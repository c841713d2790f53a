"""Serving substrate: KV-cache engine + symbiotic round scheduler (the
port of the reference's ``repro.serve``).

:mod:`.engine` (step loop + exact execution, :func:`build_dag_triples`),
:mod:`.composer` (the per-step composition pipeline and
:class:`GatedGuard`), :mod:`.cache` (the namespaced ScheduleCache),
:mod:`.live` (cross-step incremental composition), and the async layer:
:mod:`.frontend` (arrival queue, cost-modelled admission control,
continuous-batching dispatch over engine replicas on a virtual clock)
and :mod:`.loadgen` (seeded Poisson/bursty/diurnal load generation).
"""

from .cache import ScheduleCache, Signature
from .composer import Composer, GatedGuard
from .engine import (Request, SchedulerPolicy, ServingEngine,
                     build_dag_triples)
from .frontend import AdmissionPolicy, ServingFrontend, VirtualClock
from .live import LiveComposition
from .loadgen import (ARRIVAL_PROCESSES, LoadGenerator, bursty_arrivals,
                      diurnal_arrivals, make_workload, poisson_arrivals)

__all__ = ["Request", "ScheduleCache", "SchedulerPolicy",
           "ServingEngine", "Signature", "Composer", "GatedGuard",
           "LiveComposition", "build_dag_triples",
           "AdmissionPolicy", "ServingFrontend", "VirtualClock",
           "ARRIVAL_PROCESSES", "LoadGenerator", "bursty_arrivals",
           "diurnal_arrivals", "make_workload", "poisson_arrivals"]
