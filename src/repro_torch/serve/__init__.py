"""Serving substrate: KV-cache engine + symbiotic round scheduler (the
flat path and the unsliced dependency-aware path).  :mod:`.engine`
(step loop + exact execution, :func:`build_dag_triples`),
:mod:`.composer` (the per-step composition pipeline and
:class:`GatedGuard`), :mod:`.cache` (the namespaced ScheduleCache)."""

from .cache import ScheduleCache, Signature
from .composer import Composer, GatedGuard
from .engine import (Request, SchedulerPolicy, ServingEngine,
                     build_dag_triples)

__all__ = ["Composer", "GatedGuard", "Request", "ScheduleCache",
           "SchedulerPolicy", "ServingEngine", "Signature",
           "build_dag_triples"]
