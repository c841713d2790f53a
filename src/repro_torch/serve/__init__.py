"""Serving substrate: KV-cache engine + symbiotic round scheduler (flat
path).  :mod:`.engine` (step loop + exact execution), :mod:`.composer`
(the per-step composition pipeline), :mod:`.cache` (the namespaced
ScheduleCache)."""

from .cache import ScheduleCache, Signature
from .composer import Composer
from .engine import Request, SchedulerPolicy, ServingEngine

__all__ = ["Composer", "Request", "ScheduleCache", "SchedulerPolicy",
           "ServingEngine", "Signature"]
