"""Utilities of the port (``ray_tpu/util``'s twins): metric instruments
(``metrics``), tracing spans (``tracing``), the engine's step flight
recorder (``steprec``), device-memory pools (``devmem``), the device
profiler (``profiling``), span analysis (``trace_analysis``), the gang
round recorder (``gangrec``), health, network faults (``netfault``), chaos
injectors (``chaos``), actor pools (``actor_pool``), the distributed queue
(``queue``) and the ``multiprocessing.Pool`` surface over tasks
(``multiprocessing``).  Each is the port's own copy of the module of the
same name."""

from . import metrics
from .actor_pool import ActorPool
from .queue import Empty, Full, Queue

__all__ = ["metrics", "ActorPool", "Queue", "Empty", "Full"]
