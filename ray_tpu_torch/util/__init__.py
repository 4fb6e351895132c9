"""Utilities of the port (``ray_tpu/util``'s twins): metric instruments
(``metrics``), tracing spans (``tracing``), the engine's step flight
recorder (``steprec``), device-memory pools (``devmem``), the device
profiler (``profiling``), span analysis (``trace_analysis``), the gang
round recorder (``gangrec``), health, network faults (``netfault``) and
chaos injectors (``chaos``).  Each is the port's own copy of the module of
the same name."""

from . import metrics

__all__ = ["metrics"]
