"""Serving observability of the port: metric instruments (``metrics``),
tracing spans (``tracing``), the engine's step flight recorder
(``steprec``), device-memory pools (``devmem``), the device profiler
(``profiling``) and span analysis (``trace_analysis``).  Each is the port's
own copy of the ``ray_tpu/util`` module of the same name."""
