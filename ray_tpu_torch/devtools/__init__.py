"""Developer tooling of the port: the recompile sentinel (``jitguard``),
the port's copy of ``ray_tpu/devtools/jitguard.py``."""
