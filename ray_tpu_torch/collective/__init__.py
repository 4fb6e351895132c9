"""Collective communication (port of ``ray_tpu/collective/``).

The device plane: ``mesh_ops``, named-axis collectives over the ambient
``DeviceMesh`` (the counterpart of ``xla_ops``), differentiable where JAX's
are.  The host plane (named groups of workers exchanging numpy arrays
through the cluster KV) comes with the runtime (ROADMAP.md).
"""

from . import mesh_ops

__all__ = ["mesh_ops"]
