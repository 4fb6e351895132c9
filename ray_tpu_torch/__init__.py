"""PyTorch/CUDA port of ray_tpu's serving path, for NVIDIA Hopper (H100).

A second package beside the JAX ``ray_tpu``, which stays the reference it
is held against.  It follows ``ray_tpu``'s layout and names (``ops``,
``models``, ``serve``) so each module's counterpart is easy to find, and
imports only torch, numpy and the standard library: nothing of JAX and
nothing of ``ray_tpu``.  The Pallas TPU kernels on its path are kernels
written by hand in CUDA C++ under ``csrc/``, built with nvcc at first use
(``_build.py``).  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
