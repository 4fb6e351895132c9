"""The plain reference of the benchmark's correctness check: plain PyTorch,
fp32, importing nothing of the program (``ray_tpu_torch``) or of JAX."""
