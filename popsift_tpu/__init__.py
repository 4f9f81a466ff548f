"""popsift_tpu — a SIFT / SfM framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of PopSift
(single-GPU CUDA SIFT, reference at /root/reference) extended with
batched multi-device extraction, matmul-based descriptor matching, and
a distributed SfM backend.
"""

from .config import SiftConfig

__version__ = "0.1.0"

__all__ = ["SiftConfig"]
