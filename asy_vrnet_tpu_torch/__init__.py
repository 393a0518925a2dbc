"""PyTorch + CUDA port of asy_vrnet_tpu for NVIDIA Hopper (H100).

The JAX package (`asy_vrnet_tpu`) is the reference; this package keeps its
module layout (`models/`, `ops/`, `utils/`, `infer/`, `data/`) so each part
has an obvious counterpart, and never imports JAX or the JAX package.  The
two fused ClusterBlock halves run as hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc at first use); every other op is plain torch.
"""
__version__ = "0.1.0"
