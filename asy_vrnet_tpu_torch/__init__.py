"""PyTorch + CUDA port of asy_vrnet_tpu for NVIDIA Hopper (H100).

The JAX package (`asy_vrnet_tpu`) is the reference; this package keeps its
module layout (`models/`, `ops/`, `utils/`, `infer/`, `data/`) so each part
has an obvious counterpart, and never imports JAX or the JAX package.  The
two fused ClusterBlock halves run as hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc at first use); every other op is plain torch.
Importing the package registers the serving kernels as PyTorch operators
(`ops/custom_ops.py`), which an exported program names.
"""
__version__ = "0.1.0"

from asy_vrnet_tpu_torch.ops import custom_ops  # noqa: E402,F401  (registers asy_vrnet::*)
