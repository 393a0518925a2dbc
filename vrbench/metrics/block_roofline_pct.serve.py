"""The fused ClusterBlock kernels' share of their roofline in a request: the
sum of K2 and K1's bounds over the model's blocks (`vrbench/roofline.py`) /
the sum of their device ms in the trace."""
from vrbench.roofline import blocks_bound_ms

PATTERNS = ("mixer_block_kernel", "mlp_block_kernel", "mlp_block_mma_kernel")


def read(rec):
    ms = rec.kernel_ms(PATTERNS)
    if not ms:
        return None
    return 100.0 * blocks_bound_ms(rec.model_cfg, rec.batch, backward=False) / ms
