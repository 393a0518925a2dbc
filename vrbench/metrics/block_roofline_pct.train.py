"""The fused ClusterBlock kernels' share of their roofline in a train step:
the sum of K2, K1, K6 and K5's bounds over the model's blocks
(`vrbench/roofline.py`) / the sum of their device ms in the trace, K6's
epilogue launch included."""
from vrbench.roofline import blocks_bound_ms

PATTERNS = ("mixer_block_kernel", "mlp_block_kernel", "mlp_block_mma_kernel",
            "mixer_bwd_kernel", "mixer_bwd_epilogue", "mlp_block_bwd_kernel",
            "mlp_block_bwd_cluster_kernel")


def read(rec):
    ms = rec.kernel_ms(PATTERNS)
    if not ms:
        return None
    return 100.0 * blocks_bound_ms(rec.model_cfg, rec.batch, backward=True) / ms
