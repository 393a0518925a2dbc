"""K1's wide tensor-core kernels' share of their roofline in a request: the
sum of K1's bounds (`vrbench/roofline.py`) over the model's blocks wider
than C = 160, which those kernels run, / the device ms in the trace of the
kernels whose name holds `mlp_block_mma_kernel_wide` (the 64- and the
128-token one).  None where the trace holds no launch of them (a program
without the kernels)."""
from vrbench.roofline import blocks, bound_ms, mlp_bounds

PATTERNS = ("mlp_block_mma_kernel_wide",)
NARROW_MAX_C = 160


def read(rec):
    ms = rec.kernel_ms(PATTERNS)
    if not ms:
        return None
    bound = sum(bound_ms(*mlp_bounds(k.b, k.h, k.w, k.c, k.hid))
                for k in blocks(rec.model_cfg, rec.batch) if k.c > NARROW_MAX_C)
    return 100.0 * bound / ms
