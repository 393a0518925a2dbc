"""Device ms a train step of the optimiser's and the EMA's multi-tensor
kernels."""

PATTERNS = ("multi_tensor", "foreach")


def read(rec):
    return rec.kernel_ms(PATTERNS)
