"""Device ms a train step of the loss kernels: K3 (SimOTA's three) and K4,
K4b (the fused seg loss)."""

PATTERNS = ("simota_", "seg_loss_sums_kernel", "seg_loss_dlogits_kernel")


def read(rec):
    return rec.kernel_ms(PATTERNS)
