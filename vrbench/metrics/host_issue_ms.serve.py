"""Mean host ms from calling the fused pipeline until it returns, before the
detections are read back, over the untraced window."""


def read(rec):
    return rec.mean_issue_ms()
