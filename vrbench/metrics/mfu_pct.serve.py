"""The served forward's share of the bf16 peak over the untraced window: the
reference forward's FLOPs a frame x frames / window / 989 TFLOP/s (the
letterbox, projection, decode and NMS not counted)."""


def read(rec):
    return rec.mfu_pct()
