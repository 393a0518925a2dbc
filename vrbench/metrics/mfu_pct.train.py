"""The whole train step's share of the bf16 peak over the untraced window:
3 x the reference forward's FLOPs an image x images / window / 989 TFLOP/s
(recompute not counted)."""


def read(rec):
    return rec.mfu_pct()
