"""Device ms a train step tiled by the spans `train_step/loss_seg` and
`train_step/loss_det`: the seg loss and f-score, SimOTA, the YOLOX loss and
the multitask combine, kernels and plain torch ops alike (`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("train_step/loss_seg", "train_step/loss_det"), "train_step")
