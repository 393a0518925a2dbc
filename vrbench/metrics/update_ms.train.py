"""Device ms a train step tiled by the spans `train_step/grad_sync`,
`train_step/optimizer` and `train_step/ema`: the gradient all-reduce (none
on one card), the optimiser, the log-variance update and the EMA
(`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("train_step/grad_sync", "train_step/optimizer", "train_step/ema"),
                    "train_step")
