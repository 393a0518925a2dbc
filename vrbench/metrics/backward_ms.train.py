"""Device ms a train step tiled by the span `train_step/backward`: the
backward, the autograd thread's launches and any remat recompute included
(`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("train_step/backward",), "train_step")
