"""Device ms a train step tiled by the span `train_step/forward`: input
normalisation and the model's forward (`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("train_step/forward",), "train_step")
