"""Device ms a request tiled by the span `serve/forward`: the model's
forward (`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("serve/forward",), "serve")
