"""Device ms a request tiled by the span `serve/preprocess`: the letterbox,
the radar projection and its min-max (`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("serve/preprocess",), "serve")
