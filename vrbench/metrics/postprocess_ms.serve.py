"""Device ms a request tiled by the span `serve/postprocess`: decode, NMS
(all rounds) and the seg softmax (`vrbench/spans.py`)."""

from vrbench.spans import phase_ms


def read(rec):
    return phase_ms(rec, ("serve/postprocess",), "serve")
