"""Device ms a request tiled by the operations launched outside the span
`serve`, and the idle gaps before them (`vrbench/spans.py`).  This is the
remainder of the traced timeline, not a span of its own: today it holds the
serve client's copies of the frames and points to the device and the
readback of the detections (`vrbench/traffic/serve.py`), and any other
operation launched outside `serve` would move it too."""

from vrbench.spans import OUTSIDE, phase_ms


def read(rec):
    return phase_ms(rec, (OUTSIDE,), "serve")
