"""The traced window's device timeline, tiled by the program's phase spans.

The program marks each iteration of its hot paths with a top-level span
(`train_step`, `serve`) whose children `<top>/<phase>` tile it
(`asy_vrnet_tpu_torch/utils/profiling.py::span`).  Each device operation
(kernel, copy, memset) is charged to the innermost phase span, on any
thread, whose interval holds the timestamp of the CUDA runtime or driver
call that launched it (found by its `correlation`): the autograd thread's
launches thus fall in the span of the backward that started them.  An
operation whose launch is not in the trace goes to the phase of the one
before it, and is counted.  One launched outside every top-level span goes
to `OUTSIDE`.

Walking the operations in order of start, each adds to the union of the
device's busy intervals what it covers past the frontier of those before
it; that busy time, and the idle gap before it (the device was waiting for
its launch), go to its phase.  The phases' tiles and `OUTSIDE` thus sum to
the last operation's end less the first one's start.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

from vrbench.record import DEVICE_CATS

TOPS = ("train_step", "serve")
OUTSIDE = "(outside)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


@dataclass
class Tile:
    busy_us: float = 0.0
    idle_us: float = 0.0
    ops: int = 0

    @property
    def tile_us(self) -> float:
        return self.busy_us + self.idle_us


@dataclass
class Phases:
    tiles: dict                     # phase -> Tile
    timeline_us: float              # last device op's end - the first one's start
    ops: int                        # device ops
    missing: int                    # of them, ops whose launch is not in the trace
    spans: set                      # names of the phase spans in the trace


def is_phase(name: str) -> bool:
    """A top-level span or one of its children."""
    return name.partition("/")[0] in TOPS


def phase_spans(events: list) -> list:
    return [e for e in events if e.get("cat") == SPAN_CAT and "dur" in e and is_phase(e["name"])]


def assign(events: list) -> list:
    """[(device op, its phase, whether its launch is in the trace)], the ops
    in order of start."""
    spans = phase_spans(events)
    # between bounds[i] and bounds[i + 1] the innermost span is names[i]
    bounds = sorted({t for e in spans for t in (e["ts"], e["ts"] + e["dur"])})
    names = []
    for t in bounds:
        cover = [e for e in spans if e["ts"] <= t < e["ts"] + e["dur"]]
        names.append(min(cover, key=lambda e: e["dur"])["name"] if cover else OUTSIDE)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    out, phase = [], OUTSIDE
    for op in ops:
        ts = launch.get(op.get("args", {}).get("correlation"))
        if ts is not None:
            i = bisect.bisect_right(bounds, ts) - 1
            phase = names[i] if i >= 0 else OUTSIDE
        out.append((op, phase, ts is not None))
    return out


def attribute(events: list) -> Phases | None:
    """The tiles of a trace's device timeline (None without device ops)."""
    ops = assign(events)
    if not ops:
        return None
    tiles = {}
    start = end = ops[0][0]["ts"]
    for op, phase, _ in ops:
        tile = tiles.setdefault(phase, Tile())
        tile.ops += 1
        s, e = op["ts"], op["ts"] + op["dur"]
        if e > end:
            idle = max(s - end, 0.0)
            tile.idle_us += idle
            tile.busy_us += e - end - idle
            end = e
    return Phases(tiles=tiles, timeline_us=end - start, ops=len(ops),
                  missing=sum(not found for _, _, found in ops),
                  spans={e["name"] for e in phase_spans(events)})


def phase_ms(rec, phases: tuple, top: str) -> float | None:
    """Device ms an iteration that `phases` tile; None where the trace holds
    no device op, no traced iteration or no top-level span `top`."""
    p = attribute(rec.events)
    if p is None or not rec.traced_iters or top not in p.spans:
        return None
    return sum(p.tiles[n].tile_us for n in phases if n in p.tiles) / 1e3 / rec.traced_iters
