"""The traced window's record, which the per-layer metrics read: the
profiler's trace of the traced iterations, the untraced window's
iteration log, and the run's counters.

Device activity is the union of the intervals of every kernel, copy and
memset in the trace: two streams that overlap count once.
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclass
class Record:
    model_cfg: dict
    batch: int                      # images or frames an iteration
    window_s: float                 # the untraced window
    iters: int                      # iterations completed in it
    issue_s: list                   # host seconds each iteration's call took
    flops_per_item: float           # the reference forward's FLOPs an image
    flops_factor: int               # 3 for a train step, 1 for a forward
    peak_bytes: int                 # the window's device memory peak
    events: list = field(default_factory=list)   # trace events of the traced window
    traced_iters: int = 0
    traced_s: float = 0.0           # the traced window, host clock

    @classmethod
    def load_trace(cls, path: str) -> list:
        with open(path) as fh:
            return json.load(fh)["traceEvents"]

    def device_events(self) -> list:
        return [e for e in self.events if e.get("cat") in DEVICE_CATS and "dur" in e]

    def busy_s(self) -> float:
        return union_us([(e["ts"], e["ts"] + e["dur"]) for e in self.device_events()]) / 1e6

    def kernel_ms(self, patterns) -> float | None:
        """Device ms an iteration of the kernels whose name contains one of
        `patterns` (None if the trace holds none)."""
        hits = [e["dur"] for e in self.device_events() if e.get("cat") == "kernel"
                and any(p in e["name"] for p in patterns)]
        if not hits or not self.traced_iters:
            return None
        return sum(hits) / 1e3 / self.traced_iters

    def mean_issue_ms(self) -> float | None:
        return statistics.fmean(self.issue_s) * 1e3 if self.issue_s else None

    def mfu_pct(self) -> float | None:
        if not self.iters or self.window_s <= 0:
            return None
        flops = self.flops_per_item * self.flops_factor * self.batch * self.iters
        from vrbench.roofline import PEAK_FLOPS
        return 100.0 * flops / self.window_s / PEAK_FLOPS

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps named by the innermost host op that spans them."""
        dev = self.device_events()
        by = {}
        for e in dev:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host = [e for e in self.events if e.get("cat") in ("cpu_op", "user_annotation",
                                                           "python_function") and "dur" in e]
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = min(cover, key=lambda e: e["dur"])["name"] if cover else "(no host op)"
            named.append([name, (g1 - g0) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
