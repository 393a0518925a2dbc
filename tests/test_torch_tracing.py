"""The port's phase spans (`utils/profiling.py::span`) and the benchmark's
reading of them (`vrbench/spans.py`, the span metrics), on the CPU.

Without a profiler `span` is one shared no-op.  Under `torch.profiler`, one
train step (coc_dryrun, 64^2, batch 2, f32) and one fused-pipeline call
emit their top-level span and its children in order, inside it, without
overlap, and every aten op of the body on the span's thread from the first
child on falls inside a child (the step's preparation stays in the top
span; a pipeline call has none).  The port's device-time union is the
benchmark's.  An exported serving graph holds no profiler op, with or without a
profiler recording.  On a hand-made trace the attribution's tiles are exact
and each span metric reads its tile, and nothing without device ops or
spans.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
from asy_vrnet_tpu_torch.utils import profiling
from vrbench import spans
from vrbench import record
from vrbench.record import Record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = Config(model=ModelConfig(variant="coc_dryrun", compute_dtype="float32",
                               use_pallas_cluster=False, input_size=(64, 64)),
             loss=LossConfig(max_boxes=16))
TRAIN_PHASES = ("forward", "loss_seg", "loss_det", "backward", "grad_sync", "optimizer", "ema")
SERVE_PHASES = ("preprocess", "forward", "postprocess")


def test_span_without_profiler_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("train_step"), profiling.span("serve/forward")
    assert a is b is profiling._NO_SPAN
    with a:
        with b:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        live = profiling.span("serve")
        with live:
            torch.ones(2).sum()
    assert live is not profiling._NO_SPAN
    assert "serve" in {e.key for e in prof.key_averages()}


def _trace(run, path) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _ns(e) -> tuple[int, int]:
    return round(e["ts"] * 1000), round((e["ts"] + e["dur"]) * 1000)


def _check_tiling(events, top: str, phases: tuple, head: bool):
    """One `top` span; its children `top/<phase>`, in `phases`' order,
    inside it and apart; every aten op of its thread inside it lies inside
    a child, but for those before the first child where `head` allows the
    top span work of its own."""
    ann = [e for e in events if e.get("cat") == "user_annotation" and spans.is_phase(e["name"])]
    tops = [e for e in ann if e["name"] == top]
    assert len(tops) == 1, [e["name"] for e in ann]
    t0, t1 = _ns(tops[0])
    children = sorted((e for e in ann if e["name"] != top), key=lambda e: e["ts"])
    assert [e["name"] for e in children] == [f"{top}/{p}" for p in phases]
    bounds = [_ns(e) for e in children]
    assert t0 <= bounds[0][0] and bounds[-1][1] <= t1
    assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(e["tid"] == tops[0]["tid"] for e in children)
    starts = [a for a, _ in bounds]
    body = before = outside = 0
    for e in events:
        if e.get("cat") != "cpu_op" or e["tid"] != tops[0]["tid"]:
            continue
        a, z = _ns(e)
        if t0 <= a < t1:
            body += 1
            i = bisect.bisect_right(starts, a) - 1
            if i < 0:
                before += 1
            else:
                outside += z > bounds[i][1]
    assert body > before and not outside
    assert head or not before


def test_train_step_spans_tile_the_step(tmp_path):
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train.optim import set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    torch.manual_seed(0)
    state = create_train_state(CFG, device="cpu")
    set_learning_rate(state.optimizer, 1e-2)
    step = build_train_step(CFG, device="cpu")
    batch = make_batch(np.random.default_rng(3), 2, (64, 64))
    events = _trace(lambda: step(state, batch), tmp_path / "train.json")
    _check_tiling(events, "train_step", TRAIN_PHASES, head=True)
    assert state.step == 1


def test_pipeline_spans_tile_a_call(tmp_path):
    from asy_vrnet_tpu_torch.infer.pipeline import build_fused_pipeline
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    torch.manual_seed(0)
    model = create_model(CFG.model, "cpu").eval()
    pipe = build_fused_pipeline(model, CFG.model, (48, 96), conf_thres=0.01, max_det=4)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.integers(0, 255, (1, 48, 96, 3), dtype=np.uint8))
    points = torch.from_numpy(rng.uniform(0, 60, (1, 32, 6)).astype(np.float32))
    valid = torch.ones((1, 32), dtype=torch.bool)
    events = _trace(lambda: pipe(image, points, valid), tmp_path / "serve.json")
    _check_tiling(events, "serve", SERVE_PHASES, head=False)


class _TinyHeads(nn.Module):
    """A stand-in for the model: det maps at strides 8/16/32 and seg logits,
    NHWC, as the model gives them."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.det = nn.Conv2d(cfg.image_channels, 5 + cfg.num_classes, 1)
        self.seg = nn.Conv2d(cfg.image_channels + cfg.radar_channels, cfg.num_seg_classes, 1)

    def forward(self, image, radar):
        x = image.permute(0, 3, 1, 2)
        det = [self.det(F.avg_pool2d(x, s)).permute(0, 2, 3, 1) for s in (8, 16, 32)]
        seg = self.seg(torch.cat([x, radar.permute(0, 3, 1, 2)], 1)).permute(0, 2, 3, 1)
        return det, seg


@pytest.mark.parametrize("recording", [False, True])
def test_exported_program_holds_no_profiler_op(tmp_path, recording):
    from asy_vrnet_tpu_torch.infer.export import export_program

    torch.manual_seed(0)
    model = _TinyHeads(CFG.model)
    path = str(tmp_path / "g.pt2")
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            export_program(model, CFG.model, path, max_det=2)
    else:
        export_program(model, CFG.model, path, max_det=2)
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes]
    assert targets and not [t for t in targets if "profiler" in t]


@pytest.mark.parametrize("seed", range(3))
def test_device_union_is_the_benchmarks(seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 100, 40)
    intervals = [(s, s + d) for s, d in zip(starts, rng.exponential(5, 40))]
    intervals += [intervals[0], (intervals[1][0], intervals[1][0])]
    assert profiling._union_us(intervals) == record.union_us(intervals) < sum(
        e - s for s, e in intervals)


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel", name=None):
    return {"ph": "X", "cat": cat, "name": name or f"op{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def hand_trace(top: str, first: str, second: str, device_ops: bool = True) -> list:
    """`top` over [0, 100): `first` [0, 40), `second` [40, 100).  Op 1 is
    launched in `first` and runs [10, 30); a copy launched in `first` runs
    inside it, [12, 20); op 2 is launched in `second` from another thread
    and runs [50, 60) after 20 idle; op 99 has no launch event and runs
    [55, 70); op 3 is launched after `top` and runs [120, 125) after 50
    idle.  Tiles: `first` 20 busy; `second` 20 busy + 20 idle; outside 5
    busy + 50 idle; 115 in all."""
    events = [_span(top, 0, 100), _span(f"{top}/{first}", 0, 40),
              _span(f"{top}/{second}", 40, 60), _span("unrelated", 0, 200),
              _launch(1, 5), _launch(4, 6), _launch(2, 45, tid=2), _launch(3, 110)]
    if device_ops:
        events += [_op(1, 10, 20), _op(4, 12, 8, cat="gpu_memcpy"), _op(2, 50, 10),
                   _op(99, 55, 15), _op(3, 120, 5),
                   {"ph": "X", "cat": "gpu_user_annotation", "name": top, "ts": 10, "dur": 60}]
    return events


def test_attribution_tiles_are_exact():
    trace = hand_trace("train_step", "forward", "backward")
    p = spans.attribute(trace)
    got = {k: (t.busy_us, t.idle_us, t.ops) for k, t in p.tiles.items()}
    assert got == {"train_step/forward": (20, 0, 2), "train_step/backward": (20, 20, 2),
                   spans.OUTSIDE: (5, 50, 1)}
    assert p.timeline_us == 115 == sum(t.tile_us for t in p.tiles.values())
    assert (p.ops, p.missing) == (5, 1)
    assert p.spans == {"train_step", "train_step/forward", "train_step/backward"}
    assert [(op["name"], phase, found) for op, phase, found in spans.assign(trace)] == [
        ("op1", "train_step/forward", True), ("op4", "train_step/forward", True),
        ("op2", "train_step/backward", True), ("op99", "train_step/backward", False),
        ("op3", spans.OUTSIDE, True)]


# metric: (top span, its two children in the hand-made trace, ms it reads)
METRICS = {
    "forward_ms.train": ("train_step", ("forward", "backward"), 0.020),
    "backward_ms.train": ("train_step", ("forward", "backward"), 0.040),
    "loss_ms.train": ("train_step", ("loss_seg", "loss_det"), 0.060),
    "update_ms.train": ("train_step", ("optimizer", "ema"), 0.060),
    "preprocess_ms.serve": ("serve", ("preprocess", "forward"), 0.020),
    "forward_ms.serve": ("serve", ("preprocess", "forward"), 0.040),
    "postprocess_ms.serve": ("serve", ("forward", "postprocess"), 0.040),
    "client_ms.serve": ("serve", ("forward", "postprocess"), 0.055),
}


def _reader(name: str):
    path = os.path.join(ROOT, "vrbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("span_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _record(events) -> Record:
    return Record(model_cfg={}, batch=1, window_s=1.0, iters=1, issue_s=[], flops_per_item=0.0,
                  flops_factor=1, peak_bytes=0, events=events, traced_iters=1)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metric_reads_its_tile(name):
    top, children, want = METRICS[name]
    got = _reader(name)(_record(hand_trace(top, *children)))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metric_reads_none_without_device_ops_or_spans(name):
    top, children, _ = METRICS[name]
    read = _reader(name)
    assert read(_record(hand_trace(top, *children, device_ops=False))) is None
    no_spans = [e for e in hand_trace(top, *children) if e["cat"] != "user_annotation"]
    assert read(_record(no_spans)) is None
    other = "serve" if top == "train_step" else "train_step"
    assert read(_record(hand_trace(other, "forward", "backward"))) is None
