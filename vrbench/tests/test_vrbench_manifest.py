"""BENCHMARK.json against the files it names and the rules it keeps: names and
units, each cell's configuration, traffic mix, driver and metric readers
found by name, per-layer metrics reported where the end-to-end metric they
move is, the roofline counts against `chip_smoke.py`'s, the FLOP count."""
from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from vrbench import roofline, run
from vrbench.common import model_flops

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in manifest["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert 1 <= manifest["run_seconds"] <= 51


def test_cells_found_by_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cell, cfg, mix = run.cell_spec(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert cell["why"] == w["why"]
        assert configs[w["config"]]["file"] == f"vrbench/configs/{w['config']}.json"
        assert cfg["name"] == w["config"] and cfg["reduced"] == configs[w["config"]]["reduced"]
        driver = importlib.import_module(f"vrbench.traffic.{mix['kind']}")
        assert hasattr(driver, "Driver")
        e2e, per = run.cell_metrics(w["name"], manifest)
        for m in per:
            assert callable(run.metric_reader(m["name"]))
        assert "setup_s" in {m["name"] for m in e2e}
        assert all(isinstance(v, (int, float)) for v in cell["limits"].values())


def test_per_layer_moves_reported(manifest):
    for w in manifest["workloads"]:
        e2e, per = run.cell_metrics(w["name"], manifest)
        reported = {m["name"] for m in e2e}
        assert len(reported) >= 2 and per
        for m in per:
            assert m["moves"] in reported, (w["name"], m["name"])


def test_paths_hold_the_files(manifest):
    assert manifest["paths"] == ["vrbench"]
    for c in manifest["configs"]:
        assert c["file"].startswith("vrbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    assert manifest["command"][:3] == ["python3", "-m", "vrbench.run"]


def test_roofline_counts_match_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    for name, b, h, w, c, heads, d, fold, hid, _ in chip_smoke.SHAPES:
        assert roofline.mixer_bounds(b, h, w, c, heads, d, fold) == \
            chip_smoke.mixer_bounds(b, h, w, c, heads, d, fold), name
        assert roofline.mlp_bounds(b, h, w, c, hid) == chip_smoke.mlp_bounds(b, h, w, c, hid)
        assert roofline.mixer_bwd_bounds(b, h, w, c, heads, d, fold) == \
            chip_smoke.mixer_bwd_bounds(b, h, w, c, heads, d, fold)
        assert roofline.mlp_bwd_bounds(b, h, w, c, hid) == \
            chip_smoke.mlp_bwd_bounds(b, h, w, c, hid)
        assert roofline.bound_ms(*roofline.mixer_bounds(b, h, w, c, heads, d, fold)) == \
            chip_smoke.bound_ms(*chip_smoke.mixer_bounds(b, h, w, c, heads, d, fold))[0]


def test_roofline_blocks_are_the_main_path_shapes():
    """The nano model's 27 blocks at batch 8 are chip_smoke's SHAPES with
    their calls per forward."""
    chip_smoke = pytest.importorskip("chip_smoke")
    with open(os.path.join(ROOT, "vrbench", "configs", "vrnet-nano.json")) as fh:
        cfg = json.load(fh)["model"]
    got = sorted(tuple(k) for k in roofline.blocks(cfg, 8))
    want = sorted((b, h, w, c, heads, d, fold, hid)
                  for _, b, h, w, c, heads, d, fold, hid, calls in chip_smoke.SHAPES
                  for _ in range(calls))
    assert got == want


@pytest.mark.parametrize("config", ["vrnet-nano", "vrnet-s"])
def test_mfu_flops_positive_and_repeatable(config):
    with open(os.path.join(ROOT, "vrbench", "configs", f"{config}.json")) as fh:
        cfg = json.load(fh)["model"]
    a, b = model_flops(cfg), model_flops(cfg)
    assert a > 0 and a == b


def test_device_busy_is_the_union_of_intervals():
    from vrbench.record import Record, union_us

    assert union_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    rec = Record(model_cfg={}, batch=1, window_s=1.0, iters=1, issue_s=[0.1], flops_per_item=1.0,
                 flops_factor=1, peak_bytes=0, traced_iters=2, traced_s=1e-4)
    rec.events = [{"cat": "kernel", "name": "a", "ts": 0, "dur": 40},
                  {"cat": "kernel", "name": "b", "ts": 20, "dur": 40},
                  {"cat": "gpu_memcpy", "name": "c", "ts": 80, "dur": 10},
                  {"cat": "cpu_op", "name": "aten::add", "ts": 55, "dur": 30}]
    assert rec.busy_s() == 70e-6
    assert rec.kernel_ms(("a", "b")) == 40e-3
    assert rec.breakdown()["idle_gaps"] == [["aten::add", 20e-6]]
