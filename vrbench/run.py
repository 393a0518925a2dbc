"""Run one benchmark cell once on this machine's card and print its result.

    python -m vrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `vrbench/workloads/<cell>.json`: a configuration
(`vrbench/configs/<config>.json`) and a traffic mix
(`vrbench/traffic/<mix>.json`), whose `kind` names the driver
(`vrbench/traffic/<kind>.py`).  Set-up (imports, the kernel libraries,
weights and inputs from the seed, the cell's own shapes warmed up) is timed
from the start of the process.  The window then runs the driver's
iterations for `--seconds` and ends at a synchronise.  With `--trace 1` the
same window runs, then `trace_iters` more iterations under the profiler,
whose trace the per-layer metrics (`vrbench/metrics/<metric>.py`, those
that BENCHMARK.json lists for the cell) read.  Last, the program's state is
freed and the reference checks what the timed path produced.

The last line of standard output is one JSON object; the numbers compared
and their limits are also the last lines of standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, nothing is printed and
the exit code is 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".vrbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "asy_vrnet_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_spec(name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic mix) of a cell, found by name."""
    cell = load_json(HERE, "workloads", f"{name}.json")
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return cell, cfg, mix


def cell_metrics(name: str, manifest: dict) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries of BENCHMARK.json that
    the cell reports."""
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return e2e, per


def metric_reader(name: str):
    """`read(record)` of `vrbench/metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "vrbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_window(driver, seconds: float, sync) -> tuple[float, int]:
    """Iterate for `seconds`, then synchronise: (window seconds, iterations)."""
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.iterate()
        n += 1
    sync()
    return time.perf_counter() - t0, n


def traced(driver, iters: int, sync, attempts: int = 3) -> tuple[list, float]:
    """(trace events, traced seconds) of `iters` iterations under the
    profiler; taken again while the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    from vrbench.record import DEVICE_CATS, Record

    for _ in range(attempts):
        with tempfile.TemporaryDirectory() as d:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    driver.iterate()
                sync()
                span = time.perf_counter() - t0
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            events = Record.load_trace(path)
        if any(e.get("cat") in DEVICE_CATS for e in events):
            return events, span
    return events, span


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, overrides=None,
             fault: str | None = None) -> dict:
    """One run of a cell on `device`; the result object (what `main`
    prints) with the checks' lines under "checks".  `overrides` replaces
    parts of the cell ({"model": {...}, "mix": {...}}) and `fault` plants a
    fault in the timed path: both for the harness's own tests."""
    import torch

    from vrbench.record import Record

    cell, cfg, mix = cell_spec(name)
    overrides = overrides or {}
    cfg = {**cfg, "model": {**cfg["model"], **overrides.get("model", {})}}
    mix = {**mix, **overrides.get("mix", {})}
    manifest = load_json(ROOT, "BENCHMARK.json")
    e2e, per = cell_metrics(name, manifest)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        from asy_vrnet_tpu_torch.ops import kernels
        kernels.build()
    driver_mod = importlib.import_module(f"vrbench.traffic.{mix['kind']}")
    driver = driver_mod.Driver(cfg, mix, seed, device, fault=fault)
    sync()
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    window_s, iters = run_window(driver, seconds, sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    values = driver.end_to_end(window_s, iters)
    values["setup_s"] = (setup_s, "s")
    result = {"attempted": iters, "failed": 0}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(max(peak, setup_peak))}
    if on_card:
        device_info["power_limit"] = power_limit()
    record = None
    if trace:
        from vrbench.common import model_flops

        record = Record(model_cfg=cfg["model"], batch=mix["batch"],
                        window_s=window_s, iters=iters, issue_s=list(driver.issue_s),
                        flops_per_item=model_flops(cfg["model"]),
                        flops_factor=3 if mix["kind"] == "train" else 1, peak_bytes=peak)
        record.events, record.traced_s = traced(driver, mix["trace_iters"], sync)
        record.traced_iters = mix["trace_iters"]
        device_info["busy_s"] = record.busy_s()
        device_info["window_s"] = record.traced_s
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if trace:
        metrics = {}
        for m in per:
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = record.breakdown()
    else:
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver reported no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]} for m in e2e}
    return {"correct": correct, **result, "metrics": metrics, "device": device_info,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell, _, _ = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vrbench: the cell needs {cell['chips']} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"vrbench: the process loaded {bad}", file=sys.stderr)
        return 4
    print(f"iterations in the window: {result['attempted']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
