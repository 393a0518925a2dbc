"""Readings that the limits of `correct` are set from, for one cell, in one
process on the card:

    python -m vrbench.calibrate --workload <cell> --seeds 12 --controls 3 \
        [--witness 3 --witness-batch 128] --out <file.json>

For each of `--seeds` seeds the program's numbers (set-up, the cell's
checked steps or a short window of its requests, then the check); for each
of `--controls` further seeds the control's (the reference computed in fp8,
`reference/lowp.py`, in the program's place) and the planted faults' (a
training cell: the step on half of each batch; a serving cell: NMS that
suppresses nothing).  With `--witness`, the first seeds again at
`--witness-batch` rows, with the program computing in bf16 and in f32:
which gaps the bf16 compute makes (f32 needs twice the memory).  A training
cell's rows also name its worst leaves.  Writes every reading to `--out`.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from vrbench.run import cell_spec

FAULTS = {"train": ("half_batch",), "serve": ("no_suppression",)}
F32 = {"model": {"compute_dtype": "float32"}}


def readings(name: str, seeds: int, controls: int, device, first_seed: int = 1 << 31,
             overrides=None, witness: int = 0, witness_batch: int | None = None) -> dict:
    _, cfg, mix = cell_spec(name)
    overrides = overrides or {}
    cfg = {**cfg, "model": {**cfg["model"], **overrides.get("model", {})}}
    mix = {**mix, **overrides.get("mix", {})}
    driver_cls = importlib.import_module(f"vrbench.traffic.{mix['kind']}").Driver
    out = {"program": [], "control": [], "bf16": [], "f32": [],
           **{f: [] for f in FAULTS[mix["kind"]]}}
    wmix = {**mix, "batch": witness_batch or mix["batch"]}

    def one(seed, fault=None, control=False, f32=None):
        t = time.perf_counter()
        c = {**cfg, "model": {**cfg["model"], **F32["model"]}} if f32 else cfg
        d = driver_cls(c, mix if f32 is None else wmix, seed, device, fault=fault)
        for _ in range(mix.get("early_requests", 0) + 1):
            d.iterate()
        d.release()
        nums = d.check(control)
        row = {"seed": seed, "seconds": time.perf_counter() - t, **nums}
        if getattr(d, "worst", None):
            row["worst"] = d.worst
        del d
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"fault": fault, "control": control, "f32": f32, **row}),
              file=sys.stderr, flush=True)
        return row

    for i in range(seeds):
        out["program"].append(one(first_seed + i))
    for i in range(controls):
        out["control"].append(one(first_seed + seeds + i, control=True))
        for f in FAULTS[mix["kind"]]:
            out[f].append(one(first_seed + seeds + i, fault=f))
    for i in range(witness):
        out["bf16"].append(one(first_seed + i, f32=False))
        out["f32"].append(one(first_seed + i, f32=True))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--witness-batch", type=int)
    ap.add_argument("--first-seed", type=int, default=1 << 31)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vrbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    from asy_vrnet_tpu_torch.ops import kernels

    kernels.build()
    res = readings(args.workload, args.seeds, args.controls, torch.device("cuda", 0),
                   args.first_seed, witness=args.witness, witness_batch=args.witness_batch)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
