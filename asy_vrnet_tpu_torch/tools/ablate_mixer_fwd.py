"""Ablation of the mixer half's forward kernel (K2): times successive
prefixes of its body and attributes K2's time among its phases.

    python -m asy_vrnet_tpu_torch.tools.ablate_mixer_fwd [--batch 64] [--hw 512]
        [--width 0.25] [--stage 0] [--groups 0] [--iters 5] [--out DIR]
        [--device cuda]

The counterpart of the TPU tool `tools/ablate_mixer_fwd.py`, which timed
prefixes of the lane-folded Pallas body; here the prefixes are compile-time
cuts of the port's own K2 (`csrc/mixer_block.cu`; what each prefix runs and
sums is in `ops/mixer_ablate.py`).  Base: gn, centers, feat, sim, agg, full
(= K2); the normalise-first variant nf (the TPU folded kernel's similarity):
featn, cosm, sim, agg, full.

Geometry: coc_small at width `--width` (0.25 = phi nano), stage `--stage`
of a `--hw`^2 input, batch `--batch`: x (B, hw/4/2^s, hw/4/2^s, C) bf16,
random weights from seed 0 (as the TPU tool's).  Any stage 0-3 runs: the TPU
tool asserted a lane fold (s > 1, stages 0-1), a TPU layout the port does
not have.  `--groups` is the CTAs per region (K2's thread-block cluster
size), overriding `kernels.mixer_groups` (0: its choice); the TPU
tool's `--gw` grouped regions per program instead.  `--device cpu` runs the
plain twins on the CPU (the times are then the CPU's).

Per prefix it prints the ms per launch from the profiler trace (the device
time of its kernel: `utils/profiling.py::kernel_table`'s row of its template
name) and from CUDA events (which include the host's launch work where that
is longer than the kernel), the step Delta ms against the previous prefix
and the share of `full` (both from the trace), the prefix's bound (the bytes
and operations it needs at the H100 SXM's 3.35 TB/s and 989 TFLOP/s) and the
CTAs per SM it ran with beside K2's; then the nf-vs-base numerics of the
`full` outputs, as the TPU tool printed them.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from asy_vrnet_tpu_torch.config import COC_VARIANTS
from asy_vrnet_tpu_torch.ops import block
from asy_vrnet_tpu_torch.ops import mixer_ablate as ma
from asy_vrnet_tpu_torch.utils import profiling

PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
JOBS = [(s, False) for s in ma.STOPS[False]] + [(s, True) for s in ma.STOPS[True]]
# the prefix each one's Delta is taken against
PREV = {("centers", False): ("gn", False), ("feat", False): ("centers", False),
        ("sim", False): ("feat", False), ("agg", False): ("sim", False),
        ("full", False): ("agg", False), ("featn", True): ("feat", False),
        ("cosm", True): ("featn", True), ("sim", True): ("cosm", True),
        ("agg", True): ("sim", True), ("full", True): ("agg", True)}
# the step of the TPU body (tools/ablate_mixer_fwd.py) a prefix adds
TPU_STEP = {"gn": "gn: normalise, write", "centers": "[2] centers",
            "feat": "[1] feat", "sim": "[3-5] norms, cos, argmax",
            "agg": "[6] aggregation, oc", "full": "[7] dispatch, moments",
            "featn": "[3-4] norms, featn", "cosm": "[5] cosines"}


def _symbol(stop: str, nf: bool, dtype: torch.dtype) -> str:
    """A prefix's kernel name in a trace (its template arguments)."""
    t = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    return f"mixer_block_kernel<{t}, {ma.CODES[stop]}, {str(nf).lower()}>"


def geometry(stage: int, hw: int, width: float, batch: int) -> dict:
    """The ClusterBlock shape of coc_small's `stage` at width `width`."""
    if not 0 <= stage <= 3:
        raise ValueError(f"stage {stage}: coc_small has stages 0-3")
    v = COC_VARIANTS["coc_small"]
    side = hw // (4 * 2 ** stage)
    return dict(b=batch, h=side, w=side, c=v.scaled_dims(width)[stage], heads=v.heads[stage],
                d=v.head_dim[stage], fold=v.fold_h[stage], ph=v.proposal_h[stage],
                pw=v.proposal_w[stage])


def make_inputs(geo: dict, device, seed: int = 0):
    """(x, stats, (wf, bf, wv, bv, w2, b2, alpha_beta)) as the TPU tool drew
    them: x standard normal, weights normal with standard deviation 0.1 in
    f32, x and the matmul weights cast to bf16; alpha, beta = 1, 0."""
    rng = np.random.default_rng(seed)
    b, h, w, c, inner = geo["b"], geo["h"], geo["w"], geo["c"], geo["heads"] * geo["d"]
    x = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).to(
        device, torch.bfloat16)

    def mk(*shape, mat=False):
        t = torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.1).to(device)
        return t.to(torch.bfloat16) if mat else t

    ws = (mk(c, inner, mat=True), mk(inner), mk(c, inner, mat=True), mk(inner),
          mk(inner, c, mat=True), mk(c), torch.tensor([1.0, 0.0], device=device))
    return x, block.gn1_stats(x), ws


def prefix_bounds(stop: str, nf: bool, geo: dict, m: int = 4, itemsize: int = 2):
    """(flops, bytes) a prefix needs.  Bytes: x read and the output written
    once each, and the weights it reads (wf and wv from `centers` on, w2 in
    `full`).  Flops, cumulative: the projections of the M pooled rows
    (4*M*C*I per region), feat (2*C*I per token), the norms (2*I per token)
    and the M cosines (2*I*M), the aggregation (2*C*heads per token) and the
    mixed centers (2*M*C*I per region), the dispatch (2*C*heads per token)
    and the fc2 fold (2*M*C*I per region); `full` is chip_smoke.py's bound
    of K2."""
    b, h, w, c, heads = geo["b"], geo["h"], geo["w"], geo["c"], geo["heads"]
    inner = heads * geo["d"]
    t, regions = b * h * w, b * geo["fold"] ** 2
    order = ("gn", "centers", "feat", "featn", "cosm", "sim", "agg", "full")
    k = order.index(stop)
    steps = (0, regions * 4 * m * c * inner, t * 2 * c * inner,
             t * 2 * inner if nf else 0, t * 2 * inner * m if nf else 0,
             0 if nf else t * 2 * inner * (m + 1),
             t * 2 * c * heads + regions * 2 * m * c * inner,
             t * 2 * c * heads + regions * 2 * m * c * inner)
    flops = sum(steps[:k + 1])
    byts = 2 * t * c * itemsize
    if stop != "gn":
        byts += 2 * c * inner * itemsize
    if stop == "full":
        byts += c * inner * itemsize
    return flops, byts


def bound_ms(flops, byts):
    """(least ms at the H100 SXM's peaks, "bytes" or "operations")."""
    tf, tb = flops / PEAK_FLOPS, byts / PEAK_BYTES
    return max(tf, tb) * 1e3, ("operations" if tf >= tb else "bytes")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hw", type=int, default=512)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--groups", type=int, default=0,
                    help="CTAs per region (0: kernels.mixer_groups' choice)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "ablate_mixer_fwd"),
                    help="directory of the profiler's Chrome trace")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def time_prefixes(x, stats, ws, kw, groups, iters, log_dir, jobs=JOBS) -> dict:
    """{job: {"ms_trace", "trace_count", "ms"}} per launch of each prefix:
    the device time its kernel took in a profiler trace over `iters` sweeps
    of `jobs` (`kernel_table`'s row of the kernel's template name, per
    launch it recorded: a trace in a process that has run the profiler many
    times can miss launches, and "trace_count" is the launches it recorded
    per sweep; on CPU arguments, with no kernel, the CPU's time of the
    labelled range) and the time from CUDA events around back-to-back
    launches (`chained_device_time`).  The events include the host's launch
    work where a launch takes longer on the host than on the card (batch 8:
    ~0.1 ms a launch); the trace does not."""
    def prefix(xx, stop, nf):
        return ma.mixer_block_ablate(xx, stats, *ws, stop=stop, nf=nf, groups=groups, **kw)

    events = {job: 1e3 * profiling.chained_device_time(
        lambda xx, j=job: prefix(xx, *j), x, n=iters) for job in jobs}
    def sweeps():
        for _ in range(iters):
            for job in jobs:
                prefix(x, *job)

    profiling.traced(sweeps, log_dir, on_card=x.is_cuda)
    table = profiling.kernel_table(log_dir, iters)

    def traced(job):
        """(ms per recorded launch, launches recorded per sweep)."""
        for match in (lambda n: _symbol(*job, x.dtype) in n, lambda n: n == ma.label(*job)):
            hits = [(ms, n) for (name, _), (ms, n) in table.items() if match(name)]
            if hits:
                count = sum(n for _, n in hits)
                return sum(ms for ms, _ in hits) / count, count
        return 0.0, 0.0

    times = {}
    for job in jobs:
        ms, count = traced(job)
        times[job] = {"ms_trace": ms, "trace_count": count, "ms": events[job]}
    return times


def run(args) -> dict:
    """Run every prefix at the geometry of `args`, print the table and the
    numerics; -> {"geometry", "groups", "device", "rows", "numerics"}."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ablate_mixer_fwd: no CUDA device (--device cpu runs the twins)")
    geo = geometry(args.stage, args.hw, args.width, args.batch)
    x, stats, ws = make_inputs(geo, dev)
    kw = dict(heads=geo["heads"], fold_h=geo["fold"], fold_w=geo["fold"],
              proposal_h=geo["ph"], proposal_w=geo["pw"])
    groups = args.groups
    if dev.type == "cuda" and not groups:
        from asy_vrnet_tpu_torch.ops import kernels

        groups = kernels.mixer_groups(x, ws[0].shape[1], geo["heads"], geo["fold"], geo["fold"],
                                      geo["ph"], geo["pw"])
    groups = groups or 1

    def full(nf):
        return ma.mixer_block_ablate(x, stats, *ws, stop="full", nf=nf, groups=groups,
                                     return_assign=True, **kw)

    occupancy = {job: ma.mixer_block_ablate(x, stats, *ws, stop=job[0], nf=job[1],
                                            groups=groups, return_occupancy=True, **kw)[-1]
                 for job in JOBS}
    (base, _, base_asg), (nf, _, nf_asg) = full(False), full(True)
    yb, yn = base.float(), nf.float()
    d = (yb - yn).abs()
    numerics = {"max_abs_diff": d.max().item(), "mean_abs_y": yb.abs().mean().item(),
                "frac_gt_1e-2": (d > 1e-2).float().mean().item(),
                "frac_gt_1e-1": (d > 1e-1).float().mean().item(),
                "assignment_agreement": (base_asg == nf_asg).float().mean().item()}
    times = time_prefixes(x, stats, ws, kw, groups, args.iters, args.out)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"mixer_block ablation on {kind}: coc_small width {args.width} stage {args.stage}, "
          f"x {tuple(x.shape)} bf16, heads {geo['heads']}, fold {geo['fold']}, "
          f"{groups} CTA(s) per region; ms per launch over {args.iters} iterations from "
          + ("the profiler trace (device) and CUDA events" if dev.type == "cuda"
             else "the CPU clock") + f"; Delta and share from the trace; trace in {args.out}")
    print(f"{'prefix':<14}{'adds (TPU step)':<28}{'ms trace':>10}{'ms events':>10}"
          f"{'d ms':>9}{'of full':>8}{'bound ms':>10} {'bound by':<11}{'CTAs/SM (K2)':>12}")
    rows = []
    for stop, nf_ in JOBS:
        t = times[(stop, nf_)]
        prev = PREV.get((stop, nf_))
        dms = t["ms_trace"] - (times[prev]["ms_trace"] if prev else 0.0)
        bms, by = bound_ms(*prefix_bounds(stop, nf_, geo))
        occ = occupancy[(stop, nf_)]
        row = {"variant": "nf" if nf_ else "base", "stop": stop, "tpu_step": TPU_STEP[stop],
               **t, "delta_ms": dms, "share_of_full": t["ms_trace"] / times[("full", nf_)][
                   "ms_trace"], "bound_ms": bms, "bound_by": by, "ctas_per_sm": occ}
        rows.append(row)
        print(f"{row['variant'] + ' ' + stop:<14}{TPU_STEP[stop]:<28}{row['ms_trace']:>10.4f}"
              f"{row['ms']:>10.4f}{dms:>9.4f}{row['share_of_full']:>8.3f}{bms:>10.5f} {by:<11}"
              f"{'not measured' if occ is None else f'{occ[0]} ({occ[1]})':>12}")
    short = [f"{r['variant']} {r['stop']} {r['trace_count']:.2f}" for r in rows
             if r["trace_count"] < 1.0]
    if short:
        print(f"the trace recorded fewer launches than were made (per sweep): "
              f"{', '.join(short)}; ms trace is per recorded launch")
    print(f"nf-vs-base max|diff| = {numerics['max_abs_diff']:.3e}  mean|y| = "
          f"{numerics['mean_abs_y']:.3e}")
    print(f"  frac > 1e-2: {numerics['frac_gt_1e-2']:.2e}   frac > 1e-1: "
          f"{numerics['frac_gt_1e-1']:.2e}   assignment agreement "
          f"{numerics['assignment_agreement']:.6f}")
    return {"geometry": geo, "groups": groups, "device": kind, "rows": rows,
            "numerics": numerics}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
