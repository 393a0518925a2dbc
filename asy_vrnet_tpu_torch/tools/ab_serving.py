"""Measurements of the serving path's two kernels (K2, K1), its forward and
the mixer half's backward (K6, K6r), for comparing two checkouts of the
port on one card.

    cd <checkout> && python <this file> {check|time|time-bwd|forward|bits|dispatch} [--tag NAME]

The port is imported from the current directory, so one copy of this file
measures any checkout whose `ops/block.py`, `ops/kernels.py` and
`utils/profiling.py` have the entry points it calls (the port has had them
since its K2 profiling tool).  To compare two checkouts, run each mode from
both in alternation (A, B, B, A, ...) on one card.  Each mode
prints one line per record, `AB {json}`, with the tag.

- check: K2 in f32 against its plain twin at the 7 ClusterBlock shapes of
  nano coc_small at 512^2, batch 1, 8, 16 and 32, with the inputs
  `tests/test_torch_cuda.py::_mixer_setup` makes for seeds 0, 11, 14, 15,
  21: the (token, head) pairs whose assignment differs, the twin's logit
  margin at each (its max less its logit at K2's pick), the direct max
  |diff| against the twin and whether it meets 1e-4 * max(1, max|y|); at p3,
  batch 16 and 32, also the twin on the CPU as a second witness.
- time: K2 and K1 at the 7 shapes, batch 8, bf16: device ms per launch from
  a profiler trace, CUDA-event ms per launch (20 launches), and the host's
  microseconds per wrapper call (200 calls without a synchronise, median of
  5).
- dispatch (a checkout with `ops/custom_ops.py`): the host's
  microseconds per call of K2 and K1 through the registered operators
  (`torch.ops.asy_vrnet.*`, what `block.mixer_block` and `block.mlp_block`
  call on the card) and through the launch they wrap, called directly
  (`block.mixer_block_launch`, `block.mlp_block_launch`), at the 7 shapes,
  batch 8, bf16, in one process, alternating (op, direct, direct, op):
  200 calls without a synchronise, median of 5, each.
- time-bwd: K6 (fed K2's residual pack) and K6r at the 7 shapes, batch 16
  (the train batch), bf16: per launch of the wrapper, the device ms of the
  main kernel, of the dxn epilogue and of the wrapper's torch sums from a
  profiler trace, CUDA-event ms (20 launches), host microseconds per call;
  the head groups G and CTAs, and where the checkout reports them
  (`kernels.mixer_block_bwd_info`, `block.PATHS`) the CTAs per SM,
  registers, shared memory and the path each launch took.  Then K5 and
  its z1 variant at the same shapes and batch, and K7 and K7b at the four
  stochastic-depth shapes (`CLUSTER_SHAPES`, batch 16): the main kernel's
  and the wrapper's torch reductions' device ms by trace, events, host
  microseconds, and where the checkout reports them
  (`kernels.mlp_block_bwd_info`, `kernels.cluster_mix_info`, the
  `PATHS` of `ops/block.py` and `ops/cluster_fused.py`) the CTAs, cluster
  size, partial-row bytes, CTAs per SM, registers, shared memory, threads
  and path.  Then K3 (SimOTA, one wrapper call of three kernels) on two
  inputs: the step's data (`make_batch(default_rng(70), 16, 512^2,
  max_boxes=100)` through the r05 head, sliced as `yolox_loss` slices it:
  48 valid GT rows) and chip_smoke.py's probe (seed 6, noised logits,
  0/1/7/100 GTs x 4: 432 valid rows): per call, the trace device ms of
  each kernel and of the wrapper's other device operations, the device
  operations per call, events and host microseconds, and K3 against its
  plain twin on the same input (fg agreement, matched GT equal where both
  are fg, num_fg, dynamic-k agreement).  Then K4 and K4b (the fused seg
  loss) on chip_smoke.py's phase-6 inputs ((16, 512, 512, 9) bf16 logits,
  randn * 2 from a generator seeded 6, ~10% ignored pixels), without and
  with class weights: per call of the loss's forward
  (`fused_seg_loss_and_fscore`), of its backward (`torch.autograd.grad`
  through it) and of the train step's span (the model's bf16 NCHW seg map
  through its NHWC f32 output, `train_step.seg_loss_and_fscore` and the
  backward to that map, the casts included), the trace device ms of K4,
  of K4b and of every other device operation, the operations per call,
  events and host microseconds.  Last, each kernel's per-step sums (calls
  per train step x ms).  `--only k6,k5,k7,k3,k4` picks families (default:
  all).
- forward: the r05 weights (`--weights`, by default the checkout's) in
  nano coc_small at 512^2, bf16; per forward at batch 8 and 32
  (`--batches`): CUDA-event ms (5 repeats of 10 forwards), the host's wall
  ms (10 forwards between two synchronises), and the device busy ms and
  device operations from a trace of 5 forwards.
- route (a checkout with `ops/custom_ops.py`): the same forward with K2
  and K1 reached through the registered operators and with the launches
  they wrap called directly, alternating (op, direct, direct, op) 6 times
  in one process: CUDA-event ms of 10 forwards each; the host's ms to
  issue one forward (100 each way, alternating, from an idle card;
  quartiles), with the garbage collector on and off, and again with each
  K2 and K1 call timed inside the forward (µs a call); and each way's
  device busy ms from a trace.
- bits: K7's output and assignment and K7b's outputs and assignment at the
  four stochastic-depth shapes, batch 16, f32 and bf16 (seeded inputs), and
  the fused seg loss's value, f_score and d logits (K4, K4b) on the k4
  inputs, f32 and bf16, without and with class weights;
  `--save FILE` writes them, `--compare FILE` (from another checkout)
  prints per tensor whether the bits are equal and how many elements
  differ.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asy_vrnet_tpu_torch.ops import block  # noqa: E402
from asy_vrnet_tpu_torch.utils.profiling import cuda_ms, kernel_table, traced  # noqa: E402

# (name, B, H, W, C, heads, head_dim, fold, hid, calls per forward)
SHAPES = [("stage0", 8, 128, 128, 16, 4, 32, 8, 128, 4),
          ("stage1", 8, 64, 64, 32, 4, 32, 4, 256, 4),
          ("stage2", 8, 32, 32, 80, 8, 32, 2, 320, 12),
          ("stage3", 8, 16, 16, 128, 8, 32, 1, 512, 4),
          ("p5", 8, 16, 16, 128, 4, 24, 2, 512, 1),
          ("p4", 8, 32, 32, 160, 4, 24, 2, 640, 1),
          ("p3", 8, 64, 64, 64, 4, 24, 2, 256, 1)]
# the stand-alone cluster mix at the stochastic-depth train step: (name, B,
# H, W, inner width I, heads, fold, calls per step)
CLUSTER_SHAPES = [("stage0", 16, 128, 128, 128, 4, 8, 2),
                  ("stage1", 16, 64, 64, 128, 4, 4, 4),
                  ("stage2", 16, 32, 32, 256, 8, 2, 12),
                  ("stage3", 16, 16, 16, 256, 8, 1, 4)]
SEEDS = (0, 11, 14, 15, 21)
R05 = os.path.join("model_data", "convergence_tpu_r05", "logs_512c", "best_epoch_weights.npz")


def _weights(c, inner, hid, seed):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale  # noqa: E731
    mixer = (n(c, inner, scale=c ** -0.5), n(inner, scale=0.1), n(c, inner, scale=c ** -0.5),
             n(inner, scale=0.1), n(inner, c, scale=inner ** -0.5), n(c, scale=0.1),
             torch.tensor([1.5, 0.2]))
    mlp = (n(c, hid, scale=c ** -0.5), n(hid, scale=0.1), n(hid, c, scale=hid ** -0.5),
           n(c, scale=0.1))
    return n, mixer, mlp


def _cast(ws, dt, dev):
    return [w.to(dev, dt if w.dim() == 2 else torch.float32).contiguous() for w in ws]


def _margins(x, st, args, kw, asg):
    """The twin's max logit less its logit at K2's pick, where they differ."""
    wf, bf, wv, bv, _, _, ab = args
    p = block._mixer_planes(x, st, wf, bf, wv, bv, ab, **kw)
    logit = ab[1] + ab[0] * p.cos
    karg = block._regions(asg.permute(0, 2, 3, 1), kw["fold_h"], kw["fold_w"])[0].long()
    gap = logit.max(-1).values - logit.gather(-1, karg[..., None])[..., 0]
    return gap[karg != p.arg]


def check(dev, emit):
    cpu = torch.device("cpu")
    for (name, _, h, w, c, heads, d, fold, hid, _) in SHAPES:
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        for b in (1, 8, 16, 32):
            for seed in SEEDS:
                n, mixer, _ = _weights(c, heads * d, hid, seed)
                x = n(b, h, w, c).to(dev)
                st = block.gn1_stats(x)
                args = _cast(mixer, torch.float32, dev)
                out, _, asg = block.mixer_block(x, st, *args, return_assign=True, **kw)
                ref, _, rasg = block.mixer_block_plain(x, st, *args, return_assign=True, **kw)
                ymax = (ref - x).abs().max().item()
                dmax = (out - ref).abs().max().item()
                rec = {"mode": "check", "shape": name, "b": b, "seed": seed,
                       "pairs": asg.numel(), "flips": int((asg != rasg).sum().item()),
                       "margins": _margins(x, st, args, kw, asg).tolist(),
                       "direct_max": dmax, "ymax": ymax,
                       "direct_ok": dmax <= 1e-4 * max(1.0, ymax)}
                if name == "p3" and b in (16, 32):
                    _, _, casg = block.mixer_block_plain(
                        x.to(cpu), st.to(cpu), *_cast(mixer, torch.float32, cpu),
                        return_assign=True, **kw)
                    rec["cpu_twin_vs_card_twin"] = int((casg.to(dev) != rasg).sum().item())
                    rec["cpu_twin_vs_kernel"] = int((casg.to(dev) != asg).sum().item())
                emit(rec)


def _trace_rows(fn, iters=20):
    """{kernel name: (device ms, launches)} per fn() call, from one trace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        traced(lambda: [fn() for _ in range(iters)], d, on_card=True)
        for (nm, _), (ms, k) in kernel_table(d, iters).items():
            t, n = rows.get(nm, (0.0, 0.0))
            rows[nm] = (t + ms, n + k)
    return rows


def _per_launch(rows, kernel):
    hit = [v for nm, v in rows.items() if kernel in nm]
    return sum(ms for ms, _ in hit) / max(1e-9, sum(k for _, k in hit)) if hit else None


def _device_ms(fn, kernel, iters=20):
    return _per_launch(_trace_rows(fn, iters), kernel) or 0.0


def _host_us(fn, calls=200, reps=5):
    vals = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        vals.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(vals)[reps // 2]


def timing(dev, emit):
    for (name, b, h, w, c, heads, d, fold, hid, calls) in SHAPES:
        n, mixer, mlp = _weights(c, heads * d, hid, 0)
        x = n(b, h, w, c).to(dev, torch.bfloat16)
        st = block.gn1_stats(x)
        mw, lw = _cast(mixer, torch.bfloat16, dev), _cast(mlp, torch.bfloat16, dev)
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        rec = {"mode": "time", "shape": name, "calls": calls}
        for k, fn, kernel in (
                ("k2", lambda: block.mixer_block(x, st, *mw, **kw), "mixer_block_kernel"),
                ("k1", lambda: block.mlp_block(x, st, *lw), "mlp_block_mma_kernel")):
            rec[f"{k}_device_ms"] = _device_ms(fn, kernel)
            rec[f"{k}_events_ms"] = cuda_ms(fn, 20)
            rec[f"{k}_host_us"] = _host_us(fn)
        emit(rec)


def time_bwd(dev, emit, batch=16, only=("k6", "k5", "k7", "k3", "k4"), weights=R05):
    from asy_vrnet_tpu_torch.ops import kernels

    paths = getattr(block, "PATHS", {})
    step = {}  # per kernel: the sums over shapes of calls x ms
    if "k4" in only:
        _time_seg(dev, emit, batch, step)
    if "k3" in only:
        _time_simota(dev, emit, batch, step, weights)
    if "k5" in only:
        _time_mlp_bwd(dev, emit, batch, step)
    if "k7" in only:
        _time_cluster(dev, emit, batch, step)
    # the head groups depend on the element size since the tensor-core tiles
    by_dtype = ({"dtype": torch.bfloat16}
                if "dtype" in inspect.signature(kernels.mixer_bwd_groups).parameters else {})
    for (name, _, h, w, c, heads, d, fold, hid, calls) in SHAPES if "k6" in only else ():
        n, mixer, _ = _weights(c, heads * d, hid, 0)
        x = n(batch, h, w, c).to(dev, torch.bfloat16)
        gy = (n(batch, h, w, c) * 0.5).to(dev, torch.bfloat16)
        st = block.gn1_stats(x)
        mw = _cast(mixer, torch.bfloat16, dev)
        wf, bf, wv, bv, w2, _, ab = mw
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        _, _, pack = block.mixer_block(x, st, *mw, return_residuals=True, **kw)
        for k, res in (("k6", pack), ("k6r", None)):
            def fn(res=res):
                return block.mixer_block_bwd(x, gy, st, wf, bf, wv, bv, w2, ab, res, **kw)

            before = dict(paths)
            fn()
            torch.cuda.synchronize()
            groups = kernels.mixer_bwd_groups(c, heads * d, heads, batch * fold * fold, 2, 2,
                                              res is None, dev, **by_dtype)
            rec = {"mode": "time-bwd", "kernel": k, "shape": name, "b": batch, "calls": calls,
                   "groups": groups, "ctas": batch * fold * fold * groups,
                   "path": {p: v - before.get(p, 0) for p, v in paths.items()
                            if v != before.get(p, 0)} or None}
            if hasattr(kernels, "mixer_block_bwd_info"):
                rec.update(kernels.mixer_block_bwd_info(torch.bfloat16, c, heads * d, heads, 2,
                                                        2, groups, res is None, dev))
            rows = _trace_rows(fn)
            main_ms = _per_launch(rows, "mixer_bwd_kernel")
            epi_ms = _per_launch(rows, "mixer_bwd_epilogue")
            launches = sum(n for nm, (_, n) in rows.items() if "mixer_bwd_kernel" in nm)
            other = sum(ms for nm, (ms, _) in rows.items()
                        if "mixer_bwd_kernel" not in nm and "mixer_bwd_epilogue" not in nm)
            rec.update(main_device_ms=main_ms, epilogue_device_ms=epi_ms,
                       torch_device_ms=other / max(1e-9, launches),
                       events_ms=cuda_ms(fn, 20), host_us=_host_us(fn, calls=50))
            emit(rec)
            tot = step.setdefault(k, {})
            for f in ("main_device_ms", "epilogue_device_ms", "torch_device_ms", "events_ms"):
                tot[f] = tot.get(f, 0.0) + calls * (rec[f] or 0.0)
    for k, tot in step.items():
        emit({"mode": "time-bwd", "kernel": k, "shape": "per step", "b": batch, **tot})


def _path(fn, paths):
    """The PATHS keys one call of fn moves (None where the checkout has no
    PATHS for it)."""
    before = dict(paths)
    fn()
    torch.cuda.synchronize()
    return {p: v - before.get(p, 0) for p, v in paths.items() if v != before.get(p, 0)} or None


def _record(fn, main):
    """Trace, events and host time of one wrapper: device ms per launch of
    the kernels named `main` and of everything else the call launched (the
    wrapper's torch reductions), events ms and host us a call."""
    rows = _trace_rows(fn)
    launches = sum(n for nm, (_, n) in rows.items() if main in nm)
    other = sum(ms for nm, (ms, _) in rows.items() if main not in nm)
    return dict(main_device_ms=_per_launch(rows, main),
                torch_device_ms=other / max(1e-9, launches),
                events_ms=cuda_ms(fn, 20), host_us=_host_us(fn, calls=50))


def _add_step(step, k, rec, calls):
    tot = step.setdefault(k, {})
    for f in ("main_device_ms", "torch_device_ms", "events_ms"):
        tot[f] = tot.get(f, 0.0) + calls * (rec[f] or 0.0)
    if rec.get("part_bytes") is not None:
        tot["part_bytes"] = tot.get("part_bytes", 0) + calls * rec["part_bytes"]


def _time_mlp_bwd(dev, emit, batch, step):
    """K5 and K5 with z1 at the 7 block shapes."""
    from asy_vrnet_tpu_torch.ops import kernels

    paths = getattr(block, "PATHS", {})
    for (name, _, h, w, c, heads, d, fold, hid, calls) in SHAPES:
        n, _, mlp = _weights(c, heads * d, hid, 0)
        x = n(batch, h, w, c).to(dev, torch.bfloat16)
        gy = (n(batch, h, w, c) * 0.5).to(dev, torch.bfloat16)
        st = block.gn1_stats(x)
        lw = _cast(mlp, torch.bfloat16, dev)
        w1, b1, w2, _ = lw
        _, z1 = block.mlp_block(x, st, *lw, return_z1=True)
        for k, zz in (("k5", None), ("k5_z1", z1)):
            def fn(zz=zz):
                return block.mlp_block_bwd(x, gy, st, w1, b1, w2, zz)

            rec = {"mode": "time-bwd", "kernel": k, "shape": name, "b": batch, "calls": calls,
                   "path": _path(fn, paths)}
            if hasattr(kernels, "mlp_block_bwd_info"):
                rec.update(kernels.mlp_block_bwd_info(torch.bfloat16, batch, h * w, c, hid,
                                                      zz is not None, dev))
            rec.update(_record(fn, "mlp_block_bwd"))
            emit(rec)
            _add_step(step, k, rec, calls)


def _time_cluster(dev, emit, batch, step):
    """K7 and K7b at the four stochastic-depth shapes."""
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import kernels

    paths = getattr(cf, "PATHS", {})
    g = torch.Generator().manual_seed(4)
    ab = torch.tensor([1.5, 0.2], device=dev)
    for (name, _, h, w, inner, heads, fold, calls) in CLUSTER_SHAPES:
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        feat, value, gy = (torch.randn(batch, h, w, inner, generator=g).mul(sc).to(
            dev, torch.bfloat16) for sc in (1.0, 1.0, 0.5))
        for k, fn, main in (
                ("k7", lambda: cf.cluster_mix_fwd(feat, value, ab, **kw), "cluster_mix_kernel"),
                ("k7b", lambda: cf.cluster_mix_bwd(feat, value, gy, ab, **kw),
                 "cluster_mix_bwd_kernel")):
            rec = {"mode": "time-bwd", "kernel": k, "shape": name, "b": batch, "calls": calls,
                   "path": _path(fn, paths)}
            if hasattr(kernels, "cluster_mix_info"):
                rec.update(kernels.cluster_mix_info(torch.bfloat16, tuple(feat.shape),
                                                    backward=k == "k7b", device=dev, **kw))
            rec.update(_record(fn, main))
            emit(rec)
            _add_step(step, k, rec, calls)


SIMOTA_KERNELS = ("simota_prep_kernel", "simota_rows_kernel", "simota_resolve_kernel")


def _simota_inputs(dev, batch, weights):
    """{input name: the 8 tensor arguments of `simota_assign_batched`}: the
    step's data (the train step's first batch through the r05 head, sliced
    as `yolox_loss` slices `decode_for_loss`'s tensor) and chip_smoke.py's
    phase-6 probe (contiguous, noised logits, 0/1/7/100 GTs)."""
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.ops.boxes import decode_for_loss

    cfg = ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                      input_size=(512, 512), seg_signed_logits=True)
    model = create_model(cfg, device=dev, weights=weights)

    def head(bt):
        with torch.no_grad():
            det, _ = model(torch.from_numpy(bt["image"]).to(dev),
                           torch.from_numpy(bt["radar"]).to(dev))
            outs, grids, svec = decode_for_loss(det, (8, 16, 32))
        return outs.float(), grids, svec

    out = {}
    bt = make_batch(np.random.default_rng(70), batch, (512, 512), max_boxes=100)
    model.train()
    outs, grids, svec = head(bt)
    gt = [torch.from_numpy(bt[k]).to(dev) for k in ("gt_boxes", "gt_classes", "gt_valid")]
    out["step"] = [outs[..., :4], outs[..., 5:], outs[..., 4], *gt, grids, svec]
    model.eval()
    rng = np.random.default_rng(6)
    outs, grids, svec = head(make_batch(rng, batch, (512, 512), max_boxes=100))
    noise = torch.from_numpy(rng.normal(0, 0.5, outs[..., 4:].shape).astype(np.float32)).to(dev)
    gb = np.zeros((batch, 100, 4), np.float32)
    gv = np.zeros((batch, 100), bool)
    for i, n in enumerate([0, 1, 7, 100] * (batch // 4)):
        gb[i, :n] = np.concatenate([rng.uniform(32, 480, (n, 2)), rng.uniform(24, 160, (n, 2))],
                                   -1)
        gv[i, :n] = True
    gc = rng.integers(0, cfg.num_classes, (batch, 100)).astype(np.int32)
    out["probe"] = [outs[..., :4].contiguous(), (outs[..., 5:] + noise[..., 1:]).contiguous(),
                    (outs[..., 4] + noise[..., 0]).contiguous(),
                    *(torch.from_numpy(x).to(dev) for x in (gb, gc, gv)), grids, svec]
    del model
    return out


def _time_simota(dev, emit, batch, step, weights):
    """K3 per wrapper call on the step's data and on chip_smoke's probe."""
    from asy_vrnet_tpu_torch.ops import simota_fused

    for name, args in _simota_inputs(dev, batch, weights).items():
        def fn(args=args):
            return simota_fused.simota_assign_batched(*args)

        _, dyn = simota_fused.simota_assign_batched(*args, return_dynamic_ks=True)
        rows = _trace_rows(fn)
        calls = sum(n for nm, (_, n) in rows.items() if SIMOTA_KERNELS[1] in nm)
        rec = {"mode": "time-bwd", "kernel": "k3", "shape": name, "b": batch, "calls": 1,
               "valid_rows": int(args[5].sum().item()), "dynamic_k_sum": int(dyn.sum().item())}
        for k in SIMOTA_KERNELS:
            rec[k.split("_")[1] + "_device_ms"] = _per_launch(rows, k)
        ours = sum(ms for nm, (ms, _) in rows.items() if any(k in nm for k in SIMOTA_KERNELS))
        other = sum(ms for nm, (ms, _) in rows.items()
                    if not any(k in nm for k in SIMOTA_KERNELS))
        rec.update(main_device_ms=ours / max(1e-9, calls),
                   torch_device_ms=other / max(1e-9, calls),
                   device_ops=sum(n for _, n in rows.values()) / max(1e-9, calls),
                   device_op_names=sorted({nm[:60] for nm in rows}),
                   events_ms=cuda_ms(fn, 20), host_us=_host_us(fn, calls=50))
        ker, kdyn = simota_fused.simota_assign_batched(*args, return_dynamic_ks=True)
        ref, rdyn = simota_fused.simota_assign_batched(*args, use_kernel=False,
                                                       return_dynamic_ks=True)
        both = ker.fg_mask & ref.fg_mask
        rec.update(fg_agreement=(ker.fg_mask == ref.fg_mask).float().mean().item(),
                   fg_mismatches=int((ker.fg_mask != ref.fg_mask).sum().item()),
                   matched_equal=bool(torch.equal(ker.matched_gt[both], ref.matched_gt[both])),
                   num_fg=[ker.num_fg.sum().item(), ref.num_fg.sum().item()],
                   dynamic_k_agreement=(kdyn == rdyn).float().mean().item())
        emit(rec)
        if name == "step":
            _add_step(step, "k3", rec, 1)


SEG_KERNELS = ("seg_loss_sums", "seg_loss_dlogits")


def _seg_inputs(dev, batch, dtype=torch.bfloat16):
    """chip_smoke.py's phase-6 seg-loss inputs: (B, 512, 512, 9) logits
    (randn * 2, generator seeded 6) in `dtype`, the int32 target with ~10%
    ignored pixels, and the class weights {"plain": None, "weighted":
    linspace(0.5, 2, 9)}."""
    c = 9
    gen = torch.Generator().manual_seed(6)
    logits = torch.randn(batch, 512, 512, c, generator=gen) * 2
    target = torch.randint(0, c, (batch, 512, 512), generator=gen, dtype=torch.int32)
    target[torch.rand(target.shape, generator=gen) < 0.1] = c
    weights = {"plain": None, "weighted": torch.linspace(0.5, 2.0, c).to(dev)}
    return logits.to(dev, dtype), target.to(dev), weights


def _seg_calls(dev, batch):
    """{(call, weights): fn} of the k4 family (see the module's docstring)."""
    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.ops.losses_seg_fused import fused_seg_loss_and_fscore
    from asy_vrnet_tpu_torch.train import train_step

    logits, target, weights = _seg_inputs(dev, batch)
    one = torch.ones((), device=dev)
    # the decoder's bf16 map as the model holds it: NCHW, channels_last
    seg_map = logits.permute(0, 3, 1, 2).detach().requires_grad_(True)
    out = {}
    for wname, w in weights.items():
        cfg = Config(model=ModelConfig(phi="nano", variant="coc_small",
                                       compute_dtype="bfloat16", input_size=(512, 512)),
                     loss=LossConfig(use_pallas_seg=True, cls_balance_weights=None if w is None
                                     else tuple(w.tolist())))
        lg = logits.detach().requires_grad_(True)
        loss, _ = fused_seg_loss_and_fscore(lg, target, w, 9, use_kernel=True)

        def fwd(w=w):
            return fused_seg_loss_and_fscore(logits, target, w, 9, use_kernel=True)

        def bwd(loss=loss, lg=lg):
            return torch.autograd.grad(loss, lg, one, retain_graph=True)

        def span(cfg=cfg):
            # the model's output cast (models/efficient_vrnet.py: NHWC, f32),
            # the step's seg loss, and the backward to the decoder's map
            loss, _ = train_step.seg_loss_and_fscore(
                cfg, seg_map.permute(0, 2, 3, 1).float(), {"seg_target": target})
            return torch.autograd.grad(loss, seg_map, one)

        out.update({("forward", wname): fwd, ("backward", wname): bwd,
                    ("step span", wname): span})
    return out


def _time_seg(dev, emit, batch, step):
    """K4 and K4b per call: the loss's forward, its backward and the train
    step's span from the model's seg output to its gradient."""
    for (call, wname), fn in _seg_calls(dev, batch).items():
        rows = _trace_rows(fn)
        calls = max(sum(n for nm, (_, n) in rows.items() if k in nm) for k in SEG_KERNELS)
        rec = {"mode": "time-bwd", "kernel": "k4", "shape": f"{call} {wname}", "b": batch,
               "calls": 1}
        for k in SEG_KERNELS:
            rec[f"{k}_device_ms"] = sum(ms for nm, (ms, _) in rows.items() if k in nm) / calls
        other = {nm: v for nm, v in rows.items() if not any(k in nm for k in SEG_KERNELS)}
        rec.update(other_device_ms=sum(ms for ms, _ in other.values()) / calls,
                   other_ops=sum(n for _, n in other.values()) / calls,
                   device_ops=sum(n for _, n in rows.values()) / calls,
                   device_op_names=sorted({nm[:60] for nm in rows}),
                   events_ms=cuda_ms(fn, 20), host_us=_host_us(fn, calls=50))
        emit(rec)
        if wname == "plain" and call != "step span":
            _add_step(step, "k4" if call == "forward" else "k4b", dict(rec, main_device_ms=sum(
                rec[f"{k}_device_ms"] for k in SEG_KERNELS),
                torch_device_ms=rec["other_device_ms"]), 1)


def _seg_bits(dev, batch):
    """{key: {name: tensor}}: the fused seg loss's value, f_score and d
    logits (focal + dice) on the k4 inputs, f32 and bf16."""
    from asy_vrnet_tpu_torch.ops.losses_seg_fused import fused_seg_loss_and_fscore

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        logits, target, weights = _seg_inputs(dev, batch, dt)
        for wname, w in weights.items():
            lg = logits.detach().requires_grad_(True)
            loss, fs = fused_seg_loss_and_fscore(lg, target, w, 9, use_kernel=True)
            (grad,) = torch.autograd.grad(loss, lg)
            out[f"seg {wname} {str(dt)[6:]}"] = {
                "k4_loss": loss.detach().cpu(), "k4_fscore": fs.detach().cpu(),
                "k4b_dlogits": grad.cpu()}
    return out


def bits(dev, emit, save=None, compare=None, batch=16):
    """K7's and K7b's outputs at CLUSTER_SHAPES (seeded) and the fused seg
    loss's (`_seg_bits`): saved to `save`, or held bit for bit against
    those `compare` holds."""
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf

    names = ("k7_out", "k7_assign", "k7b_dfeat", "k7b_dvalue", "k7b_dab", "k7b_assign")
    g = torch.Generator().manual_seed(4)
    ab = torch.tensor([1.5, 0.2], device=dev)
    out = {}
    for (name, _, h, w, inner, heads, fold, _) in CLUSTER_SHAPES:
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        f32s = [torch.randn(batch, h, w, inner, generator=g) * sc for sc in (1.0, 1.0, 0.5)]
        for dt in (torch.float32, torch.bfloat16):
            feat, value, gy = (t.to(dev, dt) for t in f32s)
            y, asg = cf.cluster_mix_fwd(feat, value, ab, return_assign=True, **kw)
            got = cf.cluster_mix_bwd(feat, value, gy, ab, return_assign=True, **kw)
            out[f"{name} {str(dt)[6:]}"] = dict(zip(names, (t.cpu() for t in (y, asg, *got))))
    out.update(_seg_bits(dev, batch))
    if save:
        torch.save(out, save)
    if compare:
        other = torch.load(compare)
        for key, tensors in out.items():
            emit({"mode": "bits", "shape": key, **{
                n: {"equal": bool(torch.equal(a, other[key][n])),
                    "differ": int((a != other[key][n]).sum().item()),
                    "max_abs": (a.float() - other[key][n].float()).abs().max().item()}
                for n, a in tensors.items()}})

def dispatch(dev, emit):
    for (name, b, h, w, c, heads, d, fold, hid, calls) in SHAPES:
        n, mixer, mlp = _weights(c, heads * d, hid, 0)
        x = n(b, h, w, c).to(dev, torch.bfloat16)
        st = block.gn1_stats(x)
        mw, lw = _cast(mixer, torch.bfloat16, dev), _cast(mlp, torch.bfloat16, dev)
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        fns = {"k2_op": lambda: torch.ops.asy_vrnet.mixer_block.default(
                   x, st, *mw, heads, fold, fold, 2, 2),
               "k2_direct": lambda: block.mixer_block_launch(x, st, *mw, **kw),
               "k1_op": lambda: torch.ops.asy_vrnet.mlp_block.default(x, st, *lw),
               "k1_direct": lambda: block.mlp_block_launch(x, st, *lw)}
        rec = {"mode": "dispatch", "shape": name, "calls": calls}
        for k in ("k2", "k1"):
            us = {"op": [], "direct": []}
            for way in ("op", "direct", "direct", "op"):
                us[way].append(_host_us(fns[f"{k}_{way}"]))
            rec.update({f"{k}_{way}_us": v for way, v in us.items()})
        emit(rec)


def _r05_model(dev, weights):
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    cfg = ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                      input_size=(512, 512), seg_signed_logits=True)
    return create_model(cfg, weights=weights)


def _forward_fn(model, bs, dev):
    r = np.random.default_rng(bs)
    img = torch.from_numpy(r.standard_normal((bs, 512, 512, 3)).astype(np.float32)).to(dev)
    rad = torch.from_numpy(r.random((bs, 512, 512, 4)).astype(np.float32)).to(dev)

    def fn():
        with torch.no_grad():
            return model(img, rad)
    return fn


def _busy(fn, iters=5):
    """(device busy ms, device operations) per fn() call, from one trace: the
    kernels', copies' and memsets' summed time (one stream, so no overlap).
    A trace may hold one call fewer than it ran (see `profiling.traced`):
    the calls it holds are counted by K2's launches, 27 a forward."""
    with tempfile.TemporaryDirectory() as d:
        traced(lambda: [fn() for _ in range(iters)], d, on_card=True)
        with open(os.path.join(d, "trace.json")) as fh:
            ev = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    calls = sum("mixer_block_kernel" in e["name"] for e in ev) / 27 or 1
    return sum(e["dur"] for e in ev) / calls / 1e3, len(ev) / calls


def _host_ms(fn, iters=10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def forward(dev, emit, weights=R05, batches=(8, 32)):
    model = _r05_model(dev, weights)
    for bs in batches:
        fn = _forward_fn(model, bs, dev)
        ms = [cuda_ms(fn, 10, warmup=2 if i == 0 else 0) for i in range(5)]
        busy, ops = _busy(fn)
        emit({"mode": "forward", "bs": bs, "ms": ms, "host_ms": _host_ms(fn),
              "busy_ms": busy, "device_ops": ops})


def _issue_ms(fn, ways, n, gc_on):
    """{way: [the host's ms to issue one forward]}, n forwards each way,
    alternating, each started on an idle card; `gc_on` False: Python's
    cyclic garbage collector off while they run."""
    import gc

    issue = {w: [] for w in ways}
    if not gc_on:
        gc.collect()
        gc.disable()
    try:
        for i in range(n):
            for way in (("op", "direct") if i % 2 else ("direct", "op")):
                block.mixer_block, block.mlp_block = ways[way]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                issue[way].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return issue


def route(dev, emit, weights=R05, batches=(8, 32), rounds=6, issues=100):
    """The forward with K2 and K1 reached through the registered operators
    (what `block.mixer_block` / `block.mlp_block` do on the card) and with
    the launches they wrap called directly, in one process: `rounds` x (op,
    direct, direct, op) of 10 forwards each by CUDA events; then `issues`
    forwards each way, alternating, each started on an idle card and timed
    by the host's clock until the call returns (the host's ms to issue a
    forward: the card runs a forward in less time than the host takes to
    issue it, so no launch waits for room in the queue), as quartiles, with
    Python's garbage collector on and off; then the same with each K2 and
    K1 call timed inside the forward (µs a call, quartiles); then one trace
    each way for the device busy time."""
    op = (block.mixer_block, block.mlp_block)
    direct = (lambda x, *a, **kw: block.mixer_block_launch(x, *a, **kw),
              lambda x, *a, **kw: block.mlp_block_launch(x, *a, **kw))
    ways = {"op": op, "direct": direct}
    call_us = {w: {"k2": [], "k1": []} for w in ways}

    def timed(fn, into):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            into.append((time.perf_counter() - t0) * 1e6)
            return out
        return call

    timed_ways = {w: (timed(f[0], call_us[w]["k2"]), timed(f[1], call_us[w]["k1"]))
                  for w, f in ways.items()}
    model = _r05_model(dev, weights)
    try:
        for bs in batches:
            fn = _forward_fn(model, bs, dev)
            ms = {"op": [], "direct": []}
            for i in range(rounds):
                for way in ("op", "direct", "direct", "op"):
                    block.mixer_block, block.mlp_block = ways[way]
                    before = block.LAUNCHES["mixer_block"]
                    ms[way].append(cuda_ms(fn, 10, warmup=2 if i == 0 else 1))
                    assert block.LAUNCHES["mixer_block"] - before == 27 * (
                        10 + (2 if i == 0 else 1)), "a forward skipped K2"
            rec = {"mode": "route", "bs": bs}
            for tag, wset in (("", ways), ("_calls", timed_ways)):
                for gc_on in (True, False):
                    issue = _issue_ms(fn, wset, issues, gc_on)
                    for way, v in issue.items():
                        key = f"{way}_issue{tag}{'' if gc_on else '_nogc'}_ms"
                        rec[key] = np.percentile(v, [25, 50, 75]).tolist()
            for way in ("op", "direct"):
                rec[f"{way}_call_us"] = {k: np.percentile(v, [25, 50, 75]).tolist()
                                         for k, v in call_us[way].items()}
                block.mixer_block, block.mlp_block = ways[way]
                rec[f"{way}_ms"] = ms[way]
                rec[f"{way}_busy_ms"], rec[f"{way}_device_ops"] = _busy(fn)
            emit(rec)
            for v in call_us.values():
                for times in v.values():
                    times.clear()
    finally:
        block.mixer_block, block.mlp_block = op


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("check", "time", "time-bwd", "forward", "bits",
                                     "dispatch", "route"))
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    ap.add_argument("--weights", default=R05,
                    help="forward, route, time-bwd k3: the r05 weights (.npz)")
    ap.add_argument("--batches", default="8,32", help="forward, route: the batch sizes")
    ap.add_argument("--only", default="k6,k5,k7,k3,k4",
                    help="time-bwd: the kernel families to time (k6, k5, k7, k3, k4)")
    ap.add_argument("--save", help="bits: write K7's, K7b's, K4's and K4b's outputs to "
                                   "this file")
    ap.add_argument("--compare", help="bits: hold them against this file's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_serving measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(rec):
        print("AB " + json.dumps({**rec, "tag": args.tag}), flush=True)

    dev = torch.device("cuda")
    batches = tuple(int(b) for b in args.batches.split(","))
    if args.mode == "forward":
        forward(dev, emit, args.weights, batches)
    elif args.mode == "route":
        route(dev, emit, args.weights, batches)
    elif args.mode == "time-bwd":
        time_bwd(dev, emit, only=tuple(args.only.split(",")), weights=args.weights)
    elif args.mode == "bits":
        bits(dev, emit, args.save, args.compare)
    else:
        {"check": check, "time": timing, "dispatch": dispatch}[args.mode](dev, emit)


if __name__ == "__main__":
    main()
