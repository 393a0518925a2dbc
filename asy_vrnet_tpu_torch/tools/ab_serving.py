"""Measurements of the serving path's two kernels (K2, K1) and its forward,
for comparing two checkouts of the port on one card.

    cd <checkout> && python <this file> {check|time|forward} [--tag NAME]

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
- forward: the r05 weights (`--weights`, by default the checkout's) in
  nano coc_small at 512^2, bf16; CUDA-event ms per forward at batch 8 and
  32, 5 repeats of 10 forwards.
"""
from __future__ import annotations

import argparse
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


def _device_ms(fn, kernel, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        traced(lambda: [fn() for _ in range(iters)], d, on_card=True)
        rows = [v for (nm, _), v in kernel_table(d, iters).items() if kernel in nm]
    return sum(ms for ms, _ in rows) / max(1, sum(k for _, k in rows))


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


def forward(dev, emit, weights=R05):
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    cfg = ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                      input_size=(512, 512), seg_signed_logits=True)
    model = create_model(cfg, weights=weights)
    for bs in (8, 32):
        r = np.random.default_rng(bs)
        img = torch.from_numpy(r.standard_normal((bs, 512, 512, 3)).astype(np.float32)).to(dev)
        rad = torch.from_numpy(r.random((bs, 512, 512, 4)).astype(np.float32)).to(dev)
        with torch.no_grad():
            ms = [cuda_ms(lambda: model(img, rad), 10, warmup=2 if i == 0 else 0)
                  for i in range(5)]
        emit({"mode": "forward", "bs": bs, "ms": ms})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("check", "time", "forward"))
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    ap.add_argument("--weights", default=R05, help="forward: the r05 weights (.npz)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_serving measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(rec):
        print("AB " + json.dumps({**rec, "tag": args.tag}), flush=True)

    dev = torch.device("cuda")
    if args.mode == "forward":
        forward(dev, emit, args.weights)
    else:
        {"check": check, "time": timing}[args.mode](dev, emit)


if __name__ == "__main__":
    main()
