#!/usr/bin/env python3
"""Smoke run of the PyTorch port (asy_vrnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
     print ptxas registers / shared memory / spills;
  2. at the 7 ClusterBlock shapes of nano coc_small at 512^2, batch 8, hold
     each kernel against its plain PyTorch twin on the card, bf16 (the main
     path) and f32;
  3. main path: load the trained r05 weights into nano coc_small at 512^2,
     bf16, run one batch-8 forward (launch counters reset just before, read
     just after: 27 launches of each kernel), compare it with the same
     forward through the plain twins, and check the card against the CPU
     (plain path, f32) at 128^2;
  4. the Detector answers 4 seeded requests (PIL image + radar array) laid
     out like the learnable synthetic set the r05 weights were trained on;
     at least half of the drawn objects must come back (IoU >= 0.5, right
     class).  r05 reached AP50 0.97 on its own 48 training images; these
     are new layouts;
  5. times each kernel per shape, its plain twin and its bound, the full
     forward at batch 8 and 32, and peak memory.

Tolerances:
  kernel vs plain, f32: max |diff| <= 1e-4 * max(1, max|y|) (mixer, y = out - x)
    or 1e-5 * max(1, max|out|) (MLP), assignment agreement >= 99.99%: the
    same formula in f32, sums in another order.
  kernel vs plain, bf16: the kernel rounds intermediates to bf16 where the
    TPU kernel does, the plain twin where the JAX package's module reference
    does, so near-tied assignments flip: mixer agreement >= 99%, mean |diff|
    <= 2% of max|y|, max |diff| <= max|y| + 2 bf16 ulps; MLP within 2 bf16
    ulps of max|out|.
  512^2 bf16 forward, kernels vs plain twins: every output finite with the
    expected shape; mean |diff| <= 5% of mean |ref| per output (bf16 rounding
    and flipped assignments compound through 27 blocks).
  128^2 f32 forward, card vs CPU: atol = rtol = 2e-3 (f32 kernels and f32
    cuDNN with TF32 off against the CPU's plain path through ~90 layers).
Bounds: max(flops / 989 TFLOP/s bf16, bytes / 3.35 TB/s), flops and bytes
counted from this run's shapes (each input read once, each output written
once).  No PyTorch library call computes either fused half: library_ms null.
"""
import json
import os
import subprocess
import sys
import time

PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bandwidth
R05 = os.path.join("model_data", "convergence_tpu_r05", "logs_512c", "best_epoch_weights.npz")

# (name, B, H, W, C, heads, head_dim, fold, hid, calls per batch-8 forward)
SHAPES = [
    ("stage0", 8, 128, 128, 16, 4, 32, 8, 128, 4),
    ("stage1", 8, 64, 64, 32, 4, 32, 4, 256, 4),
    ("stage2", 8, 32, 32, 80, 8, 32, 2, 320, 12),
    ("stage3", 8, 16, 16, 128, 8, 32, 1, 512, 4),
    ("p5", 8, 16, 16, 128, 4, 24, 2, 512, 1),
    ("p4", 8, 32, 32, 160, 4, 24, 2, 640, 1),
    ("p3", 8, 64, 64, 64, 4, 24, 2, 256, 1),
]
KERNELS = {
    "mixer_block": dict(source="asy_vrnet_tpu_torch/csrc/mixer_block.cu",
                        replaces="asy_vrnet_tpu/ops/block_pallas.py:583"),
    "mlp_block": dict(source="asy_vrnet_tpu_torch/csrc/mlp_block.cu",
                      replaces="asy_vrnet_tpu/ops/block_pallas.py:2022"),
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check raises (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def mixer_bounds(b, h, w, c, heads, d, fold):
    t, inner, m = b * h * w, heads * d, 4
    regions = b * fold * fold
    flops = (t * (2 * c * inner + 2 * inner * (m + 1) + 4 * c * heads)
             + regions * 8 * m * c * inner)
    byts = 2 * t * c * 2 + 3 * c * inner * 2
    return flops, byts


def mlp_bounds(b, h, w, c, hid):
    t = b * h * w
    return 4 * t * c * hid, 2 * t * c * 2 + 2 * c * hid * 2


def bound_ms(flops, byts):
    tf, tb = flops / PEAK_FLOPS, byts / PEAK_BYTES
    return max(tf, tb) * 1e3, ("operations" if tf >= tb else "bytes")


def learnable_request(rng):
    """One 512^2 request laid out like the learnable synthetic set r05 was
    trained on (asy_vrnet_tpu/data/synthetic.py::write_learnable_voc_dataset):
    dark noisy background, 1-3 solid rectangles whose colour encodes the
    class, radar rectangles in channels 0-2.  -> (PIL image, radar (4,H,W),
    [(x1, y1, x2, y2, det_cls)])."""
    import numpy as np
    from PIL import Image

    palette = np.asarray([[230, 25, 75], [60, 180, 75], [0, 130, 200], [255, 225, 25],
                          [240, 50, 230], [70, 240, 240], [245, 130, 48],
                          [255, 255, 255]], np.float64)
    h = w = 512
    img = rng.normal(30.0, 6.0, (h, w, 3))
    radar = rng.normal(0.0, 0.3, (4, h, w)).astype(np.float32)
    gt = []
    for _ in range(int(rng.integers(1, 4))):
        seg_cls = int(rng.integers(1, 9))
        det_cls = (seg_cls - 1) * 4 // 8
        bw, bh = int(rng.integers(w // 4, w // 2)), int(rng.integers(h // 4, h // 2))
        x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        img[y1:y1 + bh, x1:x1 + bw] = palette[seg_cls - 1] + rng.normal(0.0, 4.0, (bh, bw, 3))
        radar[0, y1:y1 + bh, x1:x1 + bw] = 8.0
        radar[1, y1:y1 + bh, x1:x1 + bw] = float(det_cls + 1) * 2.0
        radar[2, y1:y1 + bh, x1:x1 + bw] = float(seg_cls)
        gt.append((x1, y1, x1 + bw, y1 + bh, det_cls))
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)), radar, gt


def iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


CATEGORIES = (
    ("mixer_block (ours)", ("mixer_block",)),
    ("mlp_block (ours)", ("mlp_block",)),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "sm90_")),
    ("gemm", ("gemm", "cutlass")),
    ("resize", ("upsample", "interpolat")),
    ("reduction", ("reduce", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "permute", "index", "gather")),
)


def profile_forward(model, image, radar, reps=3):
    """torch.profiler over `reps` forwards: host wall time, device busy time,
    device time by category and the top kernels (per forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(image, radar)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(image, radar)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            t, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (t + e.device_time_total / 1e3 / reps, n + 1)
    device = sum(t for t, _ in kernels.values())
    cats = {c: 0.0 for c, _ in CATEGORIES}
    cats["other elementwise"] = 0.0
    for name, (t, _) in kernels.items():
        low = name.lower()
        for c, keys in CATEGORIES:
            if any(k in low for k in keys):
                cats[c] += t
                break
        else:
            cats["other elementwise"] += t
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "launches": sum(n for _, n in kernels.values()) // reps,
            "by_category_ms": cats,
            "top": [(name[:90], t, n // reps) for name, (t, n) in top]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.chdir(here)
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.infer.predictor import Detector
    from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.ops import block, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. build ----
    t0 = time.time()
    kernels.build()
    log(f"[build] {len(kernels.SOURCES)} libraries in {time.time() - t0:.1f} s")
    for name in kernels.SOURCES:
        for line in kernels.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # ---- 2. kernels vs plain twins at the main path's shapes ----
    stats_out = {k: {"max_abs_err": 0.0, "per_shape": []} for k in KERNELS}
    g = torch.Generator().manual_seed(0)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def cast(ws, dt):
        return [w.to(dev, dt if w.dim() == 2 else torch.float32).contiguous() for w in ws]

    inputs = {}
    for (name, b, h, w, c, heads, d, fold, hid, _) in SHAPES:
        inner = heads * d
        mixer_w = (rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(inner, c, scale=inner ** -0.5), rn(c, scale=0.1),
                   torch.tensor([1.5, 0.2]))
        mlp_w = (rn(c, hid, scale=c ** -0.5), rn(hid, scale=0.1),
                 rn(hid, c, scale=hid ** -0.5), rn(c, scale=0.1))
        x32 = rn(b, h, w, c)
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dev, dt)
            st = block.gn1_stats(x)
            mw, lw = cast(mixer_w, dt), cast(mlp_w, dt)
            out, mom, asg = block.mixer_block(x, st, *mw, return_assign=True, **kw)
            torch.cuda.synchronize()
            ref, rmom, rasg = block.mixer_block_plain(x, st, *mw, return_assign=True, **kw)
            diff = (out.float() - ref.float()).abs()
            ymax = (ref.float() - x.float()).abs().max().item()
            agree = (asg == rasg).float().mean().item()
            out_st = block._stats_from_moments(mom, h * w * c)
            ref_st = block._stats_from_moments(rmom, h * w * c)
            st_diff = (out_st - ref_st).abs().max().item()
            ulp = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
            log(f"[check mixer_block {name} {str(dt)[6:]}] max|diff| {diff.max().item():.4e} "
                f"mean|diff| {diff.mean().item():.4e} max|y| {ymax:.4e} "
                f"stats diff {st_diff:.4e} assignment agreement {agree:.6f}")
            if dt == torch.float32:
                check(agree >= 0.9999 and diff.max().item() <= 1e-4 * max(1.0, ymax), name)
            else:
                check(agree >= 0.99, name)
                check(diff.mean().item() <= 0.02 * ymax, name)
                check(diff.max().item() <= ymax + 2 * ulp, name)
                check(st_diff <= 1e-2 * max(1.0, ref_st.abs().max().item()), name)
                stats_out["mixer_block"]["max_abs_err"] = max(
                    stats_out["mixer_block"]["max_abs_err"], diff.max().item())
                stats_out["mixer_block"].setdefault("agreement", []).append(agree)
            y = block.mlp_block(x, st, *lw)
            torch.cuda.synchronize()
            yref = block.mlp_block_plain(x, st, *lw)
            dmax = (y.float() - yref.float()).abs().max().item()
            scale = yref.float().abs().max().item()
            log(f"[check mlp_block {name} {str(dt)[6:]}] max|diff| {dmax:.4e} max|out| {scale:.4e}")
            if dt == torch.float32:
                check(dmax <= 1e-5 * max(1.0, scale), name)
            else:
                check(dmax <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7), name)
                stats_out["mlp_block"]["max_abs_err"] = max(
                    stats_out["mlp_block"]["max_abs_err"], dmax)
                inputs[name] = (x, st, mw, lw, kw)

    # ---- 3. main path: r05 weights, nano coc_small 512^2 bf16, batch 8 ----
    # r05 was trained with signed seg logits and raw radar (radar_norm "none")
    cfg = ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                      input_size=(512, 512), seg_signed_logits=True)
    model = create_model(cfg, weights=R05)            # the card by default
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((8, 512, 512, 3)).astype(np.float32)).to(dev)
    rad = torch.from_numpy(rng.random((8, 512, 512, 4)).astype(np.float32)).to(dev)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((tuple(a[0].shape), m.heads, m.head_dim, m.fold_h)))
        for m in model.modules() if isinstance(m, ClusterBlock)]
    for k in block.LAUNCHES:
        block.LAUNCHES[k] = 0
    with torch.no_grad():
        det, seg = model(img, rad)
    torch.cuda.synchronize()
    launches = dict(block.LAUNCHES)
    for hk in hooks:
        hk.remove()
    log(f"[main path] launches {launches}")
    check(launches == {"mixer_block": 27, "mlp_block": 27}, launches)
    want = {(b, c, h, w, heads, d, fold) for (_, b, h, w, c, heads, d, fold, _, _) in SHAPES}
    check({s + (hd, dd, f) for s, hd, dd, f in seen} == want, seen)
    check([tuple(o.shape) for o in det] == [(8, 64, 64, 9), (8, 32, 32, 9), (8, 16, 16, 9)],
          "det shapes")
    check(tuple(seg.shape) == (8, 512, 512, 9), "seg shape")
    check(all(bool(torch.isfinite(o).all()) for o in (*det, seg)), "finite outputs")

    kernel_fns = (block.mixer_block, block.mlp_block)

    def plain_mixer(x, stats, *a, return_assign=False, **kw):
        return block.mixer_block_plain(x, stats, *a, return_assign=return_assign, **kw)

    block.mixer_block, block.mlp_block = plain_mixer, block.mlp_block_plain
    try:
        with torch.no_grad():
            det_p, seg_p = model(img, rad)
        torch.cuda.synchronize()
    finally:
        block.mixer_block, block.mlp_block = kernel_fns
    check(block.LAUNCHES == launches, "plain forward launched no kernel")
    for name, a, r in zip(("det p3", "det p4", "det p5", "seg"), (*det, seg), (*det_p, seg_p)):
        dd = (a - r).abs()
        rel = dd.mean().item() / r.abs().mean().item()
        log(f"[main path vs plain] {name}: max|diff| {dd.max().item():.4e} "
            f"mean|diff|/mean|ref| {rel:.4e}")
        check(rel <= 0.05, name)

    small = ModelConfig(phi="nano", variant="coc_small", compute_dtype="float32",
                        input_size=(128, 128), seg_signed_logits=True)
    card32 = create_model(small, weights=R05)
    cpu32 = create_model(small, device="cpu", weights=R05)
    si = torch.from_numpy(rng.standard_normal((2, 128, 128, 3)).astype(np.float32))
    sr = torch.from_numpy(rng.random((2, 128, 128, 4)).astype(np.float32))
    before = dict(block.LAUNCHES)
    with torch.no_grad():
        dc, sc = cpu32(si, sr)
        dg, sg = card32(si.to(dev), sr.to(dev))
    check(block.LAUNCHES["mixer_block"] > before["mixer_block"],
          "the 128^2 card forward used the kernels")
    for name, a, r in zip(("det p3", "det p4", "det p5", "seg"), (*dg, sg), (*dc, sc)):
        log(f"[card vs cpu 128^2 f32] {name}: max|diff| {(a.cpu() - r).abs().max().item():.4e}")
        torch.testing.assert_close(a.cpu(), r, atol=2e-3, rtol=2e-3)
    del card32, cpu32

    # ---- 4. Detector: 4 seeded requests ----
    detector = Detector(cfg, ["pier", "vessel", "ship", "boat"], model=model,
                        conf_thres=0.3, nms_thres=0.5, radar_norm="none")
    for k in block.LAUNCHES:
        block.LAUNCHES[k] = 0
    found = total = 0
    for i in range(4):
        image, radar, gt = learnable_request(np.random.default_rng(100 + i))
        res = detector.detect(image, radar)
        boxes = res["boxes"][:, [1, 0, 3, 2]]           # (y1,x1,y2,x2) -> xyxy
        check(boxes.shape[1:] == (4,) and np.isfinite(boxes).all(), "finite boxes")
        hits = [bool(len(boxes)) and max(
            iou(bx, g[:4]) if c == g[4] else 0.0 for bx, c in zip(boxes, res["classes"])
        ) >= 0.5 for g in gt]
        found += sum(hits)
        total += len(gt)
        log(f"[detector] request {i}: {len(boxes)} boxes, classes "
            f"{res['classes'].tolist()}, scores {np.round(res['scores'], 3).tolist()}; "
            f"ground truth {gt}; matched at IoU 0.5 {hits}")
    log(f"[detector] launches over 4 requests {dict(block.LAUNCHES)}; "
        f"recall@0.5 {found}/{total}")
    check(block.LAUNCHES == {"mixer_block": 108, "mlp_block": 108}, dict(block.LAUNCHES))
    check(found >= 0.5 * total, f"recall {found}/{total}")

    # ---- 5. timing ----
    report = []
    for kname in KERNELS:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0}
        for (name, b, h, w, c, heads, d, fold, hid, calls) in SHAPES:
            x, st, mw, lw, kw = inputs[name]
            if kname == "mixer_block":
                fk = lambda: block.mixer_block(x, st, *mw, **kw)          # noqa: E731
                fp = lambda: block.mixer_block_plain(x, st, *mw, **kw)    # noqa: E731
                flops, byts = mixer_bounds(b, h, w, c, heads, d, fold)
            else:
                fk = lambda: block.mlp_block(x, st, *lw)                  # noqa: E731
                fp = lambda: block.mlp_block_plain(x, st, *lw)            # noqa: E731
                flops, byts = mlp_bounds(b, h, w, c, hid)
            ms, pms = cuda_ms(fk, 20), cuda_ms(fp, 5, warmup=1)
            bms, by = bound_ms(flops, byts)
            log(f"[time {kname} {name}] kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {bms:.5f} ms ({by}), x{calls} per forward")
            stats_out[kname]["per_shape"].append(
                {"shape": name, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                 "bound_by": by, "calls_per_forward": calls})
            tot["ms"] += calls * ms
            tot["plain_ms"] += calls * pms
            tot["bound_ms"] += calls * bms
            tot["flops_ms"] += calls * flops / PEAK_FLOPS * 1e3
            tot["bytes_ms"] += calls * byts / PEAK_BYTES * 1e3
        report.append({
            "name": kname, "route": "cuda", **KERNELS[kname],
            "launches": launches[kname],
            "max_abs_err": stats_out[kname]["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["flops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": None,
            "per_shape": stats_out[kname]["per_shape"],
        })
    del inputs

    fwd = {}
    for bs in (8, 32):
        r = np.random.default_rng(bs)
        bi = torch.from_numpy(r.standard_normal((bs, 512, 512, 3)).astype(np.float32)).to(dev)
        br = torch.from_numpy(r.random((bs, 512, 512, 4)).astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = cuda_ms(lambda: model(bi, br), 10 if bs == 8 else 5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fwd[bs] = {"ms": ms, "fps": bs / ms * 1e3, "peak_gib": peak,
                   "profile": profile_forward(model, bi, br)}
        p = fwd[bs]["profile"]
        log(f"[forward bs={bs}] {ms:.3f} ms, {bs / ms * 1e3:.1f} frames/s, "
            f"peak memory {peak:.3f} GiB; profiled: wall {p['wall_ms']:.3f} ms, "
            f"device busy {p['device_ms']:.3f} ms ({p['busy_share']:.3f}), "
            f"{p['launches']} kernel launches")
        for cat, v in p["by_category_ms"].items():
            log(f"[forward bs={bs} device ms] {cat}: {v:.4f}")
        for name, v, n in p["top"]:
            log(f"[forward bs={bs} top] {v:.4f} ms x{n} {name}")
        del bi, br

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[total] {time.time() - t_start:.1f} s")
    print(json.dumps({"forward": fwd, "mixer_assignment_agreement_bf16":
                      stats_out["mixer_block"].get("agreement")}), flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
