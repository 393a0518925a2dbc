#!/usr/bin/env python3
"""Smoke run of the PyTorch port (asy_vrnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
     print ptxas registers / shared memory / spills;
  2. at the 7 ClusterBlock shapes of nano coc_small at 512^2, batch 8, hold
     each kernel against its plain PyTorch twin on the card, bf16 (the main
     path) and f32; two runs of K2 and of K1 give equal bits;
  3. main path: load the trained r05 weights into nano coc_small at 512^2,
     bf16, run one batch-8 forward (launch counters reset just before, read
     just after: 27 launches of each kernel, all 27 of K2 with its feat on
     tensor cores and all 27 of K1 on tensor cores with the tokens per CTA
     `kernels.mlp_tokens_per_cta` gives each shape), compare it with the same
     forward through the plain twins, and check the card against the CPU
     (plain path, f32) at 128^2;
  4. the Detector answers 4 seeded requests (PIL image + radar array) laid
     out like the learnable synthetic set the r05 weights were trained on;
     at least half of the drawn objects must come back (IoU >= 0.5, right
     class).  r05 reached AP50 0.97 on its own 48 training images; these
     are new layouts;
  5. times each kernel per shape (CUDA events; device time in a profiler
     trace beside it), its plain twin and its bound, with its launch
     geometry (CTAs, K2's CTAs per region, K1's tokens per CTA, CTAs per SM
     from the occupancy API, shared memory, registers, the path taken); the
     full forward at batch 8 and 32, and peak memory;
  6. kernels, training: the fused seg-loss forward and backward kernels
     (K4, K4b) against their plain twins at (16, 512, 512, 9), bf16 and f32,
     focal+dice and CE-only, with and without class weights, ~10% ignored
     pixels, three K4 calls giving the same bits; the f32-in variant the
     train step runs (the model's f32 output read as bf16) against the bf16
     path bit for bit; partial last tiles (1 and 300 pixels) and C = 21 (the
     generic instantiation); each kernel's time (events, trace), geometry,
     and the train step's span from the model's seg output to its gradient
     (device operations and ms by trace); the SimOTA kernel against its twin at B = 16, A = 5376, G = 100 with 0, 1, 7
     and 100 valid GTs, on the r05 model's head outputs plus seeded noise, and
     on a constructed case with duplicated GT boxes and duplicated anchors;
     the same call on the loss's strided views of one (B, A, 5 + C) tensor
     gives the same bits in at most 3 device operations (its three kernels,
     each timed in a profiler trace);
  7. kernels, block backward at the train batch: at the 7 ClusterBlock
     shapes with batch 16, bf16 and f32, K2's residual pack (winning cosine
     and proposal per (token, head), raw and mixed centers) against the
     twin's, the MLP-half backward kernel (K5) against its twin, and the
     mixer-half backward kernel (K6) against its twin with both fed the
     kernel's pack; two runs of each give equal bits; K6's products on
     tensor cores in bf16, on CUDA cores in f32, K5 on its cluster path in
     bf16 and its FMA path in f32 (`block.PATHS`); times and bounds, and a
     `[geometry mlp_block_bwd ...]` line per shape (CTAs, cluster size,
     partial-row bytes, CTAs per SM, registers, shared memory, clusters the
     card holds at once);
 7b. kernels of the memory settings, at the same shapes, batch 16, f32 and
     bf16: K6r (the full-remat mixer backward, ASY_MIXER_BWD_RESIDUALS=0)
     against its twin fed K6r's own assignment, which must equal the one K2
     stored in its pack bit for bit, and against K6 fed that pack (the same
     function); K1 with z1 (ASY_MLP_BWD_RESIDUALS=1: the same output bits as
     K1, z1 against the twin's) and K5 reading it against its twin fed the
     same z1; two runs of each give equal bits; K6r's path as K6's, K5 z1's
     as K5's; times, bounds and K5 z1's `[geometry ...]` lines;
  8. kernels, stand-alone cluster mix: K7 (cluster_mix) and K7b
     (cluster_mix_bwd) against their twins at the four shapes the
     stochastic-depth step gives them, batch 16, f32 and bf16:
     (16,128,128,128) fold 8 heads 4, (16,64,64,128) fold 4 heads 4,
     (16,32,32,256) fold 2 heads 8, (16,16,16,256) fold 1 heads 8; K7's and
     K7b's assignment outputs equal, and their mixed centers; two runs of
     each give equal bits; both on their fast instantiation
     (`cluster_fused.PATHS`); times (events, and a profiler trace), twin
     times, bounds and a `[geometry ...]` line per shape for each (CTAs,
     CTAs per SM, registers, shared memory, tiles staged);
  9. train path, fused blocks: r05 weights, `create_train_state`, 5 steps
     on seeded `make_batch` batches at 512^2, batch 16, bf16, fused
     ClusterBlocks (`use_pallas_cluster=True`, the JAX package's default),
     lr from `adaptive_lr`; launch counters reset before the first step and
     read after it (mixer_block, mlp_block, mixer_block_bwd, mlp_block_bwd 27
     each, cluster_mix and cluster_mix_bwd 0, seg_loss_sums 1,
     seg_loss_dlogits 1, simota_assign >= 1; every K6 and K6r launch of
     every bf16 train path on tensor cores, every K5 launch (either
     variant) on its cluster path and every K7 and K7b launch on its fast
     instantiation); losses finite, num_fg > 0,
     parameters, EMA and BN running stats moved; the same first step through
     the plain twins from the same start;
 10. the module-path train step (`use_pallas_cluster=False`, every block
     eager torch with plain autograd and the plain cluster mix): 2 steps
     from the same start and batches, the same checks with every block and
     cluster-mix kernel at 0 launches; its first step against the fused
     path's;
 11. train path, stochastic depth (the path K7/K7b run on): coc_small with
     drop_path_rate 0.1 (`dataclasses.replace`, registered in this process
     only), the same start, batches and checks, drop-path drawing from a
     seeded CUDA generator (`set_generator`); the 22 backbone blocks past
     stage 0's first take the module path with K7/K7b, the other 5 the
     fused blocks: per step cluster_mix and cluster_mix_bwd 22 each, the
     four block kernels 5 each, seg_loss_sums 1, seg_loss_dlogits 1,
     simota_assign >= 1; the first step through the twins from the same
     start and generator seed; then an eval forward of that model launches
     K2 and K1 27 times and K7 0 times (JAX's gate);
 12. the JAX package's memory settings, from the same start and batches:
     the lean step (train_remat "blocks" with ASY_MIXER_BWD_RESIDUALS=0, 5
     steps; per step K6r 27, K6 0, K2 51 (24 recomputed), K1, K5 27), the z1
     step (ASY_MLP_BWD_RESIDUALS=1, 5 steps; K1 and K5 take their z1
     variants on all 27 blocks), "fusion" and "stages" (2 steps each; under
     "stages" K2 51 and K1 43 launches: a recomputed stack reruns all but its
     last MLP half), the same checks and the first step through the twins;
     each first step equals the fused step's (loss to 1e-5 relative, num_fg
     equal: the same forward);
 13. a 30-step overfit of one 128^2 batch in f32 through the fused path;
     step time, images/s, peak memory (absolute, and above what was held
     before the first step), device-busy share, launches per step and device
     ms by category for the fused, the module-path, the stochastic-depth and
     the memory-setting steps;
 14. K2f-ablate, the prefixes of K2 (ops/mixer_ablate.py, the profiling
     tool's kernel; no serving or train path launched one): at the 7 block
     shapes, batch 8, f32 and bf16, and at the TPU tool's geometry (stage 0,
     batch 64, bf16) base `full` equals K2 bit for bit (output, moments,
     assignment), nf `full` is held against its twin fed its own
     assignment, and every cut prefix wrote rnd(x + s) with its checksum s,
     which is held with its magnitude against the twin's (fed K2's or the nf
     assignment); two runs give equal bits; the nf-vs-base numerics; per
     prefix the kernel's and the twin's time, the bound and the CTAs per SM
     beside K2's; the base prefixes and K2 with its residual pack at the
     train batch; the attribution of K2's time per batch-8 forward and per
     fused train step to its phases (each prefix's Delta ms x calls, summed
     over the 7 shapes).  Then the tool's own path
     (`python -m asy_vrnet_tpu_torch.tools.ablate_mixer_fwd`, its defaults)
     with the launch count reset before and read after: every prefix timed
     by the profiler trace and by CUDA events;
 15. the training CLI (`asy_vrnet_tpu_torch/cli/train.py`, called through its
     `main` in this process) on r05's recipe: the 48-image learnable set at
     512^2, batch 8, Adam, bf16, no EMA, signed seg logits, starting from the
     r05 weights (`partial_load` must load every leaf), 3 epochs with the
     first at the frozen-backbone batch of 32, then `--resume` from
     `ckpt/step_3.pt` for a fourth.  The callbacks on the r05 weights before
     training and after every epoch: AP50 >= 0.90, mIoU >= 0.93; every
     epoch's loss finite; launch counters over the run: K2 and K1 27 a train
     step, val step and callback forward, K6 and K5 27 a train step, K4 and
     the SimOTA wrapper once a train and val step, K4b once a train step, no
     other kernel; every batch `device_prefetch` hands out in epoch 1 equal
     to its host batch; the resumed step count continues from three epochs'
     steps; `last_epoch_weights.npz` loads strictly into a new model.  Per
     epoch (host clock): wall seconds, the train loop's images/s, the share
     spent waiting on the loader (inside `device_prefetch`), and which npz
     reader ran;
 16. inference and offline evaluation (`check_inference`): r05's weights on
     phase 15's set through the CLIs' `main`s in this process (signed seg
     logits, raw radar, as r05 was trained): get_map's AP50 and get_miou's
     mIoU >= 0.95 and within 0.01 of the training callbacks on the same
     weights and set at batch 1 (phase 15's, at batch 8, printed beside:
     the model's radar gate min-maxes over the whole batch, so an image's
     outputs depend on its batch); predict's predict, heatmap, dir_predict
     and map_txt modes (the last two on 8 images; map_txt's files agree
     with get_map's detection-results) and fps on the
     host clock and by CUDA events; predict_seg's predict and fps; the
     export mode (`torch.export`: its time; the program loaded again holds
     27 asy_vrnet.mixer_block and 27 asy_vrnet.mlp_block nodes and no plain
     twin, and gives the eager graph's detections and its seg probabilities
     within 1e-6); the fused pipeline at batch 8 (frames, and one point a
     non-zero radar pixel; ms a batch by CUDA events) against the same batch
     preprocessed on the host, and frame by frame against Detector.detect on
     the same maps (>= 95% of the reference's boxes matched at IoU >= 0.9
     with the same class); Detector.detect at batch 1 (wall and profiled device
     time a request) and decode + NMS alone, early exit and fixed rounds.
     Every entry point launches K2 and K1 27 times a forward and no other
     kernel (counters reset just before each, read just after);
 17. data-parallel training (`check_parallel`; asy_vrnet_tpu_torch/parallel/)
     at the CLI's defaults (nano coc_small, fused, r05's weights, 512^2,
     global batch 16, 2 steps): (a) the parallel step on a one-rank NCCL
     group gives the plain step's bits and launches (27 of K2, K1, K6, K5,
     one K4, one K4b, one SimOTA call a step), both under torch's
     deterministic algorithms, where a second plain run repeats the first's
     bits; (b) two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
     card; gloo's SUM, MIN and MAX on CUDA tensors checked first), 8 rows
     each, against the plain step, in bf16 and in f32, with each rank's
     launches, step and all-reduce ms; (c) the training CLI's launcher,
     `--num-devices 2`, one epoch of 16 learnable images at 128^2: NCCL on
     cuda:0,1 with two cards, else gloo with both ranks on cuda:0 (the CLI's
     device choice patched to put them there; the NCCL two-card leg is then
     reported as not run); rank 0 alone writes the
     loss line, the callbacks' AP50 and mIoU, the checkpoint and weights.

Tolerances:
  kernel vs plain, f32: max |diff| <= 1e-4 * max(1, max|y|) (mixer, y = out - x)
    or 1e-5 * max(1, max|out|) (MLP), assignment agreement >= 99.99%: the
    same formula in f32, sums in another order.
  kernel vs plain, bf16: both round intermediates to bf16 where the TPU
    kernel does, but sum in another order, so a bf16 rounding can land on
    the other side and near-tied assignments flip: mixer agreement >= 99%, mean |diff|
    <= 2% of max|y|, max |diff| <= max|y| + 2 bf16 ulps; MLP within 2 bf16
    ulps of max|out|.
  512^2 bf16 forward, kernels vs plain twins: every output finite with the
    expected shape; mean |diff| <= 5% of mean |ref| per output (bf16 rounding
    and flipped assignments compound through 27 blocks).
  128^2 f32 forward, card vs CPU: atol = rtol = 2e-3 (f32 kernels and f32
    cuDNN with TF32 off against the CPU's plain path through ~90 layers).
  seg-loss sums vs plain: rtol 1e-5 in f32 (1e-4 on bf16 logits; both read
    the same logits and compute in f32), thresholded counts within 8 pixels,
    the loss and f_score (computed in the kernel) within 1e-3 relative; three
    runs give equal bits.  dlogits: f32 max |diff| <= 1e-6 * max(1, max
    |dlogits|), bf16 within 2 bf16 ulps of max |dlogits|.  The f32-in
    variant: the bf16 path's bits exactly.
  SimOTA vs plain: exact on the constructed ties and on images with 0 or 1
    GT; otherwise fg agreement >= 99.9% of anchors, matched GT equal where
    both are fg, IoU atol 1e-5, num_fg within 1% (libm's last ulp can flip a
    near-tie).
  K6r vs its twin (fed K6r's assignment), K5 with z1 vs its twin (fed the
    same z1): as the block backward below; K6r vs K6 fed K2's pack: 1e-4 *
    max(1, max |K6|) in f32, reported in bf16 (the pack rounds the winning
    cosine and the centers to bf16, the remat does not); K1's z1: 1e-5 *
    max(1, max |z1|) in f32, 2 bf16 ulps of max |z1| in bf16.
  block backward vs plain twins (the same residual pack fed to both), f32:
    every output within 1e-4 * max(1, max |ref|); the pack's fields within
    1e-4 * max(1, max |ref|) and its assignment 100% equal.  bf16: dxn
    within 2 bf16 ulps of max |ref|; the summed weight, bias and alpha/beta
    gradients within 2% of max |ref|; the per-sample GroupNorm sums within
    1e-3 of sum |dxn| (they cancel); the pack: assignment >= 99% equal
    (near-ties flip, as in the forward), c_rep within 2% of max |ref|, the
    winning cosine within 2% where the assignment agrees, mean |d oc| within
    2% of max |ref|.
  cluster mix vs plain twins: K7 as the mixer half (f32: max |diff| <=
    1e-4 * max(1, max |out|), assignment agreement >= 99.99%; bf16:
    agreement >= 99%, mean |diff| <= 2% of max |out|, max |diff| <= max
    |out| + 2 bf16 ulps); K7b as the block backward, the twin fed K7b's own
    assignment (equal to K7's, checked) as K6's twin is fed K2's pack (f32:
    every output within 1e-4 * max(1, max |ref|); bf16: d feat and d value
    within 2 bf16 ulps of max |ref|, the summed d alpha and d beta within
    2% of max |ref|).
  K2's prefixes vs their twins: a cut prefix's checksum and its sum of
    |terms| within 1e-5 (f32) or 1e-3 (bf16) of the twin's sum of |terms|,
    per CTA: the twin is fed the kernel's assignment, so only the order of
    the f32 sums and a rounding that lands on the other side differ; nf
    `full` as the mixer half above.
  train step, kernels vs plain twins: loss, loss_det, loss_seg within 2%
    relative, num_fg within 1% or one anchor, whichever is more: the
    kernels' and the twins' bf16 forwards differ in the last place here and
    there, which can move one anchor across SimOTA's dynamic-k cut (one of
    ~75 fg anchors is 1.3%); fused vs module path: the losses within 2%.
  data-parallel step: (a) bit for bit.  (b) bf16: metrics within 1e-2
    relative (num_fg within 1% or one anchor), the parameter update after
    steps 1 and 2 within 0.1 and 0.2 of the plain update's norm: bf16
    rounds GroupNorm's per-sample statistics otherwise at another batch
    size and the step amplifies it, so the plain step itself on the batch
    tiled twice (each row twice, the same step in exact arithmetic) moves
    by 1.09e-1 / 1.49e-1 (printed in the same run, with the plain step on
    reversed rows and under torch's default algorithms); f32: metrics
    within 1e-4 (num_fg equal), the update after each step within 5e-3,
    the BN running stats' within 1e-4.
Bounds: max(flops / peak, bytes / 3.35 TB/s), flops and bytes counted from
this run's shapes and data (each input read once, each output written once).
The peak is 989 TFLOP/s (dense bf16 tensor cores) for the four block kernels
and 67 TFLOP/s (f32 on CUDA cores; NVIDIA's H100 SXM data sheet) for the
seg-loss, SimOTA and cluster-mix kernels, which have no matrix product.  The
backward bounds count the products the math needs: K5 8*C*hid flops per
token (g @ w2^T, dz1 @ w1^T, both weight gradients; z1's recompute is not
counted; the z1 variants add the z1 plane's bytes), K6 6*C*I per token
(feat, d feat @ wf^T, dWf) plus the per (token, head) winner terms, K6r
those plus the forward remat's 2*C*I + 2*I*(M+1) and no pack;
K7 and K7b count their code's arithmetic
(`cluster_mix_bounds`) and 3 (K7) or 5 (K7b) tensors of B*H*W*I bf16 values.
No single PyTorch call computes any of the thirteen kernels: library_ms is
null.  The prefixes' bounds are `tools/ablate_mixer_fwd.py::prefix_bounds`
(its `full` is K2's bound).
"""
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_FLOPS_F32 = 67e12  # H100 SXM f32 rate outside the tensor cores
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
BWD_KERNELS = {
    "mixer_block_bwd": dict(source="asy_vrnet_tpu_torch/csrc/mixer_block_bwd.cu",
                            replaces="asy_vrnet_tpu/ops/block_pallas.py:1556"),
    "mlp_block_bwd": dict(source="asy_vrnet_tpu_torch/csrc/mlp_block_bwd.cu",
                          replaces="asy_vrnet_tpu/ops/block_pallas.py:2197"),
}
TRAIN_KERNELS = {
    "seg_loss_sums": dict(source="asy_vrnet_tpu_torch/csrc/seg_loss_sums.cu",
                          replaces="asy_vrnet_tpu/ops/losses_seg_pallas.py:167"),
    "seg_loss_dlogits": dict(source="asy_vrnet_tpu_torch/csrc/seg_loss_dlogits.cu",
                             replaces="asy_vrnet_tpu/ops/losses_seg_pallas.py:204"),
    "simota_assign": dict(source="asy_vrnet_tpu_torch/csrc/simota_assign.cu",
                          replaces="asy_vrnet_tpu/ops/simota_pallas.py:154"),
}
# K6r and the z1 variants of K1 and K5 (the lean and the z1 train steps)
REMAT_KERNELS = {
    "mixer_block_bwd_remat": dict(source="asy_vrnet_tpu_torch/csrc/mixer_block_bwd.cu",
                                  replaces="asy_vrnet_tpu/ops/block_pallas.py:1245"),
    "mlp_block_z1": dict(source="asy_vrnet_tpu_torch/csrc/mlp_block.cu",
                         replaces="asy_vrnet_tpu/ops/block_pallas.py:2022"),
    "mlp_block_bwd_z1": dict(source="asy_vrnet_tpu_torch/csrc/mlp_block_bwd.cu",
                             replaces="asy_vrnet_tpu/ops/block_pallas.py:2197"),
}
CLUSTER_KERNELS = {
    "cluster_mix": dict(source="asy_vrnet_tpu_torch/csrc/cluster_mix.cu",
                        replaces="asy_vrnet_tpu/ops/cluster_pallas.py:243"),
    "cluster_mix_bwd": dict(source="asy_vrnet_tpu_torch/csrc/cluster_mix_bwd.cu",
                            replaces="asy_vrnet_tpu/ops/cluster_pallas.py:448"),
}
# K2f-ablate: the prefixes of K2 that the profiling tool times
ABLATE_KERNEL = dict(source="asy_vrnet_tpu_torch/csrc/mixer_block.cu",
                     replaces="tools/ablate_mixer_fwd.py:252")
# the stand-alone cluster mix at the stochastic-depth train step (nano
# coc_small 512^2, batch 16): (name, B, H, W, inner width I, heads, fold,
# calls per step: the backbone blocks past stage 0's first, 2 streams)
CLUSTER_SHAPES = [
    ("stage0", 16, 128, 128, 128, 4, 8, 2),
    ("stage1", 16, 64, 64, 128, 4, 4, 4),
    ("stage2", 16, 32, 32, 256, 8, 2, 12),
    ("stage3", 16, 16, 16, 256, 8, 1, 4),
]
DROP_PATH_VARIANT = "coc_small_droppath"
TRAIN_BATCH, SEG_CLASSES, MAX_BOXES = 16, 9, 100


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check raises (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def mixer_bounds(b, h, w, c, heads, d, fold):
    t, inner, m = b * h * w, heads * d, 4
    regions = b * fold * fold
    flops = (t * (2 * c * inner + 2 * inner * (m + 1) + 4 * c * heads)
             + regions * 8 * m * c * inner)
    byts = 2 * t * c * 2 + 3 * c * inner * 2
    return flops, byts


def mlp_bounds(b, h, w, c, hid, z1=False):
    """Per token 4*C*hid flops; bytes: x in, out out (bf16), w1, w2, and with
    `z1` the pre-GELU z1 written (bf16)."""
    t = b * h * w
    return 4 * t * c * hid, 2 * t * c * 2 + 2 * c * hid * 2 + (2 * t * hid if z1 else 0)


def mixer_bwd_bounds(b, h, w, c, heads, d, fold, m=4, remat=False):
    """Per token: feat, d feat @ wf^T and dWf (6*C*I), the winner's d sim,
    the dispatch and the sim-weighted sums (10*C per head), the norms (4*I),
    the pooling (2*C).  Bytes: x, g, dxn (bf16), the pack (cosine bf16 +
    proposal int8 per (token, head); two center sets), wf, wv, w2 (bf16),
    the f32 weight gradients.  K6r (`remat`) reads no pack and adds the
    forward remat's per-token 2*C*I (feat for the cosines) + 2*I*(M+1)
    (the norms and the M cosines) flops."""
    t, inner, regions = b * h * w, heads * d, b * fold * fold
    flops = t * (6 * c * inner + 10 * c * heads + 4 * inner + 2 * c)
    byts = 3 * t * c * 2 + 3 * c * inner * 2 + (3 * c * inner + 2 * inner + c) * 4
    if remat:
        flops += t * (2 * c * inner + 2 * inner * (m + 1))
    else:
        byts += 3 * t * heads + 2 * regions * heads * m * d * 2
    return flops, byts


def mlp_bwd_bounds(b, h, w, c, hid, z1=False):
    """Per token 8*C*hid flops (z1's recompute, where the kernel does it, is
    not counted); bytes: x, g, dxn (bf16), w1, w2 (bf16), the f32 weight
    gradients, and with `z1` the stored z1 (bf16) read."""
    t = b * h * w
    byts = 3 * t * c * 2 + 2 * c * hid * 2 + (2 * c * hid + hid + c) * 4
    return 8 * t * c * hid, byts + (2 * t * hid if z1 else 0)


def cluster_mix_bounds(b, h, w, inner, itemsize, backward, m=4):
    """Per (token, head) of width D, counted from csrc/cluster_mix*.cu: K7
    pools feat and value (4*D), takes the norm and xn (3*D), the M cosines
    (2*M*D), the aggregation (2*D) and the dispatch (D): 10*D + 2*M*D; K7b
    does that forward again and then the cotangents (d oc, d sim, d value
    with its pooling term, d centers, d feat with its norm and pooling
    terms): 28*D + 6*M*D.  f32 arithmetic on the CUDA cores.  Bytes: feat
    and value in, out out (K7); feat, value and g in, d feat and d value out
    (K7b)."""
    t = b * h * w
    flops = t * inner * ((28 + 6 * m) if backward else (10 + 2 * m))
    return flops, (5 if backward else 3) * t * inner * itemsize


def bound_ms(flops, byts, peak=PEAK_FLOPS):
    tf, tb = flops / peak, byts / PEAK_BYTES
    return max(tf, tb) * 1e3, ("operations" if tf >= tb else "bytes")


def seg_bounds(npix, c, itemsize, backward):
    """~30 f32 operations per logit (the TPU kernel's own estimate); bytes:
    logits in (and dlogits out), the int32 target."""
    return 30 * npix * c, npix * (c * itemsize * (2 if backward else 1) + 4)


def simota_bounds(b, a, g, c, k, valid_rows, dyn_k_sum):
    """Operations this run's data needs: per (image, anchor) the prefilter
    over G boxes and 2*C clamped logs; per VALID (GT, anchor) pair the IoU and
    cost (~30 + 4*C); 4 per element and round for the k IoU rounds and the
    dynamic-k cost rounds each valid row ran.  Bytes: inputs and outputs."""
    flops = (b * a * (6 * g + 12 * c) + valid_rows * a * (30 + 4 * c)
             + 4 * a * (valid_rows * k + dyn_k_sum))
    byts = 4 * (b * a * (4 + c + 1) + b * g * 6 + a * 3) + b * a * 9
    return flops, byts


# the kernels' template names in a profiler trace
KERNEL_NAMES = {"mixer_block": "mixer_block_kernel", "mlp_block": "mlp_block_mma_kernel"}


def device_ms(fn, kernel, iters, warmup=3):
    """(device ms per launch of the kernels whose trace name contains
    `kernel`, over `iters` calls of fn() in a profiler trace; the traces
    taken, more than 1 where the profiler handed back one without device
    events)."""
    import torch

    from asy_vrnet_tpu_torch.utils.profiling import kernel_table, traced

    def run():
        for _ in range(iters):
            fn()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        tries = traced(run, d, on_card=True)
        rows = [v for (name, _), v in kernel_table(d, iters).items() if kernel in name]
    count = sum(n for _, n in rows)
    check(count > 0, f"the trace recorded {kernel}")
    return sum(ms for ms, _ in rows) / count, tries


def trace_table(fn, iters, warmup=3):
    """{kernel name: (device ms, launches) per fn() call} and the device
    operations per call, from one profiler trace of `iters` calls; the calls
    are counted by the first name's launches (a trace may hold one sweep
    fewer than it ran)."""
    import torch

    from asy_vrnet_tpu_torch.utils.profiling import kernel_table, traced

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        traced(lambda: [fn() for _ in range(iters)], d, on_card=True)
        rows = kernel_table(d, iters)
    out = {}
    for (name, _), (ms, n) in rows.items():
        t, k = out.get(name, (0.0, 0.0))
        out[name] = (t + ms, k + n)
    return out, sum(n for _, n in out.values())


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def bf16_ulp(x):
    import math

    return 2.0 ** (math.floor(math.log2(x)) - 7)


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


def profile_forward(model, image, radar, reps=3):
    import torch

    from asy_vrnet_tpu_torch.utils.profiling import profile_calls

    with torch.no_grad():
        return profile_calls(lambda: model(image, radar), reps)


@contextlib.contextmanager
def switches(env):
    """Set the residual switches (environment variables of ops/block.py) for
    the duration."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_launches(*modules):
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def gt_rows(rng, valid_counts, g, size, classes):
    """Padded GT (B,G,4) cxcywh pixels, classes (B,G) and validity (B,G)."""
    import numpy as np

    b = len(valid_counts)
    gb = np.zeros((b, g, 4), np.float32)
    gv = np.zeros((b, g), bool)
    for i, n in enumerate(valid_counts):
        gb[i, :n] = np.concatenate([rng.uniform(32, size - 32, (n, 2)),
                                    rng.uniform(24, 160, (n, 2))], -1)
        gv[i, :n] = True
    return gb, rng.integers(0, classes, (b, g)).astype(np.int32), gv


def compare_simota(tag, simota_fused, args, exact):
    """Kernel against plain twin on the same tensors -> (agreement, dyn-k sum,
    valid rows, max IoU error).  `exact` lists the images that must agree
    bit for bit in fg and matched GT."""
    import torch

    ker, kdyn = simota_fused.simota_assign_batched(*args, return_dynamic_ks=True)
    torch.cuda.synchronize()
    ref, rdyn = simota_fused.simota_assign_batched(*args, use_kernel=False,
                                                   return_dynamic_ks=True)
    agree = (ker.fg_mask == ref.fg_mask).float().mean().item()
    both = ker.fg_mask & ref.fg_mask
    match_equal = bool(torch.equal(ker.matched_gt[both], ref.matched_gt[both]))
    iou_err = ((ker.pred_iou - ref.pred_iou).abs() * both).max().item()
    nk, nr = ker.num_fg.sum().item(), ref.num_fg.sum().item()
    dyn_agree = (kdyn == rdyn).float().mean().item()
    log(f"[check simota_assign {tag}] fg agreement {agree:.6f}, matched GT equal on "
        f"common fg {match_equal}, max IoU diff {iou_err:.3e}, num_fg {nk:.0f} vs "
        f"{nr:.0f}, dynamic-k agreement {dyn_agree:.6f}")
    check(agree >= 0.999 and match_equal and iou_err <= 1e-5, f"simota {tag}")
    check(abs(nk - nr) <= 0.01 * max(nr, 1.0), f"simota num_fg {tag}")
    for i in exact:
        check(bool(torch.equal(ker.fg_mask[i], ref.fg_mask[i]))
              and bool(torch.equal(ker.matched_gt[i], ref.matched_gt[i])),
              f"simota {tag}: image {i} must agree exactly")
    return agree, int(kdyn.sum().item()), int(args[5].sum().item()), iou_err


def check_cluster_mix(dev):
    """K7 and K7b against their twins at CLUSTER_SHAPES, f32 and bf16, then
    their times at bf16.  -> {kernel: stats}, bf16 assignment agreements."""
    import torch

    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import kernels
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms

    stats = {k: {"max_abs_err": 0.0, "per_shape": [], "ms": 0.0, "device_ms": 0.0,
                 "plain_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0}
             for k in CLUSTER_KERNELS}
    agreement = []
    g = torch.Generator().manual_seed(4)
    ab = torch.tensor([1.5, 0.2], device=dev)
    for (name, b, h, w, inner, heads, fold, calls) in CLUSTER_SHAPES:
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        f32s = [torch.randn(b, h, w, inner, generator=g) * sc for sc in (1.0, 1.0, 0.5)]
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{name} {str(dt)[6:]}"
            feat, value, gy = (t.to(dev, dt) for t in f32s)
            on_fast = (cf.PATHS["cluster_mix/fast"], cf.PATHS["cluster_mix_bwd/fast"])
            out, asg = cf.cluster_mix_fwd(feat, value, ab, return_assign=True, **kw)
            again = cf.cluster_mix_fwd(feat, value, ab, **kw)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"K7 bits {tag}")
            ref, rasg = cf.cluster_mix_fused_plain(feat, value, ab, return_assign=True, **kw)
            diff = (out.float() - ref.float()).abs()
            ymax = ref.float().abs().max().item()
            agree = (asg == rasg).float().mean().item()
            if dt == torch.float32:
                check(agree >= 0.9999 and diff.max().item() <= 1e-4 * max(1.0, ymax), f"K7 {tag}")
            else:
                agreement.append(agree)
                check(agree >= 0.99, f"K7 assignment {tag}")
                check(diff.mean().item() <= 0.02 * ymax, f"K7 mean {tag}")
                check(diff.max().item() <= ymax + 2 * bf16_ulp(ymax), f"K7 max {tag}")
            # K7b: its assignment is K7's, bit for bit; the twin is fed it (as
            # K6's twin is fed K2's pack)
            got = cf.cluster_mix_bwd(feat, value, gy, ab, return_assign=True, **kw)
            again = cf.cluster_mix_bwd(feat, value, gy, ab, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(got[:3], again)), f"K7b bits {tag}")
            check(torch.equal(got[3], asg), f"K7b's assignment is K7's {tag}")
            # K7 and K7b compute the mixed centers with one function: the same bits
            cen = [torch.full((b, heads, fold * fold, 4, inner // heads), float("nan"),
                              device=dev) for _ in range(2)]
            fast = kernels.cluster_mix_fast(inner // heads, 4)
            kernels.cluster_mix(feat, value, ab, torch.empty_like(feat), None, fast=fast,
                                centers=cen[0], **kw)
            kernels.cluster_mix_bwd(feat, value, gy, ab, torch.empty_like(feat),
                                    torch.empty_like(feat), torch.empty_like(got[2]).new_empty(
                                        (b * heads * fold * fold, 2)), None, fast=fast,
                                    centers=cen[1], **kw)
            check(torch.equal(cen[0], cen[1]), f"K7's mixed centers are K7b's {tag}")
            check((cf.PATHS["cluster_mix/fast"], cf.PATHS["cluster_mix_bwd/fast"])
                  == (on_fast[0] + 2, on_fast[1] + 2), f"K7, K7b fast path {tag}")
            want = cf.cluster_mix_bwd_plain(feat, value, gy, ab, assign=got[3], **kw)
            errs = []
            for what, a, r in zip(("dfeat", "dvalue", "dalpha_dbeta"), got[:3], want):
                a, r = a.float(), r.float()
                sc, err = r.abs().max().item(), (a - r).abs().max().item()
                if dt == torch.float32:
                    ok = err <= 1e-4 * max(1.0, sc)
                elif what == "dalpha_dbeta":
                    ok = err <= 0.02 * max(sc, 1e-6)
                else:
                    ok = err <= 2 * bf16_ulp(sc)
                errs.append(err)
                check(ok, f"K7b {what} {tag}: max|diff| {err:.4e} max|ref| {sc:.4e}")
            log(f"[check cluster_mix {tag}] max|diff| {diff.max().item():.4e} mean|diff| "
                f"{diff.mean().item():.4e} max|out| {ymax:.4e} assignment agreement {agree:.6f}; "
                f"[check cluster_mix_bwd {tag}] max|diff| dfeat {errs[0]:.3e} dvalue "
                f"{errs[1]:.3e} dalpha/beta {errs[2]:.3e}; K7 and K7b assignments equal")
            if dt == torch.bfloat16:
                stats["cluster_mix"]["max_abs_err"] = max(stats["cluster_mix"]["max_abs_err"],
                                                          diff.max().item())
                stats["cluster_mix_bwd"]["max_abs_err"] = max(
                    stats["cluster_mix_bwd"]["max_abs_err"], *errs[:2])
        for kname, backward in (("cluster_mix", False), ("cluster_mix_bwd", True)):
            log_geometry(kname, name, kernels.cluster_mix_info(
                torch.bfloat16, (b, h, w, inner), backward=backward, device=dev, **kw))
            if backward:
                fk = lambda: cf.cluster_mix_bwd(feat, value, gy, ab, **kw)          # noqa: E731
                fp = lambda: cf.cluster_mix_bwd_plain(feat, value, gy, ab, **kw)    # noqa: E731
            else:
                fk = lambda: cf.cluster_mix_fwd(feat, value, ab, **kw)              # noqa: E731
                fp = lambda: cf.cluster_mix_fused_plain(feat, value, ab, **kw)      # noqa: E731
            ms, pms = cuda_ms(fk, 20), cuda_ms(fp, 3, warmup=1)
            dms, _ = device_ms(fk, kname + "_kernel", 20)
            flops, byts = cluster_mix_bounds(b, h, w, inner, 2, backward)
            bms, by = bound_ms(flops, byts, peak=PEAK_FLOPS_F32)
            log(f"[time {kname} {name} bf16 ({b},{h},{w},{inner})] kernel {ms:.4f} ms "
                f"({dms:.4f} in a trace), plain {pms:.4f} ms, bound {bms:.5f} ms ({by}), "
                f"x{calls} per step")
            st = stats[kname]
            st["per_shape"].append({"shape": name, "ms": ms, "device_ms": dms, "plain_ms": pms,
                                    "bound_ms": bms, "bound_by": by, "calls_per_step": calls})
            st["ms"] += calls * ms
            st["device_ms"] += calls * dms
            st["plain_ms"] += calls * pms
            st["bound_ms"] += calls * bms
            st["flops_ms"] += calls * flops / PEAK_FLOPS_F32 * 1e3
            st["bytes_ms"] += calls * byts / PEAK_BYTES * 1e3
    for st in stats.values():
        st["bound_by"] = "operations" if st.pop("flops_ms") >= st.pop("bytes_ms") else "bytes"
    return stats, agreement


def log_geometry(kname, name, info):
    """One `[geometry ...]` line: a kernel's launch at one shape."""
    log(f"[geometry {kname} {name}] " + ", ".join(f"{k} {v}" for k, v in info.items()))


def close_bwd(kname, name, got, want, dt, dxn_ref):
    """Log and check one backward output against its twin (tolerances in
    the docstring); returns max |diff|."""
    import torch

    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if dt == torch.float32:
        ok = err <= 1e-4 * max(1.0, scale)
    elif name == "dxn":
        ok = err <= 2 * bf16_ulp(scale)
    elif name == "sums":
        ok = bool(((got - want).abs() <= 1e-3 * dxn_ref.float().abs().sum(
            dim=(1, 2, 3))[:, None]).all())
    else:
        ok = err <= 0.02 * max(scale, 1e-6)
    if not ok:
        log(f"[check {kname} {str(dt)[6:]}] {name}: max|diff| {err:.4e} max|ref| {scale:.4e}")
    check(ok, f"{kname} {name} {str(dt)[6:]}")
    return err


def check_remat_z1(dev):
    """K6r (the full-remat mixer backward) and the z1 variants of K1 and K5
    against their twins at the 7 block shapes with the train batch, f32 and
    bf16, then their times at bf16.  K6r's rebuilt assignment must equal the
    one K2 stored in its pack, bit for bit; its twin is fed that assignment
    (near-ties in bf16 can fall either way in a twin that sums in another
    order), as K6's twin is fed K2's pack.  K6r against K6 fed K2's pack:
    the same function, held to f32 rounding in f32 and reported in bf16.
    The z1 variants: K1's output equals K1's without z1 (the same bits), z1
    within 1e-5 (f32) or 2 bf16 ulps of max |z1| of its twin's; K5 and its
    twin are fed the same z1 and held as K5.  -> {kernel: stats}."""
    import torch

    from asy_vrnet_tpu_torch.ops import block, kernels
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms

    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
    stats = {k: {"max_abs_err": 0.0, "per_shape": [], "ms": 0.0, "plain_ms": 0.0,
                 "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0} for k in REMAT_KERNELS}
    stats["mixer_block_bwd_remat"]["vs_k6_bf16"] = []
    g = torch.Generator().manual_seed(13)

    def rn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g) * scale

    def cast(ws, dt):
        return [w.to(dev, dt if w.dim() == 2 else torch.float32).contiguous() for w in ws]

    for (name, _, h, w, c, heads, d, fold, hid, calls) in SHAPES:
        b, inner = TRAIN_BATCH, heads * d
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        mixer_w = (rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(inner, c, scale=inner ** -0.5), rn(c, scale=0.1),
                   torch.tensor([1.5, 0.2]))
        mlp_w = (rn(c, hid, scale=c ** -0.5), rn(hid, scale=0.1),
                 rn(hid, c, scale=hid ** -0.5), rn(c, scale=0.1))
        x32, g32 = rn(b, h, w, c), rn(b, h, w, c, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{name} {str(dt)[6:]}"
            x, gy = x32.to(dev, dt), g32.to(dev, dt)
            st = block.gn1_stats(x)
            mw, lw = cast(mixer_w, dt), cast(mlp_w, dt)
            wf, bf, wv, bv, w2, _, ab = mw
            margs = (x, gy, st, wf, bf, wv, bv, w2, ab)
            _, _, pack = block.mixer_block(x, st, *mw, return_residuals=True, **kw)
            path = f"mixer_block_bwd_remat/{'tc' if dt == torch.bfloat16 else 'fma'}"
            on_path = block.PATHS[path]
            *got, asg = block.mixer_block_bwd(*margs, None, return_assign=True, **kw)
            again = block.mixer_block_bwd(*margs, None, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(got, again)), f"K6r bits {tag}")
            check(block.PATHS[path] == on_path + 2, f"K6r products' path {tag}")
            same = torch.equal(asg, pack[1])
            log(f"[check mixer_block_bwd_remat {tag}] rebuilt assignment equals K2's, bit "
                f"for bit: {same} ({(asg == pack[1]).float().mean().item():.6f} equal)")
            check(same, f"K6r rebuilds K2's assignment {tag}")
            want = block.mixer_block_bwd_remat_plain(*margs, assign=asg, **kw)
            errs = [close_bwd("mixer_block_bwd_remat", n, a, r, dt, want[0])
                    for n, a, r in zip(names, got, want)]
            k6 = block.mixer_block_bwd(*margs, pack, **kw)
            vs = []
            for n, a, r in zip(names, got, k6):
                sc = r.float().abs().max().item()
                err = (a.float() - r.float()).abs().max().item()
                vs.append(err / max(sc, 1e-12))
                if dt == torch.float32 and n != "sums":
                    check(err <= 1e-4 * max(1.0, sc), f"K6r vs K6 {n} {tag}")
            log(f"[check mixer_block_bwd_remat {tag}] vs twin max|diff| " + " ".join(
                f"{n} {e:.3e}" for n, e in zip(names, errs)) + "; vs K6 fed K2's pack, "
                "max|diff|/max|K6| " + " ".join(f"{n} {v:.3e}" for n, v in zip(names, vs)))
            # K1 with z1, K5 reading it
            w1, b1, w2m, _ = lw
            out_z, z1 = block.mlp_block(x, st, *lw, return_z1=True)
            out = block.mlp_block(x, st, *lw)
            torch.cuda.synchronize()
            check(torch.equal(out_z, out), f"K1 with z1 gives K1's output {tag}")
            _, zref = block.mlp_block_plain(x, st, *lw, return_z1=True)
            zs = zref.float().abs().max().item()
            zerr = (z1.float() - zref.float()).abs().max().item()
            check(zerr <= (1e-5 * max(1.0, zs) if dt == torch.float32 else 2 * bf16_ulp(zs)),
                  f"K1 z1 {tag}: max|diff| {zerr:.3e} max|z1| {zs:.3e}")
            largs = (x, gy, st, w1, b1, w2m, z1)
            zpath = f"mlp_block_bwd_z1/{'cluster' if dt == torch.bfloat16 else 'fma'}"
            on_path = block.PATHS[zpath]
            lgot = block.mlp_block_bwd(*largs)
            again = block.mlp_block_bwd(*largs)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(lgot, again)), f"K5 z1 bits {tag}")
            check(block.PATHS[zpath] == on_path + 2, f"K5 z1 path {tag}")
            lwant = block.mlp_block_bwd_plain(*largs)
            lerr = [close_bwd("mlp_block_bwd_z1", n, a, r, dt, lwant[0]) for n, a, r in zip(
                ("dxn", "dw1", "db1", "dw2", "db2", "sums"), lgot, lwant)]
            log(f"[check mlp_block_z1 {tag}] output equals K1's; z1 max|diff| {zerr:.3e} "
                f"(max|z1| {zs:.3e}); [check mlp_block_bwd_z1 {tag}] max|diff| dxn "
                f"{lerr[0]:.3e} dw1 {lerr[1]:.3e} dw2 {lerr[3]:.3e}")
            if dt == torch.bfloat16:
                stats["mixer_block_bwd_remat"]["vs_k6_bf16"].append(
                    {"shape": name, **dict(zip(names, vs))})
                for kname, e in (("mixer_block_bwd_remat", errs[0]), ("mlp_block_z1", zerr),
                                 ("mlp_block_bwd_z1", lerr[0])):
                    stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], e)
        # times at bf16 (the last dtype's inputs)
        fns = {
            "mixer_block_bwd_remat": (
                lambda: block.mixer_block_bwd(*margs, None, **kw),
                lambda: block.mixer_block_bwd_remat_plain(*margs, **kw),
                mixer_bwd_bounds(b, h, w, c, heads, d, fold, remat=True)),
            "mlp_block_z1": (lambda: block.mlp_block(x, st, *lw, return_z1=True),
                             lambda: block.mlp_block_plain(x, st, *lw, return_z1=True),
                             mlp_bounds(b, h, w, c, hid, z1=True)),
            "mlp_block_bwd_z1": (lambda: block.mlp_block_bwd(*largs),
                                 lambda: block.mlp_block_bwd_plain(*largs),
                                 mlp_bwd_bounds(b, h, w, c, hid, z1=True)),
        }
        log_geometry("mlp_block_bwd_z1", name, kernels.mlp_block_bwd_info(
            torch.bfloat16, b, h * w, c, hid, True, dev))
        for kname, (fk, fp, (flops, byts)) in fns.items():
            ms, pms = cuda_ms(fk, 10), cuda_ms(fp, 2, warmup=1)
            bms, by = bound_ms(flops, byts)
            log(f"[time {kname} {name} bs={b}] kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {bms:.5f} ms ({by}), x{calls} per step")
            ks = stats[kname]
            ks["per_shape"].append({"shape": name, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                                    "bound_by": by, "calls_per_step": calls})
            ks["ms"] += calls * ms
            ks["plain_ms"] += calls * pms
            ks["bound_ms"] += calls * bms
            ks["flops_ms"] += calls * flops / PEAK_FLOPS * 1e3
            ks["bytes_ms"] += calls * byts / PEAK_BYTES * 1e3
        del margs, largs, pack, fns
    for ks in stats.values():
        ks["bound_by"] = "operations" if ks.pop("flops_ms") >= ks.pop("bytes_ms") else "bytes"
    return stats


def check_ablation(dev):
    """K2f-ablate: the prefixes of K2 (ops/mixer_ablate.py) against their
    twins at the 7 block shapes with batch 8, f32 and bf16, and at the TPU
    tool's geometry (stage 0, batch 64, bf16).  Per shape and dtype: K2 with
    its assignment; base `full` equals K2 bit for bit (output, moments,
    assignment); nf `full` against its twin fed the nf assignment; every cut
    prefix wrote rnd(x + s) with its own checksum s, and s and its magnitude
    against the twin's (fed K2's or the nf assignment); two runs give equal
    bits; the nf-vs-base numerics.  Then at bf16 the times of every prefix
    and its twin, the bounds, and the same base prefixes and K2 with its
    residual pack at the train batch.  -> (stats, attribution: per phase
    {ms per batch-8 forward, ms per train step})."""
    import torch

    from asy_vrnet_tpu_torch.ops import block
    from asy_vrnet_tpu_torch.ops import mixer_ablate as ma
    from asy_vrnet_tpu_torch.tools import ablate_mixer_fwd as tool
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_ablate_")

    g = torch.Generator().manual_seed(14)

    def rn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g) * scale

    def cast(ws, dt):
        return [w.to(dev, dt if w.dim() == 2 else torch.float32).contiguous() for w in ws]

    def shape_inputs(geo, dt, x32, mixer_w):
        if x32 is None:                                   # the TPU tool's own draw
            return tool.make_inputs(geo, dev)
        x = x32.to(dev, dt)
        return x, block.gn1_stats(x), cast(mixer_w, dt)

    cases = [(name, dict(b=b, h=h, w=w, c=c, heads=heads, d=d, fold=fold, ph=2, pw=2), calls)
             for (name, b, h, w, c, heads, d, fold, _, calls) in SHAPES]
    cases.append(("tool stage0 bs64", tool.geometry(0, 512, 0.25, 64), None))
    stats = {"max_abs_err": 0.0, "max_rel_checksum_err_bf16": 0.0, "per_shape": [],
             "numerics": []}
    phases = ("gn", "centers", "feat", "sim", "agg", "full")
    attribution = {p: {"forward_ms": 0.0, "train_ms": 0.0} for p in phases + ("pack",)}
    for name, geo, calls in cases:
        kw = dict(heads=geo["heads"], fold_h=geo["fold"], fold_w=geo["fold"],
                  proposal_h=geo["ph"], proposal_w=geo["pw"])
        b, c, inner, r = geo["b"], geo["c"], geo["heads"] * geo["d"], geo["fold"] ** 2
        tool_case = calls is None
        x32 = None if tool_case else rn(b, geo["h"], geo["w"], c)
        mixer_w = None if tool_case else (
            rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1), rn(c, inner, scale=c ** -0.5),
            rn(inner, scale=0.1), rn(inner, c, scale=inner ** -0.5), rn(c, scale=0.1),
            torch.tensor([1.5, 0.2]))
        for dt in ((torch.bfloat16,) if tool_case else (torch.float32, torch.bfloat16)):
            tag = f"{name} {str(dt)[6:]}"
            x, st, mw = shape_inputs(geo, dt, x32, mixer_w)
            out, mom, asg = block.mixer_block(x, st, *mw, return_assign=True, **kw)
            k2_asg = asg.permute(0, 2, 3, 1).to(torch.int8)
            full = ma.mixer_block_ablate(x, st, *mw, stop="full", return_assign=True, **kw)
            nf_full = ma.mixer_block_ablate(x, st, *mw, stop="full", nf=True,
                                            return_assign=True, **kw)
            torch.cuda.synchronize()
            groups = full[1].shape[1] // r
            check(torch.equal(full[0], out) and torch.equal(full[1].sum(1), mom)
                  and torch.equal(full[2], k2_asg), f"ablate full is K2, bit for bit {tag}")
            ymax = (out.float() - x.float()).abs().max().item()
            ref, _ = ma.mixer_block_ablate_plain(x, st, *mw, stop="full", nf=True, groups=groups,
                                                 assign=nf_full[2], **kw)
            diff = (nf_full[0].float() - ref.float()).abs()
            if dt == torch.float32:
                check(diff.max().item() <= 1e-4 * max(1.0, ymax), f"nf full {tag}")
            else:
                check(diff.mean().item() <= 0.02 * ymax
                      and diff.max().item() <= ymax + 2 * bf16_ulp(ymax), f"nf full {tag}")
            # max_abs_err: the full prefixes' outputs (base is K2's bits); a cut
            # prefix's output rnd(x + s) is held through s instead
            errs = {"nf full": diff.max().item()}
            rel = {}
            for stop, nf in tool.JOBS:
                if stop == "full":
                    continue
                o, part = ma.mixer_block_ablate(x, st, *mw, stop=stop, nf=nf, **kw)
                again = ma.mixer_block_ablate(x, st, *mw, stop=stop, nf=nf, **kw)
                torch.cuda.synchronize()
                lab = f"{'nf' if nf else 'base'} {stop}"
                check(torch.equal(o, again[0]) and torch.equal(part, again[1]),
                      f"{lab} bits {tag}")
                s = part.view(b, r, groups, 2)
                check(torch.equal(o, ma.write_through(x, s[..., 0], fold_h=geo["fold"],
                                                      fold_w=geo["fold"])),
                      f"{lab} wrote rnd(x + s) {tag}")
                ro, rpart = ma.mixer_block_ablate_plain(
                    x, st, *mw, stop=stop, nf=nf, groups=groups,
                    assign=nf_full[2] if nf else k2_asg, **kw)
                mag = rpart[..., 1]
                e = torch.maximum((part[..., 0] - rpart[..., 0]).abs(),
                                  (part[..., 1] - mag).abs()) / mag
                rel[lab] = e.max().item()
                check(rel[lab] <= (1e-5 if dt == torch.float32 else 1e-3),
                      f"{lab} checksum {tag}: max |diff| / sum |terms| {rel[lab]:.3e}")
            log(f"[check mixer_block_ablate {tag}] G {groups}: base full = K2 bit for bit "
                f"(output, moments, assignment); max |diff| / sum |terms| of the checksums "
                + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
                + f"; nf full vs twin max|diff| {errs['nf full']:.3e} (max|y| {ymax:.3e})")
            if dt == torch.bfloat16:
                stats["max_abs_err"] = max(stats["max_abs_err"], *errs.values())
                stats["max_rel_checksum_err_bf16"] = max(stats["max_rel_checksum_err_bf16"],
                                                         *rel.values())
                dd = (out.float() - nf_full[0].float()).abs()
                num = {"shape": name, "max_abs_diff": dd.max().item(),
                       "mean_abs_y": out.float().abs().mean().item(),
                       "frac_gt_1e-2": (dd > 1e-2).float().mean().item(),
                       "frac_gt_1e-1": (dd > 1e-1).float().mean().item(),
                       "assignment_agreement": (nf_full[2] == k2_asg).float().mean().item()}
                stats["numerics"].append(num)
                log(f"[ablate nf-vs-base {name} bf16] max|diff| {num['max_abs_diff']:.3e} "
                    f"mean|y| {num['mean_abs_y']:.3e} frac > 1e-2 {num['frac_gt_1e-2']:.2e} "
                    f"frac > 1e-1 {num['frac_gt_1e-1']:.2e} assignment agreement "
                    f"{num['assignment_agreement']:.6f}")
        # times at bf16 (the last dtype's inputs): each kernel's device time
        # in a profiler trace (the launches at batch 8 are host-bound, so
        # the CUDA-event times beside them include the host's work)
        times = tool.time_prefixes(x, st, mw, kw, groups, 20, trace_dir)
        ms = {job: t["ms_trace"] for job, t in times.items()}
        for stop, nf in tool.JOBS:
            pms = cuda_ms(lambda: ma.mixer_block_ablate_plain(
                x, st, *mw, stop=stop, nf=nf, groups=groups, **kw), 3, warmup=1)
            bms, by = tool.bound_ms(*tool.prefix_bounds(stop, nf, geo))
            occ = ma.mixer_block_ablate(x, st, *mw, stop=stop, nf=nf, return_occupancy=True,
                                        **kw)[-1]
            check(occ[0] == occ[1], f"{name} {stop}: K2's CTAs per SM")
            stats["per_shape"].append({"shape": name, "prefix": f"{'nf' if nf else 'base'} {stop}",
                                       "ms": ms[(stop, nf)], "ms_events": times[(stop, nf)]["ms"],
                                       "trace_count": times[(stop, nf)]["trace_count"],
                                       "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                                       "ctas_per_sm": occ, "calls_per_forward": calls})
            log(f"[time mixer_block_ablate {name} bf16 {'nf' if nf else 'base'} {stop}] "
                f"kernel {ms[(stop, nf)]:.4f} ms (trace; events {times[(stop, nf)]['ms']:.4f}), "
                f"plain {pms:.4f} ms, bound {bms:.5f} ms ({by}), CTAs/SM {occ[0]} (K2 {occ[1]})"
                + ("" if tool_case else f", x{calls} per forward"))
        if tool_case:
            continue
        # the same base prefixes and K2 with its residual pack at the train batch
        xt = rn(TRAIN_BATCH, geo["h"], geo["w"], c).to(dev, torch.bfloat16)
        stt = block.gn1_stats(xt)
        train = {job[0]: t["ms_trace"] for job, t in tool.time_prefixes(
            xt, stt, mw, kw, None, 20, trace_dir, jobs=[(p, False) for p in phases]).items()}
        # the pack: K2 with and without it through K2's own wrapper (CUDA
        # events; these launches keep the card busy)
        k2_pack = cuda_ms(lambda: block.mixer_block(xt, stt, *mw, return_residuals=True, **kw),
                          20)
        k2_eval = cuda_ms(lambda: block.mixer_block(xt, stt, *mw, **kw), 20)
        prev_f = prev_t = 0.0
        for p in phases:
            attribution[p]["forward_ms"] += calls * (ms[(p, False)] - prev_f)
            attribution[p]["train_ms"] += calls * (train[p] - prev_t)
            prev_f, prev_t = ms[(p, False)], train[p]
        attribution["pack"]["train_ms"] += calls * (k2_pack - k2_eval)
        log(f"[ablate train batch {name}] bs={TRAIN_BATCH} ms (trace) " + ", ".join(
            f"{k} {v:.4f}" for k, v in train.items()) + f"; K2 with its pack {k2_pack:.4f}, "
            f"without {k2_eval:.4f} (events)")
    log("[ablate attribution] phase | ms per batch-8 forward | share | ms per fused train "
        "step (K2 with its pack, bs=16) | share")
    tot_f = sum(a["forward_ms"] for a in attribution.values())
    tot_t = sum(a["train_ms"] for a in attribution.values())
    for p, a in attribution.items():
        log(f"[ablate attribution] {p}: {a['forward_ms']:.4f} | {a['forward_ms'] / tot_f:.3f} | "
            f"{a['train_ms']:.4f} | {a['train_ms'] / tot_t:.3f}")
    log(f"[ablate attribution] total: {tot_f:.4f} (K2's full prefix x calls) | "
        f"{tot_t:.4f} (full prefix + the pack's Delta, x calls)")
    shutil.rmtree(trace_dir)
    return stats, attribution


def check_seg_loss(dev):
    """Phase 6's seg-loss part: K4 and K4b against their twins at the train
    step's (16, 512, 512, 9) on the bf16 and f32 paths, without and with
    class weights, focal+dice and CE (three calls in a row give the same
    bits); the f32-in variant the train step runs (`round_bf16`) against the
    bf16 path bit for bit; partial last tiles and C = 21 (the generic path);
    each kernel's time on the main path's variant (events, trace), its
    twin's, its bound and geometry, and the bf16 variant's beside it; and the
    train step's span from the model's seg output to its gradient (device
    operations and ms by trace).  -> {kernel: stats for the kernels line}."""
    import torch

    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.ops import kernels
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as segf
    from asy_vrnet_tpu_torch.train import train_step
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms

    f32, b16 = torch.float32, torch.bfloat16
    npix, c9 = TRAIN_BATCH * 512 * 512, SEG_CLASSES
    gen = torch.Generator().manual_seed(6)
    seg32 = torch.randn(TRAIN_BATCH, 512, 512, c9, generator=gen) * 2
    seg_t = torch.randint(0, c9, (TRAIN_BATCH, 512, 512), generator=gen, dtype=torch.int32)
    seg_t[torch.rand(seg_t.shape, generator=gen) < 0.1] = c9        # ~10% ignored
    seg_t = seg_t.to(dev)
    class_w = {"weighted": torch.linspace(0.5, 2.0, c9).to(dev), "plain": None}
    modes = {"focal+dice": segf.SegHyper(), "ce": segf.SegHyper(use_focal=False, use_dice=False)}
    stats = {k: {"max_abs_err": 0.0} for k in ("seg_loss_sums", "seg_loss_dlogits")}

    def held(lg, tg, w, hp, tag, gloss, calls=3):
        """Both kernels against their twins (the tolerances of the module's
        docstring); K4 `calls` times, equal bits.  -> (|loss diff|, max
        |dlogits diff|)."""
        runs = [segf.seg_loss_sums(lg, tg, w, hp) for _ in range(calls)]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r)),
              "seg_loss_sums gives the same bits twice")
        (acc, lk, fk), (ref, lp, fp) = runs[0], segf.seg_sums_plain(lg, tg, w, hp)
        c = lg.shape[-1]
        smooth, counts = slice(0, 4 + 3 * c), slice(4 + 3 * c, 4 + 5 * c)
        rerr = ((acc - ref).abs() / ref.abs().clamp_min(1.0))[smooth].max().item()
        cerr = (acc - ref).abs()[counts].max().item()
        dk = segf.seg_loss_dlogits(lg, tg, w, ref, gloss, hp)
        torch.cuda.synchronize()
        dp = segf.seg_dlogits_plain(lg, tg, w, ref, gloss, hp)
        derr = (dk.float() - dp.float()).abs().max().item()
        dmax = dp.float().abs().max().item()
        log(f"[check seg loss {tag}] sums max rel diff {rerr:.3e}, thresholded counts differ "
            f"by <= {cerr:.0f} pixels; loss {lk.item():.6f} vs {lp.item():.6f}, f_score "
            f"{fk.item():.6f} vs {fp.item():.6f}; dlogits (cotangent {gloss.item():.0f}) "
            f"max|diff| {derr:.3e} max|dlogits| {dmax:.3e}")
        check(rerr <= (1e-5 if lg.dtype == f32 else 1e-4) and cerr <= 8, "seg_loss_sums")
        check(rel_diff(lk.item(), lp.item()) <= 1e-3 and rel_diff(fk.item(), fp.item()) <= 1e-3,
              "seg loss value")
        check(derr <= (1e-6 * max(1.0, dmax) if lg.dtype == f32 else 2 * bf16_ulp(dmax)),
              "seg_loss_dlogits")
        return abs(lk.item() - lp.item()), derr

    gloss = torch.tensor(float(npix), device=dev)
    for dt in (f32, b16):
        lg = seg32.to(dev, dt)
        for wname, w in class_w.items():
            for mode, hp in modes.items():
                lerr, derr = held(lg, seg_t, w, hp, f"{str(dt)[6:]} {wname} {mode}", gloss)
                if dt == b16:
                    stats["seg_loss_sums"]["max_abs_err"] = max(
                        stats["seg_loss_sums"]["max_abs_err"], lerr)
                    stats["seg_loss_dlogits"]["max_abs_err"] = max(
                        stats["seg_loss_dlogits"]["max_abs_err"], derr)
    # the train step's variant: the model's f32 output (an upcast of bf16)
    # read as bf16, and an f32 input that is not bf16-exact
    lg16 = seg32.to(dev, b16)
    for wname, w in class_w.items():
        want = segf.seg_loss_sums(lg16, seg_t, w, modes["focal+dice"])
        want_dl = segf.seg_loss_dlogits(lg16, seg_t, w, want[0], gloss, modes["focal+dice"])
        for xname, x in (("bf16-exact", lg16.float()), ("f32", seg32.to(dev))):
            got = segf.seg_loss_sums(x, seg_t, w, modes["focal+dice"], round_bf16=True)
            dl = segf.seg_loss_dlogits(x, seg_t, w, got[0], gloss, modes["focal+dice"],
                                       round_bf16=True)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            same_dl = dl.dtype == f32 and torch.equal(dl, want_dl.float())
            log(f"[check seg loss f32 in {wname} {xname}] sums, loss, f_score equal the bf16 "
                f"path's bits: {same}; dlogits equal its upcast: {same_dl}")
            check(same and same_dl, "the f32-in seg-loss kernels give the bf16 path's bits")
    del lg16
    # partial last tiles (npix 1 and 300) and the generic path (C = 21)
    g7 = torch.Generator().manual_seed(7)
    for shape, c in (((1, 1, 1), c9), ((1, 3, 100), c9), ((2, 37, 53), 21)):
        l32 = torch.randn(*shape, c, generator=g7) * 2
        tg = torch.randint(0, c + 1, shape, generator=g7, dtype=torch.int32).to(dev)
        for dt in (f32, b16):
            held(l32.to(dev, dt), tg, None, modes["focal+dice"],
                 f"{str(dt)[6:]} {shape} C={c}", torch.tensor(float(tg.numel()), device=dev))

    # times: the main path's variant (f32 in, read as bf16) in the kernels
    # line, the bf16 variant beside it
    hp, one = modes["focal+dice"], torch.tensor(1.0, device=dev)
    for variant, x, rnd in (("f32 in", seg32.to(dev), True), ("bf16", seg32.to(dev, b16), False)):
        acc = segf.seg_loss_sums(x, seg_t, None, hp, rnd)[0]
        fns = {"seg_loss_sums": (
                   lambda x=x, rnd=rnd: segf.seg_loss_sums(x, seg_t, None, hp, rnd),
                   lambda x=x, rnd=rnd: segf.seg_sums_plain(x, seg_t, None, hp, rnd), False),
               "seg_loss_dlogits": (
                   lambda x=x, rnd=rnd, acc=acc: segf.seg_loss_dlogits(x, seg_t, None, acc, one,
                                                                       hp, rnd),
                   lambda x=x, rnd=rnd, acc=acc: segf.seg_dlogits_plain(x, seg_t, None, acc, one,
                                                                        hp, rnd), True)}
        for kname, (fk, fp, backward) in fns.items():
            ms = cuda_ms(fk, 20)
            dms, _ = device_ms(fk, kname + "_kernel", 20)
            pms = cuda_ms(fp, 3, warmup=1)
            bms, by = bound_ms(*seg_bounds(npix, c9, x.element_size(), backward),
                               peak=PEAK_FLOPS_F32)
            geo = kernels.seg_loss_info(backward, x.dtype, c9, rnd, dev)
            geo["ctas"] = kernels.seg_loss_blocks(backward, npix, c9, x.element_size(), dev)
            log(f"[time {kname} {variant} (16,512,512,9)] kernel {ms:.4f} ms events, "
                f"{dms:.4f} ms trace, plain {pms:.4f} ms, bound {bms:.5f} ms ({by})")
            log(f"[geometry {kname} {variant}] CTAs {geo['ctas']} of {geo['threads']} threads, "
                f"CTAs/SM {geo['ctas_per_sm']}, registers {geo['registers']}, shared memory "
                f"{geo['smem_bytes']} B, ring slots {geo['stages']}")
            if rnd:
                stats[kname].update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                                    bound_by=by, device_geometry=geo)
            else:
                stats[kname].update(device_bf16_events_ms=ms, device_bf16_trace_ms=dms,
                                    device_bf16_bound_ms=bms)
        del x, acc, fns

    # the train step's span: the model's NHWC f32 output of its bf16 map,
    # the seg loss and the gradient back to that map
    cfg = Config(model=ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                                   input_size=(512, 512)),
                 loss=LossConfig(use_pallas_seg=True))
    seg_map = seg32.to(dev, b16).permute(0, 3, 1, 2).detach().requires_grad_(True)

    def span():
        loss, _ = train_step.seg_loss_and_fscore(cfg, seg_map.permute(0, 2, 3, 1).float(),
                                                 {"seg_target": seg_t})
        return torch.autograd.grad(loss, seg_map, one)

    rows, ops = trace_table(span, 10)
    log(f"[seg span] per train step: {ops:.0f} device ops, "
        f"{sum(ms for ms, _ in rows.values()):.4f} device ms: " + ", ".join(
            f"{name[:48]} {ms:.4f} x{n:.0f}" for name, (ms, n) in rows.items()))
    stats["seg_loss_sums"]["device_span_ops"] = ops
    stats["seg_loss_sums"]["device_span_ms"] = sum(ms for ms, _ in rows.values())
    return stats


# phase 15: the training CLI on the card, r05's recipe
# (model_data/convergence_tpu_r05/MILESTONES.md:17-20) for three epochs, then
# one more from the full checkpoint
CLI_FLAGS = ["--synthetic", "48", "--synthetic-learnable", "--input-size", "512",
             "--freeze-epoch", "1", "--batch-size", "8", "--optimizer", "adam",
             "--init-lr", "4e-4", "--no-ema", "--seg-signed-logits", "--eval-period", "1",
             "--save-period", "3", "--compute-dtype", "bfloat16", "--cache-gb", "1",
             "--weights", R05]
CLI_MIN_AP50, CLI_MIN_MIOU = 0.90, 0.93
# the kernels of the CLI's path (the others must stay at 0 launches)
CLI_KERNELS = ("mixer_block", "mlp_block", "mixer_block_bwd", "mlp_block_bwd",
               "seg_loss_sums", "seg_loss_dlogits", "simota_assign")


def check_train_cli(dev):
    """Phase 15: `python -m asy_vrnet_tpu_torch.cli.train` in this process,
    through its `main`, on r05's recipe: 3 epochs (the first with the
    backbone frozen at batch 32), then `--resume` from `ckpt/step_3.pt` for a
    fourth.  Checks: partial_load loads every leaf; the callbacks on the r05
    weights before training and after every epoch give AP50 and mIoU above
    their floors; every epoch's loss is finite; the launch counters over the
    run equal 27 K2 and K1 a train step, val step and callback forward, 27
    K6 and K5 a train step, K4 and the SimOTA wrapper a train and val step,
    K4b a train step, no other kernel; every batch `device_prefetch` hands
    out in epoch 1 equals its host batch; the resumed run's step continues
    from three epochs' steps; `last_epoch_weights.npz` loads strictly into a
    fresh model.  -> summary (epoch seconds, images/s and loader-wait share
    by host clock, the launches, the metrics)."""
    import numpy as np
    import torch

    from asy_vrnet_tpu_torch.cli import train as cli
    from asy_vrnet_tpu_torch.data import native_io
    from asy_vrnet_tpu_torch.data.dataset import (
        DataLoader,
        WaterScenesDataset,
        read_annotation_file,
    )
    from asy_vrnet_tpu_torch.data.synthetic import write_learnable_voc_dataset
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.ops import block, simota_fused
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as segf
    from asy_vrnet_tpu_torch.train import callbacks, checkpoint, loop
    from asy_vrnet_tpu_torch.train.state import float_state

    t_phase = time.time()
    counters = (block, cf, segf, simota_fused)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    save_dir = os.path.join(work, "logs")
    flags = CLI_FLAGS + ["--save-dir", save_dir]
    args = cli.build_argparser().parse_args(flags)
    cfg, class_names = cli.resolve_config(args)
    n, size = args.synthetic, args.input_size
    hw = (size, size)
    log(f"[train cli] npz reader: {'native' if native_io.native_available() else 'numpy'}"
        f" (build error: {native_io.build_error()})")

    # the r05 weights before training: the callbacks on a copy of the set
    # the CLI writes (the same writer, size and seed)
    meta = write_learnable_voc_dataset(os.path.join(work, "pre"), num_images=n, hw=hw)
    model = create_model(cfg.model, dev, weights=R05)
    ds = WaterScenesDataset(read_annotation_file(meta["annotation_path"]), hw,
                            cfg.model.num_classes, cfg.model.num_seg_classes,
                            meta["radar_root"], meta["seg_dataset_path"],
                            max_boxes=cfg.loss.max_boxes)
    pre_loader = DataLoader(ds, cfg.train.batch_size, shuffle=False, workers=2)
    logs = os.path.join(work, "pre_logs")
    pre_ap = callbacks.DetEvalCallback(model, cfg, pre_loader, class_names, logs,
                                       period=1).on_epoch_end(0, float_state(model))
    pre_miou = callbacks.SegEvalCallback(model, cfg, pre_loader, logs,
                                         period=1).on_epoch_end(0, float_state(model))
    log(f"[train cli] r05 weights before training: AP50 {pre_ap:.4f}, mIoU {pre_miou:.4f}")
    check(pre_ap >= CLI_MIN_AP50 and pre_miou >= CLI_MIN_MIOU, "r05's AP50 / mIoU")
    del model

    loads, calls, forwards, cb_s = [], [], [0], []
    real_prefetch, real_partial = loop.device_prefetch, checkpoint.partial_load
    real_forward = callbacks._EvalForward.__call__
    real_cbs = {c: c.on_epoch_end for c in (callbacks.DetEvalCallback,
                                            callbacks.SegEvalCallback)}

    def timed(cls):
        def on_epoch_end(self, epoch, variables):
            t = time.time()
            out = real_cbs[cls](self, epoch, variables)
            cb_s.append((cls.__name__, time.time() - t))
            return out
        return on_epoch_end

    def partial_load(target, source, verbose=True):
        out = real_partial(target, source, verbose)
        loads.append((len(out[1]), len(out[2])))
        return out

    def forward(self, variables, batch):
        forwards[0] += 1
        return real_forward(self, variables, batch)

    def prefetch(iterator, device):
        """device_prefetch, timed; in epoch 1 (its first two calls: train,
        val) every device batch is held against its host batch."""
        rec = {"start": time.time(), "batches": 0, "images": 0, "wait": 0.0, "step_s": []}
        calls.append(rec)
        held = len(calls) <= 2
        hosts = []

        def tee():
            for b in iterator:
                if held:
                    hosts.append(b)
                yield b

        it = real_prefetch(tee(), device)
        handed = None
        while True:
            t = time.time()
            if handed is not None:              # the consumer's time for the last batch
                rec["step_s"].append(t - handed)
            try:
                db = next(it)
            except StopIteration:
                break
            rec["wait"] += time.time() - t
            if held:
                host = hosts.pop(0)
                for k, v in host.items():
                    if k != "image_id":
                        check(db[k].device.type == dev.type
                              and torch.equal(db[k].cpu(), torch.as_tensor(v)),
                              f"prefetched {k} equals the host batch")
            rec["batches"] += 1
            rec["images"] += int(db["image"].shape[0])
            handed = time.time()
            yield db
        rec["end"] = time.time()

    def run(argv):
        reset_launches(*counters)
        loop.device_prefetch, checkpoint.partial_load = prefetch, partial_load
        callbacks._EvalForward.__call__ = forward
        for cls in real_cbs:
            cls.on_epoch_end = timed(cls)
        old_tmp = tempfile.tempdir
        tempfile.tempdir = work                   # the CLI's synthetic set
        try:
            t0 = time.time()
            state = cli.main(argv)
            torch.cuda.synchronize()
            return state, time.time() - t0
        finally:
            tempfile.tempdir = old_tmp
            loop.device_prefetch, checkpoint.partial_load = real_prefetch, real_partial
            callbacks._EvalForward.__call__ = real_forward
            for cls, fn in real_cbs.items():
                cls.on_epoch_end = fn

    try:
        state, seconds = run(flags + ["--epochs", "3"])
        end = time.time()
        launches = {k: v for m in counters for k, v in m.LAUNCHES.items()}
        check(len(calls) == 6, f"device_prefetch calls {len(calls)}, expected 6")
        train = sum(calls[i]["batches"] for i in (0, 2, 4))
        val = sum(calls[i]["batches"] for i in (1, 3, 5))
        want = dict.fromkeys(launches, 0)
        want.update(mixer_block=27 * (train + val + forwards[0]),
                    mlp_block=27 * (train + val + forwards[0]),
                    mixer_block_bwd=27 * train, mlp_block_bwd=27 * train,
                    seg_loss_sums=train + val, seg_loss_dlogits=train,
                    simota_assign=train + val)
        log(f"[train cli] partial_load (loaded, kept) {loads}; {train} train steps, {val} "
            f"val steps, {forwards[0]} callback forwards; launches {launches}")
        with np.load(args.weights) as src:
            leaves = len(src.files)
        check(len(loads) == 2 and sum(l for l, _ in loads) == leaves
              and not any(k for _, k in loads), f"partial_load loaded every leaf: {loads}")
        check(launches == want, f"CLI launches {launches}, expected {want}")
        per_epoch = n // cfg.train.batch_size
        check(train == n // cfg.train.freeze_batch_size + 2 * per_epoch
              and val == 3 * per_epoch and forwards[0] == 2 * 3 * per_epoch
              and state.step == train,
              f"steps {train}, {val}, {forwards[0]}, state.step {state.step}")

        def lines(name):
            with open(os.path.join(save_dir, name)) as f:
                return [float(v) for v in f.read().split()]

        aps, mious = lines("epoch_map.txt"), lines("epoch_miou.txt")
        losses = lines(os.path.join("loss", "epoch_det_seg.txt"))
        val_losses = lines(os.path.join("loss", "epoch_val_det_seg.txt"))
        epochs = []
        for e in range(3):
            tr, vl = calls[2 * e], calls[2 * e + 1]
            wall = (calls[2 * e + 2]["start"] if e < 2 else end) - tr["start"]
            det_s, seg_s = cb_s[2 * e][1], cb_s[2 * e + 1][1]
            epochs.append({
                "epoch": e + 1, "wall_s": wall, "train_s": vl["start"] - tr["start"],
                "val_s": vl["end"] - vl["start"], "det_eval_s": det_s, "seg_eval_s": seg_s,
                "step_ms": [round(1e3 * v, 3) for v in tr["step_s"]],
                "train_images": tr["images"],
                "train_images_per_s": tr["images"] / (vl["start"] - tr["start"]),
                "loader_wait_s": tr["wait"] + vl["wait"],
                "loader_wait_share": (tr["wait"] + vl["wait"]) / wall,
                "loss": losses[e], "val_loss": val_losses[e], "ap50": aps[e],
                "miou": mious[e]})
            log("[train cli] epoch {epoch}: wall {wall_s:.3f} s, train loop {train_s:.3f} s "
                "for {train_images} images ({train_images_per_s:.2f} images/s; host ms a "
                "step {step_ms}), val loop {val_s:.3f} s, det eval {det_eval_s:.3f} s, seg "
                "eval {seg_eval_s:.3f} s, loader wait {loader_wait_s:.3f} s "
                "({loader_wait_share:.4f} of the epoch); loss {loss:.4f}, val {val_loss:.4f}, "
                "AP50 {ap50:.4f}, mIoU {miou:.4f}".format(**epochs[-1]))
        check(len(aps) == len(mious) == len(losses) == 3, "one eval and loss an epoch")
        check(all(np.isfinite(losses + val_losses)), f"finite losses {losses} {val_losses}")
        check(min(aps) >= CLI_MIN_AP50 and min(mious) >= CLI_MIN_MIOU,
              f"AP50 {aps}, mIoU {mious}")

        first_steps = state.step
        ckpt = os.path.join(save_dir, "ckpt", "step_3.pt")
        del state
        calls.clear()
        cb_s.clear()
        forwards[0] = 0
        resumed, resume_s = run(flags + ["--epochs", "4", "--resume", ckpt])
        aps, mious, losses = (lines("epoch_map.txt"), lines("epoch_miou.txt"),
                              lines(os.path.join("loss", "epoch_det_seg.txt")))
        log(f"[train cli] resumed from step_3.pt: step {first_steps} -> {resumed.step} over "
            f"{calls[0]['batches']} steps in {resume_s:.3f} s; epoch 4 loss {losses[-1]:.4f}, "
            f"AP50 {aps[-1]:.4f}, mIoU {mious[-1]:.4f}")
        check(len(calls) == 2 and calls[0]["batches"] == per_epoch
              and resumed.step == first_steps + per_epoch, f"the resumed step count {resumed.step}")
        check(len(aps) == 4 and np.isfinite(losses[-1]) and aps[-1] >= CLI_MIN_AP50
              and mious[-1] >= CLI_MIN_MIOU, f"epoch 4: AP50 {aps}, mIoU {mious}")
        check(os.path.exists(os.path.join(save_dir, "ckpt", "step_4.pt")), "step_4.pt")
        del resumed
        create_model(cfg.model, dev, weights=os.path.join(save_dir, "last_epoch_weights.npz"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = time.time() - t_phase
    log(f"[train cli] phase 15 took {total:.1f} s (first run {seconds:.1f} s)")
    return {"epochs": epochs, "launches": launches, "train_steps": train, "val_steps": val,
            "callback_forwards": 2 * 3 * per_epoch, "pre_training": {"ap50": pre_ap, "miou": pre_miou},
            "epoch4": {"ap50": aps[-1], "miou": mious[-1], "loss": losses[-1]},
            "npz_reader": "native" if native_io.native_available() else "numpy",
            "seconds": total}


# phase 16: inference and offline evaluation on the card, r05's weights on
# phase 15's 48-image learnable set (the same writer, size and seed), as r05
# was trained: signed seg logits, raw radar
INFER_FLAGS = ["--weights", R05, "--seg-signed-logits", "--radar-norm", "none",
               "--compute-dtype", "bfloat16", "--input-size", "512"]
INFER_MIN = 0.95          # AP50 and mIoU floors, and
INFER_SLACK = 0.01        # the distance allowed from the callbacks at batch 1
FPS_CALLS = 10
PREDICT_DIR = 8           # images in predict's dir_predict and map_txt runs


def check_inference(dev, pre):
    """Phase 16: the inference and offline-evaluation entry points on the
    card, each through its CLI `main` in this process (or its function),
    with the launch counters reset just before and read just after:
    get_map (AP50) and get_miou (mIoU) above INFER_MIN and within
    INFER_SLACK of the training callbacks run here on the same weights and
    set at batch 1, printed beside phase 15's (`pre`, batch 8): the model
    min-maxes the radar gate over the whole batch (`data_normal`, a parity
    quirk of the reference), so an image's outputs depend on the images it
    is batched with, and get_map and get_miou take one image at a time;
    predict in the predict, heatmap, dir_predict and map_txt modes (the
    last two on PREDICT_DIR images; map_txt's files equal get_map's
    detection-results) and fps on both
    clocks; predict_seg predict and fps; the export mode (time; the saved
    program loaded again holds 27 + 27 operator nodes and no plain twin,
    and gives the eager graph's bits); the fused pipeline at batch 8 on
    the set's frames and points made from its radar maps (ms a batch),
    against the same batch letterboxed and normalised on the host through
    the same forward, decode and NMS, and, one frame at a time, against
    Detector.detect on the same maps (each: >= 95% of the reference's boxes
    matched at IoU >= 0.9 with the same class; seg probabilities sum to 1);
    Detector.detect at batch 1, wall and device time per request, and the
    post-process alone.  K2 and K1 launch 27 times per forward in every
    entry point, no other kernel."""
    import glob

    import numpy as np
    import torch
    from PIL import Image

    from asy_vrnet_tpu_torch.cli import get_map, get_miou, predict, predict_seg
    from asy_vrnet_tpu_torch.config import Config, ModelConfig
    from asy_vrnet_tpu_torch.data.dataset import (
        DataLoader,
        WaterScenesDataset,
        read_annotation_file,
    )
    from asy_vrnet_tpu_torch.data.synthetic import write_learnable_voc_dataset
    from asy_vrnet_tpu_torch.infer.export import ServingGraph, decode_and_nms, load_exported
    from asy_vrnet_tpu_torch.infer.pipeline import build_fused_pipeline
    from asy_vrnet_tpu_torch.infer.predictor import Detector
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.ops import block, simota_fused
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as segf
    from asy_vrnet_tpu_torch.ops import mixer_ablate as ma
    from asy_vrnet_tpu_torch.ops.boxes import correct_boxes
    from asy_vrnet_tpu_torch.train import callbacks
    from asy_vrnet_tpu_torch.train.state import float_state
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms, profile_calls

    t_phase = time.time()
    counters = (block, cf, segf, simota_fused, ma)
    work = tempfile.mkdtemp(prefix="chip_smoke_infer_")
    out = {"entry_points": {}}

    def launches():
        return {k: v for m in counters for k, v in m.LAUNCHES.items()}

    def entry(name, forwards, fn):
        """Run fn() with the counters reset: K2 and K1 27 per forward, no
        other kernel.  -> (fn's result, seconds)."""
        reset_launches(*counters)
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        sec = time.time() - t0
        got = launches()
        want = dict.fromkeys(got, 0)
        want.update(mixer_block=27 * forwards, mlp_block=27 * forwards)
        check(got == want, f"{name}: launches {got}, expected {want}")
        out["entry_points"][name] = {"forwards": forwards, "seconds": sec,
                                     "mixer_block": got["mixer_block"],
                                     "mlp_block": got["mlp_block"]}
        log(f"[inference {name}] {sec:.3f} s, {forwards} forwards, launches K2 "
            f"{got['mixer_block']}, K1 {got['mlp_block']}, other kernels 0")
        return res, sec

    try:
        meta = write_learnable_voc_dataset(os.path.join(work, "set"), num_images=48,
                                           hw=(512, 512))
        n = 48
        images = os.path.join(meta["seg_dataset_path"], "JPEGImages")
        names = sorted(os.listdir(images))
        ids = [os.path.splitext(x)[0] for x in names]
        flags = INFER_FLAGS + ["--device", str(dev)]
        det_flags = flags + ["--classes", meta["classes_path"]]

        # offline evaluation
        txt = os.path.join(work, "map_txt")
        res, _ = entry("get_map", n, lambda: get_map.main(
            ["--val-annotation", meta["annotation_path"], "--radar-root", meta["radar_root"],
             "--write-txt", txt] + det_flags))
        ap = res["coco"]["map"]
        res, _ = entry("get_miou", n, lambda: get_miou.main(
            ["--val-annotation", meta["annotation_path"], "--radar-root", meta["radar_root"],
             "--seg-path", meta["seg_dataset_path"], "--out", os.path.join(work, "miou")]
            + flags))
        miou = float(np.nanmean(res[1]))
        cfg = ModelConfig(phi="nano", variant="coc_small", compute_dtype="bfloat16",
                          input_size=(512, 512), seg_signed_logits=True)
        model = create_model(cfg, dev, weights=R05)
        ds = WaterScenesDataset(read_annotation_file(meta["annotation_path"]), (512, 512), 4,
                                9, meta["radar_root"], meta["seg_dataset_path"], max_boxes=100)
        one = DataLoader(ds, 1, shuffle=False, workers=2)
        logs = os.path.join(work, "callbacks")
        names4 = ["pier", "vessel", "ship", "boat"]
        cb_ap = callbacks.DetEvalCallback(model, Config(model=cfg), one, names4, logs,
                                          period=1).on_epoch_end(0, float_state(model))
        cb_miou = callbacks.SegEvalCallback(model, Config(model=cfg), one, logs,
                                            period=1).on_epoch_end(0, float_state(model))
        log(f"[inference] get_map AP50 {ap:.4f}, get_miou mIoU {miou:.4f}; the callbacks on "
            f"the same weights and set at batch 1: AP50 {cb_ap:.4f}, mIoU {cb_miou:.4f}; at "
            f"batch 8 (phase 15): AP50 {pre['ap50']:.4f}, mIoU {pre['miou']:.4f}")
        check(ap >= INFER_MIN and abs(ap - cb_ap) <= INFER_SLACK, f"AP50 {ap} vs {cb_ap}")
        check(miou >= INFER_MIN and abs(miou - cb_miou) <= INFER_SLACK,
              f"mIoU {miou} vs {cb_miou}")
        out.update(ap50=ap, miou=miou, callbacks_batch1={"ap50": cb_ap, "miou": cb_miou},
                   callbacks_batch8=pre)

        # predict, every mode but video (cv2) and export (below)
        first = os.path.join(images, names[0])
        radar0 = os.path.join(meta["radar_root"], ids[0] + ".npz")
        pdir = os.path.join(work, "predict")

        def run_predict(mode, image, radar, extra=()):
            return predict.main(["--mode", mode, "--image", image, "--radar", radar,
                                 "--out", os.path.join(pdir, mode), *extra] + det_flags)

        entry("predict", 1, lambda: run_predict("predict", first, radar0))
        heat, _ = entry("heatmap", 1, lambda: run_predict("heatmap", first, radar0))
        check(heat.shape == (512, 512) and 0.0 <= heat.min() and heat.max() <= 1.0, "heatmap")
        # the directory modes on the set's first PREDICT_DIR images
        sub = os.path.join(work, "predict_images")
        os.makedirs(sub)
        for x in names[:PREDICT_DIR]:
            shutil.copy(os.path.join(images, x), sub)
        entry("dir_predict", PREDICT_DIR, lambda: run_predict("dir_predict", sub,
                                                              meta["radar_root"]))
        entry("map_txt", PREDICT_DIR, lambda: run_predict("map_txt", sub, meta["radar_root"]))
        check(sorted(os.listdir(os.path.join(pdir, "dir_predict"))) == names[:PREDICT_DIR],
              "dir_predict")
        same = 0
        for i in ids[:PREDICT_DIR]:
            with open(os.path.join(pdir, "map_txt", i + ".txt")) as f:
                a = [line.split() for line in f.read().splitlines()]
            with open(os.path.join(txt, "detection-results", i + ".txt")) as f:
                b = [line.split() for line in f.read().splitlines()]
            check(len(a) == len(b) and all(
                x[0] == y[0] and abs(float(x[1]) - float(y[1])) <= 1e-4
                and max(abs(int(u) - int(v)) for u, v in zip(x[2:], y[2:])) <= 1
                for x, y in zip(a, b)), f"map_txt {i} against get_map's detections")
            same += a == b
        log(f"[inference] map_txt: {PREDICT_DIR} files agree with get_map's detection-results "
            f"({same} identical)")
        fps = {}
        for clock, extra in (("host", ()), ("device", ("--device-time",))):
            calls = 1 + FPS_CALLS if clock == "host" else 1 + 3 * FPS_CALLS
            fps[clock], _ = entry(f"fps {clock}", calls, lambda extra=extra: run_predict(
                "fps", first, radar0, ("--test-interval", str(FPS_CALLS), *extra)))
        seg_flags = ["--image", first, "--radar", radar0, "--out",
                     os.path.join(work, "predict_seg")] + flags
        entry("predict_seg", 1, lambda: predict_seg.main(["--mode", "predict"] + seg_flags))
        seg_fps, _ = entry("predict_seg fps", 1 + FPS_CALLS, lambda: predict_seg.main(
            ["--mode", "fps", "--test-interval", str(FPS_CALLS)] + seg_flags))
        log(f"[inference fps] detect: {fps['host'] * 1e3:.3f} ms a request by the host "
            f"clock, {fps['device'] * 1e3:.3f} ms by CUDA events; segment: "
            f"{seg_fps * 1e3:.3f} ms by the host clock (batch 1)")
        out.update(fps_s={"detect_host": fps["host"], "detect_device": fps["device"],
                          "segment_host": seg_fps})

        # export: trace, save, load again, the graph's nodes, the outputs
        pt2 = os.path.join(work, "asy_vrnet.pt2")
        _, export_s = entry("export", 0, lambda: run_predict(
            "export", first, radar0, ("--export-path", pt2)))
        t0 = time.time()
        run = load_exported(pt2)
        load_s = time.time() - t0
        targets = [str(nd.target) for nd in run.module.graph.nodes if nd.op == "call_function"]
        nodes = {k: targets.count(f"asy_vrnet.{k}.default") for k in ("mixer_block", "mlp_block")}
        plain = [t for t in targets if any(k in t for k in ("einsum", "one_hot", "gelu"))]
        log(f"[inference export] traced and saved in {export_s:.2f} s, loaded in {load_s:.2f} s "
            f"({os.path.getsize(pt2) / 2 ** 20:.1f} MiB); {len(targets)} ops, operator nodes "
            f"{nodes}, plain-twin ops {len(plain)}")
        check(nodes == {"mixer_block": 27, "mlp_block": 27} and not plain, "exported graph")
        detector = Detector(cfg, ["pier", "vessel", "ship", "boat"], model=model,
                            radar_norm="none")
        img0, rad0, _, _ = detector._prep(Image.open(first), np.load(radar0)["arr_0"])
        (pd, ps), _ = entry("exported program", 1, lambda: run(img0, rad0))
        with torch.no_grad():
            rd, rs = ServingGraph(model, cfg)(img0, rad0)
        equal = all(torch.equal(pd[k], rd[k]) for k in rd) and torch.equal(ps, rs)
        sdiff = (ps - rs).abs().max().item()
        log(f"[inference export] loaded program vs eager graph: equal bits {equal}, seg "
            f"max |diff| {sdiff:.3e}, boxes kept {int(pd['valid'].sum())} / "
            f"{int(rd['valid'].sum())}")
        # tolerance: the same kernels on the same inputs; aim and require the
        # same detections, seg probabilities within 1e-6
        check(all(torch.equal(pd[k], rd[k]) for k in rd) and sdiff <= 1e-6, "exported outputs")
        out["export"] = {"export_s": export_s, "load_s": load_s, "ops": len(targets),
                         "equal_bits": equal, "seg_max_abs": sdiff}

        # the fused pipeline at batch 8 against Detector.detect on the same maps
        b = 8
        frames = np.stack([np.asarray(Image.open(os.path.join(images, x)).convert("RGB"))
                           for x in names[:b]])
        maps = [np.load(os.path.join(meta["radar_root"], i + ".npz"))["arr_0"] for i in ids[:b]]
        rows = []
        for m in maps:                      # one (u, v, r, v, e, p) row per non-zero pixel
            vv, uu = np.nonzero(np.any(m != 0, axis=0))
            rows.append(np.concatenate([np.stack([uu, vv], 1).astype(np.float32),
                                        m[:, vv, uu].T], 1))
        npts = max(len(r) for r in rows)
        pts = np.full((b, npts, 6), -1.0, np.float32)
        valid = np.zeros((b, npts), bool)
        for k, r in enumerate(rows):
            pts[k, :len(r)] = r
            valid[k, :len(r)] = True
        pipe = build_fused_pipeline(model, cfg, (512, 512), radar_minmax=False)
        args = [torch.from_numpy(a).to(dev) for a in (frames, pts, valid)]
        (dets, probs), _ = entry("fused pipeline", 1, lambda: pipe(*args))
        pipe_ms = cuda_ms(lambda: pipe(*args), 3, warmup=1)
        check(bool((probs.sum(-1) - 1).abs().max() <= 1e-3), "pipeline seg sums")

        def boxes_of(d, k):
            keep = d["valid"][k].cpu().numpy()
            return (correct_boxes(d["boxes_xyxy"][k].cpu().numpy()[keep], (512, 512),
                                  (512, 512)), d["classes"][k].cpu().numpy()[keep])

        def matched(ref, got):
            """(reference boxes with a box of their class at IoU >= 0.9, all)."""
            (rb, rc), (gb, gc) = ref, got
            return sum(any(iou(x, o) >= 0.9 for o in gb[gc == c]) for x, c in zip(rb, rc)), len(rb)

        # the same batch, letterboxed and normalised on the host
        host = [detector._prep(Image.fromarray(frames[k]), maps[k])[:2] for k in range(b)]
        with torch.no_grad():
            ref_dets, _ = ServingGraph(model, cfg)(torch.cat([h[0] for h in host]),
                                                   torch.cat([h[1] for h in host]))
        same = all(torch.equal(dets[k], ref_dets[k]) for k in dets)
        hits = [matched(boxes_of(ref_dets, k), boxes_of(dets, k)) for k in range(b)]
        m8, t8 = sum(h for h, _ in hits), sum(t for _, t in hits)
        # one frame at a time against Detector.detect
        m1 = t1 = 0
        for k in range(b):
            single, _ = pipe(*(a[k:k + 1] for a in args))
            ref = detector.detect(Image.fromarray(frames[k]), maps[k])
            h, t = matched((ref["boxes"], ref["classes"]), boxes_of(single, 0))
            m1, t1 = m1 + h, t1 + t
        log(f"[inference pipeline] batch {b}, {npts} points an image: {pipe_ms:.3f} ms a "
            f"batch by CUDA events; against the batch letterboxed on the host: {m8}/{t8} "
            f"boxes matched (IoU >= 0.9, same class), equal bits {same}; one frame at a time "
            f"against Detector.detect: {m1}/{t1} matched")
        check(t8 > 0 and m8 >= 0.95 * t8, f"pipeline vs host batch {m8}/{t8}")
        check(t1 > 0 and m1 >= 0.95 * t1, f"pipeline vs Detector.detect {m1}/{t1}")
        out["pipeline"] = {"batch": b, "points": npts, "ms": pipe_ms, "equal_bits_batch": same,
                           "matched_batch": [m8, t8], "matched_detector": [m1, t1]}

        # Detector.detect at batch 1: wall and device time a request; the
        # post-process (decode + NMS) alone
        image, radar = Image.open(first), np.load(radar0)["arr_0"]
        entry("detect", 21, lambda: [detector.detect(image, radar) for _ in range(21)])
        t0 = time.perf_counter()
        for _ in range(20):
            detector.detect(image, radar)
        wall = (time.perf_counter() - t0) * 1e3 / 20
        prof = profile_calls(lambda: detector.detect(image, radar), reps=5)
        with torch.no_grad():
            det_maps, _ = model(img0, rad0)
        post = {}
        for mode, fixed in (("early exit", False), ("fixed rounds", True)):
            fn = lambda fixed=fixed: decode_and_nms(  # noqa: E731
                det_maps, cfg, 0.3, 0.5, 100, fixed_rounds=fixed)
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            post[mode] = {"host_ms": (time.perf_counter() - t0) * 1e3 / 20,
                          "events_ms": cuda_ms(fn, 20, warmup=1),
                          "device_ms": profile_calls(fn, reps=5)["device_ms"]}
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        log(f"[inference detect bs=1] {smi}: wall {wall:.3f} ms a request (host clock, "
            f"letterbox to boxes), profiled wall {prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_ms']:.3f} ms ({prof['busy_share']:.3f}), {prof['launches']} "
            f"launches")
        for mode, v in post.items():
            log(f"[inference post-process bs=1 {mode}] host {v['host_ms']:.3f} ms, CUDA events "
                f"{v['events_ms']:.3f} ms, device busy {v['device_ms']:.4f} ms")
        out["detect_bs1"] = {"card": smi, "wall_ms": wall, "profile": prof, "post": post}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log(f"[inference] phase 16 took {out['seconds']:.1f} s")
    return out


# phase 17: data-parallel training (asy_vrnet_tpu_torch/parallel/) at the
# CLI's defaults: nano coc_small, bf16, fused blocks and seg loss, r05's
# weights, 512^2, global batch 16, 2 steps
PAR_STEPS = 2
# the kernels a fused train step launches (SimOTA's count is of wrapper calls)
# leg (b) runs the CLI's bf16 and, to separate a fault from bf16 rounding,
# f32
PAR_DTYPES = ("bfloat16", "float32")
# leg (b), bf16: the two-rank update after steps 1, 2 against the plain
# step's, relative to the plain update's norm.  bf16 rounds a per-sample
# reduction (GroupNorm's statistics) otherwise at another batch size, and
# the step amplifies it: the same step on the batch tiled twice moves the
# update by 1.09e-1 / 1.49e-1, the two ranks by 4.87e-2 / 9.02e-2 (PERF.md)
PAR_BF16_UPDATE_LIMITS = (0.1, 0.2)
PAR_KERNELS = ("mixer_block", "mlp_block", "mixer_block_bwd", "mlp_block_bwd",
               "seg_loss_sums", "seg_loss_dlogits", "simota_assign")


def _par_setup(dev, dtype="bfloat16"):
    """(config, train state from r05 at the adaptive lr, the 2 global
    batches as numpy) of phase 17, computing in `dtype`."""
    import numpy as np

    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train.optim import adaptive_lr, set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state

    cfg = Config(model=ModelConfig(phi="nano", variant="coc_small", compute_dtype=dtype,
                                   input_size=(512, 512), seg_signed_logits=True,
                                   use_pallas_cluster=True),
                 loss=LossConfig(max_boxes=MAX_BOXES, use_pallas_seg=True))
    state = create_train_state(cfg, device=dev, weights=R05)
    set_learning_rate(state.optimizer, adaptive_lr(cfg.optim, TRAIN_BATCH)[0])
    batches = [make_batch(np.random.default_rng(90 + i), TRAIN_BATCH, (512, 512),
                          max_boxes=MAX_BOXES) for i in range(PAR_STEPS)]
    return cfg, state, batches


def _par_bits(state) -> dict:
    """The state a step changes, as CPU tensors: parameters and BN stats
    (`state/`), EMA (`ema/`), the log-variance."""
    from asy_vrnet_tpu_torch.train.state import float_state

    out = {f"state/{k}": v.detach().cpu().clone() for k, v in float_state(state.model).items()}
    out.update({f"ema/{k}": v.cpu().clone() for k, v in state.ema.items()})
    out["log_var"] = state.log_var.detach().cpu().clone()
    return out


def _par_run(state, step, batches, dev, shard=None):
    """PAR_STEPS steps; -> per step (metrics, launches, step ms and
    collective ms by CUDA events, all-reduce calls, the state's bits)."""
    import torch

    from asy_vrnet_tpu_torch.ops import block, simota_fused
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as segf
    from asy_vrnet_tpu_torch.parallel import collectives

    counters = (block, cf, segf, simota_fused)
    out = []
    for b in batches:
        rows = b if shard is None else shard(b)
        db = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        torch.cuda.synchronize()
        reset_launches(*counters)
        collectives.CALLS["all_reduce"] = 0
        events = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with collectives.timed(events):
            state, m = step(state, db)
        end.record()
        torch.cuda.synchronize()
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        out.append({"metrics": {k: v.detach().cpu().clone() for k, v in m.items()},
                    "launches": launches, "step_ms": start.elapsed_time(end),
                    "collective_ms": sum(s.elapsed_time(e) for s, e in events),
                    "all_reduce_calls": collectives.CALLS["all_reduce"],
                    "bits": _par_bits(state)})
    return out


def _parallel_rank(rank, init_method, out_dir):
    """Leg (b) of phase 17: rank `rank` of two gloo ranks that share
    cuda:0.  Checks that gloo's SUM, MIN and MAX all-reduces work on CUDA
    tensors, then runs the parallel step on its rows of the global
    batches under torch's deterministic algorithms, in bf16 and in f32;
    rank 0 saves its state after each step."""
    import torch
    import torch.distributed as dist

    from asy_vrnet_tpu_torch.parallel import mesh as pm
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.init_rank(rank, 2, "gloo", torch.device("cuda", 0), init_method)
    try:
        ops = {}
        for name, op, want in (("SUM", dist.ReduceOp.SUM, 3.0), ("MIN", dist.ReduceOp.MIN, 1.0),
                               ("MAX", dist.ReduceOp.MAX, 2.0)):
            t = torch.full((3,), rank + 1.0, device=dev)
            dist.all_reduce(t, op=op)
            ops[name] = t.tolist()
            check(t.device == dev and t.tolist() == [want] * 3,
                  f"gloo {name} all-reduce of CUDA tensors gave {t.tolist()}")
        mesh = pm.make_mesh(2)
        res = {"rank": rank, "ops": ops}
        for dtype in PAR_DTYPES:
            cfg, state, batches = _par_setup(dev, dtype)
            pm.replicate_state(state, mesh)
            step = pm.build_parallel_train_step(build_train_step(cfg, device=dev), mesh)
            with deterministic_algorithms():
                res[dtype] = _par_run(state, step, batches, dev,
                                      shard=lambda b: pm.shard_batch(b, mesh))
            del state
            if rank:
                for st in res[dtype]:
                    del st["bits"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pm.shutdown()


def _par_witnesses(dev):
    """bf16's rounding, without a process group: the plain step from leg
    (a)'s start on the same global batches with (a) the rows in reversed
    order, (b) the batch tiled twice (32 rows, each row twice: the same
    step in exact arithmetic, with every per-sample reduction at another
    batch size), under torch's deterministic algorithms.  -> {name: the
    run's steps}."""
    import numpy as np
    import torch

    from asy_vrnet_tpu_torch.ops.block import gn1_stats
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    # where the rounding starts: GroupNorm's per-sample statistics of rows
    # 0-7 alone and within the 16 rows, at the four stages' shapes
    g = torch.Generator(device=dev).manual_seed(0)
    differ = {}
    for shape in ((16, 16, 128, 128), (16, 32, 64, 64), (16, 80, 32, 32), (16, 128, 16, 16)):
        x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
        differ[shape[1:]] = int((gn1_stats(x[:8]) != gn1_stats(x)[:8]).any(dim=1).sum())
    log(f"[parallel b bf16 witness] GroupNorm statistics (gn1_stats) of 8 rows alone vs "
        f"within 16, samples whose bits differ (of 8) at (C, H, W): {differ}")
    cfg, state, batches = _par_setup(dev)
    step = build_train_step(cfg)
    rows = {"reversed rows": lambda b: {k: v[::-1].copy() for k, v in b.items()},
            "tiled twice": lambda b: {k: np.concatenate([v, v]) for k, v in b.items()}}
    out = {}
    with deterministic_algorithms():
        for name, shard in rows.items():
            out[name] = _par_run(copy.deepcopy(state), step, batches, dev, shard=shard)
    return out


def _launch_row(steps):
    return [{k: s["launches"][k] for k in PAR_KERNELS} for s in steps]


def check_parallel(dev):
    """Phase 17, three legs at the CLI's defaults (nano coc_small, bf16, fused):
    (a) the parallel step on a one-rank NCCL group on cuda:0, 2 steps of
        global batch 16 at 512^2 from r05, against the plain step from the
        same start and batches, both under torch's deterministic
        algorithms (a second plain run repeats the first's bits): the same
        bits (parameters, BN stats, EMA, log-variance, every metric) and
        the same launches;
    (b) two gloo ranks sharing cuda:0 (new processes; gloo's SUM, MIN and
        MAX on CUDA tensors checked first), 8 rows each of the same global
        batches, against the plain step, both under deterministic
        algorithms: in bf16 every metric within 1e-2 relative (num_fg
        within 1% or one anchor) and the parameter update (new - old) after
        steps 1 and 2 within PAR_BF16_UPDATE_LIMITS of the plain update's
        norm, printed beside bf16's rounding witnesses (`_par_witnesses`)
        and the plain step's own difference under default algorithms;
        in f32 the metrics within 1e-4 (num_fg equal), the update after
        each step within 5e-3 and the BN stats' within 1e-4; the two ranks'
        launches equal the plain step's; each rank's step and all-reduce ms
        by CUDA events;
    (c) the training CLI's own launcher (`--num-devices 2`): 1 epoch on
        phase 15's learnable writer, 16 images at 128^2, batch 8, from
        r05: NCCL on cuda:0,1 with two or more cards, else gloo with both
        ranks on cuda:0 (the CLI's `rank_devices` patched to put them
        there, and the NCCL two-card leg reported as not run); rank 0
        alone writes one loss line, the callbacks' AP50 and mIoU, the
        checkpoint and weights, which load strictly.
    -> summary."""
    t_phase = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out = {"card": smi}
    out["one_rank_nccl"], plain, before, loose = _parallel_one_rank(dev, smi)
    out["two_rank_gloo"] = _parallel_two_ranks(dev, smi, plain, before, loose)
    out["cli"] = _parallel_cli(dev, smi)
    out["seconds"] = time.time() - t_phase
    log(f"[parallel] phase 17 took {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic implementations (cuDNN's and the ops' own, e.g.
    the bilinear upsample's backward, whose default adds with atomics) while
    the block runs, warn-only; yields the warnings recorded."""
    import warnings

    import torch

    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def _parallel_one_rank(dev, smi):
    """Leg (a), under torch's deterministic algorithms (by default the
    step's backward does not repeat its bits: some torch ops add with
    atomics): the plain step, a second plain run from the same start (it
    must repeat the first's bits, or no bit comparison means anything),
    then the parallel step on a one-rank NCCL group; last, the plain step
    with the default algorithms, leg (b)'s yardstick.  -> (summary, the
    plain run's steps, the start's bits, the default-algorithm run's
    steps)."""
    import torch

    from asy_vrnet_tpu_torch.parallel import mesh as pm
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    cfg, state, batches = _par_setup(dev)
    start, again, loose = (copy.deepcopy(state) for _ in range(3))
    step = build_train_step(cfg)
    before = _par_bits(state)
    with deterministic_algorithms() as caught:
        plain = _par_run(state, step, batches, dev)
        del state
        again_bits = _par_run(again, step, batches, dev)[-1]["bits"]
        del again
        pm.init_rank(0, 1, "nccl", dev, f"tcp://127.0.0.1:{pm.free_port()}")
        try:
            mesh = pm.make_mesh(1)
            pm.replicate_state(start, mesh)
            one = _par_run(start, pm.build_parallel_train_step(step, mesh), batches, dev,
                           shard=lambda b: pm.shard_batch(b, mesh))
        finally:
            pm.shutdown()
        del start
    warned = sorted({str(w.message)[:160] for w in caught if "determinis" in str(w.message)})
    # the yardstick of leg (b): the plain step with torch's default algorithms
    loose_steps = _par_run(loose, step, batches, dev)
    del loose
    plain_bits, one_bits = plain[-1]["bits"], one[-1]["bits"]
    run_to_run = [k for k in plain_bits if not torch.equal(plain_bits[k], again_bits[k])]
    differ = [k for k in plain_bits if not torch.equal(plain_bits[k], one_bits[k])]
    metrics_equal = all(torch.equal(p["metrics"][k], o["metrics"][k])
                        for p, o in zip(plain, one) for k in p["metrics"])
    log(f"[parallel a] {smi}: plain step launches {_launch_row(plain)}, NCCL one-rank "
        f"step launches {_launch_row(one)}; all-reduce calls a step "
        f"{[o['all_reduce_calls'] for o in one]}; determinism warnings {warned}")
    log(f"[parallel a] entries whose bits differ: NCCL one-rank vs plain {len(differ)} of "
        f"{len(plain_bits)} {differ[:8]}, plain vs plain again {len(run_to_run)} "
        f"{run_to_run[:8]}; metrics equal {metrics_equal}")
    check(not run_to_run, "the plain step repeats its bits under deterministic algorithms")
    for i, (p, o) in enumerate(zip(plain, one)):
        log(f"[parallel a] step {i + 1}: plain " + ", ".join(
            f"{k} {float(v):.6f}" for k, v in p["metrics"].items())
            + f"; step ms {p['step_ms']:.3f} plain, {o['step_ms']:.3f} NCCL one-rank "
            f"({o['collective_ms']:.3f} ms in all-reduces) by CUDA events, deterministic "
            "algorithms")
    check(_launch_row(plain) == _launch_row(one), "NCCL one-rank launches equal the plain step's")
    check(all(row[k] == w for row in _launch_row(plain) for k, w in (
        ("mixer_block", 27), ("mlp_block", 27), ("mixer_block_bwd", 27), ("mlp_block_bwd", 27),
        ("seg_loss_sums", 1), ("seg_loss_dlogits", 1), ("simota_assign", 1))),
        f"the fused step's launches {_launch_row(plain)}")
    check(not differ and metrics_equal, "NCCL one-rank step gives the plain step's bits")
    summary = {"launches": _launch_row(one), "bits_equal": True,
               "run_to_run_differ": len(run_to_run),
               "step_ms": [o["step_ms"] for o in one],
               "plain_step_ms": [p["step_ms"] for p in plain],
               "plain_default_algorithms_step_ms": [p["step_ms"] for p in loose_steps],
               "collective_ms": [o["collective_ms"] for o in one],
               "all_reduce_calls": [o["all_reduce_calls"] for o in one]}
    return summary, plain, before, loose_steps


def _rel_norm(got: dict, want: dict, before: dict, keys) -> float:
    """|(got - before) - (want - before)| / |want - before| over `keys`."""
    import torch

    d_want = torch.cat([(want[k] - before[k]).flatten() for k in keys])
    d_got = torch.cat([(got[k] - before[k]).flatten() for k in keys])
    return ((d_got - d_want).norm() / d_want.norm()).item()


def _parallel_two_ranks(dev, smi, plain, before, loose):
    """Leg (b): two gloo ranks sharing cuda:0 against the plain step, both
    under torch's deterministic algorithms.  bf16 (the CLI's, against (a)'s
    plain run): metrics within 1e-2, the update after steps 1 and 2 within
    PAR_BF16_UPDATE_LIMITS of the plain update's norm, printed beside what
    bf16's rounding alone moves it by: the plain step on the rows in
    reversed order and on the batch tiled twice (`_par_witnesses`), and
    the plain step under torch's default algorithms (`loose`).  f32 (2
    more steps a rank, in the same processes): metrics within 1e-4 (num_fg
    equal), the update after each step within 5e-3 and the BN running
    stats' within 1e-4: there bf16's rounding, which differs with the
    batch size a per-sample reduction sees, cannot hide a fault (local BN
    moments, a local normaliser or an unsummed gradient move them by
    percents)."""
    import torch
    import torch.multiprocessing

    from asy_vrnet_tpu_torch.parallel import mesh as pm
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    witnesses = _par_witnesses(dev)
    cfg32, state32, batches = _par_setup(dev, "float32")
    before32 = _par_bits(state32)
    with deterministic_algorithms():
        plain32 = _par_run(state32, build_train_step(cfg32), batches, dev)
    del state32
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        t0 = time.time()
        torch.multiprocessing.spawn(_parallel_rank, nprocs=2,
                                    args=(f"tcp://127.0.0.1:{pm.free_port()}", work))
        spawn_s = time.time() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"spawn_s": spawn_s}
    for dtype, want, start in (("bfloat16", plain, before), ("float32", plain32, before32)):
        for r in ranks:
            steps = r[dtype]
            log(f"[parallel b {dtype}] rank {r['rank']} (gloo, cuda:0) {smi}: gloo all-reduce "
                f"on CUDA tensors {r['ops']}; launches {_launch_row(steps)}; step ms "
                f"{[round(s['step_ms'], 3) for s in steps]}, all-reduce ms "
                f"{[round(s['collective_ms'], 3) for s in steps]} in "
                f"{[s['all_reduce_calls'] for s in steps]} calls (CUDA events, deterministic "
                "algorithms)")
            check(_launch_row(steps) == _launch_row(want),
                  f"rank {r['rank']}'s launches equal the plain step's ({dtype})")
        got = ranks[0][dtype]
        worst = 0.0
        for i, (p, s) in enumerate(zip(want, got)):
            for k, v in p["metrics"].items():
                a, b = float(s["metrics"][k]), float(v)
                if k == "num_fg":
                    ok = (a == b if dtype == "float32"
                          else abs(a - b) <= max(0.01 * abs(b), 1.0))
                else:
                    worst = max(worst, rel_diff(a, b))
                    ok = rel_diff(a, b) <= (1e-4 if dtype == "float32" else 1e-2)
                side = ("" if dtype == "float32" else
                        f", plain with default algorithms {float(loose[i]['metrics'][k]):.6f}")
                log(f"[parallel b {dtype}] step {i + 1} {k}: two ranks {a:.6f}, plain "
                    f"{b:.6f}{side}")
                check(ok, f"two-rank step {i + 1} {k} ({dtype})")
            check(all(torch.equal(s["metrics"][k], ranks[1][dtype][i]["metrics"][k])
                      for k in s["metrics"]), "both ranks hold the same metrics")
        stats = [k for k in start if k.startswith("state/")
                 and k.endswith(("running_mean", "running_var"))]
        params = [k for k in start if k.startswith("state/") and k not in stats]
        upd = [_rel_norm(s["bits"], p["bits"], start, params) for p, s in zip(want, got)]
        bn = [_rel_norm(s["bits"], p["bits"], start, stats) for p, s in zip(want, got)]
        res = {"update_rel_diff": upd, "bn_update_rel_diff": bn, "metric_worst_rel": worst,
               "launches": _launch_row(got),
               "step_ms": [[s["step_ms"] for s in r[dtype]] for r in ranks],
               "collective_ms": [[s["collective_ms"] for s in r[dtype]] for r in ranks],
               "all_reduce_calls": [s["all_reduce_calls"] for s in got]}
        side = ""
        if dtype == "bfloat16":
            res["witness_update_rel_diff"] = {
                name: [_rel_norm(s["bits"], p["bits"], start, params) for p, s in zip(want, w)]
                for name, w in [*witnesses.items(), ("default algorithms", loose)]}
            side = "; the plain step " + ", ".join(
                f"{name} {[f'{v:.4e}' for v in d]}"
                for name, d in res["witness_update_rel_diff"].items())
            for name, w in witnesses.items():
                log(f"[parallel b bf16 witness] plain step, {name}: " + "; ".join(
                    f"step {i + 1} " + ", ".join(f"{k} {float(v):.6f}"
                                                 for k, v in st["metrics"].items())
                    for i, st in enumerate(w)))
        log(f"[parallel b {dtype}] |update - plain update| / |plain update| after steps "
            f"1..{PAR_STEPS}: two ranks {[f'{v:.4e}' for v in upd]} (BN running stats "
            f"{[f'{v:.4e}' for v in bn]}){side}; worst metric relative difference {worst:.4e}")
        if dtype == "bfloat16":
            check(all(u <= lim for u, lim in zip(upd, PAR_BF16_UPDATE_LIMITS)),
                  f"the two-rank bf16 update within {PAR_BF16_UPDATE_LIMITS} of the plain one's "
                  f"norm after steps 1, 2 ({upd})")
        else:
            check(max(upd) <= 5e-3 and max(bn) <= 1e-4,
                  f"the two-rank f32 update within 5e-3 of the plain one's norm ({upd}), "
                  f"the BN running stats' within 1e-4 ({bn})")
        out[dtype] = res
    log(f"[parallel b] two processes spawned and joined in {spawn_s:.1f} s")
    return out


def _parallel_cli(dev, smi):
    """Leg (c): the CLI's launcher end to end."""
    import numpy as np
    import torch

    from asy_vrnet_tpu_torch.cli import train as cli
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    cards = torch.cuda.device_count()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_cli_")
    save_dir = os.path.join(work, "logs")
    argv = ["--synthetic", "16", "--synthetic-learnable", "--input-size", "128", "--epochs", "1",
            "--batch-size", "8", "--eval-period", "1", "--save-period", "1", "--weights", R05,
            "--seg-signed-logits", "--num-devices", "2", "--save-dir", save_dir]
    old_tmp, old_devices = tempfile.tempdir, cli.rank_devices
    if cards >= 2:
        leg = "NCCL on cuda:0, cuda:1"
    else:
        # the CLI gives ranks that share a card gloo (NCCL refuses them)
        cli.rank_devices = lambda args: ["cuda:0", "cuda:0"]
        leg = "gloo with both ranks on cuda:0"
        log(f"[parallel c] the NCCL two-card leg did not run: {cards} card visible; the CLI's "
            "launcher runs two gloo ranks on cuda:0 instead")
    tempfile.tempdir = work                       # the CLI's synthetic set
    try:
        t0 = time.time()
        check(cli.main(argv) is None, "the CLI's launcher returns no state")
        cli_s = time.time() - t0

        def lines(name):
            with open(os.path.join(save_dir, name)) as f:
                return [float(v) for v in f.read().split()]

        losses = lines(os.path.join("loss", "epoch_det_seg.txt"))
        ap, miou = lines("epoch_map.txt"), lines("epoch_miou.txt")
        check(len(losses) == len(ap) == len(miou) == 1 and np.isfinite(losses[0]),
              f"one epoch's loss and metrics, from rank 0 alone: {losses} {ap} {miou}")
        ck = torch.load(os.path.join(save_dir, "ckpt", "step_1.pt"), map_location="cpu",
                        weights_only=True)
        check(ck["step"] == 2, f"the checkpoint's step {ck['step']} (16 images, batch 8)")
        args = cli.build_argparser().parse_args(argv)
        create_model(cli.resolve_config(args)[0].model, dev,
                     weights=os.path.join(save_dir, "last_epoch_weights.npz"))
    finally:
        tempfile.tempdir, cli.rank_devices = old_tmp, old_devices
        shutil.rmtree(work, ignore_errors=True)
    log(f"[parallel c] the CLI's launcher, {leg}, {smi}: 1 epoch of 16 images at 128^2 in "
        f"{cli_s:.1f} s (host clock, spawn included); loss {losses[0]:.4f}, AP50 {ap[0]:.4f}, "
        f"mIoU {miou[0]:.4f}")
    return {"leg": leg, "seconds": cli_s, "loss": losses[0], "ap50": ap[0], "miou": miou[0],
            "nccl_two_cards": cards >= 2}

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
    from asy_vrnet_tpu_torch import config as tconfig
    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.data.preprocess import maybe_normalize_image_device
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.infer.predictor import Detector
    from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.models.layers import set_generator
    from asy_vrnet_tpu_torch.ops import block, kernels, simota_fused
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as segf
    from asy_vrnet_tpu_torch.ops import mixer_ablate as ma
    from asy_vrnet_tpu_torch.ops.boxes import decode_for_loss
    from asy_vrnet_tpu_torch.train.optim import adaptive_lr, set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state, float_state
    from asy_vrnet_tpu_torch.tools import ablate_mixer_fwd as ablate_tool
    from asy_vrnet_tpu_torch.train.train_step import build_train_step
    from asy_vrnet_tpu_torch.utils.profiling import cuda_ms, profile_calls

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
            again = block.mixer_block(x, st, *mw, return_assign=True, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip((out, mom, asg), again)),
                  f"K2 bits {name} {dt}")
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
            check(torch.equal(y, block.mlp_block(x, st, *lw)), f"K1 bits {name} {dt}")
            yref = block.mlp_block_plain(x, st, *lw)
            dmax = (y.float() - yref.float()).abs().max().item()
            scale = yref.float().abs().max().item()
            log(f"[check mlp_block {name} {str(dt)[6:]}] max|diff| {dmax:.4e} max|out| {scale:.4e}; "
                f"two runs of K2 and of K1 give equal bits")
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
    reset_launches(block, cf)
    for k in block.PATHS:
        block.PATHS[k] = 0
    with torch.no_grad():
        det, seg = model(img, rad)
    torch.cuda.synchronize()
    launches = dict(block.LAUNCHES)
    paths = dict(block.PATHS)
    for hk in hooks:
        hk.remove()
    log(f"[main path] launches {launches}, {cf.LAUNCHES}")
    check(launches == {**dict.fromkeys(block.LAUNCHES, 0), "mixer_block": 27, "mlp_block": 27}
          and not any(cf.LAUNCHES.values()), launches)
    want = {(b, c, h, w, heads, d, fold) for (_, b, h, w, c, heads, d, fold, _, _) in SHAPES}
    check({s + (hd, dd, f) for s, hd, dd, f in seen} == want, seen)
    # every main-path shape: K2's feat on tensor cores, K1 on tensor cores
    # with its tokens per CTA chosen from the shape's token count
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want_paths = dict.fromkeys(block.PATHS, 0)
    want_paths["mixer_block/tc"] = 27
    for (_, b, h, w, *_rest, calls) in SHAPES:
        want_paths[f"mlp_block/mma{kernels.mlp_tokens_per_cta(b * h * w, sms)}"] += calls
    log(f"[main path] kernel paths {paths}")
    check(paths == want_paths, f"main-path kernel paths {paths}, expected {want_paths}")
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
    check(block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "mixer_block": 108,
                             "mlp_block": 108}, dict(block.LAUNCHES))
    check(found >= 0.5 * total, f"recall {found}/{total}")

    # ---- 5. timing ----
    # kernel ms: CUDA events around 20 launches, as every kernel's; beside it
    # `device_ms`, the device time of those launches in a profiler trace (at
    # batch 8 a launch can take less time on the card than its wrapper on the
    # host, and the events then time the host).  With the launch geometry:
    # CTAs, CTAs per SM (the occupancy API), shared memory, registers and the
    # path taken.
    report = []
    for kname in KERNELS:
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "flops_ms": 0.0, "bytes_ms": 0.0}
        for (name, b, h, w, c, heads, d, fold, hid, calls) in SHAPES:
            x, st, mw, lw, kw = inputs[name]
            if kname == "mixer_block":
                fk = lambda: block.mixer_block(x, st, *mw, **kw)          # noqa: E731
                fp = lambda: block.mixer_block_plain(x, st, *mw, **kw)    # noqa: E731
                flops, byts = mixer_bounds(b, h, w, c, heads, d, fold)
                groups = kernels.mixer_groups(x, heads * d, heads, fold, fold, 2, 2)
                geo = {"ctas": b * fold * fold * groups, "groups": groups,
                       "path": "tc" if kernels.mixer_feat_on_tensor_cores(c, d, x.dtype)
                       else "fma",
                       **kernels.mixer_block_info(x.dtype, c, heads * d, heads,
                                                  (h // fold, w // fold), 2, 2, groups, dev)}
            else:
                fk = lambda: block.mlp_block(x, st, *lw)                  # noqa: E731
                fp = lambda: block.mlp_block_plain(x, st, *lw)            # noqa: E731
                flops, byts = mlp_bounds(b, h, w, c, hid)
                tokens = kernels.mlp_tokens(x, lw[0], lw[2])
                geo = {"ctas": -(-b * h * w // tokens), "tokens_per_cta": tokens,
                       "path": f"mma{tokens}", **kernels.mlp_block_info(c, tokens, dev)}
            dms, tries = device_ms(fk, KERNEL_NAMES[kname], 20)
            ms, pms = cuda_ms(fk, 20), cuda_ms(fp, 5, warmup=1)
            bms, by = bound_ms(flops, byts)
            log(f"[time {kname} {name}] kernel {ms:.4f} ms (device {dms:.4f} in a trace, "
                f"traces taken {tries}), plain {pms:.4f} ms, bound {bms:.5f} ms ({by}), "
                f"x{calls} per forward")
            log(f"[geometry {kname} {name}] " + ", ".join(f"{k} {v}" for k, v in geo.items()))
            stats_out[kname]["per_shape"].append(
                {"shape": name, "ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bms,
                 "bound_by": by, "calls_per_forward": calls, **geo})
            tot["ms"] += calls * ms
            tot["device_ms"] += calls * dms
            tot["plain_ms"] += calls * pms
            tot["bound_ms"] += calls * bms
            tot["flops_ms"] += calls * flops / PEAK_FLOPS * 1e3
            tot["bytes_ms"] += calls * byts / PEAK_BYTES * 1e3
        log(f"[time {kname}] per batch-8 forward: {tot['ms']:.4f} ms (device "
            f"{tot['device_ms']:.4f} in a trace), bound {tot['bound_ms']:.4f} ms")
        report.append({
            "name": kname, "route": "cuda", **KERNELS[kname],
            "launches": launches[kname],
            "max_abs_err": stats_out[kname]["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["flops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": None, "device_ms": tot["device_ms"],
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


    # ---- 6. kernels, training: seg loss (sums, dlogits) and SimOTA ----
    train_stats = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS}
    train_stats.update(check_seg_loss(dev))

    # SimOTA on the r05 head's outputs for seeded images, plus seeded noise
    rng6 = np.random.default_rng(6)
    probe = make_batch(rng6, TRAIN_BATCH, (512, 512), max_boxes=MAX_BOXES)
    with torch.no_grad():
        det16, _ = model(torch.from_numpy(probe["image"]).to(dev),
                         torch.from_numpy(probe["radar"]).to(dev))
        outs, grids, svec = decode_for_loss(det16, (8, 16, 32))
    outs = outs.float()
    noise = torch.from_numpy(rng6.normal(0, 0.5, outs[..., 4:].shape).astype(np.float32)).to(dev)
    pred_boxes = outs[..., :4].contiguous()
    obj_logits = (outs[..., 4] + noise[..., 0]).contiguous()
    cls_logits = (outs[..., 5:] + noise[..., 1:]).contiguous()
    gb, gc, gv = (torch.from_numpy(x).to(dev) for x in gt_rows(
        rng6, [0, 1, 7, 100] * 4, MAX_BOXES, 512, cfg.num_classes))
    sim_args = [pred_boxes, cls_logits, obj_logits, gb, gc, gv, grids, svec]
    n_anchor = pred_boxes.shape[1]
    check(tuple(pred_boxes.shape) == (TRAIN_BATCH, 5376, 4), "A = 5376 at 512^2")
    agree, dyn_sum, valid_rows, iou_err = compare_simota(
        "r05 head, 0/1/7/100 GTs x4", simota_fused, sim_args, exact=[0, 1, 4, 5, 8, 9, 12, 13])
    tie = [t[[2, 6]].clone() for t in sim_args[:6]] + [grids, svec]  # two 7-GT images
    for i in range(2):
        tie[3][i, 2], tie[4][i, 2] = tie[3][i, 1], tie[4][i, 1]      # duplicated GT
        tie[0][i, :4096] = tie[3][i, 1]                              # duplicated anchors
        tie[1][i, :4096] = tie[1][i, 0]
        tie[2][i, :4096] = tie[2][i, 0]
    compare_simota("constructed ties", simota_fused, tie, exact=[0, 1])
    ms = cuda_ms(lambda: simota_fused.simota_assign_batched(*sim_args), 20)
    pms = cuda_ms(lambda: simota_fused.simota_assign_batched(*sim_args, use_kernel=False), 1,
                  warmup=1)
    # the same call on the loss's strided views: per kernel by trace, device
    # operations per call (the three kernels, nothing else), the geometry
    full = torch.cat([pred_boxes, obj_logits[..., None], cls_logits], -1)
    views = [full[..., :4], full[..., 5:], full[..., 4]] + sim_args[3:]
    on_views = simota_fused.simota_assign_batched(*views)
    on_copies = simota_fused.simota_assign_batched(*sim_args)
    check(all(torch.equal(a, b) for a, b in zip(on_views, on_copies)),
          "K3 on the loss's views gives the bits it gives on contiguous copies")
    trace, ops = trace_table(lambda: simota_fused.simota_assign_batched(*views), 20)
    per_call = {k: next(((ms_, n) for nm, (ms_, n) in trace.items() if k in nm), (0.0, 0.0))
                for k in ("simota_prep_kernel", "simota_rows_kernel", "simota_resolve_kernel")}
    calls = per_call["simota_rows_kernel"][1]
    check(calls > 0 and ops / calls <= 3, f"K3's wrapper runs its three kernels only: {trace}")
    k3_device = {k.split("_")[1]: ms_ / calls for k, (ms_, _) in per_call.items()}
    vms = cuda_ms(lambda: simota_fused.simota_assign_batched(*views), 20)
    log(f"[geometry simota_assign] prep and resolve {-(-n_anchor // 256)}x{TRAIN_BATCH} "
        f"blocks, rows {TRAIN_BATCH}x{MAX_BOXES} blocks, 256 threads, candidate lists of "
        f"{simota_fused.list_length(10)} (k 10)")
    log(f"[time simota_assign views] device ms by trace: prep {k3_device['prep']:.4f}, rows "
        f"{k3_device['rows']:.4f}, resolve {k3_device['resolve']:.4f}; "
        f"{ops / calls:.1f} device operations a call; events {vms:.4f} ms")
    bms, by = bound_ms(*simota_bounds(TRAIN_BATCH, n_anchor, MAX_BOXES, cfg.num_classes, 10,
                                      valid_rows, dyn_sum), peak=PEAK_FLOPS_F32)
    log(f"[time simota_assign B=16 A={n_anchor} G={MAX_BOXES}, {valid_rows} valid rows, "
        f"dynamic-k sum {dyn_sum}] kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bms:.5f} ms ({by})")
    train_stats["simota_assign"].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                        max_abs_err=iou_err, fg_agreement=agree,
                                        device_ms=sum(k3_device.values()),
                                        device_ms_by_kernel=k3_device,
                                        device_ops_per_call=ops / calls, views_ms=vms)
    del sim_args, tie, outs, det16, full, views

    # ---- 7. block backward kernels vs twins at the train batch ----
    bwd_stats = {k: {"max_abs_err": 0.0, "per_shape": []} for k in BWD_KERNELS}
    bwd_inputs = {}
    pack_agreement = []
    g = torch.Generator().manual_seed(7)

    for (name, _, h, w, c, heads, d, fold, hid, _) in SHAPES:
        b, inner = TRAIN_BATCH, heads * d
        mixer_w = (rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(c, inner, scale=c ** -0.5), rn(inner, scale=0.1),
                   rn(inner, c, scale=inner ** -0.5), rn(c, scale=0.1),
                   torch.tensor([1.5, 0.2]))
        mlp_w = (rn(c, hid, scale=c ** -0.5), rn(hid, scale=0.1),
                 rn(hid, c, scale=hid ** -0.5), rn(c, scale=0.1))
        x32, g32 = rn(b, h, w, c), rn(b, h, w, c, scale=0.5)
        kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{name} {str(dt)[6:]}"
            x, gy = x32.to(dev, dt), g32.to(dev, dt)
            st = block.gn1_stats(x)
            mw, lw = cast(mixer_w, dt), cast(mlp_w, dt)
            _, _, pack = block.mixer_block(x, st, *mw, return_residuals=True, **kw)
            again = block.mixer_block(x, st, *mw, return_residuals=True, **kw)[2]
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(pack, again)), f"pack bits {tag}")
            _, _, rpack = block.mixer_block_plain(x, st, *mw, return_residuals=True, **kw)
            same = pack[1] == rpack[1]
            agree = same.float().mean().item()
            errs = [(pack[i].float() - rpack[i].float()).abs() for i in (0, 2, 3)]
            scales = [rpack[i].float().abs().max().item() for i in (0, 2, 3)]
            log(f"[check residual pack {tag}] assignment agreement {agree:.6f}, max|diff| "
                f"cbest {errs[0].max().item():.3e} c_rep {errs[1].max().item():.3e} "
                f"oc {errs[2].max().item():.3e} (max|ref| {scales[0]:.3f} {scales[1]:.3f} "
                f"{scales[2]:.3f})")
            if dt == torch.float32:
                check(agree == 1.0, f"pack assignment {tag}")
                for e, sc in zip(errs, scales):
                    check(e.max().item() <= 1e-4 * max(1.0, sc), f"pack {tag}")
            else:
                pack_agreement.append(agree)
                check(agree >= 0.99, f"pack assignment {tag}")
                check((errs[0] * same).max().item() <= 0.02 * scales[0], f"pack cbest {tag}")
                check(errs[1].max().item() <= 0.02 * scales[1], f"pack c_rep {tag}")
                check(errs[2].mean().item() <= 0.02 * scales[2], f"pack oc {tag}")
            wf, bf, wv, bv, w2, _, ab = mw
            margs = (x, gy, st, wf, bf, wv, bv, w2, ab, pack)
            path = f"mixer_block_bwd/{'tc' if dt == torch.bfloat16 else 'fma'}"
            on_path = block.PATHS[path]
            got = block.mixer_block_bwd(*margs, **kw)
            again = block.mixer_block_bwd(*margs, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(got, again)), f"K6 bits {tag}")
            check(block.PATHS[path] == on_path + 2, f"K6 products' path {tag}")
            want = block.mixer_block_bwd_plain(*margs, **kw)
            names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
            merr = [close_bwd("mixer_block_bwd", n, a, r, dt, want[0])
                    for n, a, r in zip(names, got, want)]
            w1, b1, w2m, _ = lw
            largs = (x, gy, st, w1, b1, w2m)
            lpath = f"mlp_block_bwd/{'cluster' if dt == torch.bfloat16 else 'fma'}"
            on_path = block.PATHS[lpath]
            got = block.mlp_block_bwd(*largs)
            again = block.mlp_block_bwd(*largs)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(got, again)), f"K5 bits {tag}")
            check(block.PATHS[lpath] == on_path + 2, f"K5 path {tag}")
            want = block.mlp_block_bwd_plain(*largs)
            names = ("dxn", "dw1", "db1", "dw2", "db2", "sums")
            lerr = [close_bwd("mlp_block_bwd", n, a, r, dt, want[0])
                    for n, a, r in zip(names, got, want)]
            log(f"[check mixer_block_bwd {tag}] max|diff| dxn {merr[0]:.3e} dwf {merr[1]:.3e} "
                f"dwv {merr[3]:.3e} dw2 {merr[5]:.3e} dalpha/beta {merr[7]:.3e}; "
                f"[check mlp_block_bwd {tag}] dxn {lerr[0]:.3e} dw1 {lerr[1]:.3e} "
                f"dw2 {lerr[3]:.3e}")
            if dt == torch.bfloat16:
                for kname, e in (("mixer_block_bwd", merr[0]), ("mlp_block_bwd", lerr[0])):
                    bwd_stats[kname]["max_abs_err"] = max(bwd_stats[kname]["max_abs_err"], e)
                bwd_inputs[name] = (margs, largs, kw)

    for kname in BWD_KERNELS:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0}
        for (name, _, h, w, c, heads, d, fold, hid, calls) in SHAPES:
            margs, largs, kw = bwd_inputs[name]
            if kname == "mixer_block_bwd":
                fk = lambda: block.mixer_block_bwd(*margs, **kw)          # noqa: E731
                fp = lambda: block.mixer_block_bwd_plain(*margs, **kw)    # noqa: E731
                flops, byts = mixer_bwd_bounds(TRAIN_BATCH, h, w, c, heads, d, fold)
            else:
                fk = lambda: block.mlp_block_bwd(*largs)                  # noqa: E731
                fp = lambda: block.mlp_block_bwd_plain(*largs)            # noqa: E731
                flops, byts = mlp_bwd_bounds(TRAIN_BATCH, h, w, c, hid)
                log_geometry(kname, name, kernels.mlp_block_bwd_info(
                    torch.bfloat16, TRAIN_BATCH, h * w, c, hid, False, dev))
            ms, pms = cuda_ms(fk, 10), cuda_ms(fp, 2, warmup=1)
            bms, by = bound_ms(flops, byts)
            log(f"[time {kname} {name} bs={TRAIN_BATCH}] kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {bms:.5f} ms ({by}), x{calls} per step")
            bwd_stats[kname]["per_shape"].append(
                {"shape": name, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                 "bound_by": by, "calls_per_step": calls})
            tot["ms"] += calls * ms
            tot["plain_ms"] += calls * pms
            tot["bound_ms"] += calls * bms
            tot["flops_ms"] += calls * flops / PEAK_FLOPS * 1e3
            tot["bytes_ms"] += calls * byts / PEAK_BYTES * 1e3
        bwd_stats[kname].update(
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="operations" if tot["flops_ms"] >= tot["bytes_ms"] else "bytes")
    del bwd_inputs

    # ---- 7b. K6r and the z1 variants of K1 and K5 vs twins at the train batch ----
    remat_stats = check_remat_z1(dev)

    # ---- 8. the stand-alone cluster mix (K7, K7b) vs twins at the train batch ----
    cl_stats, cl_agreement = check_cluster_mix(dev)

    # ---- 9.-11. train paths: r05 weights, 512^2, batch 16, bf16 ----
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        np.random.default_rng(70 + i), TRAIN_BATCH, (512, 512), max_boxes=MAX_BOXES).items()}
        for i in range(5)]
    plain_of = [(block, "mixer_block", block.mixer_block_plain),
                (block, "mlp_block", block.mlp_block_plain),
                (block, "mixer_block_bwd", block.mixer_block_bwd_plain),
                (block, "mlp_block_bwd", block.mlp_block_bwd_plain),
                (segf, "seg_loss_sums", segf.seg_sums_plain),
                (segf, "seg_loss_dlogits", segf.seg_dlogits_plain),
                (simota_fused, "_kernel_batched", simota_fused._plain_batched),
                (cf, "cluster_mix_fwd", cf.cluster_mix_fused_plain),
                (cf, "cluster_mix_bwd", cf.cluster_mix_bwd_plain)]
    counters = (block, cf, segf, simota_fused)

    def counts(k2=0, k1=0, k6=0, k5=0, k6r=0, k1z=0, k5z=0, k7=0):
        """Expected launches per step of every block and cluster-mix kernel
        (K4 and K4b once each)."""
        return {"mixer_block": k2, "mlp_block": k1, "mixer_block_bwd": k6, "mlp_block_bwd": k5,
                "mixer_block_bwd_remat": k6r, "mlp_block_z1": k1z, "mlp_block_bwd_z1": k5z,
                "cluster_mix": k7, "cluster_mix_bwd": k7, "seg_loss_sums": 1,
                "seg_loss_dlogits": 1}

    def run_train(tag, fused, steps, want, variant="coc_small", drop_seed=None,
                  remat="none", env=None):
        """`steps` train steps from the r05 weights under `train_remat` =
        `remat` and the residual switches `env`; launch counts of the first
        (`want`, SimOTA at least once); parameters, EMA and BN stats moved;
        the same first step through the plain twins, with drop-path (if any)
        drawing from a generator seeded with `drop_seed` in both.  ->
        (state, step fn, history, launches, peak GiB, step GiB: the peak
        above what was allocated before the first step)."""
        with switches(env or {}):
            return _run_train(tag, fused, steps, want, variant, drop_seed, remat)

    def _run_train(tag, fused, steps, want, variant, drop_seed, remat):
        tcfg = Config(
            model=ModelConfig(phi="nano", variant=variant, compute_dtype="bfloat16",
                              input_size=(512, 512), seg_signed_logits=True,
                              use_pallas_cluster=fused, train_remat=remat),
            loss=LossConfig(max_boxes=MAX_BOXES, use_pallas_seg=True))
        state = create_train_state(tcfg, weights=R05)                # the card by default
        lr, _ = adaptive_lr(tcfg.optim, TRAIN_BATCH)
        set_learning_rate(state.optimizer, lr)
        step = build_train_step(tcfg)                                # the card by default
        start = copy.deepcopy(state)
        if drop_seed is not None:
            set_generator(state.model, torch.Generator(device=dev).manual_seed(drop_seed))
        before = {k: v.clone() for k, v in float_state(state.model).items()}
        ema_before = {k: v.clone() for k, v in state.ema.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches(*counters)
        for paths in (block.PATHS, cf.PATHS):
            for k in paths:
                paths[k] = 0
        state, first = step(state, batches[0])
        torch.cuda.synchronize()
        launches = {k: v for m in counters for k, v in m.LAUNCHES.items()}
        log(f"[train {tag}] launches in one step {launches}; backward paths "
            f"{ {k: v for k, v in block.PATHS.items() if '_bwd' in k} }; cluster mix paths "
            f"{cf.PATHS}")
        check({k: launches[k] for k in want} == want and launches["simota_assign"] >= 1,
              launches)
        # bf16: every K6 and K6r launch ran its products on tensor cores, every
        # K5 launch took its cluster path, every K7 and K7b launch (all at head
        # width 32 with 2x2 proposals) its fast instantiation
        for paths, key, new, old in (
                (block.PATHS, "mixer_block_bwd", "tc", "fma"),
                (block.PATHS, "mixer_block_bwd_remat", "tc", "fma"),
                (block.PATHS, "mlp_block_bwd", "cluster", "fma"),
                (block.PATHS, "mlp_block_bwd_z1", "cluster", "fma"),
                (cf.PATHS, "cluster_mix", "fast", "general"),
                (cf.PATHS, "cluster_mix_bwd", "fast", "general")):
            check(paths[f"{key}/{new}"] == launches[key] and not paths[f"{key}/{old}"],
                  f"{tag}: {key} on its {new} path in every launch")
        history = [{k: float(v) for k, v in first.items()}]
        for bt in batches[1:steps]:
            state, m = step(state, bt)
            history.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_gib = peak - held / 2 ** 30
        log(f"[train {tag}] peak memory {peak:.3f} GiB, {step_gib:.3f} GiB above the "
            f"{held / 2 ** 30:.3f} GiB held before the first step")
        for i, m in enumerate(history):
            log(f"[train {tag}] step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))
            check(all(np.isfinite(v) for v in m.values()) and m["num_fg"] > 0, f"step {i + 1}")
        after = float_state(state.model)
        moved = lambda keys, a, b: sum(not torch.equal(a[k], b[k]) for k in keys)  # noqa: E731
        names = [k for k, _ in state.model.named_parameters()]
        stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
        log(f"[train {tag}] moved: {moved(names, before, after)}/{len(names)} parameters, "
            f"{moved(stats, before, after)}/{len(stats)} BN running stats, "
            f"{moved(list(ema_before), ema_before, state.ema)}/{len(ema_before)} EMA entries; "
            f"step {state.step}, ema_updates {state.ema_updates}, lr {lr}")
        log(f"[train {tag}] parameters that kept their bits: "
            f"{[k for k in names if torch.equal(before[k], after[k])]}")
        # a few decay-free entries rightly stay: their update lr * grad is below
        # one f32 ulp of the value (norm weights and alpha behind a LayerScale of
        # ~1e-5, a conv bias in front of a batch-stat BatchNorm)
        check(moved(names, before, after) >= 0.9 * len(names), "the parameters moved")
        check(moved(stats, before, after) == len(stats), "every BN running stat moved")
        check(moved(list(ema_before), ema_before, state.ema) >= 0.9 * len(ema_before),
              "the EMA moved")
        check(state.step == steps and state.ema_updates == float(steps), "counters")
        del before, ema_before, after
        # the same first step through the plain twins, from the same start
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plain_of]
        for mod, attr, fn in plain_of:
            setattr(mod, attr, fn)
        if drop_seed is not None:
            set_generator(start.model, torch.Generator(device=dev).manual_seed(drop_seed))
        reset_launches(*counters)
        try:
            _, plain_first = step(start, batches[0])
            torch.cuda.synchronize()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        check(not any(v for m in counters for v in m.LAUNCHES.values()),
              "the plain step launched no kernel")
        for k, v in history[0].items():
            pv = float(plain_first[k])
            log(f"[train {tag} vs plain twins] {k}: {v:.6f} vs {pv:.6f}")
            ok = (abs(v - pv) <= max(0.01 * pv, 1.0) if k == "num_fg"
                  else rel_diff(v, pv) <= 0.02)
            check(ok, f"first step {k}")
        return state, step, history, launches, peak, step_gib

    fused4 = dict(k2=27, k1=27, k6=27, k5=27)
    state, train_step, history, train_launches, train_peak, train_gib = run_train(
        "fused", True, 5, counts(**fused4))
    mstate, mstep, mhistory, _, mpeak, mgib = run_train("module path", False, 2, counts())
    for k in ("loss", "loss_det", "loss_seg"):
        v, mv = history[0][k], mhistory[0][k]
        log(f"[train fused vs module path] first step {k}: {v:.6f} vs {mv:.6f}")
        check(rel_diff(v, mv) <= 0.02, f"fused vs module path {k}")

    # ---- 11. stochastic depth: coc_small with drop_path_rate 0.1 (this
    # process only); the 22 backbone blocks past stage 0's first take the
    # module path with K7/K7b, the other 5 the fused blocks ----
    tconfig.COC_VARIANTS[DROP_PATH_VARIANT] = dataclasses.replace(
        tconfig.COC_VARIANTS["coc_small"], drop_path_rate=0.1)
    dstate, dstep, dhistory, drop_launches, dpeak, dgib = run_train(
        "stochastic depth", True, 5, counts(k2=5, k1=5, k6=5, k5=5, k7=22),
        variant=DROP_PATH_VARIANT, drop_seed=11)
    reset_launches(block, cf)
    dstate.model.eval()
    with torch.no_grad():
        dstate.model(maybe_normalize_image_device(batches[0]["image"]), batches[0]["radar"])
    torch.cuda.synchronize()
    log(f"[stochastic depth eval forward] launches {block.LAUNCHES} {cf.LAUNCHES}")
    check(block.LAUNCHES["mixer_block"] == block.LAUNCHES["mlp_block"] == 27
          and not any(cf.LAUNCHES.values()), "eval forward takes the fused blocks (JAX's gate)")

    # ---- 12. the JAX package's memory settings: the lean step
    # (train_remat "blocks", ASY_MIXER_BWD_RESIDUALS=0: K6r on every block,
    # K2 again for each of the 24 recomputed backbone blocks, K1 not), the z1
    # step (ASY_MLP_BWD_RESIDUALS=1) and the "fusion" and "stages" spans.
    # The forward is the fused step's, so the first step's loss is too ----
    variants = {}
    for tag, steps, want, remat, env in (
            ("lean", 5, counts(k2=51, k1=27, k6r=27, k5=27), "blocks",
             {"ASY_MIXER_BWD_RESIDUALS": "0"}),
            ("z1", 5, counts(k2=27, k1z=27, k6=27, k5z=27), "none",
             {"ASY_MLP_BWD_RESIDUALS": "1"}),
            # "stages" recomputes each stack's mixer halves and all but its
            # last MLP half: 24 + 16 more launches of K2 and K1
            ("remat fusion", 2, counts(**fused4), "fusion", None),
            ("remat stages", 2, counts(k2=51, k1=43, k6=27, k5=27), "stages", None)):
        variants[tag] = run_train(tag, True, steps, want, remat=remat, env=env)
        first = variants[tag][2][0]
        log(f"[train {tag} vs fused] first step loss {first['loss']:.7f} vs "
            f"{history[0]['loss']:.7f}, num_fg {first['num_fg']:.0f} vs "
            f"{history[0]['num_fg']:.0f}")
        check(rel_diff(first["loss"], history[0]["loss"]) <= 1e-5
              and first["num_fg"] == history[0]["num_fg"], f"{tag} first step = fused")

    # ---- 13. overfit one fixed 128^2 batch, f32, 30 steps, fused blocks ----
    ocfg = Config(
        model=ModelConfig(phi="nano", variant="coc_small", compute_dtype="float32",
                          input_size=(128, 128), seg_signed_logits=True,
                          use_pallas_cluster=True),
        loss=LossConfig(max_boxes=16, use_pallas_seg=True))
    ostate = create_train_state(ocfg, weights=R05)
    set_learning_rate(ostate.optimizer, adaptive_lr(ocfg.optim, 4)[0])
    ostep = build_train_step(ocfg)
    obatch = make_batch(np.random.default_rng(8), 4, (128, 128))
    olosses = []
    before = dict(block.LAUNCHES)
    for _ in range(30):
        ostate, m = ostep(ostate, obatch)
        olosses.append(float(m["loss"]))
    log(f"[overfit 128^2 f32, fused blocks, 30 steps] loss {olosses[0]:.4f} -> "
        f"{olosses[-1]:.4f} (min {min(olosses):.4f}); block launches "
        f"{ {k: block.LAUNCHES[k] - before[k] for k in before} }")
    check(block.LAUNCHES["mixer_block_bwd"] > before["mixer_block_bwd"], "overfit ran K6")
    check(block.PATHS["mixer_block_bwd/fma"] >= block.LAUNCHES["mixer_block_bwd"]
          - before["mixer_block_bwd"], "f32 K6 on the CUDA cores")
    check(all(np.isfinite(olosses)) and olosses[-1] < olosses[0], "overfit loss falls")
    del ostate

    # step time, images/s, device-busy share, launches per step
    def time_step(tag, st, fn, peak, hist, step_gib=None, env=None):
        def one_step():
            fn(st, batches[0])

        with switches(env or {}):
            one_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                one_step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / 5
            tp = profile_calls(one_step, reps=2)
        log(f"[train step {tag} bs={TRAIN_BATCH}] {step_ms:.2f} ms, "
            f"{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory {peak:.3f} GiB; "
            f"profiled: wall {tp['wall_ms']:.2f} ms, device busy {tp['device_ms']:.2f} ms "
            f"({tp['busy_share']:.3f}), {tp['launches']} kernel launches")
        for name, v, n in tp["top"]:
            log(f"[train step {tag} top] {v:.4f} ms x{n} {name}")
        return {"batch": TRAIN_BATCH, "step_ms": step_ms,
                "images_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_gib": peak,
                "step_gib": step_gib, "profile": tp, "history": hist}

    train = time_step("fused", state, train_step, train_peak, history, train_gib)
    train["overfit"] = [olosses[0], olosses[-1]]
    train_module = time_step("module path", mstate, mstep, mpeak, mhistory)
    log("[train step] fused vs module path: " + ", ".join(
        f"{k} {train[k]:.3f} vs {train_module[k]:.3f}"
        for k in ("step_ms", "images_per_s", "peak_gib")) +
        f", device busy ms {train['profile']['device_ms']:.3f} vs "
        f"{train_module['profile']['device_ms']:.3f}, busy share "
        f"{train['profile']['busy_share']:.3f} vs {train_module['profile']['busy_share']:.3f}, "
        f"launches {train['profile']['launches']} vs {train_module['profile']['launches']}")
    train_drop = time_step("stochastic depth", dstate, dstep, dpeak, dhistory)
    log("[train step] stochastic depth vs fused: " + ", ".join(
        f"{k} {train_drop[k]:.3f} vs {train[k]:.3f}"
        for k in ("step_ms", "images_per_s", "peak_gib")) +
        f", device busy ms {train_drop['profile']['device_ms']:.3f} vs "
        f"{train['profile']['device_ms']:.3f}, busy share "
        f"{train_drop['profile']['busy_share']:.3f} vs {train['profile']['busy_share']:.3f}, "
        f"launches {train_drop['profile']['launches']} vs {train['profile']['launches']}")
    for cat in train["profile"]["by_category_ms"]:
        log(f"[train step device ms] {cat}: fused {train['profile']['by_category_ms'][cat]:.4f}, "
            f"module path {train_module['profile']['by_category_ms'][cat]:.4f}, stochastic "
            f"depth {train_drop['profile']['by_category_ms'][cat]:.4f}")
    # the memory settings beside the fused step (the same call and card)
    table = {"fused": train}
    for (tag, env), (vs, vstep, vhist, _, vpeak, vgib) in zip(
            (("lean", {"ASY_MIXER_BWD_RESIDUALS": "0"}), ("z1", {"ASY_MLP_BWD_RESIDUALS": "1"}),
             ("remat fusion", None), ("remat stages", None)), variants.values()):
        table[tag] = time_step(tag, vs, vstep, vpeak, vhist, vgib, env)
    log("[train memory settings] step ms | images/s | launches | device busy ms | busy "
        "share | peak GiB | GiB above the state")
    for tag, t in table.items():
        log(f"[train memory settings] {tag}: {t['step_ms']:.2f} | {t['images_per_s']:.1f} | "
            f"{t['profile']['launches']} | {t['profile']['device_ms']:.2f} | "
            f"{t['profile']['busy_share']:.3f} | {t['peak_gib']:.3f} | {t['step_gib']:.3f}")
    for cat in train["profile"]["by_category_ms"]:
        log(f"[train memory settings device ms] {cat}: " + ", ".join(
            f"{tag} {t['profile']['by_category_ms'][cat]:.4f}" for tag, t in table.items()))
    remat_launches = {**variants["lean"][3], **{k: variants["z1"][3][k] for k in
                                               ("mlp_block_z1", "mlp_block_bwd_z1")}}
    for kname in REMAT_KERNELS:
        st = remat_stats[kname]
        report.append({"name": kname, "route": "cuda", **REMAT_KERNELS[kname],
                       "launches": remat_launches[kname], "max_abs_err": st["max_abs_err"],
                       "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                       "bound_by": st["bound_by"], "library_ms": None,
                       "per_shape": st["per_shape"]})
    for kname in BWD_KERNELS:
        st = bwd_stats[kname]
        report.append({"name": kname, "route": "cuda", **BWD_KERNELS[kname],
                       "launches": train_launches[kname], "max_abs_err": st["max_abs_err"],
                       "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                       "bound_by": st["bound_by"], "library_ms": None,
                       "per_shape": st["per_shape"]})
    # K6 and K6r run K2's feat and pooling device code (mixer_block.cuh); K5
    # is K1's backward: their times per step beside the redesigned forward
    log(f"[redesign] per batch-16 step (CUDA events x calls): K6 "
        f"{bwd_stats['mixer_block_bwd']['ms']:.4f} ms, K6r "
        f"{remat_stats['mixer_block_bwd_remat']['ms']:.4f} ms, K5 "
        f"{bwd_stats['mlp_block_bwd']['ms']:.4f} ms")
    for kname in TRAIN_KERNELS:
        st = train_stats[kname]
        extra = {k: v for k, v in st.items() if k.startswith(("device_", "views_"))}
        report.append({"name": kname, "route": "cuda", **TRAIN_KERNELS[kname],
                       "launches": train_launches[kname], "max_abs_err": st["max_abs_err"],
                       "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                       "bound_by": st["bound_by"], "library_ms": None, **extra})
    for kname in CLUSTER_KERNELS:
        st = cl_stats[kname]
        report.append({"name": kname, "route": "cuda", **CLUSTER_KERNELS[kname],
                       "launches": drop_launches[kname], "max_abs_err": st["max_abs_err"],
                       "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                       "bound_by": st["bound_by"], "library_ms": None,
                       "device_ms": st["device_ms"], "per_shape": st["per_shape"]})

    # ---- 14. K2f-ablate: K2's prefixes against their twins, their times, the
    # attribution of K2's time; then the profiling tool's own path ----
    check(ma.LAUNCHES["mixer_block_ablate"] == 0, "no serving or train path ran a prefix")
    ab_stats, attribution = check_ablation(dev)
    reset_launches(ma)
    tool_res = ablate_tool.run(ablate_tool.parse_args([]))
    torch.cuda.synchronize()
    tool_launches = ma.LAUNCHES["mixer_block_ablate"]
    log(f"[ablate tool] launches {tool_launches}; trace ms per prefix " + ", ".join(
        f"{r['variant']} {r['stop']} {r['ms_trace']:.4f}" for r in tool_res["rows"]))
    check(tool_launches > 0 and all(r["ms_trace"] > 0 for r in tool_res["rows"]),
          "the tool launched every prefix and its trace timed each")
    tool_geo = tool_res["geometry"]
    bounds = [ablate_tool.prefix_bounds(r["stop"], r["variant"] == "nf", tool_geo)
              for r in tool_res["rows"]]
    report.append({
        "name": "mixer_block_ablate", "route": "cuda", **ABLATE_KERNEL,
        "launches": tool_launches, "launches_serving_and_train": 0,
        "max_abs_err": ab_stats["max_abs_err"],
        "max_rel_checksum_err_bf16": ab_stats["max_rel_checksum_err_bf16"],
        "ms": sum(r["ms_trace"] for r in tool_res["rows"]),
        "plain_ms": sum(e["plain_ms"] for e in ab_stats["per_shape"]
                        if e["shape"] == "tool stage0 bs64"),
        "bound_ms": sum(r["bound_ms"] for r in tool_res["rows"]),
        "bound_by": ("operations" if sum(f for f, _ in bounds) / PEAK_FLOPS
                     >= sum(b for _, b in bounds) / PEAK_BYTES else "bytes"),
        "library_ms": None, "tool": tool_res, "attribution": attribution,
        "numerics_bf16": ab_stats["numerics"], "per_shape": ab_stats["per_shape"]})

    # ---- 15. the training CLI (cli/train.py) on r05's recipe ----
    cli_stats = check_train_cli(dev)
    for entry in report:
        entry["launches_train_cli"] = cli_stats["launches"].get(entry["name"], 0)
    check(all(cli_stats["launches"][k] > 0 for k in CLI_KERNELS), "the CLI ran its kernels")

    # ---- 16. inference and offline evaluation on r05's weights ----
    infer_stats = check_inference(dev, cli_stats["pre_training"])
    for entry in report:
        entry["launches_inference"] = sum(
            e[entry["name"]] for e in infer_stats["entry_points"].values()
            if entry["name"] in e)

    # ---- 17. data-parallel training: NCCL one rank, two gloo ranks, the CLI ----
    par_stats = check_parallel(dev)
    for entry in report:
        entry["launches_parallel_step"] = par_stats["one_rank_nccl"]["launches"][0].get(
            entry["name"], 0)
        entry["launches_parallel_step_per_rank"] = par_stats["two_rank_gloo"]["bfloat16"][
            "launches"][0].get(entry["name"], 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[total] {time.time() - t_start:.1f} s")
    print(json.dumps({"forward": fwd, "train": train, "train_module_path": train_module,
                      "train_stochastic_depth": train_drop,
                      "train_memory_settings": {k: v for k, v in table.items() if k != "fused"},
                      "remat_vs_k6_bf16": remat_stats["mixer_block_bwd_remat"]["vs_k6_bf16"],
                      "cluster_mix_assignment_agreement_bf16": cl_agreement,
                      "mixer_assignment_agreement_bf16": stats_out["mixer_block"].get("agreement"),
                      "pack_assignment_agreement_bf16": pack_agreement,
                      "simota_fg_agreement": train_stats["simota_assign"]["fg_agreement"],
                      "train_cli": cli_stats, "inference": infer_stats,
                      "parallel": par_stats}),
          flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
