"""Launch geometry of the block kernels, as pure functions of the shape (no
card needed): K1's tokens per CTA (`ops/kernels.py::mlp_tokens_per_cta`,
the SM count passed in) and its tensor-core predicate, K2's feat path
(tensor cores or CUDA cores) by C, head width and dtype, the mixer
backward's (K6, K6r) head groups before the shared-memory fit, products'
path and epilogue tiles, the MLP backward's (K5) clusters, hidden split and
token tiles (from its geometry header, built here by the host compiler),
the stand-alone cluster mix's (K7, K7b) path and lane mapping, and the
seg-loss kernels' (K4, K4b) ring depth, grid and tile dealing, with a model
of K4's fixed-order reduction.
"""
import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from asy_vrnet_tpu_torch.ops import block, kernels, simota_fused

H100_SMS = 132
# the ClusterBlocks of nano coc_small at 512^2: (name, H*W per sample, C,
# heads, head_dim, hid)
MAIN_PATH = [("stage0", 128 * 128, 16, 4, 32, 128), ("stage1", 64 * 64, 32, 4, 32, 256),
             ("stage2", 32 * 32, 80, 8, 32, 320), ("stage3", 16 * 16, 128, 8, 32, 512),
             ("p5", 16 * 16, 128, 4, 24, 512), ("p4", 32 * 32, 160, 4, 24, 640),
             ("p3", 64 * 64, 64, 4, 24, 256)]


@pytest.mark.parametrize("ntok", [1, 15, 16, 17, 256, 2047, 2048, 2049, 8192, 131072,
                                  10 ** 7])
@pytest.mark.parametrize("sms", [1, 66, 132])
def test_mlp_tokens_per_cta_is_a_warp_multiple_between_16_and_64(ntok, sms):
    t = kernels.mlp_tokens_per_cta(ntok, sms)
    assert t in (16, 32, 64)
    assert f"mlp_block/mma{t}" in block.PATHS
    # the widest choice that still gives every SM a CTA, else the narrowest
    wider = [w for w in kernels.MLP_TOKENS if w > t]
    assert all(-(-ntok // w) < sms for w in wider)
    if t > 16:
        assert -(-ntok // t) >= sms


def test_mlp_grid_covers_the_card_at_2048_tokens():
    t = kernels.mlp_tokens_per_cta(2048, H100_SMS)
    assert t == 16 and -(-2048 // t) == 128      # was 64 tokens: 32 CTAs
    # a batch-8 stage-0 plane keeps the widest CTAs
    assert kernels.mlp_tokens_per_cta(8 * 128 * 128, H100_SMS) == 64


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_main_path_shapes_take_the_tensor_cores(batch):
    for name, hw, c, heads, d, hid in MAIN_PATH:
        assert kernels.mixer_feat_on_tensor_cores(c, d, torch.bfloat16), name
        assert kernels.mlp_mma_shape(c, hid, torch.bfloat16), name
        t = kernels.mlp_tokens_per_cta(batch * hw, H100_SMS)
        # as many CTAs as the tokens allow, up to one per SM at least
        assert -(-batch * hw // t) >= min(H100_SMS, -(-batch * hw // 16)), (name, t)


@pytest.mark.parametrize("c, d, dtype, tc", [
    (16, 32, torch.bfloat16, True), (160, 24, torch.bfloat16, True),
    (24, 32, torch.bfloat16, False),     # tiny_stage0: C not a multiple of 16
    (32, 12, torch.bfloat16, False),     # a head width that is not whole n-tiles
    (16, 32, torch.float32, False),      # f32 keeps the CUDA-core path
])
def test_mixer_feat_path(c, d, dtype, tc):
    assert kernels.mixer_feat_on_tensor_cores(c, d, dtype) is tc
    assert ("mixer_block/tc" if tc else "mixer_block/fma") in block.PATHS


@pytest.mark.parametrize("c, hid, dtype, mma", [
    (16, 128, torch.bfloat16, True), (160, 640, torch.bfloat16, True),
    (176, 640, torch.bfloat16, True),    # past the accumulators' 160: the wide kernel
    (656, 2624, torch.bfloat16, False),  # past the wide kernel's 640
    (24, 96, torch.bfloat16, False), (64, 100, torch.bfloat16, False),
    (64, 256, torch.float32, False),
])
def test_mlp_mma_shape(c, hid, dtype, mma):
    assert kernels.mlp_mma_shape(c, hid, dtype) is mma


# the ClusterBlocks of phi l (width 1.0) coc_small at 512^2: (name, H*W per
# sample, C, hid); K1 runs C 256-640 on its wide tensor-core kernel
L_PATH = [("stage0", 128 * 128, 64, 512), ("stage1", 64 * 64, 128, 1024),
          ("stage2", 32 * 32, 320, 1280), ("stage3", 16 * 16, 512, 2048),
          ("p5", 16 * 16, 512, 2048), ("p4", 32 * 32, 640, 2560), ("p3", 64 * 64, 256, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name, hw, c, hid", L_PATH, ids=[s[0] for s in L_PATH])
def test_l_shapes_take_the_wide_kernel_in_bf16(name, hw, c, hid, dtype):
    """bf16: every l block on tensor cores, C > 160 on a wide kernel with
    its tokens a CTA (128 up to C = 320, else 64, whatever the token count)
    and its own PATHS key; f32 keeps the CUDA-core path."""
    mma = kernels.mlp_mma_shape(c, hid, dtype)
    assert mma is (dtype == torch.bfloat16)
    assert kernels.mlp_wide(c) is (c > 160)
    if mma and kernels.mlp_wide(c):
        tokens = kernels.mlp_wide_tokens(c)
        assert tokens == (128 if c <= 320 else 64)
        for batch in (1, 2, 256):
            assert kernels._mlp_tokens(batch * hw, c, hid, dtype, None) == tokens
        assert f"mlp_block/wide{tokens}" in block.PATHS
    if not mma:
        assert kernels._mlp_tokens(hw, c, hid, dtype, None) == 0
    assert {"mixer_block/tc_wide", "mixer_block/fma_wide"} <= set(block.PATHS)


@pytest.mark.parametrize("c", range(176, kernels.MLP_WIDE_MAX_C + 1, 16))
def test_wide_kernel_splits_fc2_channels_evenly(c):
    """The wide kernels' fc2 groups (4 up to C = 320, where a CTA's 16 warps
    take 128 tokens in 4 tiles of 32, else 8 over 2 tiles) own C / 8 n-tiles
    between them, each a contiguous run of at most the instantiated width,
    with no gap and no overlap (n_lo, cnt, Wide128 and Wide64 in
    csrc/mlp_block.cu)."""
    groups, inst = (4, (8, 10)) if c <= 320 else (8, (8, 10))
    nt = c // 8
    runs = [(g * nt // groups, (g + 1) * nt // groups) for g in range(groups)]
    assert runs[0][0] == 0 and runs[-1][1] == nt
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    width = next(k for k in inst if -(-nt // groups) <= k)
    assert max(hi - lo for lo, hi in runs) <= width


# ---------------------------------------------------------------------------
# The mixer backward (K6, K6r) at the train batch: its head groups before the
# shared-memory fit (which only the card can test), its products' path and
# its epilogue's tiles.
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16
# (region side in tokens, fold) of each main-path block; 2x2 proposals
FOLDS = {"stage0": 8, "stage1": 4, "stage2": 2, "stage3": 1, "p5": 2, "p4": 2, "p3": 2}


def test_mixer_bwd_head_groups_at_the_train_batch():
    groups = {}
    for name, hw, c, heads, d, hid in MAIN_PATH:
        regions = TRAIN_BATCH * FOLDS[name] ** 2
        g = kernels.cluster_divisor(heads, regions, H100_SMS, fill=0.5)
        assert heads % g == 0 and heads // g <= 16, name   # the kernel's item prefetch
        # half the SMs get a block, or every head has its own group
        assert regions * g >= H100_SMS / 2 or g == heads or g == 8, name
        groups[name] = g
    assert groups == {"stage0": 1, "stage1": 1, "stage2": 2, "stage3": 8, "p5": 2, "p4": 2,
                      "p3": 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mixer_bwd_products_path(dtype):
    """In bf16 every main-path shape runs K6's and K6r's products on tensor
    cores (the predicate K2's feat takes); f32 keeps the CUDA cores."""
    for name, hw, c, heads, d, hid in MAIN_PATH:
        tc = kernels.mixer_feat_on_tensor_cores(c, d, dtype)
        assert tc is (dtype == torch.bfloat16), name
        for kernel in ("mixer_block_bwd", "mixer_block_bwd_remat"):
            assert f"{kernel}/{'tc' if tc else 'fma'}" in block.PATHS


@pytest.mark.parametrize("c, tile", [(16, 128), (32, 64), (64, 32), (80, 24), (128, 16),
                                     (160, 8), (256, 8), (512, 8)])
def test_mixer_bwd_epilogue_tile(c, tile):
    """8 tokens per thread, 256 // c threads per channel."""
    assert kernels.mixer_bwd_epi_tile(c) == tile
    assert kernels.mixer_bwd_tiles(1, c) == 1
    assert kernels.mixer_bwd_tiles(tile, c) == 1 and kernels.mixer_bwd_tiles(tile + 1, c) == 2


def test_mixer_bwd_epilogue_fills_the_card_at_the_train_batch():
    """Every main-path shape gives the epilogue at least one block per SM
    (256 tokens a block left stage 3 with 16 blocks)."""
    for name, hw, c, heads, d, hid in MAIN_PATH:
        assert TRAIN_BATCH * kernels.mixer_bwd_tiles(hw, c) >= H100_SMS, name


# ---------------------------------------------------------------------------
# The MLP backward (K5): its cluster path's hidden split, token tiles and
# partial rows at the nano shapes (the SM count passed in), as the kernel's
# own geometry header (csrc/mlp_block_bwd_geometry.h, plain C++) chooses
# them: the host compiler builds it into a small library for these tests.
# ---------------------------------------------------------------------------

_K5_SHIM = r"""
#include "mlp_block_bwd_geometry.h"
using namespace k5geo;
extern "C" {
void k5_pick(int B, int HW, int C, int hid, int sms, int max_active, long long* out) {
  const Pick p = pick(B, HW, C, hid, sms, max_active);
  const long long v[] = {p.cs, p.ncl, p.T, p.tiles, p.own_max, p.acc, (long long)p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
int k5_first_slice(int r, int slices, int cs) { return first_slice(r, slices, cs); }
int k5_own_max(int slices, int cs) { return own_max(slices, cs); }
void k5_limits(long long* out) {
  const long long v[] = {kCHid, kCMaxAcc, (long long)kCMaxSmem, kCMaxCluster, kCWideC};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}
}
"""
_PICK = ("cluster", "clusters", "tile", "tiles", "own_max", "acc_tiles", "smem_bytes")


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    """The geometry header built by the host C++ compiler: pick(b, hw, c,
    hid, sms, max_active=0) -> dict, first_slice(r, slices, cs),
    own_max(slices, cs) and its limits."""
    d = tmp_path_factory.mktemp("k5geo")
    (d / "shim.cpp").write_text(_K5_SHIM)
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build csrc/mlp_block_bwd_geometry.h"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", kernels.CSRC,
                    str(d / "shim.cpp"), "-o", str(d / "libk5geo.so")], check=True)
    lib = ctypes.CDLL(str(d / "libk5geo.so"))
    lim = (ctypes.c_longlong * 5)()
    lib.k5_limits(lim)

    def pick(b, hw, c, hid, sms, max_active=0):
        out = (ctypes.c_longlong * 7)()
        lib.k5_pick(b, hw, c, hid, sms, max_active, out)
        return dict(zip(_PICK, out))

    return types.SimpleNamespace(
        pick=pick, first_slice=lib.k5_first_slice, own_max=lib.k5_own_max,
        **dict(zip(("slice", "max_acc", "max_smem", "max_cluster", "wide_c"), lim)))


def _rank_units(k5, hid, cs):
    """(first hidden unit, hidden units) of each rank, as the kernel reads them."""
    s = hid // k5.slice
    return [(k5.first_slice(r, s, cs) * k5.slice,
             (k5.first_slice(r + 1, s, cs) - k5.first_slice(r, s, cs)) * k5.slice)
            for r in range(cs)]


@pytest.mark.parametrize("batch", [1, 8, 16, 32])
def test_mlp_bwd_geometry_covers_every_unit_and_token_once(k5, batch):
    bytes_per_step = 0
    for name, hw, c, heads, d, hid in MAIN_PATH:
        g = k5.pick(batch, hw, c, hid, H100_SMS)
        cs, ncl, tiles = g["cluster"], g["clusters"], g["tiles"]
        assert 1 <= cs <= k5.max_cluster and 1 <= ncl <= tiles, name
        # whole tiles of one sample each, covering its tokens
        assert g["tile"] in (64, 128) and hw % g["tile"] == 0, name
        assert tiles * g["tile"] == batch * hw, name
        # the ranks' hidden units partition [0, hid), none larger than own_max
        units = _rank_units(k5, hid, cs)
        covered = [j for j0, own in units for j in range(j0, j0 + own)]
        assert covered == list(range(hid)), name
        assert all(0 < own <= g["own_max"] for _, own in units), name
        # registers and shared memory of a rank fit
        assert g["acc_tiles"] <= k5.max_acc, name
        assert g["smem_bytes"] <= k5.max_smem, name
        # one row of partials per cluster, at most one CTA per SM in all
        assert ncl * cs <= H100_SMS, name
        if batch == TRAIN_BATCH:
            calls = {"stage0": 4, "stage1": 4, "stage2": 12, "stage3": 4}.get(name, 1)
            bytes_per_step += calls * ncl * (2 * c * hid + hid + c + 2 * batch) * 4
    if batch == TRAIN_BATCH:
        # the parent wrote 850 MB of rows a fused step (one per 128 tokens)
        assert bytes_per_step < 160e6


def test_mlp_bwd_geometry_fills_the_card_where_the_tokens_allow(k5):
    """Stage 3 and p5 (64 tiles at batch 16) get a hidden split of 8: 128
    CTAs where the parent had 32.  Stage 2's 10 slices split evenly over a
    cluster of 5 (the largest divisor up to 8), its 80 channels take tiles
    of 128 tokens; p4's 20 slices fall back to 8 (uneven: 5 and 10 ranks
    would not fit their weight slices in shared memory)."""
    for name, hw, c, heads, d, hid in MAIN_PATH:
        g = k5.pick(TRAIN_BATCH, hw, c, hid, H100_SMS)
        assert g["clusters"] * g["cluster"] >= min(H100_SMS - 12, g["tiles"] * g["cluster"])
        assert (g["tile"] == 128) is (c <= k5.wide_c), name
    g = k5.pick(TRAIN_BATCH, 16 * 16, 128, 512, H100_SMS)
    assert (g["cluster"], g["clusters"], g["tile"]) == (8, 16, 64)
    g = k5.pick(TRAIN_BATCH, 32 * 32, 80, 320, H100_SMS)
    assert (g["cluster"], g["clusters"], g["own_max"], g["tile"]) == (5, 26, 64, 128)
    g = k5.pick(TRAIN_BATCH, 32 * 32, 160, 640, H100_SMS)
    assert (g["cluster"], g["own_max"]) == (8, 96)
    # the card holds fewer clusters at once: no second wave
    assert k5.pick(TRAIN_BATCH, 16 * 16, 128, 512, H100_SMS, max_active=15)["clusters"] == 15


@pytest.mark.parametrize("hid, cs", [(320, 8), (352, 8), (96, 2), (224, 4), (640, 8)])
def test_mlp_bwd_uneven_hidden_split(k5, hid, cs):
    """A hidden width whose slices do not divide by the cluster: ranks own
    whole slices, differing by at most one."""
    owns = [own for _, own in _rank_units(k5, hid, cs)]
    assert sum(owns) == hid and max(owns) - min(owns) <= k5.slice
    assert all(own % k5.slice == 0 for own in owns)
    assert max(owns) == k5.own_max(hid // k5.slice, cs)


@pytest.mark.parametrize("hw, c, hid, dtype, ok", [
    (16384, 16, 128, torch.bfloat16, True), (1024, 160, 640, torch.bfloat16, True),
    (1024, 176, 640, torch.bfloat16, False),   # wider than 160
    (1024, 80, 100, torch.bfloat16, False),    # hid not whole slices
    (96, 64, 256, torch.bfloat16, False),      # H*W not whole tiles of 64
    (64, 64, 256, torch.bfloat16, True),
    (1024, 24, 96, torch.bfloat16, False), (1024, 64, 256, torch.float32, False),
])
def test_mlp_bwd_cluster_shape(k5, hw, c, hid, dtype, ok):
    """Which shapes take the cluster path; f32 always takes the FMA path
    (the wrapper asks the card only in bf16)."""
    if dtype == torch.bfloat16:
        assert (k5.pick(1, hw, c, hid, H100_SMS)["cluster"] > 0) is ok
    else:
        geo = kernels.mlp_bwd_launch(1, hw, c, hid, dtype, torch.device("cpu"))
        assert geo["cluster"] == 0 and geo["chunks"] > 0
    assert "mlp_block_bwd/cluster" in block.PATHS and "mlp_block_bwd_z1/fma" in block.PATHS


# ---------------------------------------------------------------------------
# The stand-alone cluster mix (K7, K7b): which instantiation a shape takes and
# the thread mapping of its per-token phases.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d, m, fast", [(32, 4, True), (32, 1, True), (24, 4, False),
                                        (32, 16, False), (24, 16, False), (24, 49, False),
                                        (64, 4, False), (8, 4, False)])
def test_cluster_mix_path(d, m, fast):
    assert kernels.cluster_mix_fast(d, m) is fast


def _cluster_mix_lanes(tid, tokens, head_dim, fast):
    """The (token, channel) pairs thread `tid` of K7/K7b's 256 reads of one
    input in a per-token phase, as csrc/cluster_mix.cuh states its mapping:
    token slot tid // 8 takes tokens slot, slot + 32, ...; lane tid % 8
    takes channels 4*lane .. 4*lane + 3 (fast) or lane, lane + 8, ...
    (general)."""
    slot, lane = divmod(tid, 8)
    chans = range(4 * lane, 4 * lane + 4) if fast else range(lane, head_dim, 8)
    return [(n, d) for n in range(slot, tokens, 32) for d in chans]


@pytest.mark.parametrize("tokens, d, fast", [(256, 32, True), (196, 32, True),
                                             (256, 24, False), (1024, 24, False),
                                             (64, 12, False)])
def test_cluster_mix_lanes_cover_each_token_channel_once(tokens, d, fast):
    """The 256 threads read every (token, channel) of a region exactly
    once, 8 lanes a token (4 tokens a warp), the same trip count in every
    lane (the 8-lane shuffles need it)."""
    pairs = [_cluster_mix_lanes(t, tokens, d, fast) for t in range(256)]
    flat = sorted(p for ps in pairs for p in ps)
    assert flat == [(n, c) for n in range(tokens) for c in range(d)]
    for t in range(256):
        assert {n for n, _ in pairs[t]} == set(range(t // 8, tokens, 32))
    # a warp's 32 lanes take 4 consecutive tokens
    assert {pairs[t][0][0] for t in range(32)} == {0, 1, 2, 3}


def _cluster_mix_stores(tid, tokens, head_dim, fast):
    """K7's dispatch (csrc/cluster_mix.cu, phase D) as thread `tid` runs it
    in one region: [(token, first channel, channels)] per store, a token's
    4 channels in one store (fast) or one channel a store (general)."""
    slot, lane = divmod(tid, 8)
    if fast:
        return [(n, 4 * lane, 4) for n in range(slot, tokens, 32)]
    return [(n, d, 1) for n in range(slot, tokens, 32) for d in range(lane, head_dim, 8)]


@pytest.mark.parametrize("shape, heads, fold, fast", [
    ((2, 16, 16, 64), 2, 2, True), ((1, 16, 8, 128), 4, 1, True),
    ((1, 16, 16, 48), 2, 2, False), ((2, 8, 8, 24), 2, 1, False)])
def test_cluster_mix_dispatch_stores_cover_each_element_once(shape, heads, fold, fast):
    """Every CTA (sample, region, head) of K7 stores each (token, channel)
    of its region once, a token's NHWC offset formed once (`View::goff`):
    over the grid, every element of the (B, H, W, C) output exactly once,
    and on the fast path as 4-channel stores at 4-element alignment (8 or
    16 bytes)."""
    b, h, w, c = shape
    d = c // heads
    rh, rw = h // fold, w // fold
    hits = [0] * (b * h * w * c)
    for bb in range(b):
        for r in range(fold * fold):
            for hh in range(heads):
                for tid in range(256):
                    for n, d0, cnt in _cluster_mix_stores(tid, rh * rw, d, fast):
                        row = (r // fold) * rh + n // rw
                        col = (r % fold) * rw + n % rw
                        off = ((bb * h + row) * w + col) * c + hh * d + d0
                        assert not fast or off % 4 == 0
                        for e in range(off, off + cnt):
                            hits[e] += 1
    assert hits == [1] * len(hits)


def _f32(x):
    import numpy as np

    return np.float32(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_mix_scatter_sum_has_group_sum_bits(seed):
    """K7/K7b's assignment sums a token's 4 cosines over its 8 lanes by a
    reduce-scatter (`scatter_sum4` in csrc/cluster_mix.cuh): lanes 2m and
    2m + 1 end with cosine m, bit for bit what the butterfly `group_sum`
    gives every lane (the same pairs are added; a + b == b + a in IEEE)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for _ in range(200):
        v = (rng.standard_normal((8, 4)) * 10.0 ** rng.integers(-3, 4, (8, 4))).astype(np.float32)

        def shfl(vals, o):
            return [vals[s ^ o] for s in range(8)]

        g = [list(v[:, m]) for m in range(4)]          # group_sum of each value
        for m in range(4):
            for o in (4, 2, 1):
                g[m] = [_f32(a + b) for a, b in zip(g[m], shfl(g[m], o))]
        hi = [bool(s & 4) for s in range(8)]
        h2 = [bool(s & 2) for s in range(8)]
        send0 = [v[s, 0] if hi[s] else v[s, 2] for s in range(8)]
        send1 = [v[s, 1] if hi[s] else v[s, 3] for s in range(8)]
        b0 = [_f32((v[s, 2] if hi[s] else v[s, 0]) + shfl(send0, 4)[s]) for s in range(8)]
        b1 = [_f32((v[s, 3] if hi[s] else v[s, 1]) + shfl(send1, 4)[s]) for s in range(8)]
        keep = [b1[s] if h2[s] else b0[s] for s in range(8)]
        send = [b0[s] if h2[s] else b1[s] for s in range(8)]
        cc = [_f32(keep[s] + shfl(send, 2)[s]) for s in range(8)]
        out = [_f32(cc[s] + shfl(cc, 1)[s]) for s in range(8)]
        for s in range(8):
            assert out[s].view(np.int32) == g[s >> 1][s].view(np.int32)


# ---------------------------------------------------------------------------
# K3's rows kernel (csrc/simota_assign.cu): one sweep into per-thread sorted
# lists, merged within each warp and then across the 8 warps, against the
# plain twin's rounds (ops/simota.py: k rounds of a first-index arg-max of the
# IoUs, then dynamic-k rounds of a first-index arg-min of the costs).
# ---------------------------------------------------------------------------

_FLT_MAX = 3.4028234663852886e38
_BIG = 1e9


def _to_int(x):
    """f32 -> int32 as the card's truncating conversion: NaN 0, saturating."""
    import math

    if math.isnan(x):
        return 0
    return int(max(-2 ** 31, min(2 ** 31 - 1, math.trunc(max(-1e30, min(1e30, x))))))


def _rounds_rows(ious, cost, k):
    """The rounds: k rounds of a first-index arg-max of the candidate IoUs
    (the pick zeroed; a scan from -FLT_MAX that finds no non-NaN value
    reports -FLT_MAX at index A), summed in pick order; then dynamic-k
    rounds of a first-index arg-min of the costs (the pick set to inf),
    recorded below 1e9 / 2."""
    import numpy as np

    a_n = len(ious)
    x = ious.copy()
    s = np.float32(0.0)
    for _ in range(k):                                    # -FLT_MAX twice is -inf
        ok = x > -_FLT_MAX                                # NaN never wins
        m, i = (np.float32(x[ok].max()), int(np.flatnonzero(ok & (x == x[ok].max()))[0])) \
            if ok.any() else (np.float32(-_FLT_MAX), a_n)
        if i < a_n:
            x[i] = 0.0
        with np.errstate(over="ignore"):
            s = np.float32(s + m)
    dyn = min(max(_to_int(float(s)), 1), k)
    x = cost.copy()
    picks = []
    for _ in range(dyn):
        ok = x < _FLT_MAX
        if not ok.any():
            continue
        m = x[ok].min()
        i = int(np.flatnonzero(ok & (x == m))[0])
        x[i] = np.inf
        if m < _BIG / 2:
            picks.append(i)
    return s, dyn, picks


def _push(lst, x, a, desc):
    """List::push: insert (x, a) behind equal values, keep the length."""
    last = lst[-1][0]
    if not (x > last if desc else x < last):              # also drops NaN
        return
    for j, (v, _) in enumerate(lst):
        if x > v if desc else x < v:
            lst.insert(j, (x, a))
            lst.pop()
            return


def _merged_rows(ious, cost, k, threads=256):
    """The rows kernel as a model: per-thread lists of kk (the first of 4,
    8, 12, 16 that holds k) over anchors tid, tid + threads, ...; each
    warp's k best by k rounds of a lane arg-best (the winning lane pops;
    the IoUs are values only, equal ones broken by lane, the costs by
    anchor); warp 0's k best of the warp lists the same way; the IoUs
    summed in descending order, the first dynamic-k costs picked."""
    import numpy as np

    a_n = len(ious)
    kk = simota_fused.list_length(k)
    empty = {True: (-_FLT_MAX, a_n), False: (_FLT_MAX, a_n)}

    def merge(lists, desc):
        out = []
        for _ in range(k):
            def key(t):
                v, i = lists[t][0]
                return (-v if desc else v, t if desc else i)
            lane = min(range(len(lists)), key=key)
            out.append(lists[lane][0])
            if desc or lists[lane][0][1] < a_n:
                lists[lane] = lists[lane][1:] + [empty[desc]]
        return out

    result = {}
    for desc, vals in ((True, ious), (False, cost)):
        lists = [[empty[desc]] * kk for _ in range(threads)]
        for t in range(threads):
            for a in range(t, a_n, threads):
                if desc or vals[a] < _BIG / 2:
                    _push(lists[t], np.float32(vals[a]), a, desc)
        warps = [merge(lists[w:w + 32], desc) for w in range(0, threads, 32)]
        result[desc] = merge([wl + [empty[desc]] for wl in warps], desc)    # one warp
    top, low = result[True], result[False]
    none = np.float32(0.0 if top[0][0] > -_FLT_MAX else -_FLT_MAX)
    s = np.float32(0.0)
    for v, _ in top:
        with np.errstate(over="ignore"):
            s = np.float32(s + (np.float32(v) if v > -_FLT_MAX else none))
    dyn = min(max(_to_int(float(s)), 1), k)
    return s, dyn, [i for _, i in low[:dyn] if i < a_n]


def _simota_row(rng, a_n, kind):
    """A row's candidate IoUs and costs: many equal values, NaNs, big-M."""
    import numpy as np

    # IoUs: mostly 0, ~30 drawn from 20 values (ties; sums that round
    # differently by order)
    ious = np.zeros(a_n, np.float32)
    hit = rng.random(a_n) < 0.05
    ious[hit] = rng.choice(rng.random(20).astype(np.float32), int(hit.sum()))
    # costs at the centre penalty an f32 ulp apart (ties), a few below it,
    # and big-M entries
    cost = np.float32(1e5) + rng.integers(0, 6, a_n).astype(np.float32) * np.float32(0.0078125)
    cost[rng.random(a_n) < 0.1] = np.float32(rng.integers(1, 4) * 12.3)
    cost[rng.random(a_n) < 0.3] = np.float32(1e9 + 1e5)
    if kind == "nan":
        ious[rng.random(a_n) < 0.2] = np.nan
        cost[rng.random(a_n) < 0.2] = np.nan
    elif kind == "all_nan":
        ious[:] = np.nan
    elif kind == "few":                                   # fewer non-NaN IoUs than k
        ious[:] = np.nan
        ious[rng.integers(0, a_n, 2)] = np.float32(0.625)
    return ious.astype(np.float32), cost.astype(np.float32)


@pytest.mark.parametrize("k", range(1, 17))
def test_simota_rows_merge_equals_the_rounds(k):
    """The one-pass rows kernel gives, for every k it takes (1..16), the
    rounds' dynamic k from the same f32 IoU sum bit for bit (descending
    order), and the rounds' picks, which are a stable argsort's first
    dynamic-k below the big-M."""
    import numpy as np

    rng = np.random.default_rng(100 + k)
    for kind in ("ties", "nan", "all_nan", "few"):
        ious, cost = _simota_row(rng, 1300, kind)
        s_ref, dyn_ref, picks_ref = _rounds_rows(ious, cost, k)
        s, dyn, picks = _merged_rows(ious, cost, k)
        assert s.view(np.int32) == s_ref.view(np.int32), kind
        assert dyn == dyn_ref and picks == picks_ref, kind
        order = [int(i) for i in np.argsort(cost, kind="stable")
                 if not np.isnan(cost[i]) and cost[i] < _BIG / 2]
        assert picks == order[:dyn], kind


# ---------------------------------------------------------------------------
# the seg-loss kernels (K4, K4b): ring depth, persistent grid, tile dealing
# (csrc/seg_loss.cuh::Tiles) and K4's fixed-order reduction
# ---------------------------------------------------------------------------

SEG_NPIX = 16 * 512 * 512                 # the train step's, batch 16 at 512^2


def test_seg_mirrors_match_the_sources():
    import re

    src = "".join(open(f"{kernels.CSRC}/{f}").read() for f in ("seg_loss.cuh", "seg_loss_sums.cu"))
    const = dict(re.findall(r"(k\w+) = ([\d <]+)[;,]", src))
    assert int(const["kTile"]) == kernels.SEG_TILE
    assert int(const["kWideThreads"]) == kernels.SEG_WIDE
    assert eval(const["kRingBytes"]) == kernels.SEG_RING_BYTES
    assert eval(re.search(r"kC \? (\d+ << 10) : kRingBytes", src).group(1)) == \
        kernels.SEG_WIDE_RING_BYTES
    assert (int(const["kMinStages"]), int(const["kMaxStages"])) == kernels.SEG_STAGES


@pytest.mark.parametrize("c", [1, 9, 21, 32])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_seg_rings_fit_and_are_deep_on_the_main_path(c, itemsize):
    # K4b: 256 threads, two output slots, the CTA within the card's 227 KB
    s = kernels.seg_ring_stages(c, itemsize)
    slot = kernels.SEG_TILE * (c * itemsize + 4)
    assert 2 <= s <= 4 and (s == 2 or s * slot <= kernels.SEG_RING_BYTES)
    assert 432 + 2 * kernels.SEG_TILE * c * itemsize + s * slot <= 232448
    # K4: its threads' target bins and its ring
    thr = kernels.seg_sums_threads(c)
    budget = kernels.SEG_WIDE_RING_BYTES if c == 9 else kernels.SEG_RING_BYTES
    s4 = kernels.seg_ring_stages(c, itemsize, thr, budget)
    assert 192 + 3 * c * thr * 4 + s4 * thr * (c * itemsize + 4) <= 232448
    if c == 9:
        assert (s, s4, thr) == (4, 4 if itemsize == 2 else 3, 768)


def _seg_deal(npix, grid, bulk, tile=kernels.SEG_TILE):
    """Per CTA, the tiles it takes in order (seg_loss.cuh::Tiles): ring tiles
    b, b + grid, ... below the first scalar tile, then scalar tiles from the
    CTA after the last ring tile's."""
    nfull = npix // tile
    ntiles, first = -(-npix // tile), (nfull if bulk else 0)
    deal = []
    for b in range(grid):
        mine = list(range(b, first, grid))
        mine += list(range(first + (b + grid - first % grid) % grid, ntiles, grid))
        deal.append(mine)
    return deal


@pytest.mark.parametrize("npix", [1, 255, 256, 257, 3000, SEG_NPIX - 3, SEG_NPIX])
@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "scalar"])
@pytest.mark.parametrize("backward, c, itemsize", [(True, 9, 2), (True, 9, 4), (False, 9, 2),
                                                   (False, 21, 4)],
                         ids=["K4b-bf16", "K4b-f32", "K4", "K4-generic"])
def test_seg_tiles_are_dealt_once_and_evenly(npix, bulk, backward, c, itemsize):
    tile = kernels.SEG_TILE if backward else kernels.seg_sums_threads(c)
    grid = kernels.seg_grid(backward, npix, c, itemsize, H100_SMS)
    ntiles = -(-npix // tile)
    per_sm = kernels.SEG_CTAS_PER_SM[itemsize] if backward else 1
    assert grid == min(ntiles, per_sm * H100_SMS)
    deal = _seg_deal(npix, grid, bulk, tile)
    assert sorted(t for mine in deal for t in mine) == list(range(ntiles))
    # the partial tile does not lengthen the longest CTA
    assert max(map(len, deal)) == -(-ntiles // grid)


def _seg_reduce(acc):
    """K4's reduction of per-thread f32 accumulators acc (grid, threads, W):
    per CTA and value, lane l adds threads l, l + 32, ... in order (f32), an
    xor butterfly adds the 32 lanes (lane 0's is the CTA's row); the last
    CTA sums column w over rows q, q + Q, ... in f64 (Q = threads // W
    slices), then the slices in order."""
    grid, thr, w = acc.shape
    lanes = np.zeros((grid, 32, w), np.float32)
    for i in range(thr // 32):
        lanes = lanes + acc[:, i * 32:(i + 1) * 32]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    assert (lanes == lanes[:, :1]).all()       # every lane holds the CTA's sum
    rows = lanes[:, 0]
    q_ = thr // w
    part = [sum((rows[r].astype(np.float64) for r in range(q, grid, q_)), np.zeros(w))
            for q in range(q_)]
    return sum(part, np.zeros(w)).astype(np.float32)


@pytest.mark.parametrize("npix, grid, c", [(3000, 3, 9), (768 * 7 + 5, 4, 9), (1, 1, 9),
                                           (2000, 2, 21)])
def test_seg_sums_model_matches_the_plain_twin(npix, grid, c):
    """The per-pixel terms of the plain twin, dealt to the threads as the
    kernel deals tiles and reduced as the kernel reduces, give the twin's
    sums (rtol 1e-5: f32 sums in another order)."""
    from asy_vrnet_tpu_torch.ops import losses_seg_fused as tf

    hp, thr = tf.SegHyper(), kernels.seg_sums_threads(c)
    rng = np.random.default_rng(npix)
    logits = torch.from_numpy((rng.standard_normal((1, 1, npix, c)) * 2).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, c + 1, (1, 1, npix)).astype(np.int32))
    probs, onehot, nll, w_t = tf._softmax_parts(logits, target, None)
    logpt = -nll
    focal = -((1.0 - torch.exp(logpt)) ** hp.gamma) * (hp.alpha * logpt)
    pred = (probs > hp.threshold).float()
    terms = torch.cat([torch.stack([nll, w_t, focal, torch.ones_like(nll)], 1),
                       onehot * probs, probs, onehot, onehot * pred, pred], 1).numpy()
    w = terms.shape[1]
    pad = np.zeros((-(-npix // thr) * thr, w), np.float32)
    pad[:npix] = terms
    acc = np.zeros((grid, thr, w), np.float32)
    for b, mine in enumerate(_seg_deal(npix, grid, True, thr)):
        for t in mine:
            acc[b] = acc[b] + pad[t * thr:(t + 1) * thr]
    want, _, _ = tf.seg_sums_plain(logits, target, None, hp)
    np.testing.assert_allclose(_seg_reduce(acc), want.numpy(), rtol=1e-5, atol=1e-5)
