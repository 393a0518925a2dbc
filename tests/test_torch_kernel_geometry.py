"""Launch geometry of the block kernels, as pure functions of the shape (no
card needed): K1's tokens per CTA (`ops/kernels.py::mlp_tokens_per_cta`,
the SM count passed in) and its tensor-core predicate, K2's feat path
(tensor cores or CUDA cores) by C, head width and dtype, and the mixer
backward's (K6, K6r) head groups before the shared-memory fit, products'
path and epilogue tiles.
"""
import pytest
import torch

from asy_vrnet_tpu_torch.ops import block, kernels

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
    (176, 640, torch.bfloat16, False),   # wider than the accumulators' 160
    (24, 96, torch.bfloat16, False), (64, 100, torch.bfloat16, False),
    (64, 256, torch.float32, False),
])
def test_mlp_mma_shape(c, hid, dtype, mma):
    assert kernels.mlp_mma_shape(c, hid, dtype) is mma


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
