"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`; each test skips inside its fixture when no card is present
(never at import, so every pytest worker collects the same tests).  This file
imports no JAX, so it also runs on a machine without it:

    ASY_VRNET_TPU_TESTS=1 python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances:
  f32 instantiation: atol 1e-4 relative to the output scale.  Same formula,
    f32 everywhere, sums in another order; assignments must agree on >=
    99.99% of (token, head) pairs (ties only at f32 rounding).
  bf16 (the main path): kernel and twin round intermediates to bf16 where
    the TPU kernel does, but sum in another order, so a rounding can land on
    the other side and near-tied assignments flip.  Agreement >= 99%, mean |diff| <=
    2% of max |y| (y = out - x), max |diff| <= max |y| + 2 bf16 ulps; the MLP
    half (no assignments) within 2 bf16 ulps of max |out|.
"""
import numpy as np
import pytest
import torch

from asy_vrnet_tpu_torch.ops import (block, boxes, cluster_fused, kernels, losses_seg_fused,
                                     simota_fused)

pytestmark = pytest.mark.cuda

# (name, B, H, W, C, heads, head_dim, fold, hid): the 7 ClusterBlock shapes of
# nano coc_small at 512^2, batch 8, and one of phi "tiny" (C 24: the MLP's
# FMA path, since its tensor-core path needs C % 16 == 0)
SHAPES = [
    ("stage0", 8, 128, 128, 16, 4, 32, 8, 128),
    ("stage1", 8, 64, 64, 32, 4, 32, 4, 256),
    ("stage2", 8, 32, 32, 80, 8, 32, 2, 320),
    ("stage3", 8, 16, 16, 128, 8, 32, 1, 512),
    ("p5", 8, 16, 16, 128, 4, 24, 2, 512),
    ("p4", 8, 32, 32, 160, 4, 24, 2, 640),
    ("p3", 8, 64, 64, 64, 4, 24, 2, 256),
    ("tiny_stage0", 2, 128, 128, 24, 4, 32, 8, 192),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(c, inner, hid, seed):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale  # noqa: E731
    mixer = (n(c, inner, scale=c ** -0.5), n(inner, scale=0.1),
             n(c, inner, scale=c ** -0.5), n(inner, scale=0.1),
             n(inner, c, scale=inner ** -0.5), n(c, scale=0.1), torch.tensor([1.5, 0.2]))
    mlp = (n(c, hid, scale=c ** -0.5), n(hid, scale=0.1),
           n(hid, c, scale=hid ** -0.5), n(c, scale=0.1))
    return n, mixer, mlp


def _cast(ws, dt, dev):
    # matmul weights in the working dtype, biases and alpha/beta in f32
    return [w.to(dev, dt if w.dim() == 2 else torch.float32).contiguous() for w in ws]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_kernel_matches_plain(dev, shape, dt):
    _, b, h, w, c, heads, d, fold, hid = shape
    n, mixer, _ = _weights(c, heads * d, hid, 0)
    x = n(b, h, w, c).to(dev, dt)
    st = block.gn1_stats(x)
    args = _cast(mixer, dt, dev)
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
    before = block.LAUNCHES["mixer_block"]
    out, mom, asg = block.mixer_block(x, st, *args, return_assign=True, **kw)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mixer_block"] == before + 1
    ref, rmom, rasg = block.mixer_block_plain(x, st, *args, return_assign=True, **kw)
    diff = (out.float() - ref.float()).abs()
    ymax = (ref.float() - x.float()).abs().max().item()
    agree = (asg == rasg).float().mean().item()
    if dt == torch.float32:
        assert agree >= 0.9999
        assert diff.max().item() <= 1e-4 * max(1.0, ymax)
        torch.testing.assert_close(mom, rmom, rtol=1e-4, atol=1e-2)
    else:
        assert agree >= 0.99
        assert diff.mean().item() <= 0.02 * ymax
        ulp = 2.0 ** (torch.log2(ref.float().abs().max()).floor().item() - 7)
        assert diff.max().item() <= ymax + 2 * ulp


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_kernel_matches_plain(dev, shape, dt):
    _, b, h, w, c, heads, d, fold, hid = shape
    n, _, mlp = _weights(c, heads * d, hid, 1)
    x = n(b, h, w, c).to(dev, dt)
    st = block.gn1_stats(x)
    args = _cast(mlp, dt, dev)
    before = block.LAUNCHES["mlp_block"]
    out = block.mlp_block(x, st, *args)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mlp_block"] == before + 1
    ref = block.mlp_block_plain(x, st, *args)
    diff = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if dt == torch.float32:
        assert diff <= 1e-5 * max(1.0, scale)
    else:
        assert diff <= 2 * 2.0 ** (torch.log2(torch.tensor(scale)).floor().item() - 7)


def _at_batch(shape, batch):
    return (shape[0], batch) + shape[2:]


def _main_path(shape):
    return shape[0] != "tiny_stage0"


# the largest margin, in the twin's f32 logits, by which the twin may prefer
# another proposal where the f32 kernel's assignment differs from it: tens of
# f32 ulps at |logit| ~ 1, the spread of sums of the same products in
# another order (64-256 terms)
NEAR_TIE = 1e-5


def _flip_margins(x, st, args, kw, asg):
    """Where K2's assignment `asg` (B, heads, H, W) differs from the twin's
    first max: the twin's max logit less its logit at K2's pick (empty when
    they agree)."""
    wf, bf, wv, bv, _, _, ab = args
    p = block._mixer_planes(x, st, wf, bf, wv, bv, ab, **kw)
    logit = ab[1] + ab[0] * p.cos
    karg = block._regions(asg.permute(0, 2, 3, 1), kw["fold_h"], kw["fold_w"])[0].long()
    gap = logit.max(-1).values - logit.gather(-1, karg[..., None])[..., 0]
    return gap[karg != p.arg]


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_kernel_matches_plain_at_batch(dev, shape, dt, batch):
    """K2 at batch 1 and 32 (other cluster sizes, other grids): two launches
    give equal bits; K2's feat ran on tensor cores exactly on the main path
    in bf16; against the twin with its own assignment at the tolerances
    above.  In f32, where an assignment differs (more tokens, more
    near-ties), each differing pick must be a near-tie in the twin's logits
    (NEAR_TIE), and the output is then held at the same tolerance against
    the twin fed K2's assignment."""
    _, b, h, w, c, heads, d, fold, hid = _at_batch(shape, batch)
    x, _, st, args, kw = _mixer_setup(dev, _at_batch(shape, batch), dt, 11)
    tc = block.PATHS["mixer_block/tc"]
    out, mom, asg = block.mixer_block(x, st, *args, return_assign=True, **kw)
    again = block.mixer_block(x, st, *args, return_assign=True, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip((out, mom, asg), again))
    on_tc = dt == torch.bfloat16 and _main_path(shape)
    assert block.PATHS["mixer_block/tc"] == tc + (2 if on_tc else 0)
    ref, _, rasg = block.mixer_block_plain(x, st, *args, return_assign=True, **kw)
    agree = (asg == rasg).float().mean().item()
    ymax = (ref.float() - x.float()).abs().max().item()
    if dt == torch.float32:
        assert agree >= 0.9999
        margins = _flip_margins(x, st, args, kw, asg)
        if margins.numel():
            assert margins.max().item() <= NEAR_TIE
            wf, bf, wv, bv, w2, b2, ab = args
            p = block._mixer_planes(x, st, wf, bf, wv, bv, ab, assign=asg.permute(0, 2, 3, 1),
                                    **kw)
            ref, _ = block._mixer_out(x, p, w2, b2, heads, fold, fold)
        assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ymax)
    else:
        diff = (out.float() - ref.float()).abs()
        assert agree >= 0.99
        assert diff.mean().item() <= 0.02 * ymax
        ulp = 2.0 ** (torch.log2(ref.float().abs().max()).floor().item() - 7)
        assert diff.max().item() <= ymax + 2 * ulp


def test_kernels_refuse_a_path_their_shape_does_not_take(dev):
    """K2's `tc` and K1's `tokens` confirm the path the kernel picks from
    the shape, and never pick one: the other path raises."""
    from asy_vrnet_tpu_torch.ops import kernels

    shape = SHAPES[2]
    x, _, st, args, kw = _mixer_setup(dev, shape, torch.bfloat16, 16)
    b, h, w, c = x.shape
    wf, bf, wv, bv, w2, b2, ab = args
    fold, heads = kw["fold_h"], kw["heads"]
    g = kernels.mixer_groups(x, wf.shape[1], heads, fold, fold, 2, 2)
    part = torch.empty((b, fold * fold * g, 2), dtype=torch.float32, device=dev)
    assert kernels.mixer_feat_on_tensor_cores(c, wf.shape[1] // heads, x.dtype)
    with pytest.raises(RuntimeError, match="mixer_block kernel launch failed"):
        kernels.mixer_block(x, st, wf, bf, wv, bv, w2, b2, ab, torch.empty_like(x), part, None,
                            None, tc=False, **kw)
    _, _, mlp = _weights(c, heads * shape[6], shape[8], 16)
    w1, b1, w2m, b2m = _cast(mlp, torch.bfloat16, dev)
    assert kernels.mlp_tokens(x, w1, w2m) > 0
    with pytest.raises(RuntimeError, match="mlp_block kernel launch failed"):
        kernels.mlp_block(x, st, w1, b1, w2m, b2m, torch.empty_like(x), None, 0)


def test_mixer_bwd_refuses_a_path_its_shape_does_not_take(dev):
    """K6/K6r's `tc` confirms the products' path, as K2's does: the other
    path raises."""
    shape = SHAPES[2]
    x, gy, st, args, kw = _mixer_setup(dev, shape, torch.bfloat16, 16)
    b, h, w, c = x.shape
    wf, bf, wv, bv, w2, _, ab = args
    heads, fold, inner = kw["heads"], kw["fold_h"], wf.shape[1]
    f32 = torch.float32
    g = kernels.mixer_bwd_groups(c, inner, heads, b * fold * fold, 2, 2, True, dev, x.dtype)
    tiles = kernels.mixer_bwd_tiles(h * w, c)
    bufs = (torch.empty_like(x), torch.empty((g, b, h, w, c), dtype=f32, device=dev),
            torch.empty((b * fold * fold, g, 4, c), dtype=f32, device=dev),
            torch.empty((b * fold * fold, 3 * c * inner + 2 * inner), dtype=f32, device=dev),
            torch.empty((b * fold * fold * g, 2), dtype=f32, device=dev),
            torch.empty((b, tiles, 2 + c), dtype=f32, device=dev),
            torch.empty((b, h, w, heads), dtype=torch.int8, device=dev),
            torch.empty((b, h, w, heads, 2), dtype=f32, device=dev))
    assert kernels.mixer_feat_on_tensor_cores(c, inner // heads, x.dtype)
    with pytest.raises(RuntimeError, match="mixer_block_bwd kernel launch failed"):
        kernels.mixer_block_bwd(x, gy, st, wf, bf, wv, bv, w2, ab, None, *bufs, groups=g,
                                tiles=tiles, tc=False, **kw)


def _mlp_close(out, ref, dt):
    diff = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if dt == torch.float32:
        assert diff <= 1e-5 * max(1.0, scale)
    else:
        assert diff <= 2 * 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_kernel_matches_plain_at_batch(dev, shape, dt, batch):
    """K1 at batch 1 and 32 (other tokens per CTA): within the tolerances
    above, two launches give equal bits, on tensor cores exactly on the main
    path in bf16, with the tokens per CTA `mlp_tokens_per_cta` picks."""
    from asy_vrnet_tpu_torch.ops import kernels

    _, b, h, w, c, heads, d, fold, hid = _at_batch(shape, batch)
    n, _, mlp = _weights(c, heads * d, hid, 12)
    x = n(b, h, w, c).to(dev, dt)
    st = block.gn1_stats(x)
    args = _cast(mlp, dt, dev)
    paths = dict(block.PATHS)
    out = block.mlp_block(x, st, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, block.mlp_block(x, st, *args))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    key = (f"mlp_block/mma{kernels.mlp_tokens_per_cta(b * h * w, sms)}"
           if dt == torch.bfloat16 and _main_path(shape) else "mlp_block/fma")
    assert block.PATHS[key] == paths[key] + 2
    _mlp_close(out, block.mlp_block_plain(x, st, *args), dt)


# (B, H, W, C, hid): token counts that are no multiple of 16, at the main
# path's widths (a CTA's last warp holds rows past the end)
RAGGED = [(3, 5, 7, 16, 128), (1, 9, 13, 80, 320), (2, 3, 11, 160, 640), (1, 1, 17, 128, 512),
          (5, 7, 9, 64, 256)]


@pytest.mark.parametrize("case", RAGGED, ids=[f"{b}x{h}x{w}x{c}" for b, h, w, c, _ in RAGGED])
def test_mlp_kernel_ragged_token_counts(dev, case):
    """K1 (bf16, tensor cores) and its z1 variant at ragged token counts:
    the output within 2 bf16 ulps of the twin's, the same bits with and
    without z1, z1 within 2 bf16 ulps of the twin's."""
    b, h, w, c, hid = case
    n, _, mlp = _weights(c, 4 * 8, hid, 13)
    x = n(b, h, w, c).to(dev, torch.bfloat16)
    st = block.gn1_stats(x)
    args = _cast(mlp, torch.bfloat16, dev)
    mma = sum(v for k, v in block.PATHS.items() if k.startswith("mlp_block/mma"))
    out = block.mlp_block(x, st, *args)
    out_z, z1 = block.mlp_block(x, st, *args, return_z1=True)
    torch.cuda.synchronize()
    assert sum(v for k, v in block.PATHS.items() if k.startswith("mlp_block/mma")) == mma + 2
    assert torch.equal(out, out_z)
    ref, zref = block.mlp_block_plain(x, st, *args, return_z1=True)
    _mlp_close(out, ref, torch.bfloat16)
    _mlp_close(z1, zref, torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_block_fits_shared_memory_at_batch_32_and_16_with_the_pack(dev, shape, dt):
    """K2 stages its weights and three chunks in shared memory: every shape
    launches at batch 32, and at batch 16 with the residual pack, without a
    shared-memory refusal (the cluster grows where a block would not fit),
    with finite outputs; K6r then rebuilds the pack's assignment bit for
    bit."""
    x, _, st, args, kw = _mixer_setup(dev, _at_batch(shape, 32), dt, 14)
    out, mom = block.mixer_block(x, st, *args, **kw)
    x, g, st, args, kw = _mixer_setup(dev, _at_batch(shape, 16), dt, 15)
    out16, mom16, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    wf, bf, wv, bv, w2, _, ab = args
    *_, asg = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, None, return_assign=True,
                                    **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t.float()).all()) for t in (out, mom, out16, mom16))
    assert torch.equal(asg, pack[1])


def test_model_on_card_matches_cpu(dev):
    """coc_dryrun at 128^2 in f32: the card (kernels for the 10 fused blocks)
    against the CPU (their plain twins): atol 1e-3, the f32 kernels vs
    f32 cuDNN/cuBLAS (TF32 off) vs the CPU through ~60 layers."""
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    cfg = ModelConfig(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                      input_size=(128, 128))
    cpu = create_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    card = create_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    img = torch.randn(2, 128, 128, 3, generator=g)
    rad = torch.rand(2, 128, 128, 4, generator=g)
    before = dict(block.LAUNCHES)
    with torch.no_grad():
        det_c, seg_c = cpu(img, rad)
        det_g, seg_g = card(img.to(dev), rad.to(dev))
    assert block.LAUNCHES["mixer_block"] - before["mixer_block"] == 10
    assert block.LAUNCHES["mlp_block"] - before["mlp_block"] == 10
    for a, b in zip(det_c, det_g):
        torch.testing.assert_close(b.cpu(), a, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(seg_g.cpu(), seg_c, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# the training kernels: fused seg loss (sums, dlogits) and SimOTA
# ---------------------------------------------------------------------------

def _seg_inputs(dev, dt, shape=(16, 512, 512), c=9, seed=0, weighted=True):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(*shape, c, generator=g) * 2).to(dev, dt)
    target = torch.randint(0, c, shape, generator=g, dtype=torch.int32)
    target[torch.rand(shape, generator=g) < 0.1] = c             # ~10% ignored
    w = torch.linspace(0.5, 2.0, c).to(dev) if weighted else None   # None: every class 1
    return logits, target.to(dev), w


SEG = losses_seg_fused


def _check_sums(acc, ref, dt, c):
    """Sums against the twin's: rtol 1e-5 in f32, 1e-4 on bf16 logits (the
    same f32 math, summed in another order), thresholded counts within 8
    pixels (a probability at the threshold may land on the other side)."""
    counts = slice(4 + 3 * c, 4 + 5 * c)                 # tp_f and sum_pred
    rtol = 1e-5 if dt == torch.float32 else 1e-4
    torch.testing.assert_close(acc[:4 + 3 * c], ref[:4 + 3 * c], rtol=rtol, atol=1e-3)
    torch.testing.assert_close(acc[counts], ref[counts], rtol=0, atol=8)


def _check_dlogits(dl, ref, dt, min_scale=1e-3):
    """f32: max |diff| <= 1e-6 * max(1, max |ref|); bf16: 2 bf16 ulps of max |ref|."""
    assert dl.dtype == ref.dtype and dl.shape == ref.shape
    diff = (dl.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert scale > min_scale
    if dt == torch.float32:
        assert diff <= 1e-6 * max(1.0, scale)
    else:
        assert diff <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "plain"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_loss_sums_kernel_matches_plain(dev, dt, weighted):
    """K4 at the train step's shape: sums, loss and f_score against the twin
    for focal+dice and CE; three calls in a row give the same bits (the last
    CTA resets its ticket), one launch each."""
    logits, target, w = _seg_inputs(dev, dt, weighted=weighted)
    c = 9
    for hp in (SEG.SegHyper(), SEG.SegHyper(use_focal=False, use_dice=False)):
        before = SEG.LAUNCHES["seg_loss_sums"]
        runs = [SEG.seg_loss_sums(logits, target, w, hp) for _ in range(3)]
        torch.cuda.synchronize()
        assert SEG.LAUNCHES["seg_loss_sums"] == before + 3
        for run in runs[1:]:                             # no float atomics
            assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
        acc, loss, fs = runs[0]
        ref, rloss, rfs = SEG.seg_sums_plain(logits, target, w, hp)
        _check_sums(acc, ref, dt, c)
        torch.testing.assert_close(loss, rloss, rtol=1e-3, atol=0)
        torch.testing.assert_close(fs, rfs, rtol=1e-3, atol=0)


@pytest.mark.parametrize("use_focal", [True, False], ids=["focal", "ce"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_loss_dlogits_kernel_matches_plain(dev, dt, use_focal):
    """K4b at the train step's shape, from the twin's sums and a cotangent
    on the device, against the twin fed the same."""
    logits, target, w = _seg_inputs(dev, dt, seed=1)
    hp = SEG.SegHyper(use_focal=use_focal)
    acc, _, _ = SEG.seg_sums_plain(logits, target, w, hp)
    gloss = torch.tensor(3e5, device=dev)
    before = SEG.LAUNCHES["seg_loss_dlogits"]
    dl = SEG.seg_loss_dlogits(logits, target, w, acc, gloss, hp)
    torch.cuda.synchronize()
    assert SEG.LAUNCHES["seg_loss_dlogits"] == before + 1
    _check_dlogits(dl, SEG.seg_dlogits_plain(logits, target, w, acc, gloss, hp), dt)


@pytest.mark.parametrize("shape, c", [((1, 1, 1), 9), ((1, 3, 100), 9), ((2, 37, 53), 9),
                                      ((2, 64, 64), 1), ((2, 37, 53), 21), ((1, 45, 61), 32)],
                         ids=["npix1", "tail", "tail2", "c1", "c21", "c32"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_loss_kernels_tails_and_generic_classes(dev, dt, shape, c):
    """Partial last tiles (npix = 1, 300, 3922, 2745) and the generic path
    (C = 1, 21, 32, any C but 9) of both kernels against their twins."""
    logits, target, w = _seg_inputs(dev, dt, shape=shape, c=c, seed=3)
    hp = SEG.SegHyper()
    acc, loss, fs = SEG.seg_loss_sums(logits, target, w, hp)
    ref, rloss, rfs = SEG.seg_sums_plain(logits, target, w, hp)
    _check_sums(acc, ref, dt, c)
    torch.testing.assert_close(loss, rloss, rtol=1e-3, atol=1e-6)
    gloss = torch.tensor(float(target.numel()), device=dev)
    dl = SEG.seg_loss_dlogits(logits, target, w, ref, gloss, hp)
    ref_dl = SEG.seg_dlogits_plain(logits, target, w, ref, gloss, hp)
    if c > 1:                      # one class: every probability is 1, dlogits 0
        _check_dlogits(dl, ref_dl, dt, min_scale=0.0)
    else:
        assert torch.equal(dl.float(), ref_dl.float())


def test_seg_loss_sure_pixels_stay_finite_below_gamma_one(dev):
    """Pixels sure of their target (pt = 1 within an ulp) with focal gamma
    0.5: K4's SFU log and exp must not step across 0 into a NaN (f32, the
    twin's value within 1e-3 relative)."""
    logits, target, w = _seg_inputs(dev, torch.float32, shape=(2, 64, 64), seed=8)
    sure = target < 9
    rows = logits[sure]                  # the target 15 above the rest: ssum = 1 + ~1e-6
    logits[sure] = rows.scatter(-1, target[sure].long()[:, None],
                                rows.max(-1, keepdim=True).values + 15.0)
    hp = SEG.SegHyper(gamma=0.5, use_dice=False)
    acc, loss, _ = SEG.seg_loss_sums(logits, target, w, hp)
    ref, rloss, _ = SEG.seg_sums_plain(logits, target, w, hp)
    assert torch.isfinite(acc).all() and torch.isfinite(loss)
    torch.testing.assert_close(loss, rloss, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_loss_kernels_read_unaligned_views(dev, dt):
    """Logits whose base is not 16-byte aligned (the scalar path) give the
    twins' results, and the aligned copy's dlogits bit for bit (the same
    per-pixel arithmetic)."""
    logits, target, w = _seg_inputs(dev, dt, shape=(2, 64, 96), seed=4)
    flat = torch.empty(logits.numel() + 1, dtype=dt, device=dev)
    view = flat[1:].view(logits.shape)
    view.copy_(logits)
    assert view.data_ptr() % 16 != 0
    hp = SEG.SegHyper()
    acc, _, _ = SEG.seg_loss_sums(view, target, w, hp)
    ref, _, _ = SEG.seg_sums_plain(logits, target, w, hp)
    _check_sums(acc, ref, dt, 9)
    gloss = torch.tensor(float(target.numel()), device=dev)
    dl = SEG.seg_loss_dlogits(view, target, w, ref, gloss, hp)
    assert torch.equal(dl, SEG.seg_loss_dlogits(logits, target, w, ref, gloss, hp))
    _check_dlogits(dl, SEG.seg_dlogits_plain(logits, target, w, ref, gloss, hp), dt)


def test_seg_loss_kernels_replay_in_a_cuda_graph(dev):
    """Forward and backward captured in one CUDA graph: a replay gives the
    eager calls' bits, twice (the ticket is reset inside the graph too)."""
    logits, target, w = _seg_inputs(dev, torch.bfloat16, shape=(4, 128, 128), seed=5)
    hp = SEG.SegHyper()
    gloss = torch.tensor(7.0, device=dev)

    def run():
        acc, loss, fs = SEG.seg_loss_sums(logits, target, w, hp)
        return acc, loss, fs, SEG.seg_loss_dlogits(logits, target, w, acc, gloss, hp)

    eager = [t.clone() for t in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "plain"])
def test_seg_loss_f32_in_variant_has_the_bf16_bits(dev, weighted):
    """The train step's f32-in variant (round_bf16: the model's f32 output,
    an exact upcast of bf16) gives the bf16 path's sums, loss and f_score
    bit for bit, and its dlogits upcast; so does an f32 input that is not
    bf16-exact (rounded on load)."""
    logits, target, w = _seg_inputs(dev, torch.float32, weighted=weighted, seed=6)
    hp = SEG.SegHyper()
    gloss = torch.tensor(11.0, device=dev)
    b16 = logits.to(torch.bfloat16)
    want = SEG.seg_loss_sums(b16, target, w, hp)
    want_dl = SEG.seg_loss_dlogits(b16, target, w, want[0], gloss, hp)
    for x in (b16.float(), logits):
        got = SEG.seg_loss_sums(x, target, w, hp, round_bf16=True)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
        dl = SEG.seg_loss_dlogits(x, target, w, got[0], gloss, hp, round_bf16=True)
        assert dl.dtype == torch.float32 and torch.equal(dl, want_dl.float())


@pytest.mark.parametrize("use_focal", [True, False], ids=["focal", "ce"])
def test_fused_seg_loss_gradient_matches_autograd_of_the_oracle(dev, use_focal):
    """The autograd.Function (kernels forward and backward, f32) against
    autograd through the unfused losses on the card: value rtol 1e-5,
    gradient atol 1e-6 * max(1, max |grad| * npix) / npix."""
    logits, target, w = _seg_inputs(dev, torch.float32, shape=(2, 128, 128), seed=2)
    out = []
    for fused in (True, False):
        lg = logits.clone().requires_grad_(True)
        loss, fs = losses_seg_fused.fused_seg_loss_and_fscore(
            lg, target, w, 9, use_focal=use_focal, use_kernel=fused)
        (loss * 1e4).backward()
        out.append((loss.detach(), fs.detach(), lg.grad))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-4, atol=1e-6)


def _simota_inputs(dev, valid_counts, seed=0, g=100, size=512, c=4):
    rng = np.random.default_rng(seed)
    level_hw = tuple((size // s, size // s) for s in (8, 16, 32))
    grids, strides = boxes.make_grids_and_strides(level_hw, (8, 16, 32))
    grids, strides = grids.numpy(), strides.numpy()
    a, b = grids.shape[0], len(valid_counts)
    xy = (grids[None] + rng.uniform(-1, 1, (b, a, 2))) * strides[None, :, None]
    wh = np.exp(rng.uniform(-1, 2, (b, a, 2))) * strides[None, :, None]
    gb = np.zeros((b, g, 4), np.float32)
    gv = np.zeros((b, g), bool)
    for i, n in enumerate(valid_counts):
        gb[i, :n] = np.concatenate([rng.uniform(32, size - 32, (n, 2)),
                                    rng.uniform(24, 160, (n, 2))], -1)
        gv[i, :n] = True
    arrays = (np.concatenate([xy, wh], -1), rng.standard_normal((b, a, c)),
              rng.standard_normal((b, a)), gb)
    tensors = [torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in arrays]
    tensors += [torch.from_numpy(rng.integers(0, c, (b, g)).astype(np.int32)).to(dev),
                torch.from_numpy(gv).to(dev), torch.from_numpy(grids).to(dev),
                torch.from_numpy(strides).to(dev)]
    return tensors


def _simota_both(args):
    before = simota_fused.LAUNCHES["simota_assign"]
    ker, kdyn = simota_fused.simota_assign_batched(*args, return_dynamic_ks=True)
    torch.cuda.synchronize()
    assert simota_fused.LAUNCHES["simota_assign"] == before + 1
    ref, rdyn = simota_fused.simota_assign_batched(*args, use_kernel=False,
                                                   return_dynamic_ks=True)
    assert simota_fused.LAUNCHES["simota_assign"] == before + 1
    return ker, kdyn, ref, rdyn


def test_simota_kernel_is_exact_on_ties_and_trivial_images(dev):
    args = _simota_inputs(dev, [0, 1, 7, 7], seed=3)
    pred, cls, obj, gb, gc = args[:5]
    for i in (2, 3):                     # duplicated GT rows, duplicated anchors
        gb[i, 2], gc[i, 2] = gb[i, 1], gc[i, 1]
        pred[i, :4096] = gb[i, 1]
        cls[i, :4096] = cls[i, 0]
        obj[i, :4096] = obj[i, 0]
    ker, kdyn, ref, rdyn = _simota_both(args)
    assert torch.equal(ker.fg_mask, ref.fg_mask)
    assert torch.equal(ker.matched_gt, ref.matched_gt)
    assert torch.equal(kdyn, rdyn)
    torch.testing.assert_close(ker.pred_iou, ref.pred_iou, rtol=0, atol=1e-6)
    assert ker.num_fg[0].item() == 0 and ker.num_fg[1].item() >= 1
    assert not (ker.matched_gt[2:][ker.fg_mask[2:]] == 2).any()


def test_simota_kernel_matches_plain_on_random_inputs(dev):
    args = _simota_inputs(dev, [0, 1, 7, 100, 30, 100, 3, 64], seed=4)
    ker, kdyn, ref, rdyn = _simota_both(args)
    agree = (ker.fg_mask == ref.fg_mask).float().mean().item()
    both = ker.fg_mask & ref.fg_mask
    assert agree >= 0.999
    assert torch.equal(ker.matched_gt[both], ref.matched_gt[both])
    torch.testing.assert_close(ker.pred_iou[both], ref.pred_iou[both], rtol=0, atol=1e-5)
    assert abs(ker.num_fg.sum().item() - ref.num_fg.sum().item()) <= 0.01 * ref.num_fg.sum().item()
    assert (kdyn == rdyn).float().mean().item() >= 0.99
    assert ref.num_fg.sum().item() > 100


def _simota_views(args):
    """The predictions as `yolox_loss` hands them over: strided views of one
    (B, A, 5 + C) tensor."""
    pred, cls, obj = args[:3]
    full = torch.cat([pred, obj[..., None], cls], -1)
    return [full[..., :4], full[..., 5:], full[..., 4]] + list(args[3:])


def test_simota_kernel_reads_the_loss_views_in_place(dev):
    """K3 on the loss's strided views, with gt_classes int64 and gt_valid
    uint8, gives the bits it gives on contiguous int32 / bool copies."""
    args = _simota_inputs(dev, [0, 1, 7, 100], seed=6)
    views = _simota_views(args)
    assert not views[0].is_contiguous() and not views[2].is_contiguous()
    got, gdyn = simota_fused.simota_assign_batched(*views, return_dynamic_ks=True)
    other = views[:4] + [views[4].long(), views[5].to(torch.uint8)] + views[6:]
    alt, adyn = simota_fused.simota_assign_batched(*other, return_dynamic_ks=True)
    want, wdyn = simota_fused.simota_assign_batched(*args, return_dynamic_ks=True)
    torch.cuda.synchronize()
    for res, dyn in ((got, gdyn), (alt, adyn)):
        assert all(torch.equal(a, b) for a, b in zip(res, want)) and torch.equal(dyn, wdyn)
    assert got.fg_mask.dtype == torch.bool and got.matched_gt.dtype == torch.int64
    assert got.num_fg.dtype == torch.float32 and gdyn.dtype == torch.int32


@pytest.mark.parametrize("k", [1, 10, 16])
def test_simota_kernel_candidate_k_and_ragged_anchors(dev, k):
    """K3 at candidate_k 1, 10 and 16 on 320^2 anchors (A = 2100, not a
    multiple of the 256-thread block) against its twin: exact on the 0- and
    1-GT images, otherwise as on random inputs."""
    args = _simota_views(_simota_inputs(dev, [0, 1, 7, 30], seed=5, size=320))
    assert args[0].shape[1] % 256
    ker, kdyn = simota_fused.simota_assign_batched(*args, candidate_k=k,
                                                   return_dynamic_ks=True)
    torch.cuda.synchronize()
    ref, rdyn = simota_fused.simota_assign_batched(*args, candidate_k=k, use_kernel=False,
                                                   return_dynamic_ks=True)
    for i in (0, 1):
        assert torch.equal(ker.fg_mask[i], ref.fg_mask[i])
        assert torch.equal(ker.matched_gt[i], ref.matched_gt[i])
        assert torch.equal(kdyn[i], rdyn[i])
    both = ker.fg_mask & ref.fg_mask
    assert (ker.fg_mask == ref.fg_mask).float().mean().item() >= 0.999
    assert torch.equal(ker.matched_gt[both], ref.matched_gt[both])
    torch.testing.assert_close(ker.pred_iou[both], ref.pred_iou[both], rtol=0, atol=1e-5)
    assert abs(ker.num_fg.sum().item() - ref.num_fg.sum().item()) <= max(
        1.0, 0.01 * ref.num_fg.sum().item())
    assert (kdyn == rdyn).float().mean().item() >= 0.99 and (kdyn <= k).all()
    with pytest.raises(ValueError, match="candidate_k"):
        simota_fused.simota_assign_batched(*args, candidate_k=17)


def test_simota_wrapper_runs_three_device_operations(dev, tmp_path):
    """One K3 wrapper call on the loss's views is its three kernels and
    nothing else on the device (profiler trace)."""
    from asy_vrnet_tpu_torch.utils.profiling import kernel_table, traced

    args = _simota_views(_simota_inputs(dev, [3] * 4, seed=7))
    simota_fused.simota_assign_batched(*args)
    torch.cuda.synchronize()
    traced(lambda: [simota_fused.simota_assign_batched(*args) for _ in range(5)],
           str(tmp_path), on_card=True)
    rows = kernel_table(str(tmp_path), 5)
    calls = sum(n for (name, _), (_, n) in rows.items() if "simota_rows_kernel" in name)
    assert calls > 0
    assert sum(n for _, n in rows.values()) / calls <= 3, sorted(name for name, _ in rows)


# ---------------------------------------------------------------------------
# the block backward: K2's residual pack, K5 and K6 (same pack fed to the
# kernel and to its twin, so a flipped bf16 assignment cannot enter)
#   f32: every output within 1e-4 * max(1, max |ref|), assignment 100% equal.
#   bf16: dxn within 2 bf16 ulps of max |ref|; weight, bias, alpha/beta
#   gradients within 2% of max |ref|; GroupNorm sums within 1e-3 of
#   sum |dxn| (they cancel); residual pack: assignment >= 99% equal, c_rep
#   within 2% of max |ref|, cbest within 2% of max |ref| where the
#   assignment agrees, mean |d oc| within 2% of max |ref| (a flipped token
#   moves its two centers).  Two runs of each kernel give equal bits.
# ---------------------------------------------------------------------------

def _bwd_close(name, got, want, dt, dxn_ref=None):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if dt == torch.float32:
        assert err <= 1e-4 * max(1.0, scale), (name, err, scale)
    elif name == "dxn":
        assert err <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7), (name, err, scale)
    elif name == "sums":
        tol = 1e-3 * dxn_ref.float().abs().sum(dim=(1, 2, 3))
        assert ((got - want).abs() <= tol[:, None]).all(), (name, got, want)
    else:
        assert err <= 0.02 * max(scale, 1e-6), (name, err, scale)


def _bwd_paths(key, shape, dt):
    """The PATHS counter the mixer backward `key` advances at this shape:
    bf16 at every nano shape runs its products on tensor cores."""
    _, b, h, w, c, heads, d, fold, hid = shape
    tc = kernels.mixer_feat_on_tensor_cores(c, d, dt)
    if dt == torch.bfloat16 and not shape[0].startswith("tiny"):
        assert tc, shape[0]
    return f"{key}/{'tc' if tc else 'fma'}"


def _mixer_setup(dev, shape, dt, seed):
    _, b, h, w, c, heads, d, fold, hid = shape
    n, mixer, _ = _weights(c, heads * d, hid, seed)
    x = n(b, h, w, c).to(dev, dt)
    g = (n(b, h, w, c) * 0.5).to(dev, dt)
    args = _cast(mixer, dt, dev)
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
    return x, g, block.gn1_stats(x), args, kw


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_residual_pack_matches_plain(dev, shape, dt):
    x, _, st, args, kw = _mixer_setup(dev, shape, dt, 2)
    before = block.LAUNCHES["mixer_block"]
    out, mom, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    _, _, again = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mixer_block"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(pack, again))
    ref, _, rpack = block.mixer_block_plain(x, st, *args, return_residuals=True, **kw)
    assert [(t.dtype, t.shape) for t in pack] == [(t.dtype, t.shape) for t in rpack]
    same = pack[1] == rpack[1]
    if dt == torch.float32:
        assert bool(same.all())
        for name, a, r in zip(("cbest", "c_rep", "oc"), pack[::2] + pack[3:], rpack[::2] + rpack[3:]):
            _bwd_close(name, a, r, dt)
    else:
        assert same.float().mean().item() >= 0.99
        _bwd_close("c_rep", pack[2], rpack[2], dt)
        cb_err = ((pack[0].float() - rpack[0].float()).abs() * same).max().item()
        assert cb_err <= 0.02 * rpack[0].float().abs().max().item()
        # a flipped token moves its two centers: the mean stays small
        oc_err = (pack[3].float() - rpack[3].float()).abs().mean().item()
        assert oc_err <= 0.02 * rpack[3].float().abs().max().item()


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_bwd_kernel_matches_plain(dev, shape, dt):
    x, g, st, args, kw = _mixer_setup(dev, shape, dt, 3)
    wf, bf, wv, bv, w2, _, ab = args
    _, _, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    before = block.LAUNCHES["mixer_block_bwd"]
    path = _bwd_paths("mixer_block_bwd", shape, dt)
    on_path = block.PATHS[path]
    got = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, pack, **kw)
    again = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, pack, **kw)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mixer_block_bwd"] == before + 2
    assert block.PATHS[path] == on_path + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block.mixer_block_bwd_plain(x, g, st, wf, bf, wv, bv, w2, ab, pack, **kw)
    assert got[0].dtype == dt and got[0].shape == x.shape
    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
    for name, a, w_ in zip(names, got, want):
        _bwd_close(name, a, w_, dt, want[0])


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_bwd_kernel_matches_plain(dev, shape, dt):
    _, b, h, w, c, heads, d, fold, hid = shape
    n, _, mlp = _weights(c, heads * d, hid, 4)
    x = n(b, h, w, c).to(dev, dt)
    g = (n(b, h, w, c) * 0.5).to(dev, dt)
    st = block.gn1_stats(x)
    w1, b1, w2, _ = _cast(mlp, dt, dev)
    before = block.LAUNCHES["mlp_block_bwd"]
    cluster = kernels.mlp_bwd_launch(b, h * w, c, hid, dt, dev)["cluster"] > 0
    assert cluster is (dt == torch.bfloat16 and not shape[0].startswith("tiny"))
    path = f"mlp_block_bwd/{'cluster' if cluster else 'fma'}"
    on_path = block.PATHS[path]
    got = block.mlp_block_bwd(x, g, st, w1, b1, w2)
    again = block.mlp_block_bwd(x, g, st, w1, b1, w2)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mlp_block_bwd"] == before + 2
    assert block.PATHS[path] == on_path + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block.mlp_block_bwd_plain(x, g, st, w1, b1, w2)
    for name, a, w_ in zip(("dxn", "dw1", "db1", "dw2", "db2", "sums"), got, want):
        _bwd_close(name, a, w_, dt, want[0])


# (name, B, H, W, C, hid): K5's cluster path at hidden widths whose 32-unit
# slices do not divide by the cluster (csrc/mlp_block_bwd_geometry.h: 11 or 13
# slices over 8 ranks; p4's 20 over 8 at batch 1, 64-token tiles), and one
# 64-token tile
UNEVEN_MLP = [("c128_h352", 2, 16, 16, 128, 352), ("c128_h416", 2, 16, 16, 128, 416),
              ("c160_h640", 1, 32, 32, 160, 640), ("one_tile", 1, 8, 8, 16, 32)]


@pytest.mark.parametrize("shape", UNEVEN_MLP, ids=[s[0] for s in UNEVEN_MLP])
@pytest.mark.parametrize("z1", [False, True], ids=["remat", "z1"])
def test_mlp_bwd_uneven_hidden_split(dev, shape, z1):
    """K5 in bf16 on its cluster path where the ranks own different numbers
    of hidden slices: against its twin, two runs equal bits."""
    _, b, h, w, c, hid = shape
    n, _, mlp = _weights(c, 64, hid, 9)
    dt = torch.bfloat16
    x = n(b, h, w, c).to(dev, dt)
    g = (n(b, h, w, c) * 0.5).to(dev, dt)
    st = block.gn1_stats(x)
    lw = _cast(mlp, dt, dev)
    w1, b1, w2, _ = lw
    geo = kernels.mlp_bwd_launch(b, h * w, c, hid, dt, dev)
    uneven = (hid // 32) % geo["cluster"] != 0
    assert geo["cluster"] >= 1 and (uneven or shape[0] == "one_tile"), geo
    zz = block.mlp_block(x, st, *lw, return_z1=True)[1] if z1 else None
    key = "mlp_block_bwd_z1" if z1 else "mlp_block_bwd"
    on_path = block.PATHS[f"{key}/cluster"]
    got = block.mlp_block_bwd(x, g, st, w1, b1, w2, zz)
    again = block.mlp_block_bwd(x, g, st, w1, b1, w2, zz)
    torch.cuda.synchronize()
    assert block.PATHS[f"{key}/cluster"] == on_path + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block.mlp_block_bwd_plain(x, g, st, w1, b1, w2, zz)
    for name, a, w_ in zip(("dxn", "dw1", "db1", "dw2", "db2", "sums"), got, want):
        _bwd_close(name, a, w_, dt, want[0])


# ---------------------------------------------------------------------------
# K6r (the full-remat mixer backward) and the z1 variants of K1 and K5.  K6r
# must rebuild the assignment K2 stored, bit for bit; its twin is fed that
# assignment (as K6's twin is fed K2's pack).  Tolerances as the block
# backward above; K1 with z1 gives K1's output bits, and z1 lies within
# 1e-5 (f32) or 2 bf16 ulps of max |z1| (bf16) of its twin's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_bwd_remat_kernel_matches_plain(dev, shape, dt):
    x, g, st, args, kw = _mixer_setup(dev, shape, dt, 5)
    wf, bf, wv, bv, w2, _, ab = args
    _, _, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    before = block.LAUNCHES["mixer_block_bwd_remat"]
    path = _bwd_paths("mixer_block_bwd_remat", shape, dt)
    on_path = block.PATHS[path]
    *got, asg = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, None,
                                      return_assign=True, **kw)
    *again, asg2 = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, None,
                                         return_assign=True, **kw)
    torch.cuda.synchronize()
    assert block.LAUNCHES["mixer_block_bwd_remat"] == before + 2
    assert block.PATHS[path] == on_path + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the assignment K6r rebuilt (once a call) is K2's, bit for bit, twice
    assert torch.equal(asg, pack[1]) and torch.equal(asg2, pack[1])
    want = block.mixer_block_bwd_remat_plain(x, g, st, wf, bf, wv, bv, w2, ab, assign=asg, **kw)
    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
    for name, a, w_ in zip(names, got, want):
        _bwd_close(name, a, w_, dt, want[0])


# regions of fewer tokens than one 32-token chunk (nano at 128^2: 16 and 4
# tokens), where sweep 2's first chunk is sweep 1's only one
SMALL_REGIONS = [("stage0_128", 2, 32, 32, 16, 4, 32, 8, 128),
                 ("p5_128", 2, 4, 4, 128, 4, 24, 2, 512),
                 ("p3_128", 2, 16, 16, 64, 4, 24, 2, 256)]


@pytest.mark.parametrize("shape", SMALL_REGIONS, ids=[s[0] for s in SMALL_REGIONS])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("remat", [False, True], ids=["k6", "k6r"])
def test_mixer_bwd_small_regions(dev, shape, dt, remat):
    x, g, st, args, kw = _mixer_setup(dev, shape, dt, 9)
    wf, bf, wv, bv, w2, _, ab = args
    _, _, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    res = None if remat else pack
    got = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, res, return_assign=remat,
                                **kw)
    again = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, res, return_assign=remat,
                                  **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if remat:
        *got, asg = got
        assert torch.equal(asg, pack[1])
        want = block.mixer_block_bwd_remat_plain(x, g, st, wf, bf, wv, bv, w2, ab, assign=asg,
                                                 **kw)
    else:
        want = block.mixer_block_bwd_plain(x, g, st, wf, bf, wv, bv, w2, ab, pack, **kw)
    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
    for name, a, w_ in zip(names, got, want):
        _bwd_close(name, a, w_, dt, want[0])


@pytest.mark.parametrize("remat", [False, True], ids=["k6", "k6r"])
def test_mixer_bwd_fits_shared_memory_at_batch_32(dev, remat):
    """nano stage 2 at batch 32: its 128 regions fill the card with one head
    group per region, whose block (8 heads' columns) would need ~340 KB of
    shared memory; the backward splits the heads into groups that fit."""
    shape = ("stage2_b32", 32, 32, 32, 80, 8, 32, 2, 320)
    x, g, st, args, kw = _mixer_setup(dev, shape, torch.bfloat16, 7)
    wf, bf, wv, bv, w2, _, ab = args
    _, _, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    pack = None if remat else pack
    got = block.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, pack, return_assign=remat,
                                **kw)
    torch.cuda.synchronize()
    assign = got[-1] if remat else None
    want = (block.mixer_block_bwd_remat_plain(x, g, st, wf, bf, wv, bv, w2, ab, assign=assign,
                                              **kw) if remat else
            block.mixer_block_bwd_plain(x, g, st, wf, bf, wv, bv, w2, ab, pack, **kw))
    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dab", "sums")
    for name, a, w_ in zip(names, got, want):
        _bwd_close(name, a, w_, torch.bfloat16, want[0])


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_z1_kernels_match_plain(dev, shape, dt):
    _, b, h, w, c, heads, d, fold, hid = shape
    n, _, mlp = _weights(c, heads * d, hid, 6)
    x = n(b, h, w, c).to(dev, dt)
    g = (n(b, h, w, c) * 0.5).to(dev, dt)
    st = block.gn1_stats(x)
    lw = _cast(mlp, dt, dev)
    before = dict(block.LAUNCHES)
    out, z1 = block.mlp_block(x, st, *lw, return_z1=True)
    torch.cuda.synchronize()
    assert torch.equal(out, block.mlp_block(x, st, *lw))
    _, zref = block.mlp_block_plain(x, st, *lw, return_z1=True)
    scale = zref.float().abs().max().item()
    tol = 1e-5 * max(1.0, scale) if dt == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (z1.float() - zref.float()).abs().max().item() <= tol
    w1, b1, w2, _ = lw
    got = block.mlp_block_bwd(x, g, st, w1, b1, w2, z1)
    again = block.mlp_block_bwd(x, g, st, w1, b1, w2, z1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block.mlp_block_bwd_plain(x, g, st, w1, b1, w2, z1)
    for name, a, w_ in zip(("dxn", "dw1", "db1", "dw2", "db2", "sums"), got, want):
        _bwd_close(name, a, w_, dt, want[0])
    launched = {k: block.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**dict.fromkeys(before, 0), "mlp_block_z1": 1, "mlp_block": 1,
                        "mlp_block_bwd_z1": 2}


def test_remat_train_steps_on_card_match_cpu(dev, monkeypatch):
    """coc_dryrun 128^2 f32, one train step under train_remat "blocks" with
    ASY_MIXER_BWD_RESIDUALS=0 and one with ASY_MLP_BWD_RESIDUALS=1: the card
    (K6r; K1 and K5 with z1) against the CPU (their twins) from the same
    state, metrics rtol 1e-3 as the fused step above; launches per step."""
    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train.optim import set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    batch = make_batch(np.random.default_rng(5), 2, (128, 128), max_boxes=16)
    for remat, env, want in (
            ("blocks", ("ASY_MIXER_BWD_RESIDUALS", "0"),
             {"mixer_block": 18, "mlp_block": 10, "mixer_block_bwd_remat": 10,
              "mlp_block_bwd": 10}),
            ("none", ("ASY_MLP_BWD_RESIDUALS", "1"),
             {"mixer_block": 10, "mlp_block_z1": 10, "mixer_block_bwd": 10,
              "mlp_block_bwd_z1": 10})):
        monkeypatch.setenv(*env)
        cfg = Config(model=ModelConfig(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                                       input_size=(128, 128), train_remat=remat),
                     loss=LossConfig(max_boxes=16, use_pallas_seg=True))
        torch.manual_seed(0)
        cpu = create_train_state(cfg, device="cpu")
        card = create_train_state(cfg, device=dev)
        card.model.load_state_dict(cpu.model.state_dict())
        out = {}
        for name, state, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
            set_learning_rate(state.optimizer, 1e-2)
            before = dict(block.LAUNCHES)
            _, m = build_train_step(cfg, device=device)(state, batch)
            out[name] = {k: float(v) for k, v in m.items()}
            launched = {k: block.LAUNCHES[k] - before[k] for k in before}
            assert launched == {**dict.fromkeys(before, 0), **({} if name == "cpu" else want)}
        for k in out["cpu"]:
            np.testing.assert_allclose(out["card"][k], out["cpu"][k], rtol=1e-3, err_msg=k)
        monkeypatch.delenv(env[0])


def test_fused_train_step_on_card_matches_cpu(dev):
    """coc_dryrun 128^2 f32, one train step through the fused blocks: the
    card (K2 with its pack, K1, K6, K5) against the CPU (their twins) from
    the same state: metrics rtol 1e-3 (f32 kernels, cuDNN with TF32 off,
    sums in another order through a forward and a backward)."""
    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train.optim import set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    cfg = Config(model=ModelConfig(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                                   input_size=(128, 128)),
                 loss=LossConfig(max_boxes=16, use_pallas_seg=True))
    torch.manual_seed(0)
    cpu = create_train_state(cfg, device="cpu")
    card = create_train_state(cfg, device=dev)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = make_batch(np.random.default_rng(5), 2, (128, 128), max_boxes=16)
    out = {}
    for name, state, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        set_learning_rate(state.optimizer, 1e-2)
        before = dict(block.LAUNCHES)
        _, m = build_train_step(cfg, device=device)(state, batch)
        out[name] = {k: float(v) for k, v in m.items()}
        launched = {k: block.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({k: 0 for k in before} if name == "cpu" else
                            {**dict.fromkeys(before, 0), "mixer_block": 10, "mlp_block": 10,
                             "mixer_block_bwd": 10, "mlp_block_bwd": 10})
    for k in out["cpu"]:
        np.testing.assert_allclose(out["card"][k], out["cpu"][k], rtol=1e-3, err_msg=k)
    for (k, a), b in zip(card.model.state_dict().items(), cpu.model.state_dict().values()):
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3, msg=k)


# ---------------------------------------------------------------------------
# the stand-alone cluster mix, K7 (forward) and K7b (backward), against their
# twins.  Tolerances as the mixer half (K7) and the block backward (K7b) of
# the same dtype above; the twin of K7b is fed K7b's own assignment, which
# must equal K7's (the same device code rebuilds it).  Two runs of each give
# equal bits.
# ---------------------------------------------------------------------------

# (name, B, H, W, I, heads, fold, proposals): the four stochastic-depth
# shapes of nano coc_small at 512^2 (a smaller batch), a neck-like one
# (head_dim 24, 1024-token regions), coc_tiny2's stage 0 (4x4 proposals),
# its 7x7 proposals (M = 49, overlapping windows, 196-token regions) and
# head_dim 32 with 4x4 proposals: all but the first four take the general
# instantiation of K7/K7b (`kernels.cluster_mix_fast`)
CLUSTER_SHAPES = [
    ("stage0", 4, 128, 128, 128, 4, 8, 2),
    ("stage1", 4, 64, 64, 128, 4, 4, 2),
    ("stage2", 4, 32, 32, 256, 8, 2, 2),
    ("stage3", 4, 16, 16, 256, 8, 1, 2),
    ("p3", 2, 64, 64, 96, 4, 2, 2),
    ("tiny2_stage0", 2, 128, 128, 96, 4, 8, 4),
    ("tiny2_7x7", 2, 28, 28, 96, 4, 2, 7),
    ("d32_4x4", 2, 64, 64, 128, 4, 4, 4),
]


def _cluster_path(kernel, shape):
    """The PATHS counter K7 or K7b advances at this shape."""
    _, b, h, w, inner, heads, fold, prop = shape
    fast = kernels.cluster_mix_fast(inner // heads, prop * prop)
    assert fast is (shape[0].startswith("stage")), shape[0]
    return f"{kernel}/{'fast' if fast else 'general'}"


def _cluster_setup(dev, shape, dt, seed):
    _, b, h, w, inner, heads, fold, prop = shape
    g = torch.Generator().manual_seed(seed)
    feat, value, gy = (torch.randn(b, h, w, inner, generator=g).mul(sc).to(dev, dt)
                       for sc in (1.0, 1.0, 0.5))
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=prop, proposal_w=prop)
    return feat, value, gy, torch.tensor([1.5, 0.2], device=dev), kw


@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=[s[0] for s in CLUSTER_SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cluster_mix_kernel_matches_plain(dev, shape, dt):
    feat, value, _, ab, kw = _cluster_setup(dev, shape, dt, 5)
    before = cluster_fused.LAUNCHES["cluster_mix"]
    path = _cluster_path("cluster_mix", shape)
    on_path = cluster_fused.PATHS[path]
    out, asg = cluster_fused.cluster_mix_fwd(feat, value, ab, return_assign=True, **kw)
    again = cluster_fused.cluster_mix_fwd(feat, value, ab, **kw)
    torch.cuda.synchronize()
    assert cluster_fused.LAUNCHES["cluster_mix"] == before + 2
    assert cluster_fused.PATHS[path] == on_path + 2
    assert torch.equal(out, again) and out.dtype == dt
    ref, rasg = cluster_fused.cluster_mix_fused_plain(feat, value, ab, return_assign=True, **kw)
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    agree = (asg == rasg).float().mean().item()
    if dt == torch.float32:
        assert agree >= 0.9999 and diff.max().item() <= 1e-4 * max(1.0, scale)
    else:
        assert agree >= 0.99 and diff.mean().item() <= 0.02 * scale
        assert diff.max().item() <= scale + 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=[s[0] for s in CLUSTER_SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cluster_mix_bwd_kernel_matches_plain(dev, shape, dt):
    feat, value, gy, ab, kw = _cluster_setup(dev, shape, dt, 6)
    _, asg = cluster_fused.cluster_mix_fwd(feat, value, ab, return_assign=True, **kw)
    before = cluster_fused.LAUNCHES["cluster_mix_bwd"]
    path = _cluster_path("cluster_mix_bwd", shape)
    on_path = cluster_fused.PATHS[path]
    got = cluster_fused.cluster_mix_bwd(feat, value, gy, ab, return_assign=True, **kw)
    again = cluster_fused.cluster_mix_bwd(feat, value, gy, ab, **kw)
    torch.cuda.synchronize()
    assert cluster_fused.LAUNCHES["cluster_mix_bwd"] == before + 2
    assert cluster_fused.PATHS[path] == on_path + 2
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again))
    assert torch.equal(got[3], asg)
    want = cluster_fused.cluster_mix_bwd_plain(feat, value, gy, ab, assign=got[3], **kw)
    assert got[0].dtype == got[1].dtype == dt and got[2].dtype == torch.float32
    for name, a, w_ in zip(("dxn", "dvalue", "dab"), got[:3], want):
        _bwd_close("dxn" if name == "dvalue" else name, a, w_, dt)


@pytest.mark.parametrize("shape", [CLUSTER_SHAPES[i] for i in (0, 3, 4, 6)],
                         ids=[CLUSTER_SHAPES[i][0] for i in (0, 3, 4, 6)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cluster_mix_k7_and_k7b_share_their_mixed_centers(dev, shape, dt):
    """K7 and K7b compute the mixed centers with one function
    (`mixed_centers` in csrc/cluster_mix.cuh): both write the same bits
    (every entry written: the buffers start as NaN), at stage 0, stage 3
    (fast) and on the general path (D = 24), and they are the twin's
    (agg + vc) / (count + 1) at K7's assignment (f32 within 1e-4 of
    max |ref|; bf16 within 2%: rnd(sim) can land on the other bf16 side)."""
    feat, value, gy, ab, kw = _cluster_setup(dev, shape, dt, 8)
    _, b, h, w, inner, heads, fold, prop = shape
    fast = kernels.cluster_mix_fast(inner // heads, prop * prop)
    cen = [torch.full((b, heads, fold * fold, prop * prop, inner // heads), float("nan"),
                      device=dev) for _ in range(2)]
    out = torch.empty_like(feat)
    asg = torch.empty((b, h, w, heads), dtype=torch.int8, device=dev)
    kernels.cluster_mix(feat, value, ab, out, asg, fast=fast, centers=cen[0], **kw)
    dab = torch.empty((b * heads * fold * fold, 2), device=dev)
    kernels.cluster_mix_bwd(feat, value, gy, ab, torch.empty_like(feat), torch.empty_like(feat),
                            dab, None, fast=fast, centers=cen[1], **kw)
    torch.cuda.synchronize()
    assert torch.equal(cen[0], cen[1])
    assert torch.equal(out, cluster_fused.cluster_mix_fwd(feat, value, ab, **kw))
    p = cluster_fused._remat(feat, value, ab, heads, fold, fold, prop, prop, assign=asg)
    rnd_sim = block._round(p["sim"], dt)
    ref = (torch.einsum("bhrmn,bhrnd->bhrmd", rnd_sim, p["vf"]) + p["vc"]) / (p["counts"] + 1.0)
    scale = ref.abs().max().item()
    err = (cen[0] - ref).abs().max().item()
    assert err <= (1e-4 * max(1.0, scale) if dt == torch.float32 else 0.02 * scale), err


def test_cluster_mix_fused_gradients_on_card_match_cpu(dev):
    """`cluster_mix_fused` under autograd, f32: the card (K7, K7b) against
    the CPU (their twins) at a nano stage-2 shape, every gradient within
    1e-4 of its scale."""
    feat, value, gy, _, kw = _cluster_setup(dev, ("stage2", 2, 32, 32, 256, 8, 2, 2),
                                            torch.float32, 7)
    res = {}
    for device in (dev, torch.device("cpu")):
        args = [t.detach().to(device).requires_grad_(True) for t in
                (feat, value, torch.tensor([1.3]), torch.tensor([-0.2]))]
        before = dict(cluster_fused.LAUNCHES)
        out = cluster_fused.cluster_mix_fused(*args, **kw)
        (out * gy.to(device)).sum().backward()
        launched = {k: cluster_fused.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"cluster_mix": 1, "cluster_mix_bwd": 1} if device == dev
                            else {"cluster_mix": 0, "cluster_mix_bwd": 0})
        res[device.type] = [out.detach().cpu()] + [a.grad.cpu() for a in args]
    for name, a, b in zip(("out", "dfeat", "dvalue", "dalpha", "dbeta"), res["cuda"], res["cpu"]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_ablate_prefixes_match_plain(dev, shape, dt):
    """K2's prefixes (ops/mixer_ablate.py): base `full` is K2 bit for bit
    (output, moments, assignment); every cut prefix wrote rnd(x + s) with its
    checksum s, which (with its sum of |terms|) is within 1e-5 (f32) or 1e-3
    (bf16) of the twin's sum of |terms| per CTA, the twin fed the kernel's
    assignment; nf `full` against its twin fed its own assignment, as the
    mixer half."""
    from asy_vrnet_tpu_torch.ops import mixer_ablate as ma

    x, _, st, args, kw = _mixer_setup(dev, shape, dt, 14)
    fold = kw["fold_h"]
    out, mom, asg = block.mixer_block(x, st, *args, return_assign=True, **kw)
    asg = asg.permute(0, 2, 3, 1).to(torch.int8)
    before = ma.LAUNCHES["mixer_block_ablate"]
    o, part, a = ma.mixer_block_ablate(x, st, *args, stop="full", return_assign=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, out) and torch.equal(part.sum(1), mom) and torch.equal(a, asg)
    groups = part.shape[1] // fold ** 2
    o, part, nf_asg = ma.mixer_block_ablate(x, st, *args, stop="full", nf=True,
                                            return_assign=True, **kw)
    ref, _ = ma.mixer_block_ablate_plain(x, st, *args, stop="full", nf=True, groups=groups,
                                         assign=nf_asg, **kw)
    diff = (o.float() - ref.float()).abs()
    ymax = (out.float() - x.float()).abs().max().item()
    if dt == torch.float32:
        assert diff.max().item() <= 1e-4 * max(1.0, ymax)
    else:
        ulp = 2.0 ** (torch.log2(out.float().abs().max()).floor().item() - 7)
        assert diff.mean().item() <= 0.02 * ymax and diff.max().item() <= ymax + 2 * ulp
    for stop, nf in [(s, False) for s in ma.STOPS[False][:-1]] + [
            (s, True) for s in ma.STOPS[True][:-1]]:
        o, part = ma.mixer_block_ablate(x, st, *args, stop=stop, nf=nf, **kw)
        torch.cuda.synchronize()
        s = part.view(x.shape[0], fold ** 2, groups, 2)[..., 0]
        assert torch.equal(o, ma.write_through(x, s, fold_h=fold, fold_w=fold))
        _, want = ma.mixer_block_ablate_plain(x, st, *args, stop=stop, nf=nf, groups=groups,
                                              assign=nf_asg if nf else asg, **kw)
        tol = (1e-5 if dt == torch.float32 else 1e-3) * want[..., 1]
        assert ((part - want).abs() <= tol[..., None]).all(), (stop, nf)
    assert ma.LAUNCHES["mixer_block_ablate"] == before + 11
