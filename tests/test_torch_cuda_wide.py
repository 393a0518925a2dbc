"""The block kernels at the ClusterBlock shapes of ASY-VRNet phi l (width 1.0,
coc_small, 512^2) against their plain PyTorch twins, on the card: K1 on its
wide tensor-core kernels (160 < C <= 640) and K2 on its wide shared-memory
layout (the blocks whose base layout fits at no cluster split), batch 2.

Marked `cuda`; each test skips inside its fixture when no card is present:

    ASY_VRNET_TPU_TESTS=1 python -m pytest tests/test_torch_cuda_wide.py -m cuda

Tolerances (bf16, the main path), as in tests/test_torch_cuda.py and for
the same reasons:
  K1: out and z1 within 2 bf16 ulps of the twin's largest |value|.  Kernel
    and twin round xn and the GELU output to bf16 at the same points and
    sum in f32, in another order (the kernel adds fc1 in k-steps, or over
    four channel quarters past C = 320, and fc2 slice by slice), so a sum
    can round to the neighbouring bf16 value: one ulp at the output, and a
    hidden unit's ulp moves the output by far less than one.
  K2 on its base layout (l's stages 0-2 and p3): the assignment agrees on
    >= 99% of (token, head) pairs (a sum in another order flips near-ties),
    mean |diff| <= 2% of max |y| (y = out - x) and max |diff| <= max |y| +
    2 bf16 ulps (a flipped token takes another center).
  K2 on its wide layout (stage 3, p5, p4): these seeded inputs have no
    near-tie, so the assignment agrees on every pair, and the output then
    differs from the twin's only by the order of f32 sums before the one
    bf16 rounding of x + y: max |diff| within 2 bf16 ulps of max |out| (one
    ulp from that rounding, one for the sums), mean |diff| <= 1e-4 of max
    |y|.  A wrong peer's center, a wrong fc_v or fc2 column read from
    device memory or a center off by one moves whole tokens by a share of
    max |y|, far past both.
Two launches give the same bits, and K1 the same output with and without
z1.
"""
import numpy as np
import pytest
import torch

from asy_vrnet_tpu_torch.ops import block, kernels

pytestmark = pytest.mark.cuda

# (name, B, H, W, C, heads, head_dim, fold, hid): the 7 ClusterBlock shapes of
# phi l coc_small at 512^2 (backbone stages 0-3, then the neck's p5, p4, p3
# CoCConv blocks), batch 2
L_SHAPES = [
    ("l_stage0", 2, 128, 128, 64, 4, 32, 8, 512),
    ("l_stage1", 2, 64, 64, 128, 4, 32, 4, 1024),
    ("l_stage2", 2, 32, 32, 320, 8, 32, 2, 1280),
    ("l_stage3", 2, 16, 16, 512, 8, 32, 1, 2048),
    ("l_p5", 2, 16, 16, 512, 4, 24, 2, 2048),
    ("l_p4", 2, 32, 32, 640, 4, 24, 2, 2560),
    ("l_p3", 2, 64, 64, 256, 4, 24, 2, 1024),
]
# the shapes whose K2 base layout fits at no split of the heads
K2_WIDE = {"l_stage3", "l_p5", "l_p4"}


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


def _cast(ws, dev):
    return [w.to(dev, torch.bfloat16 if w.dim() == 2 else torch.float32).contiguous()
            for w in ws]


def _within_2_ulps(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert diff <= 2 * 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7), (diff, scale)
    return diff / scale


@pytest.mark.parametrize("shape", L_SHAPES, ids=[s[0] for s in L_SHAPES])
def test_l_mlp_kernel_matches_plain(dev, shape):
    name, b, h, w, c, heads, d, fold, hid = shape
    n, _, mlp = _weights(c, heads * d, hid, 21)
    x = n(b, h, w, c).to(dev, torch.bfloat16)
    st = block.gn1_stats(x)
    args = _cast(mlp, dev)
    tokens = kernels.mlp_tokens(x, args[0], args[2])
    key = f"mlp_block/wide{tokens}" if c > 160 else f"mlp_block/mma{tokens}"
    before = dict(block.PATHS)
    out = block.mlp_block(x, st, *args)
    again = block.mlp_block(x, st, *args)
    out_z, z1 = block.mlp_block(x, st, *args, return_z1=True)
    torch.cuda.synchronize()
    assert block.PATHS[key] == before[key] + 3
    assert block.PATHS["mlp_block/fma"] == before["mlp_block/fma"]
    assert torch.equal(out, again) and torch.equal(out, out_z)
    ref, zref = block.mlp_block_plain(x, st, *args, return_z1=True)
    _within_2_ulps(out, ref)
    _within_2_ulps(z1, zref)


# (B, H, W, C, hid): token counts that are no multiple of a CTA's (128 or
# 64) and hidden widths that are no multiple of a slice (64 or 32 units), on
# both wide kernels (128 tokens up to C = 320, 64 above)
RAGGED = [(1, 5, 7, 176, 712), (3, 3, 11, 320, 1288), (1, 1, 17, 352, 1400),
          (2, 3, 5, 512, 2056), (1, 9, 13, 640, 2568)]


@pytest.mark.parametrize("case", RAGGED, ids=[f"{b}x{h}x{w}x{c}" for b, h, w, c, _ in RAGGED])
def test_wide_mlp_ragged_shapes(dev, case):
    b, h, w, c, hid = case
    n, _, mlp = _weights(c, 32, hid, 23)
    x = n(b, h, w, c).to(dev, torch.bfloat16)
    st = block.gn1_stats(x)
    args = _cast(mlp, dev)
    key = f"mlp_block/wide{kernels.mlp_wide_tokens(c)}"
    before = block.PATHS[key]
    out = block.mlp_block(x, st, *args)
    out_z, z1 = block.mlp_block(x, st, *args, return_z1=True)
    torch.cuda.synchronize()
    assert block.PATHS[key] == before + 2
    assert torch.equal(out, out_z)
    ref, zref = block.mlp_block_plain(x, st, *args, return_z1=True)
    _within_2_ulps(out, ref)
    _within_2_ulps(z1, zref)


@pytest.mark.parametrize("shape", L_SHAPES, ids=[s[0] for s in L_SHAPES])
def test_l_mixer_kernel_matches_plain(dev, shape):
    name, b, h, w, c, heads, d, fold, hid = shape
    n, mixer, _ = _weights(c, heads * d, hid, 22)
    x = n(b, h, w, c).to(dev, torch.bfloat16)
    st = block.gn1_stats(x)
    args = _cast(mixer, dev)
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
    assert kernels.mixer_layout(x, heads * d, heads, fold, fold, 2, 2)[1] is (name in K2_WIDE)
    key = "mixer_block/tc_wide" if name in K2_WIDE else "mixer_block/tc"
    before = dict(block.PATHS)
    out, mom, asg = block.mixer_block(x, st, *args, return_assign=True, **kw)
    out2, mom2, pack = block.mixer_block(x, st, *args, return_residuals=True, **kw)
    torch.cuda.synchronize()
    assert block.PATHS[key] == before[key] + 2
    assert torch.equal(out, out2) and torch.equal(mom, mom2)
    assert torch.equal(asg, pack[1].permute(0, 3, 1, 2).long())
    ref, rmom, rasg = block.mixer_block_plain(x, st, *args, return_assign=True, **kw)
    diff = (out.float() - ref.float()).abs()
    ymax = (ref.float() - x.float()).abs().max().item()
    ulp = 2.0 ** (torch.log2(ref.float().abs().max()).floor().item() - 7)
    if name in K2_WIDE:
        assert torch.equal(asg, rasg)
        assert diff.mean().item() <= 1e-4 * ymax, (diff.mean().item(), ymax)
        assert diff.max().item() <= 2 * ulp, (diff.max().item(), ulp)
    else:
        assert (asg == rasg).float().mean().item() >= 0.99
        assert diff.mean().item() <= 0.02 * ymax
        assert diff.max().item() <= ymax + 2 * ulp
    # the moments are those of the stored output
    o = out.float().reshape(b, -1)
    torch.testing.assert_close(mom, torch.stack([o.sum(1), (o * o).sum(1)], 1),
                               rtol=1e-4, atol=1e-2)


def test_l_wide_kernels_fit_their_ctas_an_sm(dev):
    """Both wide K1 kernels fit one 512-thread CTA an SM at every width,
    within the 128 registers a thread that leaves; K2's wide layout fits
    every wide block."""
    for c in (176, 256, 320, 336, 352, 512, 640):
        info = kernels.mlp_block_info(c, kernels.mlp_wide_tokens(c), dev)
        assert info["ctas_per_sm"] == 1, (c, info)
        assert info["registers"] <= 128, (c, info)
    for name, b, h, w, c, heads, d, fold, hid in L_SHAPES:
        x = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
        g = kernels.mixer_groups(x, heads * d, heads, fold, fold, 2, 2)
        info = kernels.mixer_block_info(torch.bfloat16, c, heads * d, heads,
                                        (h // fold, w // fold), 2, 2, g, dev)
        assert info["ctas_per_sm"] >= 1, (name, g, info)
