"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`; each test skips inside its fixture when no card is present
(never at import, so every pytest worker collects the same tests).  This file
imports no JAX, so it also runs on a machine without it:

    ASY_VRNET_TPU_TESTS=1 python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances:
  f32 instantiation: atol 1e-4 relative to the output scale.  Same formula,
    f32 everywhere, sums in another order; assignments must agree on >=
    99.99% of (token, head) pairs (ties only at f32 rounding).
  bf16 (the main path): the kernel rounds intermediates to bf16 where the
    TPU kernel does, the plain twin where the JAX package's module reference
    does, so near-tied assignments flip.  Agreement >= 99%, mean |diff| <=
    2% of max |y| (y = out - x), max |diff| <= max |y| + 2 bf16 ulps; the MLP
    half (no assignments) within 2 bf16 ulps of max |out|.
"""
import pytest
import torch

from asy_vrnet_tpu_torch.ops import block

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
