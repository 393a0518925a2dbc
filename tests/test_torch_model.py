"""Whole slice at 64x64: the port's f32 forward, decode and NMS against the
JAX package (coc_dryrun, fused Pallas path in interpret mode, literal
pre-stem).  At 64x64 every backbone stage and the p4/p5 neck blocks have
regions of 4 tokens, so they take the module path in both packages; only the
p3 neck block is fused."""
import pytest

from torch_parity import check_forward_and_boxes, fused_blocks, inputs, model_pair

SIZE = 64


@pytest.fixture(scope="module")
def pair():
    return model_pair(SIZE)


def test_forward_and_boxes_match_jax(pair):
    check_forward_and_boxes(*pair, SIZE)


def test_fused_blocks_at_64(pair):
    seen = fused_blocks(pair[2], *inputs(SIZE))
    # 8 backbone blocks (image + radar, 4 stages) then p5, p4, p3
    assert seen == [False] * 8 + [False, False, True]
