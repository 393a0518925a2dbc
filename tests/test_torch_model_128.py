"""Whole slice at 128x128 (see test_torch_model.py).  Here every backbone
stage and the p3/p4 neck blocks take the fused path (the port's plain twins
of the two kernels on the CPU); p5 still has 4-token regions."""
import pytest

from torch_parity import check_forward_and_boxes, fused_blocks, inputs, model_pair

SIZE = 128


@pytest.fixture(scope="module")
def pair():
    return model_pair(SIZE)


def test_forward_and_boxes_match_jax(pair):
    check_forward_and_boxes(*pair, SIZE)


def test_fused_blocks_at_128(pair):
    seen = fused_blocks(pair[2], *inputs(SIZE))
    assert seen == [True] * 8 + [False, True, True]
