"""The serving forward's two kernels as PyTorch operators, so that PyTorch's
tracers (`torch.export`, graph capture) see one named op where the ctypes
launch of a hand-written kernel would be opaque:

  asy_vrnet::mixer_block  K2, the mixer half's inference forward
                          -> (out (B,H,W,C) in x's dtype, moments (B,2) f32)
  asy_vrnet::mlp_block    K1, the MLP half's inference forward -> out

The real implementation on CUDA tensors is the kernel's launch in
`ops/block.py` (`mixer_block_launch`, `mlp_block_launch`): the geometry, the
output allocations, the launch and its count in `block.LAUNCHES` and
`block.PATHS`.  So every call or replay of an exported program that runs the
op counts one launch, and tracing, which runs the fake, counts none.  On CPU
tensors the real implementation is the plain version (no count), which lets
`torch.library.opcheck` hold the fake against it on the CPU.  The fakes give the
outputs' shapes and dtypes only.

Importing the package registers both ops (`asy_vrnet_tpu_torch/__init__.py`),
so a program exported on the card loads in a fresh process.
"""
from __future__ import annotations

import torch

from asy_vrnet_tpu_torch.ops import block

# Defined with `torch.library.Library` and one implementation per dispatch
# key: a call then costs the dispatcher's hop into Python.  The same ops as
# `torch.library.custom_op`s, whose wrapper adds an autograd layer, cost
# about three times that hop (PERF.md §5, the dispatch measurement).
_LIB = torch.library.Library("asy_vrnet", "DEF")
_LIB.define("mixer_block(Tensor x, Tensor stats, Tensor wf, Tensor bf, Tensor wv, Tensor bv, "
            "Tensor w2, Tensor b2, Tensor alpha_beta, int heads, int fold_h, int fold_w, "
            "int proposal_h, int proposal_w) -> (Tensor, Tensor)")
_LIB.define("mlp_block(Tensor x, Tensor stats, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
            "-> Tensor")


def _geo(heads, fold_h, fold_w, proposal_h, proposal_w):
    return dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
                proposal_w=proposal_w)


def _mixer_cpu(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *geo):
    return block.mixer_block_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, **_geo(*geo))


def _mixer_cuda(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *geo):
    return block.mixer_block_launch(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, **_geo(*geo))


def _mixer_fake(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *geo):
    return torch.empty_like(x), x.new_empty((x.shape[0], 2), dtype=torch.float32)


_LIB.impl("mixer_block", _mixer_cpu, "CPU")
_LIB.impl("mixer_block", _mixer_cuda, "CUDA")
torch.library.register_fake("asy_vrnet::mixer_block", _mixer_fake, lib=_LIB)

_LIB.impl("mlp_block", block.mlp_block_plain, "CPU")
_LIB.impl("mlp_block", block.mlp_block_launch, "CUDA")
torch.library.register_fake("asy_vrnet::mlp_block",
                            lambda x, stats, w1, b1, w2, b2: torch.empty_like(x), lib=_LIB)
