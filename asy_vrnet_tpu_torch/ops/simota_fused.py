"""Batched SimOTA assignment (counterpart of
`asy_vrnet_tpu/ops/simota_pallas.py`): the hand-written CUDA kernel
(`csrc/simota_assign.cu`) on CUDA tensors, the plain twin
(`ops/simota.py::simota_assign`, one image at a time) on CPU tensors.

On a CUDA tensor the wrapper launches the kernel or raises; nothing falls
back.  The kernel reads the tensors where the loss has them (the
predictions as strided views of `decode_for_loss`'s f32 tensor, gt_classes
int32 or int64, gt_valid bool) and writes its results in their final types
into one buffer per call: the wrapper copies and casts nothing and runs
nothing on the device after the launches.  LAUNCHES counts wrapper calls
that launched the kernel (one call runs its three stages: prep, rows,
resolve).
"""
from __future__ import annotations

import functools
import math

import torch

from asy_vrnet_tpu_torch.ops.simota import SimOTAResult, simota_assign

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"simota_assign": 0}
# the lengths of the candidate lists the kernel's rows keep (the first that
# holds candidate_k; `rows_kernel` in the source): candidate_k is at most 16
LIST_LENGTHS = (4, 8, 12, 16)
MAX_CANDIDATE_K = LIST_LENGTHS[-1]


def list_length(candidate_k: int) -> int:
    """The length of the rows kernel's per-thread candidate lists at k."""
    return next(n for n in LIST_LENGTHS if n >= candidate_k)


def _plain_batched(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                   grids, strides, center_radius, candidate_k):
    """The plain twin over a batch -> (SimOTAResult with a leading batch
    dimension, dynamic_ks (B,G))."""
    per_image = [simota_assign(pred_boxes[i], cls_logits[i], obj_logits[i], gt_boxes[i],
                               gt_classes[i], gt_valid[i], grids, strides,
                               center_radius=center_radius, candidate_k=candidate_k,
                               return_dynamic_ks=True)
                 for i in range(pred_boxes.shape[0])]
    result = SimOTAResult(*(torch.stack(f) for f in zip(*(r for r, _ in per_image))))
    return result, torch.stack([d for _, d in per_image])


# the call's buffer, in order: (name, dtype, shape from (B, A, G, C)); the
# first _SCRATCH are the kernel's scratch, the rest its outputs
_SCRATCH = 4
_SECTIONS = (("fg_pre", torch.uint8, lambda b, a, g, c: (b, a)),
             ("cls_cost", torch.float32, lambda b, a, g, c: (b, c + 1, a)),
             ("picks", torch.int32, lambda b, a, g, c: (b, a, 2)),
             ("counts", torch.int32, lambda b, a, g, c: (b, 2)),
             ("dynamic_ks", torch.int32, lambda b, a, g, c: (b, g)),
             ("fg", torch.bool, lambda b, a, g, c: (b, a)),
             ("matched", torch.int64, lambda b, a, g, c: (b, a)),
             ("pred_iou", torch.float32, lambda b, a, g, c: (b, a)),
             ("num_fg", torch.float32, lambda b, a, g, c: (b,)))


@functools.lru_cache(maxsize=None)
def _layout(b, a, g, c):
    """(byte offset of each section (16-byte aligned), the buffer's bytes,
    and per output section (dtype, shape, contiguous strides, offset in
    elements of that dtype))."""
    offs, views, off = [], [], 0
    for i, (_, dt, shape) in enumerate(_SECTIONS):
        sh = shape(b, a, g, c)
        strides = tuple(math.prod(sh[j + 1:]) for j in range(len(sh)))
        offs.append(off)
        if i >= _SCRATCH:
            views.append((dt, sh, strides, off // dt.itemsize))
        off += -(-dt.itemsize * math.prod(sh) // 16) * 16
    return offs, off, views


def _kernel_batched(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                    grids, strides, center_radius, candidate_k):
    from asy_vrnet_tpu_torch.ops import kernels

    dev = pred_boxes.device
    b, a, c = cls_logits.shape
    g = gt_boxes.shape[1]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    got = [(t.device, t.shape, t.dtype) for t in (pred_boxes, cls_logits, obj_logits,
                                                  gt_boxes, gt_classes, gt_valid, grids,
                                                  strides)]
    want = [(dev, (b, a, 4), f32), (dev, (b, a, c), f32), (dev, (b, a), f32),
            (dev, (b, g, 4), f32), (dev, (b, g), gt_classes.dtype),
            (dev, (b, g), gt_valid.dtype), (dev, (a, 2), f32), (dev, (a,), f32)]
    if (got != want or gt_classes.dtype not in (i32, i64)
            or gt_valid.dtype not in (torch.bool, torch.uint8)
            or pred_boxes.stride(-1) != 1 or cls_logits.stride(-1) != 1
            or not all(t.is_contiguous() for t in (gt_boxes, gt_classes, gt_valid, grids,
                                                   strides))):
        raise ValueError(
            "simota_assign: the kernel takes f32 pred_boxes (B,A,4), cls_logits (B,A,C), "
            "obj_logits (B,A) (last dimension contiguous), contiguous f32 gt_boxes (B,G,4), "
            "gt_classes (B,G) int32|int64, gt_valid (B,G) bool|uint8, f32 grids (A,2) and "
            f"strides (A,), all on {dev}; got {got}")
    if not 1 <= candidate_k <= MAX_CANDIDATE_K:
        raise ValueError(f"simota_assign: candidate_k {candidate_k} outside "
                         f"1..{MAX_CANDIDATE_K}, the kernel's list lengths")
    offs, total, views = _layout(b, a, g, c)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    ptrs = [base + off for off in offs]
    kernels.simota_assign(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                          grids, strides, ptrs[:_SCRATCH], ptrs[_SCRATCH:],
                          center_radius=float(center_radius), candidate_k=int(candidate_k))
    LAUNCHES["simota_assign"] += 1
    typed = {dt: buf.view(dt) for dt in (i32, torch.bool, i64, f32)}
    dyn, fg, matched, pred_iou, num_fg = (typed[dt].as_strided(sh, st, off)
                                          for dt, sh, st, off in views)
    return SimOTAResult(fg, matched, pred_iou, num_fg), dyn


@torch.no_grad()
def simota_assign_batched(
    pred_boxes,     # (B, A, 4) cxcywh absolute
    cls_logits,     # (B, A, C)
    obj_logits,     # (B, A)
    gt_boxes,       # (B, G, 4)
    gt_classes,     # (B, G) int
    gt_valid,       # (B, G) bool
    grids,          # (A, 2)
    strides,        # (A,)
    center_radius: float = 2.5,
    candidate_k: int = 10,
    use_kernel: bool | None = None,
    return_dynamic_ks: bool = False,
):
    """Batched SimOTA -> SimOTAResult with (B, A) fields and num_fg (B,)
    [, dynamic_ks (B,G) int32].  `use_kernel=None` takes the kernel iff the
    tensors lie on a CUDA device (and then launches it or raises); False runs
    the plain twin image by image on whatever device holds the tensors; True
    on a CPU tensor raises, since a CUDA kernel cannot run there."""
    on_cuda = pred_boxes.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("simota_assign_batched: use_kernel=True needs CUDA tensors, "
                         f"got {pred_boxes.device}")
    run = _kernel_batched if use_kernel else _plain_batched
    result, dynamic_ks = run(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes,
                             gt_valid, grids, strides, center_radius, candidate_k)
    return (result, dynamic_ks) if return_dynamic_ks else result
