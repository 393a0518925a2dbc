"""Build, load and launch the CUDA kernels in `asy_vrnet_tpu_torch/csrc/`.

Nine sources: the two fused ClusterBlock halves (mixer_block, with the
prefixes of its body that the ablation tool times; mlp_block) and
their backward passes (mixer_block_bwd, with both bodies K6 and K6r;
mlp_block_bwd), K1 and K5 with their z1 variants, the stand-alone
cluster mix and its backward (cluster_mix, cluster_mix_bwd), the fused
seg-loss forward and backward (seg_loss_sums, seg_loss_dlogits) and SimOTA
(simota_assign).  Each source is compiled by nvcc into a shared
library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`),
loaded with ctypes, at first use; all sources build in parallel.  Libraries
land in
`asy_vrnet_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
sources and flags, so an edit rebuilds.  `-Xptxas -v` output (registers,
shared memory, spills) is kept beside each library.

Launches go on the current stream; each C entry returns cudaGetLastError()
and a nonzero code raises here.  Nothing here is imported by the CPU path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("mixer_block", "mlp_block", "mixer_block_bwd", "mlp_block_bwd",
           "cluster_mix", "cluster_mix_bwd", "seg_loss_sums", "seg_loss_dlogits",
           "simota_assign")
HEADERS = ("common.cuh", "mixer_block.cuh", "cluster_mix.cuh", "seg_loss.cuh",
           "mlp_block_bwd_geometry.h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# SimOTA's results hang on exact ties between costs, so its source is built
# without FMA contraction: every multiply and add rounds as in the plain
# PyTorch version it is held against.
EXTRA_FLAGS = {"simota_assign": ("-fmad=false",)}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGS = {
    "mixer_block": [_P] * 15 + [_I] * 12 + [_P],
    "mlp_block": [_P] * 8 + [_I] * 5 + [_P],
    "mixer_block_bwd": [_P] * 21 + [_I] * 13 + [_P],
    "mlp_block_bwd": [_P] * 9 + [_I] * 8 + [_P],
    "cluster_mix": [_P] * 6 + [_I] * 10 + [_P],
    "cluster_mix_bwd": [_P] * 9 + [_I] * 10 + [_P],
    "seg_loss_sums": [_P] * 4 + [_I] * 2 + [_F] * 3 + [_I] * 2 + [_F] * 4 + [_I] * 2 + [_P],
    "seg_loss_dlogits": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_I] * 2 + [_F] * 2 + [_I] * 2 + [_P],
    "simota_assign": [_P] * 3 + [_LL] * 6 + [_P, _P, _I] + [_P] * 12 + [_I] * 4 + [_F, _I, _P],
}
# element types each source is instantiated for (entry = "<source>_<suffix>")
_SUFFIXES = {"simota_assign": ("f32",)}
# further entries of a library: name -> (argument types, result type)
_EXTRA = {"mixer_block_bwd": {"mixer_block_bwd_groups": ([_I] * 8, _I),
                              "mixer_block_bwd_info": ([_I] * 8 + [_P], _I)},
          "mixer_block": {**{f"mixer_block_ablate_{t}": ([_P] * 12 + [_I] * 14 + [_P] * 2, _I)
                             for t in ("bf16", "f32")},
                          "mixer_block_groups": ([_I] * 9 + [_P], _I),
                          "mixer_block_info": ([_I] * 9 + [_P], _I)},
          "mlp_block": {"mlp_block_info": ([_I] * 2 + [_P], _I)},
          "mlp_block_bwd": {"mlp_block_bwd_info": ([_I] * 10 + [_P], _I),
                            "mlp_block_bwd_geometry": ([_I] * 4 + [_P], _I)},
          "cluster_mix": {"cluster_mix_info": ([_I] * 10 + [_P], _I)},
          "cluster_mix_bwd": {"cluster_mix_bwd_info": ([_I] * 10 + [_P], _I)},
          "seg_loss_sums": {"seg_loss_sums_info": ([_I] * 3 + [_P], _I)},
          "seg_loss_dlogits": {"seg_loss_dlogits_info": ([_I] * 3 + [_P], _I)}}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in (f"{name}.cu", *HEADERS):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources (in parallel, one nvcc each) unless already
    built; returns {name: library path}.  Raises with nvcc's output on error."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(n), "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(paths[n][:-3] + ".ptxas.txt", "w") as fh:
            fh.write(log)
        if proc.returncode:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report(name: str) -> str:
    """nvcc -Xptxas -v output of the last build of `name` (may be empty if the
    library was built by an earlier process and its log is gone)."""
    log = _lib_path(name)[:-3] + ".ptxas.txt"
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build((name,))[name])
            for suffix in _SUFFIXES.get(name, ("bf16", "f32")):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = _SIGS[name]
                fn.restype = _I
            for entry, (args, res) in _EXTRA.get(name, {}).items():
                getattr(lib, entry).argtypes = args
                getattr(lib, entry).restype = res
            lib.asy_cuda_error_string.argtypes = [_I]
            lib.asy_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry(name: str, entry: str | None, bf16: bool):
    """(library, C function) of `<entry>_<bf16|f32>` (built at first use)."""
    lib = load(name)
    return lib, getattr(lib, f"{entry or name}_{'bf16' if bf16 else 'f32'}")


def _call(name: str, x: torch.Tensor, *args, entry: str | None = None) -> None:
    """Launch `<entry>_<bf16|f32>` (entry defaults to the source's name) of
    library `name` on x's device and current stream; raises on an error."""
    lib, fn = _entry(name, entry, x.dtype == torch.bfloat16)
    # the raw stream handle: `current_stream().cuda_stream` builds a Stream
    # object first, host time on every launch
    index = x.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        msg = lib.asy_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry or name} kernel launch failed: {msg} (code {err})")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mixer_cluster_size(heads: int, regions: int, device: torch.device,
                       fill: float = 1.0) -> int:
    """CTAs per region (one thread-block cluster, split by heads).  Splitting
    pays only when the batch has fewer regions than `fill` times the card's
    SMs (every CTA of a cluster re-reads its whole region): then the smallest
    divisor of `heads` (at most 8, the portable cluster size) that gives that
    many blocks, or the largest such divisor."""
    return cluster_divisor(heads, regions, _sms(device), fill)


def cluster_divisor(heads: int, regions: int, sms: int, fill: float = 1.0) -> int:
    """`mixer_cluster_size` for a card of `sms` SMs."""
    divisors = [d for d in range(1, 9) if heads % d == 0]
    return next((d for d in divisors if regions * d >= fill * sms), divisors[-1])


def mixer_feat_on_tensor_cores(c: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether K2 runs its feat product on tensor cores (`feat_chunk_mma` in
    csrc/mixer_block.cuh), and K6/K6r their feat, dxn-share and dWf
    products: bf16, C a multiple of 16 (the k-steps) and the head width a
    multiple of 8 (so every head grouping's columns are whole n-tiles, and
    K6/K6r, grouped otherwise, take the same path).  Else the CUDA-core FMA
    path.  `asy::mix::feat_on_tc` makes the choice in the kernels; K2, K6
    and K6r refuse a launch whose `tc` differs from it."""
    return dtype == torch.bfloat16 and c % 16 == 0 and head_dim % 8 == 0


def mixer_groups(x: torch.Tensor, inner: int, heads: int, fold_h: int, fold_w: int,
                 proposal_h: int, proposal_w: int) -> int:
    """CTAs per region of K2 on x (B, H, W, C): `mixer_layout`'s G."""
    return mixer_layout(x, inner, heads, fold_h, fold_w, proposal_h, proposal_w)[0]


def mixer_layout(x: torch.Tensor, inner: int, heads: int, fold_h: int, fold_w: int,
                 proposal_h: int, proposal_w: int) -> tuple[int, bool]:
    """K2's geometry on x (B, H, W, C): (G, wide).  G, the CTAs per region,
    is `mixer_cluster_size`'s choice, raised to the next divisor of `heads`
    while the block does not fit in shared memory; where no split fits the
    base layout, the same on the wide layout (fc_v and fc2 read from device
    memory, two chunk buffers, the centers read from their owners;
    csrc/mixer_block.cu), and `wide` says so.  Raises if none fits."""
    b, h, w, c = x.shape
    return _mixer_groups(x.element_size(), c, inner, heads, h // fold_h, w // fold_w,
                         proposal_h, proposal_w, b * fold_h * fold_w, x.device)


@functools.lru_cache(maxsize=None)
def _mixer_groups(esz, c, inner, heads, rh, rw, proposal_h, proposal_w, regions, device):
    least = mixer_cluster_size(heads, regions, device)
    wide = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(device):
        g = load("mixer_block").mixer_block_groups(esz, c, inner, heads, rh, rw, proposal_h,
                                                   proposal_w, least, wide.data_ptr())
    if g < 1:
        raise RuntimeError(f"mixer_block: no split of C={c}, I={inner}, heads={heads} over "
                           f"a cluster fits in shared memory")
    return g, bool(wide.item())


def mixer_block_info(dtype, c, inner, heads, region_hw, proposal_h, proposal_w, groups,
                     device) -> dict:
    """K2 as launched with `groups` CTAs per region: its dynamic shared
    memory (bytes), CTAs per SM and registers per thread."""
    out = torch.zeros(3, dtype=torch.int32)
    with torch.cuda.device(device):
        err = load("mixer_block").mixer_block_info(
            torch.empty((), dtype=dtype).element_size(), c, inner, heads, *region_hw,
            proposal_h, proposal_w, groups, out.data_ptr())
    if err:
        raise RuntimeError(f"mixer_block_info: code {err}")
    return dict(zip(("smem_bytes", "ctas_per_sm", "registers"), out.tolist()))


def mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out, part, assign,
                pack, *, heads, fold_h, fold_w, proposal_h, proposal_w, tc) -> None:
    """Launch the mixer-half kernel; tensors are checked by the caller.
    `part` is (B, fold_h * fold_w * G, 2) with G = part.shape[1] // (fold_h *
    fold_w) CTAs per region (see mixer_groups).  `assign` (int8) and `pack`
    (cbest, assign, c_rep, oc) may be None; `tc`: whether feat runs on
    tensor cores (mixer_feat_on_tensor_cores), which the kernel confirms: it
    refuses a `tc` other than its own choice."""
    b, h, w, c = x.shape
    cbest, _, crep, oc = pack if pack is not None else (None,) * 4
    _call("mixer_block", x, _ptr(x), _ptr(stats), _ptr(wf), _ptr(bf), _ptr(wv),
          _ptr(bv), _ptr(w2), _ptr(b2), _ptr(alpha_beta), _ptr(out), _ptr(part),
          _ptr(assign), _ptr(cbest), _ptr(crep), _ptr(oc), b, h, w, c, wf.shape[1],
          heads, fold_h, fold_w, proposal_h, proposal_w,
          part.shape[1] // (fold_h * fold_w), int(tc))


def mixer_block_ablate(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out, part, assign,
                       occupancy, *, heads, fold_h, fold_w, proposal_h, proposal_w, groups,
                       tc, stop, nf) -> None:
    """Launch one prefix of the mixer-half kernel (`stop` a code of
    ops/mixer_ablate.py, `nf` the normalise-first variant); tensors are
    checked by the caller.  `part` is (B, fold_h * fold_w * groups, 2) f32;
    `assign` (int8, may be None) receives a full prefix's assignment;
    `occupancy` a 2-int32 host tensor that receives (the prefix's CTAs per SM
    as launched, K2's)."""
    b, h, w, c = x.shape
    _call("mixer_block", x, _ptr(x), _ptr(stats), _ptr(wf), _ptr(bf), _ptr(wv), _ptr(bv),
          _ptr(w2), _ptr(b2), _ptr(alpha_beta), _ptr(out), _ptr(part), _ptr(assign), b, h,
          w, c, wf.shape[1], heads, fold_h, fold_w, proposal_h, proposal_w, groups, int(tc),
          stop, int(nf), _ptr(occupancy), entry="mixer_block_ablate")


# The MLP backward (K5).  Its cluster path (bf16, C % 16 == 0 up to 160,
# hid % 32 == 0, H*W % 64 == 0, where a rank fits) cuts the tokens into
# tiles of 64 or 128 and the hidden width into slices of 32 over the CTAs of
# a thread-block cluster; csrc/mlp_block_bwd_geometry.h decides both.
# Otherwise the FMA path: one block per chunk of a sample, its f32 dxn
# (tokens x C) in shared memory, at most this many floats.  Mirrors `launch`
# in csrc/mlp_block_bwd.cu.
_MLP_BWD_CHUNK_FLOATS = 16384
_MLP_BWD_SUB = 32
# tokens per thread of the mixer backward's epilogue (kEpiRows in the source)
_MIXER_BWD_EPI_ROWS = 8


def mlp_bwd_chunks(hw: int, c: int, hid: int, dtype: torch.dtype) -> int:
    """Blocks per sample of the MLP backward's FMA path (each takes
    ceil(hw/chunks) tokens of one sample)."""
    tt = max(_MLP_BWD_SUB, (_MLP_BWD_CHUNK_FLOATS // c) // _MLP_BWD_SUB * _MLP_BWD_SUB)
    return -(-hw // tt)


def mlp_bwd_launch(b: int, hw: int, c: int, hid: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    """How K5 launches on this card.  Cluster path (bf16 at the shapes
    csrc/mlp_block_bwd_geometry.h takes, which also picks the launch):
    `cluster` CTAs a cluster, `clusters` clusters, `tile` tokens a tile and
    `row_floats` floats of partials a cluster writes, `chunks` 0.  FMA path:
    `chunks` blocks per sample, `cluster` 0.  Cached by shape: the train
    step asks 27 times."""
    return _mlp_bwd_launch(b, hw, c, hid, dtype, device)


@functools.lru_cache(maxsize=None)
def _mlp_bwd_launch(b, hw, c, hid, dtype, device):
    if dtype == torch.bfloat16:
        out = torch.zeros(3, dtype=torch.int32)
        with torch.cuda.device(device):
            err = load("mlp_block_bwd").mlp_block_bwd_geometry(b, hw, c, hid, out.data_ptr())
        if err:
            raise RuntimeError(f"mlp_block_bwd_geometry: code {err}")
        cs, ncl, tile = out.tolist()
        if cs:
            return dict(chunks=0, cluster=cs, clusters=ncl, tile=tile,
                        row_floats=2 * c * hid + hid + c + 2 * b)
    return dict(chunks=mlp_bwd_chunks(hw, c, hid, dtype), cluster=0, clusters=0, tile=0)


def mixer_bwd_groups(c: int, inner: int, heads: int, regions: int, proposal_h: int,
                     proposal_w: int, remat: bool, device: torch.device,
                     dtype: torch.dtype) -> int:
    """Head groups per region of the mixer backward (K6, or K6r with
    `remat`) on `dtype` operands: each keeps an f32 dxn plane, so it fills
    only half the SMs (`mixer_cluster_size`) before it splits a region
    further; more groups where a block would not fit in shared memory.
    Raises if none fits.  Cached by shape: the train step asks 27 times."""
    return _mixer_bwd_groups(dtype.itemsize, c, inner, heads,
                             regions, proposal_h, proposal_w, bool(remat), device)


@functools.lru_cache(maxsize=None)
def _mixer_bwd_groups(esz, c, inner, heads, regions, proposal_h, proposal_w, remat, device):
    least = mixer_cluster_size(heads, regions, device, fill=0.5)
    with torch.cuda.device(device):
        g = load("mixer_block_bwd").mixer_block_bwd_groups(
            esz, c, inner, heads, proposal_h, proposal_w, least, int(remat))
    if g < 1:
        raise RuntimeError(f"mixer_block_bwd: no head grouping of C={c}, I={inner}, "
                           f"heads={heads} fits in shared memory")
    return g


def mixer_block_bwd_info(dtype, c, inner, heads, proposal_h, proposal_w, groups, remat,
                         device) -> dict:
    """The mixer backward's main kernel (K6, or K6r with `remat`) as launched
    with `groups` head groups: its dynamic shared memory (bytes), CTAs per
    SM, registers and threads per CTA."""
    out = torch.zeros(4, dtype=torch.int32)
    with torch.cuda.device(device):
        err = load("mixer_block_bwd").mixer_block_bwd_info(
            torch.empty((), dtype=dtype).element_size(), c, inner, heads, proposal_h,
            proposal_w, groups, int(remat), out.data_ptr())
    if err:
        raise RuntimeError(f"mixer_block_bwd_info: code {err}")
    return dict(zip(("smem_bytes", "ctas_per_sm", "registers", "threads"), out.tolist()))


def mixer_bwd_epi_tile(c: int) -> int:
    """Tokens per epilogue block of the mixer backward: 8 for each of the
    256 // c threads that share a channel (`epi_tile` in the source)."""
    return _MIXER_BWD_EPI_ROWS * max(1, 256 // c)


def mixer_bwd_tiles(hw: int, c: int) -> int:
    """Epilogue blocks per sample of the mixer backward."""
    return -(-hw // mixer_bwd_epi_tile(c))


def mlp_block_bwd(x, g, stats, w1, b1, w2, z1, dxn, part, *, chunks, cluster, clusters,
                  tile) -> None:
    """Launch the MLP-half backward kernel (reading z1 unless it is None);
    tensors are checked by the caller (16-byte aligned on the cluster
    path).  Cluster path (`cluster` > 0, `chunks` 0, `tile` tokens a tile):
    `part` (clusters, 2*C*hid + hid + C + 2*B) f32, one row per cluster
    ending in the per-sample GroupNorm sums.  FMA path (`cluster` 0):
    `part` (B * chunks, 2*C*hid + hid + C + 2).  The kernel refuses a
    `cluster` that names the path its shape does not take."""
    b, h, w, c = x.shape
    _call("mlp_block_bwd", x, _ptr(x), _ptr(g), _ptr(stats), _ptr(w1), _ptr(b1),
          _ptr(w2), _ptr(z1), _ptr(dxn), _ptr(part), b, h * w, c, w1.shape[1], chunks, cluster,
          clusters, tile)


def mlp_block_bwd_info(dtype, b, hw, c, hid, z1, device) -> dict:
    """K5 as a launch at (B, H*W, C, hid) takes it (`z1`: its z1 variant):
    its CTAs, cluster size, partial-row bytes, dynamic shared memory
    (bytes), CTAs per SM, registers, threads per CTA and the clusters the
    card holds at once (0 on the FMA path)."""
    geo = mlp_bwd_launch(b, hw, c, hid, dtype, device)
    out = torch.zeros(5, dtype=torch.int32)
    with torch.cuda.device(device):
        err = load("mlp_block_bwd").mlp_block_bwd_info(
            torch.empty((), dtype=dtype).element_size(), b, hw, c, hid, geo["chunks"],
            geo["cluster"], geo["clusters"], geo["tile"], int(z1), out.data_ptr())
    if err:
        raise RuntimeError(f"mlp_block_bwd_info: code {err}")
    if geo["cluster"]:
        ctas, rows = geo["clusters"] * geo["cluster"], geo["clusters"] * geo["row_floats"]
    else:
        ctas, rows = b * geo["chunks"], b * geo["chunks"] * (2 * c * hid + hid + c + 2)
    return dict(ctas=ctas, cluster=geo["cluster"], tile=geo["tile"], part_bytes=4 * rows,
                **dict(zip(("smem_bytes", "ctas_per_sm", "registers", "threads",
                            "active_clusters"), out.tolist())))


def mixer_block_bwd(x, g, stats, wf, bf, wv, bv, w2, alpha_beta, pack, dxn, scratch,
                    dcin, wpart, dab, epart, assign, win, *, groups, tiles, tc, heads,
                    fold_h, fold_w, proposal_h, proposal_w) -> None:
    """Launch the two mixer-half backward kernels (per region and head group,
    then the dxn epilogue): K6 with the residual `pack` (`assign`, `win`
    None), K6r with None: it writes the assignment it rebuilds to `assign`
    (B, H, W, heads) int8 and the winners' (cosine, raw product) to `win`
    (B, H, W, heads, 2) f32, which its second sweep reads back.  `tc`:
    whether the products run on tensor cores (mixer_feat_on_tensor_cores),
    which the kernel confirms: it refuses a `tc` other than its own choice.
    Tensors are checked by the caller."""
    b, h, w, c = x.shape
    cbest, argf, crep, oc = pack if pack is not None else (None,) * 4
    _call("mixer_block_bwd", x, _ptr(x), _ptr(g), _ptr(stats), _ptr(wf), _ptr(bf),
          _ptr(wv), _ptr(bv), _ptr(w2), _ptr(alpha_beta), _ptr(cbest), _ptr(argf),
          _ptr(crep), _ptr(oc), _ptr(dxn), _ptr(scratch), _ptr(dcin), _ptr(wpart),
          _ptr(dab), _ptr(epart), _ptr(assign), _ptr(win), b, h, w, c, wf.shape[1], heads,
          fold_h, fold_w, proposal_h, proposal_w, groups, tiles, int(tc))


# K1's tensor-core path: tokens per CTA, widest first (4 warps a CTA; with
# fewer than 64 tokens they split the hidden units)
MLP_TOKENS = (64, 32, 16)
# its accumulators' widest C; past it, up to MLP_WIDE_MAX_C, the wide
# tensor-core kernels (16 warps over 128 tokens a CTA up to MLP_WIDE128_MAX_C,
# 64 above)
MLP_MMA_MAX_C, MLP_WIDE_MAX_C, MLP_WIDE128_MAX_C = 160, 640, 320


def mlp_mma_shape(c: int, hid: int, dtype: torch.dtype) -> bool:
    """Whether K1 takes a tensor-core path at this width (the operands
    must also be 16-byte aligned): bf16, C a multiple of 16 up to 640,
    hid a multiple of 8; past C = 160 a wide kernel (`mlp_wide`).  Else
    the CUDA-core path."""
    return (dtype == torch.bfloat16 and c % 16 == 0 and c <= MLP_WIDE_MAX_C
            and hid % 8 == 0)


def mlp_wide(c: int) -> bool:
    """Whether a tensor-core shape of width c (`mlp_mma_shape`) runs on a
    wide kernel."""
    return c > MLP_MMA_MAX_C


def mlp_wide_tokens(c: int) -> int:
    """Tokens per CTA of the wide kernel at width c: 128 up to C = 320 (xn
    of 128 tokens and a slice of 64 hidden units fit in shared memory), 64
    above."""
    return 128 if c <= MLP_WIDE128_MAX_C else 64


def mlp_tokens_per_cta(ntok: int, sms: int) -> int:
    """Tokens per CTA of K1's tensor-core path: the most (of 64, 32, 16) that
    still give at least one CTA per SM, else 16 (a grid that cannot cover
    the card is as wide as it can be).  A CTA is 4 warps either way: 16
    tokens a warp at 64, the hidden units split over 2 or 4 warps below."""
    return next((t for t in MLP_TOKENS if -(-ntok // t) >= sms), MLP_TOKENS[-1])


def mlp_tokens(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> int:
    """K1's tokens per CTA for these operands (`mlp_wide_tokens` on the wide
    kernels), 0 for the CUDA-core path."""
    if (x.data_ptr() | w1.data_ptr() | w2.data_ptr()) % 16:
        return 0
    b, h, w, c = x.shape
    return _mlp_tokens(b * h * w, c, w1.shape[1], x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _mlp_tokens(ntok, c, hid, dtype, device):
    if not mlp_mma_shape(c, hid, dtype):
        return 0
    return mlp_wide_tokens(c) if mlp_wide(c) else mlp_tokens_per_cta(ntok, _sms(device))


def mlp_block_info(c: int, tokens: int, device) -> dict:
    """K1's tensor-core kernel at width c with `tokens` per CTA (past C =
    160 the wide one, with `mlp_wide_tokens(c)`): its dynamic shared memory
    (bytes), CTAs per SM and registers per thread."""
    out = torch.zeros(3, dtype=torch.int32)
    with torch.cuda.device(device):
        err = load("mlp_block").mlp_block_info(c, tokens, out.data_ptr())
    if err:
        raise RuntimeError(f"mlp_block_info: code {err}")
    return dict(zip(("smem_bytes", "ctas_per_sm", "registers"), out.tolist()))


def mlp_block(x, stats, w1, b1, w2, b2, out, z1, tokens) -> None:
    """Launch the MLP-half kernel (also writing z1 unless it is None) with
    `tokens` per CTA on its tensor-core path, 0 for its CUDA-core path (see
    mlp_tokens; the kernel refuses a `tokens` that names the path it does
    not take); tensors are checked by the caller."""
    b, h, w, c = x.shape
    _call("mlp_block", x, _ptr(x), _ptr(stats), _ptr(w1), _ptr(b1), _ptr(w2),
          _ptr(b2), _ptr(out), _ptr(z1), b, h * w, c, w1.shape[1], tokens)


# the fast instantiation of K7/K7b (csrc/cluster_mix.cuh::fast_path): the
# head width it holds in registers (4 channels a lane, 8 lanes a token) and
# the most proposals whose cosines it forms at once
CLUSTER_FAST_D, CLUSTER_FAST_M = 32, 4


def cluster_mix_fast(head_dim: int, proposals: int) -> bool:
    """Whether K7 and K7b take their fast instantiation at this head width
    and proposal count, else the general one (any D, any M).  Both kernels
    refuse a `fast` that differs from their own reading."""
    return head_dim == CLUSTER_FAST_D and proposals <= CLUSTER_FAST_M


def cluster_mix(feat, value, alpha_beta, out, assign, *, heads, fold_h, fold_w,
                proposal_h, proposal_w, fast, centers=None) -> None:
    """Launch the cluster mix forward (K7); tensors are checked by the
    caller (16-byte aligned on the fast path).  `assign` (B, H, W, heads)
    int8 may be None; `centers` (B, heads, fold_h * fold_w, proposal_h *
    proposal_w, head_dim) f32, where given, receives the mixed centers
    (the bits K7b computes: csrc/cluster_mix.cuh::mixed_centers)."""
    b, h, w, c = feat.shape
    _call("cluster_mix", feat, _ptr(feat), _ptr(value), _ptr(alpha_beta), _ptr(out),
          _ptr(assign), _ptr(centers), b, h, w, c, heads, fold_h, fold_w, proposal_h,
          proposal_w, int(fast))


def cluster_mix_bwd(feat, value, g, alpha_beta, dx, dv, dab, assign, *, heads, fold_h,
                    fold_w, proposal_h, proposal_w, fast, centers=None) -> None:
    """Launch the cluster mix backward (K7b); tensors are checked by the
    caller (16-byte aligned on the fast path).  `dab` is (B * heads *
    fold_h * fold_w, 2) f32, one row of [d alpha, d beta] partials per
    block; `assign` and `centers` (as `cluster_mix`'s) may be None."""
    b, h, w, c = feat.shape
    _call("cluster_mix_bwd", feat, _ptr(feat), _ptr(value), _ptr(g), _ptr(alpha_beta),
          _ptr(dx), _ptr(dv), _ptr(dab), _ptr(assign), _ptr(centers), b, h, w, c, heads,
          fold_h, fold_w, proposal_h, proposal_w, int(fast))


def cluster_mix_info(dtype, shape, *, heads, fold_h, fold_w, proposal_h, proposal_w,
                     backward, device) -> dict:
    """K7 (or K7b with `backward`) as a launch on a (B, H, W, C) feat takes
    it: its CTAs, dynamic shared memory (bytes), CTAs per SM, registers,
    threads per CTA, whether it takes the fast instantiation and whether
    its tiles are staged in shared memory."""
    name = "cluster_mix_bwd" if backward else "cluster_mix"
    b, h, w, c = shape
    out = torch.zeros(6, dtype=torch.int32)
    with torch.cuda.device(device):
        err = getattr(load(name), f"{name}_info")(
            torch.empty((), dtype=dtype).element_size(), b, h, w, c, heads, fold_h, fold_w,
            proposal_h, proposal_w, out.data_ptr())
    if err:
        raise RuntimeError(f"{name}_info: code {err}")
    vals = out.tolist()
    return dict(ctas=b * heads * fold_h * fold_w, **dict(zip(
        ("smem_bytes", "ctas_per_sm", "registers", "threads"), vals[:4])),
        fast=bool(vals[4]), staged=bool(vals[5]))


# The seg-loss kernels (csrc/seg_loss.cuh): tiles of one pixel a thread
# streamed through a ring of 2 to 4 slots.  K4b: CTAs of SEG_TILE threads
# with a ring of at most SEG_RING_BYTES, SEG_CTAS_PER_SM[logits' itemsize]
# of them an SM (the fastest of 1-4 on an H100: more for the lighter bf16
# tiles).  K4: one CTA an SM, of SEG_WIDE threads with a ring of at most
# SEG_WIDE_RING_BYTES at C = 9, of SEG_TILE threads on the generic path.
SEG_TILE, SEG_RING_BYTES, SEG_STAGES = 256, 64 << 10, (2, 4)
SEG_WIDE, SEG_WIDE_RING_BYTES = 768, 96 << 10
SEG_CTAS_PER_SM = {2: 3, 4: 2}


def seg_sums_threads(c: int) -> int:
    """Threads of a K4 CTA (and pixels of its tiles) for C classes."""
    return SEG_WIDE if c == 9 else SEG_TILE


def seg_ring_stages(c: int, itemsize: int, tile: int = SEG_TILE,
                    budget: int = SEG_RING_BYTES) -> int:
    """Ring slots of a seg-loss kernel for C classes of `itemsize`-byte
    logits in tiles of `tile` pixels: as many slots (a tile's logits and
    targets) as fit in `budget` bytes, between 2 and 4 (`ring_stages` in
    the source)."""
    lo, hi = SEG_STAGES
    return max(lo, min(hi, budget // (tile * (c * itemsize + 4))))


def seg_grid(backward: bool, npix: int, c: int, itemsize: int, sms: int) -> int:
    """CTAs of a seg-loss launch over `npix` pixels on a card of `sms` SMs
    (persistent: no more than there are tiles): K4b SEG_CTAS_PER_SM an SM,
    K4 one."""
    if backward:
        return max(1, min(-(-npix // SEG_TILE), SEG_CTAS_PER_SM[itemsize] * sms))
    return max(1, min(-(-npix // seg_sums_threads(c)), sms))


def seg_loss_blocks(backward: bool, npix: int, c: int, itemsize: int,
                    device: torch.device) -> int:
    """`seg_grid` on this card (its SM count cached)."""
    return seg_grid(backward, npix, c, itemsize, _sms(device))


def seg_loss_info(backward: bool, dtype: torch.dtype, c: int, round_bf16: bool,
                  device) -> dict:
    """The seg-loss forward (or backward) kernel for C classes of `dtype`
    logits: its dynamic shared memory (bytes), CTAs per SM, registers, ring
    slots and threads per CTA."""
    name = "seg_loss_dlogits" if backward else "seg_loss_sums"
    out = torch.zeros(5, dtype=torch.int32)
    with torch.cuda.device(device):
        err = getattr(load(name), f"{name}_info")(
            torch.empty((), dtype=dtype).element_size(), c, int(round_bf16), out.data_ptr())
    if err:
        raise RuntimeError(f"{name}_info: code {err}")
    return dict(zip(("smem_bytes", "ctas_per_sm", "registers", "stages", "threads"),
                    out.tolist()))


def seg_loss_sums(logits, target, weights, out, hp, blocks, round_bf16=False) -> None:
    """Launch the seg-loss forward kernel on `blocks` CTAs; tensors are
    checked by the caller, `weights` may be None (every class 1).  `out`
    (f32) receives rows (blocks, 4 + 5*C), the sums (4 + 5*C,), the loss and
    f_score; `hp` holds the loss's hyper-parameters
    (losses_seg_fused.SegHyper); `round_bf16` rounds f32 logits to bf16 on
    load."""
    _call("seg_loss_sums", logits, _ptr(logits), _ptr(target), _ptr(weights), _ptr(out),
          target.numel(), logits.shape[-1], hp.alpha, hp.gamma, hp.threshold,
          int(hp.use_focal), int(hp.use_dice), hp.dice_beta, hp.dice_smooth, hp.fs_beta,
          hp.fs_smooth, blocks, int(round_bf16))


def seg_loss_dlogits(logits, target, weights, sums, gloss, out, hp, blocks,
                     round_bf16=False) -> None:
    """Launch the seg-loss backward kernel on `blocks` CTAs: dlogits into
    `out` from the forward's sums and the loss cotangent `gloss` (one f32 on
    the device); tensors are checked by the caller, `weights` may be None.
    `round_bf16` rounds f32 logits to bf16 on load and the results before
    they are stored."""
    _call("seg_loss_dlogits", logits, _ptr(logits), _ptr(target), _ptr(weights), _ptr(sums),
          _ptr(gloss), _ptr(out), target.numel(), logits.shape[-1], hp.alpha, hp.gamma,
          int(hp.use_focal), int(hp.use_dice), hp.dice_beta, hp.dice_smooth, blocks,
          int(round_bf16))


def simota_assign(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                  grids, strides, scratch, outputs, *, center_radius, candidate_k) -> None:
    """Launch the three SimOTA kernels (prep, rows, resolve) of one batch;
    tensors are checked by the caller.  The predictions are read through
    their batch and anchor strides (f32, last dimension contiguous);
    gt_classes is int32 or int64.  `scratch` holds the device addresses of
    fg_pre, cls_cost, picks and counts, `outputs` those of dynamic_ks, fg,
    matched, pred_iou and num_fg (csrc/simota_assign.cu's entry names their
    shapes)."""
    b, a, c = cls_logits.shape
    _call("simota_assign", pred_boxes, _ptr(pred_boxes), _ptr(cls_logits), _ptr(obj_logits),
          *pred_boxes.stride()[:2], *cls_logits.stride()[:2], *obj_logits.stride(),
          _ptr(gt_boxes), _ptr(gt_classes), int(gt_classes.dtype == torch.int64),
          _ptr(gt_valid), _ptr(grids), _ptr(strides), *scratch, *outputs, b, a,
          gt_boxes.shape[1], c, center_radius, candidate_k)
