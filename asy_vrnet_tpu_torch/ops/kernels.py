"""Build, load and launch the CUDA kernels in `asy_vrnet_tpu_torch/csrc/`.

Each source is compiled by nvcc into a shared library with a plain C
interface (`-gencode arch=compute_90a,code=sm_90a`), loaded with ctypes, at
first use; all sources build in parallel.  Libraries land in
`asy_vrnet_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
sources and flags, so an edit rebuilds.  `-Xptxas -v` output (registers,
shared memory, spills) is kept beside each library.

Launches go on the current stream; each C entry returns cudaGetLastError()
and a nonzero code raises here.  Nothing here is imported by the CPU path.
"""
from __future__ import annotations

import ctypes
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
SOURCES = ("mixer_block", "mlp_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "mixer_block": [_P] * 12 + [_I] * 11 + [_P],
    "mlp_block": [_P] * 7 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", "common.cuh"):
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
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
            for suffix in ("bf16", "f32"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = _SIGS[name]
                fn.restype = _I
            lib.asy_cuda_error_string.argtypes = [_I]
            lib.asy_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _call(name: str, x: torch.Tensor, *args) -> None:
    lib = load(name)
    fn = getattr(lib, f"{name}_{'bf16' if x.dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err:
        msg = lib.asy_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {err})")


def mixer_cluster_size(heads: int, regions: int, device: torch.device) -> int:
    """CTAs per region (one thread-block cluster, split by heads).  Splitting
    pays only when the batch has fewer regions than the card has SMs (every
    CTA of a cluster re-reads its whole region): then the smallest divisor of
    `heads` (at most 8, the portable cluster size) that gives each SM a
    block, or the largest such divisor."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    divisors = [d for d in range(1, 9) if heads % d == 0]
    return next((d for d in divisors if regions * d >= sms), divisors[-1])


def mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out, part, assign,
                *, heads, fold_h, fold_w, proposal_h, proposal_w) -> None:
    """Launch the mixer-half kernel; tensors are checked by the caller.
    `part` is (B, fold_h * fold_w * G, 2) with G = part.shape[1] // (fold_h *
    fold_w) CTAs per region (see mixer_cluster_size)."""
    b, h, w, c = x.shape
    _call("mixer_block", x, _ptr(x), _ptr(stats), _ptr(wf), _ptr(bf), _ptr(wv),
          _ptr(bv), _ptr(w2), _ptr(b2), _ptr(alpha_beta), _ptr(out), _ptr(part),
          _ptr(assign), b, h, w, c, wf.shape[1], heads, fold_h, fold_w,
          proposal_h, proposal_w, part.shape[1] // (fold_h * fold_w))


def mlp_block(x, stats, w1, b1, w2, b2, out) -> None:
    """Launch the MLP-half kernel; tensors are checked by the caller."""
    b, h, w, c = x.shape
    _call("mlp_block", x, _ptr(x), _ptr(stats), _ptr(w1), _ptr(b1), _ptr(w2),
          _ptr(b2), _ptr(out), b, h * w, c, w1.shape[1])
