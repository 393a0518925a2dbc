"""ctypes bindings for the native IO core (`native/nativeio.cpp`; the port's own
copy of `asy_vrnet_tpu/data/native_io.py`).

Builds its own `libnativeio.so` into `asy_vrnet_tpu_torch/_build/` on first use
(g++ and zlib), so neither package rebuilds or replaces the other's library,
and exposes:
  - load_npz(path, member="arr_0") -> np.ndarray (float32)
  - NativeBatchLoader: thread-pool batch loads of radar .npz straight into a
    contiguous (B, ...) buffer (GIL-free decompression)

Host IO, not a device kernel: where no compiler or zlib is found,
`native_available()` is False, `build_error()` says why, and the dataset
reads the npz with numpy.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "nativeio.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "asy_vrnet_tpu_torch", "_build")
_LIB = os.path.join(_BUILD_DIR, "libnativeio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile into a temporary file and rename it into place, so that a
    process loading the library never sees a half-written one."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp, "-lz", "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return res.stderr[-2000:]
        os.replace(tmp, _LIB)
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:            # built for another system
            _build_error = str(e)
            return None
        lib.nio_load_npz_f32.restype = ctypes.c_int
        lib.nio_load_npz_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.nio_pool_create.restype = ctypes.c_void_p
        lib.nio_pool_create.argtypes = [ctypes.c_int]
        lib.nio_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.nio_pool_load_batch.restype = ctypes.c_int
        lib.nio_pool_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    _get_lib()
    return _build_error


def load_npz(path: str, member: str = "arr_0",
             capacity: int = 64 * 1024 * 1024) -> np.ndarray:
    """Native npz load (float32).  Raises on parse failure."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native io unavailable: {_build_error}")
    out = np.empty(capacity // 4, np.float32)
    shape = np.zeros(8, np.int64)
    ndim = ctypes.c_int32(0)
    rc = lib.nio_load_npz_f32(
        path.encode(), member.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(ndim), 8,
    )
    if rc != 0:
        raise RuntimeError(f"nio_load_npz_f32({path}) failed with code {rc}")
    shp = tuple(int(s) for s in shape[: ndim.value])
    n = int(np.prod(shp)) if shp else 0
    return out[:n].reshape(shp).copy()


class NativeBatchLoader:
    """Thread-pool batch loader: N radar .npz files -> one (N, *item_shape)
    float32 array, decompressed in parallel outside the GIL."""

    def __init__(self, item_shape: tuple[int, ...], threads: int = 4,
                 member: str = "arr_0"):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native io unavailable: {_build_error}")
        self._lib = lib
        self._pool = lib.nio_pool_create(threads)
        self.item_shape = tuple(item_shape)
        self.member = member.encode()
        self._stride = int(np.prod(item_shape))

    def load(self, paths: Sequence[str]) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, *self.item_shape), np.float32)
        status = np.zeros(n, np.int32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        failures = self._lib.nio_pool_load_batch(
            self._pool, arr, self.member, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._stride,
            self._stride,  # expected elements == stride: reject short arrays
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if failures:
            bad = [paths[i] for i in range(n) if status[i] != 0]
            raise RuntimeError(f"native batch load failed for {bad} (status {status.tolist()})")
        return out

    def close(self):
        if self._pool:
            self._lib.nio_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
