"""ctypes binding for the native C++ data loader (port of vo_tpu.io.native_loader).

zlib-backed grayscale PNG decode and an N-frames-ahead prefetch pool feeding
the frame loop: the replacement for MATLAB's imageDatastore/readimage feed
(VO.m:16-17, 71-72). This is host-side file decoding, not a device kernel.

The port keeps its own copy of the source (``vo_tpu_torch/csrc/loader.cpp``)
and builds it at first use with the host C++ compiler (``$CXX``, else g++ or
c++) and ``-lz`` into ``build/vo_tpu_torch/``, named by a hash of the source
and flags so that an edit rebuilds. Where it cannot be built (no compiler, no
``zlib.h``), ``available()`` is False, ``unavailable_reason()`` says why, and
``io.kitti`` decodes with PIL instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..frontend.kernels import BUILD_DIR

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "loader.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_LIB = None
_TRIED = False
_WHY_NOT = ""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libvoio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/loader.cpp unless the library for this source already exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX, or put g++ on PATH)")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", tmp, "-lz"], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load():
    global _LIB, _TRIED, _WHY_NOT
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _WHY_NOT = str(e)
        return None
    lib.vo_png_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vo_png_info.restype = ctypes.c_int
    lib.vo_png_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    lib.vo_png_read.restype = ctypes.c_int
    lib.vo_prefetch_start.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.vo_prefetch_start.restype = ctypes.c_void_p
    lib.vo_prefetch_get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    lib.vo_prefetch_get.restype = ctypes.c_int
    lib.vo_prefetch_stop.argtypes = [ctypes.c_void_p]
    lib.vo_prefetch_stop.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native decoder is built (building it now if need be) and loaded."""
    return _load() is not None


def unavailable_reason() -> str:
    """Why ``available()`` is False (the compiler's or the loader's message); empty when it is True."""
    _load()
    return _WHY_NOT


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader not available: {_WHY_NOT}")
    return lib


def png_info(path: str) -> tuple[int, int]:
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.vo_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vo_png_info({path}) failed: {rc}")
    return h.value, w.value


def read_png_gray(path: str) -> np.ndarray:
    """Decode one grayscale PNG -> [H, W] float32 in [0, 1]."""
    lib = _require()
    h, w = png_info(path)
    out = np.empty(h * w, np.float32)
    rc = lib.vo_png_read(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    if rc != 0:
        raise IOError(f"vo_png_read({path}) failed: {rc}")
    return out.reshape(h, w)


class PrefetchFeed:
    """Threaded decode-ahead feed over a fixed list of PNG paths.

    Usage:
        feed = PrefetchFeed(paths, ahead=8, threads=4)
        img = feed[3]          # blocks until frame 3 decoded
        feed.close()

    The pool hands each decoded frame out once and then drops it, so a frame
    that is asked for again (the runner's warm-up reads frame 0 before the
    loop does) is decoded on the spot instead of waited for: waiting would
    never end. One consumer thread.
    """

    def __init__(self, paths, ahead: int = 8, threads: int = 4):
        self._lib = _require()
        self.paths = list(paths)
        if not self.paths:
            raise ValueError("empty path list")
        self.h, self.w = png_info(self.paths[0])
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._keepalive = arr
        self._taken: set = set()  # indices the pool has already handed out
        self._handle = self._lib.vo_prefetch_start(arr, len(self.paths), ahead, threads)
        if not self._handle:
            raise RuntimeError("vo_prefetch_start failed")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self.paths):
            raise IndexError(idx)
        if idx in self._taken:
            return read_png_gray(self.paths[idx])
        self._taken.add(idx)
        out = np.empty(self.h * self.w, np.float32)
        rc = self._lib.vo_prefetch_get(
            self._handle, idx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
        )
        if rc != 0:
            raise IOError(f"prefetch_get({idx}) failed: {rc}")
        return out.reshape(self.h, self.w)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vo_prefetch_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
