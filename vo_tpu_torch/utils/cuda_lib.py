"""The port's CUDA library: how every hand-written kernel is built, bound, launched and counted.

``csrc/*.cu`` is compiled at first use with ``nvcc`` into ONE shared library under
``build/vo_tpu_torch/``, named by a hash of the sources and flags (an edit rebuilds, a built tree
is reused). A wrapper module declares each entry point it calls as a ``Kernel`` (symbol, ctypes
argument types before the stream, counter key); nothing builds or binds before its first launch,
which on a card is in the warm-up run that ``utils.graphs.capture`` makes before it records.
``Kernel.launch`` runs it on the current stream of the tensor's device, raises on an error, and
counts it in ``LAUNCHES``. A ``Counts`` (``LAUNCHES``; ``dist.mesh.COLLECTIVES``) counts a call
recorded into a CUDA graph under capture in ``captured`` instead; the graph adds what it captured
(``captured(since=)``) back on each replay, so a graphed run counts what the eager run counts.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vo_tpu_torch"
# Compile flags of each source; the objects are then linked with -shared. --split-compile=0 lets nvcc
# optimise on every core: K4's unrolled passes take most of the build.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build vo_tpu_torch/csrc")


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvo_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu with nvcc unless the library for these sources already exists: every source at
    once, each in a process of its own, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        srcs = sorted(_CSRC.glob("*.cu"))
        objs = [os.path.join(work, f"{src.stem}.o") for src in srcs]
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)
        ]
        failed = [(src.name, p.returncode, log) for src, p in zip(srcs, procs) for log in [p.communicate()[0]]
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        tmp = os.path.join(work, out.name)
        proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -shared failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build()))


def array(ctype, values):
    """A ctypes array of ``values``: what an entry point's per-octave (or per-job) arguments take."""
    return (ctype * len(values))(*values)


def capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t`` is being recorded into a CUDA graph rather than run (never asked of the CPU)."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


COUNTS: dict = {}  # every Counts, by name


class Counts(dict):
    """Calls by key since the last ``reset()``; ``captured``: calls recorded into CUDA graphs under
    capture, by key (never reset: utils.graphs reads the difference). Registered in ``COUNTS``."""

    def __init__(self, name: str, *keys: str):
        self.captured = {}
        for key in keys:
            self.declare(key)
        COUNTS[name] = self

    def declare(self, key: str) -> None:
        """Add ``key`` at 0 (a key already declared keeps its counts)."""
        self.setdefault(key, 0)
        self.captured.setdefault(key, 0)

    def count(self, key: str, t: torch.Tensor) -> None:
        """One call of ``key`` on ``t``: run, or recorded into a graph under capture."""
        (self.captured if capturing(t) else self)[key] += 1

    def reset(self) -> None:
        for key in self:
            self[key] = 0


LAUNCHES = Counts("launches")  # the hand-written kernels, by the key each Kernel declares


def captured(since: dict | None = None) -> dict:
    """Every counter's calls recorded under capture, {counter name: {key: n}}: in all, or since ``since``
    (an earlier return of this)."""
    since = since or {}
    return {name: {k: n - since.get(name, {}).get(k, 0) for k, n in c.captured.items()} for name, c in COUNTS.items()}


class Kernel:
    """One C entry point of the library: ``symbol`` takes ``argtypes`` (ctypes) and then the stream,
    returns a ``cudaError_t``, and counts in ``LAUNCHES[key]``. Bound at its first launch."""

    def __init__(self, symbol: str, key: str, argtypes):
        self.symbol, self.key, self.argtypes = symbol, key, list(argtypes)
        self._fn = None
        LAUNCHES.declare(key)

    def launch(self, like: torch.Tensor, *args) -> None:
        """Call the entry point with ``args`` and the current stream of ``like``'s device, raise on an
        error, and count the launch."""
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes, fn.restype = [*self.argtypes, ctypes.c_void_p], ctypes.c_int
            self._fn = fn
        with torch.cuda.device(like.device):
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{self.key} kernel launch failed with cudaError_t {err}")
            LAUNCHES.count(self.key, like)
