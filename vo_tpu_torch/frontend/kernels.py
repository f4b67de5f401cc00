"""The front-end's two hand-written CUDA kernels: build, bind, wrappers and plain versions.

K1 ``extrema_scores`` replaces vo_tpu/frontend/pallas_kernels.py::extrema_scores_pallas;
K2 ``bin_maps`` replaces vo_tpu/frontend/pallas_kernels.py::bin_maps_pallas. Their
sources are ``vo_tpu_torch/csrc/*.cu`` (CUDA C++ for sm_90a; each file notes what
bounds its kernel). At first use the sources are compiled with ``nvcc`` into one
shared library under ``build/vo_tpu_torch/`` (named by a hash of the sources and
flags, so an edit rebuilds) and bound with ``ctypes``.

Each wrapper takes its plain PyTorch version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel on the current stream or raises. ``LAUNCHES``
counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

NB = 8  # orientation bins of the dense descriptor maps

# Kernel launches since the last reset_launches(), by wrapper name.
LAUNCHES = {"extrema_scores": 0, "bin_maps": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Compile csrc/*.cu with nvcc unless the library for these sources already exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    srcs = [str(s) for s in sorted(_CSRC.glob("*.cu"))]
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then bind the kernels' C entry points (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.vo_extrema_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.vo_extrema_scores.restype = ctypes.c_int
        lib.vo_bin_maps.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.vo_bin_maps.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got device {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of rank {ndim}, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# K1: extrema scores
# ---------------------------------------------------------------------------


def extrema_scores_plain(dog: torch.Tensor, thr: float, border: int = 5) -> torch.Tensor:
    """[B, L, H, W] DoG stacks -> [B, L-2, H, W] candidate scores (the score part of
    vo_tpu's sift._find_candidates): |dog| at 3x3x3 extrema with |dog| > thr/2 at least
    ``border`` px inside the image, -1 elsewhere; inner levels only."""
    B, L, H, W = dog.shape
    x = dog[:, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[:, 0, 1:-1]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[:, 0, 1:-1]
    c = dog[:, 1:-1]
    ys = torch.arange(H, device=dog.device)[:, None]
    xs = torch.arange(W, device=dog.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    valid = ((c >= mx) | (c <= mn)) & (c.abs() > 0.5 * thr) & inb
    return torch.where(valid, c.abs(), -1.0)


def extrema_scores(dog: torch.Tensor, thr: float, border: int = 5) -> torch.Tensor:
    """K1 wrapper: [B, L, H, W] -> [B, L-2, H, W] scores (see extrema_scores_plain)."""
    if dog.device.type == "cpu":
        return extrema_scores_plain(dog, thr, border)
    _check_input(dog, 4, "extrema_scores")
    B, L, H, W = dog.shape
    if B == 0 or L < 3:
        raise ValueError(f"extrema_scores: need B >= 1 and L >= 3 levels, got {tuple(dog.shape)}")
    out = torch.empty((B, L - 2, H, W), dtype=torch.float32, device=dog.device)
    with torch.cuda.device(dog.device):
        err = load().vo_extrema_scores(
            dog.data_ptr(), out.data_ptr(), B, L, H, W, 0.5 * thr, border,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "extrema_scores")
    LAUNCHES["extrema_scores"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: pooled soft-bin maps
# ---------------------------------------------------------------------------


def soft_bin_pool_plain(G: torch.Tensor) -> torch.Tensor:
    """[B, H, W] Gaussian levels -> UNBLURRED pooled soft-bin maps [B, 8, H//2, W//2]
    (vo_tpu's dense_desc._soft_bin_pool, batched)."""
    B, H, W = G.shape
    gx = 0.5 * (torch.roll(G, -1, dims=2) - torch.roll(G, 1, dims=2))
    gy = 0.5 * (torch.roll(G, -1, dims=1) - torch.roll(G, 1, dims=1))
    gx[:, :, 0] = 0.0
    gx[:, :, -1] = 0.0
    gy[:, 0, :] = 0.0
    gy[:, -1, :] = 0.0
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    b = (ang / (2.0 * math.pi) + 0.5) * NB  # [0, 8]
    b0 = torch.floor(b)
    fb = b - b0
    b0i = b0.long() % NB
    bins = torch.arange(NB, device=G.device)
    # Exact soft binning: each pixel feeds its two adjacent bins.
    maps = (b0i[..., None] == bins) * ((1.0 - fb) * mag)[..., None] + (
        ((b0i + 1) % NB)[..., None] == bins
    ) * (fb * mag)[..., None]  # [B, H, W, 8]
    H2, W2 = H // 2, W // 2
    maps = maps[:, : H2 * 2, : W2 * 2].reshape(B, H2, 2, W2, 2, NB).sum(dim=(2, 4))
    return maps.permute(0, 3, 1, 2).contiguous()


def bin_maps(G: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: [B, H, W] -> [B, 8, H//2, W//2] (see soft_bin_pool_plain)."""
    if G.device.type == "cpu":
        return soft_bin_pool_plain(G)
    _check_input(G, 3, "bin_maps")
    B, H, W = G.shape
    if B == 0 or H < 2 or W < 2:
        raise ValueError(f"bin_maps: need B >= 1 and H, W >= 2, got {tuple(G.shape)}")
    out = torch.empty((B, NB, H // 2, W // 2), dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        err = load().vo_bin_maps(
            G.data_ptr(), out.data_ptr(), B, H, W, torch.cuda.current_stream().cuda_stream
        )
    _raise_on(err, "bin_maps")
    LAUNCHES["bin_maps"] += 1
    return out
