"""The port's hand-written CUDA kernels: build, bind, and the front-end's wrappers and plain versions.

K1 ``extrema_scores`` replaces vo_tpu/frontend/pallas_kernels.py::extrema_scores_pallas;
K2 ``bin_maps`` replaces vo_tpu/frontend/pallas_kernels.py::bin_maps_pallas. K3
``pose_refine`` (RANSAC-P3P's consensus refinement) replaces no TPU kernel; its wrapper
and plain version live with the rest of RANSAC in pose/ransac.py. Nor does K4
``gauss_blur`` (the detector's separable Gaussian blurs, which the JAX package leaves to
XLA as band-matrix products); its wrappers and plain versions live with the pyramid
(pyramid.gauss_stack) and the descriptor maps (dense_desc.bin_map_rows). Their sources are
``vo_tpu_torch/csrc/*.cu`` (CUDA C++ for sm_90a; each file notes what bounds its
kernel). At first use the sources are compiled with ``nvcc`` into one shared library
under ``build/vo_tpu_torch/`` (named by a hash of the sources and flags, so an edit
rebuilds) and bound with ``ctypes``. The same library carries the tracer's one-thread
stage stamp (``csrc/stage_stamp.cu``, wrapped by ``utils.profiling.write_stamp``), which
counts apart.

K1 and K2 take every octave of a detection call in ONE launch
(``extrema_scores_octaves``, ``bin_maps_octaves``); the one-octave wrappers
(``extrema_scores``, ``bin_maps``) launch the same kernels on a list of one.
Each wrapper takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel on the current stream or raises. ``LAUNCHES``
counts the launches of each kernel (a call over several octaves is one launch).
A call made while the current stream is being captured into a CUDA graph
enqueues nothing: it is counted in ``CAPTURED`` instead, and the graph adds
what it captured to ``LAUNCHES`` each time it is replayed (utils.graphs).
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
# Compile flags of each source; the objects are then linked with -shared. --split-compile=0 lets nvcc
# optimise on every core: K4's unrolled passes take most of the build.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0", "-Xcompiler", "-fPIC"]

NB = 8  # orientation bins of the dense descriptor maps
MAX_OCTAVES = 8  # octaves one launch takes (kMaxOctaves in csrc/*.cu)

# Kernel launches since the last reset_launches(), by wrapper name.
LAUNCHES = {"extrema_scores": 0, "bin_maps": 0, "pose_refine": 0, "gauss_blur": 0}
# Calls recorded into a CUDA graph under capture (never reset: utils.graphs reads the difference).
CAPTURED = {"extrema_scores": 0, "bin_maps": 0, "pose_refine": 0, "gauss_blur": 0}

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


def load() -> ctypes.CDLL:
    """Build if needed, then bind the kernels' C entry points (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        longs = ctypes.POINTER(ctypes.c_longlong)
        lib.vo_extrema_scores.argtypes = [
            ptrs, ptrs, ints, ints, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.vo_extrema_scores.restype = ctypes.c_int
        lib.vo_bin_maps.argtypes = [
            ptrs, ptrs, longs, longs, longs, ints, ints, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.vo_bin_maps.restype = ctypes.c_int
        # K3 (csrc/pose_refine.cu; wrapper pose.ransac._finalize_f32): six inputs, n, fu, fv, cu, cv,
        # thr2, huber, iters, min_points, five outputs, the stream.
        lib.vo_pose_refine.argtypes = [
            *[ctypes.c_void_p] * 6, ctypes.c_int, *[ctypes.c_float] * 6, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 6,
        ]
        lib.vo_pose_refine.restype = ctypes.c_int
        # K4 (csrc/gauss_blur.cu; wrappers pyramid.gauss_stack, dense_desc.bin_map_rows). Both end with
        # the tap tables (radii, taps, lo, hi, tot) and the stream.
        floats = ctypes.POINTER(ctypes.c_float)
        taps = [ints, floats, floats, floats, floats, ctypes.c_void_p]
        lib.vo_gauss_stack.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, *[ctypes.c_int] * 3, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *taps,
        ]
        lib.vo_gauss_stack.restype = ctypes.c_int
        lib.vo_gauss_rows.argtypes = [
            ptrs, longs, longs, ints, ints, ints, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, *taps,
        ]
        lib.vo_gauss_rows.restype = ctypes.c_int
        # The tracer's stage stamp (csrc/stage_stamp.cu; wrapper utils.profiling.write_stamp).
        lib.vo_stage_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_void_p]
        lib.vo_stage_stamp.restype = ctypes.c_int
        _lib = lib
    return _lib


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _check_octaves(xs, name: str, contiguous: bool) -> None:
    """What the kernels take, on any device: 1..MAX_OCTAVES float32 tensors [B, L, H, W] with
    one B and L and a unit stride along x (``contiguous``: no stride at all)."""
    if not 1 <= len(xs) <= MAX_OCTAVES:
        raise ValueError(f"{name}: expected 1..{MAX_OCTAVES} octaves, got {len(xs)}")
    for x in xs:
        ok = x.dtype == torch.float32 and x.ndim == 4 and x.shape[:2] == xs[0].shape[:2] and x.device == xs[0].device
        ok = ok and (x.is_contiguous() if contiguous else x.stride(3) == 1)
        if not ok:
            raise ValueError(
                f"{name}: expected float32 [B, L, H, W] tensors of one B, L and device, "
                f"{'contiguous' if contiguous else 'with unit stride along x'}; got {x.dtype} {tuple(x.shape)} "
                f"strides {x.stride()} on {x.device}"
            )
        if x.shape[0] * x.shape[1] > 65535 or x.shape[2] * x.shape[3] >= 2**31:
            raise ValueError(f"{name}: {tuple(x.shape)} exceeds the launch grid")


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got device {x.device}")


def _empty_octaves(shapes, device) -> list:
    """One uninitialised float32 tensor per shape: views, back to back, of one allocation."""
    sizes = [math.prod(shape) for shape in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return [part.view(shape) for part, shape in zip(flat.split(sizes), shapes)]


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel, or one call recorded into a graph under capture."""
    (CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES)[name] += 1


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


def extrema_scores_octaves(dogs, thr: float, border: int = 5) -> list:
    """K1 wrapper over a pyramid: per-octave [B, L, H_o, W_o] DoG stacks -> per-octave
    [B, L-2, H_o, W_o] scores (see extrema_scores_plain), all octaves in one launch."""
    dogs = list(dogs)
    if dogs and dogs[0].device.type == "cpu":
        return [extrema_scores_plain(d, thr, border) for d in dogs]
    _check_octaves(dogs, "extrema_scores", contiguous=True)
    _require_cuda(dogs[0], "extrema_scores")
    B, L = dogs[0].shape[:2]
    if B == 0 or L < 3 or border < 0:
        raise ValueError(f"extrema_scores: need B >= 1, L >= 3 levels and border >= 0, got {tuple(dogs[0].shape)}, {border}")
    shapes = [(B, L - 2, d.shape[2], d.shape[3]) for d in dogs]
    outs = _empty_octaves(shapes, dogs[0].device)
    with torch.cuda.device(dogs[0].device):
        err = load().vo_extrema_scores(
            _array(ctypes.c_void_p, [d.data_ptr() for d in dogs]),
            _array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
            _array(ctypes.c_int, [d.shape[2] for d in dogs]),
            _array(ctypes.c_int, [d.shape[3] for d in dogs]),
            len(dogs), B, L, 0.5 * thr, border,
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(err, "extrema_scores")
    count_launch("extrema_scores")
    return outs


def extrema_scores(dog: torch.Tensor, thr: float, border: int = 5) -> torch.Tensor:
    """K1 wrapper, one octave: [B, L, H, W] -> [B, L-2, H, W] scores (see extrema_scores_plain)."""
    return extrema_scores_octaves([dog], thr, border)[0]


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


def bin_maps_plain(levels: torch.Tensor) -> torch.Tensor:
    """soft_bin_pool_plain over [B, L, H, W] -> [B, L, 8, H//2, W//2]."""
    B, L, H, W = levels.shape
    return soft_bin_pool_plain(levels.reshape(B * L, H, W)).reshape(B, L, NB, H // 2, W // 2)


def bin_maps_octaves(levels) -> list:
    """K2 wrapper over a pyramid: per-octave [B, L, H_o, W_o] Gaussian levels -> per-octave
    [B, L, 8, H_o//2, W_o//2] pooled soft-bin maps (see soft_bin_pool_plain), all octaves in
    one launch. The levels are read in place: any strides with a unit stride along x, so a
    slice of levels such as ``G[:, 1:4]`` needs no copy."""
    levels = list(levels)
    if levels and levels[0].device.type == "cpu":
        return [bin_maps_plain(g) for g in levels]
    _check_octaves(levels, "bin_maps", contiguous=False)
    _require_cuda(levels[0], "bin_maps")
    B, L = levels[0].shape[:2]
    if B == 0 or L == 0 or any(g.shape[2] < 2 or g.shape[3] < 2 for g in levels):
        raise ValueError(f"bin_maps: need B, L >= 1 and H, W >= 2, got {[tuple(g.shape) for g in levels]}")
    shapes = [(B, L, NB, g.shape[2] // 2, g.shape[3] // 2) for g in levels]
    outs = _empty_octaves(shapes, levels[0].device)
    with torch.cuda.device(levels[0].device):
        err = load().vo_bin_maps(
            _array(ctypes.c_void_p, [g.data_ptr() for g in levels]),
            _array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
            *(_array(ctypes.c_longlong, [g.stride(d) for g in levels]) for d in (0, 1, 2)),
            _array(ctypes.c_int, [g.shape[2] for g in levels]),
            _array(ctypes.c_int, [g.shape[3] for g in levels]),
            len(levels), B, L,
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(err, "bin_maps")
    count_launch("bin_maps")
    return outs


def bin_maps(G: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, one octave: [B, L, H, W] -> [B, L, 8, H//2, W//2], or [B, H, W] -> [B, 8, H//2, W//2]."""
    if G.ndim == 3:
        return bin_maps_octaves([G[:, None]])[0][:, 0]
    return bin_maps_octaves([G])[0]
