"""The world a cell's jobs run over: the rendered log, cached in the checkout, staged on the
card, and the sensor noise that ``--seed`` draws on the card.

The render (gen.render, numpy) runs once per checkout: the first run of a cell writes it as
uint8 ``[poses, 2, H, W]`` into ``perfbench/.cache/`` under a name made from everything that
fixes its bytes, and every later run memory-maps it. The world is the log, as KITTI's images are: the
seed never re-renders it. What a seed changes is the sensor noise on top (``noisy_log``).
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import multiprocessing
import os

import numpy as np
import torch

from . import kitti, render
from .traffic import HERE, Traffic

CACHE_DIR = os.path.join(HERE, ".cache")
RENDER_VERSION = 1  # bump when gen/render.py changes what it draws


def _render_rows(P1, P2, image_size, poses, n_landmarks, seed, noise, rows) -> np.ndarray:
    """Frames ``rows`` of the render, uint8 [len(rows), 2, H, W] (one worker's share)."""
    r = render.Renderer(P1, P2, image_size, poses, n_landmarks, seed=seed, noise=noise)
    return np.stack([np.stack([render.quantize(im) for im in r.frame(i)]) for i in rows])


class World:
    """The rendered poses of one traffic mix under one configuration's camera."""

    def __init__(self, config: dict, traffic: Traffic, root: str = HERE):
        seq = config["sequence"]
        self.image_size = tuple(seq["image_size"])
        self.calib_path = os.path.join(os.path.dirname(root), seq["calib"])
        self.P1, self.P2 = kitti.projections(self.calib_path, self.image_size)
        self.gt_all = kitti.read_poses(os.path.join(os.path.dirname(root), seq["poses"]))
        self.traffic = traffic
        if traffic.poses > len(self.gt_all):
            raise ValueError(f"traffic {traffic.name} renders {traffic.poses} poses; {seq['poses']} holds {len(self.gt_all)}")
        self.gt = self.gt_all[: traffic.poses]
        self.log = traffic.log()
        self.gt_log = self.gt[self.log]  # [frames, 4, 4] the GT pose each frame of a job shows

    def key(self) -> str:
        t = self.traffic
        desc = dict(
            v=RENDER_VERSION, P1=self.P1.tolist(), P2=self.P2.tolist(), size=self.image_size, poses=self.gt.tolist(),
            landmarks=t.n_landmarks, seed=t.world_seed, noise=t.render_noise,
        )
        return hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()[:20]

    def cache_path(self) -> str:
        return os.path.join(CACHE_DIR, f"world_{self.key()}.npy")

    def rendered(self, workers: int = 8) -> tuple[np.ndarray, bool]:
        """uint8 [poses, 2, H, W] -> (frames, whether this call rendered them). A cached render is
        memory-mapped (copy-on-write, so torch takes it without a copy), not read whole."""
        path = self.cache_path()
        if os.path.exists(path):
            return np.load(path, mmap_mode="c"), False
        t = self.traffic
        n = t.poses
        args = (self.P1, self.P2, self.image_size, self.gt, t.n_landmarks, t.world_seed, t.render_noise)
        if workers <= 1:
            frames = _render_rows(*args, range(n))
        else:
            # Spawned, not forked: this process may already hold a CUDA context.
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                shares = list(pool.map(_render_rows, *zip(*[args + (range(k, n, workers),) for k in range(workers)])))
            frames = np.empty((n, 2) + self.image_size, np.uint8)
            for k, share in enumerate(shares):
                frames[k::workers] = share
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.part.npy"
        with open(tmp, "wb") as f:
            np.save(f, frames)
            f.flush()
            os.fsync(f.fileno())  # written back inside this run, not during the next run's start
        os.replace(tmp, path)  # a run that is cut never leaves a partial file under the name
        return frames, True


    def stage(self, device, workers: int = 8) -> tuple[torch.Tensor, bool]:
        """The rendered poses as uint8 [poses, 2, H, W] on ``device`` (rendered first where the cache
        has none) -> (frames, whether they were rendered now). Kept for the check after the window."""
        if getattr(self, "staged", None) is None or self.staged.device != torch.device(device):
            frames, rendered = self.rendered(workers)
            self.staged = torch.from_numpy(frames).to(device)
            return self.staged, rendered
        return self.staged, False


def frame_seed(seed: int, job: int, frame: int) -> int:
    """The sensor-noise seed of one frame of one job (63 bits)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, job, frame, 1])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def job_seed(seed: int, job: int) -> int:
    """``run_sequence(seed=)`` of one job (63 bits)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, job, 0])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def noisy_frame(base: torch.Tensor, sigma: float, seed: int, gen: torch.Generator) -> torch.Tensor:
    """uint8 [2, H, W] + Gaussian noise of stddev ``sigma`` ([0, 1] units) drawn from ``seed`` on
    ``base``'s device, clipped and rounded back to uint8 as vo_tpu_torch/bench.py::add_noise does."""
    if sigma <= 0.0:
        return base.clone()
    gen.manual_seed(seed)
    n = torch.randn(base.shape, generator=gen, device=base.device, dtype=torch.float32)
    x = torch.clamp(base.to(torch.float32) + n * (255.0 * sigma), 0.0, 255.0)
    return (x + 0.5).to(torch.uint8)


def noisy_log(staged: torch.Tensor, log: np.ndarray, sigma: float, seed: int, job: int, frames=None) -> torch.Tensor:
    """The job's feed: uint8 [len(frames), 2, H, W] on ``staged``'s device, frame ``f`` of the log
    (``frames``: all of them by default) with its own noise. The same (seed, job, f) gives the same
    bytes, whichever frames are asked for."""
    frames = range(len(log)) if frames is None else frames
    gen = torch.Generator(device=staged.device)
    out = torch.empty((len(frames),) + tuple(staged.shape[1:]), dtype=torch.uint8, device=staged.device)
    for k, f in enumerate(frames):
        out[k] = noisy_frame(staged[int(log[f])], sigma, frame_seed(seed, job, f), gen)
    return out
