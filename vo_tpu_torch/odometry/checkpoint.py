"""Checkpoint / resume for long VO runs (port of vo_tpu.odometry.checkpoint).

The full resumable state (carried features, current pose, landmark map
prefix, trajectory and per-frame stats so far, the RANSAC sample stream, the
frame index and, on refined runs, the refiner's state) is dumped atomically
to one npz every ``checkpoint_every`` frames and restored with ``load``.

The file is the reference's v2 format, field for field, so each package's
``load`` opens the other's files. The one thing that does not cross is the
sample stream: the reference's state holds a JAX PRNG key (field ``key``),
the port's a ``torch.Generator``. The port writes the generator's state as
``torch_gen_state`` with the generator's device type beside it
(``torch_gen_device``), and also a ``key`` of the reference's shape and dtype
(uint32 [2], the generator's initial seed) so that the reference's ``load``
finds its field. A file without ``torch_gen_state`` (a reference file)
restores everything else and seeds a fresh generator from ``key``: such a
run continues, but not with the draws the reference would have made. A CPU
generator's state cannot continue a CUDA generator's stream or the reverse
(the two are different algorithms), so that mismatch raises.
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ..frontend.track import StereoFeatures
from ..utils.device import resolve
from ..utils.host_copy import HostCopy, upload
from .landmarks import LandmarkMap
from .pipeline import VOState

FORMAT_VERSION = 2

_PREV_FIELDS = ("l_xy", "r_xy", "l_desc", "r_desc", "mask", "ids")


class Checkpoint(NamedTuple):
    state: VOState
    lmap: LandmarkMap | None
    poses: np.ndarray  # [T, 4, 4] trajectory so far (frames 2..)
    rel_poses: np.ndarray
    key: np.ndarray  # the file's ``key`` field (the reference's PRNG key; a placeholder in port files)
    frame_idx: int
    # Per-frame stats so far (v2+):
    n_inliers: np.ndarray | None = None
    n_tracks: np.ndarray | None = None
    pose_ok: np.ndarray | None = None
    # RefinerWorker.checkpoint_state payload (v2+, refined runs only).
    refiner: dict | None = None


def generator_fields(gen: torch.Generator, prefix: str = "") -> dict:
    """The npz fields of a sample stream: its state and device type under the port's names, and a
    ``key`` of the reference's shape and dtype (uint32 [2], the generator's initial seed)."""
    seed = int(gen.initial_seed())
    return {
        prefix + "key": np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
        prefix + "torch_gen_state": gen.get_state().numpy(),
        prefix + "torch_gen_device": np.asarray(gen.device.type),
    }


def generator_from_fields(z, device: torch.device, prefix: str = "") -> torch.Generator:
    """The generator that ``generator_fields`` stored, on ``device``. Without the port's fields (the
    reference wrote the file) it is a fresh one seeded from ``key``; a state taken on another kind
    of device raises."""
    gen = torch.Generator(device=device)
    if prefix + "torch_gen_state" not in z:
        hi, lo = (int(w) for w in np.asarray(z[prefix + "key"]).reshape(-1)[:2])
        gen.manual_seed((hi << 32) | lo)
        return gen
    saved = str(z[prefix + "torch_gen_device"])
    if saved != device.type:
        raise ValueError(
            f"checkpoint holds the sample stream of a {saved} generator and cannot continue it on "
            f"{device.type}: resume on a {saved} device, or start the run again"
        )
    gen.set_state(torch.from_numpy(np.array(z[prefix + "torch_gen_state"], np.uint8)))
    return gen


def save(
    path: str,
    state: VOState,
    lmap: LandmarkMap | None,
    poses,
    rel_poses,
    frame_idx: int,
    stats: tuple | None = None,
    refiner_state: dict | None = None,
) -> str:
    """Atomic npz dump (write temp + rename, so a crash never corrupts the last good
    checkpoint). ``stats`` = (n_inliers, n_tracks, pose_ok) per frame so far;
    ``refiner_state`` = RefinerWorker.checkpoint_state(). The state's tensors are read
    through one host copy (one wait on the device)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tensors = [getattr(state.prev, f) for f in _PREV_FIELDS] + [
        state.next_id, state.pose_c2w, state.prev_rel, state.frame_idx,
    ]
    if lmap is not None:
        tensors += [lmap.count, lmap.dropped]
    host = HostCopy(*tensors).numpy()
    count = int(host[10]) if lmap is not None else 0
    payload = dict(
        version=FORMAT_VERSION,
        frame_idx=frame_idx,
        **{f"prev_{f}": host[i] for i, f in enumerate(_PREV_FIELDS)},
        next_id=host[6],
        pose_c2w=host[7],
        prev_rel=host[8],
        state_frame_idx=host[9].astype(np.int32),
        poses=np.asarray(poses),
        rel_poses=np.asarray(rel_poses),
        **generator_fields(state.gen),
        lm_count=count,
        lm_dropped=int(host[11]) if lmap is not None else 0,
        # Only the valid prefix is persisted — the store capacity may be huge.
        lm_xyz=lmap.xyz[:count].cpu().numpy() if lmap is not None else np.zeros((0, 3), np.float32),
        lm_capacity=int(lmap.xyz.shape[0]) if lmap is not None else 0,
    )
    if stats is not None:
        n_in, n_tr, oks = stats
        payload["stat_n_inliers"] = np.asarray(n_in, np.int32)
        payload["stat_n_tracks"] = np.asarray(n_tr, np.int32)
        payload["stat_pose_ok"] = np.asarray(oks, bool)
    if refiner_state is not None:
        for k, v in refiner_state.items():
            payload["refx_" + k] = v
    d = os.path.dirname(os.path.abspath(path))
    # Suffix must end in .npz or np.savez appends it and the rename grabs the
    # empty mkstemp placeholder instead of the written archive.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(path: str, device=None) -> Checkpoint:
    """Restore a checkpoint onto ``device`` (None: the current CUDA device)."""
    device = resolve(device)
    z = np.load(path)
    if int(z["version"]) not in (1, FORMAT_VERSION):
        raise ValueError(f"checkpoint version {int(z['version'])} != {FORMAT_VERSION}")

    def dev(name, dtype):
        return upload(torch.from_numpy(np.array(z[name], dtype)), device)

    dtypes = dict(l_xy=np.float32, r_xy=np.float32, l_desc=np.float32, r_desc=np.float32, mask=bool, ids=np.int32)
    state = VOState(
        prev=StereoFeatures(**{f: dev(f"prev_{f}", dt) for f, dt in dtypes.items()}),
        pose_c2w=dev("pose_c2w", np.float32),
        prev_rel=dev("prev_rel", np.float32),
        frame_idx=dev("state_frame_idx", np.int64),
        next_id=dev("next_id", np.int32),
        gen=generator_from_fields(z, device),
    )
    cap = int(z["lm_capacity"])
    lmap = None
    if cap > 0:
        # Only the valid prefix was stored: rebuild the fixed-capacity store.
        xyz = torch.zeros((cap, 3), dtype=torch.float32, device=device)
        count = int(z["lm_count"])
        if count:
            xyz[:count] = dev("lm_xyz", np.float32)
        lmap = LandmarkMap(
            xyz=xyz,
            count=torch.tensor(count, dtype=torch.int64, device=device),
            dropped=torch.tensor(int(z["lm_dropped"]), dtype=torch.int64, device=device),
        )
    refiner = {k[5:]: z[k] for k in z.files if k.startswith("refx_")} or None
    return Checkpoint(
        state=state,
        lmap=lmap,
        poses=z["poses"],
        rel_poses=z["rel_poses"],
        key=z["key"],
        frame_idx=int(z["frame_idx"]),
        n_inliers=z["stat_n_inliers"] if "stat_n_inliers" in z.files else None,
        n_tracks=z["stat_n_tracks"] if "stat_n_tracks" in z.files else None,
        pose_ok=z["stat_pose_ok"] if "stat_pose_ok" in z.files else None,
        refiner=refiner,
    )
