"""Whether a run's output is correct: the program's frames against the plain reference.

After the window has closed and the card's peak has been read, a sample of the window's frames,
drawn from ``--seed`` across its jobs, is worked out again by the plain reference
(perfbench/reference/frame.py, no import of the program) from the same inputs: the job's noisy
frames, regenerated from the seed, and its RANSAC stream, the job's seed advanced one draw per
frame. Each number below is compared with its limit in ``workloads/<cell>.json`` (``check``):

- ``rows_missing``: frames of a job with no row in its result (limit 0);
- ``stat_mismatches``: sampled frames whose ``pose_ok``, ``n_tracks`` or ``n_inliers`` differ
  from the reference's, or whose failed pose is not the constant-velocity fallback;
- ``rel_t_gap_m`` / ``rel_r_gap_rad``: the widest gap of a sampled frame's relative pose
  (translation, m; rotation angle, rad) from the reference's, where both found one;
- ``landmark_miss_share``: of the landmarks the reference inserts for the sampled frames, moved
  into the world by the program's pose of their frame, the share with no landmark of the
  program's map within ``LANDMARK_TOL_M`` (a stereo match that flips between two near-equal
  descriptors moves one landmark by metres, so the share, not the widest gap, is compared);
- ``chain_rel_gap``: over every frame, the widest gap of the program's world position from its
  previous pose composed with its relative pose (float64), over 1 m plus the distance from the
  origin (float32 world coordinates round in proportion to it).

The control (``control``) puts the reference computed with TF32 products in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from .gen import world as world_mod
from .reference import frame as ref

NUMBERS = ("rows_missing", "stat_mismatches", "rel_t_gap_m", "rel_r_gap_rad", "landmark_miss_share", "chain_rel_gap")
LANDMARK_TOL_M = 1e-3  # a landmark "is in the map" within this: 60x the widest float32 world rounding seen (1.5e-5 m)


def sample(jobs, n: int, seed: int) -> dict:
    """{job index: sorted frames t >= 1} — ``n`` frames drawn from ``seed`` over the jobs' frames."""
    pairs = [(j.index, t) for j in jobs for t in range(1, j.n_frames)]
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False) if pairs else []
    out: dict = {}
    for k in sorted(pick):
        j, t = pairs[k]
        out.setdefault(j, []).append(t)
    return {j: sorted(ts) for j, ts in out.items()}


def batch_of(f: int, n: int, group: int) -> list:
    """The frames whose images the program detects together with frame ``f``'s (runner.run_sequence:
    groups of ``group`` frames from frame 0, single frames for a tail that does not fill one)."""
    start = (f // group) * group
    if group > 1 and start + group <= n:
        return list(range(start, start + group))
    return [f]


def reference_frames(cell, jobs, samples: dict, seed: int, group: int, device, tf32: bool = False) -> dict:
    """{(job, t): reference.frame.FrameRef} for the sampled frames (``tf32``: TF32 products)."""
    w, t = cell.world, cell.traffic
    cfg = ref.pipeline_config(cell.config["pipeline"])
    calib = ref.calib(w.P1, w.P2, w.image_size, device)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    out = {}
    try:
        by_index = {j.index: j for j in jobs}
        for ji, ts in samples.items():
            job = by_index[ji]
            n = job.n_frames
            need = sorted({g for f in ts for h in (f - 1, f) for g in batch_of(h, n, group)})
            imgs = world_mod.noisy_log(w.stage(device)[0], w.log[:n], t.sensor_noise, seed, ji, frames=need)
            pos = {f: k for k, f in enumerate(need)}
            feats: dict = {}

            def image_feats(f):
                b = batch_of(f, n, group)
                if b[0] not in feats:
                    x = torch.stack([imgs[pos[g], s] for g in b for s in (0, 1)])
                    feats[b[0]] = ref.detect(x, cfg)
                k = b.index(f)
                return ref.image(feats[b[0]], 2 * k), ref.image(feats[b[0]], 2 * k + 1)

            gen = torch.Generator(device=device)
            gen.manual_seed(job.seed)
            drawn = 0
            for f in ts:
                for _ in range(f - drawn):  # one fixed-size RANSAC draw per frame before f
                    torch.rand((cfg.ransac.n_hypotheses, cfg.max_tracks), generator=gen, device=device)
                pl, pr = image_feats(f - 1)
                cl, cr = image_feats(f)
                out[(ji, f)] = ref.frame(pl, pr, cl, cr, calib, cfg, gen)
                drawn = f + 1
                for b in [b for b in feats if b + group <= f - 1]:  # batches no later frame reads
                    del feats[b]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return out


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The rotation angle between two rotations, from their chordal distance (exact 0 where equal;
    arccos of the trace loses everything under about 1e-3 rad)."""
    return float(2.0 * np.arcsin(min(1.0, np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0)))))


def _nearest(pts: torch.Tensor, cloud: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """[len(pts)] distance of each of ``pts`` to its nearest point of ``cloud`` (exact distances)."""
    if cloud.shape[0] == 0:
        return torch.full((pts.shape[0],), float("inf"), dtype=torch.float64, device=pts.device)
    out = [
        torch.cdist(pts[k : k + chunk].double(), cloud.double(), compute_mode="donot_use_mm_for_euclid_dist").min(dim=1).values
        for k in range(0, pts.shape[0], chunk)
    ]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64, device=pts.device)


def compare(frames: dict, refs: dict, device) -> dict:
    """The per-frame numbers: ``frames`` {(job, t): (rel, ok, n_tracks, n_inliers, prev_rel, pose,
    map)} of the side judged, ``refs`` the reference's. ``pose`` / ``map`` may be None (no
    landmark reading)."""
    mism, t_gap, r_gap, lm_miss, lm_all = 0, 0.0, 0.0, 0, 0
    where = {}
    for key, r in refs.items():
        rel, ok, n_tr, n_in, prev_rel, pose, lmap = frames[key]
        if bool(ok) != r.ok or int(n_tr) != r.n_tracks or int(n_in) != r.n_inliers:
            mism += 1
            where.setdefault("stat_mismatches", []).append((key, (bool(ok), int(n_tr), int(n_in)), (r.ok, r.n_tracks, r.n_inliers)))
        elif not ok and prev_rel is not None and not np.array_equal(rel, prev_rel):
            mism += 1
            where.setdefault("stat_mismatches", []).append((key, "fallback"))
        elif ok:
            rr = r.rel.double().cpu().numpy()
            g = float(np.linalg.norm(rel[:3, 3] - rr[:3, 3]))
            if g > t_gap:
                t_gap, where["rel_t_gap_m"] = g, key
            r_gap = max(r_gap, _angle(rel[:3, :3].astype(np.float64), rr[:3, :3]))
        if lmap is not None:
            pts = ref.to_world(torch.as_tensor(pose, dtype=torch.float32, device=device), r.new_landmarks)
            d = _nearest(pts, lmap)
            miss = int((d > LANDMARK_TOL_M).sum())
            if miss:
                where.setdefault("landmark_miss_share", []).append((key, miss, int(d.numel()), round(float(d.max()), 4)))
            lm_miss += miss
            lm_all += int(d.numel())
    return dict(stat_mismatches=mism, rel_t_gap_m=t_gap, rel_r_gap_rad=r_gap, landmark_miss_share=lm_miss / max(lm_all, 1),
                where=where)


def program_frames(jobs, samples: dict, device) -> dict:
    """The program's side of ``compare`` for the sampled frames (result row t - 1 is frame t)."""
    out = {}
    for j in jobs:
        ts = samples.get(j.index)
        if not ts:
            continue
        res = j.result
        lmap = torch.as_tensor(np.asarray(res.landmarks, np.float32), device=device)
        for t in ts:
            r = t - 1
            prev = res.rel_poses[r - 1].astype(np.float64) if r >= 1 else None
            out[(j.index, t)] = (
                res.rel_poses[r].astype(np.float64), res.pose_ok[r], res.n_tracks[r], res.n_inliers[r], prev,
                res.poses[r], lmap,
            )
    return out


def chain_rel_gap(jobs) -> float:
    worst = 0.0
    for j in jobs:
        P = np.asarray(j.result.poses, np.float64)
        R = np.asarray(j.result.rel_poses, np.float64)
        if len(P) == 0:
            continue
        prev = np.concatenate([np.eye(4)[None], P[:-1]])
        gap = np.linalg.norm(np.einsum("tij,tjl->til", prev, R)[:, :3, 3] - P[:, :3, 3], axis=1)
        worst = max(worst, float((gap / (1.0 + np.linalg.norm(prev[:, :3, 3], axis=1))).max()))
    return worst


def judge(values: dict, limits: dict) -> dict:
    """Each number beside its limit; ``where`` (the frames that set the widest readings) goes to
    standard error only."""
    import sys

    for name, w in values.get("where", {}).items():
        print(f"# check {name} set by {w}", file=sys.stderr)
    numbers = {}
    for name in NUMBERS:
        if name not in values:
            continue
        v, lim = values[name], limits[name]
        numbers[name] = dict(value=v, limit=lim, ok=bool(np.isfinite(v) and v <= lim))
    return dict(correct=all(c["ok"] for c in numbers.values()), numbers=numbers)


def run_check(cell, run, device) -> dict:
    samples = sample(run.jobs, int(cell.check["samples"]), run.seed)
    refs = reference_frames(cell, run.jobs, samples, run.seed, run.group, device)
    values = compare(program_frames(run.jobs, samples, device), refs, device)
    values["rows_missing"] = sum(abs(j.n_frames - 1 - len(j.result.poses)) for j in run.jobs)
    values["chain_rel_gap"] = chain_rel_gap(run.jobs)
    return judge(values, cell.check["limits"])


def control(cell, seed: int, jobs, group: int, device) -> dict:
    """The reference with TF32 products in the program's place, at the cell's size: the
    per-frame numbers against the float32 reference (landmarks compared in the camera's frame)."""
    samples = sample(jobs, int(cell.check["samples"]), seed)
    f32 = reference_frames(cell, jobs, samples, seed, group, device)
    low = reference_frames(cell, jobs, samples, seed, group, device, tf32=True)
    frames = {}
    for key, r in low.items():
        frames[key] = (r.rel.double().cpu().numpy(), r.ok, r.n_tracks, r.n_inliers, None, None, None)
    values = compare(frames, f32, device)
    d = [_nearest(f32[k].new_landmarks, low[k].new_landmarks) for k in f32]
    d = torch.cat(d) if d else torch.zeros(0)
    values["landmark_miss_share"] = float((d > LANDMARK_TOL_M).sum()) / max(d.numel(), 1)
    return judge(values, cell.check["limits"])
