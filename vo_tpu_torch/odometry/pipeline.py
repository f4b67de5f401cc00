"""The per-frame VO step (port of vo_tpu.odometry.pipeline).

The reference's main-loop body (VO.m:64-232): detect, stereo match, 4-view
temporal cascade, triangulate, RANSAC-P3P, chain into the world frame, pick
the new stereo features for the landmark map, thread persistent track ids.
Static shapes and masks throughout; the first frame falls out of the mask
algebra (an empty previous set tracks nothing), and a failed pose falls back
to constant velocity. Frame-dependent choices are ``torch.where`` on device
tensors, so the step never waits on the device.

The reference's three factories (``make_jitted_step``, ``make_fused_loop_step``,
``make_fused_multi_step``) compile the step into one device program per frame
or per group. Their counterparts here return the eager step on the CPU and,
on a CUDA device, the step recorded into one CUDA graph per frame shape
(utils.graphs): its state, map, frames and outputs live in static buffers, and
the next call overwrites what a call returned. The meshed step
(``make_fused_loop_step(mesh=)``) is one graph per rank where its collectives
go over NCCL (sharded detection with its all-gather, hypothesis-sharded RANSAC
with its all-gather, the landmark insert) and eager where they go over gloo.

Stage stamps. Given ``stamps`` (utils.profiling.StageStamps, which the runner
makes while the tracer is on), the two fused factories' step writes the
device's clock at each stage boundary, in this order (``stage_columns``): the
start; ``detect`` (``_normalize`` and ``detect_and_describe``, once for the
whole group); per frame ``match`` (``stereo_features_with_matches``, ``track``
and the gathers) and ``pose`` (triangulation, RANSAC-P3P, chaining, the
new-landmark selection and the ids); then per frame ``map``
(``landmarks.insert``; a stamp where there is no map too). A stamp is a node of
the captured graph and touches none of the step's tensors; without ``stamps``
the graph holds no stamp node.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..dist.frontend_batch import detect_batch
from ..dist.mesh import axis_size, collective_backends
from ..dist.ransac_sharded import estimate_world_pose_sharded
from ..frontend.sift import Features, detect_and_describe
from ..frontend.track import StereoFeatures, TrackResult, stereo_features_with_matches, track
from ..geom import se3
from ..geom.camera import StereoCalib
from ..geom.triangulate import triangulate_rectified
from ..pose.ransac import estimate_world_pose
from ..utils import graphs
from ..utils.debug import check_finite
from ..utils.device import resolve
from ..utils.padding import gather_rows
from ..utils.precision import matmul_precision
from . import landmarks as lm_mod


class VOState(NamedTuple):
    prev: StereoFeatures  # stereo-matched features of the previous frame
    pose_c2w: torch.Tensor  # [4, 4] world pose (identity at start, VO.m:58)
    prev_rel: torch.Tensor  # [4, 4] last relative pose (constant-velocity fallback)
    frame_idx: torch.Tensor  # scalar int64
    next_id: torch.Tensor  # scalar int32, persistent track-id counter
    gen: torch.Generator  # RANSAC sample stream (the reference's PRNG key)


class FrameOutput(NamedTuple):
    pose_c2w: torch.Tensor  # [4, 4] world pose after this frame
    rel_pose: torch.Tensor  # [4, 4] estimated relative pose
    pose_ok: torch.Tensor  # bool: RANSAC succeeded (False on frame 1 / fallback)
    n_tracks: torch.Tensor  # tracked correspondences entering RANSAC
    n_inliers: torch.Tensor
    mean_reproj_err: torch.Tensor
    tracked_cur_px: torch.Tensor  # [C, 2] current left px of tracked features
    tracked_old_px: torch.Tensor  # [C, 2] previous left px
    tracked_disp_3d: torch.Tensor  # [C] 3D displacement magnitude
    tracked_mask: torch.Tensor  # [C]
    new_lm_l_px: torch.Tensor  # [C, 2] left px of NEW stereo features (VO.m:157-158)
    new_lm_r_px: torch.Tensor  # [C, 2]
    new_lm_mask: torch.Tensor  # [C]


def init_state(cfg: PipelineConfig, seed: int = 0, device=None) -> VOState:
    """The state before frame 0, on ``device`` (None: the current CUDA device)."""
    device = resolve(device)
    c = cfg.max_tracks
    z2 = torch.zeros((c, 2), dtype=torch.float32, device=device)
    zd = torch.zeros((c, 128), dtype=torch.float32, device=device)
    prev = StereoFeatures(
        l_xy=z2,
        r_xy=z2.clone(),
        l_desc=zd,
        r_desc=zd.clone(),
        mask=torch.zeros(c, dtype=torch.bool, device=device),
        ids=torch.full((c,), -1, dtype=torch.int32, device=device),
    )
    eye = torch.eye(4, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VOState(
        prev=prev,
        pose_c2w=eye,
        prev_rel=eye.clone(),
        frame_idx=torch.zeros((), dtype=torch.int64, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        gen=gen,
    )


def _membership(query_idx, query_mask, ref_idx, ref_mask) -> torch.Tensor:
    """query_idx[i] in the ref_idx set? -> [Cq] bool (masked)."""
    eq = (query_idx[:, None] == ref_idx[None, :]) & query_mask[:, None] & ref_mask[None, :]
    return eq.any(dim=1)


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 (the runner stages 1 byte/px)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def stage_columns(frames: int) -> tuple:
    """The stage each stamp of a step over ``frames`` frames ends (module docstring), column by column."""
    return ("start", "detect") + ("match", "pose") * frames + ("map",) * frames


_local = threading.local()  # .stamps: the StageStamps of the step body this thread runs, or None


@contextlib.contextmanager
def _stamping(stamps):
    """The fused factories' step body writes its stage stamps into ``stamps`` (None: none)."""
    prev = getattr(_local, "stamps", None)
    _local.stamps = stamps
    try:
        yield
    finally:
        _local.stamps = prev


def _mark(advance: bool = False) -> None:
    """A stage stamp, where the running step body stamps (``_stamping``)."""
    stamps = getattr(_local, "stamps", None)
    if stamps is not None:
        stamps.mark(advance)


def _step_core(
    state: VOState,
    feats_l: Features,
    feats_r: Features,
    calib: StereoCalib,
    cfg: PipelineConfig,
    triples: torch.Tensor | None = None,
    pose_fn=None,
) -> tuple[VOState, FrameOutput]:
    """Everything after detection: the serial, pose-dependent part of a frame.

    RANSAC draws from ``state.gen`` unless ``triples`` [H, 3] are given.
    ``pose_fn(px2d, pts3d, mask, gen, triples)`` replaces the single-device
    estimate (the mesh's hypothesis-sharded one: ``_mesh_step_overrides``).
    Stamps the ends of ``match`` and ``pose`` (module docstring).
    """
    cap = cfg.max_tracks
    stereo, m_st = stereo_features_with_matches(feats_l, feats_r, cfg.matcher, cap)
    # (check_finite does nothing outside utils.debug.nan_debug)
    check_finite("stereo_match", (stereo.l_xy, stereo.r_xy, stereo.l_desc, stereo.r_desc), stereo.mask)

    # --- temporal 4-view cascade (VO.m:106-107 / 280-334) ---
    tr: TrackResult = track(state.prev, feats_l, feats_r, cfg.matcher, cap)
    cur_l_px = gather_rows(feats_l.xy, tr.cur_l_idx, tr.mask)
    cur_r_px = gather_rows(feats_r.xy, tr.cur_r_idx, tr.mask)
    old_l_px = gather_rows(state.prev.l_xy, tr.old_row, tr.mask)
    old_r_px = gather_rows(state.prev.r_xy, tr.old_row, tr.mask)
    check_finite("track", (cur_l_px, cur_r_px, old_l_px, old_r_px), tr.mask)
    _mark()  # match

    # --- triangulate both frames (VO.m:113-116) ---
    X_prev = triangulate_rectified(old_l_px, old_r_px, calib)
    X_cur = triangulate_rectified(cur_l_px, cur_r_px, calib)
    depth_ok = (X_prev[:, 2] > 0.1) & (X_prev[:, 2] < 400.0)
    pose_mask = tr.mask & depth_ok
    check_finite("triangulate", (X_prev, X_cur), tr.mask)

    # --- RANSAC-P3P world pose (VO.m:123-127) ---
    if pose_fn is None:
        est = estimate_world_pose(cur_l_px, X_prev, pose_mask, calib, cfg.ransac, gen=state.gen, triples=triples)
    else:
        est = pose_fn(cur_l_px, X_prev, pose_mask, state.gen, triples)

    check_finite("ransac_p3p", (est.pose_c2w, est.mean_err), est.ok)

    # --- chain / fallback (VO.m:130): identity on frame 1, constant velocity on failure ---
    first = state.frame_idx == 0
    eye = torch.eye(4, dtype=state.prev_rel.dtype, device=state.prev_rel.device)
    rel = torch.where(est.ok, est.pose_c2w, torch.where(first, eye, state.prev_rel))
    pose = torch.where(first, state.pose_c2w, se3.compose(state.pose_c2w, rel))
    check_finite("chain", (rel, pose))

    # --- new-landmark selection (VO.m:141-161): stereo pairs whose left feature was not tracked ---
    tracked_l = _membership(m_st.a_idx, m_st.mask, tr.cur_l_idx, tr.mask)
    new_mask = m_st.mask & ~tracked_l
    new_l_px = gather_rows(feats_l.xy, m_st.a_idx, new_mask)
    new_r_px = gather_rows(feats_r.xy, m_st.b_idx, new_mask)

    disp = torch.linalg.vector_norm(X_cur - X_prev, dim=-1)

    # --- persistent track ids: a stereo row inherits the id of the previous-frame
    # feature its left feature was tracked from; untracked rows get fresh ids ---
    eq = (m_st.a_idx[:, None] == tr.cur_l_idx[None, :]) & m_st.mask[:, None] & tr.mask[None, :]
    inherited_pos = torch.argmax(eq.to(torch.int32), dim=1)  # first match; CUDA has no bool argmax
    has_parent = eq.any(dim=1)
    parent_ids = state.prev.ids[tr.old_row[inherited_pos]]
    fresh_needed = m_st.mask & ~has_parent
    fresh_ids = state.next_id + torch.cumsum(fresh_needed.to(torch.int32), dim=0, dtype=torch.int32) - 1
    minus1 = torch.full_like(fresh_ids, -1)
    ids = torch.where(m_st.mask, torch.where(has_parent, parent_ids, fresh_ids), minus1).to(torch.int32)
    next_id = state.next_id + fresh_needed.sum(dtype=torch.int32)

    new_state = VOState(
        prev=stereo._replace(ids=ids),
        pose_c2w=pose,
        prev_rel=rel,
        frame_idx=state.frame_idx + 1,
        next_id=next_id,
        gen=state.gen,
    )
    out = FrameOutput(
        pose_c2w=pose,
        rel_pose=rel,
        pose_ok=est.ok & ~first,
        n_tracks=pose_mask.sum(),
        n_inliers=est.n_inliers,
        mean_reproj_err=est.mean_err,
        tracked_cur_px=cur_l_px,
        tracked_old_px=old_l_px,
        tracked_disp_3d=torch.where(tr.mask, disp, 0.0),
        tracked_mask=tr.mask,
        new_lm_l_px=new_l_px,
        new_lm_r_px=new_r_px,
        new_lm_mask=new_mask,
    )
    _mark()  # pose
    return new_state, out


def _mesh_step_overrides(calib: StereoCalib, cfg: PipelineConfig, mesh):
    """(pose_fn, data_sharded) routing the step through the dist layer.

    "model" axis > 1 -> hypothesis-sharded RANSAC (dist.ransac_sharded: every
    rank scores its rows of the replicated draw, one all-gather picks the
    winner); "data" axis > 1 -> the stereo detection batch sharded across the
    axis (dist.frontend_batch: the batch is the L/R pair, so data must be 1 or
    2; each data rank detects ONE image and the pair's features are
    all-gathered before the replicated ``_step_core``).
    """
    if mesh is None:
        return None, False
    pose_fn = None
    if axis_size(mesh, "model") > 1:

        def pose_fn(px2d, pts3d, mask, gen, triples=None):
            return estimate_world_pose_sharded(px2d, pts3d, mask, calib, cfg.ransac, gen, mesh, triples=triples)

    data = axis_size(mesh, "data")
    if data > 1 and data != 2:
        raise ValueError(f"integrated step shards the stereo pair on 'data'; axis size {data} != 2")
    return pose_fn, data > 1


def _detect(imgs: torch.Tensor, cfg: PipelineConfig, mesh=None) -> Features:
    """Detect + describe ``imgs`` [B, H, W]; with ``mesh``, sharded over its "data" axis."""
    feats = detect_and_describe(imgs, cfg.sift) if mesh is None else detect_batch(imgs, cfg.sift, mesh)
    check_finite("detect_and_describe", tuple(feats), feats.mask)
    return feats


def _image_features(feats: Features, i: int) -> Features:
    return Features(*(f[i] for f in feats))


def vo_step_multi(state: VOState, frames, calib: StereoCalib, cfg: PipelineConfig) -> tuple[VOState, list]:
    """N frames, detection batched across all 2N images; ``frames`` is (l0, r0, l1, r1, ...).

    Detection is pose-independent, so one batched detect_and_describe covers
    every image; the serial tracking / RANSAC / chaining then runs frame by
    frame. Returns (state, [FrameOutput x N]). Stamps the end of ``detect``
    (module docstring).
    """
    feats = _detect(torch.stack([_normalize(f) for f in frames]), cfg)
    _mark()  # detect
    outs = []
    for k in range(len(frames) // 2):
        state, out = _step_core(state, _image_features(feats, 2 * k), _image_features(feats, 2 * k + 1), calib, cfg)
        outs.append(out)
    return state, outs


def vo_step(
    state: VOState,
    left: torch.Tensor,
    right: torch.Tensor,
    calib: StereoCalib,
    cfg: PipelineConfig,
    return_feats: bool = False,
    pose_fn=None,
    mesh=None,
):
    """One frame -> (state, FrameOutput).

    ``return_feats`` also returns the FULL left detection set (xy, desc,
    mask): loop-closure verification matches the query keyframe's complete
    detections, not just its stereo subset (slam.loop_closure). ``mesh`` (a
    ``DeviceMesh`` from dist.mesh.make_mesh) runs the step distributed: every
    rank of the mesh calls it with the same arguments and ends with the same
    state (``_mesh_step_overrides``); ``pose_fn`` overrides the pose estimate.
    Stamps the end of ``detect`` (module docstring).
    """
    mesh_pose_fn, data_sharded = _mesh_step_overrides(calib, cfg, mesh)
    feats = _detect(torch.stack([_normalize(left), _normalize(right)]), cfg, mesh if data_sharded else None)
    _mark()  # detect
    feats_l = _image_features(feats, 0)
    state, out = _step_core(
        state, feats_l, _image_features(feats, 1), calib, cfg, pose_fn=pose_fn if pose_fn is not None else mesh_pose_fn
    )
    if return_feats:
        return state, out, (feats_l.xy, feats_l.desc, feats_l.mask)
    return state, out


def _compiled(fn, calib: StereoCalib, graph, pool, name: str, backends=None):
    """``fn(carry, *frames) -> (carry, outputs)`` as a factory's step ``step(carry, frames)``: the eager
    function where ``graphs.wanted`` says so for ``calib``'s device and the ``backends`` of the
    groups ``fn`` reduces over, else one ``graphs.StaticStep`` per shape of the frames, counted in
    ``graphs.PROGRAMS`` under ``name``."""
    if not graphs.wanted(graph, calib.P1.device, backends):
        return lambda carry, frames: fn(carry, *frames)
    pool = pool if pool is not None else graphs.Pool(calib.P1.device)
    by_shape: dict = {}

    def step(carry, frames):
        key = tuple((f.shape, f.dtype) for f in frames)
        s = by_shape.get(key)
        if s is None:
            s = by_shape[key] = graphs.StaticStep(fn, carry, frames, calib.P1.device, name, pool)
        return s(carry, frames)

    return step


def make_jitted_step(calib: StereoCalib, cfg: PipelineConfig, precision: str | None = None, graph=None, pool=None):
    """The per-frame step, ``step(state, left, right) -> (state, out)`` (reference: the same name).

    There is no ``key``: RANSAC draws from ``state.gen``. ``precision``
    (default cfg.matmul_precision) names the matmul precision of the step;
    every name is float32 on the card (utils.precision). ``graph``: None
    captures on a CUDA device and runs eagerly on the CPU, False is the eager
    step, True on the CPU raises (utils.graphs). Captured, the returned state
    and output are the step's static buffers; ``pool`` (a ``graphs.Pool``)
    shares one graph memory pool between steps.
    """
    precision = cfg.matmul_precision if precision is None else precision

    def fn(state, left, right):
        with matmul_precision(precision):
            return vo_step(state, left, right, calib, cfg)

    step = _compiled(fn, calib, graph, pool, "frame_step")
    return lambda state, left, right: step(state, (left, right))


def make_fused_loop_step(
    calib: StereoCalib,
    cfg: PipelineConfig,
    precision: str | None = None,
    with_landmarks: bool = False,
    mesh=None,
    with_query_feats: bool = False,
    graph=None,
    pool=None,
    stamps=None,
):
    """ONE step per frame for the frame loop, the landmark insert folded in (reference: the same name).

    Returns ``step(state, lmap, left, right) -> (state, lmap, out)``; pass
    ``lmap=None`` when ``with_landmarks=False``. The map is updated in place
    (the reference donates it); captured, the step inserts into its own static
    map, which it returns. ``with_query_feats`` appends the full left
    detection set ``(xy, desc, mask)`` (the loop-closure query side). ``mesh``
    runs the step distributed (``vo_step``): every rank captures its own graph
    where the step's collectives go over NCCL, and steps eagerly where they go
    over gloo (``graph=True`` there raises; utils.graphs.wanted); every rank
    must call the step as often as the others. ``precision``, ``graph`` and
    ``pool`` as in ``make_jitted_step``; ``stamps`` (utils.profiling.StageStamps)
    writes the stage stamps (module docstring; 5 a step).
    """
    precision = cfg.matmul_precision if precision is None else precision

    def fn(carry, left, right):
        state, lmap = carry
        with _stamping(stamps), matmul_precision(precision):
            _mark()  # start
            r = vo_step(state, left, right, calib, cfg, return_feats=with_query_feats, mesh=mesh)
            state, out = r[0], r[1]
            if with_landmarks:
                lmap = lm_mod.insert(lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks)
            _mark(advance=True)  # map
        return (state, lmap), ((out, r[2]) if with_query_feats else (out,))

    step = _compiled(fn, calib, graph, pool, "frame_step", collective_backends(mesh))

    def loop_step(state, lmap, left, right):
        (state, lmap), outs = step((state, lmap), (left, right))
        return (state, lmap, *outs)

    return loop_step


def make_fused_multi_step(
    calib: StereoCalib,
    cfg: PipelineConfig,
    precision: str | None = None,
    with_landmarks: bool = False,
    group: int = 2,
    graph=None,
    pool=None,
    stamps=None,
):
    """``group`` frames per step, detection batched across all of them (reference: the same name).

    Returns ``stepN(state, lmap, l0, r0, ..., l{g-1}, r{g-1}) -> (state, lmap,
    out0, ..., out{g-1})``: ``vo_step_multi`` and, with ``with_landmarks``,
    each frame's insert. ``precision``, ``graph`` and ``pool`` as in
    ``make_jitted_step``, ``stamps`` as in ``make_fused_loop_step`` (2 + 3 ×
    ``group`` a step).
    """
    precision = cfg.matmul_precision if precision is None else precision

    def fn(carry, *frames):
        state, lmap = carry
        with _stamping(stamps), matmul_precision(precision):
            _mark()  # start
            state, outs = vo_step_multi(state, frames, calib, cfg)
            for k, out in enumerate(outs):
                if with_landmarks:
                    lmap = lm_mod.insert(
                        lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks
                    )
                _mark(advance=k == len(outs) - 1)  # map
        return (state, lmap), tuple(outs)

    step = _compiled(fn, calib, graph, pool, "group_step")

    def stepN(state, lmap, *frames):
        if len(frames) != 2 * group:
            raise ValueError(f"expected {2 * group} images (a left and a right per frame of the group), got {len(frames)}")
        (state, lmap), outs = step((state, lmap), frames)
        return (state, lmap, *outs)

    return stepN
