"""The port's step factories (odometry.pipeline) and their static-buffer plumbing (utils.graphs).

On the CPU a factory's step is the eager step; on a CUDA card it is one CUDA
graph per frame shape over static buffers. A CUDA graph cannot run here, so
the ``static`` fixture stands in for ``graphs.capture``: its "replay" runs the
recorded body and writes the outputs into static buffers, as a replay
overwrites a graph's outputs. Everything around the capture (the static
state, map and frames, the copies in and out, the generator, the runner's
copies of what it keeps) then runs as it does on the card. Sizes: 128x256
images, 2 octaves, 256 keypoints, 64 RANSAC hypotheses, on the committed
KITTI-00 geometry.
"""
import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu.eval import metrics
from vo_tpu.io import synthetic as r_syn
from vo_tpu.odometry import landmarks as r_lm
from vo_tpu.odometry import pipeline as r_pipe
from vo_tpu_torch import convert
from vo_tpu_torch.dist import mesh as p_mesh
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import landmarks as p_lm
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.utils import cuda_lib, debug, graphs

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (128, 256)
N_FRAMES = 6
ATE_MAX_M, POS_TOL_M = 0.05, 0.03  # tests/test_torch_pipeline.py::test_run_sequence_matches_reference


def _cfg(**kw):
    return PipelineConfig(
        sift=SIFTConfig(max_keypoints=256, n_octaves=2), ransac=RansacConfig(n_hypotheses=64), max_tracks=256, **kw
    )


def _pcfg(**kw):
    return convert.config_from_reference(_cfg(**kw))


class _BodyReplay:
    """``graphs.capture``'s stand-in on the CPU: a replay runs the body and writes its outputs into
    the static outputs made at capture."""

    def __init__(self, body):
        self.body = body
        self.outputs = graphs.static_copy(body())
        self.launches = {}

    def replay(self):
        graphs.copy_into(self.outputs, self.body())
        return self.outputs


@pytest.fixture()
def static(monkeypatch):
    """Steps take the static-buffer path on the CPU, with the body in place of a graph's replay."""
    made = []

    def capture(body, device, pool=None, generators=()):
        graphs.refuse_nan_debug()
        made.append(_BodyReplay(body))
        return made[-1]

    monkeypatch.setattr(graphs, "wanted", lambda graph, device, mesh=None: mesh is None and graph is not False)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "Pool", lambda device: None)
    return made


@pytest.fixture(scope="module")
def seqs():
    kw = dict(n_frames=N_FRAMES, n_landmarks=900, seed=7, image_size=SIZE)
    return p_syn.kitti_synthetic_sequence(**kw), r_syn.kitti_synthetic_sequence(str(DATA.parent), **kw)


def _frames(seq, n):
    return [tuple(torch.from_numpy(np.asarray(im, np.float32)) for im in seq.frame(i)) for i in range(n)]


def _host(tree) -> list:
    """Every leaf of a step's result as numpy (a generator as its state), copied now."""
    if isinstance(tree, torch.Tensor):
        return [tree.numpy().copy()]
    if isinstance(tree, torch.Generator):
        return [tree.get_state().numpy().copy()]
    if tree is None:
        return []
    return [a for x in tree for a in _host(x)]


def _assert_same(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}: leaf {k}"


def _eager_steps(kind, calib, cfg, frames):
    """The factories' eager counterparts, from init_state(seed 0) and an empty map -> per-step results."""
    state, lmap = p_pipe.init_state(cfg, 0, "cpu"), p_lm.init_map(cfg.landmarks, "cpu")
    rows = []
    if kind == "multi":
        for k in range(0, len(frames), 2):
            state, outs = p_pipe.vo_step_multi(state, [*frames[k], *frames[k + 1]], calib, cfg)
            for out in outs:
                p_lm.insert(lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks)
            rows.append(_host((state, lmap, *outs)))
        return rows
    for left, right in frames:
        r = p_pipe.vo_step(state, left, right, calib, cfg, return_feats=kind == "loop")
        state = r[0]
        if kind == "loop":
            p_lm.insert(lmap, r[1].new_lm_l_px, r[1].new_lm_r_px, r[1].new_lm_mask, r[1].pose_c2w, calib, cfg.landmarks)
            rows.append(_host((state, lmap, r[1], r[2])))
        else:
            rows.append(_host((state, r[1])))
    return rows


def _factory_steps(kind, calib, cfg, frames):
    state, lmap = p_pipe.init_state(cfg, 0, "cpu"), p_lm.init_map(cfg.landmarks, "cpu")
    rows = []
    if kind == "jitted":
        step = p_pipe.make_jitted_step(calib, cfg)
        for left, right in frames:
            state, out = step(state, left, right)
            rows.append(_host((state, out)))
    elif kind == "loop":
        step = p_pipe.make_fused_loop_step(calib, cfg, with_landmarks=True, with_query_feats=True)
        for left, right in frames:
            state, lmap, out, query = step(state, lmap, left, right)
            rows.append(_host((state, lmap, out, query)))
    else:
        step = p_pipe.make_fused_multi_step(calib, cfg, with_landmarks=True, group=2)
        for k in range(0, len(frames), 2):
            state, lmap, *outs = step(state, lmap, *frames[k], *frames[k + 1])
            rows.append(_host((state, lmap, *outs)))
    return rows


@pytest.mark.parametrize("mode", ["eager", "static"])
@pytest.mark.parametrize("kind", ["jitted", "loop", "multi"])
def test_factories_equal_the_eager_step(seqs, kind, mode, request):
    """Each factory's step returns exactly what vo_step / vo_step_multi + landmarks.insert return
    from the same seed, frame by frame (state with its generator, map, outputs): eagerly, and over
    static buffers that each step overwrites."""
    made = request.getfixturevalue("static") if mode == "static" else None
    cfg = _pcfg()
    calib = seqs[0].calib
    frames = _frames(seqs[0], 4)
    got = _factory_steps(kind, calib, cfg, frames)
    if made is not None:
        assert len(made) == 1  # one static step for the one frame shape, replayed each call
    want = _eager_steps(kind, calib, cfg, frames)
    assert len(got) == len(want) == (2 if kind == "multi" else 4)
    for k, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{kind} step {k}")


def _reference_run(kind, seq, cfg, n):
    """Poses and pose_ok of frames 1..n-1 through the reference's factory."""
    frames = [tuple(jnp.asarray(im, jnp.float32) for im in seq.frame(i)) for i in range(n)]
    outs = []
    if kind == "jitted":
        step = r_pipe.make_jitted_step(seq.calib, cfg)
        state, key = r_pipe.init_state(cfg), jax.random.PRNGKey(0)
        for left, right in frames:
            key, sub = jax.random.split(key)
            state, out = step(state, left, right, sub)
            outs.append(out)
    else:
        step = r_pipe.make_fused_multi_step(seq.calib, cfg, with_landmarks=True, group=2)
        state, lmap = r_pipe.init_state(cfg), r_lm.init_map(cfg.landmarks)
        for k in range(0, n, 2):
            state, lmap, *o = step(state, lmap, *frames[k], *frames[k + 1])
            outs += o
    return np.stack([np.asarray(o.pose_c2w) for o in outs[1:]]), np.asarray([bool(o.pose_ok) for o in outs[1:]])


def _port_run(kind, seq, cfg, n):
    frames = _frames(seq, n)
    state, lmap = p_pipe.init_state(cfg, 0, "cpu"), p_lm.init_map(cfg.landmarks, "cpu")
    outs = []
    if kind == "jitted":
        step = p_pipe.make_jitted_step(seq.calib, cfg)
        for left, right in frames:
            state, out = step(state, left, right)
            outs.append(convert.to_numpy(out))
    else:
        step = p_pipe.make_fused_multi_step(seq.calib, cfg, with_landmarks=True, group=2)
        for k in range(0, n, 2):
            state, lmap, *o = step(state, lmap, *frames[k], *frames[k + 1])
            outs += convert.to_numpy(o)
    return np.stack([o.pose_c2w for o in outs[1:]]), np.asarray([bool(o.pose_ok) for o in outs[1:]])


@pytest.mark.parametrize("kind", ["jitted", "multi"])
def test_factories_match_the_reference(seqs, kind):
    """The port's factory against the reference's on CPU JAX over the same frames: both within the
    ATE bound, the same pose_ok, and every frame's relative pose close (RANSAC draws differ)."""
    p_seq, r_seq = seqs
    r_poses, r_ok = _reference_run(kind, r_seq, _cfg(), N_FRAMES)
    p_poses, p_ok = _port_run(kind, p_seq, _pcfg(), N_FRAMES)
    gt = np.asarray(r_seq.gt_poses)[:N_FRAMES]
    assert p_poses.shape == r_poses.shape == (N_FRAMES - 1, 4, 4)
    assert metrics.ate(p_poses, gt)["rmse"] <= ATE_MAX_M
    assert metrics.ate(r_poses, gt)["rmse"] <= ATE_MAX_M
    np.testing.assert_array_equal(p_ok, r_ok)
    assert p_ok[1:].all()
    rel = lambda P: np.einsum("tji,tjk->tik", P[:-1, :3, :3], P[1:, :3, 3:] - P[:-1, :3, 3:])[..., 0]  # noqa: E731
    assert np.abs(rel(p_poses) - rel(r_poses)).max() < POS_TOL_M
    assert np.abs(p_poses[:, :3, 3] - r_poses[:, :3, 3]).max() < POS_TOL_M


def test_graph_true_raises_on_the_cpu(seqs):
    calib = seqs[0].calib
    cfg = _pcfg()
    for make in (p_pipe.make_jitted_step, p_pipe.make_fused_loop_step, p_pipe.make_fused_multi_step):
        with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
            make(calib, cfg, graph=True)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        p_runner.run_sequence(seqs[0], cfg, n_frames=2, device="cpu", graph=True)
    # A step that reduces over gloo is eager by rule, and graph=True for it raises and names NCCL
    # (the meshed step on gloo ranks: tests/test_torch_mesh_graphs.py).
    with pytest.raises(ValueError, match="graph=True with a mesh whose collectives go over gloo.*NCCL"):
        graphs.wanted(True, calib.P1.device, ("gloo",))


def test_graphed_step_refuses_nan_debug(seqs, static):
    """Under nan_debug a graphed step raises and names graph=False, at capture and at a replay;
    graph=False traps as before."""
    cfg = _pcfg()
    calib = seqs[0].calib
    (left, right), = _frames(seqs[0], 1)
    step = p_pipe.make_jitted_step(calib, cfg)
    with debug.nan_debug(), pytest.raises(ValueError, match="graph=False"):
        step(p_pipe.init_state(cfg, 0, "cpu"), left, right)
    state, _ = step(p_pipe.init_state(cfg, 0, "cpu"), left, right)
    with debug.nan_debug(), pytest.raises(ValueError, match="graph=False"):
        step(state, left, right)
    with debug.nan_debug():
        eager = p_pipe.make_jitted_step(calib, cfg, graph=False)
        assert int(eager(p_pipe.init_state(cfg, 0, "cpu"), left, right)[0].frame_idx) == 1


def test_replay_adds_the_captured_launches():
    """A replay counts the hand-written kernels' launches it made: what the capture recorded."""

    class _Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    g = _Graph()
    cap = graphs.Captured(g, outputs=("out",), counted={"launches": {"extrema_scores": 1, "bin_maps": 2}})
    before = dict(cuda_lib.LAUNCHES)
    try:
        assert cap.replay() == ("out",) and cap.replay() == ("out",)
        assert g.replays == 2
        assert cuda_lib.LAUNCHES == {
            **before, "extrema_scores": before["extrema_scores"] + 2, "bin_maps": before["bin_maps"] + 4,
        }
    finally:
        cuda_lib.LAUNCHES.update(before)


@pytest.mark.parametrize("counter, key", [("launches", "pose_refine"), ("launches", "gauss_blur"),
                                          ("collectives", "all_reduce")])
def test_a_call_under_capture_counts_at_each_replay(monkeypatch, counter, key):
    """A call counted under a (faked) capture counts as captured, not run; the graph that holds it
    adds it to the counter on each replay. A CPU tensor never asks whether its stream is capturing."""
    assert cuda_lib.COUNTS["launches"] is cuda_lib.LAUNCHES and cuda_lib.COUNTS["collectives"] is p_mesh.COLLECTIVES
    counts = cuda_lib.COUNTS[counter]
    x = torch.zeros(1)

    def asked(*a):
        raise AssertionError("asked whether a CPU tensor's stream is capturing")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", asked)
    assert not cuda_lib.capturing(x)
    before, snap = dict(counts), cuda_lib.captured()
    monkeypatch.setattr(cuda_lib, "capturing", lambda t: True)
    counts.count(key, x)
    counted = cuda_lib.captured(since=snap)
    assert counted == {name: {k: int(name == counter and k == key) for k in c} for name, c in cuda_lib.COUNTS.items()}
    assert counts == before
    cap = graphs.Captured(types.SimpleNamespace(replay=lambda: None), outputs=(), counted=counted)
    try:
        cap.replay()
        cap.replay()
        assert counts == {**before, key: before[key] + 2}
        monkeypatch.setattr(cuda_lib, "capturing", lambda t: False)
        counts.count(key, x)
        assert counts[key] == before[key] + 3 and cuda_lib.captured(since=snap) == counted
    finally:
        counts.update(before)
        counts.captured[key] -= 1


def _refined_feed():
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:8], gt[6::-1]])
    return p_syn.SyntheticSequence(
        p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=900, seed=6, image_size=SIZE
    )


def _refined_cfg():
    cfg = _pcfg()
    return dataclasses.replace(
        cfg,
        ba=dataclasses.replace(cfg.ba, keyframe_every=2, window=4),
        loop=dataclasses.replace(cfg.loop, min_gap=2, verify_cooldown=1),
    )


def test_refined_run_over_static_buffers_equals_the_eager_run(static):
    """A refined run (window BA + loop closure) whose steps write into static buffers equals the
    eager run bit for bit. Every history row and every keyframe handed to the refiner must be a
    copy: a reference to a step's static buffers would hold a later frame's values by the time it
    is read (the worker lags the frame loop), and the poses would differ."""
    seq, cfg = _refined_feed(), _refined_cfg()
    kw = dict(use_ba=True, use_loop_closure=True, warmup=False, device="cpu")
    got = p_runner.run_sequence(seq, cfg, **kw)
    # Each captured once: the single-frame step, the window solve, the verification round, the
    # global descriptor (one query shape: max_keypoints = max_tracks here) and the association.
    assert len(static) == 5
    want = p_runner.run_sequence(seq, cfg, graph=False, **kw)
    assert np.array_equal(got.poses, want.poses), np.abs(got.poses - want.poses).max()
    for k in ("rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for k in ("n_keyframes", "ba_solves", "lc_verified", "loops_closed"):
        assert got.refine_stats[k] == want.refine_stats[k], k
    assert want.refine_stats["ba_solves"] >= 1 and want.refine_stats["n_keyframes"] == 7


def test_plain_run_over_static_buffers_equals_the_eager_run(seqs, static):
    """The deferred path: two-frame groups, then the single-frame tail (5 = 2 + 2 + 1), both steps
    over static buffers; equal to the eager run bit for bit."""
    cfg = _pcfg()
    got = p_runner.run_sequence(seqs[0], cfg, n_frames=5, device="cpu")
    assert len(static) == 2  # the group step and the tail's single-frame step
    want = p_runner.run_sequence(seqs[0], cfg, n_frames=5, device="cpu", graph=False)
    for k in ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.landmarks.shape[0] > 20


def test_resume_through_static_buffers_equals_an_uninterrupted_run(tmp_path, seqs, static):
    """Checkpoint at frame 3 of 6 and resume, the steps over static buffers: the checkpoint reads the
    state from them, the resumed run copies the saved state (and the generator's state) into them."""
    cfg = _pcfg()
    ck = str(tmp_path / "ck.npz")
    kw = dict(device="cpu", warmup=False, progress=lambda i, s: None)
    full = p_runner.run_sequence(seqs[0], cfg, **kw)
    p_runner.run_sequence(seqs[0], cfg, n_frames=3, checkpoint_path=ck, checkpoint_every=3, **kw)
    resumed = p_runner.run_sequence(seqs[0], cfg, checkpoint_path=ck, resume=True, **kw)
    eager = p_runner.run_sequence(seqs[0], cfg, graph=False, **kw)
    for k in ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks"):
        assert np.array_equal(getattr(resumed, k), getattr(full, k)), k
        assert np.array_equal(getattr(full, k), getattr(eager, k)), k
