"""Scoped matmul precision (vo_tpu_torch/utils/precision.py): the TF32 flags are off for the
span of a solver or a run and given back to the caller, whatever the caller had set, when it
returns or raises; a block whose flags are already off writes nothing; unknown names raise.
Each entry point is probed from inside: a callee it reaches first is replaced by a probe that
records the flags and stops the call. tools/precision_torch.py's bare step loop is held to
run_sequence's plain path."""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch.ba import pose_graph, window
from vo_tpu_torch.config import BAConfig, PipelineConfig, RansacConfig
from vo_tpu_torch.dist import ba_sharded, pose_graph_sharded, ransac_sharded
from vo_tpu_torch.odometry import runner
from vo_tpu_torch.pose import ransac
from vo_tpu_torch.slam import loop_closure
from vo_tpu_torch.utils.precision import NAMES, matmul_precision

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

# (cuda.matmul.allow_tf32, cudnn.allow_tf32) as a caller may leave them; the last is torch's own default.
CALLERS = [(True, True), (False, False), (False, True)]
PINNED = (False, False)


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(params=CALLERS, ids=lambda c: f"caller{int(c[0])}{int(c[1])}")
def caller(request):
    """The caller's flags, set before the test and torch's defaults put back after it."""
    before = _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = request.param
    yield request.param
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class _Stop(Exception):
    """Raised by a probe: the entry point is left by an exception, as a failing solve would leave it."""


def _probe(seen: list):
    def probe(*a, **k):
        seen.append(_flags())
        raise _Stop

    return probe


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _eye():
    return torch.eye(4)[None]


# entry point -> (module, name of the first callee it reaches, the call)
ENTRY_POINTS = {
    "estimate_world_pose": (ransac, "best_hypothesis", lambda: ransac.estimate_world_pose(
        None, None, None, None, RansacConfig(), triples=torch.zeros((1, 3), dtype=torch.long))),
    "finalize_pose": (ransac, "_finalize_f32", lambda: ransac.finalize_pose(*[None] * 7, RansacConfig())),
    "solve_window": (window, "_residuals", lambda: window.solve_window(_ns(T_c2w=_eye(), X=None), None, BAConfig())),
    "pose_graph.optimize": (pose_graph, "edge_cost", lambda: pose_graph.optimize(
        _ns(edge_mask=torch.ones(1, dtype=torch.bool), edge_weight=torch.ones(1), T_c2w=_eye()))),
    "LoopCloser._verify": (loop_closure, "match", lambda: loop_closure.LoopCloser._verify(
        _ns(cfg=_ns(match_capacity=4), calib=None, _verify_matcher=None), [(None,) * 4], None, None, None)),
    "_Keyframes._associate": (runner, "match", lambda: runner._Keyframes._associate(
        _ns(cfg=_ns(max_tracks=4, matcher=None), ring_desc=[None], ring_mask=[None]), None, None)),
    "estimate_world_pose_sharded": (ransac_sharded, "axis_size", lambda: ransac_sharded.estimate_world_pose_sharded(
        *[None] * 4, RansacConfig(), None, None)),
    "solve_window_sharded": (ba_sharded, "axis_size", lambda: ba_sharded.solve_window_sharded(
        _ns(X=torch.zeros((4, 3))), None, BAConfig(), None)),
    "optimize_sharded": (pose_graph_sharded, "axis_size", lambda: pose_graph_sharded.optimize_sharded(
        _ns(edge_i=torch.zeros(2)), None)),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_solver_pins_float32_and_restores_the_callers_flags(name, caller, monkeypatch):
    """Inside: both flags off. After (here left by an exception): the caller's own, as set."""
    mod, callee, call = ENTRY_POINTS[name]
    seen = []
    monkeypatch.setattr(mod, callee, _probe(seen))
    with pytest.raises(_Stop):
        call()
    assert seen == [PINNED]
    assert _flags() == caller


@pytest.mark.parametrize(
    "precision_name,use_ba,use_loop_closure",
    [("float32", False, False), ("default", False, False), ("highest", False, False),
     ("default", True, False), ("default", False, True), ("default", True, True)],
)
def test_run_sequence_scopes_its_precision(precision_name, use_ba, use_loop_closure, caller, monkeypatch):
    """The run's body (probed at its first callee) steps with both flags off, at every name and on
    the refined path (the worker is a second thread); the caller's flags come back when it raises."""
    seen = []
    monkeypatch.setattr(runner, "resolve", _probe(seen))
    cfg = PipelineConfig(matmul_precision=precision_name)
    with pytest.raises(_Stop):
        runner.run_sequence(None, cfg, use_ba=use_ba, use_loop_closure=use_loop_closure, device="cpu")
    assert seen == [PINNED]
    assert _flags() == caller


@pytest.mark.parametrize("precision_name", NAMES)
def test_real_run_gives_the_flags_back(precision_name, caller):
    """A whole (tiny) plain run on the CPU, not a stand-in: the flags after it are the caller's."""
    from vo_tpu_torch.config import SIFTConfig
    from vo_tpu_torch.io import synthetic

    seq = synthetic.kitti_synthetic_sequence(n_frames=2, n_landmarks=400, seed=8201, image_size=(60, 200))
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=64), ransac=RansacConfig(n_hypotheses=16), max_tracks=64,
                         matmul_precision=precision_name)
    res = runner.run_sequence(seq, cfg, device="cpu", warmup=False)
    assert res.poses.shape == (1, 4, 4) and np.isfinite(res.poses).all()
    assert _flags() == caller


class _Recorder:
    """Stands for torch.backends.cuda.matmul / torch.backends.cudnn: holds a flag and logs every write."""

    def __init__(self, value: bool, log: list):
        object.__setattr__(self, "allow_tf32", value)
        object.__setattr__(self, "log", log)

    def __setattr__(self, key, value):
        self.log.append((key, value))
        object.__setattr__(self, key, value)


def test_nested_block_inside_a_pinned_run_writes_nothing(monkeypatch):
    """The flags are global to the process: inside a pinned run (a worker thread may be stepping),
    a solver's own float32 block must not write them at all, not even the same value back."""
    log = []
    monkeypatch.setattr(torch.backends.cuda, "matmul", _Recorder(True, log))
    monkeypatch.setattr(torch.backends, "cudnn", _Recorder(True, log))
    with matmul_precision("float32"):
        pinned = len(log)
        with matmul_precision("float32"):
            with matmul_precision("highest"):
                assert _flags() == PINNED
        assert len(log) == pinned
    assert pinned == 2 and _flags() == (True, True) and len(log) == 4


def test_block_restores_on_exception():
    before = _flags()
    with pytest.raises(KeyError):
        with matmul_precision("float32"):
            assert _flags() == PINNED
            raise KeyError("x")
    assert _flags() == before


@pytest.mark.parametrize("name", NAMES)
def test_every_name_is_float32(name, caller):
    """The reference's names, "default" included, all run in float32 on the card (measured:
    PERF.md section 6); the caller's flags come back after the block."""
    with matmul_precision(name):
        assert _flags() == PINNED
    assert _flags() == caller


@pytest.mark.parametrize("bad", ["bfloat16", "tf32", "", "Float32"])
def test_unknown_precision_raises(bad):
    with pytest.raises(ValueError, match="unknown matmul precision"):
        with matmul_precision(bad):
            pass
    for refined in (False, True):
        with pytest.raises(ValueError, match="unknown matmul precision"):
            runner.run_sequence(None, PipelineConfig(matmul_precision=bad), use_ba=refined, device="cpu")


def test_tool_bare_loop_is_run_sequences_plain_path():
    """tools/precision_torch.py times TF32 on a bare copy of the plain deferred loop (run_sequence
    pins its own precision): at float32 its poses are run_sequence's, bit for bit, over an odd
    number of frames (2-frame groups and a single-frame tail), landmarks inserted."""
    from vo_tpu_torch.config import SIFTConfig
    from vo_tpu_torch.io import synthetic

    spec = importlib.util.spec_from_file_location("_precision_torch", Path(__file__).resolve().parent.parent / "tools" / "precision_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seq = synthetic.kitti_synthetic_sequence(n_frames=5, n_landmarks=1500, seed=8202, image_size=(94, 310))
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=128), ransac=RansacConfig(n_hypotheses=64), max_tracks=128)
    assert cfg.fused_group == 2 and cfg.view_3d
    feed = runner.StagedSequence(seq, 5, "cpu")
    poses, ok, ms = tool.plain_run(feed, 5, cfg, "cpu")
    res = runner.run_sequence(feed, cfg, device="cpu")
    assert poses.shape == (4, 4, 4) and ms > 0
    np.testing.assert_array_equal(poses, res.poses)
    np.testing.assert_array_equal(ok, res.pose_ok)


# --- on the card: the solvers give the same bits whatever the caller allowed ---


def _ransac_problem(device):
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.geom.triangulate import triangulate_rectified

    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(f"{root}/00")
    gt = kitti.read_poses(f"{root}/poses/00.txt")
    rng = np.random.default_rng(0)
    lm = synthetic.scatter_landmarks(rng, gt[:10], 3000)
    tr = synthetic.make_tracks(rng, calib, gt[2], gt[3], lm, noise_px=0.3, outlier_frac=0.3, max_points=1024)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    calib = calib.to(device)
    X = triangulate_rectified(t(tr.px_prev_l), t(tr.px_prev_r), calib)
    return t(tr.px_cur_l), X, torch.ones(X.shape[0], dtype=torch.bool, device=device), calib


def _window_problem(device):
    from vo_tpu_torch.io import kitti, synthetic

    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(f"{root}/00")
    K, M = 6, 512
    gt = kitti.read_poses(f"{root}/poses/00.txt")[: 2 * K : 2]
    rng = np.random.default_rng(1)
    lms = synthetic.scatter_landmarks(rng, gt, M)
    P1, P2 = (P.numpy().astype(np.float64) for P in (calib.P1, calib.P2))
    obs, obs_ur = np.zeros((K, M, 2), np.float32), np.zeros((K, M), np.float32)
    msk = np.zeros((K, M), bool)
    H, W = calib.image_size
    for k in range(K):
        cam = synthetic._w2c_apply(gt[k], lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px, pxr = synthetic.project_np(P1, safe), synthetic.project_np(P2, safe)
        msk[k] = (cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        obs[k] = px + rng.normal(scale=0.3, size=px.shape)
        obs_ur[k] = pxr[:, 0] + rng.normal(scale=0.3, size=M)
    T0 = gt.astype(np.float32).copy()
    T0[1:, :3, 3] += rng.normal(scale=0.05, size=(K - 1, 3)).astype(np.float32)
    X0 = (lms + rng.normal(scale=0.3, size=lms.shape)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    prob = window.BAProblem(
        T_c2w=t(T0), X=t(X0), obs_uv=t(obs), obs_mask=t(msk), obs_ur=t(obs_ur), obs_ur_mask=t(msk.copy()),
        X_mask=torch.ones(M, dtype=torch.bool, device=device), kf_mask=torch.ones(K, dtype=torch.bool, device=device),
    )
    return prob, calib.to(device)


@pytest.mark.gpu
def test_solvers_same_bits_whatever_the_caller_allowed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    px, X, mask, calib = _ransac_problem(dev)
    prob, wcalib = _window_problem(dev)
    gen = torch.Generator(device=dev)
    before = _flags()
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            gen.manual_seed(3)
            est = ransac.estimate_world_pose(px, X, mask, calib, RansacConfig(), gen=gen)
            sol = window.solve_window(prob, wcalib, BAConfig())
            torch.cuda.synchronize()
            out[tf32] = (est, sol)
            assert _flags() == (tf32, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    for a, b in zip(out[False], out[True]):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
