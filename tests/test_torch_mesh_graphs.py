"""The mesh's programs as CUDA graphs (utils.graphs under dist.mesh), and the undistort warp's graph.

Under a mesh each rank captures and replays its own graphs, program by
program (``graphs.wanted``): the meshed step and the landmark-sharded window
solve where their collectives go over NCCL, the programs without a collective
(verification round, global descriptor, keyframe association) under any mesh,
and nothing that issues a collective over gloo.

A CUDA graph cannot run here, so a launched rank (dist.mesh.launch: gloo on
the CPU, real processes) stands in for the capture as ``tests/test_torch_graphs.py``
does: ``_capture`` runs the body once eagerly (the warm-up), once more "under
capture", where the mesh's collectives count apart
(``dist.mesh.COLLECTIVES.captured``, as on the card), and each replay runs the body again the same way and writes
the outputs into the static outputs made at capture; ``utils.graphs.Captured``
then adds the captured collectives per replay, as on the card. ``wanted``
says yes to every program of the mesh, so the (2, 2) plain run and the
(1, 2) run with window BA go through ``StaticStep`` / ``StaticCall`` on every
rank, and must equal the same runs with ``graph=False`` bit for bit, with the
same collectives per step and per solve. The same worlds hold the rule by
backend: over gloo the step and the sharded solve stay eager (``graph=True``
raises and names NCCL) and the collective-free programs are captured. Two
worlds, each with its own time limit. Sizes: 160x320 images, 2 octaves, 256
keypoints, 128 hypotheses, a window of 6 keyframes of 256 landmarks.

The ``gpu`` cases capture for real on the card: an NCCL world of one with the
four sharded entry points captured as ``StaticCall``s, and the (2, 2) and
(1, 4) + BA runs with a card per rank (they skip below four cards).
"""
import contextlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.dist import mesh as p_mesh
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.io import undistort as p_und
from vo_tpu_torch.odometry import ba_runner as p_bar
from vo_tpu_torch.odometry import landmarks as p_lm
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import refiner as p_ref
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.utils import cuda_lib, graphs

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (160, 320)
N_FRAMES = 10
FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
UNDISTORT_TOL = 1e-5  # chip_smoke.py phase 10
WORLD_TIMEOUT_S = 300.0


def _cfg():
    c = p_config
    return c.PipelineConfig(
        sift=c.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=c.RansacConfig(n_hypotheses=128),
        landmarks=c.LandmarkConfig(capacity=20000),
        ba=c.BAConfig(keyframe_every=2, window=6, max_points=256),
        max_tracks=256,
    )


def _feed(n_frames=N_FRAMES):
    return p_syn.kitti_synthetic_sequence(n_frames=n_frames, n_landmarks=1200, seed=4, image_size=SIZE)


def _as_dict(res) -> dict:
    out = {k: getattr(res, k) for k in FIELDS}
    out["refine_stats"] = {k: res.refine_stats[k] for k in ("n_keyframes", "ba_solves", "ba_rejected") if k in res.refine_stats}
    return out


def _assert_same(a: dict, b: dict, what: str):
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    assert a["refine_stats"] == b["refine_stats"], what


# ---- the capture's stand-in (inside a launched rank) -------------------------------------------

_RECORDING = threading.local()  # set while the stand-in "records": the thread's collectives count apart


@contextlib.contextmanager
def _recording():
    _RECORDING.on = True
    try:
        yield
    finally:
        _RECORDING.on = False


class _BodyGraph:
    """A CUDA graph's stand-in: a replay runs the recorded body, its collectives counted as a capture
    counts them (``graphs.Captured.replay`` adds those), and writes the static outputs."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        with _recording():
            graphs.copy_into(self.outputs, self.body())


def _capture(body, device, pool=None, generators=()):
    """``graphs.capture``'s stand-in: the eager warm-up run, then the "capture", whose collectives
    ``dist.mesh`` counts as captured, as a real capture does."""
    graphs.refuse_nan_debug()
    body()
    before = cuda_lib.captured()
    with _recording():
        outputs = graphs.static_copy(body())
    counted = cuda_lib.captured(since=before)
    CAPTURES.append(counted["collectives"])
    return graphs.Captured(_BodyGraph(body, outputs), outputs, counted)


CAPTURES: list = []  # the collectives of each capture this rank made


def _stand_in(rule):
    """Route this rank's programs through the stand-in; ``rule`` replaces ``graphs.wanted``."""
    cuda_lib.capturing = lambda t: getattr(_RECORDING, "on", False)
    graphs.capture = _capture
    graphs.Pool = lambda device: None
    graphs.wanted = rule


def _yes_to_the_mesh(graph, device, backends=None):
    return graph is not False


_REAL_WANTED = graphs.wanted


def _as_on_a_card(graph, device, backends=None):
    """The real rule, for a program on a CUDA device (the ranks' CPU stands in for it)."""
    return _REAL_WANTED(graph, "cuda", backends)


def _step_collectives(mesh, device, seq, cfg) -> dict:
    """Collectives of two meshed steps after the first (the capture, where graphed): graphed and eager."""
    calib = seq.calib.to(device)
    frames = [tuple(p_runner.to_device(im, device) for im in seq.frame(i)) for i in range(3)]
    counts = {}
    for name, g in (("graphed", None), ("eager", False)):
        step = p_pipe.make_fused_loop_step(calib, cfg, with_landmarks=True, mesh=mesh, graph=g)
        state, lmap = p_pipe.init_state(cfg, 0, device), p_lm.init_map(cfg.landmarks, device)
        state, lmap, _ = step(state, lmap, *frames[0])
        p_mesh.COLLECTIVES.reset()
        for f in frames[1:]:
            state, lmap, _ = step(state, lmap, *f)
        counts[name] = dict(p_mesh.COLLECTIVES)
    return counts


def _solve_collectives(mesh, device, seq, cfg) -> dict:
    """Collectives of one landmark-sharded window solve after the first (the capture): graphed and eager."""
    counts = {}
    for name, g in (("graphed", None), ("eager", False)):
        wba = p_bar.WindowedBA(seq.calib, cfg.ba, device=device, mesh=mesh, graph=g)
        wba.warmup()
        p_mesh.COLLECTIVES.reset()
        wba.warmup()
        counts[name] = dict(p_mesh.COLLECTIVES)
    return counts


def _static_rank(mesh, device, use_ba):
    """One rank of a launched world: the meshed run through the static buffers and eagerly, the
    collectives per step (and per solve) both ways, then the real rule by backend over gloo."""
    _stand_in(_yes_to_the_mesh)
    seq, cfg = _feed(), _cfg()
    kw = dict(warmup=False, mesh=mesh, device=device, use_ba=use_ba)
    CAPTURES.clear()
    graphs.reset_programs()
    static = _as_dict(p_runner.run_sequence(seq, cfg, **kw))
    out = dict(static=static, static_captures=list(CAPTURES), programs=dict(graphs.PROGRAMS))
    out["eager"] = _as_dict(p_runner.run_sequence(seq, cfg, graph=False, **kw))
    out["step_collectives"] = _step_collectives(mesh, device, seq, cfg)
    if use_ba:
        out["solve_collectives"] = _solve_collectives(mesh, device, seq, cfg)

    # The real rule, as on a card whose ranks share it over gloo.
    _stand_in(_as_on_a_card)
    out["backends"] = p_mesh.collective_backends(mesh)
    CAPTURES.clear()
    step = p_pipe.make_fused_loop_step(seq.calib, cfg, with_landmarks=True, mesh=mesh)
    step(p_pipe.init_state(cfg, 0, device), p_lm.init_map(cfg.landmarks, device),
         *(p_runner.to_device(im, device) for im in seq.frame(0)))
    out["step_captures"] = len(CAPTURES)
    try:
        p_pipe.make_fused_loop_step(seq.calib, cfg, mesh=mesh, graph=True)
    except ValueError as e:
        out["step_graph_true"] = str(e)
    if use_ba:
        graphs.reset_programs()
        worker = p_ref.RefinerWorker(seq.calib, cfg, use_ba=True, use_loop_closure=True, device=device, mesh=mesh)
        try:
            kfs = p_runner._Keyframes(worker, cfg, device, use_ba=True)
            out["worker"] = dict(
                solve_graphed=worker.wba._graphed,
                rounds=type(worker.lclo._rounds).__name__,
                gdesc=type(worker._gdesc).__name__,
                assoc=type(kfs._assoc).__name__,
                programs={k: v["captures"] for k, v in graphs.PROGRAMS.items()},
            )
        finally:
            worker.close()
        try:
            p_bar.WindowedBA(seq.calib, cfg.ba, device=device, mesh=mesh, graph=True)
        except ValueError as e:
            out["solve_graph_true"] = str(e)
    return out


def _check_world(per_rank, use_ba):
    for r, out in enumerate(per_rank):
        _assert_same(out["static"], out["eager"], f"rank {r}: static buffers against eager")
        _assert_same(out["static"], per_rank[0]["static"], f"rank {r} against rank 0")
        counts = out["step_collectives"]
        assert counts["graphed"] == counts["eager"] and sum(counts["eager"].values()) > 0, counts
        assert out["backends"] and set(out["backends"]) == {"gloo"}
        # Over gloo the meshed step stays eager by rule, and asking for its graph names NCCL.
        assert out["step_captures"] == 0
        assert "NCCL" in out["step_graph_true"] and "gloo" in out["step_graph_true"]
        # The static run's first capture is its step's, and holds the step's collectives.
        assert sum(out["static_captures"][0].values()) > 0, out["static_captures"]
    if use_ba:
        for out in per_rank:
            counts = out["solve_collectives"]
            assert counts["graphed"] == counts["eager"] and counts["eager"]["all_reduce"] > 0, counts
            assert out["programs"]["window_solve"]["replays"] >= 1
            assert out["worker"] == dict(
                solve_graphed=False, rounds="ByShape", gdesc="ByShape", assoc="StaticCall",
                programs={"verification_round": 1, "global_descriptor": 1, "keyframe_association": 1},
            ), out["worker"]
            assert "NCCL" in out["solve_graph_true"]
        assert per_rank[0]["static"]["refine_stats"]["ba_solves"] >= 1


def test_meshed_run_over_static_buffers_equals_eager():
    """(2, 2), plain VO: detection sharded over "data", RANSAC over "model", through StaticStep."""
    per_rank = p_mesh.launch(_static_rank, (2, 2), "cpu", args=(False,), timeout=WORLD_TIMEOUT_S)
    _check_world(per_rank, use_ba=False)


def test_meshed_ba_run_over_static_buffers_equals_eager():
    """(1, 2) with window BA: the worker's sharded solve through StaticCall over its own group."""
    per_rank = p_mesh.launch(_static_rank, (1, 2), "cpu", args=(True,), timeout=WORLD_TIMEOUT_S)
    _check_world(per_rank, use_ba=True)


# ---- the rule by backend -----------------------------------------------------------------------


@pytest.mark.parametrize(
    "graph, device, backends, want",
    [
        (None, "cuda", None, True),
        (None, "cuda", ("nccl",), True),
        (None, "cuda", ("nccl", "nccl"), True),
        (True, "cuda", ("nccl",), True),
        (False, "cuda", ("nccl",), False),
        (None, "cuda", ("gloo",), False),
        (None, "cuda", ("nccl", "gloo"), False),
        (False, "cuda", ("gloo",), False),
        (None, "cpu", None, False),
        (None, "cpu", ("gloo",), False),
    ],
)
def test_wanted_by_backend(graph, device, backends, want):
    assert graphs.wanted(graph, device, backends) is want


@pytest.mark.parametrize("backends", [("gloo",), ("nccl", "gloo")])
def test_graph_true_with_a_gloo_collective_raises(backends):
    with pytest.raises(ValueError, match="graph=True with a mesh whose collectives go over gloo.*NCCL"):
        graphs.wanted(True, "cuda", backends)
    # on the CPU too: the gloo rule comes first
    with pytest.raises(ValueError, match="NCCL"):
        graphs.wanted(True, "cpu", backends)


# ---- the undistort warp ------------------------------------------------------------------------

MODEL = dict(k1=-0.05, k2=0.002, p1=1e-4, p2=-1e-4, k3=1e-4)


def _calib():
    return p_kitti.load_stereo_calib(str(DATA / "00"))


def _images(n=2):
    rng = np.random.default_rng(3)
    H, W = _calib().image_size
    yy, xx = np.mgrid[0:H, 0:W]
    base = (0.5 + 0.3 * np.sin(xx / 40.0) * np.cos(yy / 30.0)).astype(np.float32)
    return [torch.from_numpy(base + rng.normal(scale=0.02, size=(H, W)).astype(np.float32)) for _ in range(n)]


@pytest.fixture()
def static_programs(monkeypatch):
    """Programs take the static-buffer path on the CPU (the stand-in above, in this process)."""
    monkeypatch.setattr(cuda_lib, "capturing", lambda t: getattr(_RECORDING, "on", False))
    monkeypatch.setattr(graphs, "capture", _capture)
    monkeypatch.setattr(graphs, "Pool", lambda device: None)
    monkeypatch.setattr(graphs, "wanted", lambda graph, device, backends=None: graph is not False)
    graphs.reset_programs()


def test_undistorter_over_static_buffers_equals_eager_and_the_reference(static_programs):
    import jax.numpy as jnp

    from vo_tpu.io import undistort as r_und

    model = p_und.DistortionModel(**MODEL)
    graphed = p_und.Undistorter(_calib(), model, device="cpu")
    eager = p_und.Undistorter(_calib(), model, device="cpu", graph=False)
    assert isinstance(graphed._warp, graphs.ByShape) and not isinstance(eager._warp, graphs.ByShape)
    left, right = _images()
    got_l, got_r = graphed(left), graphed(right)  # one graph for both: each result is the caller's own
    for img, got in ((left, got_l), (right, got_r)):
        want = eager(img)
        assert torch.equal(got, want)
        ref = np.asarray(r_und.undistort_image(jnp.asarray(img.numpy()), jnp.asarray(graphed._remap.numpy())))
        np.testing.assert_allclose(got.numpy(), ref, atol=UNDISTORT_TOL)
    assert (graphs.PROGRAMS["undistort_warp"]["captures"], graphs.PROGRAMS["undistort_warp"]["replays"]) == (1, 2)
    # The identity model returns the image itself and captures nothing.
    assert p_und.Undistorter(_calib(), device="cpu")(left) is left


def test_undistorter_graph_true_raises_on_the_cpu():
    for model in (p_und.DistortionModel(**MODEL), None):
        with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
            p_und.Undistorter(_calib(), model, device="cpu", graph=True)
    assert not isinstance(p_und.Undistorter(_calib(), p_und.DistortionModel(**MODEL), device="cpu")._warp, graphs.ByShape)


# ---- on the card: real capture -----------------------------------------------------------------


def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, have {torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(n)]


def _sharded_calls_rank(mesh, device):
    """An NCCL world of one: the four sharded entry points captured as StaticCalls against eager,
    bit for bit, with the collectives each replay accounts."""
    from vo_tpu_torch.ba import pose_graph, window
    from vo_tpu_torch.dist import ba_sharded, frontend_batch, pose_graph_sharded, ransac_sharded
    from vo_tpu_torch.geom.triangulate import triangulate_rectified

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert torch.distributed.get_backend(mesh.get_group("model")) == "nccl"
    seq, cfg = _feed(4), _cfg()
    calib = seq.calib.to(device)
    rng = np.random.default_rng(0)
    tr = p_syn.make_tracks(rng, seq.calib, seq.gt_poses[0], seq.gt_poses[2], seq.landmarks, noise_px=0.3, max_points=cfg.max_tracks)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    px = dev(tr.px_cur_l)
    X = triangulate_rectified(dev(tr.px_prev_l), dev(tr.px_prev_r), calib)
    mask = torch.ones(px.shape[0], dtype=torch.bool, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    K, M = cfg.ba.window, cfg.ba.max_points
    prob = window.BAProblem(
        T_c2w=torch.eye(4, device=device).repeat(K, 1, 1), X=torch.zeros((M, 3), device=device),
        obs_uv=torch.zeros((K, M, 2), device=device), obs_mask=torch.zeros((K, M), dtype=torch.bool, device=device),
        obs_ur=torch.zeros((K, M), device=device), obs_ur_mask=torch.zeros((K, M), dtype=torch.bool, device=device),
        X_mask=torch.zeros(M, dtype=torch.bool, device=device), kf_mask=torch.zeros(K, dtype=torch.bool, device=device),
    )
    T = torch.from_numpy(np.asarray(seq.gt_poses[:8], np.float32)).to(device)
    g = pose_graph.PoseGraph(T, *pose_graph.odometry_edges(T))
    imgs = torch.stack([dev(im) for im in seq.frame(0)])
    calls = {
        "ransac": (lambda px, X, mask: ransac_sharded.estimate_world_pose_sharded(px, X, mask, calib, cfg.ransac, gen, mesh),
                   (px, X, mask), (gen,)),
        "window": (lambda prob: ba_sharded.solve_window_sharded(prob, calib, cfg.ba, mesh), (prob,), ()),
        "pose_graph": (lambda g: pose_graph_sharded.optimize_sharded(g, mesh, iters=4), (g,), ()),
        "detect": (lambda imgs: frontend_batch.detect_batch(imgs, cfg.sift, mesh), (imgs,), ()),
    }
    out = {}
    for name, (fn, inputs, gens) in calls.items():
        state = gen.get_state()
        call = graphs.StaticCall(fn, inputs, device, name, generators=gens)
        gen.set_state(state)
        p_mesh.COLLECTIVES.reset()
        got = [t.clone() for t in call(*inputs)]
        replayed = dict(p_mesh.COLLECTIVES)
        gen.set_state(state)
        p_mesh.COLLECTIVES.reset()
        want = list(fn(*inputs))
        eager = dict(p_mesh.COLLECTIVES)
        out[name] = dict(equal=all(torch.equal(a, b) for a, b in zip(got, want)), replayed=replayed, eager=eager,
                         captured=call.captured.counted["collectives"])
    return out


@pytest.mark.gpu
def test_sharded_entry_points_captured_over_nccl():
    devices = _cards(1)
    out = p_mesh.launch(_sharded_calls_rank, (1, 1), devices, timeout=WORLD_TIMEOUT_S)[0]
    for name, o in out.items():
        assert o["equal"], name
        assert o["replayed"] == o["eager"] == o["captured"] and sum(o["eager"].values()) > 0, (name, o)


def _card_rank(mesh, device, use_ba):
    seq, cfg = _feed(), _cfg()
    kw = dict(mesh=mesh, device=device, use_ba=use_ba)
    graphs.reset_programs()
    graphed = _as_dict(p_runner.run_sequence(seq, cfg, **kw))
    programs = {k: dict(v) for k, v in graphs.PROGRAMS.items()}
    return graphed, _as_dict(p_runner.run_sequence(seq, cfg, graph=False, **kw)), programs


@pytest.mark.gpu
@pytest.mark.parametrize("shape, use_ba", [((2, 2), False), ((1, 4), True)], ids=["2x2", "1x4_ba"])
def test_meshed_run_with_a_card_per_rank_graphed_equals_eager(shape, use_ba):
    devices = _cards(shape[0] * shape[1])
    per_rank = p_mesh.launch(_card_rank, shape, devices, args=(use_ba,), timeout=WORLD_TIMEOUT_S)
    for r, (graphed, eager, programs) in enumerate(per_rank):
        _assert_same(graphed, eager, f"rank {r}: graphed against eager")
        _assert_same(graphed, per_rank[0][0], f"rank {r} against rank 0")
        if use_ba:
            assert programs["window_solve"]["captures"] == 1 and programs["window_solve"]["replays"] >= 1, programs
