"""The port's own copies of the configuration and the trajectory metrics against vo_tpu's, and
its rule for the default device.

The port imports nothing of vo_tpu, so ``vo_tpu_torch.config`` and
``vo_tpu_torch.eval.metrics`` are copies: every class, field and default must
equal the reference's, ``convert.config_from_reference`` must carry any values
across, and the metrics must give the same numbers on the same trajectories.
Every entry point runs on the CUDA card when given no device, raises where
there is none, and runs on the CPU only when asked (``device="cpu"``).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu import config as r_config
from vo_tpu.eval import metrics as r_metrics
from vo_tpu_torch import config as p_config
from vo_tpu_torch import convert
from vo_tpu_torch.ba.pose_graph import _np_exp_so3
from vo_tpu_torch.eval import metrics as p_metrics
from vo_tpu_torch.geom.camera import calib_from_projections
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import undistort
from vo_tpu_torch.odometry import ba_runner, checkpoint, landmarks, pipeline, refiner, runner
from vo_tpu_torch.slam import loop_closure
from vo_tpu_torch.utils.device import default_device, resolve

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
CLASSES = ["SIFTConfig", "MatcherConfig", "RansacConfig", "LandmarkConfig", "BAConfig", "LoopConfig", "MeshConfig",
           "PipelineConfig"]


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def calib():
    return p_kitti.load_stereo_calib(str(DATA / "00"))


@pytest.mark.parametrize("name", CLASSES)
def test_config_defaults_equal_reference(name):
    p, r = getattr(p_config, name), getattr(r_config, name)
    assert p is not r and p.__module__ == "vo_tpu_torch.config"
    assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(r)]
    assert dataclasses.asdict(p()) == dataclasses.asdict(r())
    assert {f.name: type(getattr(p(), f.name)).__name__ for f in dataclasses.fields(p)} == {
        f.name: type(getattr(r(), f.name)).__name__ for f in dataclasses.fields(r)
    }


def test_config_module_exports_the_reference_classes():
    public = lambda m: sorted(k for k, v in vars(m).items() if dataclasses.is_dataclass(v))  # noqa: E731
    assert public(p_config) == public(r_config) == sorted(CLASSES)


def test_config_from_reference_copies_field_by_field():
    r = r_config.PipelineConfig(
        sift=r_config.SIFTConfig(max_keypoints=77, n_octaves=2, use_pallas=False),
        loop=r_config.LoopConfig(radius=3.5, appearance=False),
        mesh=r_config.MeshConfig(data=2, axis_names=("a", "b")),
        fused_group=3,
        matmul_precision="float32",
    )
    p = convert.config_from_reference(r)
    assert type(p) is p_config.PipelineConfig
    for f in dataclasses.fields(p):
        if dataclasses.is_dataclass(getattr(p, f.name)):
            assert type(getattr(p, f.name)) is getattr(p_config, type(getattr(r, f.name)).__name__)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert type(convert.config_from_reference(r.ba)) is p_config.BAConfig
    with pytest.raises(AttributeError):
        convert.config_from_reference(object())


def _trajectory(rng, T, noise):
    poses = [np.eye(4)]
    for _ in range(T - 1):
        rel = np.eye(4)
        rel[:3, :3] = _np_exp_so3(rng.normal(scale=0.02, size=3))
        rel[:3, 3] = rng.normal(scale=noise, size=3) + [0.0, 0.0, 1.0]
        poses.append(poses[-1] @ rel)
    return np.stack(poses)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    gt = _trajectory(rng, 60, 0.05)
    est = gt[1:].copy()  # estimates start at frame 2, the ground truth at frame 1
    est[:, :3, 3] += np.cumsum(rng.normal(scale=0.01, size=(59, 3)), axis=0)
    est[:, :3, :3] = est[:, :3, :3] @ _np_exp_so3(rng.normal(scale=0.01, size=3))
    assert p_metrics.ate(est, gt) == r_metrics.ate(est, gt)
    assert p_metrics.ate(est, gt, align=True) == r_metrics.ate(est, gt, align=True)
    assert p_metrics.ate(est, gt)["rmse"] > 0
    for delta in (1, 5):
        assert p_metrics.rpe(est, gt, delta=delta) == r_metrics.rpe(est, gt, delta=delta)
    for offset in (False, True):
        np.testing.assert_array_equal(
            p_metrics.xz_error(est, gt, reference_offset=offset), r_metrics.xz_error(est, gt, reference_offset=offset)
        )


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve(None)
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")


class _Feed:
    """A feed that must not be read: the device is resolved before the first frame."""

    def __init__(self, calib):
        self.calib = calib

    def __len__(self):
        return 0


def _entry_points(calib, device):
    cfg = p_config.PipelineConfig()
    kw = {} if device is None else dict(device=device)
    state = pipeline.init_state(cfg, device="cpu")
    host = convert.to_numpy(state)
    P = np.asarray(calib.P1), np.asarray(calib.P2)
    z = np.zeros((4, 2), np.float32)
    kf = loop_closure.ArchivedKeyframe(
        frame_idx=0, pose_c2w=np.eye(4, dtype=np.float32), l_px=z, r_px=z, l_desc=np.zeros((4, 128), np.float32),
        mask=np.zeros(4, bool),
    )
    prob = dict(
        T_c2w=np.zeros((2, 4, 4), np.float32), X=np.zeros((3, 3), np.float32), obs_uv=np.zeros((2, 3, 2), np.float32),
        obs_mask=np.zeros((2, 3), bool), obs_ur=np.zeros((2, 3), np.float32), obs_ur_mask=np.zeros((2, 3), bool),
        X_mask=np.zeros(3, bool), kf_mask=np.zeros(2, bool),
    )
    return {
        "run_sequence": lambda: runner.run_sequence(_Feed(calib), cfg, warmup=False, **kw).poses,
        "RefinerWorker": lambda: _closed(refiner.RefinerWorker(calib, cfg, use_ba=True, use_loop_closure=True, **kw)),
        "WindowedBA": lambda: ba_runner.WindowedBA(calib, cfg.ba, **kw).device,
        "LoopCloser": lambda: loop_closure.LoopCloser(calib, cfg.loop, **kw).device,
        "init_state": lambda: pipeline.init_state(cfg, 0, **kw).pose_c2w,
        "init_map": lambda: landmarks.init_map(p_config.LandmarkConfig(capacity=16), **kw).xyz,
        "calib_from_projections": lambda: calib_from_projections(*P, **kw).P1,
        "calib_from_numpy": lambda: convert.calib_from_numpy(calib, **kw).P1,
        "features_from_numpy": lambda: convert.features_from_numpy(_features(), **kw).xy,
        "stereo_features_from_numpy": lambda: convert.stereo_features_from_numpy(host.prev, **kw).l_xy,
        "state_from_numpy": lambda: convert.state_from_numpy(host, **kw).pose_c2w,
        "lmap_from_numpy": lambda: convert.lmap_from_numpy(
            convert.to_numpy(landmarks.init_map(p_config.LandmarkConfig(capacity=16), "cpu")), **kw
        ).xyz,
        "ba_problem_from_numpy": lambda: convert.ba_problem_from_numpy(prob, **kw).X,
        "archived_keyframe_from_numpy": lambda: convert.archived_keyframe_from_numpy(kf, **kw).dev[0],
        # (a file's sample stream continues only on the kind of device that wrote it: where the
        # load goes to the card, so did the state that is saved)
        "checkpoint.load": lambda: checkpoint.load(
            _checkpoint_file(pipeline.init_state(cfg, device="cuda") if device is None and torch.cuda.is_available() else state), **kw
        ).state.pose_c2w,
        "Undistorter": lambda: undistort.Undistorter(calib, undistort.DistortionModel(k1=-0.1), **kw).device,
    }


def _checkpoint_file(state) -> str:
    import tempfile

    path = tempfile.mkdtemp() + "/c.npz"
    return checkpoint.save(path, state, None, np.zeros((0, 4, 4)), np.zeros((0, 4, 4)), 1)


def _closed(worker):
    worker.close()
    return worker.device


def _features():
    from vo_tpu_torch.frontend.sift import Features

    return Features(
        xy=np.zeros((4, 2), np.float32), scale=np.ones(4, np.float32), orientation=np.zeros(4, np.float32),
        response=np.ones(4, np.float32), desc=np.zeros((4, 128), np.float32), mask=np.ones(4, bool),
    )


ENTRY_POINTS = ["run_sequence", "RefinerWorker", "WindowedBA", "LoopCloser", "init_state", "init_map",
                "calib_from_projections", "calib_from_numpy", "features_from_numpy", "stereo_features_from_numpy",
                "state_from_numpy", "lmap_from_numpy", "ba_problem_from_numpy", "archived_keyframe_from_numpy",
                "checkpoint.load", "Undistorter"]


def test_entry_point_list_is_complete(calib):
    assert sorted(_entry_points(calib, "cpu")) == sorted(ENTRY_POINTS)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_a_device(no_cuda, calib, name):
    """Given no device, on a machine without a card: an error that says how to ask for the CPU, not a CPU run."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points(calib, None)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_honours_cpu(no_cuda, calib, name):
    got = _entry_points(calib, "cpu")[name]()
    dev = got if isinstance(got, torch.device) else getattr(got, "device", None)
    if name == "run_sequence":
        assert got.shape == (0, 4, 4)  # ran to its end on the CPU, over no frame
    else:
        assert dev == torch.device("cpu"), (name, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n in ENTRY_POINTS if n not in ("run_sequence", "RefinerWorker")])
def test_entry_point_defaults_to_the_card(calib, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _entry_points(calib, None)[name]()
    dev = got if isinstance(got, torch.device) else got.device
    assert dev == torch.device("cuda", torch.cuda.current_device())


# --- the copies of the reference's host-side utilities, and the small tensor utilities ---


def test_profiling_copies_equal_the_originals(tmp_path):
    import json

    from vo_tpu.utils import profiling as r_prof
    from vo_tpu_torch.utils import profiling as p_prof

    rel = np.eye(4)
    rel[:3, 3] = [1.0, 0.0, 0.5]
    pose = np.eye(4)
    pose[:3, 3] = [3.25, -1.5, 40.0]
    for dt in (0.1, 0.0):
        assert p_prof.pretty_frame(7, rel, pose, dt) == r_prof.pretty_frame(7, rel, pose, dt)
    assert "frame 7" in p_prof.pretty_frame(7, rel, pose, 0.1) and "km/h" in p_prof.pretty_frame(7, rel, pose, 0.1)
    rows = []
    for mod, name in ((p_prof, "p.jsonl"), (r_prof, "r.jsonl")):
        m = mod.MetricsLog(str(tmp_path / name))
        m.log(0, n_tracks=np.int64(5), err=np.float32(1.5), arr=np.array([1.0, 2.0]))
        m.log(1, n_tracks=7, err=0.5)
        m.close()
        rows.append([json.loads(line) for line in open(tmp_path / name)])
    assert rows[0] == rows[1] and rows[0][0] == dict(frame=0, n_tracks=5, err=1.5, arr=[1.0, 2.0])


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    from vo_tpu_torch.utils import profiling as p_prof

    with p_prof.trace(str(tmp_path / "tr")):
        with p_prof.span("vo_tpu_torch.test_span", frame=0):  # the tracer is on inside trace()
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "vo_tpu_torch.test_span" for e in events)
    assert p_prof.span("vo_tpu_torch.test_span") is p_prof.NOOP  # and off after it


def test_figures_copy_equals_the_original(tmp_path):
    from vo_tpu.viz import figures as r_fig
    from vo_tpu_torch.viz import figures as p_fig

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (64, 128)).astype(np.float32)
    cur = rng.uniform(0, 120, (20, 2))
    old = cur + rng.normal(0, 2, (20, 2))
    disp = rng.uniform(0, 5, 20)
    poses = np.tile(np.eye(4), (10, 1, 1))
    poses[:, 0, 3] = np.arange(10)
    lms = rng.uniform(-5, 5, (100, 3))
    frame_out = dict(tracked_cur_px=cur, tracked_old_px=old, tracked_disp_3d=disp, tracked_mask=np.ones(20, bool))
    sizes = []
    for mod, d in ((p_fig, tmp_path / "p"), (r_fig, tmp_path / "r")):
        mod.frame_report(str(d), 5, img, frame_out, poses[1:], poses, landmarks=lms)
        sizes.append({n: (d / "5" / n).stat().st_size for n in ("view.png", "map.png", "error.png", "3d_map.png")})
    assert sizes[0] == sizes[1] and min(sizes[0].values()) > 1000  # the same drawing, byte for byte in size
    public = lambda m: sorted(k for k, v in vars(m).items() if callable(v) and getattr(v, "__module__", "") == m.__name__)  # noqa: E731
    assert public(p_fig) == public(r_fig)


@pytest.mark.parametrize("n", [3, 5, 8])
def test_pad_to_equals_reference(rng, n):
    import jax.numpy as jnp

    from vo_tpu.utils import padding as r_pad
    from vo_tpu_torch.utils import padding as p_pad

    for x in (rng.normal(size=(5, 3)).astype(np.float32), rng.integers(0, 9, 5)):
        got = p_pad.pad_to(torch.from_numpy(x), n, fill=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(r_pad.pad_to(jnp.asarray(x), n, fill=-1)))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape[0] == n


@pytest.mark.parametrize("n_valid", [0, 3, 40])
def test_masked_topk_equals_reference(rng, n_valid):
    import jax.numpy as jnp

    from vo_tpu.utils import padding as r_pad
    from vo_tpu_torch.utils import padding as p_pad

    scores = rng.permutation(40).astype(np.float32)  # no ties: the order is then defined
    mask = np.zeros(40, bool)
    mask[rng.permutation(40)[:n_valid]] = True
    vals, idx, valid = p_pad.masked_topk(torch.from_numpy(scores), torch.from_numpy(mask), 8)
    r_vals, r_idx, r_valid = r_pad.masked_topk(jnp.asarray(scores), jnp.asarray(mask), 8)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    assert int(valid.sum()) == min(n_valid, 8)
    k = int(valid.sum())
    np.testing.assert_array_equal(idx.numpy()[:k], np.asarray(r_idx)[:k])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


def test_debug_utils():
    """The port's mirror of tests/test_profiling.py::test_debug_utils."""
    import itertools

    from vo_tpu_torch.utils import cuda_lib, debug

    with debug.nan_debug():
        assert debug.nan_checks_enabled()
        with pytest.raises(FloatingPointError, match="stage 's'"):
            debug.check_finite("s", (torch.tensor([1.0, float("inf")]),))
        debug.check_finite("s", (torch.tensor([1.0, float("nan")]),), mask=torch.tensor([True, False]))
    debug.check_finite("s", torch.tensor([float("nan")]))  # outside the context: no check
    with debug.compile_logging() as log:
        cuda_lib.LAUNCHES["extrema_scores"] += 2  # as two launches inside the block would
    cuda_lib.LAUNCHES["extrema_scores"] -= 2
    assert log.hand_written == {"extrema_scores": 2, "bin_maps": 0, "pose_refine": 0, "gauss_blur": 0, "stage_stamp": 0}
    assert log.per_frame(2)["extrema_scores_per_frame"] == 1.0
    assert log.device_launches is None or log.device_launches >= 0  # traced only where there is a card
    x = torch.arange(4.0)
    assert debug.check_determinism(lambda a: {"y": a * 2, "z": (a + 1, [a])}, x)
    counter = itertools.count()
    assert not debug.check_determinism(lambda a: a + next(counter), x)
    assert debug.check_determinism(lambda a: a + next(counter), x, n=1)
