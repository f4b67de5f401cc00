"""K3 ``pose_refine`` (csrc/pose_refine.cu): RANSAC-P3P's consensus refinement against its plain version.

``pose.ransac._finalize_f32`` takes the plain version ``_finalize_plain`` for CPU
tensors and launches K3 for CUDA tensors. Here on the CPU: the wrapper's output is
the plain version's bit for bit and counts no launch, and the wrapper refuses what
the kernel does not take. The kernel-vs-plain cases and the step's graphed-vs-eager
run need a CUDA card (marker ``gpu``) and skip without one. This module imports
neither jax nor conftest's fixtures, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_pose_refine.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch.config import PipelineConfig, RansacConfig
from vo_tpu_torch.geom import se3
from vo_tpu_torch.io import kitti, synthetic
from vo_tpu_torch.odometry import runner
from vo_tpu_torch.pose import ransac
from vo_tpu_torch.utils import cuda_lib, graphs
from vo_tpu_torch.utils.precision import matmul_precision

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
CFG = RansacConfig()
# A tenth of the benchmark's limits (perfbench/check.py: 3e-4 m, 1.5e-5 rad). Kernel and plain version
# reach the same IRLS optimum and differ by the order of their float32 sums alone, which moves a pose
# of metres by about 1e-7 of itself.
T_TOL_M, R_TOL_RAD = 3e-5, 1.5e-6
# A point may fall on either side of the gate where its squared error lies this close to the
# threshold: the two sides project it through differently rounded products (~1e-5 px apart at the
# RANSAC winner, ~1e-4 px at the refined pose).
EDGE_PX2 = 1e-3
MEAN_ERR_TOL = 1e-5  # px: a mean of square roots of the same inliers' errors


def _calib():
    return kitti.load_stereo_calib(str(DATA / "00"))


def _rotation(rng, angle):
    axis = rng.standard_normal(3)
    return se3.exp_so3(torch.from_numpy(angle * axis / np.linalg.norm(axis))).numpy().astype(np.float64)


def _case(name: str):
    """(R_best, t_best, any_valid, px2d, pts3d, mask) as numpy arrays for one named case: points 5-60 m
    ahead of the previous camera, seen in the current one through a ground-truth motion with 0.05 px
    of noise; outliers moved 5-40 px off; the RANSAC winner is the truth turned and moved by ``kick``
    (rad, m)."""
    n, outliers, kick, n_valid, n_true, any_valid = 1024, 0.2, (1e-3, 5e-3), None, None, True
    if name == "n512":
        n = 512
    elif name == "n1000":
        n = 1000
    elif name == "n3000":
        n = 3000
    elif name == "tie":
        kick = (1e-4, 1e-3)  # every true point inside the gate before and after: |inliers_r| == |inliers0|
    elif name == "few_valid":
        n_valid, outliers, kick = CFG.min_points - 1, 0.0, (1e-4, 1e-3)
    elif name == "no_hypothesis":
        any_valid = False
    elif name == "few_inliers":
        n_true, kick = 2, (1e-4, 1e-3)
    rng = np.random.default_rng(sum(map(ord, name)))
    c = _calib()
    z = rng.uniform(5.0, 60.0, n)
    u = rng.uniform(0.0, c.image_size[1], n)
    v = rng.uniform(0.0, c.image_size[0], n)
    pts = np.stack([(u - c.cu) / c.fu * z, (v - c.cv) / c.fv * z, z], axis=-1)
    R_gt, t_gt = _rotation(rng, 0.02), rng.uniform(-0.05, 0.05, 3) + np.array([0.0, 0.0, -0.8])
    Xc = pts @ R_gt.T + t_gt
    px = np.stack([c.fu * Xc[:, 0] / Xc[:, 2] + c.cu, c.fv * Xc[:, 1] / Xc[:, 2] + c.cv], axis=-1)
    px += rng.normal(scale=0.05, size=px.shape)
    out = rng.random(n) < outliers if n_true is None else np.arange(n) >= n_true
    ang = rng.uniform(0.0, 2 * np.pi, n)
    px[out] += rng.uniform(5.0, 40.0, (out.sum(), 1)) * np.stack([np.cos(ang[out]), np.sin(ang[out])], axis=-1)
    mask = np.ones(n, bool)
    if n_valid is not None:
        mask[n_valid:] = False
    R_best = _rotation(rng, kick[0]) @ R_gt
    step = rng.standard_normal(3)
    t_best = t_gt + kick[1] * step / np.linalg.norm(step)
    return (R_best.astype(np.float32), t_best.astype(np.float32), np.asarray(any_valid), px.astype(np.float32),
            pts.astype(np.float32), mask)


CASES = ["n1024", "n512", "n1000", "n3000", "tie", "few_valid", "no_hypothesis", "few_inliers"]


def _tensors(case, device):
    return [torch.tensor(a).to(device) for a in case]


def _gate(R, t, px2d, pts3d, mask, calib):
    """(inliers, squared error) of every point at the world->camera pose [R|t], as the plain version gates."""
    pred, z = ransac._project_w2c(R, t, pts3d, calib)
    err2 = torch.sum((pred - px2d) ** 2, dim=-1)
    return mask & (z > 0) & (err2 < CFG.max_reproj_err_px**2), err2


def _gaps(a: torch.Tensor, b: torch.Tensor):
    """(translation m, rotation rad) of the relative pose between two [4, 4] poses, in float64."""
    d = np.linalg.inv(a.double().cpu().numpy()) @ b.double().cpu().numpy()
    w = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.linalg.norm(d[:3, 3])), float(np.arcsin(min(1.0, np.linalg.norm(w))))


def _apart(a: torch.Tensor, b: torch.Tensor) -> bool:
    dt, dr = _gaps(a, b)
    return dt > T_TOL_M or dr > R_TOL_RAD


def _finalize_both(case, device):
    """(kernel's PoseEstimate, plain version's PoseEstimate, the inputs) on ``device``."""
    R, t, any_valid, px2d, pts3d, mask = _tensors(case, device)
    calib = _calib().to(device)
    kern = ransac.finalize_pose(R, t, any_valid, px2d, pts3d, mask, calib, CFG)
    plain = matmul_precision("float32")(ransac._finalize_plain)(R, t, any_valid, px2d, pts3d, mask, calib, CFG)
    return kern, plain, (R, t, any_valid, px2d, pts3d, mask, calib)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper returns the plain version's output bit for bit and launches nothing."""
    before = dict(cuda_lib.LAUNCHES)
    for name in ("n1024", "few_inliers"):
        args = _tensors(_case(name), "cpu")
        calib = _calib()
        got = ransac._finalize_f32(*args, calib, CFG)
        want = ransac._finalize_plain(*args, calib, CFG)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert cuda_lib.LAUNCHES == before


@pytest.mark.parametrize("name", CASES)
def test_plain_cases_are_what_their_names_say(name):
    """The cases the kernel is held to, on the plain version: who is ok, and whether the refinement
    kept its consensus (``better``) and on which margin."""
    R, t, any_valid, px2d, pts3d, mask = _tensors(_case(name), "cpu")
    calib = _calib()
    est = ransac._finalize_plain(R, t, any_valid, px2d, pts3d, mask, calib, CFG)
    in0, _ = _gate(R, t, px2d, pts3d, mask, calib)
    R_ref, t_ref = ransac.refine_pose(R, t, px2d, pts3d, in0.float(), calib, CFG.refine_iters)
    in_r, _ = _gate(R_ref, t_ref, px2d, pts3d, mask, calib)
    n0, nr = int(in0.sum()), int(in_r.sum())
    expect_ok = name not in ("few_valid", "no_hypothesis", "few_inliers")
    assert bool(est.ok) == expect_ok
    assert int(est.n_inliers) == (nr if nr >= n0 else n0)
    if name == "tie":
        assert nr == n0 > 500
    elif name == "few_inliers":
        assert n0 == 2
    elif name == "few_valid":
        assert int(mask.sum()) == CFG.min_points - 1 == nr == n0
    else:
        assert nr > n0 + 10  # the kick leaves true points outside the gate, the refinement brings them in


@pytest.mark.parametrize("bad", ["R_dtype", "t_shape", "px_strided", "mask_dtype", "valid_shape", "devices", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Off the CPU the wrapper checks types, shapes, contiguity and device before any launch (checked
    here on the meta device, which the kernel never takes either)."""
    R, t, any_valid, px2d, pts3d, mask = _tensors(_case("n512"), "meta")
    match = "pose_refine: expected contiguous"
    if bad == "R_dtype":
        R = R.double()
    elif bad == "t_shape":
        t = t[None]
    elif bad == "px_strided":
        px2d = torch.empty((px2d.shape[0], 4), device="meta")[:, :2]
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "valid_shape":
        any_valid = any_valid[None]
    elif bad == "devices":
        mask = torch.ones(mask.shape, dtype=torch.bool, device="cpu")
    else:
        match = "pose_refine: expected CPU or CUDA tensors"
    before = dict(cuda_lib.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ransac._finalize_f32(R, t, any_valid, px2d, pts3d, mask, _calib(), CFG)
    assert cuda_lib.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(cuda, name):
    """K3 against the plain version on the same CUDA tensors: ``ok`` equal; the inliers equal but for
    points within EDGE_PX2 of the gate; where both sides chose the same pose (``better`` agrees) and
    the refinement was posed (>= 3 points in the initial gate), the pose within (T_TOL_M, R_TOL_RAD)
    and mean_err within MEAN_ERR_TOL. With fewer than 3 points the 6x6 system is singular but for
    its 1e-6 ridge, so its solution is rounding, and ``ok`` is false: the step does not use the pose."""
    kern, plain, (R, t, _, px2d, pts3d, mask, calib) = _finalize_both(_case(name), cuda)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    assert bool(kern.ok) == bool(plain.ok)
    in0, err2_0 = _gate(R, t, px2d, pts3d, mask, calib)
    R_p, t_p = se3.inv(plain.pose_c2w)[:3, :3], se3.inv(plain.pose_c2w)[:3, 3]
    _, err2_p = _gate(R_p, t_p, px2d, pts3d, mask, calib)
    thr2 = CFG.max_reproj_err_px**2
    edge = ((err2_0 - thr2).abs() < EDGE_PX2) | ((err2_p - thr2).abs() < EDGE_PX2)
    differ = kern.inliers != plain.inliers
    assert not bool((differ & ~edge).any()), f"{int(differ.sum())} inliers differ, {int(edge.sum())} on the edge"
    assert abs(int(kern.n_inliers) - int(plain.n_inliers)) <= int(edge.sum())
    unrefined = se3.inv(se3.from_rt(R, t))
    if _apart(unrefined, kern.pose_c2w) == _apart(unrefined, plain.pose_c2w) and int(in0.sum()) >= 3:
        dt, dr = _gaps(plain.pose_c2w, kern.pose_c2w)
        assert dt <= T_TOL_M and dr <= R_TOL_RAD, (dt, dr)
        assert abs(float(kern.mean_err) - float(plain.mean_err)) <= MEAN_ERR_TOL
    else:
        assert int(edge.sum()) > 0 or int(in0.sum()) < 3, "better differs with no point on the gate's edge"


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit_and_counts_its_launches(cuda):
    """Two launches on the same input: every output equal bit for bit; one launch counted each."""
    args = _tensors(_case("n1024"), cuda)
    calib = _calib().to(cuda)
    n = cuda_lib.LAUNCHES["pose_refine"]
    a = ransac.finalize_pose(*args, calib, CFG)
    b = ransac.finalize_pose(*args, calib, CFG)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["pose_refine"] == n + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


class _OutAndBack:
    """KITTI-00 GT poses 0..n_out-1 then back to 0 (2 n_out - 1 frames) at half size, staged on the card;
    the way back shows the outbound frames again (rendered once)."""

    def __init__(self, device, n_out=100, size=(188, 620)):
        gt = kitti.read_poses(str(DATA / "poses" / "00.txt"))[:n_out]
        seq = synthetic.SyntheticSequence(_calib(), gt, n_landmarks=3000, seed=0, image_size=size)
        self.calib, self.gt_poses = seq.calib, np.concatenate([gt, gt[-2::-1]])
        out = [tuple(runner.to_device(im, device) for im in seq.frame(i)) for i in range(n_out)]
        self.frames = out + out[-2::-1]

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


@pytest.mark.gpu
def test_graphed_run_equals_eager_and_launches_once_a_frame(cuda):
    """A 199-frame graphed run is bit-equal to the eager run on the card, and K3 ran once for every
    frame a step processed: the captures' eager warm-ups and every replay, two frames a group step."""
    feed = _OutAndBack(cuda)
    cfg = PipelineConfig()
    eager = runner.run_sequence(feed, cfg, device=cuda, graph=False)
    cuda_lib.LAUNCHES.reset()
    graphs.reset_programs()
    graphed = runner.run_sequence(feed, cfg, device=cuda)
    for name in ("poses", "rel_poses", "pose_ok", "n_inliers", "n_tracks", "landmarks"):
        assert np.array_equal(np.asarray(getattr(graphed, name)), np.asarray(getattr(eager, name))), name
    assert int(np.asarray(graphed.pose_ok).sum()) >= len(feed) - 3
    steps = {name: graphs.WARMUP_RUNS * p["captures"] + p["replays"] for name, p in graphs.PROGRAMS.items()}
    frames = cfg.fused_group * steps["group_step"] + steps.get("frame_step", 0)
    assert frames >= len(feed)
    assert cuda_lib.LAUNCHES["pose_refine"] == frames
    assert cuda_lib.LAUNCHES["extrema_scores"] == steps["group_step"] + steps.get("frame_step", 0)
