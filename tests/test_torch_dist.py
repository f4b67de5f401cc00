"""vo_tpu_torch.dist on torch.distributed with gloo on the CPU: sharded = single, every rank the same bits.

Ranks are real processes, started by ``dist.mesh.launch`` (file rendezvous, so
no port is taken), each with one thread and a 60 s limit: a rank that hangs
or dies fails its test by name. Worlds of 2 and 4. The inputs come from a
numpy seed inside each rank (the same on every rank), KITTI-00 geometry from
tests/data/kitti. What is held:

- RANSAC: with the replicated draw the sharded estimate EQUALS the
  single-device one (pose, inliers, count), and lies within the reference
  test's bounds of the ground truth (0.1 m, 0.01 in R) on its 30 %-outlier
  problem; one all-gather per call.
- Window BA (tests/test_ba.py's K = 4, M = 256 problem): poses within 2e-4 and
  cost within 1e-3 relative of the port's single solve, and within 1e-4 of
  the reference's ``solve_window``; 1 + 3 * iters all-reduces and one
  all-gather per solve.
- Pose graph (tests/test_dist.py's 9-pose problem): within 2e-4 of the single
  solve; 1 + 2 * iters all-reduces.
- ``detect_batch`` of 4 frames at 128x256: ``xy`` within 1e-5 of the unsharded call.
- Capacities that do not divide, and a "data" axis of 3, raise.

The rank functions import no jax (a rank is a fresh process that imports this
module); the reference is imported inside the tests that compare with it.
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import convert
from vo_tpu_torch.ba import pose_graph as p_pg
from vo_tpu_torch.ba import window as p_win
from vo_tpu_torch.config import BAConfig, MeshConfig, PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu_torch.dist import ba_sharded, frontend_batch, pose_graph_sharded, ransac_sharded
from vo_tpu_torch.dist import mesh as p_mesh
from vo_tpu_torch.frontend import sift as p_sift
from vo_tpu_torch.geom.triangulate import triangulate_rectified
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.pose import ransac as p_ransac

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
LIMIT = 60.0  # seconds a launched world may take
BA_ITERS = 6
PG_ITERS = 8


def _geometry():
    return p_kitti.load_stereo_calib(str(DATA / "00")), p_kitti.read_poses(str(DATA / "poses" / "00.txt"))


def _ransac_problem(calib, gt):
    """tests/test_dist.py's problem: 3000 landmarks, 0.3 px noise, 30 % outliers."""
    rng = np.random.default_rng(42)
    lm = p_syn.scatter_landmarks(rng, gt[:10], 3000)
    tr = p_syn.make_tracks(rng, calib, gt[2], gt[3], lm, noise_px=0.3, outlier_frac=0.3)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    px = f32(tr.px_cur_l)
    X = triangulate_rectified(f32(tr.px_prev_l), f32(tr.px_prev_r), calib)
    return px, X, torch.ones(px.shape[0], dtype=torch.bool), tr.rel_pose


def _ba_problem(calib, gt, K=4, M=256, noise_px=0.3):
    """tests/test_ba.py's window: K GT keyframes observing M landmarks, noisy initial guesses."""
    rng = np.random.default_rng(42)
    lms = p_syn.scatter_landmarks(rng, gt[:K], M)
    obs = np.zeros((K, M, 2), np.float32)
    obs_ur = np.zeros((K, M), np.float32)
    msk = np.zeros((K, M), bool)
    H, W = calib.image_size
    P1, P2 = calib.P1.numpy().astype(np.float64), calib.P2.numpy().astype(np.float64)
    for k in range(K):
        cam = p_syn._w2c_apply(gt[k], lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px = p_syn.project_np(P1, safe)
        pxr = p_syn.project_np(P2, safe)
        msk[k] = (cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        obs[k] = px + rng.normal(scale=noise_px, size=px.shape)
        obs_ur[k] = pxr[:, 0] + rng.normal(scale=noise_px, size=M)

    def perturb(T):
        xi = np.concatenate([rng.normal(scale=0.05, size=3), rng.normal(scale=0.01, size=3)])
        return (p_pg._np_exp_se3(xi) @ T).astype(np.float32)

    T0 = np.stack([gt[0]] + [perturb(gt[k]) for k in range(1, K)]).astype(np.float32)
    X0 = (lms + rng.normal(scale=0.3, size=lms.shape)).astype(np.float32)
    return dict(
        T_c2w=T0, X=X0, obs_uv=obs, obs_mask=msk, obs_ur=obs_ur, obs_ur_mask=msk.copy(),
        X_mask=np.ones(M, bool), kf_mask=np.ones(K, bool),
    )


def _pose_graph_problem(gt, K=9):
    """tests/test_dist.py's graph: K GT poses chained by odometry edges, two of them displaced."""
    T = torch.from_numpy(gt[:K].astype(np.float32))
    ei, ej, Z, em, ew = p_pg.odometry_edges(T)
    pert = T.clone()
    pert[3, :3, 3] += torch.tensor([0.2, -0.1, 0.15])
    pert[6, :3, 3] += torch.tensor([-0.15, 0.05, 0.2])
    return p_pg.PoseGraph(T_c2w=pert, edge_i=ei, edge_j=ej, edge_T=Z, edge_mask=em, edge_weight=ew)


def _np(nt) -> dict:
    return {k: v.numpy() for k, v in nt._asdict().items()}


def _counted(fn):
    p_mesh.reset_collectives()
    out = fn()
    return out, dict(p_mesh.COLLECTIVES)


def _model_rank(mesh, device):
    """One rank of a (1, n) mesh: each model-sharded solver beside its single version."""
    calib, gt = _geometry()
    out = {}

    px, X, mask, _ = _ransac_problem(calib, gt)
    cfg = RansacConfig(n_hypotheses=512)
    gen_s, gen_1 = torch.Generator(), torch.Generator()
    gen_s.manual_seed(7)
    gen_1.manual_seed(7)
    est, out["ransac_collectives"] = _counted(
        lambda: ransac_sharded.estimate_world_pose_sharded(px, X, mask, calib, cfg, gen_s, mesh)
    )
    out["ransac"] = _np(est)
    out["ransac_single"] = _np(p_ransac.estimate_world_pose(px, X, mask, calib, cfg, gen=gen_1))
    out["gen_replicated"] = bool(torch.equal(gen_s.get_state(), gen_1.get_state()))

    prob = convert.ba_problem_from_numpy(_ba_problem(calib, gt), "cpu")
    bcfg = BAConfig(iters=BA_ITERS)
    res, out["ba_collectives"] = _counted(lambda: ba_sharded.solve_window_sharded(prob, calib, bcfg, mesh))
    out["ba"] = _np(res)
    out["ba_single"] = _np(p_win.solve_window(prob, calib, bcfg))
    with pytest.raises(ValueError, match="not divisible"):
        ba_sharded.solve_window_sharded(prob._replace(X=prob.X[:255]), calib, bcfg, mesh)

    g = _pose_graph_problem(gt)
    res, out["pg_collectives"] = _counted(lambda: pose_graph_sharded.optimize_sharded(g, mesh, iters=PG_ITERS))
    out["pg"] = _np(res)
    out["pg_single"] = _np(p_pg.optimize(g, iters=PG_ITERS))
    with pytest.raises(ValueError, match="not divisible"):
        pose_graph_sharded.optimize_sharded(g._replace(edge_i=g.edge_i[:7]), mesh, iters=1)
    return out


def _data_rank(mesh, device):
    """One rank of an (n, 1) mesh: detect_batch of 4 frames beside the unsharded call."""
    seq = p_syn.kitti_synthetic_sequence(n_frames=4, n_landmarks=600, seed=2, image_size=(128, 256))
    frames = torch.from_numpy(np.stack([seq.frame(i)[0] for i in range(4)]).astype(np.float32))
    cfg = SIFTConfig(max_keypoints=128, n_octaves=2)
    feats, n_coll = _counted(lambda: frontend_batch.detect_batch(frames, cfg, mesh))
    with pytest.raises(ValueError, match="not divisible"):
        frontend_batch.detect_batch(frames[:3], cfg, mesh)
    stereo = frontend_batch.stereo_batch(frames, frames.flip(0), cfg, PipelineConfig().matcher, 64, mesh)
    return dict(
        feats=_np(feats), single=_np(p_sift.detect_and_describe(frames, cfg)), collectives=n_coll,
        stereo_shapes={k: tuple(v.shape) for k, v in stereo._asdict().items()},
    )


def _assert_ranks_bit_equal(per_rank, keys):
    """The collectives' contract: every rank ends with the same bits."""
    for r, res in enumerate(per_rank[1:], 1):
        for k in keys:
            for name, a in res[k].items():
                np.testing.assert_array_equal(a, per_rank[0][k][name], err_msg=f"rank {r} {k}.{name}")


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def model_world(request):
    n = request.param
    per_rank = p_mesh.launch(_model_rank, (1, n), "cpu", timeout=LIMIT)
    assert len(per_rank) == n
    _assert_ranks_bit_equal(per_rank, ("ransac", "ba", "pg"))
    return n, per_rank[0]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def data_world(request):
    n = request.param
    per_rank = p_mesh.launch(_data_rank, (n, 1), "cpu", timeout=LIMIT)
    _assert_ranks_bit_equal(per_rank, ("feats",))
    return n, per_rank[0]


def test_sharded_ransac_equals_single(model_world):
    n, out = model_world
    for k in ("pose_c2w", "inliers", "n_inliers", "ok", "mean_err"):
        np.testing.assert_array_equal(out["ransac"][k], out["ransac_single"][k], err_msg=k)
    assert out["gen_replicated"]  # the sharded call consumed the generator exactly as the single one
    assert out["ransac_collectives"] == {"all_gather": 1, "all_reduce": 0}


def test_sharded_ransac_finds_the_pose(model_world):
    _, out = model_world
    rel = _ransac_problem(*_geometry())[3]
    got = out["ransac"]["pose_c2w"]
    assert bool(out["ransac"]["ok"])
    assert np.linalg.norm(got[:3, 3] - rel[:3, 3]) < 0.1
    assert np.linalg.norm(got[:3, :3] - rel[:3, :3]) < 0.01


def test_sharded_ba_matches_single(model_world):
    n, out = model_world
    np.testing.assert_allclose(out["ba"]["T_c2w"], out["ba_single"]["T_c2w"], atol=2e-4)
    np.testing.assert_allclose(float(out["ba"]["cost"]), float(out["ba_single"]["cost"]), rtol=1e-3)
    np.testing.assert_allclose(float(out["ba"]["cost0"]), float(out["ba_single"]["cost0"]), rtol=1e-5)
    assert out["ba"]["X"].shape == out["ba_single"]["X"].shape == (256, 3)
    np.testing.assert_allclose(out["ba"]["X"], out["ba_single"]["X"], atol=2e-3)
    assert int(out["ba"]["n_obs"]) == int(out["ba_single"]["n_obs"]) and out["ba"]["n_obs"].dtype == np.int64
    assert out["ba_collectives"] == {"all_gather": 1, "all_reduce": 1 + 3 * BA_ITERS}


def test_sharded_ba_matches_reference(model_world):
    import jax
    import jax.numpy as jnp

    from vo_tpu.ba import window as r_win
    from vo_tpu.io import kitti as r_kitti

    _, out = model_world
    calib, gt = _geometry()
    p = _ba_problem(calib, gt)
    r_calib = r_kitti.load_stereo_calib(str(DATA / "00"))
    cfg = BAConfig(iters=BA_ITERS)
    r = jax.jit(lambda q: r_win.solve_window(q, r_calib, cfg))(r_win.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}))
    np.testing.assert_allclose(out["ba"]["T_c2w"], np.asarray(r.T_c2w), atol=1e-4)
    np.testing.assert_allclose(float(out["ba"]["cost"]), float(r.cost), rtol=1e-3)


def test_sharded_pose_graph_matches_single(model_world):
    _, out = model_world
    np.testing.assert_allclose(out["pg"]["T_c2w"], out["pg_single"]["T_c2w"], atol=2e-4)
    assert float(out["pg"]["cost"]) < float(out["pg"]["cost0"])
    assert out["pg_collectives"] == {"all_gather": 0, "all_reduce": 1 + 2 * PG_ITERS}


def test_frame_parallel_detect(data_world):
    n, out = data_world
    assert out["feats"]["xy"].shape == (4, 128, 2)
    assert (out["feats"]["mask"].sum(axis=1) > 5).all()
    np.testing.assert_array_equal(out["feats"]["mask"], out["single"]["mask"])
    np.testing.assert_allclose(out["feats"]["xy"], out["single"]["xy"], atol=1e-5)
    np.testing.assert_allclose(out["feats"]["desc"], out["single"]["desc"], atol=1e-5)
    assert out["collectives"] == {"all_gather": 1, "all_reduce": 0}  # none inside detection
    assert out["stereo_shapes"]["l_xy"] == (4, 64, 2) and out["stereo_shapes"]["mask"] == (4, 64)


def _shape_rank(mesh, device, cfg):
    fitted = p_mesh.make_mesh(cfg, device=device)
    return p_mesh.mesh_shape(mesh), p_mesh.mesh_shape(fitted), p_mesh.mesh_shape(p_mesh.make_mesh(None, device=device))


def test_mesh_shapes():
    """make_mesh fits as the reference does: default all ranks on "model", a remainder to "model"."""
    asked, fitted, default = p_mesh.launch(_shape_rank, (2, 1), "cpu", args=(MeshConfig(data=1, model=8),), timeout=LIMIT)[1]
    assert asked == {"data": 2, "model": 1}
    assert fitted == {"data": 1, "model": 2}
    assert default == {"data": 1, "model": 2}


class _Mesh3:
    """Stands in for a mesh whose "data" axis has 3 ranks (the check reads only names and sizes)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (3, 1)[dim]


def test_data_axis_must_be_the_stereo_pair():
    calib, _ = _geometry()
    with pytest.raises(ValueError, match="axis size 3 != 2"):
        p_pipe._mesh_step_overrides(calib, PipelineConfig(), _Mesh3())
    assert p_pipe._mesh_step_overrides(calib, PipelineConfig(), None) == (None, False)


def _dies_rank(mesh, device):
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    p_mesh.all_reduce_sum_(torch.ones(1), mesh.get_group("model"))  # never completes: its peer is gone


def _hangs_rank(mesh, device):
    if torch.distributed.get_rank() == 1:
        time.sleep(3600)


def test_a_dead_rank_fails_the_launch_with_its_stderr():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 1") as e:
        p_mesh.launch(_dies_rank, (1, 2), "cpu", timeout=LIMIT)
    assert "rank one gives up" in str(e.value)
    assert time.monotonic() - t0 < LIMIT / 2  # the survivor was ended, not waited for


def test_a_hung_rank_is_killed_and_named():
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2 still running after 8 s"):
        p_mesh.launch(_hangs_rank, (1, 2), "cpu", timeout=8.0)


def test_init_distributed_single_process_is_a_noop():
    p_mesh.init_distributed("127.0.0.1:1", 1, 0, device="cpu")
    p_mesh.init_distributed(None, None, None, device="cpu")
    assert not torch.distributed.is_initialized()


def _packed_rank(mesh, device):
    g = mesh.get_group("model")
    r = torch.distributed.get_rank()
    parts = [torch.full((2, 3), float(r + 1)), torch.tensor(r + 2, dtype=torch.int64), torch.tensor(r == 0)]
    red = p_mesh.all_reduce_sum_packed(parts[:2], g)
    gat = p_mesh.all_gather_packed(parts, g)
    return [t.numpy() for t in red], [t.numpy() for t in gat], [str(t.dtype) for t in red + gat]


def test_packed_collectives_keep_shapes_and_dtypes():
    (red, gat, dtypes), other = p_mesh.launch(_packed_rank, (1, 2), "cpu", timeout=LIMIT)
    np.testing.assert_array_equal(red[0], np.full((2, 3), 3.0, np.float32))
    assert red[1] == 5 and red[1].shape == ()
    np.testing.assert_array_equal(gat[0], np.stack([np.full((2, 3), 1.0), np.full((2, 3), 2.0)]).astype(np.float32))
    np.testing.assert_array_equal(gat[1], [2, 3])
    np.testing.assert_array_equal(gat[2], [True, False])
    assert dtypes == ["torch.float32", "torch.int64", "torch.float32", "torch.int64", "torch.bool"]
    np.testing.assert_array_equal(other[1][2], gat[2])


def test_multihost_smoke_processes_agree(tmp_path):
    """``python -m vo_tpu_torch.dist.multihost_smoke`` as two real processes (the
    tests/test_multihost.py contract): each prints one JSON line, and the lines agree bit for bit."""
    import json
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "vo_tpu_torch.dist.multihost_smoke", "--cpu", "--processes", "2",
           "--coordinator", f"file://{tmp_path}/rdv", "--hypotheses", "128"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=LIMIT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    lines = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        lines.append(json.loads(out.strip().splitlines()[-1]))
    assert [ln["process"] for ln in lines] == [0, 1]
    assert lines[0]["t"] == lines[1]["t"] and lines[0]["n_inliers"] == lines[1]["n_inliers"] > 100
    assert lines[0]["ok"] and lines[0]["n_global_devices"] == 2


def test_scaling_harness_runs():
    from vo_tpu_torch.dist import scaling

    rows = scaling.run(device_counts=(2,), frame_batch=4, image_size=(64, 128), n_hyp=256, device="cpu", timeout=LIMIT)
    assert [r["ranks"] for r in rows] == [2]
    assert rows[0]["frontend_ms_per_frame"] > 0 and rows[0]["ransac_ms"] > 0
    assert set(rows[0]) == {"ranks", "frontend_ms_per_frame", "ransac_ms"}  # times only: no efficiency, no speed-up


@pytest.mark.slow
def test_scaling_run_integrated_is_equivalent():
    from vo_tpu_torch.dist import scaling

    out = scaling.run_integrated(mesh_shape=(2, 2), n_frames=8, image_size=(188, 620), device="cpu", timeout=600.0)
    assert out["equivalent"] and out["ranks_bit_equal"] and out["max_pose_deviation_m"] < 2e-2


@pytest.mark.gpu
def test_nccl_collectives_enqueue_without_a_host_wait(tmp_path):
    """A world of one on the card (NCCL refuses two ranks on one device): the sharded RANSAC, the
    window solve and the helpers issue real NCCL collectives on the current stream, the results
    equal the single-device functions bit for bit, and the host never waits inside them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.distributed.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = p_mesh.make_mesh(MeshConfig(data=1, model=1), device=dev)
        assert torch.distributed.get_backend(mesh.get_group("model")) == "nccl"
        calib, gt = _geometry()
        px, X, mask, _ = _ransac_problem(calib, gt)
        px, X, mask, calib_d = px.to(dev), X.to(dev), mask.to(dev), calib.to(dev)
        cfg = RansacConfig(n_hypotheses=512)
        prob = convert.ba_problem_from_numpy(_ba_problem(calib, gt), dev)
        bcfg = BAConfig(iters=BA_ITERS)
        gens = [torch.Generator(device=dev) for _ in range(2)]

        def sharded():
            gens[0].manual_seed(7)
            est = ransac_sharded.estimate_world_pose_sharded(px, X, mask, calib_d, cfg, gens[0], mesh)
            return est, ba_sharded.solve_window_sharded(prob, calib_d, bcfg, mesh)

        sharded()  # NCCL builds its communicator on first use
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            est, res = sharded()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        gens[1].manual_seed(7)
        for got, want in ((est, p_ransac.estimate_world_pose(px, X, mask, calib_d, cfg, gen=gens[1])),
                          (res, p_win.solve_window(prob, calib_d, bcfg))):
            for name, a, b in zip(got._fields, got, want):
                assert torch.equal(a, b), name
    finally:
        torch.distributed.destroy_process_group()
