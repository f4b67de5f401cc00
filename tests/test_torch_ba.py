"""vo_tpu_torch.ba and odometry.ba_runner against vo_tpu on identical inputs.

Window BA: the port's ``solve_window`` and the reference's on the same noisy
window (the tests/test_ba.py pattern: K ground-truth keyframes observing M
landmarks, perturbed initial poses and landmarks), full and masked: poses
within 1e-4 m / 1e-4 rad, cost within 1e-3 relative. The host parts (the
pose graph's float64 solve, window assembly, the associator, the collect
gate) are the same numpy code, so they must give equal results. KITTI-00
geometry comes from tests/data/kitti. One ``BAConfig`` (the port's class) serves both
sides: the reference reads its fields by name. The port runs on the CPU because every
call names it (``device="cpu"``).

The reference is imported by the ``ref`` fixture only, so the ``gpu`` case
also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_ba.py
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vo_tpu_torch import convert
from vo_tpu_torch.ba import pose_graph as p_pg
from vo_tpu_torch.ba import window as p_win
from vo_tpu_torch.config import BAConfig
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import ba_runner as p_bar
from vo_tpu_torch.utils.host_copy import HostCopy

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The jax reference's modules and its calibration of KITTI 00."""
    import jax
    import jax.numpy as jnp

    from vo_tpu.ba import pose_graph, window
    from vo_tpu.io import kitti
    from vo_tpu.odometry import ba_runner

    return SimpleNamespace(
        jax=jax, jnp=jnp, pg=pose_graph, win=window, bar=ba_runner, calib=kitti.load_stereo_calib(str(DATA / "00"))
    )


@pytest.fixture(scope="module")
def calib():
    return p_kitti.load_stereo_calib(str(DATA / "00"))


@pytest.fixture(scope="module")
def gt():
    return p_kitti.read_poses(str(DATA / "poses" / "00.txt"))


def _perturb(rng, T, rot=0.01, trans=0.05):
    xi = np.concatenate([rng.normal(scale=trans, size=3), rng.normal(scale=rot, size=3)])
    return (p_pg._np_exp_se3(xi) @ T).astype(np.float32)


def _ba_problem(rng, calib, gt_poses, K=5, M=256, noise_px=0.3):
    """numpy BAProblem fields: K GT keyframes observing M landmarks, noisy initial guesses."""
    lms = p_syn.scatter_landmarks(rng, gt_poses[:K], M)
    obs = np.zeros((K, M, 2), np.float32)
    obs_ur = np.zeros((K, M), np.float32)
    msk = np.zeros((K, M), bool)
    H, W = calib.image_size
    P1, P2 = calib.P1.numpy().astype(np.float64), calib.P2.numpy().astype(np.float64)
    for k in range(K):
        cam = p_syn._w2c_apply(gt_poses[k], lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px = p_syn.project_np(P1, safe)
        pxr = p_syn.project_np(P2, safe)
        msk[k] = (cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        obs[k] = px + rng.normal(scale=noise_px, size=px.shape)
        obs_ur[k] = pxr[:, 0] + rng.normal(scale=noise_px, size=M)
    T0 = np.stack([gt_poses[0]] + [_perturb(rng, gt_poses[k]) for k in range(1, K)]).astype(np.float32)
    X0 = (lms + rng.normal(scale=0.3, size=lms.shape)).astype(np.float32)
    return dict(
        T_c2w=T0, X=X0, obs_uv=obs, obs_mask=msk, obs_ur=obs_ur, obs_ur_mask=msk.copy(),
        X_mask=np.ones(M, bool), kf_mask=np.ones(K, bool),
    )


def _rot_angle(R):
    """Small rotation angles from the antisymmetric part (arccos of the trace loses them below ~1e-3)."""
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arcsin(np.clip(0.5 * np.linalg.norm(v, axis=-1), 0.0, 1.0))


def test_inv3x3_matches_reference(ref, rng):
    M = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3.0 * np.eye(3, dtype=np.float32)
    got = p_win._inv3x3(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.win._inv3x3(ref.jnp.asarray(M))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(3), M.shape), atol=1e-4)


def test_project_jacobians_matches_reference(ref, rng, calib, gt):
    p = _ba_problem(rng, calib, gt, K=4, M=64)
    T_w2c = np.linalg.inv(p["T_c2w"]).astype(np.float32)
    r = ref.win._project_jacobians(ref.jnp.asarray(T_w2c), ref.jnp.asarray(p["X"]), ref.calib)
    g = p_win._project_jacobians(torch.from_numpy(T_w2c), torch.from_numpy(p["X"]), calib)
    for name, a, b in zip(("uv", "xc", "A", "B"), g, r):
        b = np.asarray(b)
        # 1e-5 of each array's scale (pixels run to ~1e3, Jacobian entries to ~1e3)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * max(1.0, np.abs(b).max()), rtol=1e-5, err_msg=name)


def test_block_diagonal_lands_where_jax_puts_it(ref, rng):
    K = 4
    S0 = rng.normal(size=(K, 6, K, 6)).astype(np.float32)
    blocks = rng.normal(size=(K, 6, 6)).astype(np.float32)
    ar = ref.jnp.arange(K)
    want = np.asarray(ref.jnp.asarray(S0).at[ar, :, ar, :].add(ref.jnp.asarray(blocks)))
    S = torch.from_numpy(S0.copy())
    p_win._block_diag_(S).add_(torch.from_numpy(blocks))
    np.testing.assert_array_equal(S.numpy(), want)
    for k in range(K):  # and nowhere else
        np.testing.assert_array_equal(S.numpy()[k, :, k, :], S0[k, :, k, :] + blocks[k])


@pytest.mark.parametrize("masked", [False, True])
def test_solve_window_matches_reference(ref, rng, calib, gt, masked):
    """The converging window of tests/test_ba.py, and its masked case (half the landmarks and the
    last keyframe invalid: the frozen keyframe stays where it was)."""
    p = _ba_problem(rng, calib, gt, K=5, M=128 if masked else 256)
    cfg = BAConfig(iters=6 if masked else 12)
    if masked:
        p["X_mask"][64:] = False
        p["kf_mask"][4] = False
    r = ref.jax.jit(lambda q: ref.win.solve_window(q, ref.calib, cfg))(
        ref.win.BAProblem(**{k: ref.jnp.asarray(v) for k, v in p.items()})
    )
    g = p_win.solve_window(convert.ba_problem_from_numpy(p, "cpu"), calib, cfg)
    T_r, T_g = np.asarray(r.T_c2w, np.float64), g.T_c2w.numpy().astype(np.float64)
    assert np.isfinite(T_g).all()
    np.testing.assert_allclose(T_g[:, :3, 3], T_r[:, :3, 3], atol=TOL)
    assert _rot_angle(np.swapaxes(T_g[:, :3, :3], -1, -2) @ T_r[:, :3, :3]).max() < TOL
    np.testing.assert_allclose(float(g.cost0), float(r.cost0), rtol=1e-3)
    np.testing.assert_allclose(float(g.cost), float(r.cost), rtol=1e-3)
    assert int(g.n_obs) == int(r.n_obs)
    if masked:
        np.testing.assert_allclose(T_g[4], p["T_c2w"][4], atol=TOL)
    else:
        assert float(g.cost) < 0.05 * float(g.cost0)
        assert np.linalg.norm(T_g[:, :3, 3] - gt[:5, :3, 3], axis=1).max() < 0.02


@pytest.mark.gpu
def test_solve_window_cuda_matches_cpu(calib, gt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    p = _ba_problem(np.random.default_rng(42), calib, gt, K=10, M=512)
    cfg = BAConfig()
    pc = calib
    cpu = p_win.solve_window(convert.ba_problem_from_numpy(p, "cpu"), pc, cfg)
    dev = torch.device("cuda")
    gpu = p_win.solve_window(convert.ba_problem_from_numpy(p, dev), pc.to(dev), cfg)
    np.testing.assert_allclose(gpu.T_c2w.cpu().numpy(), cpu.T_c2w.numpy(), atol=TOL)
    np.testing.assert_allclose(float(gpu.cost), float(cpu.cost), rtol=1e-3)


def _drifted_chain(gt_poses, n, step, slope):
    T_true = gt_poses[np.arange(n) * step]
    Td = T_true.copy()
    for i in range(n):
        d = np.eye(4)
        d[0, 3] = slope * i / n
        Td[i] = d @ T_true[i]
    ei, ej = list(range(n - 1)) + [0], list(range(1, n)) + [n - 1]
    eT = [np.linalg.inv(Td[k]) @ Td[k + 1] for k in range(n - 1)] + [np.linalg.inv(T_true[0]) @ T_true[n - 1]]
    return Td, np.array(ei), np.array(ej), np.stack(eT), np.array([1.0] * (n - 1) + [30.0])


def test_pose_graph_optimize_np_equals_reference(ref, gt):
    args = _drifted_chain(gt, 60, 15, 3.0)
    T_r, c0_r, c_r = ref.pg.optimize_np(*args, iters=12)
    T_g, c0_g, c_g = p_pg.optimize_np(*args, iters=12)
    np.testing.assert_array_equal(T_g, T_r)
    assert (c0_g, c_g) == (c0_r, c_r) and c_g < 1e-4 * c0_g
    xi = np.random.default_rng(3).normal(size=(16, 6))
    xi[:4, 3:] *= np.pi / np.linalg.norm(xi[:4, 3:], axis=1, keepdims=True)  # the near-pi branch
    np.testing.assert_array_equal(p_pg._np_log_se3(p_pg._np_exp_se3(xi)), ref.pg._np_log_se3(ref.pg._np_exp_se3(xi)))


def _displaced_chain(gt, K=9):
    """tests/test_dist.py's graph: K GT poses chained by their odometry edges, two of them displaced."""
    pert = gt[:K].astype(np.float32).copy()
    pert[3][:3, 3] += [0.2, -0.1, 0.15]
    pert[6][:3, 3] += [-0.15, 0.05, 0.2]
    return gt[:K].astype(np.float32), pert


def test_pose_graph_device_solver_matches_reference(ref, gt):
    """odometry_edges, the residuals with their forward-mode Jacobians, and 8 Gauss-Newton
    iterations, float32 on the device, against the reference's jitted solver."""
    T_gt, pert = _displaced_chain(gt)
    jnp = ref.jnp
    r_edges = ref.pg.odometry_edges(jnp.asarray(T_gt))
    p_edges = p_pg.odometry_edges(torch.from_numpy(T_gt))
    for name, a, b in zip(("i", "j", "Z", "mask", "weight"), p_edges, r_edges):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=name)
        assert a.numpy().dtype == np.asarray(b).dtype, name
    r_g = ref.pg.PoseGraph(jnp.asarray(pert), *r_edges)
    p_g = p_pg.PoseGraph(torch.from_numpy(pert), *p_edges)

    want = ref.pg._residuals_and_jac(r_g.T_c2w, r_g)
    got = p_pg._residuals_and_jac(p_g.T_c2w, p_g)
    for name, a, b in zip(("r", "Ji", "Jj"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    # At the GT poses every residual is 0 and xi = 0 sits on log's theta = 0 branch: finite there too.
    at_zero = p_pg._residuals_and_jac(torch.from_numpy(T_gt), p_g._replace(T_c2w=torch.from_numpy(T_gt)))
    assert all(torch.isfinite(a).all() for a in at_zero) and float(at_zero[0].abs().max()) < 1e-5

    r_res = ref.pg.optimize(r_g, iters=8)
    p_res = p_pg.optimize(p_g, iters=8)
    np.testing.assert_allclose(p_res.T_c2w.numpy(), np.asarray(r_res.T_c2w), atol=2e-4)
    np.testing.assert_allclose(float(p_res.cost0), float(r_res.cost0), rtol=1e-4)
    assert float(p_res.cost) < float(p_res.cost0) and float(p_res.cost) < 1e-6

    # and against the port's own host float64 solve of the same graph
    ei, ej, Z, _, ew = (np.asarray(x) for x in r_edges)
    T_np, _, _ = p_pg.optimize_np(pert.astype(np.float64), ei, ej, Z.astype(np.float64), ew.astype(np.float64), iters=8)
    np.testing.assert_allclose(p_res.T_c2w.numpy(), T_np, atol=1e-3)


def test_pose_graph_assembly_equals_scatter_add(rng):
    """The one-hot assembly against plain scatter-adds (the reference's ``.at[].add``), on a graph
    with a loop edge, a repeated pair and a masked edge."""
    K, E = 6, 9
    T = p_pg.se3.exp(torch.from_numpy(rng.normal(0, 0.3, (K, 6)).astype(np.float32)))
    ei = torch.tensor([0, 1, 2, 3, 4, 0, 1, 1, 2], dtype=torch.int32)
    ej = torch.tensor([1, 2, 3, 4, 5, 5, 2, 3, 5], dtype=torch.int32)
    Z = torch.matmul(p_pg.se3.inv(T[ei.long()]), T[ej.long()])
    Z = torch.matmul(Z, p_pg.se3.exp(torch.from_numpy(rng.normal(0, 0.05, (E, 6)).astype(np.float32))))
    mask = torch.tensor([True] * 8 + [False])
    g = p_pg.PoseGraph(T, ei, ej, Z, mask, torch.from_numpy(rng.uniform(0.5, 2.0, E).astype(np.float32)))
    w = torch.where(mask, g.edge_weight, 0.0)
    H, b, deg = p_pg.assemble(T, g, w)
    r, Ji, Jj = p_pg._residuals_and_jac(T, g)
    H_want, b_want, deg_want = torch.zeros(K, 6, K, 6), torch.zeros(K, 6), torch.zeros(K)
    for e in range(E):
        i, j = int(ei[e]), int(ej[e])
        H_want[i, :, i, :] += w[e] * Ji[e].T @ Ji[e]
        H_want[j, :, j, :] += w[e] * Jj[e].T @ Jj[e]
        H_want[i, :, j, :] += w[e] * Ji[e].T @ Jj[e]
        H_want[j, :, i, :] += w[e] * Jj[e].T @ Ji[e]
        b_want[i] -= w[e] * Ji[e].T @ r[e]
        b_want[j] -= w[e] * Jj[e].T @ r[e]
        deg_want[i] += float(mask[e])
        deg_want[j] += float(mask[e])
    np.testing.assert_allclose(H.numpy(), H_want.numpy(), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), b_want.numpy(), atol=1e-5)
    np.testing.assert_array_equal(deg.numpy(), deg_want.numpy())


def test_windowed_ba_optimize_is_dispatch_then_collect(rng, calib, gt):
    """``WindowedBA.optimize`` (the reference's synchronous form): None until a window can be
    assembled, then the poses of the solve and the last keyframe's correction."""
    kfs = _window_keyframes(rng, calib, gt)
    wba = p_bar.WindowedBA(calib, BAConfig(window=6, max_points=256, iters=4), device="cpu")
    wba.add_keyframe(p_bar.Keyframe(**kfs[0]))
    assert wba.optimize() is None
    for kf in kfs[1:]:
        wba.add_keyframe(p_bar.Keyframe(**kf))
    T_new, corr = wba.optimize()
    assert T_new.shape == (6, 4, 4) and np.isfinite(T_new).all()
    np.testing.assert_allclose(corr, T_new[-1] @ np.linalg.inv(wba.window[-1].pose_c2w), atol=1e-6)
    assert np.linalg.norm(corr[:3, 3]) < 0.5 and not wba._pending


def _window_keyframes(rng, calib, gt_poses, K=6, M=300, C=256):
    """K keyframes 2 frames apart observing M landmarks, with detection noise, gross outliers,
    unobserved rows and a few ids pointing at the wrong landmark."""
    lms = p_syn.scatter_landmarks(rng, gt_poses[: 2 * K], M)
    P1, P2 = calib.P1.numpy().astype(np.float64), calib.P2.numpy().astype(np.float64)
    H, W = calib.image_size
    kfs = []
    for k in range(K):
        T = gt_poses[2 * k]
        cam = p_syn._w2c_apply(T, lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px, pxr = p_syn.project_np(P1, safe), p_syn.project_np(P2, safe)
        vis = np.flatnonzero((cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H))
        rows = rng.permutation(vis)[:C]
        l_px = np.zeros((C, 2), np.float32)
        r_px = np.zeros((C, 2), np.float32)
        ids = np.full(C, -1, np.int64)
        n = rows.size
        l_px[:n] = px[rows] + rng.normal(scale=0.3, size=(n, 2))
        r_px[:n] = np.stack([pxr[rows, 0], px[rows, 1]], -1) + rng.normal(scale=0.3, size=(n, 2))
        ids[:n] = rows
        l_px[: n // 20] += 25.0  # gross outliers for the reprojection pre-gate
        ids[n // 20 : n // 10] = rng.integers(0, M, n // 10 - n // 20)  # mis-associations
        mask = np.zeros(C, bool)
        mask[:n] = rng.random(n) < 0.95
        pose = _perturb(rng, T, rot=0.002, trans=0.02) if k else T.astype(np.float32)
        kfs.append(dict(frame_idx=2 * k + 2, pose_c2w=pose, ids=ids, l_px=l_px, r_px=r_px, mask=mask))
    return kfs


def test_windowed_ba_assemble_equals_reference(ref, rng, calib, gt):
    cfg = BAConfig(window=6, max_points=256)
    r_ba = ref.bar.WindowedBA(ref.calib, cfg)
    port = p_bar.WindowedBA(calib, cfg, device="cpu")
    for k, kf in enumerate(_window_keyframes(rng, calib, gt)):
        r_kf = ref.bar.Keyframe(**{n: np.copy(v) if isinstance(v, np.ndarray) else v for n, v in kf.items()})
        r_ba.add_keyframe(r_kf)
        port.add_keyframe(convert.keyframe_from_numpy(r_kf))
        r_prob, p_prob = r_ba._assemble(), port._assemble()
        assert (r_prob is None) == (p_prob is None) == (k < 2)
        if r_prob is not None:
            for f in p_win.BAProblem._fields:
                np.testing.assert_array_equal(getattr(p_prob, f).numpy(), np.asarray(getattr(r_prob, f)), err_msg=f)
    assert port.n_active == r_ba.n_active and port.n_candidate == r_ba.n_candidate
    assert 12 <= port.n_active[-1] < port.n_candidate[-1]  # the gates dropped some tracks


def test_window_associator_equals_reference(ref, rng):
    K, C = 4, 64
    r_as, port = ref.bar.WindowAssociator(K), p_bar.WindowAssociator(K)
    for t in range(11):
        valid = rng.random(C) < 0.8
        m_a = rng.integers(0, C, (K, C))
        m_b = rng.integers(0, C, (K, C))
        m_ok = rng.random((K, C)) < 0.3
        slot = t % K
        r_t = r_as.add(slot, valid, m_a, m_b, m_ok)
        p_t = port.add(slot, valid.copy(), m_a.copy(), m_b.copy(), m_ok.copy())
        np.testing.assert_array_equal(p_t, r_t)
        for a, b in zip(port._slot_tids, r_as._slot_tids):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert port._next == r_as._next and port._parent == r_as._parent
    assert len(set(p_t[p_t >= 0])) < int((p_t >= 0).sum())  # tracks were merged


def test_collect_makes_the_reference_decisions(ref, calib):
    """Ripe solves through both gates: accepted, cost rise, non-finite cost, a correction beyond
    max_corr_t and one beyond max_corr_deg (both counted as rejected), and a stale window."""
    cfg = BAConfig(window=3)
    r_ba = ref.bar.WindowedBA(ref.calib, cfg)
    port = p_bar.WindowedBA(calib, cfg, device="cpu")
    poses = [np.eye(4, dtype=np.float32) for _ in range(3)]
    for k, P in enumerate(poses):
        P[0, 3] = float(k)
        for w, Keyframe in ((r_ba, ref.bar.Keyframe), (port, p_bar.Keyframe)):
            w.add_keyframe(Keyframe(k, P.copy(), np.zeros(1, np.int64), np.zeros((1, 2)), np.zeros((1, 2)), np.zeros(1, bool)))
    idxs = [0, 1, 2]
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 1.5
    turn = np.eye(4, dtype=np.float32)
    turn[:3, :3] = p_pg._np_exp_so3(np.array([0.0, 0.05, 0.0]))
    small = np.eye(4, dtype=np.float32)
    small[2, 3] = 0.05
    cases = [
        (np.stack(poses), 1.0, 2.0, idxs),
        (np.stack(poses), 3.0, 2.0, idxs),
        (np.stack(poses), np.nan, 2.0, idxs),
        (np.stack([shift @ P for P in poses]), 1.0, 2.0, idxs),
        (np.stack([turn @ P for P in poses]), 1.0, 2.0, idxs),
        (np.stack([small @ P for P in poses]), 1.0, 2.0, idxs),
        (np.stack(poses), 1.0, 2.0, [7, 8, 9]),
    ]
    for T, cost, cost0, ki in cases:
        T = T.astype(np.float32)
        r_ba._pending.append((ref.win.BAResult(T, np.zeros((0, 3)), np.float32(cost0), np.float32(cost), 0), ki))
        port._pending.append((HostCopy(*(torch.tensor(np.asarray(x, np.float32)) for x in (T, cost, cost0))), ki))
    r_out, p_out = r_ba.collect(drain=True), port.collect(drain=True)
    assert [k for k, _ in p_out] == [k for k, _ in r_out] == [idxs, idxs]
    for (_, a), (_, b) in zip(p_out, r_out):
        np.testing.assert_array_equal(a, b)
    assert port.n_rejected == r_ba.n_rejected == 2
