"""The refined path's four programs over static buffers (utils.graphs.StaticCall), against eager and the reference.

On a CUDA card the window solve (odometry.ba_runner.WindowedBA), the
verification round (slam.loop_closure.LoopCloser), the global descriptor
(odometry.refiner.RefinerWorker.submit) and the keyframe association
(odometry.runner._Keyframes) are CUDA graphs. A CUDA graph cannot run here, so
the ``static`` fixture stands in for ``graphs.capture`` as in
tests/test_torch_graphs.py: its "replay" runs the recorded body and writes the
outputs into static buffers, as a replay overwrites a graph's outputs. Each
program is held to its eager call bit for bit, its outputs read as late as the
worker reads them (a result that was not copied out before the next call would
hold that call's values), and the padded verification round and the
association to the reference on the same inputs. The ``gpu`` cases make the
same comparisons with real capture on the card; the reference is imported
inside fixtures only, so they collect without jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_worker_graphs.py

Sizes: the refined runs at 128x256, 2 octaves, 256 keypoints, 64 RANSAC
hypotheses (tests/test_torch_graphs.py's); the verification rounds on 160x320
detections with 384 keypoints (tests/test_torch_loop_closure.py's); window
solves at the default (K, M) = (10, 512).
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch import convert
from vo_tpu_torch.frontend.sift import detect_and_describe
from vo_tpu_torch.frontend.track import stereo_features_with_matches
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import ba_runner as p_bar
from vo_tpu_torch.odometry import checkpoint as p_ckpt
from vo_tpu_torch.odometry import refiner as p_ref
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.slam import loop_closure as p_lc
from vo_tpu_torch.utils import graphs
from vo_tpu_torch.utils.host_copy import HostCopy

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (128, 256)
CAP = 384  # keypoints of the verification rounds' detections
LOOP_FRAMES = (0, 1, 2, 3, 18)  # candidates 0-3 and the query 18 of the out-and-back
POSE_TOL = 1e-4  # tests/test_torch_loop_closure.py::test_verify_round_with_reference_triples
PROGRAMS = ("window_solve", "verification_round", "global_descriptor", "keyframe_association")


def _cfg(**kw):
    return p_config.PipelineConfig(
        sift=p_config.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=p_config.RansacConfig(n_hypotheses=64),
        max_tracks=256,
        **kw,
    )


def _loop_cfg():
    return p_config.LoopConfig(radius=8.0, min_gap=8, min_inliers=15, max_keyframes=32, graph_iters=10)


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
    """Programs take the static-buffer path on the CPU, with the body in place of a graph's replay."""
    made = []

    def capture(body, device, pool=None, generators=()):
        graphs.refuse_nan_debug()
        made.append(_BodyReplay(body))
        return made[-1]

    monkeypatch.setattr(graphs, "wanted", lambda graph, device, mesh=None: mesh is None and graph is not False)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "Pool", lambda device: None)
    graphs.reset_programs()
    return made


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _calib():
    return p_kitti.load_stereo_calib(str(DATA / "00"))


# ---- the window solve --------------------------------------------------------------------------


def _window_keyframes(n: int, seed: int = 3) -> list:
    """``n`` keyframes 1 m apart along the optical axis, each observing 256 of 400 landmarks (ids =
    landmark index) with 0.3 px noise, their chained poses off the truth by a few centimetres, so
    that every window's solve has work to do and differs from the last."""
    rng = np.random.default_rng(seed)
    c = _calib()
    fu, fv, cu, cv, b = (float(x) for x in (c.fu, c.fv, c.cu, c.cv, c.baseline))
    X = np.stack([rng.uniform(-12, 12, 400), rng.uniform(-2, 2, 400), rng.uniform(n + 8, n + 40, 400)], 1)
    kfs = []
    for k in range(n):
        sel = np.sort(rng.choice(400, 256, replace=False))
        x, y, z = (X[sel] - [0.0, 0.0, float(k)]).T
        noise = rng.normal(0.0, 0.3, (256, 3))
        l_px = np.stack([fu * x / z + cu, fv * y / z + cv], 1) + noise[:, :2]
        r_px = np.stack([fu * (x - b) / z + cu, fv * y / z + cv], 1) + noise[:, 2:] * [1.0, 0.0]
        pose = np.eye(4)
        pose[:3, 3] = [0.0, 0.0, float(k)] + rng.normal(0.0, 0.03, 3)
        kfs.append(p_bar.Keyframe(k, pose.astype(np.float32), sel.astype(np.int32), l_px.astype(np.float32),
                                  r_px.astype(np.float32), np.ones(256, bool)))
    return kfs


def _window_solves(device, graph) -> list:
    """Dispatch a solve at each of 8 keyframes (from the third on), collected PIPELINE_DEPTH
    keyframes late as the worker collects them -> [(window frame indices, T_new)]."""
    wba = p_bar.WindowedBA(_calib(), p_config.BAConfig(), device=device, graph=graph)
    wba.warmup()
    got = []
    for kf in _window_keyframes(8):
        wba.add_keyframe(kf)
        wba.dispatch()
        got += wba.collect()
    return got + wba.collect(drain=True)


def _same_window_solves(device) -> None:
    got, want = _window_solves(device, None), _window_solves(device, False)
    assert len(got) == len(want) >= 3
    for (gi, gT), (wi, wT) in zip(got, want):
        assert gi == wi and np.array_equal(gT, wT)
    # Successive solves differ: a result read late without its copy would show another solve's values.
    assert not any(np.array_equal(a[1][-1], b[1][-1]) for a, b in zip(want, want[1:]))


def test_window_solves_over_static_buffers_equal_eager(static):
    _same_window_solves("cpu")
    assert graphs.PROGRAMS["window_solve"]["captures"] == 1  # at warmup, on the production (K, M)
    assert graphs.PROGRAMS["window_solve"]["replays"] == 1 + 6  # warmup's, then keyframes 3..8


def _last_results(device, graph) -> list:
    """The window solves of ``_window_solves`` -> each new ``last_result`` as the worker's collect left it,
    with a copy of its arrays taken then."""
    wba = p_bar.WindowedBA(_calib(), p_config.BAConfig(), device=device, graph=graph)
    wba.warmup()
    seen = []
    for kf in _window_keyframes(8) + [None]:
        if kf is not None:
            wba.add_keyframe(kf)
            wba.dispatch()
        wba.collect(drain=kf is None)
        if wba.last_result is not None and (not seen or wba.last_result is not seen[-1][0]):
            seen.append((wba.last_result, [np.array(x) for x in wba.last_result]))
    return seen


def _same_last_results(device) -> None:
    got, want = _last_results(device, None), _last_results(device, False)
    assert len(got) == len(want) >= 3
    for (g, g_then), (w, _) in zip(got, want):
        # Read after every later replay: still the values it had when collected, and eager's.
        for a, b, c in zip(g, g_then, w):
            assert isinstance(a, np.ndarray) and np.array_equal(a, b) and np.array_equal(a, c)
        assert int(g.n_obs) > 30 and float(g.cost) <= float(g.cost0)
    assert not any(np.array_equal(a[0].X, b[0].X) for a, b in zip(got, got[1:]))


def test_last_result_over_static_buffers_is_a_copy(static):
    """``WindowedBA.last_result`` of a graphed solve is a host copy taken at collect, not the static
    outputs a later replay overwrites: every one keeps its values and equals the eager solve's."""
    _same_last_results("cpu")
    assert graphs.PROGRAMS["window_solve"]["replays"] == 1 + 6


# ---- the verification round --------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_feats():
    """The out-and-back of tests/test_torch_loop_closure.py (GT 0..9 then 8..0 at 160x320), detected by
    the port -> (calib, poses, {frame: (stereo features, (xy, desc, mask) of the full left set)})."""
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:10], gt[8::-1]])
    seq = p_syn.SyntheticSequence(_calib(), poses, n_landmarks=2500, seed=12, image_size=(160, 320))
    sift = p_config.SIFTConfig(max_keypoints=CAP, n_octaves=2)
    feats = {}
    for i in LOOP_FRAMES:
        f = detect_and_describe(torch.from_numpy(np.stack(seq.frame(i))), sift)
        fl, fr = (type(f)(*(x[k] for x in f)) for k in (0, 1))
        sf, _ = stereo_features_with_matches(fl, fr, p_config.MatcherConfig(), CAP)
        feats[i] = (convert.to_numpy(sf), (fl.xy.numpy(), fl.desc.numpy(), fl.mask.numpy()))
    return seq.calib, poses, feats


def _archived(i, pose, sf):
    return p_lc.ArchivedKeyframe(
        frame_idx=i, pose_c2w=np.asarray(pose, np.float32), l_px=sf.l_xy.copy(), r_px=sf.r_xy.copy(),
        l_desc=sf.l_desc.copy(), mask=sf.mask.copy(),
    )


def _rounds(loop_feats, device, graph) -> tuple:
    """Two rounds on one closer, of 2 and 3 candidates, read after both were dispatched ->
    (each round's outputs, the generator's state after each round)."""
    calib, poses, feats = loop_feats
    lc = p_lc.LoopCloser(calib, _loop_cfg(), device=device, graph=graph)
    lc.warmup(CAP, CAP)
    cands = [_archived(i, poses[i], feats[i][0]) for i in (0, 1, 2, 3)]
    q = tuple(torch.from_numpy(x).to(device) for x in feats[18][1])
    outs, states = [], []
    for round_cands in (cands[:2], [cands[2], cands[3], cands[0]]):
        outs.append(lc._dispatch_verify(round_cands, None, query_dev=q))
        states.append(lc._gen.get_state().cpu())
    return [o.numpy() for o in outs], states


def _same_rounds(loop_feats, device) -> None:
    (got, g_states), (want, w_states) = _rounds(loop_feats, device, None), _rounds(loop_feats, device, False)
    for g, w in zip(got, want):
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w))
    assert all(torch.equal(a, b) for a, b in zip(g_states, w_states))
    assert not torch.equal(w_states[0], w_states[1])  # the second round drew on from the first
    assert not np.array_equal(want[0][3], want[1][3])  # and verified other candidates
    assert want[0][0].any() and want[0][3].max() >= _loop_cfg().min_inliers


def test_verification_rounds_over_static_buffers_equal_eager(loop_feats, static):
    _same_rounds(loop_feats, "cpu")
    assert graphs.PROGRAMS["verification_round"]["captures"] == 1  # at warmup
    assert graphs.PROGRAMS["verification_round"]["replays"] == 1 + 2  # warmup's, then the two rounds


@pytest.fixture(scope="module")
def ref():
    """The jax reference's modules."""
    import jax
    import jax.numpy as jnp

    from vo_tpu import config
    from vo_tpu.frontend.match import match
    from vo_tpu.geom.camera import scale_calib
    from vo_tpu.geom.triangulate import triangulate_rectified
    from vo_tpu.io import kitti
    from vo_tpu.pose import ransac
    from vo_tpu.slam import loop_closure

    return SimpleNamespace(jax=jax, jnp=jnp, config=config, match=match, scale_calib=scale_calib,
                           triangulate=triangulate_rectified, kitti=kitti, ransac=ransac, lc=loop_closure)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_padded_round_matches_the_reference(loop_feats, ref, n):
    """``n`` < B = candidate_budget candidates: the port pads the round with the first candidate as
    the reference's ``_dispatch_verify`` does, and with the reference's draws injected for all B the
    outputs equal those of the reference's ``_verify_prog`` on its own padding (pose within 1e-4)."""
    _, poses, feats = loop_feats
    jax, jnp = ref.jax, ref.jnp
    r_calib = ref.scale_calib(ref.kitti.load_stereo_calib(str(DATA / "00")), (160, 320))
    r_cfg = ref.config.LoopConfig(radius=8.0, min_gap=8, min_inliers=15, max_keyframes=32, graph_iters=10)
    B = r_cfg.candidate_budget
    assert n < B == _loop_cfg().candidate_budget
    r_lc = ref.lc.LoopCloser(r_calib, r_cfg)
    port = p_lc.LoopCloser(convert.calib_from_numpy(r_calib, "cpu"), _loop_cfg(), device="cpu", graph=False)
    cands = [ref.lc.ArchivedKeyframe(frame_idx=i, pose_c2w=poses[i].astype(np.float32), l_px=feats[i][0].l_xy,
                                     r_px=feats[i][0].r_xy, l_desc=feats[i][0].l_desc, mask=feats[i][0].mask)
             for i in (0, 1, 2, 3)][:n]
    padded = cands + [cands[0]] * (B - n)
    q = feats[18][1]
    r_out, _ = r_lc._verify_prog(tuple(r_lc._dev_of(c) for c in padded), *(jnp.asarray(x) for x in q), jax.random.PRNGKey(17))
    # The reference's draws: _verify_fused splits the key once, then once per candidate of the padded batch.
    _, sub = jax.random.split(jax.random.PRNGKey(17))
    keys = jax.random.split(sub, B)
    vm = dataclasses.replace(ref.config.MatcherConfig(), max_ratio=r_cfg.verify_ratio, mutual=r_cfg.verify_mutual)
    triples = []
    for c, k in zip(padded, keys):
        m = ref.match(jnp.asarray(q[1]), jnp.asarray(q[2]), jnp.asarray(c.l_desc), jnp.asarray(c.mask), vm, r_cfg.match_capacity)
        X = jnp.take(ref.triangulate(jnp.asarray(c.l_px), jnp.asarray(c.r_px), r_calib), m.b_idx, axis=0)
        msk = m.mask & (X[:, 2] > 0.5) & (X[:, 2] < 150.0)
        triples.append(torch.tensor(np.asarray(ref.ransac._sample_triples(k, msk, port.ransac.n_hypotheses)), dtype=torch.long))
    p_cands = [convert.archived_keyframe_from_numpy(c, "cpu") for c in cands]
    outs = port._dispatch_verify(p_cands, None, query_dev=tuple(torch.from_numpy(x) for x in q), triples=triples)
    ok, n_in, pose, n_m = outs.numpy()
    r_ok, r_n_in, r_pose, r_n_m = (np.asarray(x) for x in r_out)
    assert ok.shape == (B,)
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(n_m, r_n_m)
    np.testing.assert_array_equal(n_in, r_n_in)
    assert ok[0] and n_in[0] >= r_cfg.min_inliers
    np.testing.assert_allclose(pose[ok], r_pose[r_ok], atol=POSE_TOL)
    got = p_lc.LoopCloser._collect_verify(outs, n, r_cfg.min_inliers)
    want = ref.lc.LoopCloser._collect_verify(r_out, n, r_cfg.min_inliers)
    assert len(got) == n and [z is None for z in got] == [z is None for z in want]


# ---- the keyframe association ------------------------------------------------------------------


def _assoc_keyframes(cfg, n: int, seed: int = 5) -> list:
    """``n`` keyframes' (desc, mask) as numpy: each a random subset of 400 unit descriptors with
    small noise, in shuffled order, its last 40 rows masked out (so revisited slots match)."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(size=(400, 128)))
    C = cfg.max_tracks
    out = []
    for _ in range(n):
        d = base[rng.choice(400, C, replace=False)] + np.abs(rng.normal(0.0, 0.02, (C, 128)))
        mask = np.ones(C, bool)
        mask[-40:] = False
        out.append(((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32), mask))
    return out


def _assoc_cfg():
    cfg = _cfg()
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, window=4))


def _associations(device, graph, n: int) -> tuple:
    """``n`` keyframes through one _Keyframes ring, each result read at the end as the worker reads it
    -> ([(slot, a, b, ok)], the final ring)."""
    cfg = _assoc_cfg()
    kfs = p_runner._Keyframes(None, cfg, device, use_ba=True, graph=graph)
    copies = []
    for d, m in _assoc_keyframes(cfg, n):
        slot, *outs = kfs.associate(torch.from_numpy(d).to(device), torch.from_numpy(m).to(device))
        copies.append((slot, HostCopy(*outs)))
    return [(slot, *c.numpy()) for slot, c in copies], HostCopy(kfs.ring_desc, kfs.ring_mask).numpy()


def _same_associations(device) -> None:
    n = _assoc_cfg().ba.window + 3  # the ring wraps
    (got, g_ring), (want, w_ring) = _associations(device, None, n), _associations(device, False, n)
    assert [r[0] for r in want] == [k % _assoc_cfg().ba.window for k in range(n)]
    for g, w in zip(got, want):
        assert g[0] == w[0] and all(np.array_equal(a, b) for a, b in zip(g[1:], w[1:]))
    assert all(np.array_equal(a, b) for a, b in zip(g_ring, w_ring))
    assert all(w[3].sum() > 20 for w in want[1:])  # every keyframe after the first matched its window
    assert not np.array_equal(want[-1][3], want[-2][3])


def test_association_over_static_ring_equals_eager(static):
    _same_associations("cpu")
    n = _assoc_cfg().ba.window + 3
    assert graphs.PROGRAMS["keyframe_association"]["captures"] == 1  # one program for every slot
    assert graphs.PROGRAMS["keyframe_association"]["replays"] == n


def test_association_matches_the_reference_kf_assoc(ref):
    """The port's association program against the reference's ``kf_assoc`` body (``match`` per ring
    slot at float32) on the same ring: a_idx, b_idx and mask equal, slot by slot."""
    cfg = _assoc_cfg()
    r_matcher = ref.config.MatcherConfig()
    assert convert.config_from_reference(r_matcher) == cfg.matcher
    kfs = p_runner._Keyframes(None, cfg, "cpu", use_ba=True, graph=False)
    ring = []  # the reference's ring: (desc, mask) of the last `window` keyframes, zeros before
    zeros = (np.zeros((cfg.max_tracks, 128), np.float32), np.zeros(cfg.max_tracks, bool))
    n_matched = 0
    for k, (d, m) in enumerate(_assoc_keyframes(cfg, cfg.ba.window + 2)):
        slots = [ring[s] if s < len(ring) else zeros for s in range(cfg.ba.window)]
        with ref.jax.default_matmul_precision("float32"):
            want = [ref.match(ref.jnp.asarray(d), ref.jnp.asarray(m), ref.jnp.asarray(rd), ref.jnp.asarray(rm),
                              r_matcher, cfg.max_tracks) for rd, rm in slots]
        slot, a, b, ok = kfs.associate(torch.from_numpy(d), torch.from_numpy(m))
        assert slot == k % cfg.ba.window
        np.testing.assert_array_equal(a.numpy(), np.stack([np.asarray(r.a_idx) for r in want]))
        np.testing.assert_array_equal(b.numpy(), np.stack([np.asarray(r.b_idx) for r in want]))
        np.testing.assert_array_equal(ok.numpy(), np.stack([np.asarray(r.mask) for r in want]))
        n_matched += int(ok.sum())
        if len(ring) < cfg.ba.window:
            ring.append((d, m))
        else:
            ring[slot] = (d, m)
    assert n_matched > 1000


# ---- the global descriptor ---------------------------------------------------------------------


def _gdesc_cfg():
    return dataclasses.replace(_cfg(), max_tracks=128)  # the two shapes submit can hand it differ


def _global_descs(device, graph) -> tuple:
    """A loop-closure refiner's global descriptor at both shapes, alternating, read at the end ->
    (descriptors, the shapes captured, the verification rounds' query shapes captured)."""
    cfg = _gdesc_cfg()
    w = p_ref.RefinerWorker(_calib(), cfg, use_ba=False, use_loop_closure=True, device=device, graph=graph)
    rng = np.random.default_rng(9)
    copies = []
    try:
        for k in range(4):
            n = cfg.sift.max_keypoints if k % 2 == 0 else cfg.max_tracks
            d = torch.from_numpy(np.abs(rng.normal(size=(n, 128))).astype(np.float32)).to(device)
            m = torch.from_numpy(rng.random(n) < 0.7).to(device)
            copies.append(HostCopy(w._gdesc(d, m)))
    finally:
        w.close()
    # (a ByShape key holds (shape, dtype) per input tensor: the query's mask comes last, the descriptors first)
    rounds = None if w.lclo._rounds is None else sorted(k[-1][0][0] for k in w.lclo._rounds.calls)
    shapes = None if not isinstance(w._gdesc, graphs.ByShape) else sorted(k[0][0][0] for k in w._gdesc.calls)
    return [c.numpy()[0] for c in copies], shapes, rounds


def _same_global_descs(device) -> None:
    (got, shapes, rounds), (want, _, _) = _global_descs(device, None), _global_descs(device, False)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    cfg = _gdesc_cfg()
    both = sorted((cfg.max_tracks, cfg.sift.max_keypoints))
    assert shapes == both and rounds == both  # captured in the warm-up at both shapes
    assert not np.array_equal(want[0], want[2])


def test_global_desc_over_static_buffers_equals_eager(static):
    _same_global_descs("cpu")
    assert graphs.PROGRAMS["global_descriptor"]["captures"] == 2
    assert graphs.PROGRAMS["global_descriptor"]["replays"] == 4


# ---- the refined run -------------------------------------------------------------------------


def _refined_feed():
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:8], gt[6::-1]])
    return p_syn.SyntheticSequence(_calib(), poses, n_landmarks=900, seed=6, image_size=SIZE)


def _refined_cfg():
    cfg = _cfg()
    return dataclasses.replace(
        cfg,
        ba=dataclasses.replace(cfg.ba, keyframe_every=2, window=4),
        loop=dataclasses.replace(cfg.loop, min_gap=2, verify_cooldown=1),
    )


RUN_FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
STATS = ("n_keyframes", "ba_solves", "lc_verified", "loops_closed")


def _same_run(got, want) -> None:
    for k in RUN_FIELDS:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for k in STATS:
        assert got.refine_stats[k] == want.refine_stats[k], k


def _refined_runs(device) -> tuple:
    seq, cfg = _refined_feed(), _refined_cfg()
    kw = dict(use_ba=True, use_loop_closure=True, warmup=False, device=device)
    graphs.reset_programs()
    got = p_runner.run_sequence(seq, cfg, **kw)
    programs = {k: dict(v) for k, v in graphs.PROGRAMS.items()}
    want = p_runner.run_sequence(seq, cfg, graph=False, **kw)
    _same_run(got, want)
    assert want.refine_stats["ba_solves"] >= 1 and want.refine_stats["lc_verified"] >= 1
    return got, programs


def test_refined_run_over_static_buffers_equals_eager(static):
    """A refined run whose four programs (and step) write into static buffers equals the eager run
    bit for bit; each program was captured once (one shape each here) and replayed in the run."""
    got, programs = _refined_runs("cpu")
    n_kf = got.refine_stats["n_keyframes"]
    assert n_kf == 7
    assert {k: programs[k]["captures"] for k in PROGRAMS} == {k: 1 for k in PROGRAMS}
    assert programs["keyframe_association"]["replays"] == programs["global_descriptor"]["replays"] == n_kf
    assert programs["window_solve"]["replays"] >= got.refine_stats["ba_solves"]
    assert 1 <= programs["verification_round"]["replays"] <= n_kf


def _resumed_runs(device, tmp_path) -> None:
    """Checkpoint at frame 9 of 15 and resume, graphed; equal to the uninterrupted eager run (the
    non-deferred path, as the resumed one). The resume writes the saved generator state and ring into
    the programs' own (restore_state)."""
    seq, cfg = _refined_feed(), _refined_cfg()
    ck = str(tmp_path / "ck_refined.npz")
    kw = dict(use_ba=True, use_loop_closure=True, warmup=False, device=device, progress=lambda i, s: None)
    p_runner.run_sequence(seq, cfg, n_frames=9, checkpoint_path=ck, checkpoint_every=9, **kw)
    z = np.load(ck)
    assert {"refx_runner_ring_desc", "refx_lc_torch_gen_state", "refx_ba_pend0_T"} <= set(z.files)
    resumed = p_runner.run_sequence(seq, cfg, checkpoint_path=ck, resume=True, **kw)
    full = p_runner.run_sequence(seq, cfg, graph=False, **kw)
    _same_run(resumed, full)


def test_resumed_refined_run_over_static_buffers_equals_eager(static, tmp_path):
    _resumed_runs("cpu", tmp_path)


def test_restore_writes_into_the_registered_generator_and_the_static_ring(static, tmp_path):
    """restore_state copies the saved RANSAC stream and descriptor ring into the generator the
    verification rounds registered and the ring the association program reads; it binds no new one
    (a captured graph would go on with the old)."""
    seq, cfg = _refined_feed(), _refined_cfg()
    ck = str(tmp_path / "ck.npz")
    p_runner.run_sequence(seq, cfg, n_frames=9, checkpoint_path=ck, checkpoint_every=9, use_ba=True,
                          use_loop_closure=True, warmup=False, device="cpu", progress=lambda i, s: None)
    p = p_ckpt.load(ck, "cpu").refiner
    refiner = p_ref.RefinerWorker(seq.calib, cfg, use_ba=True, use_loop_closure=True, device="cpu", graph=True)
    try:
        kfs = p_runner._Keyframes(refiner, cfg, "cpu", use_ba=True, graph=True)
        gen, ring_desc, ring_mask = refiner.lclo._gen, kfs.ring_desc, kfs.ring_mask
        gen.manual_seed(1234)
        kfs.restore_state(p)
        assert refiner.lclo._gen is gen and kfs.ring_desc is ring_desc and kfs.ring_mask is ring_mask
        assert torch.equal(gen.get_state(), torch.from_numpy(p["lc_torch_gen_state"]))
        assert np.array_equal(ring_desc.numpy(), p["runner_ring_desc"]) and ring_desc.abs().sum() > 0
        assert np.array_equal(ring_mask.numpy(), p["runner_ring_mask"])
        assert kfs.slot == int(p["runner_assoc_slot"])
    finally:
        refiner.close()


# ---- eager by rule -----------------------------------------------------------------------------


def test_graph_true_raises_on_the_cpu_and_with_a_mesh():
    cfg = _cfg()
    calib = _calib()
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        p_bar.WindowedBA(calib, cfg.ba, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        p_lc.LoopCloser(calib, cfg.loop, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        p_ref.RefinerWorker(calib, cfg, use_ba=True, use_loop_closure=True, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        p_runner._Keyframes(None, cfg, "cpu", use_ba=True, graph=True)
    # A program that reduces over gloo (a sharded solve on ranks that share a card) is eager by rule,
    # and graph=True for it raises and names NCCL (WindowedBA and RefinerWorker on gloo ranks:
    # tests/test_torch_mesh_graphs.py).
    for backends in (("gloo",), ("nccl", "gloo")):
        with pytest.raises(ValueError, match="graph=True with a mesh whose collectives go over gloo.*NCCL"):
            graphs.wanted(True, "cpu", backends)
    # graph=None on the CPU is eager by rule.
    assert p_bar.WindowedBA(calib, cfg.ba, device="cpu")._graphed is False
    assert p_lc.LoopCloser(calib, cfg.loop, device="cpu")._rounds is None


# ---- on the card: real capture -----------------------------------------------------------------


@pytest.mark.gpu
def test_window_solves_on_the_card_equal_eager():
    _same_window_solves(_cuda())


@pytest.mark.gpu
def test_last_result_on_the_card_is_a_copy():
    _same_last_results(_cuda())


@pytest.mark.gpu
def test_verification_rounds_on_the_card_equal_eager(loop_feats):
    _same_rounds(loop_feats, _cuda())


@pytest.mark.gpu
def test_association_on_the_card_equals_eager():
    _same_associations(_cuda())


@pytest.mark.gpu
def test_global_desc_on_the_card_equals_eager():
    _same_global_descs(_cuda())


@pytest.mark.gpu
def test_refined_run_on_the_card_equals_eager():
    _, programs = _refined_runs(_cuda())
    assert all(programs[k]["captures"] >= 1 and programs[k]["replays"] >= 1 for k in PROGRAMS)


@pytest.mark.gpu
def test_resumed_refined_run_on_the_card_equals_eager(tmp_path):
    _resumed_runs(_cuda(), tmp_path)
