"""The tracer (utils.profiling): spans, device stage stamps, the step graphs' counts, and the
benchmark's readers of them.

On the CPU the steps run eagerly and a stamp is ``perf_counter_ns`` written at the stage
boundary, so the accounting the card's stamp kernel feeds runs here as it runs there; the
``static`` fixture (tests/test_torch_graphs.py) puts the steps on their static buffers, with the
body in place of a graph's replay. Sizes: 96x192 images, 2 octaves, 128 keypoints, 32 RANSAC
hypotheses. The ``gpu`` case captures for real and imports neither jax nor conftest's fixtures:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from vo_tpu_torch.config import PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import runner
from vo_tpu_torch.odometry.pipeline import stage_columns
from vo_tpu_torch.utils import graphs, profiling

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
RUNNER_SPANS = (runner.CAPTURE, runner.FRAME_LOOP, runner.FETCH, runner.STEP, runner.HOST_READ, runner.HOST_COPY,
                runner.READBACK)
READERS = ("capture_ms_per_job.offline",) + tuple(
    f"{s}_ms_per_frame.{c}" for c in ("offline", "live") for s in ("detect", "match", "pose", "map")
) + ("launch_ms_per_frame.live", "readback_ms_per_frame.live")


def _cfg(**kw):
    return PipelineConfig(
        sift=SIFTConfig(max_keypoints=128, n_octaves=2), ransac=RansacConfig(n_hypotheses=32), max_tracks=128, **kw
    )


@pytest.fixture(scope="module")
def seq():
    return runner.StagedSequence(
        p_syn.kitti_synthetic_sequence(n_frames=5, n_landmarks=600, seed=7, image_size=(96, 192)), 5, "cpu"
    )


# path -> (config, run_sequence's keywords): the grouped deferred path (2 + 2 + a single-frame tail),
# the single-frame deferred path, and the non-deferred path (one host read a frame).
PATHS = {
    "grouped": (_cfg(), {}),
    "single": (_cfg(fused_group=1), {}),
    "non_deferred": (_cfg(), dict(progress=lambda i, s: None)),
}


@pytest.fixture()
def static(monkeypatch):
    """Steps over static buffers on the CPU, the body in place of a replay (tests/test_torch_graphs.py)."""

    class _BodyReplay:
        def __init__(self, body):
            self.body = body
            self.outputs = graphs.static_copy(body())
            self.launches = {}

        def replay(self):
            graphs.copy_into(self.outputs, self.body())
            return self.outputs

    monkeypatch.setattr(graphs, "wanted", lambda graph, device, mesh=None: mesh is None and graph is not False)
    monkeypatch.setattr(graphs, "capture", lambda body, device, pool=None, generators=(): _BodyReplay(body))
    monkeypatch.setattr(graphs, "Pool", lambda device: None)
    graphs.reset_programs()


def _counted(monkeypatch) -> tuple:
    """Count record_function ranges by name and stamp writes."""
    ranges, stamps = [], []
    real_rf, real_stamp = torch.profiler.record_function, profiling.write_stamp

    def rf(name, *a, **k):
        ranges.append(name)
        return real_rf(name, *a, **k)

    def stamp(*a, **k):
        stamps.append(a[2])
        return real_stamp(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    monkeypatch.setattr(profiling, "write_stamp", stamp)
    return ranges, stamps


@pytest.mark.parametrize("path", list(PATHS))
def test_tracer_off_makes_one_range_and_no_stamp(seq, path, monkeypatch):
    """Off, a call opens FRAME_LOOP alone, writes no stamp, and returns no trace; its host clocks
    are filled."""
    cfg, kw = PATHS[path]
    ranges, stamps = _counted(monkeypatch)
    res = runner.run_sequence(seq, cfg, device="cpu", **kw)
    assert ranges == [runner.FRAME_LOOP] and stamps == []
    assert res.trace is None and res.capture_s > 0 and res.readback_s > 0


def _replays(path: str, n: int) -> list:
    if path == "grouped":
        return [tuple(range(i, min(i + 2, n))) for i in range(0, n - 1, 2)] + [(n - 1,)]
    return [(i,) for i in range(n)]


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_and_stamps_follow_the_stages(seq, path):
    """On, the spans nest as the runner opens them, each step's carrying its frame, and every replay
    has its stamps in the order of its stages, inside the replay's step span."""
    cfg, kw = PATHS[path]
    with profiling.tracing():
        tr = runner.run_sequence(seq, cfg, device="cpu", **kw).trace
    spans = tr.spans
    names = [s[0] for s in spans]
    top = [s[0] for s in spans if s[3] == -1]
    assert top == [runner.CAPTURE, runner.FRAME_LOOP, runner.READBACK]
    assert all(s[2] >= s[1] for s in spans)
    loop = names.index(runner.FRAME_LOOP)
    replays = _replays(path, len(seq))
    steps = tr.named(runner.STEP)
    assert [s[5]["frame"] for s in steps] == [r[0] for r in replays] == [s[5]["frame"] for s in tr.named(runner.FETCH)]
    for s in spans:
        if s[0] in (runner.FETCH, runner.STEP, runner.HOST_READ):
            assert s[3] == loop
        if s[0] == runner.HOST_COPY:
            assert spans[s[3]][0] == runner.HOST_READ and spans[s[3]][5] == s[5]
    reads = [s[5]["frame"] for s in tr.named(runner.HOST_READ)]
    assert reads == (list(range(len(seq))) if path == "non_deferred" else [])
    assert len(tr.named(runner.HOST_COPY)) == len(reads)

    assert tr.frames == replays
    assert tr.stages == [stage_columns(len(r)) for r in replays]
    assert tr.stamps.shape[0] == len(replays)
    for row, cols, step in zip(tr.stamps, tr.stages, steps):
        row = row[: len(cols)]
        gaps = np.diff(row)
        assert (gaps >= 0).all() and gaps.sum() == row[-1] - row[0]
        # The CPU runs a step's work inside its span; the map of a CPU stamp is the identity within
        # the anchors' bracket.
        slack = tr.clock["error_ns"] + 1000
        assert step[1] - slack <= row[0] and row[-1] <= step[2] + slack
    assert abs(tr.clock["scale"] - 1.0) < 1e-3


@pytest.mark.parametrize("mode", ["eager", "static"])
@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_are_bit_equal_with_the_tracer_on_and_off(seq, path, mode, request):
    cfg, kw = PATHS[path]
    if mode == "static":
        request.getfixturevalue("static")
    off = runner.run_sequence(seq, cfg, device="cpu", **kw)
    with profiling.tracing():
        on = runner.run_sequence(seq, cfg, device="cpu", **kw)
    assert off.trace is None and on.trace is not None and on.trace.stamps.shape[0] > 0
    for k in FIELDS:
        assert np.array_equal(getattr(on, k), getattr(off, k)), k


def test_span_times_match_the_kineto_events(seq):
    """Under torch.profiler a call is traced by itself, and each span's start and end, put on the
    profiler's clock, lie within 1 ms of the same range's Kineto event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the profiler's first range sets itself up
            pass
        res = runner.run_sequence(seq, _cfg(), device="cpu", n_frames=3)
    assert profiling._tracer is None  # the call's own tracer went off with the call
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in RUNNER_SPANS and ev.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    tr = res.trace
    assert {s[0] for s in tr.spans} == set(events) == {runner.CAPTURE, runner.FRAME_LOOP, runner.FETCH, runner.STEP,
                                                         runner.READBACK}
    for name, kineto in events.items():
        mine = sorted((tr.profiler_ns(s[1]), tr.profiler_ns(s[2])) for s in tr.named(name))
        assert len(mine) == len(kineto)
        for (a, b), (ka, kb) in zip(mine, sorted(kineto)):
            assert abs(a - ka) < 1_000_000 and abs(b - kb) < 1_000_000, (name, a - ka, b - kb)


def test_static_steps_count_in_programs(seq, static):
    """StaticStep counts its captures (one per shape per call), replays and capture seconds in
    graphs.PROGRAMS: the group step, and the single-frame step for the tail."""
    for call in (1, 2):
        runner.run_sequence(seq, _cfg(), device="cpu")
        p = graphs.PROGRAMS
        # Per call: the warm-up's replay of each, then two groups and the tail of 5 frames.
        assert (p["group_step"]["captures"], p["group_step"]["replays"]) == (call, 3 * call)
        assert (p["frame_step"]["captures"], p["frame_step"]["replays"]) == (call, 2 * call)
        assert p["group_step"]["capture_s"] > 0 and p["frame_step"]["capture_s"] > 0


def test_span_total_keeps_the_phase_seconds_on_and_off():
    """A span with ``total`` adds its seconds under the name's last part whether the tracer is on
    or off (the refiner's phase clocks); off it opens no range."""
    total = {}
    with profiling.span("vo_tpu_torch.refiner.copy", total=total):
        pass
    assert profiling.span("vo_tpu_torch.x") is profiling.NOOP and set(total) == {"copy"}
    with profiling.tracing() as t:
        with profiling.span("vo_tpu_torch.refiner.copy", total=total, frame=3):
            with profiling.span("vo_tpu_torch.inner"):
                pass
    assert set(total) == {"copy"} and total["copy"] > 0
    (outer, inner) = t.rows
    assert outer[0] == "vo_tpu_torch.refiner.copy" and outer[3] == -1 and outer[5] == dict(frame=3)
    assert inner[3] == 0 and outer[1] <= inner[1] <= inner[2] <= outer[2]


def test_refined_run_keeps_its_stats_and_spans_the_refiner(seq):
    """The refined path's phase clocks reach refine_stats on or off, and with the tracer on the
    worker's phases are spans of its own thread."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, keyframe_every=2, window=3))
    kw = dict(use_ba=True, use_loop_closure=True, device="cpu")
    off = runner.run_sequence(seq, cfg, **kw)
    with profiling.tracing():
        on = runner.run_sequence(seq, cfg, **kw)
    assert set(on.refine_stats) == set(off.refine_stats)
    assert {"main_wait_s", "worker_copy_s", "worker_ba_collect_s"} <= set(off.refine_stats)
    for k in FIELDS:
        assert np.array_equal(getattr(on, k), getattr(off, k)), k
    worker = [s for s in on.trace.spans if s[0].startswith("vo_tpu_torch.refiner.")]
    assert {s[0] for s in worker} >= {"vo_tpu_torch.refiner.copy", "vo_tpu_torch.refiner.ba_collect"}
    main = {s[4] for s in on.trace.named(runner.STEP)}
    assert {s[4] for s in worker if s[0] != "vo_tpu_torch.refiner.throttle"}.isdisjoint(main)


def test_device_offset_matches_stamp_kernels():
    """The raw stamps' offset to the profiler's device timeline, from the stamp kernels' starts there."""
    raw = np.array([[1000, 3000, 7000, -1]], np.int64)
    tr = profiling.Trace(anchor=(0, 5_000_000), spans=[], stamps=np.where(raw >= 0, raw + 20, -1), raw=raw)
    starts = raw[0, :3] + 20 + 5_000_000 - 150 + np.array([3, -2, 1])  # each kernel starts ~150 ns early
    assert tr.device_offset_ns(np.r_[starts, 5_000_000 + 50_000]) == 20 + 5_000_000 - 150 + 1
    assert tr.device_offset_ns([]) is None


# ---- the benchmark's readers (perfbench/metrics) on a made-up run ------------------------------


def _made_up_run(loop: str, traced: bool = True):
    """Two jobs of 3 frames; job 0 traced: the grouped step (frames 0-1, then 2) closed, the
    single-frame step open. Stamps in ns on perf_counter."""
    if loop == "closed":
        frames, stages = [(0, 1), (2,)], [stage_columns(2), stage_columns(1)]
        stamps = np.array([[100, 1100, 1400, 1700, 2000, 2600, 2700, 2800],  # detect 1000, match 300 + 300,
                           [3000, 3500, 3600, 3900, 4000, -1, -1, -1]])      # pose 300 + 600, map 100 + 100
    else:
        frames, stages = [(0,), (1,), (2,)], [stage_columns(1)] * 3
        stamps = np.array([[100, 600, 700, 1000, 1100], [2100, 2600, 2700, 3000, 3100], [4100, 4600, 4700, 5000, 5100]])
    spans = []
    for f, row in zip(frames, stamps):
        spans.append((runner.FETCH, row[0] - 500, row[0] - 40, 1, 1, dict(frame=f[0])))  # launch 40
        spans.append((runner.HOST_COPY, row[0] + 900, row[len(stage_columns(len(f))) - 1] + 60, 2, 1,
                      dict(frame=f[0])))  # readback 60
    tr = profiling.Trace(anchor=(0, 0), spans=spans, stamps=stamps, stages=stages, frames=frames) if traced else None
    job = lambda i, cap, t: types.SimpleNamespace(  # noqa: E731
        index=i, n_frames=3, result=types.SimpleNamespace(capture_s=cap, trace=t)
    )
    return types.SimpleNamespace(traffic=types.SimpleNamespace(loop=loop), jobs=[job(0, 0.9, tr), job(1, 0.5, None),
                                                                                 job(2, 0.3, None)])


# metric -> its value in ms on the made-up run of its loop
WANT = {
    "capture_ms_per_job.offline": 900.0,
    "detect_ms_per_frame.offline": (1000 + 500) / 1e6 / 3,
    "match_ms_per_frame.offline": (300 + 300 + 100) / 1e6 / 3,
    "pose_ms_per_frame.offline": (300 + 600 + 300) / 1e6 / 3,
    "map_ms_per_frame.offline": (100 + 100 + 100) / 1e6 / 3,
    "detect_ms_per_frame.live": 3 * 500 / 1e6 / 3,
    "match_ms_per_frame.live": 3 * 100 / 1e6 / 3,
    "pose_ms_per_frame.live": 3 * 300 / 1e6 / 3,
    "map_ms_per_frame.live": 3 * 100 / 1e6 / 3,
    "launch_ms_per_frame.live": 40 / 1e6,
    "readback_ms_per_frame.live": 60 / 1e6,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_made_up_run(name):
    from perfbench import harness

    read = harness.reader(name)
    loop = "open" if name.endswith(".live") else "closed"
    assert read(_made_up_run(loop)) == pytest.approx(WANT[name], rel=1e-12)
    assert read(_made_up_run(loop, traced=False)) is None
    assert read(_made_up_run("closed" if loop == "open" else "open")) is None
    # a program without the tracer: a RunResult with neither trace nor capture_s
    bare = _made_up_run(loop)
    for j in bare.jobs:
        j.result = types.SimpleNamespace()
    assert read(bare) is None


# ---- on the card: real capture -----------------------------------------------------------------


@pytest.mark.gpu
def test_graphed_stamps_on_the_card():
    """A graphed call with the stamps is bit-equal to one without; the graphs of the call without
    hold no stamp; the stamps are monotone within each replay, and the device -> perf_counter map
    is held to 50 us at its two anchors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    seq = runner.StagedSequence(
        p_syn.kitti_synthetic_sequence(n_frames=9, n_landmarks=1500, seed=7, image_size=(188, 620)), 9, device
    )
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=512, n_octaves=3), ransac=RansacConfig(n_hypotheses=128),
                         max_tracks=512)
    for kw in ({}, dict(progress=lambda i, s: None)):
        before = dict(profiling.STAMPS)
        off = runner.run_sequence(seq, cfg, device=device, **kw)
        assert profiling.STAMPS == before and off.trace is None
        with profiling.tracing():
            on = runner.run_sequence(seq, cfg, device=device, **kw)
        for k in FIELDS:
            assert np.array_equal(getattr(on, k), getattr(off, k)), k
        widths = {len(c) for c in on.trace.stages}
        captured = profiling.STAMPS["captured"] - before["captured"]
        assert captured == sum(widths), (captured, widths)  # one stamp node a column of each graph
        for row, cols in zip(on.trace.raw, on.trace.stages):
            assert (row[: len(cols)] > 0).all() and (np.diff(row[: len(cols)]) >= 0).all(), row
        assert on.trace.clock["error_ns"] < 50_000, on.trace.clock
        assert abs(on.trace.clock["scale"] - 1.0) < 1e-3, on.trace.clock
