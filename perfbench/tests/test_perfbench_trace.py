"""The reduction of a traced window, on a made-up timeline."""
import numpy as np
import pytest
import torch

from perfbench import arith, trace


class Ev:
    def __init__(self, name, start, end, cuda=False, corr=0):
        self._n, self._s, self._e, self._c, self._corr = name, start, end, cuda, corr

    def correlation_id(self):
        return self._corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def timeline():
    return [
        Ev(trace.JOB_SPAN, 0, 1000),
        Ev(trace.FRAME_LOOP, 90, 900),
        Ev("cudaGraphLaunch", 100, 260, corr=1),
        Ev("aten::clone", 500, 640),
        Ev("cudaGraphLaunch", 850, 870, corr=2),  # inside the loop; its work runs after the span
        Ev("cudaLaunchKernel", 940, 945, corr=3),
        Ev(trace.FRAME_LOOP, 210, 880, cuda=True),  # the span's device-side mirror: no device work
        Ev("(anonymous namespace)::extrema_scores_kernel((anonymous namespace)::Octaves, int, float, int)", 250, 300, cuda=True, corr=1),
        Ev("gemm", 280, 400, cuda=True, corr=1),
        Ev("gemm", 350, 450, cuda=True, corr=1),  # overlaps the one before (another stream)
        Ev("not_extrema_scores_kernel(int)", 460, 470, cuda=True, corr=1),
        Ev("Memcpy HtoD", 700, 800, cuda=True),
        Ev("extrema_scores_kernel(Octaves, int, float, int)", 905, 925, cuda=True, corr=2),
        Ev("extrema_scores_kernel(Octaves, int, float, int)", 950, 990, cuda=True, corr=3),  # launched after
    ]


def test_busy_is_the_union_and_mirrors_are_left_out():
    s = trace.Summary(timeline())
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((450 - 250 + 10 + 100 + 20 + 40) * 1e-9)
    assert s.busy_ns(200, 900) == 310
    assert s.busy_launched_ns(trace.FRAME_LOOP) == 200 + 10 + 100 + 20  # the copy has no launch: its own start
    assert list(s.kernel_ns("extrema_scores_kernel", trace.FRAME_LOOP)) == [50, 20]


def test_breakdown_names_gaps_by_the_host_op():
    b = trace.Summary(timeline()).breakdown()
    ops = dict(b["device_ops"])
    assert ops["gemm"] == pytest.approx(220e-9)
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(250e-9 + 105e-9)  # 0-250 and 800-905: launches run at 125, 852
    assert gaps["aten::clone"] == pytest.approx(230e-9)  # 470-700: the clone runs at 585
    assert gaps["no host op"] == pytest.approx(10e-9 + 25e-9 + 10e-9)  # 450-460, 925-950, 990-1000
    assert sum(gaps.values()) == pytest.approx(1000e-9 - 370e-9)


def test_roofline_counts_one_launch_per_detection_call():
    s = trace.Summary(timeline())
    run = type("R", (), dict(trace=s, group=1, jobs=[type("J", (), dict(n_frames=1))()],
                             config=dict(pipeline=dict(sift=dict(scales_per_octave=3, n_octaves=4))),
                             world=type("W", (), dict(image_size=(376, 1241)))()))()
    run.jobs[0].n_frames = 2
    want = 200 * arith.k1_bytes(dict(scales_per_octave=3, n_octaves=4), (376, 1241), 2) / arith.HBM_BYTES_PER_S / 70e-9
    assert arith.roofline(run, "extrema_scores_kernel", arith.k1_bytes) == pytest.approx(want)
    run.jobs[0].n_frames = 3  # three calls expected, two launches found: nothing
    assert arith.roofline(run, "extrema_scores_kernel", arith.k1_bytes) is None
