"""One run of one cell: set-up, the measured window, the per-layer reading, the check, the line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``perfbench/workloads/<cell>.json``: a configuration (``configs/<name>.json``, the
program's ``PipelineConfig`` and, in ``run``, the options it passes to ``run_sequence``) under a
traffic mix (``traffic/<name>.json``, read by gen.traffic), and its check: the sample, the limits,
and in ``extra`` the checks of its own (``checks/<name>.py``, perfbench/check.py). The metrics the
run prints are the ones ``BENCHMARK.json`` lists for the cell; each is read by
``metrics/<name>.py`` (``read(run)``).

Set-up: the program's modules, the world (rendered into ``perfbench/.cache`` by a cell's first
run, memory-mapped by the others) staged on the card, and one short warm job with the window's
options, which builds the kernels and loads every module the window's jobs use. The window: a
closed loop runs its traffic's fixed set of jobs, indices ``0 .. jobs-1``, back to back, however
fast the program is, so every program meets the same logs, noise and RANSAC streams;
``--seconds`` only bounds it (no job starts once ``2 * --seconds`` have passed); an open loop
runs one job whose camera releases frame ``i`` at ``t0 + i * period``. A job is one
``vo_tpu_torch.odometry.runner.run_sequence`` call over one log, timed on the host from the call
to its return and a synchronise; its noisy feed is made and synchronised before its clock
starts. With ``--trace 1`` the window is job 0 alone, under ``torch.profiler`` (reducing its
trace outlasts the window). After the window: the card's peak memory, the import check, the
metrics, then the check against the plain reference (perfbench/check.py), and the line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .gen import traffic as traffic_mod
from .gen import world as world_mod
from .gen.traffic import HERE
from . import check as check_mod
from . import trace as trace_mod
from .arith import ate_errors

ROOT = os.path.dirname(HERE)
METRICS = os.path.join(HERE, "metrics")  # metrics/<name>.py: a metric's reader
CHECKS = os.path.join(HERE, "checks")  # checks/<name>.py: a check's own numbers (a workload's check.extra)
FORBIDDEN = ("jax", "jaxlib", "flax", "vo_tpu")  # top-level module names the run may not hold
# The run_sequence options a configuration's ``run`` may set; the harness owns seed, device,
# progress, graph and n_frames.
RUN_OPTIONS = ("use_ba", "use_loop_closure")
# runner.HISTORY_CHUNK (128) + 1, odd: the group step, the single-frame tail, and one full history
# chunk stacked (the rows are frames 1 ..), the fewest frames that run every step of a window job.
WARM_FRAMES = 129


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that ``cell`` reports."""
    pick = lambda ms: [m for m in ms if "workloads" not in m or cell in m["workloads"]]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def module(folder: str, name: str):
    """``<folder>/<name>.py``, loaded."""
    path = os.path.join(folder, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no file {os.path.relpath(path, ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{os.path.basename(folder)}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return module(METRICS, name).read


def run_options(config: dict) -> dict:
    """A configuration file's ``run`` object: the ``run_sequence`` options it sets (none: ``{}``)."""
    run = config.get("run", {})
    if not isinstance(run, dict):
        raise ValueError(f"configuration {config.get('name')!r}: run must be an object, not {type(run).__name__}")
    for k, v in run.items():
        if k not in RUN_OPTIONS:
            raise ValueError(f"configuration {config.get('name')!r}: run option {k!r} is not one of {RUN_OPTIONS}")
        if not isinstance(v, bool):
            raise ValueError(f"configuration {config.get('name')!r}: run option {k!r} must be true or false, not {v!r}")
    return dict(run)


def program_config(d: dict):
    """The program's ``PipelineConfig`` from a configuration file's ``pipeline`` object."""
    from vo_tpu_torch import config as pc

    sub = {f.name: f.type for f in dataclasses.fields(pc.PipelineConfig)}
    kw = {}
    for k, v in d.items():
        if isinstance(v, dict):
            cls = getattr(pc, sub[k]) if isinstance(sub[k], str) else sub[k]
            v = cls(**{kk: tuple(vv) if isinstance(vv, list) else vv for kk, vv in v.items()})
        kw[k] = v
    return pc.PipelineConfig(**kw)


@dataclasses.dataclass
class Job:
    index: int
    seed: int  # run_sequence(seed=)
    n_frames: int
    wall_s: float
    result: object  # the program's RunResult
    release_s: Optional[np.ndarray] = None  # open loop: when each frame was due
    done_s: Optional[np.ndarray] = None  # open loop: when its pose reached the progress callback
    late_s: float = 0.0  # open loop: the most a release came after it was due, by the generator's fault


@dataclasses.dataclass
class Run:
    """What a run hands to the metric readers and to the check."""

    seed: int
    config: dict
    traffic: object  # gen.traffic.Traffic
    world: object  # gen.world.World
    group: int  # frames per detection batch on the window's path
    jobs: list
    setup_s: float = 0.0
    trace: Optional[object] = None  # trace.Summary of the traced job


class Feed:
    """A job's log for ``run_sequence``: ``frame(i) -> (left, right)`` uint8 tensors on the card."""

    def __init__(self, frames: torch.Tensor, calib, gt_poses: np.ndarray):
        self.frames = frames
        self.calib = calib
        self.gt_poses = gt_poses

    def __len__(self) -> int:
        return self.frames.shape[0]

    def frame(self, i: int):
        return self.frames[i, 0], self.frames[i, 1]


class LiveFeed(Feed):
    """One camera: frame ``i`` is released at ``t0 + i * period`` whether or not the system is
    ready. The runner's warm-up fetch of frame 0, before its loop, is served at once; the camera's
    clock ``t0`` starts at the loop's first fetch. A fetch made before its frame is due sleeps
    until then."""

    def __init__(self, frames, calib, gt_poses, period: float):
        super().__init__(frames, calib, gt_poses)
        self.period = period
        self.t0 = None
        self.zero_fetches = 0
        n = len(self)
        self.release = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.late = 0.0

    def frame(self, i: int):
        now = time.perf_counter()
        if self.t0 is None:
            if i == 0:
                self.zero_fetches += 1
            if self.zero_fetches < 2:  # the warm-up's fetch
                return super().frame(i)
            self.t0 = now
        due = self.t0 + i * self.period
        if now < due:
            if due - now > 0.006:  # sleep, then spin the last 5 ms: a sleep can wake milliseconds late
                time.sleep(due - now - 0.005)
            while time.perf_counter() < due:
                pass
            self.late = max(self.late, time.perf_counter() - due)
        self.release[i] = due
        return super().frame(i)

    def progress(self, i: int, _stats: dict) -> None:
        self.done[i] = time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """A cell's files, loaded: configuration and its ``run`` options, traffic, world, the check's
    own modules (``extras``), and the program's entry. A ``run`` option or a set of check limits
    that does not fit is refused here, before any run."""

    def __init__(self, name: str, overrides: Optional[dict] = None):
        spec = load_json(HERE, "workloads", f"{name}.json")
        self.name = name
        self.config = load_json(HERE, "configs", f"{spec['config']}.json")
        self.traffic = traffic_mod.load(spec["traffic"])
        self.check = spec.get("check", {})
        if overrides:  # tests only: a small size on the CPU
            self.config = _merge(self.config, overrides.get("config", {}))
            self.traffic = dataclasses.replace(self.traffic, **overrides.get("traffic", {}))
            self.check = _merge(self.check, overrides.get("check", {}))
        self.run_options = run_options(self.config)
        self.extras = [module(CHECKS, n) for n in self.check.get("extra", [])]
        numbers = check_mod.numbers(self.extras)
        limits = set(self.check.get("limits", {}))
        if limits != set(numbers):
            raise ValueError(
                f"workload {name}: check limits {sorted(limits)} are not its numbers {sorted(numbers)}: "
                f"missing {sorted(set(numbers) - limits)}, spare {sorted(limits - set(numbers))}"
            )
        self.world = world_mod.World(self.config, self.traffic)

    def group(self) -> int:
        """Frames per detection call on the window's path, as the runner steps them: ``fused_group``
        frames on its deferred path, one where ``progress`` reads every pose (open loop) or where the
        refined path (``use_ba`` / ``use_loop_closure``) hands keyframes to its refiner. The
        program's ``runner.step_group`` decides where the program has one."""
        from vo_tpu_torch.odometry import runner

        cfg = program_config(self.config["pipeline"])
        deferred, refined = self.traffic.loop != "open", any(self.run_options.values())
        rule = getattr(runner, "step_group", None)
        if rule is not None:
            return rule(cfg, deferred=deferred, refined=refined, meshed=False)
        return cfg.fused_group if deferred and not refined else 1


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def measure(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device=None, workers: int = 8) -> Run:
    """Set-up and the window of one run -> Run (``device`` None: the current CUDA card)."""
    from vo_tpu_torch.geom.camera import calib_from_projections
    from vo_tpu_torch.odometry.runner import run_sequence

    t_import = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    torch.empty(1, device=device)  # the card's context
    sync(device)
    cfg = program_config(cell.config["pipeline"])
    t = cell.traffic
    w = cell.world
    calib = calib_from_projections(w.P1, w.P2, image_size=w.image_size, device="cpu")
    t_world = time.perf_counter()
    staged, rendered = w.stage(device, workers)
    if rendered:
        print(f"# rendered {t.poses} poses into {os.path.relpath(w.cache_path(), ROOT)}", file=sys.stderr, flush=True)
    live = t.loop == "open"
    n_log = len(w.log)

    def one_job(job: int, n: int, warm: bool = False) -> Job:
        x = world_mod.noisy_log(staged, w.log[:n], t.sensor_noise, seed, job)
        # What the previous job left is collected here, before the clock starts, not inside this job.
        gc.collect()
        sync(device)
        feed = LiveFeed(x, calib, w.gt_log[:n], t.period_s) if live and not warm else Feed(x, calib, w.gt_log[:n])
        js = world_mod.job_seed(seed, job)
        # The open loop reads each frame's pose through ``progress``: the non-deferred, frame-by-frame path.
        kw = dict(cell.run_options, progress=getattr(feed, "progress", lambda i, stats: None)) if live else dict(cell.run_options)
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace_mod.JOB_SPAN):
            res = run_sequence(feed, cfg, seed=js, device=device, **kw)
            sync(device)
        wall = time.perf_counter() - t0
        j = Job(index=job, seed=js, n_frames=n, wall_s=wall, result=res)
        if isinstance(feed, LiveFeed):
            j.release_s, j.done_s, j.late_s = feed.release, feed.done, feed.late
        del feed
        return j

    # The warm job: the window's options over WARM_FRAMES frames (a group step, the single-frame
    # tail, a full history chunk and its stacking), on a job index the window never uses.
    t_warm = time.perf_counter()
    one_job(2**31, min(WARM_FRAMES, t.frames_in(seconds) if live else n_log), warm=True)
    sync(device)
    run = Run(seed=seed, config=cell.config, traffic=t, world=w, group=cell.group(), jobs=[])
    run.setup_s = time.perf_counter() - t_start
    print(f"# setup: {t_import - t_start:.3f} s start and imports, {t_world - t_import:.3f} s the card's context, "
          f"{t_warm - t_world:.3f} s to load and stage the world, {run.setup_s - (t_warm - t_start):.3f} s the warm job",
          file=sys.stderr, flush=True)

    n = t.frames_in(seconds) if live else n_log
    w0 = time.perf_counter()
    for job in range(1 if live or trace else t.jobs):
        if job > 0 and time.perf_counter() - w0 >= 2 * seconds:
            print(f"# window cut: jobs {job}..{t.jobs - 1} not started, {2 * seconds:g} s have passed", file=sys.stderr, flush=True)
            break
        if trace:
            prof = trace_mod.start(device)
            run.jobs.append(one_job(job, n))
            t_red = time.perf_counter()
            tr = run.trace = trace_mod.stop(prof, device)
            print(f"# trace: {len(tr.dev_s)} device intervals, reduced in {time.perf_counter() - t_red:.3f} s, "
                  f"{int(tr.launched_in(trace_mod.FRAME_LOOP).sum())} of them launched in the frame loop",
                  file=sys.stderr, flush=True)
        else:
            run.jobs.append(one_job(job, n))
    return run


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them ("unknown" where it gives none)."""
    import subprocess

    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=20
        )
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metrics_of(cell: Cell, run: Run, bench: dict, trace: bool) -> dict:
    """{name: {value, unit}} of the metrics BENCHMARK.json lists for the cell: its end-to-end ones,
    or with ``--trace 1`` its per-layer ones. A reader that finds nothing to read is left out."""
    e2e, per_layer = cell_metrics(bench, cell.name)
    out = {}
    for m in per_layer if trace else e2e:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, chips: int = 1, device=None,
             overrides: Optional[dict] = None, workers: int = 8) -> tuple[int, Optional[dict]]:
    """Everything after the look for a card -> (exit code, the result line's object or None)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(name, overrides)
    run = measure(cell, seed, seconds, trace, t_start, device=device, workers=workers)
    dev = torch.device(device) if device is not None else torch.device("cuda", torch.cuda.current_device())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        print(f"perfbench: after the window the process holds {found}", file=sys.stderr)
        return 4, None
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_json = dict(platform="gpu" if dev.type == "cuda" else "cpu", kind=kind, count=chips, memory_peak_bytes=int(peak))
    if trace and run.trace is not None:
        device_json.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    metrics = metrics_of(cell, run, bench, trace)
    attempted = sum(j.n_frames for j in run.jobs)
    fails = {j.index: int(np.sum(~np.asarray(j.result.pose_ok, bool))) for j in run.jobs}
    failed = sum(fails.values())
    lat = [j for j in run.jobs if j.release_s is not None]
    print(f"# card: {power_limit() if dev.type == 'cuda' else 'cpu'}; {len(run.jobs)} job(s), {attempted} frames, "
          f"frames with pose_ok false by job {fails}, "
          f"job walls {[round(j.wall_s, 4) for j in run.jobs]} s, frame loops "
          f"{[round(j.result.per_frame_ms * j.n_frames / 1000, 4) for j in run.jobs]} s, setup {run.setup_s:.4f} s"
          + (f"; {int(np.isfinite(lat[0].done_s).sum())} latency samples, generator late by at most "
             f"{1000 * lat[0].late_s:.3f} ms, latency ms p50/p90/p95/p99/max "
             f"{np.round(np.percentile(1000 * (lat[0].done_s - lat[0].release_s), [50, 90, 95, 99, 100]), 3).tolist()}"
             if lat else ""), file=sys.stderr, flush=True)
    errs = np.concatenate([ate_errors(j.result.poses, run.world.gt_log[: j.n_frames]) for j in run.jobs])
    print(f"# ATE rmse pooled over the jobs {float(np.sqrt(np.mean(errs ** 2))):.6f} m (not a metric: it swings "
          "by tens of metres from seed to seed)", file=sys.stderr)
    # The program's state is host arrays by now; the reference runs on the card after it.
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check_mod.run_check(cell, run, dev)
    print(f"# check: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    out = dict(correct=bool(checks["correct"]), attempted=attempted, failed=failed, metrics=metrics, device=device_json)
    if trace and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: dict(value=c["value"], limit=c["limit"]) for k, c in checks["numbers"].items()}
    for k, c in checks["numbers"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr, flush=True)
    return 0, out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"perfbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); found {n}", file=sys.stderr)
        return 3
    try:
        import vo_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"perfbench: the program is not here: {e}", file=sys.stderr)
        return 2
    code, out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start, chips=chips)
    if out is not None:
        print(json.dumps(out), flush=True)
    return code
