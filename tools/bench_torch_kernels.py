"""Times K1 and K2, the front-end's hand-written kernels, over one detection call, for several builds side by side on one card.

    python tools/bench_torch_kernels.py [--subject NAME=PACKAGE_DIR[:CSRC_DIR] ...] [--rounds 3]

A subject is the package at PACKAGE_DIR (default this tree's ``vo_tpu_torch``),
loaded under a name of its own, whose kernels module (``frontend/kernels.py``)
builds the CUDA sources of CSRC_DIR (default PACKAGE_DIR/csrc). So one call
compares this tree with another commit unpacked beside it, of this layout or
of the older one where ``frontend/kernels.py`` built the library itself, or
with a variant of a source:

    git archive <commit> vo_tpu_torch | tar -x -C build/parent
    python tools/bench_torch_kernels.py --subject parent=build/parent/vo_tpu_torch --subject change=vo_tpu_torch

The input is the pyramid of chip_smoke.py's detection batch (the left and right
images of 2 rendered 376x1241 frames: 4 images, 4 octaves), built once by this
tree. Per subject, K1 and K2 do the detection call's work through the wrappers
that subject has: one launch over all octaves where it has
``extrema_scores_octaves`` / ``bin_maps_octaves``, else one launch per octave,
with the contiguous copy of the level slice that its ``bin_maps`` needs (the
copy is timed: the main path paid it). Each is held against this tree's plain
version (K1 must be exact, K2 within 1e-5) and timed two ways with CUDA events:
cold (a 1 GiB buffer is cleared before each call, the events are queued while
the clear runs; median of 25) and warm (20 calls back to back between one pair
of events; where the host is slower than the card this is the host's time per
call), and the host's time to enqueue one call (host clock over 200 calls, no
synchronise inside). Subjects take turns, forwards then backwards, ``--rounds``
times.
Prints the card's name and power limit and one line per subject and kernel;
the JSON goes to chiprun_out/bench_torch_kernels.json.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import back_to_back_ms, cold_ms  # noqa: E402
from vo_tpu_torch.config import PipelineConfig  # noqa: E402
from vo_tpu_torch.frontend import kernels as plain  # noqa: E402
from vo_tpu_torch.frontend.pyramid import build_pyramid  # noqa: E402
from vo_tpu_torch.io import synthetic  # noqa: E402
from vo_tpu_torch.odometry import runner  # noqa: E402


def load_subject(name: str, spec: str):
    """The kernels module of PACKAGE_DIR[:CSRC_DIR], from that package loaded as ``bench_pkg_<name>``."""
    pkg, _, csrc = spec.partition(":")
    pkg_name = f"bench_pkg_{name}"
    root = Path(pkg).resolve()
    pkg_spec = importlib.util.spec_from_file_location(pkg_name, root / "__init__.py", submodule_search_locations=[str(root)])
    sys.modules[pkg_name] = importlib.util.module_from_spec(pkg_spec)
    pkg_spec.loader.exec_module(sys.modules[pkg_name])
    mod = importlib.import_module(f"{pkg_name}.frontend.kernels")
    if csrc:  # the library's builder: utils/cuda_lib.py, or in the older layout the kernels module itself
        builder = mod if hasattr(mod, "_CSRC") else importlib.import_module(f"{pkg_name}.utils.cuda_lib")
        builder._CSRC = Path(csrc).resolve()
    return mod


def calls_of(mod, dogs, levels, thr):
    """(K1, K2) callables doing one detection call's work through ``mod``'s wrappers."""
    if hasattr(mod, "extrema_scores_octaves"):
        return (lambda: mod.extrema_scores_octaves(dogs, thr)), (lambda: mod.bin_maps_octaves(levels))

    def k2():
        return [mod.bin_maps(g.reshape(-1, *g.shape[2:]).contiguous()).reshape(*g.shape[:2], plain.NB, g.shape[2] // 2, g.shape[3] // 2) for g in levels]

    return (lambda: [mod.extrema_scores(d, thr) for d in dogs]), k2


def host_enqueue_us(fn, n: int = 200) -> float:
    """Host microseconds to enqueue one call (the device's queue drained before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--subject", action="append", default=[], help="NAME=PACKAGE_DIR[:CSRC_DIR]")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    subjects = dict(s.split("=", 1) for s in args.subject) or {"tree": str(ROOT / "vo_tpu_torch")}
    mods = {name: load_subject(name, spec) for name, spec in subjects.items()}

    cfg = PipelineConfig()
    s = cfg.sift
    seq = synthetic.kitti_synthetic_sequence(n_frames=cfg.fused_group, n_landmarks=6000, seed=0)
    feed = runner.StagedSequence(seq, cfg.fused_group, dev)
    imgs = torch.stack([im for i in range(cfg.fused_group) for im in feed.frame(i)]).float() / 255.0
    pyr = build_pyramid(imgs, s)
    dogs = pyr.dog[: s.n_octaves]
    levels = [G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss[: s.n_octaves]]
    want1 = [plain.extrema_scores_plain(d, s.contrast_threshold) for d in dogs]
    want2 = [plain.bin_maps_plain(g) for g in levels]

    results = {name: dict(spec=subjects[name], K1=dict(cold_ms=[], warm_ms=[], host_us=[]), K2=dict(cold_ms=[], warm_ms=[], host_us=[])) for name in mods}
    calls = {}
    for name, mod in mods.items():
        k1, k2 = calls[name] = calls_of(mod, dogs, levels, s.contrast_threshold)
        got1, got2 = k1(), k2()
        torch.cuda.synchronize()
        results[name]["K1"]["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(got1, want1))
        results[name]["K2"]["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(got2, want2))
        if results[name]["K1"]["max_abs_err"] != 0.0 or not results[name]["K2"]["max_abs_err"] <= 1e-5:
            raise AssertionError(f"{name}: kernels disagree with the plain versions: {results[name]}")
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    # Yardstick: a device copy that moves K1's bytes (half read, half written), timed the same way.
    k1_bytes = sum(4 * (d.numel() + w.numel()) for d, w in zip(dogs, want1))
    src = torch.empty(k1_bytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cold_ms(lambda: dst.copy_(src), flush)
    print(f"copy of {k1_bytes / 2e6:.1f} MB to {k1_bytes / 2e6:.1f} MB (K1's {k1_bytes / 1e6:.1f} MB of traffic): cold {copy_ms:.4f} ms")
    order = list(mods)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            for k, call in zip(("K1", "K2"), calls[name]):
                results[name][k]["cold_ms"].append(cold_ms(call, flush))
                results[name][k]["warm_ms"].append(back_to_back_ms(call))
                results[name][k]["host_us"].append(host_enqueue_us(call))
    for name, r in results.items():
        for k in ("K1", "K2"):
            r[k]["cold_ms_median"] = float(np.median(r[k]["cold_ms"]))
            r[k]["warm_ms_median"] = float(np.median(r[k]["warm_ms"]))
            r[k]["host_us_median"] = float(np.median(r[k]["host_us"]))
            print(
                f"{name:>12} {k}: cold {r[k]['cold_ms_median']:.4f} ms (runs {min(r[k]['cold_ms']):.4f}..{max(r[k]['cold_ms']):.4f}), "
                f"warm {r[k]['warm_ms_median']:.4f} ms (runs {min(r[k]['warm_ms']):.4f}..{max(r[k]['warm_ms']):.4f}), "
                f"host {r[k]['host_us_median']:.1f} us to enqueue, "
                f"max|kernel-plain| {r[k]['max_abs_err']:.3e}"
            )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_torch_kernels.json"), "w") as f:
        json.dump(dict(card=card, copy_of_k1_bytes_cold_ms=copy_ms, subjects=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
