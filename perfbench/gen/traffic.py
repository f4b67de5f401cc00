"""The one traffic generator: a mix is a data file ``perfbench/traffic/<name>.json`` that this
module reads. It fixes the log (which GT poses are rendered, and the order in which a job's
frames visit them), the world the renderer draws (landmarks per pose, render noise, world
seed), the sensor noise that ``--seed`` draws on the card, and the arrivals: a closed loop
(jobs back to back) or an open loop (one camera releasing frame ``i`` at ``t0 + i * period_s``).

Routes:
- ``out_and_back``: GT poses ``0 .. poses-1`` out, ``poses-2 .. 0`` back (``2 * poses - 1``
  frames); the way back shows the renderer's frames of the way out again.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("out_and_back",)
LOOPS = ("closed", "open")


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    loop: str  # "closed" | "open"
    route: str  # ROUTES
    poses: int  # GT poses rendered: 0 .. poses-1
    landmarks_per_pose: int
    render_noise: float  # Gaussian noise of the renderer, [0, 1] units, drawn from the world seed
    world_seed: int
    sensor_noise: float  # Gaussian noise drawn from --seed on the card, [0, 1] units
    period_s: float = 0.0  # open loop: the camera's frame period

    @property
    def n_landmarks(self) -> int:
        return self.poses * self.landmarks_per_pose

    def log(self) -> np.ndarray:
        """[frames] index of the rendered pose each frame of a job shows."""
        out = np.arange(self.poses)
        return np.concatenate([out, out[-2::-1]])  # out_and_back

    def frames_in(self, seconds: float) -> int:
        """Frames of the open loop's one job: what the camera releases in ``seconds``, at most the log."""
        return min(len(self.log()), int(math.floor(seconds / self.period_s)))


def load(name: str, root: str = HERE) -> Traffic:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        d = json.load(f)
    d.pop("why", None)
    t = Traffic(name=name, **d)
    if t.loop not in LOOPS or t.route not in ROUTES:
        raise ValueError(f"traffic {name}: loop {t.loop!r} not in {LOOPS} or route {t.route!r} not in {ROUTES}")
    if t.loop == "open" and not t.period_s > 0:
        raise ValueError(f"traffic {name}: an open loop needs period_s > 0")
    return t
