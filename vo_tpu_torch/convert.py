"""numpy <-> port conversion of the state the VO step carries.

The port and the JAX reference keep the same fields under the same names, so
identical state can be put into both packages: ``to_numpy`` turns any port
NamedTuple (or a reference one) into the same structure of numpy arrays, and
the ``*_from_numpy`` functions take any object with the right field names
holding array-likes (numpy, or the reference's jax arrays, which numpy reads
without this module importing jax). Each takes the ``device`` its tensors go
to: None is the current CUDA device (``utils.device.default_device``), and the
CPU only when asked. ``config_from_reference`` copies a configuration of the
reference's classes into the port's own, field by field.

A VO engine carries no weights; what crosses between the packages is state:
the VO step's, a window-BA problem, and the refiner's keyframes (window and
loop-closure archive), so that both packages get identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .ba.window import BAProblem
from .frontend.sift import Features
from .frontend.track import StereoFeatures
from .geom.camera import StereoCalib, calib_from_projections
from .odometry.landmarks import LandmarkMap
from .odometry.pipeline import VOState
from .utils.device import resolve
from .utils.host_copy import upload


def to_numpy(x):
    """Tensors/arrays -> numpy, recursively through NamedTuples (kept as their own type),
    tuples, lists and dicts.

    A ``torch.Generator`` (VOState.gen) becomes None: the sample stream does
    not cross between the packages.
    """
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, torch.Generator) or x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (int, float, bool, str)):
        return x
    return np.asarray(x)


def config_from_reference(cfg):
    """The port's configuration class of the same name as ``type(cfg)``, with ``cfg``'s values.

    ``cfg`` is any object with that class's attributes (the reference's config);
    nested configurations are copied the same way, and a missing attribute raises.
    """
    cls = getattr(_config, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        kw[f.name] = config_from_reference(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=resolve(device))


def calib_from_numpy(c, device=None) -> StereoCalib:
    """StereoCalib from an object with P1, P2 and image_size."""
    return calib_from_projections(np.asarray(c.P1), np.asarray(c.P2), image_size=tuple(c.image_size), device=device)


def features_from_numpy(f, device=None) -> Features:
    return Features(
        xy=_t(f.xy, device, np.float32),
        scale=_t(f.scale, device, np.float32),
        orientation=_t(f.orientation, device, np.float32),
        response=_t(f.response, device, np.float32),
        desc=_t(f.desc, device, np.float32),
        mask=_t(f.mask, device, bool),
    )


def stereo_features_from_numpy(s, device=None) -> StereoFeatures:
    return StereoFeatures(
        l_xy=_t(s.l_xy, device, np.float32),
        r_xy=_t(s.r_xy, device, np.float32),
        l_desc=_t(s.l_desc, device, np.float32),
        r_desc=_t(s.r_desc, device, np.float32),
        mask=_t(s.mask, device, bool),
        ids=_t(s.ids, device, np.int32),
    )


def state_from_numpy(s, device=None, seed: int = 0) -> VOState:
    """VOState from an object with prev, pose_c2w, prev_rel, frame_idx, next_id; a fresh generator from ``seed``."""
    device = resolve(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VOState(
        prev=stereo_features_from_numpy(s.prev, device),
        pose_c2w=_t(s.pose_c2w, device, np.float32),
        prev_rel=_t(s.prev_rel, device, np.float32),
        frame_idx=_t(s.frame_idx, device, np.int64),
        next_id=_t(s.next_id, device, np.int32),
        gen=gen,
    )


def lmap_from_numpy(m, device=None) -> LandmarkMap:
    return LandmarkMap(
        xyz=_t(m.xyz, device, np.float32),
        count=_t(m.count, device, np.int64),
        dropped=_t(m.dropped, device, np.int64),
    )


def ba_problem_from_numpy(p, device=None) -> BAProblem:
    """BAProblem from a dict or an object with BAProblem's field names: float32 values, bool masks
    (uploaded without waiting, utils.host_copy.upload)."""
    device = resolve(device)
    get = p.get if isinstance(p, dict) else (lambda k: getattr(p, k))
    out = {}
    for k in BAProblem._fields:
        a = np.asarray(get(k))
        t = torch.from_numpy(np.ascontiguousarray(a, bool if a.dtype == bool else np.float32))
        out[k] = upload(t, device)
    return BAProblem(**out)


def keyframe_from_numpy(kf):
    """The port's window-BA Keyframe from an object with its fields (e.g. the reference's)."""
    from .odometry.ba_runner import Keyframe

    return Keyframe(
        frame_idx=int(kf.frame_idx),
        pose_c2w=np.array(kf.pose_c2w, np.float32),
        ids=np.array(kf.ids),
        l_px=np.array(kf.l_px, np.float32),
        r_px=np.array(kf.r_px, np.float32),
        mask=np.array(kf.mask, bool),
    )


def archived_keyframe_from_numpy(kf, device=None):
    """The port's loop-closure ArchivedKeyframe from an object with its fields (e.g. the
    reference's); its device refs (``dev``) are uploaded to ``device``."""
    from .slam.loop_closure import ArchivedKeyframe

    host = [np.array(getattr(kf, k), dt) for k, dt in (("l_px", np.float32), ("r_px", np.float32),
                                                         ("l_desc", np.float32), ("mask", bool))]
    gd = getattr(kf, "global_desc", None)
    return ArchivedKeyframe(
        frame_idx=int(kf.frame_idx),
        pose_c2w=np.array(kf.pose_c2w, np.float32),
        l_px=host[0],
        r_px=host[1],
        l_desc=host[2],
        mask=host[3],
        global_desc=None if gd is None else np.array(gd, np.float32),
        path_m=float(getattr(kf, "path_m", 0.0)),
        dev=tuple(torch.from_numpy(h).to(resolve(device)) for h in host),
    )
