"""The plain reference of the refiner's corrections: its keyframe ledger, and re-anchoring the frame
loop's rows onto corrected keyframes. In float64.

**The ledger** (``ledger``). The refiner keeps a corrected pose for every keyframe, replayed here
from its records in the order it applied them:

- a keyframe enters at its step row, moved by the worker's frame D (the identity at first): its
  corrected pose and its chain pose (the loop-corrected pose without window corrections) are both
  D P_k;
- a window solve that passes the gates (``window_ba.gate``; a solve whose last keyframe has left
  the window is stale) sets the corrected poses of its window's keyframes to its results;
- an accepted pose-graph solve moves every keyframe: with S_j a graph node's new pose and C_j its
  chain pose, node j's delta is S_j C_j^-1; a keyframe that is a node takes its own delta, any other
  the delta of the node nearest it by frame index; its corrected pose is left-multiplied by the
  delta (so a window correction rides through the closure), and its chain pose becomes S_j or the
  delta times it; D becomes K_t P_t'^-1 D, with t the newest keyframe, K_t its corrected pose and
  P_t' the pose it entered with.

**Re-anchoring** (``reanchor``). After the refiner has corrected its keyframes, every other frame
keeps its pose relative to the last keyframe at or before it: with P_k the keyframe's pose as the
frame loop chained it and K_k its corrected pose, a row t after keyframe row k becomes K_k P_k^-1 P_t
(so row k itself becomes K_k). Rows before the first keyframe stay as they were.
"""
from __future__ import annotations

import numpy as np
import torch

from .window_ba import gate


def ledger(step_poses, order, windows, graphs, ba_cfg) -> tuple[np.ndarray, torch.Tensor]:
    """(keyframe frame indices [K], corrected poses [K, 4, 4] float64 on the CPU): the ledger after
    ``order`` [(kind, i)]: ("keyframe", frame index f, whose step row is ``step_poses[f - 1]``),
    ("window", i) for ``windows[i]`` = (window frame indices [n], the last keyframe's pose before the
    solve [4, 4], the solved poses [>= n, 4, 4], cost0, cost), ("graph", i) for ``graphs[i]`` =
    (node frame indices [n], the solved node poses [n, 4, 4], or None where the solve was rejected).
    ``ba_cfg``: ``BAConfig`` (the window's size and the gates)."""
    f64 = dict(dtype=torch.float64)
    S = torch.as_tensor(np.asarray(step_poses), **f64)
    D = torch.eye(4, **f64)
    corrected, chain, entered, kfs = {}, {}, {}, []
    for kind, i in order:
        if kind == "keyframe":
            P = D @ S[int(i) - 1]
            corrected[i] = chain[i] = entered[i] = P
            kfs.append(int(i))
        elif kind == "window":
            fi, T_before, T, cost0, cost = windows[i]
            n = len(fi)
            # The window as the newest ba_cfg.window keyframes entered; at a collect the program's
            # window lacks the keyframe just entered, which differs only for a solve that old, and a
            # solve is collected two keyframes after it was dispatched.
            if int(fi[-1]) not in kfs[-ba_cfg.window:]:
                continue
            T = torch.as_tensor(np.asarray(T)[:n], **f64)
            if gate(T_before, T[n - 1], cost0, cost, ba_cfg) == "accepted":
                for k, f in enumerate(fi):
                    corrected[int(f)] = T[k]
        elif kind == "graph":
            fi, T = graphs[i]
            if T is None:
                continue
            T = torch.as_tensor(np.asarray(T), **f64)
            new = {int(f): T[k] for k, f in enumerate(fi)}
            delta = {f: new[f] @ torch.linalg.inv(chain[f]) for f in new if f in chain}
            if not delta:
                continue
            nodes = np.asarray(sorted(delta), np.int64)
            for f in kfs:
                # The node nearest by frame index, the earlier on a tie (as the program chooses).
                d = delta[f] if f in new else delta[int(nodes[np.argmin(np.abs(nodes - f))])]
                corrected[f] = d @ corrected[f]
                chain[f] = new[f] if f in new else d @ chain[f]
            D = corrected[kfs[-1]] @ torch.linalg.inv(entered[kfs[-1]]) @ D
    poses = torch.stack([corrected[f] for f in kfs]) if kfs else torch.zeros((0, 4, 4), **f64)
    return np.asarray(kfs, np.int64), poses


def reanchor(step_poses, kf_rows, kf_poses, device) -> torch.Tensor:
    """[T, 4, 4] float64: ``step_poses`` [T, 4, 4] re-anchored onto ``kf_poses`` [K, 4, 4] at rows
    ``kf_rows`` [K] (any order; rows outside 0 .. T-1 are left out)."""
    P = torch.as_tensor(np.asarray(step_poses), dtype=torch.float64, device=device)
    rows = np.asarray(kf_rows, np.int64)
    Kp = np.asarray(kf_poses, np.float64)
    keep = (rows >= 0) & (rows < P.shape[0])
    rows, Kp = rows[keep], Kp[keep]
    out = P.clone()
    if rows.size == 0:
        return out
    order = np.argsort(rows, kind="stable")
    rows, Kp = rows[order], torch.as_tensor(Kp[order], device=device)
    for n, k in enumerate(rows):
        end = int(rows[n + 1]) if n + 1 < len(rows) else P.shape[0]
        out[k:end] = Kp[n] @ torch.linalg.inv(P[k]) @ P[k:end]
    return out
