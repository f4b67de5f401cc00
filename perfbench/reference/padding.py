"""Frozen copy of vo_tpu_torch/utils/padding.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Fixed-capacity buffers with validity masks (port of vo_tpu.utils.padding).

Every feature set is a fixed-capacity tensor plus a bool mask, and filtering
is stable compaction of indices. Nothing here reads a value back to the host,
so the per-frame loop never waits on the device, and the static shapes are
what a later CUDA-graph capture of the step needs.
"""
from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable front-compaction of a [N] bool mask -> (perm, out_mask).

    Gathering any aligned array with ``perm`` moves the valid rows to the
    front in order; ``out_mask`` marks the first count(mask) slots valid.
    """
    n = mask.shape[0]
    pos = torch.arange(n, device=mask.device)
    key = torch.where(mask, pos, pos + n)  # invalid rows to the back
    perm = torch.argsort(key, stable=True)
    out_mask = pos < mask.sum()
    return perm, out_mask


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x at integer indices of any shape -> [*idx.shape, *x.shape[1:]] (no host sync)."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def gather_rows(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None = None, fill=0):
    """Gather rows of x by idx (clamped into range, like ``mode="clip"``); rows where mask is False get ``fill``."""
    out = take(x, idx.clamp(0, x.shape[0] - 1))
    if mask is not None:
        out = torch.where(mask.reshape((mask.shape[0],) + (1,) * (out.ndim - 1)), out, fill)
    return out


def pad_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """Pad/truncate the leading axis to exactly n rows."""
    cur = x.shape[0]
    if cur == n:
        return x
    if cur > n:
        return x[:n]
    pad = x.new_full((n - cur,) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad], dim=0)


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """top-k over masked scores. Invalid entries score the dtype's minimum. Returns (vals, idx, valid)."""
    neg = torch.finfo(scores.dtype).min
    vals, idx = torch.topk(torch.where(mask, scores, neg), k)
    return vals, idx, vals > neg
