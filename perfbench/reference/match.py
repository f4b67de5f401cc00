"""Frozen copy of vo_tpu_torch/frontend/match.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Descriptor matching as one distance matrix + masked reductions (port of vo_tpu.frontend.match).

Replaces the five MATLAB ``matchFeatures`` calls per frame: SSD metric, an
absolute threshold as a percent of the maximum distance, Lowe's ratio test,
and the mutual cross-check. Matches are fixed-capacity index arrays + masks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MatcherConfig
from .padding import compact_indices

# Max possible SSD between two L2-normalized nonnegative SIFT descriptors.
_MAX_SSD = 2.0
_BIG = 1e30


class Matches(NamedTuple):
    """Compacted match pairs between set A and set B (fixed capacity)."""

    a_idx: torch.Tensor  # [C] row index into A
    b_idx: torch.Tensor  # [C] row index into B
    mask: torch.Tensor  # [C] bool
    dist: torch.Tensor  # [C] SSD of the accepted pair


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[Na, Nb] SSD distances ||a||^2 + ||b||^2 - 2 a.b; the cross term is one matmul."""
    na2 = torch.sum(desc_a * desc_a, dim=-1, keepdim=True)
    nb2 = torch.sum(desc_b * desc_b, dim=-1, keepdim=True)
    cross = desc_a @ desc_b.T
    return torch.clamp(na2 + nb2.T - 2.0 * cross, min=0.0)


def _top2_min(D: torch.Tensor):
    """Per-row smallest value, its (first) argmin, and the second smallest value."""
    d1, j1 = torch.min(D, dim=1)
    D2 = D.scatter(1, j1[:, None], _BIG)
    d2 = torch.min(D2, dim=1).values
    return d1, j1, d2


def match(
    desc_a: torch.Tensor,
    mask_a: torch.Tensor,
    desc_b: torch.Tensor,
    mask_b: torch.Tensor,
    cfg: MatcherConfig,
    capacity: int | None = None,
) -> Matches:
    """Match rows of A (the query side) to rows of B.

    Per row: nearest + second-nearest distance -> absolute threshold -> Lowe
    ratio -> optional mutual cross-check. Output compacted to ``capacity``
    (default len(A)) pairs in stable order.
    """
    if capacity is None:
        capacity = desc_a.shape[0]
    D = distance_matrix(desc_a, desc_b)
    D = torch.where(mask_a[:, None] & mask_b[None, :], D, _BIG)
    d1, j1, d2 = _top2_min(D)
    thr = (cfg.match_threshold / 100.0) * _MAX_SSD
    ok = (d1 <= thr) & mask_a
    ok &= d1 <= cfg.max_ratio * d2
    if cfg.mutual:
        i1_col = torch.argmin(D, dim=0)  # best A row for each B column
        ok &= i1_col[j1] == torch.arange(desc_a.shape[0], device=D.device)
    perm, out_mask = compact_indices(ok)
    zero = torch.zeros_like(perm)
    return Matches(
        a_idx=torch.where(out_mask, perm, zero)[:capacity],
        b_idx=torch.where(out_mask, j1[perm], zero)[:capacity],
        mask=out_mask[:capacity],
        dist=torch.where(out_mask, d1[perm], 0.0)[:capacity],
    )
