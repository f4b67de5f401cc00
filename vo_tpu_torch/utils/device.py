"""The device an entry point runs on when its caller names none (the CUDA card), and waiting for it."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises where there is none (the port never carries on on the CPU unasked)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'vo_tpu_torch runs on a CUDA device by default and torch.cuda.is_available() is False: '
            'pass `device="cpu"` to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """``device`` as a torch.device; None means default_device()."""
    return default_device() if device is None else torch.device(device)


def sync(device) -> None:
    """Wait for ``device``'s work: a no-op on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
