"""The device a function runs on when its caller names none (frozen copy of vo_tpu_torch/utils/device.py)."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass `device="cpu"`')
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
