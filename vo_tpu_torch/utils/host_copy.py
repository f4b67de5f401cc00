"""Copies between host and device that the calling thread does not wait for.

Device -> host (``HostCopy``, the reference's ``copy_to_host_async``): on a
CUDA tensor the copy goes ``non_blocking`` into pinned host memory on the
current stream, and a CUDA event is recorded right after it. ``numpy()``
waits on that event before the buffers are read: a non-blocking copy read
without it gives stale data and no error. On the CPU the tensors are cloned
at construction: the copy holds the values they had then, as a CUDA copy
holds the values they had at that point of the stream, whatever later writes
them (a CUDA graph's static outputs are overwritten by its next replay).

Host -> device (``upload``): a copy from pageable host memory synchronises
the stream (the host waits until the device has drained its queue), so a
CUDA upload goes through pinned memory, ``non_blocking``.
"""
from __future__ import annotations

import numpy as np
import torch


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor ``t`` on ``device``, queued on the current stream without waiting."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Started at construction; ``numpy()`` blocks the calling thread until the copies have landed."""

    __slots__ = ("_host", "_event")

    def __init__(self, *tensors: torch.Tensor):
        cuda = [t.device.type == "cuda" for t in tensors]
        if not any(cuda):
            self._host, self._event = tuple(t.clone() for t in tensors), None
            return
        if not all(cuda):
            raise ValueError("HostCopy: tensors on more than one kind of device")
        self._host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True) for t in tensors
        )
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensors[0].device))

    @property
    def event(self):
        """The CUDA event recorded after the copies (None on the CPU): another stream that
        waits on it sees every value the copied tensors had."""
        return self._event

    def numpy(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]
