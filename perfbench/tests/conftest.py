"""Shared fixtures of the benchmark's tests: ``cuda`` decides inside the test whether there is a card."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# A cell at a size the CPU runs in seconds: 94x311 images, 256 keypoints, an 11-frame log.
SMALL = dict(
    config=dict(sequence=dict(image_size=[94, 311]), pipeline=dict(sift=dict(max_keypoints=256), max_tracks=256, ransac=dict(n_hypotheses=64))),
    traffic=dict(poses=6, landmarks_per_pose=60),
    check=dict(samples=8),
)
