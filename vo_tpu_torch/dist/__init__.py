"""The device mesh: sharded RANSAC, window BA, pose graph and detection on torch.distributed."""
