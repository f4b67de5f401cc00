"""Sliding-window bundle adjustment and the host pose-graph solve."""
