"""P3P minimal solver and RANSAC world-pose estimation."""
