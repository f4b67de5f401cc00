"""SE(3), stereo calibration, rectified triangulation."""
