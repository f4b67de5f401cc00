"""KITTI parsers and the synthetic KITTI-geometry renderer."""
