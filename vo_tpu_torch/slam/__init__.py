"""Loop closure over the keyframe archive."""
