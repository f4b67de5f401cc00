"""Per-frame VO step, landmark store and the sequence runner."""
