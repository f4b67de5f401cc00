"""Figures of a run (matplotlib; import ``figures`` where they are drawn)."""
