"""Fixed-capacity padding and masking helpers."""
