"""Per-channel volume normalization (numpy)."""
