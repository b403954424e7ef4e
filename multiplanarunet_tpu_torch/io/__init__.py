"""NIfTI-1 volume IO (numpy only)."""
