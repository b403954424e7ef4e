"""Per-image volume staging."""
