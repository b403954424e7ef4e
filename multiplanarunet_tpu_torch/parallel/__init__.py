"""Device-side data structures shared by the samplers."""
