"""Shear resampling: numpy planner, CUDA pass kernel, torch executor."""
