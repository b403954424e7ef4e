"""Fused multi-view inference."""
