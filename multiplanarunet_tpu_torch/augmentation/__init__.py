"""Batch augmenters applied on the device."""
