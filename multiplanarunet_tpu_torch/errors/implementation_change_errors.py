"""Errors signalling API semantic changes (as
`multiplanarunet_tpu/errors/implementation_change_errors.py`)."""


class NotSparseError(Exception):
    """Raised when a dense/one-hot target is passed where sparse integer
    targets are required."""
