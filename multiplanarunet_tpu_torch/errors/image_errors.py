"""Image-layer exceptions (as `multiplanarunet_tpu/errors/image_errors.py`)."""


class NoLabelFileError(Exception):
    """Raised when an operation requires labels but none were loaded."""


class ReadOnlyAttributeError(AttributeError):
    """Raised when assigning to a read-only ImagePair attribute."""
