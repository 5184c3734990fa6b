"""Exception hierarchy, mirroring ``stainlib/utils/excepts.py:5-23``.

Port of the JAX package's ``exceptions.py``; a copy rather than an import,
because importing the JAX package pulls in jax.
"""


class DigitalPathologyError(Exception):
    """Root of the library's error hierarchy."""


class DigitalPathologyAugmentationError(DigitalPathologyError):
    """Error base class for all augmentation errors."""


class InvalidRangeError(DigitalPathologyAugmentationError):
    """Raised when an augmentation range parameter is not valid."""

    def __init__(self, title, range):
        super().__init__(f"Invalid range of {title}: {range}")
        self.title = title
        self.range = range


class TissueMaskException(Exception):
    """Raised when a computed tissue mask is empty (``stain_utils.py:46-47``)."""
