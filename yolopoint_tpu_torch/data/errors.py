"""The error the image readers raise for a file that `cv2.imread` returns
None for."""


class Unreadable(ValueError):
    """A malformed image file, or one of a kind OpenCV's decoder refuses.
    `datasets._imread` turns it, and it alone, into the `FileNotFoundError`
    that the JAX package's `_imread` raises where `cv2.imread` returns None;
    any other exception from a reader is a fault of the reader and leaves
    `_imread` as it is."""
