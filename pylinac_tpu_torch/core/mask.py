"""Binary mask utilities.

Carried over from ``pylinac_tpu/core/mask.py`` (``bounding_box`` ``:8``),
unchanged: host numpy.
"""

from __future__ import annotations

import numpy as np


def bounding_box(array: np.ndarray) -> tuple[float, ...]:
    """(ymin, ymax, xmin, xmax) of the nonzero region of a binary array."""
    binary_arr = np.argwhere(array)
    (ymin, xmin), (ymax, xmax) = binary_arr.min(0), binary_arr.max(0) + 1
    return ymin, ymax, xmin, xmax
