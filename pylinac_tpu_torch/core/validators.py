"""Array validators.

Carried over from ``pylinac_tpu/core/validators.py`` (``array_not_empty``
``:8``, ``single_dimension`` ``:13``, ``double_dimension`` ``:18``,
``is_positive`` ``:23``), unchanged: host numpy.
"""

from __future__ import annotations

import numpy as np


def array_not_empty(array: np.ndarray) -> None:
    if array.size == 0:
        raise ValueError("Array must not be empty")


def single_dimension(array: np.ndarray) -> None:
    if array.ndim > 1:
        raise ValueError(f"Array was multidimensional. Must pass 1D array; found {array.ndim}")


def double_dimension(array: np.ndarray) -> None:
    if array.ndim != 2:
        raise ValueError(f"Array was not 2D. Must pass 2D array; found {array.ndim}")


def is_positive(value) -> None:
    if value < 0:
        raise ValueError("Value must be positive")
