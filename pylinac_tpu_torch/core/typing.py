"""Typing aliases, carried over from ``pylinac_tpu/core/typing.py:7-9``."""

from __future__ import annotations

import numpy as np

ArrayLike = list | tuple | np.ndarray

NumberOrArray = float | ArrayLike
