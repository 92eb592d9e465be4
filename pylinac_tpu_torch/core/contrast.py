"""Contrast algorithms, numpy only.

Port of ``pylinac_tpu/core/contrast.py``; ``Contrast`` keeps its names
without the ``options()`` listing of ``OptionListMixin``.
"""

from __future__ import annotations

import numpy as np

class Contrast:
    """Contrast calculation technique options."""

    MICHELSON = "Michelson"  #:
    WEBER = "Weber"  #:
    RATIO = "Ratio"  #:
    RMS = "Root Mean Square"  #:
    DIFFERENCE = "Difference"  #:


def visibility(array: np.ndarray, radius: float, std: float, algorithm: str) -> float:
    """Rose-model visibility: contrast · sqrt(area) / std (``core/contrast.py:18``)."""
    c = contrast(array, algorithm)
    return c * np.sqrt(radius**2 * np.pi) / std


def contrast(array: np.ndarray, algorithm: str) -> float:
    """Dispatch to the requested contrast algorithm (``core/contrast.py:43``)."""
    algorithm = algorithm.lower()
    array = np.asarray(array, dtype=float)
    if algorithm == Contrast.MICHELSON.lower():
        return michelson(array)
    elif algorithm == Contrast.WEBER.lower():
        if array.size != 2:
            raise ValueError("For Weber algorithm, the array must be exactly 2 elements.")
        return weber(array[0], array[1])
    elif algorithm == Contrast.RMS.lower():
        return rms(array)
    elif algorithm == Contrast.RATIO.lower():
        if array.size != 2:
            raise ValueError("For Ratio algorithm, the array must be exactly 2 elements.")
        return ratio(array[0], array[1])
    elif algorithm == Contrast.DIFFERENCE.lower():
        if array.size != 2:
            raise ValueError("For Difference algorithm, the array must be exactly 2 elements.")
        return difference(array[0], array[1])
    raise ValueError(f"Contrast input of {algorithm} did not match any valid options")


def rms(array: np.ndarray) -> float:
    if array.min() < 0 or array.max() > 1:
        raise ValueError("RMS calculations require the input array to be normalized (0-1).")
    return float(np.sqrt(np.mean((array - array.mean()) ** 2)))


def difference(feature: float, background: float) -> float:
    return float(abs(feature - background))


def michelson(array: np.ndarray) -> float:
    l_max, l_min = np.nanmax(array), np.nanmin(array)
    # same numerics as the unguarded division (inf/nan), without the
    # RuntimeWarning when l_max + l_min == 0 (e.g. HU plugs straddling 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float((l_max - l_min) / (l_max + l_min))


def weber(feature: float, background: float) -> float:
    return float(abs(feature - background) / background)


def ratio(feature: float, reference: float) -> float:
    return float(feature / reference)
