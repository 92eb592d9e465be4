"""Region predicates of the feature finders, on the host.

Port of ``pylinac_tpu/metrics/features.py``: the five default BB predicates
``is_symmetric`` (``:12``), ``is_right_size_bb`` (``:37``), ``is_solid``
(``:47``), ``is_round`` (``:52``) and ``is_right_circumference`` (``:59``),
plus the Winston-Lutz predicates ``is_near_center``, ``is_modest_size``,
``is_square`` and ``is_right_square_size`` (``pylinac_tpu/winston_lutz.py:
400-426``) and the field predicates ``is_right_square_perimeter``
(``:67``) and ``is_right_area_square`` (``:82``) of the field locators. Each
takes a :class:`~pylinac_tpu_torch.metrics.utils.RegionView` and the
finder's keyword arguments.
"""

from __future__ import annotations

import numpy as np


def is_symmetric(region, *args, **kwargs) -> bool:
    """Whether the region's bbox is roughly square (a circle-like blob)."""
    ymin, xmin, ymax, xmax = region.bbox
    y = abs(ymax - ymin)
    x = abs(xmax - xmin)
    if x > max(y * 1.05, y + 3) or x < min(y * 0.95, y - 3):
        return False
    return True


def is_right_size_bb(region, *args, **kwargs) -> bool:
    """Whether the region area matches a BB of the given radius ± tolerance."""
    bb_area = region.area_filled / (kwargs["dpmm"] ** 2)
    bb_size = kwargs["bb_size"]
    tolerance = kwargs["tolerance"]
    larger_bb_area = np.pi * (bb_size + tolerance) ** 2
    smaller_bb_area = max((np.pi * (bb_size - tolerance) ** 2, 2))
    return smaller_bb_area < bb_area < larger_bb_area


def is_solid(region, *args, **kwargs) -> bool:
    """Whether the region is non-spiculated (solidity > 0.9)."""
    return region.solidity > 0.9


def is_round(region, *args, **kwargs) -> bool:
    """Fill ratio of the bbox consistent with a circle (π/4 ± 20 %)."""
    expected_fill_ratio = np.pi / 4
    actual_fill_ratio = region.filled_area / region.bbox_area
    return expected_fill_ratio * 1.2 > actual_fill_ratio > expected_fill_ratio * 0.8


def is_right_circumference(region, *args, **kwargs) -> bool:
    """Perimeter consistent with a circle of the given radius ± tolerance."""
    upper = 2 * np.pi * (kwargs["bb_size"] + kwargs["tolerance"])
    lower = 2 * np.pi * (kwargs["bb_size"] - kwargs["tolerance"])
    actual = region.perimeter / kwargs["dpmm"]
    return upper > actual > lower


def is_right_square_perimeter(region, *args, **kwargs) -> bool:
    """Perimeter consistent with the expected square field (the upper bound
    20 % wider on the width term, as in the reference)."""
    actual = region.perimeter / kwargs["dpmm"]
    upper = 1.20 * 2 * (kwargs["field_width_mm"] + kwargs["field_tolerance_mm"]) + 2 * (
        kwargs["field_height_mm"] + kwargs["field_tolerance_mm"])
    lower = 2 * (kwargs["field_width_mm"] - kwargs["field_tolerance_mm"]) + 2 * (
        kwargs["field_height_mm"] - kwargs["field_tolerance_mm"])
    return upper > actual > lower


def is_right_area_square(region, *args, **kwargs) -> bool:
    """Filled area consistent with the expected field size ± tolerance."""
    field_area = region.area_filled / (kwargs["dpmm"] ** 2)
    low = (kwargs["field_width_mm"] - kwargs["field_tolerance_mm"]) * (
        kwargs["field_height_mm"] - kwargs["field_tolerance_mm"])
    high = (kwargs["field_width_mm"] + kwargs["field_tolerance_mm"]) * (
        kwargs["field_height_mm"] + kwargs["field_tolerance_mm"])
    return low < field_area < high


def is_near_center(region, *args, **kwargs) -> bool:
    """Whether the region's bbox centre is within 2 cm of the image centre."""
    dpmm = kwargs["dpmm"]
    shape = kwargs["shape"]
    extent_limit_mm = 20
    bottom, left, top, right = region.bbox
    bb_center_x = left + (right - left) / 2
    bb_center_y = bottom + (top - bottom) / 2
    return (shape[1] / 2 - dpmm * extent_limit_mm < bb_center_x < shape[1] / 2 + dpmm * extent_limit_mm
            and shape[0] / 2 - dpmm * extent_limit_mm < bb_center_y < shape[0] / 2 + dpmm * extent_limit_mm)


def is_modest_size(region, *args, **kwargs) -> bool:
    """Whether the filled area is that of a disk of the BB size ± 2 mm."""
    bb_area = region.area_filled / (kwargs["dpmm"] ** 2)
    bb_size = kwargs["bb_size"]
    larger = np.pi * ((bb_size + 2) / 2) ** 2
    smaller = max((np.pi * ((bb_size - 2) / 2) ** 2, 2))
    return smaller < bb_area < larger


def is_square(region, *args, **kwargs) -> bool:
    """Fill ratio of the bbox consistent with a square (> 0.8)."""
    return region.filled_area / region.bbox_area > 0.8


def is_right_square_size(region, *args, **kwargs) -> bool:
    """Whether the filled area is that of a square of the radiation size
    ± 5 mm."""
    field_area = region.area_filled / (kwargs["dpmm"] ** 2)
    rad_size = max((kwargs["rad_size"], 5))
    return (rad_size - 5) ** 2 < field_area < (rad_size + 5) ** 2
