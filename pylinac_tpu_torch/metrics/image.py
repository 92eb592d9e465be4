"""Image-attached plugin metrics: the sized disk locators.

Port of ``pylinac_tpu/metrics/image.py``: ``MetricBase`` (``:38``),
``SizedDiskRegion`` (``:188``) and ``SizedDiskLocator`` (``:298``), without
their plotting. The disk search runs :func:`~pylinac_tpu_torch.metrics.utils.
find_features` on the locator's ``device``: ``None`` means CUDA. The ROI
metrics, ``GlobalSizedDiskLocator`` and the field locators wait for the
slices that use them.
"""

from __future__ import annotations

import math
import weakref
from abc import ABC, abstractmethod
from collections.abc import Callable
from typing import Any

import numpy as np

from ..core.array_utils import invert
from ..core.geometry import Point
from ..core.utilities import resolve_device
from .features import (
    is_right_circumference,
    is_right_size_bb,
    is_round,
    is_solid,
    is_symmetric,
)
from .utils import RegionView, find_features


class MetricBase(ABC):
    """Base of the 2D image metrics."""

    unit: str = ""
    image_compatibility: list | None = None
    name: str

    def inject_image(self, image) -> None:
        if self.image_compatibility is not None and not isinstance(
                image, tuple(self.image_compatibility)):
            raise TypeError(f"Image must be one of {self.image_compatibility}")
        self.image = weakref.proxy(image)

    @property
    def full_name(self) -> str:
        return f"{self.name} ({self.unit})" if self.unit else self.name

    def context_calculate(self) -> Any:
        """:meth:`calculate`, raising if it changed the image's pixels."""
        img_hash = hash(self.image.array.tobytes())
        calculation = self.calculate()
        if hash(self.image.array.tobytes()) != img_hash:
            raise RuntimeError(
                "A metric modified an image. This is not allowed as it could "
                "affect downstream metrics.")
        return calculation

    @abstractmethod
    def calculate(self) -> Any:
        pass


class SizedDiskRegion(MetricBase):
    """Find disks (BBs) of a given size in a search window around an
    expected position. Returns the regions of the last successful threshold
    step."""

    is_from_physical: bool = False
    is_from_center: bool = False

    _DEFAULT_CONDITIONS = (is_right_size_bb, is_round, is_right_circumference,
                           is_symmetric, is_solid)

    def __init__(self, expected_position, search_window, radius: float,
                 radius_tolerance: float,
                 detection_conditions: tuple[Callable, ...] = _DEFAULT_CONDITIONS,
                 invert: bool = True, name: str = "Disk Region",
                 max_number: int = 1, min_number: int = 1,
                 min_separation_pixels: float = 5, device=None):
        self.expected_position = Point(expected_position)
        self.radius = radius
        self.radius_tolerance = radius_tolerance
        self.search_window = search_window
        self.detection_conditions = list(detection_conditions)
        self.name = name
        self.invert = invert
        self.max_number = max_number
        self.min_number = min_number
        self.min_separation = min_separation_pixels
        self.device = device

    @classmethod
    def from_physical(cls, expected_position_mm, search_window_mm, radius_mm,
                      radius_tolerance_mm, detection_conditions=_DEFAULT_CONDITIONS,
                      invert: bool = True, name="Disk Region", max_number: int = 1,
                      min_number: int = 1, min_separation_mm: float = 5, device=None):
        instance = cls(expected_position=expected_position_mm,
                       search_window=search_window_mm, radius=radius_mm,
                       radius_tolerance=radius_tolerance_mm,
                       detection_conditions=detection_conditions, name=name,
                       invert=invert, max_number=max_number, min_number=min_number,
                       min_separation_pixels=min_separation_mm, device=device)
        instance.is_from_physical = True
        return instance

    @classmethod
    def from_center(cls, expected_position, search_window, radius, radius_tolerance,
                    detection_conditions=_DEFAULT_CONDITIONS, invert: bool = True,
                    name="Disk Region", max_number: int = 1, min_number: int = 1,
                    min_separation_pixels: float = 5, device=None):
        instance = cls(expected_position=expected_position, search_window=search_window,
                       radius=radius, radius_tolerance=radius_tolerance,
                       detection_conditions=detection_conditions, name=name,
                       invert=invert, max_number=max_number, min_number=min_number,
                       min_separation_pixels=min_separation_pixels, device=device)
        instance.is_from_center = True
        return instance

    @classmethod
    def from_center_physical(cls, expected_position_mm, search_window_mm, radius_mm,
                             radius_tolerance_mm: float = 0.25,
                             detection_conditions=_DEFAULT_CONDITIONS,
                             invert: bool = True, name="Disk Region",
                             max_number: int = 1, min_number: int = 1,
                             min_separation_mm: float = 5, device=None):
        instance = cls(expected_position=expected_position_mm,
                       search_window=search_window_mm, radius=radius_mm,
                       radius_tolerance=radius_tolerance_mm,
                       detection_conditions=detection_conditions, name=name,
                       invert=invert, max_number=max_number, min_number=min_number,
                       min_separation_pixels=min_separation_mm, device=device)
        instance.is_from_physical = True
        instance.is_from_center = True
        return instance

    def calculate(self) -> list[RegionView]:
        if self.is_from_physical:
            self.expected_position = self.expected_position * self.image.dpmm
            self.search_window = np.asarray(self.search_window) * self.image.dpmm
        else:
            self.min_separation /= self.image.dpmm
            self.radius /= self.image.dpmm
            self.radius_tolerance /= self.image.dpmm
        if self.is_from_center:
            self.expected_position.x += self.image.shape[1] / 2
            self.expected_position.y += self.image.shape[0] / 2
        left = max(math.floor(self.expected_position.x - self.search_window[0] / 2), 0)
        right = math.ceil(self.expected_position.x + self.search_window[0] / 2)
        top = max(math.floor(self.expected_position.y - self.search_window[1] / 2), 0)
        bottom = math.ceil(self.expected_position.y + self.search_window[1] / 2)
        sample = self.image[top:bottom, left:right]
        if self.invert:
            sample = invert(sample)
        points, boundaries, regions = find_features(
            sample, top_offset=top, left_offset=left, min_number=self.min_number,
            max_number=self.max_number, dpmm=self.image.dpmm,
            detection_conditions=self.detection_conditions,
            radius_mm=self.radius, radius_tolerance_mm=self.radius_tolerance,
            min_separation_mm=self.min_separation,
            device=resolve_device(self.device, type(self).__name__))
        self.x_offset = left
        self.y_offset = top
        self.boundaries = boundaries
        self.points = points
        return regions


class SizedDiskLocator(SizedDiskRegion):
    """The weighted centroids of the found disks."""

    def calculate(self) -> list[Point]:
        super().calculate()
        return self.points
