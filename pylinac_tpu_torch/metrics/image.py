"""Image-attached plugin metrics: ROI samplers, disk and field locators.

Port of ``pylinac_tpu/metrics/image.py``: ``MetricBase`` (``:38``),
``DiskROIMetric`` (``:78``), ``RectangleROIMetric`` (``:110``),
``GlobalSizedDiskLocator`` (``:145``), ``SizedDiskRegion`` (``:188``),
``SizedDiskLocator`` (``:298``), ``GlobalSizedFieldLocator`` (``:314``),
``GlobalFieldLocator`` (``:407``) and ``WeightedCentroid`` (``:424``),
with their ``plot`` methods (``:68-72``, ``:105``, ``:140``, ``:179``,
``:290``, ``:305``, ``:397``), which draw on a matplotlib axes
(``MetricBase.plotly`` and ``additional_plots``, ``:71-75``, draw nothing,
as in JAX). The ROI
metrics and the weighted centroid are numpy on the host. The locators label the image on their ``device``
(``None`` means CUDA): the disk locators through
:func:`~pylinac_tpu_torch.metrics.utils.find_features` (4-connected), the
field locators through :func:`~pylinac_tpu_torch.ops.label.regionprops` of
the whole frame (8-connected), one threshold at a time; each step is one
label and one hole launch of the CCL kernel ``csrc/ccl.cu`` on the card.
"""

from __future__ import annotations

import math
import weakref
from abc import ABC, abstractmethod
from collections.abc import Callable
from typing import Any

import numpy as np

import torch

from ..core.array_utils import invert
from ..core.geometry import Point
from ..core.roi import DiskROI, RectangleROI
from ..core.utilities import resolve_device
from ..ops.label import regionprops
from .features import (
    is_right_area_square,
    is_right_circumference,
    is_right_size_bb,
    is_right_square_perimeter,
    is_round,
    is_solid,
    is_symmetric,
)
from .utils import (
    RegionView,
    deduplicate_points_and_boundaries,
    find_features,
    get_boundary,
)


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

    def plot(self, axis, **kwargs) -> None:
        pass

    def plotly(self, fig, **kwargs) -> None:
        pass

    def additional_plots(self) -> list:
        return []


class DiskROIMetric(MetricBase):
    """Sample a disk ROI of the image."""

    _from_physical: bool = False

    @classmethod
    def from_physical(cls, radius_mm: float, center_mm: Point,
                      name: str = "Disk ROI Metric", edgecolor: str = "b", **kwargs):
        instance = cls(radius_mm, center_mm, name, edgecolor, **kwargs)
        instance._from_physical = True
        return instance

    def __init__(self, radius: float, center: Point, name: str = "Disk ROI Metric",
                 edgecolor: str = "b", **kwargs):
        self.radius = radius
        self.center = center
        self.name = name
        self.edge_color = edgecolor
        self.kwargs = kwargs

    def calculate(self) -> DiskROI:
        if self._from_physical:
            self.radius *= self.image.dpmm
            self.center = self.center * self.image.dpmm
        self.roi = DiskROI(array=self.image.array, center=self.center, radius=self.radius)
        return self.roi

    def plot(self, axis, **kwargs) -> None:
        edgecolor = kwargs.pop("edgecolor", self.edge_color)
        self.roi.plot2axes(axis, edgecolor=edgecolor, **{**self.kwargs, **kwargs})


class RectangleROIMetric(MetricBase):
    """Sample a rectangular ROI of the image."""

    _from_physical: bool = False

    @classmethod
    def from_physical(cls, width_mm: float, height_mm: float, center_mm: Point,
                      name: str = "Rectangle ROI Metric", edgecolor: str = "b", **kwargs):
        instance = cls(width_mm, height_mm, center_mm, name, edgecolor, **kwargs)
        instance._from_physical = True
        return instance

    def __init__(self, width: float, height: float, center: Point,
                 name: str = "Rectangle ROI Metric", edgecolor: str = "b", **kwargs):
        self.width = width
        self.height = height
        self.center = center
        self.name = name
        self.edge_color = edgecolor
        self.kwargs = kwargs

    def calculate(self) -> RectangleROI:
        if self._from_physical:
            self.width *= self.image.dpmm
            self.height *= self.image.dpmm
            self.center = self.center * self.image.dpmm
        self.roi = RectangleROI(array=self.image.array, center=self.center,
                                width=self.width, height=self.height)
        return self.roi

    def plot(self, axis, **kwargs) -> None:
        edgecolor = kwargs.pop("edgecolor", self.edge_color)
        self.roi.plot2axes(axis, edgecolor=edgecolor, **{**self.kwargs, **kwargs})


class GlobalSizedDiskLocator(MetricBase):
    """Find every disk (BB) of a given size anywhere in the image: the
    disk finder over the whole frame."""

    def __init__(self, radius_mm: float, radius_tolerance_mm: float,
                 detection_conditions: tuple[Callable, ...] = (
                     is_round, is_right_size_bb, is_right_circumference),
                 invert: bool = True, min_number: int = 1,
                 max_number: int | None = None, min_separation_mm: float = 5,
                 name="Global Disk Locator", device=None):
        self.radius = radius_mm
        self.radius_tolerance = radius_tolerance_mm
        self.detection_conditions = list(detection_conditions)
        self.name = name
        self.invert = invert
        self.min_number = min_number
        self.max_number = max_number or 1e3
        self.min_separation_mm = min_separation_mm
        self.device = device

    def calculate(self) -> list[Point]:
        sample = invert(self.image.array) if self.invert else self.image.array
        self.points, boundaries, _ = find_features(
            sample, top_offset=0, left_offset=0, min_number=self.min_number,
            max_number=self.max_number, dpmm=self.image.dpmm,
            detection_conditions=self.detection_conditions,
            radius_mm=self.radius, radius_tolerance_mm=self.radius_tolerance,
            min_separation_mm=self.min_separation_mm,
            device=resolve_device(self.device, type(self).__name__))
        self.y_boundaries = []
        self.x_boundaries = []
        for boundary in boundaries:
            by, bx = np.nonzero(boundary)
            self.y_boundaries.append(by)
            self.x_boundaries.append(bx)
        return self.points

    def plot(self, axis, show_boundaries: bool = True, color: str = "red",
             markersize: float = 3, alpha: float = 0.25) -> None:
        for point in self.points:
            axis.plot(point.x, point.y, "o", color=color)
        if show_boundaries:
            for by, bx in zip(self.y_boundaries, self.x_boundaries):
                axis.scatter(bx, by, c=color, marker="s", alpha=alpha, s=markersize)


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

    def plot(self, axis, show_boundaries: bool = True, color: str = "red",
             markersize: float = 3, alpha: float = 0.25) -> None:
        if show_boundaries:
            for boundary in self.boundaries:
                by, bx = np.nonzero(boundary)
                axis.scatter(bx, by, c=color, marker="s", alpha=alpha, s=markersize)


class SizedDiskLocator(SizedDiskRegion):
    """The weighted centroids of the found disks."""

    def calculate(self) -> list[Point]:
        super().calculate()
        return self.points

    def plot(self, axis, show_boundaries: bool = True, color: str = "red",
             markersize: float = 3, alpha: float = 0.25) -> None:
        super().plot(axis, show_boundaries=show_boundaries, color=color,
                     markersize=markersize, alpha=alpha)
        for point in self.points:
            axis.plot(point.x, point.y, color=color, marker="o", alpha=1,
                      markersize=markersize)


class GlobalSizedFieldLocator(MetricBase):
    """Find the open fields of roughly a given size anywhere in the image.

    From 10 % of the image's range, in steps of 2 %, each threshold mask of
    the whole frame is labelled 8-connected with its holes (K = 16 slots,
    the hull on); the regions whose bbox keeps 3 px off the border and
    that pass every detection condition add their centroids, unless one
    found before lies within the largest kept equivalent diameter divided
    by dpmm (a pixel length divided once more, as in the JAX class; kept
    for parity). Stops at ``max_number`` fields."""

    is_from_physical: bool = False

    def __init__(self, field_width_px: float, field_height_px: float,
                 field_tolerance_px: float, min_number: int = 1,
                 max_number: int | None = None, name: str = "Field Finder",
                 detection_conditions: tuple[Callable, ...] = (
                     is_right_square_perimeter, is_right_area_square), device=None):
        self.field_width_mm = field_width_px
        self.field_height_mm = field_height_px
        self.field_tolerance_mm = field_tolerance_px
        self.min_number = min_number
        self.max_number = max_number or 1e6
        self.name = name
        self.detection_conditions = list(detection_conditions)
        self.device = device

    @classmethod
    def from_physical(cls, field_width_mm: float, field_height_mm: float,
                      field_tolerance_mm: float, min_number: int = 1,
                      max_number: int | None = None, name: str = "Field Finder",
                      detection_conditions=(is_right_square_perimeter, is_right_area_square),
                      device=None):
        instance = cls(field_width_px=field_width_mm, field_height_px=field_height_mm,
                       field_tolerance_px=field_tolerance_mm, min_number=min_number,
                       max_number=max_number, name=name,
                       detection_conditions=detection_conditions, device=device)
        instance.is_from_physical = True
        return instance

    def calculate(self) -> list[Point]:
        if not self.is_from_physical:
            self.field_width_mm /= self.image.dpmm
            self.field_height_mm /= self.image.dpmm
            self.field_tolerance_mm /= self.image.dpmm
        device = resolve_device(self.device, type(self).__name__)
        fields: list[Point] = []
        boundaries: list = []
        sample = np.asarray(self.image.array, dtype=np.float32)
        dev_sample = torch.from_numpy(sample).to(device)
        imin, imax = float(sample.min()), float(sample.max())
        step_size = (imax - imin) / 50
        cutoff = imin + step_size * 5
        h, w = sample.shape
        while cutoff <= imax and len(fields) < self.max_number:
            host = regionprops(dev_sample > cutoff, dev_sample, K=16,
                               connectivity=2).to_numpy()
            views = []
            for i in np.nonzero(host.valid)[0]:
                view = RegionView(host, i)
                rmin, cmin, rmax, cmax = view.bbox
                # clear_border with a 3 px buffer
                if not (rmin <= 3 or cmin <= 3 or rmax >= h - 3 or cmax >= w - 3):
                    views.append(view)
            kept = [v for v in views if all(
                condition(v, dpmm=self.image.dpmm, field_width_mm=self.field_width_mm,
                          field_height_mm=self.field_height_mm,
                          field_tolerance_mm=self.field_tolerance_mm, shape=sample.shape)
                for condition in self.detection_conditions)]
            if kept:
                fields, boundaries = deduplicate_points_and_boundaries(
                    original_points=fields,
                    new_points=[Point(v.centroid[1], v.centroid[0]) for v in kept],
                    min_separation_px=max(v.equivalent_diameter_area for v in kept)
                    / self.image.dpmm,
                    original_boundaries=boundaries,
                    new_boundaries=[get_boundary(v, top_offset=0, left_offset=0)
                                    for v in kept])
            cutoff += step_size
        if len(fields) < self.min_number:
            raise ValueError(
                f"Couldn't find the minimum number of fields in the image. "
                f"Found {len(fields)}; required: {self.min_number}")
        self.fields = fields
        self.boundaries = boundaries
        return fields

    def plot(self, axis, show_boundaries: bool = True, color: str = "red",
             markersize: float = 3, alpha: float = 0.25) -> None:
        for point in self.fields:
            axis.plot(point.x, point.y, color=color, marker="+", alpha=alpha)
        if show_boundaries:
            for boundary in self.boundaries:
                by, bx = np.nonzero(boundary)
                axis.scatter(bx, by, c=color, marker="s", alpha=alpha, s=markersize)


class GlobalFieldLocator(GlobalSizedFieldLocator):
    """Find the open fields of any size."""

    def __init__(self, min_number: int = 1, max_number: int | None = None,
                 name: str = "Field Finder",
                 detection_conditions=(is_right_square_perimeter, is_right_area_square),
                 device=None):
        super().__init__(field_width_px=1e4, field_height_px=1e4, field_tolerance_px=1e4,
                         min_number=min_number, max_number=max_number, name=name,
                         detection_conditions=detection_conditions, device=device)

    @classmethod
    def from_physical(cls, *args, **kwargs):
        raise NotImplementedError(
            "Not implemented for global field-finding; use the standard initializer.")


class WeightedCentroid(MetricBase):
    """The intensity-weighted centroid of the whole image."""

    def __init__(self, name: str = "Weighted Centroid"):
        self.name = name

    def calculate(self) -> Point:
        arr = self.image.array
        if np.sum(arr) == 0:
            raise ValueError("Image is blank; cannot calculate weighted centroid")
        y_indices, x_indices = np.indices(arr.shape)
        total = np.sum(arr)
        return Point(np.sum(x_indices * arr) / total, np.sum(y_indices * arr) / total)
