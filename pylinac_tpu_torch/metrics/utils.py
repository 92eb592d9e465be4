"""Feature finding: region views and the multi-threshold disk finder.

Port of ``pylinac_tpu/metrics/utils.py``: ``RegionView`` (``:47-134``) over
the port's :class:`~pylinac_tpu_torch.ops.label.Regions` after
:meth:`~pylinac_tpu_torch.ops.label.Regions.to_numpy`,
``valid_region_views`` (``:137``), ``deduplicate_points_and_boundaries``
(``:143``), ``_region_boundary`` (``:164``), ``find_features`` (``:181``)
with its sequential threshold loop, and ``get_boundary`` (``:279``).

Not ported: ``batch_thresholds`` and ``_batched_regionprops`` (``:33-44``),
which sent the thresholds in chunks to save TPU dispatch round trips; the
loop here stops at the first threshold that finds enough features, as the
JAX default does. Each step labels one mask on ``device`` (the CCL kernel
at B = 1 on the card) and reads the slots back to the host.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from ..core.array_utils import stretch
from ..core.geometry import Point
from ..ops.label import Regions, clear_border, regionprops


class RegionView:
    """A skimage-RegionProperties-compatible view over one slot of host
    (numpy) :class:`pylinac_tpu_torch.ops.label.Regions` arrays."""

    __slots__ = ("_regions", "_i")

    def __init__(self, regions: Regions, i: int):
        self._regions = regions
        self._i = i

    @property
    def bbox(self) -> tuple[int, int, int, int]:
        r = self._regions
        i = self._i
        return (int(r.bbox_rmin[i]), int(r.bbox_cmin[i]),
                int(r.bbox_rmax[i]), int(r.bbox_cmax[i]))

    @property
    def area(self) -> float:
        return float(self._regions.area[self._i])

    @property
    def area_filled(self) -> float:
        return float(self._regions.area_filled[self._i])

    filled_area = area_filled

    @property
    def bbox_area(self) -> float:
        return float(self._regions.bbox_area[self._i])

    @property
    def area_bbox(self) -> float:
        return self.bbox_area

    @property
    def solidity(self) -> float:
        return float(self._regions.solidity[self._i])

    @property
    def perimeter(self) -> float:
        return float(self._regions.perimeter[self._i])

    @property
    def centroid(self) -> tuple[float, float]:
        return (float(self._regions.centroid_r[self._i]),
                float(self._regions.centroid_c[self._i]))

    @property
    def weighted_centroid(self) -> tuple[float, float]:
        return (float(self._regions.weighted_centroid_r[self._i]),
                float(self._regions.weighted_centroid_c[self._i]))

    @property
    def centroid_weighted(self) -> tuple[float, float]:
        return self.weighted_centroid

    @property
    def eccentricity(self) -> float:
        return float(self._regions.eccentricity[self._i])

    @property
    def orientation(self) -> float:
        return float(self._regions.orientation[self._i])

    @property
    def major_axis_length(self) -> float:
        return float(self._regions.major_axis_length[self._i])

    @property
    def minor_axis_length(self) -> float:
        return float(self._regions.minor_axis_length[self._i])

    @property
    def equivalent_diameter_area(self) -> float:
        return float(np.sqrt(4 * self.area / np.pi))

    @property
    def mean_intensity(self) -> float:
        return float(self._regions.mean_intensity[self._i])

    @property
    def max_intensity(self) -> float:
        return float(self._regions.max_intensity[self._i])

    @property
    def min_intensity(self) -> float:
        return float(self._regions.min_intensity[self._i])


def valid_region_views(regions: Regions) -> list[RegionView]:
    """RegionViews of the valid slots of (K,) regions, on the host."""
    host = regions.to_numpy() if isinstance(regions.valid, torch.Tensor) else regions
    return [RegionView(host, i) for i in np.nonzero(host.valid)[0]]


def deduplicate_points_and_boundaries(
    original_points: list[Point],
    new_points: list[Point],
    min_separation_px: float,
    original_boundaries: list,
    new_boundaries: list,
) -> tuple[list[Point], list]:
    """Drop new points closer than ``min_separation_px`` to any original
    point; the lists of originals are extended in place."""
    combined_points = original_points
    combined_boundaries = original_boundaries
    for new_point, new_boundary in zip(new_points, new_boundaries):
        for original_point in original_points:
            if new_point.distance_to(original_point) < min_separation_px:
                break
        else:
            combined_points.append(new_point)
            combined_boundaries.append(new_boundary)
    return combined_points, combined_boundaries


def _region_boundary(regions_host: Regions, i: int, mask_shape, top_offset: int,
                     left_offset: int) -> np.ndarray:
    """The region's bbox outline as a boolean image, for plotting (the JAX
    function's stand-in for skimage's exact boundary)."""
    rmin, cmin, rmax, cmax = (int(regions_host.bbox_rmin[i]), int(regions_host.bbox_cmin[i]),
                              int(regions_host.bbox_rmax[i]), int(regions_host.bbox_cmax[i]))
    boundary = np.zeros((rmax + top_offset + 1, cmax + left_offset + 1), dtype=bool)
    boundary[rmin + top_offset: rmax + top_offset, cmin + left_offset] = True
    boundary[rmin + top_offset: rmax + top_offset, cmax + left_offset - 1] = True
    boundary[rmin + top_offset, cmin + left_offset: cmax + left_offset] = True
    boundary[rmax + top_offset - 1, cmin + left_offset: cmax + left_offset] = True
    return boundary


def find_features(
    sample: np.ndarray,
    top_offset: int,
    left_offset: int,
    min_number: int,
    max_number: int | float,
    dpmm: float,
    detection_conditions: list[Callable],
    radius_mm: float,
    radius_tolerance_mm: float,
    min_separation_mm: float,
    K: int = 24,
    device: str | torch.device = "cpu",
) -> tuple[list[Point], list[np.ndarray], list[RegionView]]:
    """Scan the 50 threshold steps of the stretched sample from the lowest:
    label and measure each mask (4-connected, holes filled), keep the
    regions off the border that pass every detection condition, largest
    filled area first, and add their weighted centroids unless they lie
    within ``min_separation_mm`` of one found before. Stops once
    ``max_number`` features are found; raises if fewer than ``min_number``
    were. Returns the points (offset into the image), their bbox outlines
    and the regions kept at the last successful step."""
    sample = stretch(np.asarray(sample, dtype=np.float32), min=0, max=1)
    dev_sample = torch.from_numpy(sample).to(device)
    imin, imax = float(sample.min()), float(sample.max())
    step_size = (imax - imin) / 50
    cutoff = imin + step_size

    total_features: list[Point] = []
    feature_boundaries: list[np.ndarray] = []
    last_regions: list[RegionView] = []
    while cutoff <= imax and len(total_features) < max_number:
        regions = clear_border(regionprops(dev_sample > cutoff, dev_sample, K=K,
                                           connectivity=1))
        host_regions = regions.to_numpy()
        candidates = [RegionView(host_regions, i) for i in np.nonzero(host_regions.valid)[0]]
        candidates.sort(key=lambda r: r.filled_area, reverse=True)
        kept = [region for region in candidates
                if all(condition(region, dpmm=dpmm, bb_size=radius_mm,
                                 tolerance=radius_tolerance_mm, shape=sample.shape)
                       for condition in detection_conditions)]
        if kept:
            new_points = [Point(r.weighted_centroid[1], r.weighted_centroid[0]) for r in kept]
            new_boundaries = [_region_boundary(host_regions, r._i, sample.shape,
                                               top_offset, left_offset) for r in kept]
            total_features, feature_boundaries = deduplicate_points_and_boundaries(
                original_points=total_features, new_points=new_points,
                min_separation_px=min_separation_mm * dpmm,
                original_boundaries=feature_boundaries, new_boundaries=new_boundaries)
            last_regions = kept
        cutoff += step_size

    if len(total_features) < min_number:
        raise ValueError(
            f"Couldn't find the minimum number of disks in the image. "
            f"Found {len(total_features)}; required: {min_number}")
    for feature in total_features:
        feature.x += left_offset
        feature.y += top_offset
    return total_features, feature_boundaries, last_regions


def get_boundary(region: RegionView, top_offset: int, left_offset: int) -> np.ndarray:
    """Bbox-outline boundary of a RegionView (plotting aid)."""
    return _region_boundary(region._regions, region._i, None, top_offset, left_offset)
