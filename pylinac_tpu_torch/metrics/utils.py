"""Region views for the feature finders, on the host.

Port of ``RegionView`` (``pylinac_tpu/metrics/utils.py:47-134``) over the
port's :class:`~pylinac_tpu_torch.ops.label.Regions` after
:meth:`~pylinac_tpu_torch.ops.label.Regions.to_numpy`. ``find_features``
waits for the slices that use it.
"""

from __future__ import annotations

import numpy as np

from ..ops.label import Regions


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
