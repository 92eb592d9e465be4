"""1D profiles: what the CatPhan analysis reads, numpy on the host.

Port of part of ``pylinac_tpu/core/profile.py``: ``ProfileMixin.ground`` and
``.filter`` (``:87-93``), ``ProfileBase`` (``:143``: x values, the linear
``x_at_x_idx``, ``field_width_px``), ``FWXMProfile`` (``:305``),
``MultiProfile.find_peaks`` and ``.find_valleys`` (``:994-1026``),
``CircleProfile`` and ``CollapsedCircleProfile`` (``:1043-1200``), without
plots. Peaks come from :mod:`pylinac_tpu_torch.ops.peaks` on the CPU, where
the profiles live. Normalisation, resampling, the inflection and Hill
edges, gamma and ``SingleProfile`` wait for the slices that use them.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from . import array_utils as utils
from .geometry import Circle, Point
from ..ops.peaks import find_peaks

LEFT = "left"
RIGHT = "right"


def _interp_linear_extrap(x, xp, fp):
    """Linear interpolation with linear extrapolation (UnivariateSpline k=1 s=0)."""
    x = np.asarray(x, dtype=float)
    inner = np.interp(x, xp, fp)
    left_slope = (fp[1] - fp[0]) / (xp[1] - xp[0])
    right_slope = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
    out = np.where(x < xp[0], fp[0] + (x - xp[0]) * left_slope, inner)
    return np.where(x > xp[-1], fp[-1] + (x - xp[-1]) * right_slope, out)


class ProfileMixin:
    """Manipulations of 1D profile data."""

    values: np.ndarray

    def ground(self) -> float:
        min_val = self.values.min()
        self.values = utils.ground(self.values)
        return min_val

    def filter(self, size: float = 0.05, kind: str = "median") -> None:
        self.values = utils.filter(self.values, size=size, kind=kind)


class ProfileBase(ProfileMixin):
    """Base of the single-peak profiles: values over sorted x values."""

    def __init__(self, values, x_values=None, ground: bool = False):
        values = np.asarray(values)
        if values.ndim != 1:
            raise ValueError("Values must be 1D")
        if x_values is None:
            x_values = np.arange(len(values), dtype=float)
        x_values = np.asarray(x_values, dtype=float)
        x_diff = np.diff(x_values)
        if len(x_diff) and x_diff.max() > 0 > x_diff.min():
            raise ValueError("X values must be monotonically increasing or decreasing")
        sort_idxs = np.argsort(x_values)
        self.x_values = x_values[sort_idxs]
        self.values = values[sort_idxs]
        if ground:
            self.values = utils.ground(self.values)

    def x_at_x_idx(self, x) -> float | np.ndarray:
        out = _interp_linear_extrap(x, np.arange(len(self.x_values), dtype=float),
                                    self.x_values)
        return float(out) if np.size(out) == 1 else out

    def field_edge_idx(self, side: str) -> float:
        raise NotImplementedError

    @cached_property
    def field_width_px(self) -> float:
        left = self.field_edge_idx(side=LEFT)
        right = self.field_edge_idx(side=RIGHT)
        return max(right, left) - min(right, left)


class FWXMProfile(ProfileBase):
    """Field edges at the full width at ``fwxm_height`` % of the maximum."""

    def __init__(self, values, x_values=None, ground: bool = False,
                 fwxm_height: float = 50):
        self.fwxm_height = fwxm_height
        super().__init__(values=values, x_values=x_values, ground=ground)

    def field_edge_idx(self, side: str) -> float:
        _, props = find_peaks(self.values, fwxm_height=self.fwxm_height / 100,
                              max_number=1)
        idx = props["left_ips"][0] if side == LEFT else props["right_ips"][0]
        return self.x_at_x_idx(idx)


class MultiProfile(ProfileMixin):
    """A profile with several peaks."""

    def __init__(self, values):
        self.values = np.asarray(values)
        self.peaks: list[Point] = []
        self.valleys: list[Point] = []

    def find_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                   max_number: int | None = None, search_region=(0.0, 1.0),
                   peak_sort: str = "prominences") -> tuple[np.ndarray, np.ndarray]:
        peak_idxs, props = find_peaks(
            self.values, threshold=threshold, peak_separation=min_distance,
            max_number=max_number, search_region=search_region, peak_sort=peak_sort)
        self.peaks = [Point(value=v, idx=i) for i, v in zip(peak_idxs, props["peak_heights"])]
        return peak_idxs, props["peak_heights"]

    def find_valleys(self, threshold: float = 0.3, min_distance: float = 0.05,
                     max_number: int | None = None,
                     search_region=(0.0, 1.0)) -> tuple[np.ndarray, np.ndarray]:
        valley_idxs, _ = find_peaks(
            -self.values, threshold=threshold, peak_separation=min_distance,
            max_number=max_number, search_region=search_region)
        self.valleys = [Point(value=self.values[i], idx=i) for i in valley_idxs]
        return valley_idxs, self.values[valley_idxs]


class CircleProfile(MultiProfile, Circle):
    """A profile sampled around a circle, nearest pixel (scipy
    map_coordinates order 0)."""

    def __init__(self, center: Point, radius: float, image_array,
                 start_angle: float = 0, ccw: bool = True, sampling_ratio: float = 1.0):
        Circle.__init__(self, center, radius)
        self._ensure_array_size(image_array, self.radius + self.center.x,
                                self.radius + self.center.y)
        self.image_array = image_array
        self.start_angle = start_angle
        self.ccw = ccw
        self.sampling_ratio = sampling_ratio
        MultiProfile.__init__(self, self._profile)

    @property
    def size(self) -> float:
        return np.pi * self.radius * 2 * self.sampling_ratio

    @property
    def _radians(self) -> np.ndarray:
        interval = (2 * np.pi) / self.size
        rads = np.arange(0 + self.start_angle,
                         (2 * np.pi) + self.start_angle - interval, interval)
        return rads[::-1] if self.ccw else rads

    @property
    def x_locations(self) -> np.ndarray:
        return np.cos(self._radians) * self.radius + self.center.x

    @property
    def y_locations(self) -> np.ndarray:
        return np.sin(self._radians) * self.radius + self.center.y

    @property
    def _profile(self) -> np.ndarray:
        yy = np.clip(np.round(self.y_locations).astype(int), 0, self.image_array.shape[0] - 1)
        xx = np.clip(np.round(self.x_locations).astype(int), 0, self.image_array.shape[1] - 1)
        return np.asarray(self.image_array)[yy, xx]

    def find_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                   max_number: int | None = None, search_region=(0.0, 1.0)):
        peak_idxs, peak_vals = super().find_peaks(threshold, min_distance,
                                                  max_number, search_region)
        self._map_peaks()
        return peak_idxs, peak_vals

    def find_valleys(self, threshold: float = 0.3, min_distance: float = 0.05,
                     max_number: int | None = None, search_region=(0.0, 1.0)):
        valley_idxs, valley_vals = super().find_valleys(threshold, min_distance,
                                                        max_number, search_region)
        self._map_peaks()
        return valley_idxs, valley_vals

    def _map_peaks(self) -> None:
        x_locations, y_locations = self.x_locations, self.y_locations
        for peak in self.peaks:
            peak.x = x_locations[int(peak.idx)]
            peak.y = y_locations[int(peak.idx)]

    @staticmethod
    def _ensure_array_size(array, min_width, min_height) -> None:
        if array.shape[1] < min_width or array.shape[0] < min_height:
            raise ValueError("Array size not large enough to compute profile")


class CollapsedCircleProfile(CircleProfile):
    """A thick circular profile: the mean of ``num_profiles`` concentric
    rings."""

    def __init__(self, center: Point, radius: float, image_array,
                 start_angle: float = 0, ccw: bool = True, sampling_ratio: float = 1.0,
                 width_ratio: float = 0.1, num_profiles: int = 20):
        self.width_ratio = width_ratio
        self.num_profiles = num_profiles
        super().__init__(center, radius, image_array, start_angle, ccw, sampling_ratio)

    @property
    def _radii(self) -> np.ndarray:
        return np.linspace(self.radius * (1 - self.width_ratio),
                           self.radius * (1 + self.width_ratio), self.num_profiles)

    @property
    def size(self) -> float:
        return np.pi * max(self._radii) * 2 * self.sampling_ratio

    @property
    def _profile(self) -> np.ndarray:
        rads = self._radians
        radii = self._radii[:, None]
        xx = np.round(np.cos(rads)[None, :] * radii + self.center.x).astype(int)
        yy = np.round(np.sin(rads)[None, :] * radii + self.center.y).astype(int)
        yy = np.clip(yy, 0, self.image_array.shape[0] - 1)
        xx = np.clip(xx, 0, self.image_array.shape[1] - 1)
        return np.asarray(self.image_array)[yy, xx].sum(axis=0) / self.num_profiles
