"""1D profiles: what the CatPhan and field analyses read, on the host.

Port of part of ``pylinac_tpu/core/profile.py``: ``_interp1d`` (``:51``),
``ProfileMixin.ground`` and ``.filter`` (``:87-93``), the enums
``Interpolation``, ``Normalization``, ``Edge`` and ``Centering``
(``:102-125``), ``ProfileBase`` (``:143``: x values, the linear
``x_at_x_idx``, ``field_width_px``), ``FWXMProfile`` (``:305``), the legacy
``SingleProfile`` (``:519-963``: resampling with the half-pixel offset,
normalisation, the memo cache, ``fwxm_data``, ``field_data``,
``inflection_data`` by derivative and by Hill fits, ``penumbra``,
``field_calculation``), ``MultiProfile.find_peaks`` and ``.find_valleys``
(``:994-1026``), ``CircleProfile`` and ``CollapsedCircleProfile``
(``:1043-1200``), without plots. Peaks come from
:mod:`pylinac_tpu_torch.ops.peaks`, the smoothing from
:mod:`pylinac_tpu_torch.ops.filters` and the spline from
:mod:`pylinac_tpu_torch.ops.interp`, all on the CPU, where the profiles
live. ``SingleProfile.gamma``, the new-style inflection and Hill profiles
and the physical variants wait for the slices that use them.
"""

from __future__ import annotations

import enum
from functools import cached_property

import numpy as np
import torch

from . import array_utils as utils
from .geometry import Circle, Point
from .hill import Hill
from .utilities import convert_to_enum
from ..ops import filters
from ..ops.interp import cubic_spline_interp
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


def _interp1d(xp, fp, kind: str = "linear"):
    """scipy ``interp1d`` equivalent: linear with linear extrapolation, or
    the float32 not-a-knot cubic spline."""
    xp = np.asarray(xp, dtype=float)
    fp = np.asarray(fp, dtype=float)
    if kind == "linear":
        return lambda x: _interp_linear_extrap(x, xp, fp)
    if kind == "cubic":
        def cubic(x):
            out = cubic_spline_interp(torch.from_numpy(xp), torch.from_numpy(fp),
                                      torch.from_numpy(np.atleast_1d(np.asarray(x, np.float32))))
            return out.numpy().reshape(np.shape(x))
        return cubic
    raise ValueError(f"Unknown interpolation kind {kind}")


class ProfileMixin:
    """Manipulations of 1D profile data."""

    values: np.ndarray

    def ground(self) -> float:
        min_val = self.values.min()
        self.values = utils.ground(self.values)
        return min_val

    def filter(self, size: float = 0.05, kind: str = "median") -> None:
        self.values = utils.filter(self.values, size=size, kind=kind)


class Interpolation(enum.Enum):
    NONE = None  #:
    LINEAR = "Linear"  #:
    SPLINE = "Spline"  #:


class Normalization(enum.Enum):
    NONE = None  #:
    GEOMETRIC_CENTER = "Geometric center"  #:
    BEAM_CENTER = "Beam center"  #:
    MAX = "Max"  #:


class Edge(enum.Enum):
    FWHM = "FWHM"  #:
    INFLECTION_DERIVATIVE = "Inflection Derivative"  #:
    INFLECTION_HILL = "Inflection Hill"  #:


class Centering(enum.Enum):
    MANUAL = "Manual"  #:
    BEAM_CENTER = "Beam center"  #:
    GEOMETRIC_CENTER = "Geometric center"  #:


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


class SingleProfile(ProfileMixin):
    """Single-peak profile with dict-based outputs (reference ``:1119``)."""

    def __init__(self, values: np.ndarray, dpmm: float = None,
                 interpolation=Interpolation.LINEAR, ground: bool = True,
                 interpolation_resolution_mm: float = 0.1,
                 interpolation_factor: float = 10,
                 normalization_method=Normalization.BEAM_CENTER,
                 edge_detection_method=Edge.FWHM,
                 edge_smoothing_ratio: float = 0.003,
                 hill_window_ratio: float = 0.1,
                 x_values: np.ndarray | None = None,
                 centering=Centering.BEAM_CENTER):
        self._interp_method = convert_to_enum(interpolation, Interpolation)
        self._interpolation_res = interpolation_resolution_mm
        self._interpolation_factor = interpolation_factor
        self._norm_method = convert_to_enum(normalization_method, Normalization)
        self._edge_method = convert_to_enum(edge_detection_method, Edge)
        self._edge_smoothing_ratio = edge_smoothing_ratio
        self._hill_window_ratio = hill_window_ratio
        self._centering = convert_to_enum(centering, Centering)
        self.values = np.asarray(values)
        self.dpmm = dpmm
        fitted_values, _, x_indices = self._interpolate(
            np.asarray(values), x_values, dpmm, interpolation_resolution_mm,
            interpolation_factor, self._interp_method)
        self.values = fitted_values
        self.x_indices = x_indices
        self._ground = ground
        if ground:
            fitted_values = fitted_values - fitted_values.min()
        self.values = self._normalize(fitted_values, self._norm_method)

    # -- interpolation machinery -------------------------------------------
    def _x_interp_to_original(self, location):
        out = _interp_linear_extrap(location, np.arange(len(self.x_indices)),
                                    self.x_indices)
        return float(out) if np.size(out) == 1 else out

    def _y_original_to_interp(self, location):
        out = _interp_linear_extrap(location, self.x_indices, self.values)
        return float(out) if np.size(out) == 1 else out

    def _sample_points_in_physical_window(self, left_edge: float, right_edge: float):
        lower, upper = sorted((left_edge, right_edge))
        start = int(np.searchsorted(self.x_indices, lower, side="left"))
        stop = int(np.searchsorted(self.x_indices, upper, side="right"))
        if stop - start < 3:
            left_idx = int(np.abs(self.x_indices - lower).argmin())
            right_idx = int(np.abs(self.x_indices - upper).argmin())
            start = min(left_idx, right_idx)
            stop = max(left_idx, right_idx) + 1
        if stop - start < 3:
            center = int(np.abs(self.x_indices - (lower + upper) / 2).argmin())
            start = max(0, center - 1)
            stop = min(len(self.x_indices), start + 3)
            start = max(0, stop - 3)
        x_samples = self.x_indices[start:stop]
        return x_samples, self._y_original_to_interp(x_samples)

    @staticmethod
    def _interpolate(values, x_values, dpmm, interpolation_resolution,
                     interpolation_factor, interp_method: Interpolation):
        """Resample to a fixed resolution with the half-pixel offset
        correction (the reference's 'BMF', ``core/profile.py:1329-1360``)."""
        if x_values is None:
            x_values = np.arange(len(values), dtype=float)
        if np.diff(x_values).min() < 0:
            raise ValueError("Profile values must be monotonically increasing")
        if interp_method == Interpolation.NONE:
            return values, dpmm, x_values
        if dpmm is not None:
            samples = int(round(len(x_values) / (dpmm * interpolation_resolution)))
            new_dpmm = 1 / interpolation_resolution
        else:
            samples = int(round(len(x_values) * interpolation_factor))
            new_dpmm = None
        offset = 0.5 - 1 / (2 * (samples / len(values)))
        kind = "linear" if interp_method == Interpolation.LINEAR else "cubic"
        f = _interp1d(x_values, values, kind=kind)
        new_x = np.linspace(x_values[0] - offset, x_values[-1] + offset, num=samples)
        return np.asarray(f(new_x)), new_dpmm, new_x

    def _normalize(self, values, method: Normalization) -> np.ndarray:
        if method == Normalization.NONE:
            return values
        if method == Normalization.MAX:
            return values / values.max()
        if method == Normalization.GEOMETRIC_CENTER:
            return values / self._geometric_center(values)["value (exact)"]
        # beam_center() reads self.values: set it for the call
        old = self.values
        self.values = values
        try:
            return values / self.beam_center()["value (@rounded)"]
        finally:
            self.values = old if old is not values else values

    def _geometric_center(self, values) -> dict:
        return {
            "index (exact)": self._x_interp_to_original(utils.geometric_center_idx(values)),
            "value (exact)": utils.geometric_center_value(values),
        }

    def _memoized(self, key: tuple, compute):
        """Memoise a computation keyed by a cheap fingerprint of the values,
        so the metric queries (flatness, symmetry, penumbra, width all read
        the field and inflection data) compute it once."""
        cache = getattr(self, "_memo_cache", None)
        if cache is None:
            cache = self._memo_cache = {}
        v = self.values
        # the position-weighted sum catches pure shifts that leave the
        # plain sum and the end samples unchanged
        fp = (v.shape[0], float(v[0]), float(v[-1]),
              float(v[v.shape[0] // 2]), float(v.sum()),
              float(np.dot(np.asarray(v, dtype=np.float64),
                           np.arange(v.shape[0], dtype=np.float64))))
        full_key = (key, fp)
        if full_key not in cache:
            cache[full_key] = compute()
        result = cache[full_key]
        return dict(result) if isinstance(result, dict) else result

    def geometric_center(self) -> dict:
        return self._geometric_center(self.values)

    def beam_center(self) -> dict:
        if self._edge_method == Edge.FWHM:
            data = self.fwxm_data(x=50)
            return {
                "index (rounded)": data["center index (rounded)"],
                "index (exact)": data["center index (exact)"],
                "value (@rounded)": data["center value (@rounded)"],
            }
        infl = self.inflection_data()
        mid = infl["left index (exact)"] + (
            infl["right index (exact)"] - infl["left index (exact)"]) / 2
        return {
            "index (rounded)": int(round(mid)),
            "index (exact)": mid,
            "value (@rounded)": self._y_original_to_interp(int(round(mid))),
        }

    def fwxm_data(self, x: int = 50) -> dict:
        return self._memoized(("fwxm", x), lambda: self._fwxm_data(x))

    def _fwxm_data(self, x: int = 50) -> dict:
        _, peak_props = find_peaks(self.values, fwxm_height=x / 100, max_number=1)
        left_idx = float(self._x_interp_to_original(peak_props["left_ips"][0]))
        right_idx = float(self._x_interp_to_original(peak_props["right_ips"][0]))
        width = right_idx - left_idx
        center_idx = (right_idx - left_idx) / 2 + left_idx
        data = {
            "width (exact)": width,
            "width (rounded)": int(round(width)),
            "center index (rounded)": int(round(center_idx)),
            "center index (exact)": center_idx,
            "center value (@rounded)": float(self._y_original_to_interp(int(round(center_idx)))),
            "left index (exact)": left_idx,
            "left index (rounded)": int(round(left_idx)),
            "left value (@rounded)": float(self._y_original_to_interp(int(round(left_idx)))),
            "right index (exact)": right_idx,
            "right index (rounded)": int(round(right_idx)),
            "right value (@rounded)": float(self._y_original_to_interp(int(round(right_idx)))),
            "field values": self._y_original_to_interp(
                self.x_indices[int(round(left_idx)): int(round(right_idx))]),
            "peak_props": peak_props,
        }
        if self.dpmm:
            data["width (exact) mm"] = data["width (exact)"] / self.dpmm
            data["left distance (exact) mm"] = abs(
                data["center index (exact)"] - data["left index (exact)"]) / self.dpmm
            data["right distance (exact) mm"] = abs(
                data["right index (exact)"] - data["center index (exact)"]) / self.dpmm
        return data

    def field_data(self, in_field_ratio: float = 0.8, slope_exclusion_ratio=0.2) -> dict:
        return self._memoized(
            ("field", in_field_ratio, slope_exclusion_ratio),
            lambda: self._field_data(in_field_ratio, slope_exclusion_ratio))

    def _field_data(self, in_field_ratio: float = 0.8, slope_exclusion_ratio=0.2) -> dict:
        if slope_exclusion_ratio >= in_field_ratio:
            raise ValueError("The exclusion region must be smaller than the field ratio")
        if self._edge_method == Edge.FWHM:
            data = self.fwxm_data(x=50)
            beam_center_idx = data["center index (exact)"]
            full_width = data["width (exact)"]
        else:
            data = self.inflection_data()
            beam_center_idx = self.beam_center()["index (exact)"]
            full_width = data["right index (exact)"] - data["left index (exact)"]
        beam_center_idx_r = int(round(beam_center_idx))
        cax_idx = self.geometric_center()["index (exact)"]
        cax_idx_r = int(round(cax_idx))

        center_idx = cax_idx if self._centering == Centering.GEOMETRIC_CENTER else beam_center_idx

        field_left_idx = center_idx - in_field_ratio * full_width / 2
        field_right_idx = center_idx + in_field_ratio * full_width / 2
        field_width = field_right_idx - field_left_idx

        inner_left_idx = center_idx - slope_exclusion_ratio * field_width / 2
        inner_right_idx = center_idx + slope_exclusion_ratio * field_width / 2

        left_x, left_y = self._sample_points_in_physical_window(field_left_idx, inner_left_idx)
        right_x, right_y = self._sample_points_in_physical_window(inner_right_idx, field_right_idx)
        left_fit = np.polyfit(left_x, left_y, deg=1)
        right_fit = np.polyfit(right_x, right_y, deg=1)

        top_x, top_y = self._sample_points_in_physical_window(inner_left_idx, inner_right_idx)
        fit_params = np.polyfit(top_x, top_y, deg=2)
        # the parabola's vertex, clipped to the window (the reference
        # minimises the negative polynomial within bounds)
        if fit_params[0] != 0:
            vertex = -fit_params[1] / (2 * fit_params[0])
        else:
            vertex = (top_x[0] + top_x[-1]) / 2
        if fit_params[0] < 0:  # opens downward: the interior vertex is the max
            top_idx = float(np.clip(vertex, top_x[0], top_x[-1]))
        else:  # opens upward: the max is at one of the ends
            y_ends = np.polyval(fit_params, [top_x[0], top_x[-1]])
            top_idx = float(top_x[0] if y_ends[0] >= y_ends[1] else top_x[-1])
        top_val = float(np.polyval(fit_params, top_idx))

        pixel_offset = center_idx - int(round(center_idx))
        x_shifted = self.x_indices + pixel_offset
        x_index_min = int(np.abs(x_shifted - field_left_idx).argmin())
        x_index_max = int(np.abs(x_shifted - field_right_idx).argmin())

        data = {
            "width (exact)": field_width,
            "beam center index (exact)": beam_center_idx,
            "beam center index (rounded)": beam_center_idx_r,
            "beam center value (@rounded)": self._y_original_to_interp(round(beam_center_idx)),
            "cax index (exact)": cax_idx,
            "cax index (rounded)": cax_idx_r,
            "cax value (@rounded)": self._y_original_to_interp(round(cax_idx)),
            "left index (exact)": field_left_idx,
            "left index (rounded)": int(round(field_left_idx)),
            "left value (@rounded)": self._y_original_to_interp(round(field_left_idx)),
            "left slope": left_fit[0],
            "left intercept": left_fit[1],
            "right slope": right_fit[0],
            "right intercept": right_fit[1],
            "left inner index (exact)": inner_left_idx,
            "left inner index (rounded)": int(round(inner_left_idx)),
            "right inner index (exact)": inner_right_idx,
            "right inner index (rounded)": int(round(inner_right_idx)),
            '"top" index (exact)': top_idx,
            '"top" index (rounded)': int(round(top_idx)),
            '"top" value (@exact)': top_val,
            "top params": fit_params,
            "right index (exact)": field_right_idx,
            "right index (rounded)": int(round(field_right_idx)),
            "right value (@rounded)": self._y_original_to_interp(round(field_right_idx)),
            "field values": self._y_original_to_interp(x_shifted[x_index_min: x_index_max + 1]),
        }
        if self.dpmm:
            data["width (exact) mm"] = data["width (exact)"] / self.dpmm
            data["left slope (%/mm)"] = data["left slope"] * self.dpmm * 100
            data["right slope (%/mm)"] = data["right slope"] * self.dpmm * 100
            data["left distance->beam center (exact) mm"] = abs(
                beam_center_idx - field_left_idx) / self.dpmm
            data["right distance->beam center (exact) mm"] = abs(
                field_right_idx - beam_center_idx) / self.dpmm
            data["left distance->CAX (exact) mm"] = abs(cax_idx - field_left_idx) / self.dpmm
            data["right distance->CAX (exact) mm"] = abs(cax_idx - field_right_idx) / self.dpmm
            data["left distance->top (exact) mm"] = abs(top_idx - field_left_idx) / self.dpmm
            data["right distance->top (exact) mm"] = abs(top_idx - field_right_idx) / self.dpmm
            data['"top"->beam center (exact) mm'] = (top_idx - beam_center_idx) / self.dpmm
            data['"top"->CAX (exact) mm'] = abs(top_idx - cax_idx) / self.dpmm
        return data

    def inflection_data(self) -> dict:
        return self._memoized(("inflection",), self._inflection_data)

    def _inflection_data(self) -> dict:
        if self._edge_method == Edge.FWHM:
            raise ValueError(
                "FWHM edge method does not have inflection points. Use a different edge detection method")
        smoothed = filters.gaussian_filter1d(
            torch.from_numpy(np.asarray(self.values, np.float32)),
            sigma=self._edge_smoothing_ratio * len(self.values))
        d1 = np.gradient(smoothed.numpy())
        peak_idxs, _ = MultiProfile(d1).find_peaks(threshold=0.8)
        valley_idxs, _ = MultiProfile(d1).find_valleys(threshold=0.8)
        left_idx = self._x_interp_to_original(peak_idxs[0])
        right_idx = self._x_interp_to_original(valley_idxs[-1])
        if self._edge_method == Edge.INFLECTION_DERIVATIVE:
            return {
                "left index (rounded)": int(round(left_idx)),
                "left index (exact)": left_idx,
                "right index (rounded)": int(round(right_idx)),
                "right index (exact)": right_idx,
                "left value (@rounded)": self._y_original_to_interp(int(round(left_idx))),
                "left value (@exact)": self._y_original_to_interp(left_idx),
                "right value (@rounded)": self._y_original_to_interp(int(round(right_idx))),
                "right value (@exact)": self._y_original_to_interp(right_idx),
            }
        # Hill: a sigmoid fitted around each derivative edge
        half_window = int(round(self._hill_window_ratio * abs(right_idx - left_idx) / 2))
        x_data = np.array([x for x in np.arange(left_idx - half_window,
                                                left_idx + half_window) if x >= 0])
        left_hill = Hill.fit(x_data, self._y_original_to_interp(x_data))
        left_infl = left_hill.inflection_idx()
        x_data = np.array([x for x in np.arange(right_idx - half_window,
                                                right_idx + half_window) if x < len(d1)])
        right_hill = Hill.fit(x_data, self._y_original_to_interp(x_data))
        right_infl = right_hill.inflection_idx()
        return {
            "left index (rounded)": left_infl["index (rounded)"],
            "left index (exact)": left_infl["index (exact)"],
            "right index (rounded)": right_infl["index (rounded)"],
            "right index (exact)": right_infl["index (exact)"],
            "left value (@exact)": left_hill.y(left_infl["index (exact)"]),
            "right value (@exact)": right_hill.y(right_infl["index (exact)"]),
            "left Hill params": left_hill.params,
            "right Hill params": right_hill.params,
        }

    def penumbra(self, lower: int = 20, upper: int = 80) -> dict:
        if lower > upper:
            raise ValueError("Upper penumbra value must be larger than the lower")
        if self._edge_method == Edge.FWHM:
            upper_data = self.fwxm_data(x=upper)
            lower_data = self.fwxm_data(x=lower)
            data = {
                f"left {lower}% index (exact)": lower_data["left index (exact)"],
                f"left {lower}% value (@rounded)": lower_data["left value (@rounded)"],
                f"left {upper}% index (exact)": upper_data["left index (exact)"],
                f"left {upper}% value (@rounded)": upper_data["left value (@rounded)"],
                f"right {lower}% index (exact)": lower_data["right index (exact)"],
                f"right {lower}% value (@rounded)": lower_data["right value (@rounded)"],
                f"right {upper}% index (exact)": upper_data["right index (exact)"],
                f"right {upper}% value (@rounded)": upper_data["right value (@rounded)"],
                "left values": self.values[lower_data["left index (rounded)"]: upper_data["left index (rounded)"]],
                "right values": self.values[upper_data["right index (rounded)"]: lower_data["right index (rounded)"]],
                "left penumbra width (exact)": abs(
                    upper_data["left index (exact)"] - lower_data["left index (exact)"]),
                "right penumbra width (exact)": abs(
                    upper_data["right index (exact)"] - lower_data["right index (exact)"]),
            }
            if self.dpmm:
                data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
                data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            return data
        if self._edge_method == Edge.INFLECTION_DERIVATIVE:
            infl = self.inflection_data()
            vmax = self.values.max()
            lower_left_pct = max(infl["left value (@exact)"] / vmax * lower / 50 * 100, 1)
            upper_left_pct = min(infl["left value (@exact)"] / vmax * upper / 50 * 100, 99)
            upper_left = self.fwxm_data(x=upper_left_pct)
            lower_left = self.fwxm_data(x=lower_left_pct)
            lower_right_pct = max(infl["right value (@exact)"] / vmax * lower / 50 * 100, 1)
            upper_right_pct = min(infl["right value (@exact)"] / vmax * upper / 50 * 100, 99)
            upper_right = self.fwxm_data(x=upper_right_pct)
            lower_right = self.fwxm_data(x=lower_right_pct)
            data = {
                f"left {lower}% index (exact)": lower_left["left index (exact)"],
                f"left {upper}% index (exact)": upper_left["left index (exact)"],
                f"right {lower}% index (exact)": lower_right["right index (exact)"],
                f"right {upper}% index (exact)": upper_right["right index (exact)"],
                "left values": self._y_original_to_interp(np.arange(
                    lower_left["left index (rounded)"], upper_left["left index (rounded)"])),
                "right values": self._y_original_to_interp(np.arange(
                    upper_right["right index (rounded)"], lower_right["right index (rounded)"])),
                "left penumbra width (exact)": abs(
                    upper_left["left index (exact)"] - lower_left["left index (exact)"]),
                "right penumbra width (exact)": abs(
                    upper_right["right index (exact)"] - lower_right["right index (exact)"]),
            }
            if self.dpmm:
                data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
                data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            return data
        # INFLECTION_HILL
        infl = self.inflection_data()
        left_hill = Hill.from_params(infl["left Hill params"])
        right_hill = Hill.from_params(infl["right Hill params"])
        lower_left_pct = infl["left value (@exact)"] * lower / 50
        lower_left_idx = left_hill.x(lower_left_pct)
        upper_left_pct = infl["left value (@exact)"] * upper / 50
        upper_left_idx = left_hill.x(upper_left_pct)
        lower_right_val = infl["right value (@exact)"] * lower / 50
        lower_right_idx = right_hill.x(lower_right_val)
        upper_right_val = infl["right value (@exact)"] * upper / 50
        upper_right_idx = right_hill.x(upper_right_val)
        data = {
            f"left {lower}% index (exact)": lower_left_idx,
            f"left {lower}% value (exact)": lower_left_pct,
            f"left {upper}% index (exact)": upper_left_idx,
            f"left {upper}% value (exact)": upper_left_pct,
            f"right {lower}% index (exact)": lower_right_idx,
            f"right {lower}% value (exact)": lower_right_val,
            f"right {upper}% index (exact)": upper_right_idx,
            f"right {upper}% value (exact)": upper_right_val,
            "left values": self.values[int(round(lower_left_idx)): int(round(upper_left_idx))],
            "right values": self.values[int(round(upper_right_idx)): int(round(lower_right_idx))],
            "left penumbra width (exact)": abs(upper_left_idx - lower_left_idx),
            "right penumbra width (exact)": abs(upper_right_idx - lower_right_idx),
            "left gradient (exact)": left_hill.gradient_at(infl["left index (exact)"]),
            "right gradient (exact)": right_hill.gradient_at(infl["right index (exact)"]),
        }
        if self.dpmm:
            data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
            data["left gradient (exact) %/mm"] = data["left gradient (exact)"] * self.dpmm * 100
            data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            data["right gradient (exact) %/mm"] = data["right gradient (exact)"] * self.dpmm * 100
        return data

    def field_calculation(self, in_field_ratio: float = 0.8, calculation: str = "mean",
                          slope_exclusion_ratio: float = 0.2):
        field = self.field_data(in_field_ratio, slope_exclusion_ratio=slope_exclusion_ratio)
        vals = field["field values"]
        if calculation == "mean":
            return vals.mean()
        if calculation == "median":
            return float(np.median(vals))
        if calculation == "max":
            return vals.max()
        if calculation == "min":
            return vals.min()
        raise ValueError(f"Unknown calculation {calculation}")


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
