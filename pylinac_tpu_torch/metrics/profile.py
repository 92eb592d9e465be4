"""Profile-attached plugin metrics: flatness, symmetry, penumbra,
CAX-to-edge, FFF top distance, slope, Dmax and PDD.

Port of ``pylinac_tpu/metrics/profile.py`` (``ProfileMetric`` ``:18`` and
the thirteen metrics after it), host numpy in both packages, the float64
``np.polyfit`` fits included. ``ProfileMetric.plot`` draws nothing, as
JAX's (``:34``) does, and no metric overrides it in either package.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Any, Literal

import numpy as np

LEFT = "left"
RIGHT = "right"


class ProfileMetric(ABC):
    """Base class of the metrics computed on a profile."""

    name: str
    unit: str = ""

    def __init__(self, color: str | None = None, linestyle: str | None = None):
        self.color = color
        self.linestyle = linestyle

    @property
    def full_name(self) -> str:
        return f"{self.name} ({self.unit})" if self.unit else self.name

    def inject_profile(self, profile) -> None:
        self.profile = profile

    def plot(self, axis) -> None:
        pass

    @abstractmethod
    def calculate(self) -> Any:
        pass


class FlatnessDifferenceMetric(ProfileMetric):
    """IAEA flatness: 100·(max-min)/(max+min) over the in-field region."""

    name = "Flatness (Difference)"
    unit = "%"

    def __init__(self, in_field_ratio: float = 0.8, color="g", linestyle="-."):
        self.in_field_ratio = in_field_ratio
        super().__init__(color=color, linestyle=linestyle)

    def calculate(self) -> float:
        v = self.profile.field_values(self.in_field_ratio)
        return 100 * (v.max() - v.min()) / (v.max() + v.min())


class FlatnessRatioMetric(FlatnessDifferenceMetric):
    """IEC flatness: 100·max/min."""

    name = "Flatness (Ratio)"

    def calculate(self) -> float:
        v = self.profile.field_values(self.in_field_ratio)
        return 100 * v.max() / v.min()


class SymmetryPointDifferenceMetric(ProfileMetric):
    """Max point difference symmetry (Varian-style)."""

    unit = "%"
    name = "Point Difference Symmetry"

    def __init__(self, in_field_ratio: float = 0.8, color="magenta", linestyle="--",
                 max_sym_range: float = 2, min_sym_range: float = -2):
        self.in_field_ratio = in_field_ratio
        self.max_sym = max_sym_range
        self.min_sym = min_sym_range
        super().__init__(color=color, linestyle=linestyle)

    @staticmethod
    def _calc_point(lt: float, rt: float, cax: float) -> float:
        return 100 * (lt - rt) / cax

    @property
    def symmetry_values(self) -> list[float]:
        field_values = self.profile.field_values(in_field_ratio=self.in_field_ratio)
        cax_value = self.profile.y_at_x(self.profile.center_idx)
        return [self._calc_point(lt, rt, cax_value)
                for lt, rt in zip(field_values, field_values[::-1])]

    def calculate(self) -> float:
        vals = self.symmetry_values
        return vals[int(np.argmax(np.abs(vals)))]


class SymmetryPointDifferenceQuotientMetric(SymmetryPointDifferenceMetric):
    """IEC point-difference-quotient symmetry: 100·max(lt/rt, rt/lt)."""

    name = "Point Difference Quotient Symmetry"

    def __init__(self, in_field_ratio: float = 0.8, color="magenta", linestyle="--",
                 max_sym_range: float = 105, min_sym_range: float = 100):
        super().__init__(in_field_ratio, color, linestyle, max_sym_range, min_sym_range)

    @staticmethod
    def _calc_point(lt: float, rt: float, cax: float) -> float:
        return 100 * max((lt / rt), (rt / lt))


class SymmetryAreaMetric(ProfileMetric):
    """Symmetry via left/right area ratio."""

    name = "Symmetry (Area)"

    def __init__(self, in_field_ratio: float = 0.8):
        self.in_field_ratio = in_field_ratio

    def calculate(self) -> float:
        _, _, width = self.profile.field_indices(in_field_ratio=self.in_field_ratio)
        values = self.profile.field_values(self.in_field_ratio)
        area_left = np.sum(values[: math.floor(width / 2) + 1])
        area_right = np.sum(values[math.ceil(width / 2):])
        return 100 * (area_left - area_right) / (area_left + area_right)


class PenumbraLeftMetric(ProfileMetric):
    """Left penumbra width in mm, edge assumed at 50% height."""

    unit = "mm"
    name = "Left Penumbra"
    side = LEFT

    def __init__(self, lower: float = 20, upper: float = 80, color="pink", ls="-."):
        self.lower = lower
        self.upper = upper
        super().__init__(color=color, linestyle=ls)

    def calculate(self) -> float:
        edge = self.profile.field_edge_idx(side=self.side)
        edge_value = self.profile.y_at_x(edge)
        lower_index = self.profile.x_at_y(y=edge_value * 2 * self.lower / 100, side=self.side)
        upper_index = self.profile.x_at_y(y=edge_value * 2 * self.upper / 100, side=self.side)
        self.lower_index = lower_index
        self.upper_index = upper_index
        return abs(upper_index - lower_index) / self.profile.dpmm


class PenumbraRightMetric(PenumbraLeftMetric):
    side = RIGHT
    name = "Right Penumbra"


class CAXToLeftEdgeMetric(ProfileMetric):
    name = "CAX to Left Beam Edge"
    unit = "mm"

    def __init__(self, color="cyan", linestyle="--"):
        super().__init__(color=color, linestyle=linestyle)

    def calculate(self) -> float:
        return (self.profile.cax_index - self.profile.field_edge_idx(side=LEFT)) / self.profile.dpmm


class CAXToRightEdgeMetric(CAXToLeftEdgeMetric):
    name = "CAX to Right Beam Edge"

    def calculate(self) -> float:
        return (self.profile.field_edge_idx(side=RIGHT) - self.profile.cax_index) / self.profile.dpmm


class TopDistanceMetric(ProfileMetric):
    """FFF 'top' to field center distance in mm (NCS-33-like)."""

    name = "Top Distance"
    unit = "mm"

    def __init__(self, top_region_ratio: float = 0.2, color="orange"):
        self.top_region_ratio = top_region_ratio
        super().__init__(color=color)

    def calculate(self) -> float:
        values = self.profile.field_values(in_field_ratio=self.top_region_ratio)
        left, right, _ = self.profile.field_indices(in_field_ratio=self.top_region_ratio)
        xs = np.arange(left, right + 1)
        fit_params = np.polyfit(xs, values, deg=2)
        # bounded maximum of the quadratic
        if fit_params[0] < 0:
            vertex = -fit_params[1] / (2 * fit_params[0])
            top_idx = float(np.clip(vertex, left, right))
        else:
            ends = np.polyval(fit_params, [left, right])
            top_idx = float(left if ends[0] >= ends[1] else right)
        self.top_idx = top_idx
        self.top_values = np.polyval(fit_params, xs)
        return (top_idx - self.profile.center_idx) / self.profile.dpmm


class SlopeMetric(ProfileMetric):
    """Mean in-field slope (%/mm) for FFF beams."""

    name = "In-Field Slope"
    unit = "%/mm"

    def __init__(self, ratio_edges: tuple[float, float] = (0.2, 0.8), color="cyan"):
        if len(ratio_edges) != 2:
            raise ValueError("The ratio_edges parameter must be a tuple of two floats.")
        if ratio_edges[0] >= ratio_edges[1]:
            raise ValueError("The first ratio edge must be less than the second.")
        self.ratio_edges = ratio_edges
        super().__init__(color=color)

    def calculate(self) -> float:
        inner_left, inner_right, _ = self.profile.field_indices(in_field_ratio=self.ratio_edges[0])
        outer_left, outer_right, _ = self.profile.field_indices(in_field_ratio=self.ratio_edges[1])
        left_indices = np.arange(outer_left, inner_left)
        right_indices = np.arange(inner_right, outer_right)
        left_values = self.profile.y_at_x(left_indices)
        right_values = self.profile.y_at_x(right_indices)
        combined = [(lt + rt) / 2 for lt, rt in zip(left_values, right_values[::-1])]
        scaled = np.array(combined) / self.profile.y_at_x(self.profile.center_idx)
        fit = np.polyfit(np.arange(len(combined)) / self.profile.dpmm, scaled, deg=1)
        self.raw_combined_values = np.array(combined)
        self.left_indices = left_indices
        self.right_indices = right_indices
        return float(fit[0])


class Dmax(ProfileMetric):
    """Depth of maximum dose via a windowed polynomial fit."""

    name = "Dmax"
    unit = "mm"

    def __init__(self, window_mm: float = 20, poly_order: int = 5,
                 color=None, linestyle="-."):
        super().__init__(color=color, linestyle=linestyle)
        self.window_mm = window_mm
        self.poly_order = poly_order

    def _window_fit(self, window_mm: float, depth_mm: float, poly_order: int):
        half = window_mm / 2
        start = max(depth_mm - half, 0)
        end = min(depth_mm + half, self.profile.x_values.max())
        if abs(start - end) <= half or start > end:
            raise ValueError(
                f"The PDD/Dmax metric at {depth_mm} has a window at or past an edge; "
                "make the window smaller or adjust the depth.")
        fit_x = np.arange(start, end + 1, 0.1)
        fit_y = self.profile.y_at_x(fit_x)
        # a least-squares polynomial smoother of the window
        coeffs = np.polyfit(fit_x, fit_y, deg=min(self.poly_order, len(fit_x) - 1))
        return (lambda x: np.polyval(coeffs, x)), fit_x

    def calculate(self) -> float:
        dmax_idx = int(np.argmax(self.profile.values))
        appr_dmax_mm = self.profile.x_values[dmax_idx]
        f, fit_x = self._window_fit(self.window_mm, appr_dmax_mm, self.poly_order)
        dense = np.linspace(fit_x.min(), fit_x.max(), 4001)
        yd = f(dense)
        i = int(np.argmax(yd))
        self.fit_x = fit_x
        self.fit_y = f(fit_x)
        self.point_x = float(dense[i])
        self.point_y = float(yd[i])
        return self.point_x


class PDD(Dmax):
    """Percent depth dose at a given depth, normalized to (fitted) Dmax."""

    unit = "%"

    @property
    def name(self):
        return f"PDD@{self.depth_mm}mm"

    def __init__(self, depth_mm: float, window_mm: float = 10, poly_order: int = 2,
                 normalize_to: Literal["fit", "max"] = "fit",
                 dmax_window_mm: float = 20, dmax_poly_order: int = 5,
                 color=None, linestyle="-."):
        super().__init__(color=color, linestyle=linestyle, window_mm=window_mm,
                         poly_order=poly_order)
        self.depth_mm = depth_mm
        self.normalize_to = normalize_to
        self.dmax_window = dmax_window_mm
        self.dmax_poly_order = dmax_poly_order

    def calculate(self) -> float:
        f, fit_x = self._window_fit(self.window_mm, self.depth_mm, self.poly_order)
        self.fit_x = fit_x
        self.fit_y = f(fit_x)
        self.point_x = self.depth_mm
        self.point_y = float(f(self.depth_mm))
        if self.normalize_to == "fit":
            dmax = Dmax(window_mm=self.dmax_window, poly_order=self.dmax_poly_order)
            dmax.inject_profile(self.profile)
            dmax.calculate()
            s = self.point_y / dmax.point_y
        elif self.normalize_to == "max":
            s = self.point_y / self.profile.values.max()
        else:
            raise ValueError("normalize_to must be 'fit' or 'max'")
        return s * 100
