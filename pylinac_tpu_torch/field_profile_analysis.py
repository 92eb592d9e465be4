"""Field analysis through the profile metric plugins.

Port of ``pylinac_tpu/field_profile_analysis.py:47-180``:
``FieldProfileResult``, ``DEFAULT_METRICS``, ``PROFILES`` and
``FieldProfileAnalysis``, which pulls an X and a Y profile from an image at
a chosen centre and width and runs the plugins of
:mod:`pylinac_tpu_torch.metrics.profile` on each. Host numpy in both
packages: the path reaches no kernel, so ``analyze`` takes no device. The
plots, ``plotly_analyzed_images`` and ``publish_pdf`` wait for ROADMAP
item 11 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Sequence

import numpy as np

from .core import image
from .core.exceptions import NotAnalyzed
from .core.geometry import Point, Rectangle
from .core.profile import (
    Centering,
    Edge,
    FWXMProfilePhysical,
    HillProfilePhysical,
    InflectionDerivativeProfilePhysical,
    Normalization,
)
from .core.roi import RectangleROI
from .core.utilities import ResultBase, ResultsDataMixin, convert_to_enum, not_ported
from .core.warnings import capture_warnings
from .metrics.profile import (
    CAXToLeftEdgeMetric,
    CAXToRightEdgeMetric,
    FlatnessDifferenceMetric,
    PenumbraLeftMetric,
    PenumbraRightMetric,
    ProfileMetric,
    SymmetryPointDifferenceMetric,
)


@dataclasses.dataclass(kw_only=True)
class FieldProfileResult(ResultBase):
    """The JAX model's fields in its order."""

    x_metrics: dict
    y_metrics: dict
    center: dict
    normalization: str
    edge_type: str
    centering: str


DEFAULT_METRICS = (
    FlatnessDifferenceMetric(),
    SymmetryPointDifferenceMetric(),
    PenumbraRightMetric(),
    PenumbraLeftMetric(),
    CAXToLeftEdgeMetric(),
    CAXToRightEdgeMetric(),
)
PROFILES = {
    Edge.FWHM: FWXMProfilePhysical,
    Edge.INFLECTION_HILL: HillProfilePhysical,
    Edge.INFLECTION_DERIVATIVE: InflectionDerivativeProfilePhysical,
}


@capture_warnings
@not_ported("plot_analyzed_images", "plotly_analyzed_images", "publish_pdf")
class FieldProfileAnalysis(ResultsDataMixin):
    """Field analysis through profile metric plugins."""

    _is_analyzed: bool = False

    def __init__(self, path: str | Path, **kwargs):
        super().__init__()
        self.image = image.load(path, **kwargs)
        self.image.check_inversion_by_histogram()

    def analyze(
        self,
        centering: Centering | str = Centering.BEAM_CENTER,
        position: tuple[float, float] = (0.5, 0.5),
        x_width: float = 0.0,
        y_width: float = 0.0,
        normalization: Normalization | str = Normalization.NONE,
        edge_type: Edge | str = Edge.INFLECTION_DERIVATIVE,
        invert: bool = False,
        ground: bool = True,
        metrics: Sequence[ProfileMetric] = DEFAULT_METRICS,
        **kwargs,
    ) -> None:
        """Pull the X and Y profiles at ``position`` with relative widths
        and compute each metric plugin on them."""
        if invert:
            self.image.invert()
        self._normalization = convert_to_enum(normalization, Normalization)
        self._edge_type = convert_to_enum(edge_type, Edge)
        self._centering = convert_to_enum(centering, Centering)

        x_values, y_values = self._get_profile_values(position, x_width, y_width)

        profile_cls = PROFILES[self._edge_type]
        self.x_profile = profile_cls(
            values=x_values, dpmm=self.image.dpmm,
            normalization=self._normalization, ground=ground, **kwargs)
        self.x_profile.compute(metrics=metrics)
        self.y_profile = profile_cls(
            values=y_values, dpmm=self.image.dpmm,
            normalization=self._normalization, ground=ground, **kwargs)
        # a deep copy, so that the y pass keeps the x pass's plugin state
        self.y_profile.compute(metrics=copy.deepcopy(metrics))
        self._is_analyzed = True

    def _get_x_y_position(self, position: tuple[float, float]) -> tuple[float, float]:
        if self._centering != Centering.MANUAL:
            v_sum = self.image.array.sum(axis=0)
            h_sum = self.image.array.sum(axis=1)
            profile_cls = PROFILES[self._edge_type]
            v_p = profile_cls(values=v_sum, dpmm=self.image.dpmm)
            h_p = profile_cls(values=h_sum, dpmm=self.image.dpmm)
            if self._centering == Centering.BEAM_CENTER:
                return v_p.center_idx, h_p.center_idx
            return v_p.cax_index, h_p.cax_index  # geometric centre
        if len(position) != 2:
            raise ValueError("Position must be a tuple of two values")
        if any(p < 0 or p > 1 for p in position):
            raise ValueError("Position values must be between 0 and 1")
        # (height, width) relative position -> (x=col, y=row)
        return self.image.shape[1] * position[1], self.image.shape[0] * position[0]

    def _get_profile_values(self, position: tuple[float, float], x_width: float,
                            y_width: float) -> tuple[np.ndarray, np.ndarray]:
        x, y = self._get_x_y_position(position)
        if not (0 <= x_width <= 1) or not (0 <= y_width <= 1):
            raise ValueError("Width must be between 0 and 1")
        # at least 2 rows or columns are always averaged
        top = round(y - self.image.shape[0] * x_width / 2 - 1)
        bottom = round(max(y + self.image.shape[0] * x_width / 2, top + 2))
        left = round(x - self.image.shape[1] * y_width / 2 - 1)
        right = round(max(x + self.image.shape[1] * y_width / 2, left + 2))
        x_box = self.image[top:bottom, :]
        y_box = self.image[:, left:right]
        self.x_rect = Rectangle(width=x_box.shape[1] * 2, height=x_box.shape[0],
                                center=(x, y))
        self.y_rect = Rectangle(width=y_box.shape[1], height=y_box.shape[0] * 2,
                                center=(x, y))
        self.center_rect = RectangleROI(
            array=self.image.array, width=right - left, height=bottom - top,
            center=Point(x, y))
        return x_box.mean(axis=0), y_box.mean(axis=1)

    def _generate_results_data(self) -> FieldProfileResult:
        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        return FieldProfileResult(
            edge_type=str(self._edge_type.value),
            normalization=str(self._normalization.value),
            centering=str(self._centering.value),
            x_metrics=self.x_profile.metric_values | {
                "Field Width (mm)": self.x_profile.field_width_mm,
                "values": np.asarray(self.x_profile.values).tolist(),
            },
            y_metrics=self.y_profile.metric_values | {
                "Field Width (mm)": self.y_profile.field_width_mm,
                "values": np.asarray(self.y_profile.values).tolist(),
            },
            center={
                "mean": self.center_rect.mean,
                "stdev": self.center_rect.std,
                "min": self.center_rect.min,
                "max": self.center_rect.max,
            },
        )

    def results(self) -> str:
        d = self.results_data(as_dict=True)
        s = ""
        for key, value in d.items():
            if isinstance(value, dict):
                s += f"{key}:\n"
                for k, v in value.items():
                    if not isinstance(v, list):
                        s += f"{k}: {v}\n"
            else:
                s += f"{key}: {value}\n"
        return s
