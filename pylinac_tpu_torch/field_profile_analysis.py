"""Field analysis through the profile metric plugins.

Port of ``pylinac_tpu/field_profile_analysis.py:47-180``:
``FieldProfileResult``, ``DEFAULT_METRICS``, ``PROFILES`` and
``FieldProfileAnalysis``, which pulls an X and a Y profile from an image at
a chosen centre and width and runs the plugins of
:mod:`pylinac_tpu_torch.metrics.profile` on each. Host numpy in both
packages: the path reaches no kernel, so ``analyze`` takes no device. The
reports are JAX's (``:194-306``): ``plotly_analyzed_images`` needs no
matplotlib; ``plot_analyzed_images`` and ``publish_pdf`` (which embeds the
plots' PNGs) import it inside.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import webbrowser
from pathlib import Path
from typing import Sequence

import numpy as np

from .core import image, pdf
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
from .core.utilities import ResultBase, ResultsDataMixin, convert_to_enum
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

    def plot_analyzed_images(self, show: bool = True, mirror: str | None = None,
                             grid: bool = True, **kwargs) -> list:
        import matplotlib.pyplot as plt

        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        figs = []
        for profile, name in ((self.x_profile, "X"), (self.y_profile, "Y")):
            fig, ax = plt.subplots()
            profile.plot(axis=ax, show=False)
            ax.set_title(f"{name} profile")
            if grid:
                ax.grid(True, alpha=0.3)
            figs.append(fig)
        ifig, iax = plt.subplots()
        iax.imshow(self.image.array, cmap="gray")
        for rect, color in ((self.x_rect, "b"), (self.y_rect, "g")):
            iax.add_patch(plt.Rectangle(
                (rect.center.x - rect.width / 2, rect.center.y - rect.height / 2),
                rect.width, rect.height, edgecolor=color, fill=False, alpha=0.3))
        iax.add_patch(plt.Rectangle(
            (self.center_rect.center.x - self.center_rect.width / 2,
             self.center_rect.center.y - self.center_rect.height / 2),
            self.center_rect.width, self.center_rect.height,
            edgecolor="r", fill=False, alpha=0.3, label="Center ROI"))
        figs.append(ifig)
        if show:
            plt.show()
        return figs

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`): the X and Y
        profiles and the image with the sampling ROIs, ``{name: Figure}``."""
        from .core import plotly_utils as pu

        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        figs: dict[str, pu.Figure] = {}
        for profile, name in ((self.x_profile, "X"), (self.y_profile, "Y")):
            fig = pu.Figure()
            fig.add_trace(pu.scatter_trace(profile.x_values, profile.values,
                                           name=f"{name} profile"))
            pu.add_title(fig, f"{name} profile")
            fig.update_layout(showlegend=show_legend)
            figs[f"{name} Profile"] = fig
        ifig = pu.image_figure(self.image.array, title="Image",
                               show_colorbar=show_colorbar, **kwargs)
        shapes = ifig.layout.setdefault("shapes", [])
        for rect, color in ((self.x_rect, "blue"), (self.y_rect, "green"),
                            (self.center_rect, "red")):
            shapes.append({
                "type": "rect",
                "x0": rect.center.x - rect.width / 2,
                "x1": rect.center.x + rect.width / 2,
                "y0": rect.center.y - rect.height / 2,
                "y1": rect.center.y + rect.height / 2,
                "line": {"color": color}, "opacity": 0.5})
        figs["Image"] = ifig
        if show:
            for f in figs.values():
                f.show()
        return figs

    def publish_pdf(self, filename: str, notes: str | list[str] | None = None,
                    open_file: bool = False, metadata: dict | None = None,
                    logo=None, plot_kwargs: dict | None = None) -> None:
        import matplotlib.pyplot as plt

        plt.ioff()
        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        canvas = pdf.PylinacCanvas(filename, page_title="Field Analysis",
                                   metadata=metadata, metadata_location=(2, 5),
                                   logo=logo)
        data = self.results_data(as_dict=True, by_alias=True,
                                 exclude={"pylinac_version"})
        data["x_metrics"].pop("values")
        data["y_metrics"].pop("values")
        offset = 0.0
        for key, value in data.items():
            if isinstance(value, str):
                canvas.add_text(text=f"{key}: {value}", location=(1, 25 - offset),
                                font_size=12)
                offset += 0.75
            elif isinstance(value, dict):
                canvas.add_text(text=f"{key}:", location=(1, 25 - offset),
                                font_size=12)
                offset += 0.75
                for subkey, subvalue in value.items():
                    try:
                        text = f"{subkey}: {subvalue:.3f}"
                    except (TypeError, ValueError):
                        text = f"{subkey}: {subvalue}"
                    canvas.add_text(text=text, location=(2, 25 - offset),
                                    font_size=12)
                    offset += 0.75
        plot_kwargs = plot_kwargs or {}
        figs = self.plot_analyzed_images(show=False, **plot_kwargs)
        for fig in figs[::-1]:
            canvas.add_new_page()
            with io.BytesIO() as stream:
                fig.savefig(stream, format="png")
                stream.seek(0)
                canvas.add_image(stream, location=(-4, 13), dimensions=(28, 12))
        plt.close("all")
        if notes is not None:
            canvas.add_text(text="Notes:", location=(1, 5.5), font_size=14)
            canvas.add_text(text=notes, location=(1, 5))
        canvas.finish()
        if open_file:
            webbrowser.open(filename)
