"""Starshot wobble analysis, single image on the host and batched on the card.

Port of ``pylinac_tpu/starshot.py:33-554``: ``StarshotResults`` (a
dataclass with the pydantic model's fields), ``Wobble``, ``LineManager``,
``StarProfile``, ``calculate_angles``, ``Starshot`` (``analyze``,
``results``, ``results_data``, ``passed``, ``from_multiple_images``,
``from_zip``), ``StarshotBatch`` and ``analyze_star_batch``.

The single-image ``Starshot`` is numpy on the host, as in the JAX package;
its one minimisation, a Nelder-Mead over the lines, runs on CPU tensors
(:func:`pylinac_tpu_torch.ops.optimize.nelder_mead`), where the JAX class
placed it (its arrays are far below ``pylinac_tpu/ops/route.py:22``'s
``2**18`` elements). It takes no device. ``StarshotBatch.analyze`` stages
the stack on its device once and runs
:func:`pylinac_tpu_torch.ops.star_pipeline.starshot_batch` there.

The reports (``LineManager.plot`` ``:93``, ``Starshot`` ``:326-419``):
``publish_pdf`` through :mod:`.core.pdf`, ``to_quaac`` and
``plotly_analyzed_images`` need no matplotlib; the plots import it inside,
and raise ``ModuleNotFoundError`` where it is missing.

Left out: ``from_url``, ``from_demo_image`` and ``run_demo``.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import math
from itertools import product
from pathlib import Path
from typing import BinaryIO, Sequence

import numpy as np
import torch

from .core import image
from .core.geometry import Circle, Line, Point
from .core.io import TemporaryZipDirectory
from .core.profile import CollapsedCircleProfile, FWXMProfile
from .core.utilities import QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin, resolve_device
from .core.warnings import capture_warnings
from .ops.optimize import nelder_mead
from .ops.star_pipeline import (StarParams, _combo_table, _max_distance, n_angles,
                                 starshot_batch)


@dataclasses.dataclass(kw_only=True)
class StarshotResults(ResultBase):
    """Typed results of one starshot, with the JAX model's fields in its
    order."""

    tolerance_mm: float
    circle_diameter_mm: float
    circle_radius_mm: float
    circle_center_x_y: tuple[float, float]
    angles: list[float]
    passed: bool


class Wobble(Circle):
    """The minimum circle touching all radiation lines."""

    def __init__(self, center_point=None, radius=None):
        super().__init__(center_point=center_point or (0, 0), radius=radius or 0)
        self.radius_mm = 0

    @property
    def diameter_mm(self) -> float:
        return self.radius_mm * 2


class LineManager:
    """Pairs opposite spoke peaks into radiation lines."""

    def __init__(self, points: list[Point], focus_point: Point, dpmm: float):
        self.lines: list[Line] = []
        self.focus_point = focus_point
        self.dpmm = dpmm
        self.construct_rad_lines(points)

    def __getitem__(self, item):
        return self.lines[item]

    def __len__(self):
        return len(self.lines)

    def construct_rad_lines(self, points: list[Point]) -> None:
        self.match_points(points)
        for line in self.lines:
            if line.distance_to(self.focus_point) > 10 * self.dpmm:
                raise ValueError(
                    "The radiation lines are not near the center of the image. "
                    "This could be due to missing spoke halves, such as in a gantry starshot.")

    def match_points(self, points: list[Point]) -> None:
        """Peak i pairs with peak i + N/2 (spokes cross the CAX)."""
        num_rad_lines = int(len(points) / 2)
        self.lines = [Line(points[i], points[i + num_rad_lines])
                      for i in range(num_rad_lines)]

    def plot(self, axis) -> None:
        for line in self.lines:
            line.plot2axes(axis, color="blue")


class StarProfile(CollapsedCircleProfile):
    """The thick circular profile that localises the spokes."""

    def __init__(self, image, start_point, radius, min_peak_height, fwhm):
        radius = self._convert_radius_perc2pix(image, start_point, radius)
        super().__init__(center=start_point, radius=radius, image_array=image.array,
                         width_ratio=0.1, sampling_ratio=3)
        self.get_peaks(min_peak_height, fwhm=fwhm)

    @staticmethod
    def _convert_radius_perc2pix(image, start_point, radius):
        return image.dist2edge_min(start_point) * radius

    def _roll_prof_to_midvalley(self) -> int:
        roll_amount = int(np.where(self.values == self.values.min())[0][0])
        self.roll(roll_amount)
        return roll_amount

    def get_peaks(self, min_peak_height, min_peak_distance=0.02, fwhm=True) -> None:
        self._roll_prof_to_midvalley()
        self.filter(size=0.003, kind="gaussian")
        self.ground()
        if fwhm:
            self.find_fwxm_peaks(threshold=min_peak_height, min_distance=min_peak_distance)
        else:
            self.find_peaks(min_peak_height, min_peak_distance)


def calculate_angles(lines: list[Line]) -> list[float]:
    """Spoke angles in degrees about vertical."""
    angles = []
    for line in lines:
        try:
            phi_deg = math.degrees(math.atan(line.m)) - 90
            if phi_deg > 90:
                phi_deg -= 180
            elif phi_deg <= -90:
                phi_deg += 180
        except ZeroDivisionError:
            phi_deg = 90
        angles.append(phi_deg)
    return angles


@capture_warnings
class Starshot(ResultsDataMixin, QuaacMixin):
    """Determine the wobble of a starshot image (gantry, collimator, couch or
    MLC)."""

    def __init__(self, filepath: str | Path | BinaryIO, **kwargs):
        self.image = image.load(filepath, **kwargs)
        self.wobble = Wobble()
        self.tolerance = 1
        self._is_analyzed = False
        if self.image.dpmm is None:
            raise ValueError(
                "DPI was not a tag in the image nor was it passed in. Please pass a DPI value")
        if getattr(self.image, "sid", None) is None:
            raise ValueError(
                "Source-to-Image distance was not an image tag and was not passed in. "
                "Please pass an SID value.")

    @classmethod
    def from_multiple_images(cls, filepath_list: list, stretch_each: bool = True,
                             method: str = "sum", **kwargs):
        """One starshot from several images combined by ``method``."""
        with io.BytesIO() as stream:
            img = image.load_multiples(filepath_list, stretch_each=stretch_each,
                                       method=method, **kwargs)
            img.save(stream)
            stream.seek(0)
            return cls(stream, **kwargs)

    @classmethod
    def from_zip(cls, zip_file: str, **kwargs):
        """A starshot from the image(s) in a zip archive."""
        with TemporaryZipDirectory(zip_file) as tmpdir:
            image_files = [f for f in Path(tmpdir).rglob("*") if f.is_file()]
            if not image_files:
                raise IndexError(f"No valid starshot images were found in {zip_file}")
            if len(image_files) > 1:
                return cls.from_multiple_images([str(f) for f in image_files], **kwargs)
            return cls(str(image_files[0]), **kwargs)

    def _get_reasonable_start_point(self) -> tuple[Point, float]:
        """FW80M centre of the central-third max-profiles."""
        top_third = int(self.image.array.shape[0] / 3)
        bottom_third = int(top_third * 2)
        left_third = int(self.image.array.shape[1] / 3)
        right_third = int(left_third * 2)
        central = self.image.array[top_third:bottom_third, left_third:right_third]
        x_sum = np.max(central, 0)
        y_sum = np.max(central, 1)
        fwxm_x = round(FWXMProfile(values=x_sum, fwxm_height=80).center_idx) + left_third
        fwxm_y = round(FWXMProfile(values=y_sum, fwxm_height=80).center_idx) + top_third
        return Point(fwxm_x, fwxm_y), np.percentile(central, 90)

    def analyze(self, radius: float = 0.85, min_peak_height: float = 0.25,
                max_wobble_diameter: float = 2.0, tolerance: float = 1.0,
                start_point: Point | tuple | None = None, fwhm: bool = True,
                recursive: bool = True, invert: bool = False) -> None:
        """Find the wobble circle's diameter and centre."""
        self.tolerance = tolerance
        self.image.check_inversion_by_histogram(percentiles=[4, 50, 96])
        self.image.ground()
        if invert:
            self.image.invert()

        auto_point, local_max = self._get_reasonable_start_point()
        start_point = auto_point if start_point is None else Point(start_point)
        self._get_reasonable_wobble(start_point, fwhm, min_peak_height, radius,
                                    recursive, local_max, max_wobble_diameter)
        self.angles = calculate_angles(self.lines)
        self._is_analyzed = True

    def _get_reasonable_wobble(self, start_point, fwhm, min_peak_height, radius,
                               recursive, local_max, max_wobble_diameter) -> None:
        """Retry over (radius, peak height) until the wobble is sane."""
        wobble_reasonable = False
        focus_point = copy.copy(start_point)
        peak_candidates = np.append(min_peak_height, np.linspace(0.05, 0.95, 10))
        radius_candidates = np.append(radius, np.linspace(0.95, 0.1, 10))
        gen = product(radius_candidates, peak_candidates)

        while not wobble_reasonable:
            try:
                min_height = min_peak_height * local_max
                self.circle_profile = StarProfile(self.image, focus_point, radius,
                                                  min_height, fwhm)
                if (len(self.circle_profile.peaks) < 6) or (
                        len(self.circle_profile.peaks) % 2 != 0):
                    if not recursive:
                        raise RuntimeError(
                            "The algorithm was unable to properly detect the radiation "
                            "lines. Try setting recursive to True or lower the minimum "
                            "peak height")
                    raise ValueError
                self.lines = LineManager(self.circle_profile.peaks,
                                         focus_point=focus_point, dpmm=self.image.dpmm)
                self._find_wobble_minimize()
                focus_near_center = (
                    self.wobble.center.distance_to(focus_point) < 10 * self.image.dpmm)
                if (self.wobble.diameter_mm < max_wobble_diameter and focus_near_center) \
                        or not recursive:
                    wobble_reasonable = True
                else:
                    raise ValueError
            except ValueError:
                try:
                    radius, min_peak_height = next(gen)
                except StopIteration:
                    raise RuntimeError(
                        "The algorithm was unable to determine a reasonable wobble. "
                        "Try setting recursive to False and manually adjusting parameters")

    def _find_wobble_minimize(self) -> None:
        """Minimax the distance to all lines by a Nelder-Mead on CPU tensors."""
        sp = copy.copy(self.circle_profile.center)
        p1 = np.array([[ln.point1.x, ln.point1.y] for ln in self.lines], np.float32)
        p2 = np.array([[ln.point2.x, ln.point2.y] for ln in self.lines], np.float32)
        d = p2 - p1
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        lines = _max_distance(torch.from_numpy(p1)[None], torch.from_numpy(d)[None],
                              torch.ones((1, len(p1)), dtype=torch.bool))

        def max_distance(p):
            return lines(p[None, None])[0, 0]

        x, fx = nelder_mead(max_distance, torch.tensor([sp.x, sp.y], dtype=torch.float32),
                            fatol=0.001, xatol=1e-4, max_iter=400)
        x = x.numpy()
        self.wobble.radius = float(fx)
        self.wobble.radius_mm = float(fx) / self.image.dpmm
        self.wobble.center = Point(float(x[0]), float(x[1]))

    @property
    def passed(self) -> bool:
        return bool(self.wobble.radius_mm * 2 < self.tolerance)

    @property
    def _passfail_str(self) -> str:
        return "PASS" if self.passed else "FAIL"

    def results(self, as_list: bool = False) -> str | list[str]:
        results = [
            "Starshot Analysis Results",
            "-------------------------",
            f"Number of radiation lines: {len(self.lines)}",
            f"Minimum circle diameter: {self.wobble.diameter_mm:2.3f}mm",
            f"Minimum circle center: ({self.wobble.center.x:3.1f}, {self.wobble.center.y:3.1f})",
            f"Result: {self._passfail_str}",
        ]
        if not as_list:
            return "\n".join(results)
        return results

    def _generate_results_data(self) -> StarshotResults:
        if not self._is_analyzed:
            raise ValueError("The image has not been analyzed; use .analyze()")
        return StarshotResults(
            tolerance_mm=self.tolerance,
            circle_diameter_mm=self.wobble.diameter_mm,
            circle_radius_mm=self.wobble.radius_mm,
            circle_center_x_y=(self.wobble.center.x, self.wobble.center.y),
            angles=self.angles,
            passed=self.passed,
        )

    # -- reports (JAX starshot.py:326-419) ------------------------------------
    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {
            "Circle diameter": QuaacDatum(
                value=self.wobble.diameter_mm, unit="mm",
                description="Minimum circle diameter touching all radiation lines"),
            "Circle center": QuaacDatum(
                value=f"({self.wobble.center.x:.1f}, {self.wobble.center.y:.1f})",
                unit="px"),
        }

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs):
        """The image with the lines, the wobble circle and the profile's
        circles, whole and zoomed on the wobble."""
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, **plt_kwargs)
        for ax, zoom in zip(axes, (False, True)):
            ax.imshow(self.image.array, cmap="gray")
            self.lines.plot(ax)
            self.wobble.plot2axes(ax, edgecolor="green")
            self.circle_profile.plot2axes(ax, edgecolor="green")
            if zoom:
                xlim = (self.wobble.center.x + self.wobble.diameter,
                        self.wobble.center.x - self.wobble.diameter)
                ylim = (self.wobble.center.y + self.wobble.diameter,
                        self.wobble.center.y - self.wobble.diameter)
                ax.set_xlim(xlim)
                ax.set_ylim(ylim)
        if show:
            plt.show()
        return fig, axes

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`): the image with
        the lines and the wobble circle, whole and zoomed on the wobble:
        ``{name: Figure}``."""
        from .core import plotly_utils as pu

        if not self._is_analyzed:
            raise RuntimeError("The image must be analyzed first. Use .analyze().")
        figs: dict[str, pu.Figure] = {}
        for name, zoom in zip(("Image", "Wobble"), (False, True)):
            fig = pu.image_figure(self.image.array, title="Starshot Analysis",
                                  show_colorbar=show_colorbar, **kwargs)
            for idx, line in enumerate(self.lines):
                fig.add_trace(pu.scatter_trace(
                    [line.point1.x, line.point2.x], [line.point1.y, line.point2.y],
                    mode="lines", name=f"Line {idx}",
                    line={"color": "blue", "width": 1}, showlegend=show_legend))
            theta = np.linspace(0, 2 * np.pi, 100)
            fig.add_trace(pu.scatter_trace(
                self.wobble.center.x + self.wobble.radius * np.cos(theta),
                self.wobble.center.y + self.wobble.radius * np.sin(theta),
                mode="lines", name="Wobble",
                line={"color": "green", "width": 2}, showlegend=show_legend))
            if zoom:
                pu.set_axis_range(
                    fig,
                    x=[self.wobble.center.x - self.wobble.diameter,
                       self.wobble.center.x + self.wobble.diameter],
                    y=[self.wobble.center.y - self.wobble.diameter,
                       self.wobble.center.y + self.wobble.diameter])
            figs[name] = fig
        if show:
            for f in figs.values():
                f.show()
        return figs

    def plot_analyzed_subimage(self, subimage: str = "wholeimage", ax=None,
                               show: bool = True):
        """The image with the lines and the wobble circle on one axes."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.imshow(self.image.array, cmap="gray")
        self.lines.plot(ax)
        self.wobble.plot2axes(ax, edgecolor="green")
        if show:
            plt.show()
        return ax

    def publish_pdf(self, filename: str, notes: str | list[str] | None = None,
                    open_file: bool = False, metadata: dict | None = None,
                    logo: str | None = None) -> None:
        """The results as a one-page PDF (:mod:`.core.pdf`); needs no
        matplotlib."""
        from .core import pdf

        canvas = pdf.PylinacCanvas(filename, page_title="Starshot Analysis",
                                   metadata=metadata, logo=logo)
        canvas.add_text(text=self.results(as_list=True), location=(2, 25.5), font_size=11)
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class StarshotBatch:
    """Analyse a batch of same-geometry starshot images in one batched
    pipeline on the card (:mod:`pylinac_tpu_torch.ops.star_pipeline`): the
    retry ladder, the polar profiles, the spoke pairing and the Nelder-Mead
    wobble of every image. Images must share shape and dpmm."""

    def __init__(self, filepaths: Sequence, **kwargs):
        self.images = [image.load(f, **kwargs) for f in filepaths]
        if not self.images:
            raise ValueError("No images were provided")
        shapes = {im.array.shape for im in self.images}
        if len(shapes) != 1:
            raise ValueError(
                f"All images in a batch must share one shape; got {shapes}")
        if self.images[0].dpmm is None:
            raise ValueError("DPI was not in the images nor passed in")
        self.tolerance = 1
        self._is_analyzed = False

    def analyze(self, radius: float = 0.85, min_peak_height: float = 0.25,
                max_wobble_diameter: float = 2.0, tolerance: float = 1.0,
                fwhm: bool = True, recursive: bool = True,
                invert: bool = False, chunk: int | None = None,
                device: str | torch.device | None = None) -> None:
        """Analyse the batch on ``device`` (``None`` means ``"cuda"``, and
        raises when no CUDA device exists). Arguments as
        ``pylinac_tpu.starshot.StarshotBatch.analyze``; ``chunk`` bounds the
        images a step of the ladder evaluates at once and changes no
        result. Its default there, 8, sized a TPU's ``lax.map``; here
        every image goes at once unless a chunk is given."""
        device = resolve_device(device, "StarshotBatch.analyze")
        self.tolerance = tolerance
        dpmm = float(self.images[0].dpmm)
        # the loaded pixels stay fixed for the batch's lifetime: stage them
        # on the device once
        staged = getattr(self, "_stage_cache", None)
        if staged is None or staged[0] != str(device):
            stacked = np.stack([np.asarray(im.array) for im in self.images])
            if stacked.dtype.kind == "f" and stacked.dtype.itemsize > 4:
                stacked = stacked.astype(np.float32)
            staged = (str(device), torch.from_numpy(stacked).to(device))
            self._stage_cache = staged
        batch = staged[1]
        params = StarParams(max_wobble_mm=max_wobble_diameter, dpmm=dpmm, invert=bool(invert))
        out = starshot_batch(batch, params, _combo_table(radius, min_peak_height),
                             n_ang=n_angles(batch.shape[1:], radius), recursive=recursive,
                             fwhm=fwhm, chunk=chunk)
        self._out = {k: v.cpu().numpy() for k, v in out.items()}
        self._dpmm = dpmm
        if not self._out["found"].all():
            bad = [i for i, f in enumerate(self._out["found"]) if not f]
            raise RuntimeError(
                f"The algorithm was unable to determine a reasonable wobble "
                f"for image(s) {bad}. Try recursive=False with manual "
                f"parameters, or the single-image API.")
        self._is_analyzed = True

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """A :class:`StarshotResults` an image (or their dicts or JSON)."""
        if not self._is_analyzed:
            raise ValueError("The batch has not been analyzed; use .analyze()")
        out = []
        o = self._out
        for i in range(len(self.images)):
            radius_px = float(o["wobble_radius_px"][i])
            lines = [Line(Point(*o["line_p1"][i][j]), Point(*o["line_p2"][i][j]))
                     for j in range(int(o["n_lines"][i]))
                     if o["line_valid"][i][j]]
            out.append(StarshotResults(
                tolerance_mm=self.tolerance,
                circle_diameter_mm=radius_px * 2 / self._dpmm,
                circle_radius_mm=radius_px / self._dpmm,
                circle_center_x_y=(float(o["wobble_center"][i][0]),
                                   float(o["wobble_center"][i][1])),
                angles=calculate_angles(lines),
                passed=bool(radius_px * 2 / self._dpmm < self.tolerance),
            ).output(as_dict, as_json))
        return out


def analyze_star_batch(filepaths: Sequence, **analyze_kwargs) -> list[StarshotResults]:
    """One-call batched starshot session: load, analyse, results."""
    batch = StarshotBatch(filepaths)
    batch.analyze(**analyze_kwargs)
    return batch.results_data()
