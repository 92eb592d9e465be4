"""Picket fence (MLC positional QA) analysis, single image and batched.

Port of ``pylinac_tpu/picketfence.py``: ``Orientation`` ``:39``,
``MLCArrangement`` ``:46``, ``MLC`` ``:68``, ``PFResult`` ``:80``, the
single-image ``PFDicomImage`` ``:102-143``, ``_batched_fwxm`` ``:145-156``,
``MLCValue`` ``:159-309``, ``Picket`` ``:311-390`` and ``PicketFence``
``:391-790``, the batched ``PicketFenceBatch`` ``:909-1292`` (its ``mesh``
through :mod:`pylinac_tpu_torch.parallel.mesh`) and ``analyze_batch``
``:1295``.

``PicketFence`` and ``PFDicomImage`` take a ``device`` (``None`` means
CUDA, and raises without it): the image's de-spike, a 3x3 median repeated
while the frame still has outliers, and the optional ``filter`` run there
(``csrc/median3x3.cu`` on the card), and so does ``_batched_fwxm``, one
peak analysis over every kiss profile. The rest is numpy on the host, as
in the JAX class. ``log=`` (``_load_log``, ``:480-494``) takes the
pickets' fits from a machine log's expected fluence
(:mod:`pylinac_tpu_torch.log_analyzer`), the log read for the same device;
JAX calls it before ``self.mlc`` is set, which raises there, and the port
sets the MLC first. The reports (``:786-906``, with ``MLCValue.plot2axes``
and ``plot_detailed_profile`` ``:291-307`` and ``Picket.add_guards_to_axes``
``:377``): ``publish_pdf`` through :mod:`.core.pdf`, ``to_quaac`` and
``plotly_analyzed_images`` need no matplotlib; the matplotlib plots import
it inside, and raise ``ModuleNotFoundError`` where it is missing. Left out:
``from_url``, ``from_demo_image`` and ``run_demo``.

The batch's host loads and orients the frames and builds the results with
numpy, as the JAX class does; its analysis runs in
:func:`pylinac_tpu_torch.ops.picket_pipeline.picket_fence_batch` on the
device given to :meth:`PicketFenceBatch.analyze`. Its stages carry the
JAX package's :mod:`.profiling` names (``pf.host_orient`` to
``pf.fetch_unpack``; ``pf.spec`` timed the packed wire, not ported).
"""

from __future__ import annotations

import dataclasses
import enum
import statistics
import warnings
from functools import cached_property
from io import BytesIO
from itertools import cycle, groupby
from typing import Sequence

import numpy as np
import torch

from . import profiling
from .core import image
from .core.geometry import Line, Point
from .core.profile import MultiProfile
from .core.utilities import (QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin,
                              convert_to_enum, resolve_device)
from .core.warnings import capture_warnings
from .ops import peaks
from .ops.picket_pipeline import PFLeafConfig, PFParams, picket_fence_batch

LEFT_MLC_PREFIX = "A"
RIGHT_MLC_PREFIX = "B"


class Orientation(enum.Enum):
    """Picket orientations."""

    UP_DOWN = "Up-Down"  #:
    LEFT_RIGHT = "Left-Right"  #:


class MLCArrangement:
    """An MLC leaf arrangement: list of (num_leaves, width_mm) groups."""

    def __init__(self, leaf_arrangement: list[tuple[int, float]], offset: float = 0):
        self.centers: list[float] = []
        self.widths: list[float] = []
        rolling_edge = 0.0
        for leaf_num, width in leaf_arrangement:
            self.centers += np.arange(
                start=rolling_edge + width / 2,
                stop=leaf_num * width + rolling_edge + width / 2,
                step=width).tolist()
            rolling_edge = self.centers[-1] + width / 2
            self.widths += [width] * leaf_num
        mean_c = np.mean(self.centers)
        self.centers = [c - mean_c + offset for c in self.centers]

    @property
    def leaves(self) -> list[int]:
        return np.arange(1, len(self.centers) + 1, dtype=int)[::-1].tolist()


class MLC(enum.Enum):
    """Pre-built MLC models."""

    MILLENNIUM = {"name": "Millennium", "arrangement": MLCArrangement([(10, 10), (40, 5), (10, 10)])}  #:
    HD_MILLENNIUM = {"name": "HD Millennium", "arrangement": MLCArrangement([(14, 5), (32, 2.5), (14, 5)])}  #:
    BMOD = {"name": "B Mod", "arrangement": MLCArrangement([(40, 4)])}  #:
    AGILITY = {"name": "Agility", "arrangement": MLCArrangement([(80, 5)])}  #:
    MLCI = {"name": "MLCi", "arrangement": MLCArrangement([(40, 10)])}  #:
    HALCYON_DISTAL = {"name": "Halcyon distal", "arrangement": MLCArrangement([(28, 10)])}  #:
    HALCYON_PROXIMAL = {"name": "Halcyon proximal", "arrangement": MLCArrangement([(29, 10)])}  #:


def _get_mlc_arrangement(value) -> MLCArrangement:
    """An arrangement from an ``MLC`` member, an arrangement, or a model name
    (``PicketFence._get_mlc_arrangement``, ``picketfence.py:415``)."""
    if isinstance(value, MLC):
        return value.value["arrangement"]
    if isinstance(value, MLCArrangement):
        return value
    if isinstance(value, str):
        return [member.value["arrangement"] for member in MLC
                if member.value["name"] == value][0]
    raise ValueError(f"Invalid MLC arrangement {value}")


@dataclasses.dataclass(kw_only=True)
class PFResult(ResultBase):
    """Typed results of one picket fence image, with the JAX model's fields
    in its order."""

    tolerance_mm: float
    action_tolerance_mm: float | None
    percent_leaves_passing: float
    number_of_pickets: int
    absolute_median_error_mm: float
    max_error_mm: float
    max_error_picket: int
    max_error_leaf: str | int
    mean_picket_spacing_mm: float
    offsets_from_cax_mm: list[float]
    passed: bool
    failed_leaves: list[str] | list[int]
    mlc_skew: float
    picket_widths: dict[str, dict[str, float]]
    mlc_positions_by_leaf: dict[str, list[float]]
    mlc_errors_by_leaf: dict[str, list[float]]
    cax: dict


class PFDicomImage(image.LinacDicomImage):
    """A picket fence image: edges cropped, noise de-spiked on ``device``
    (``None`` means CUDA), inversion checked by the corners."""

    def __init__(self, path, device=None, **kwargs):
        crop_mm = kwargs.pop("crop_mm", 3)
        self._central_axis = kwargs.pop("central_axis", None)
        super().__init__(path, **kwargs)
        self.device = resolve_device(device, "PFDicomImage")
        crop_pixels = int(round(crop_mm * self.dpmm))
        self.crop(pixels=crop_pixels)
        self._check_for_noise()
        self.check_inversion(box_size=10, position=(0.01, 0.01))

    def _check_for_noise(self) -> None:
        safety_stop = 5
        while self._has_noise() and safety_stop > 0:
            self.filter(size=3, device=self.device)
            safety_stop -= 1

    def _has_noise(self) -> bool:
        vmin = self.array.min()
        vmax = self.array.max()
        near_min, near_max = np.percentile(self.array, [0.5, 99.5])
        max_is_extreme = vmax > near_max * 1.25
        min_is_extreme = (vmin < near_min * 0.75) and (
            abs(vmin - near_min) > 0.1 * (near_max - near_min))
        return max_is_extreme or min_is_extreme

    def adjust_for_sag(self, sag: int, orientation) -> None:
        orient = convert_to_enum(orientation, Orientation)
        direction = "y" if orient == Orientation.UP_DOWN else "x"
        self.roll(direction, sag)

    @property
    def center(self) -> Point:
        if self._central_axis is not None:
            cax_shift = Point(x=self._central_axis.x * self.dpmm,
                              y=self._central_axis.y * self.dpmm)
            cax = super().center + cax_shift
            cax.y = 2 * (self.shape[0] // 2) - cax.y
            return Point(cax.x, cax.y)
        return super().center


def _batched_fwxm(profiles: np.ndarray, fwxm_height: float,
                  device) -> tuple[np.ndarray, np.ndarray]:
    """(N, W) grounded, normalised kiss profiles to the (left_ips,
    right_ips) of each profile's most prominent peak: one peak analysis of
    all of them on ``device``."""
    res = peaks.peak_analysis(torch.from_numpy(profiles).to(device), K=8,
                              rel_height=1 - fwxm_height)
    best = torch.argmax(torch.where(res.valid, res.prominences, float("-inf")), dim=1)
    lefts = res.left_ips.gather(1, best[:, None])[:, 0]
    rights = res.right_ips.gather(1, best[:, None])[:, 0]
    return lefts.cpu().numpy().astype(np.float64), rights.cpu().numpy().astype(np.float64)


class MLCValue:
    """One MLC kiss (or leaf-pair tips) measurement."""

    def __init__(self, picket_num, approx_idx, leaf_width, leaf_center,
                 picket_spacing, orientation, leaf_analysis_width_ratio, tolerance,
                 action_tolerance, leaf_num, approx_peak_val, image_window, image,
                 fwxm, separate_leaves, nominal_gap_mm):
        self._approximate_idx = approx_idx
        self.picket_num = picket_num
        self._approximate_peak_vale = approx_peak_val
        self.leaf_width_px = leaf_width * image.dpmm
        self._leaf_center = leaf_center
        self.leaf_center_px = leaf_center * image.dpmm + (
            image.shape[0] / 2 if orientation == Orientation.UP_DOWN else image.shape[1] / 2)
        self.leaf_num = leaf_num
        self._image_window = image_window
        self._image = image
        self._fwxm = fwxm
        self._analysis_ratio = leaf_analysis_width_ratio
        self._spacing = picket_spacing
        self._orientation = orientation
        self._tolerance = tolerance
        self._action_tolerance = action_tolerance
        self._separate_leaves = separate_leaves
        self._nominal_gap_mm = nominal_gap_mm
        self._fit = None
        self.position: Sequence[float] = ()
        self._field_width_px: float = 0.0

    @property
    def kiss_profile_values(self) -> np.ndarray:
        """The grounded, max-normalised median profile across the window."""
        if self._orientation == Orientation.UP_DOWN:
            pix_vals = np.median(self._image_window, axis=0)
        else:
            pix_vals = np.median(self._image_window, axis=1)
        pix_vals = pix_vals - pix_vals.min()
        vmax = pix_vals.max()
        return pix_vals / vmax if vmax > 0 else pix_vals

    def set_positions(self, left_ip: float, right_ip: float) -> None:
        """Install the batched FWXM results (crossings relative to the
        window)."""
        offset = max(self._approximate_idx - self._spacing / 2, 0)
        self._field_width_px = right_ip - left_ip
        if self._separate_leaves:
            self.position = (left_ip + offset, right_ip + offset)
        else:
            self.position = ((left_ip + right_ip) / 2 + offset,)

    @property
    def field_width_mm(self) -> float:
        return self._field_width_px / self._image.dpmm

    def __repr__(self) -> str:
        return f"Leaf: {self.leaf_num}, Picket: {self.picket_num}"

    @property
    def full_leaf_nums(self) -> Sequence[str | int]:
        if not self._separate_leaves:
            return [self.leaf_num]
        return [f"{LEFT_MLC_PREFIX}{self.leaf_num}", f"{RIGHT_MLC_PREFIX}{self.leaf_num}"]

    @property
    def position_mm(self) -> Sequence[float]:
        return [pos / self._image.dpmm for pos in self.position]

    @property
    def passed(self) -> Sequence[bool]:
        return [abs(error) < self._tolerance for error in self.error]

    @property
    def passed_action(self) -> Sequence[bool] | None:
        return ([abs(error) < self._action_tolerance for error in self.error]
                if self._action_tolerance is not None else [True, True])

    @property
    def bg_color(self) -> Sequence[str]:
        colors = []
        for idx, passed in enumerate(self.passed):
            if not passed:
                colors.append("red")
            elif self._action_tolerance is not None:
                colors.append("blue" if self.passed_action[idx] else "magenta")
            else:
                colors.append("blue")
        return colors

    @property
    def picket_positions(self) -> Sequence[float]:
        picket_pos = []
        for line, sign in zip(self.marker_lines, (-1, 1)):
            if self._orientation == Orientation.UP_DOWN:
                picket = self._fit(line.center.y)
            else:
                picket = self._fit(line.center.x)
            if self._separate_leaves:
                mag_factor = self._image.sid / 1000
                picket += sign * self._nominal_gap_mm * mag_factor / 2 * self._image.dpmm
            picket_pos.append(picket / self._image.dpmm)
        return picket_pos

    @property
    def error(self) -> Sequence[float]:
        errors = []
        for line, sign in zip(self.marker_lines, (-1, 1)):
            if self._orientation == Orientation.UP_DOWN:
                picket_pos = self._fit(line.center.y)
                mlc_pos = line.center.x
            else:
                picket_pos = self._fit(line.center.x)
                mlc_pos = line.center.y
            if self._separate_leaves:
                picket_pos += sign * self._nominal_gap_mm / 2 * self._image.dpmm
            errors.append((mlc_pos - picket_pos) / self._image.dpmm)
        return errors

    @property
    def max_abs_error(self) -> float:
        return float(np.max(np.abs(self.error)))

    @property
    def marker_lines(self) -> list[Line]:
        upper = self.leaf_center_px - self.leaf_width_px / 2 * self._analysis_ratio
        lower = self.leaf_center_px + self.leaf_width_px / 2 * self._analysis_ratio
        lines = []
        for mlc_position in self.position:
            if self._orientation == Orientation.UP_DOWN:
                lines.append(Line((mlc_position, upper), (mlc_position, lower)))
            else:
                lines.append(Line((upper, mlc_position), (lower, mlc_position)))
        return lines

    def plot2axes(self, axes, width: float = 1) -> None:
        for idx, line in enumerate(self.marker_lines):
            line.plot2axes(axes, width, color=self.bg_color[idx])

    def plot_detailed_profile(self):
        import matplotlib.pyplot as plt

        pix_vals = self.kiss_profile_values
        offset = max(self._approximate_idx - self._spacing / 2, 0)
        x_values = np.arange(len(pix_vals)) + offset
        fig, ax = plt.subplots()
        ax.plot(x_values, pix_vals)
        for picket_pos in self.picket_positions:
            ax.axvline(x=picket_pos * self._image.dpmm, color="black",
                       label="Fitted picket location")
        for pos, color in zip(self.position, self.bg_color):
            ax.axvline(pos, color=color, label="Measured MLC position")
        return ax


class Picket:
    """One picket: a line fit through its MLC measurements."""

    def __init__(self, mlc_measurements: list[MLCValue], orientation, image, tolerance,
                 separate_leaves, nominal_gap, log_fits=None):
        self.mlc_meas = mlc_measurements
        self.log_fits = log_fits
        self.tolerance = tolerance
        self.orientation = orientation
        self.image = image
        self._separate_leaves = separate_leaves
        self._nominal_gap = nominal_gap
        self.fit = self.get_fit()
        for m in self.mlc_meas:
            m._fit = self.fit

    def get_fit(self) -> np.poly1d:
        """The next of the log's picket fits, else a line through the
        measured MLC positions."""
        if self.log_fits is not None:
            return next(self.log_fits)
        x = [line.point1.y for m in self.mlc_meas for line in m.marker_lines]
        y = [line.point1.x for m in self.mlc_meas for line in m.marker_lines]
        if self.orientation == Orientation.UP_DOWN:
            fit = np.polyfit(x, y, 1)
        else:
            fit = np.polyfit(y, x, 1)
        return np.poly1d(fit)

    def skew(self) -> float:
        return float(np.rad2deg(self.fit.coefficients[0]))

    @property
    def dist2cax(self) -> float:
        length = (self.image.shape[0] if self.orientation == Orientation.UP_DOWN
                  else self.image.shape[1])
        x_data = np.arange(length)
        y_data = self.fit(x_data)
        idx = int(round(len(x_data) / 2))
        if self.orientation == Orientation.UP_DOWN:
            axis = "x"
            p1 = Point(y_data[idx], x_data[idx])
        else:
            axis = "y"
            p1 = Point(x_data[idx], y_data[idx])
        return (getattr(self.image.center, axis) - getattr(p1, axis)) / self.image.dpmm

    @property
    def left_guard_separated(self) -> Sequence[np.poly1d]:
        l_fit = np.copy(self.fit.coefficients)
        l_fit[-1] += self.tolerance * self.image.dpmm
        if not self._separate_leaves:
            return [np.poly1d(l_fit)]
        other = np.copy(l_fit)
        l_fit[-1] += self._nominal_gap / 2 * self.image.dpmm
        other[-1] -= self._nominal_gap / 2 * self.image.dpmm
        return [np.poly1d(l_fit), np.poly1d(other)]

    @property
    def right_guard_separated(self) -> Sequence[np.poly1d]:
        r_fit = np.copy(self.fit.coefficients)
        r_fit[-1] -= self.tolerance * self.image.dpmm
        if not self._separate_leaves:
            return [np.poly1d(r_fit)]
        other = np.copy(r_fit)
        r_fit[-1] -= self._nominal_gap / 2 * self.image.dpmm
        other[-1] += self._nominal_gap / 2 * self.image.dpmm
        return [np.poly1d(r_fit), np.poly1d(other)]

    def add_guards_to_axes(self, axis, idx: int, color: str = "g",
                           show_text: bool = False) -> None:
        length = self.image.shape[0] if self.orientation == Orientation.UP_DOWN else self.image.shape[1]
        x_data = np.arange(length)
        for left, right in zip(self.left_guard_separated, self.right_guard_separated):
            if self.orientation == Orientation.UP_DOWN:
                axis.plot(left(x_data), x_data, color=color)
                axis.plot(right(x_data), x_data, color=color)
            else:
                axis.plot(x_data, left(x_data), color=color)
                axis.plot(x_data, right(x_data), color=color)


@capture_warnings
class PicketFence(ResultsDataMixin, QuaacMixin):
    """MLC picket fence analysis of one image. The de-spike, the optional
    median ``filter`` and the kiss-profile FWXM run on ``device``
    (``None`` means CUDA, and raises without it)."""

    def __init__(self, filename, filter: int | None = None, log: str | None = None,
                 use_filename: bool = False,
                 mlc: MLC | MLCArrangement | str = MLC.MILLENNIUM,
                 crop_mm: int = 3, image_kwargs: dict | None = None, device=None):
        self.device = resolve_device(device, "PicketFence")
        if filename is not None:
            img_kwargs = image_kwargs or {}
            self.image = PFDicomImage(filename, use_filenames=use_filename,
                                      crop_mm=crop_mm, device=self.device, **img_kwargs)
            if isinstance(filter, int):
                self.image.filter(size=filter, device=self.device)
            self.image.ground()
            self.image.normalize()
        self._is_analyzed = False
        self.mlc = _get_mlc_arrangement(mlc)
        self._log_fits = None
        if log is not None:
            self._load_log(log)

    def _load_log(self, log: str) -> None:
        """Take the pickets' fits from a machine log: its expected fluence
        (equal aspect, 0.1 mm) is cropped and resampled to the image, which
        is resampled likewise, and analysed as a picket fence of its own
        whose picket fits then stand for this analysis's."""
        from .log_analyzer import load_log

        mlog = load_log(log, device=self.device)
        fl = mlog.fluence.expected.calc_map(equal_aspect=True)
        fli = image.load(fl, dpi=254)
        fluence_img, img_array = image.equate_images(fli, self.image, device=self.device)
        self.image.array = img_array.array
        pf = PicketFence(None, mlc=self.mlc, device=self.device)
        pf.image = fluence_img
        pf.analyze()
        self._log_fits = cycle([p.get_fit() for p in pf.pickets])

    @classmethod
    def from_bb_setup(cls, *args, bb_image, bb_diameter: float, **kwargs):
        """Locate the true CAX from a BB setup image, then analyse the
        picket fence image relative to that BB position."""
        device = kwargs.get("device")
        bb_img = image.load(bb_image)

        def _metric(invert: bool):
            from .metrics.image import SizedDiskLocator

            return SizedDiskLocator.from_center_physical(
                expected_position_mm=(0, 0),
                search_window_mm=(30 + bb_diameter, 30 + bb_diameter),
                radius_mm=bb_diameter / 2,
                radius_tolerance_mm=bb_diameter * 0.1 + 1,
                invert=invert, device=device)

        try:
            caxs = bb_img.compute(metrics=_metric(invert=True))
        except ValueError:
            caxs = bb_img.compute(metrics=_metric(invert=False))
        cax_shift = caxs[0] - bb_img.center
        cax_physical_shift = Point(x=cax_shift.x / bb_img.dpmm, y=cax_shift.y / bb_img.dpmm)
        instance = cls(*args, **kwargs, image_kwargs={"central_axis": cax_physical_shift})
        instance._from_bb_setup = True
        instance._bb_image = bb_img
        return instance

    @classmethod
    def from_multiple_images(cls, path_list: list, stretch_each: bool = True,
                             method: str = "mean", mlc=MLC.MILLENNIUM, device=None,
                             **kwargs):
        """One picket fence from several images combined by ``method``."""
        obj = cls(None, mlc=mlc, device=device)
        with BytesIO() as stream:
            img = image.load_multiples(path_list, method=method, stretch_each=stretch_each,
                                       loader=PFDicomImage, device=obj.device, **kwargs)
            img.save(stream)
            stream.seek(0)
            obj.image = PFDicomImage(stream, device=obj.device, **kwargs)
        obj.image.ground()
        obj.image.normalize()
        return obj

    # -- result properties --------------------------------------------------
    @property
    def passed(self) -> bool:
        return all(all(m.passed) for m in self.mlc_meas)

    @property
    def percent_passing(self) -> float:
        statuses = [p for m in self.mlc_meas for p in m.passed]
        return float(100 * sum(statuses) / len(statuses))

    @property
    def max_error(self) -> float:
        return float(np.max(np.abs(self._flattened_errors())))

    @property
    def max_error_picket(self) -> int:
        return max(self.mlc_meas, key=lambda m: np.max(np.abs(m.error))).picket_num

    def picket_width_stat(self, picket: int, metric: str = "max") -> float:
        widths = [m.field_width_mm for m in self.mlc_meas if m.picket_num == picket]
        if metric == "max":
            return max(widths)
        if metric == "median":
            return statistics.median(widths)
        if metric == "mean":
            return statistics.mean(widths)
        if metric == "min":
            return min(widths)
        raise ValueError(f"Unknown metric {metric}")

    @property
    def max_error_leaf(self) -> int | str:
        max_meas = max(self.mlc_meas, key=lambda m: np.max(np.abs(m.error)))
        if not self.separate_leaves:
            return max_meas.full_leaf_nums[0]
        if abs(max_meas.error[0]) > abs(max_meas.error[1]):
            return max_meas.full_leaf_nums[0]
        return max_meas.full_leaf_nums[1]

    def _flattened_errors(self) -> list[float]:
        return [e for m in self.mlc_meas for e in m.error]

    def failed_leaves(self) -> list[int] | list[str]:
        if not self._is_analyzed:
            raise ValueError("The PF image has not been analyzed. Use .analyze() first.")
        failing = [m for m in self.mlc_meas if not all(m.passed)]
        if not self.separate_leaves:
            return list({m.leaf_num for m in failing})
        out = []
        for m in failing:
            for idx, passed in enumerate(m.passed):
                if not passed:
                    out.append(m.full_leaf_nums[idx])
        return list(dict.fromkeys(out))

    @property
    def abs_median_error(self) -> float:
        return float(np.median(np.abs(self._flattened_errors())))

    @property
    def num_pickets(self) -> int:
        return len(self.pickets)

    @property
    def mean_picket_spacing(self) -> float:
        sorted_pickets = sorted(self.pickets, key=lambda x: x.dist2cax)
        return float(np.mean([
            abs(sorted_pickets[i].dist2cax - sorted_pickets[i + 1].dist2cax)
            for i in range(len(sorted_pickets) - 1)]))

    def mlc_skew(self) -> float:
        return float(np.mean([p.skew() for p in self.pickets]))

    @cached_property
    def orientation(self) -> Orientation:
        """The given orientation, or the one the row and column sums' upper
        percentile spreads show."""
        if self._orientation is not None:
            return convert_to_enum(self._orientation, Orientation)
        return PicketFenceBatch._detect_orientation(self.image.array)

    # -- core analysis ------------------------------------------------------
    def analyze(self, tolerance: float = 0.5, action_tolerance: float | None = None,
                num_pickets: int | None = None, sag_adjustment: float = 0,
                orientation: Orientation | str | None = None, invert: bool = False,
                leaf_analysis_width_ratio: float = 0.4,
                picket_spacing: float | None = None, height_threshold: float = 0.5,
                edge_threshold: float = 1.5, peak_sort: str = "peak_heights",
                required_prominence: float = 0.2, fwxm: int = 50,
                separate_leaves: bool = False, nominal_gap_mm: float = 3,
                central_axis: Point | None = None) -> None:
        """Analyse the image (arguments as
        ``pylinac_tpu.picketfence.PicketFence.analyze``); the kiss profiles'
        FWXM runs on the class's device."""
        if action_tolerance is not None and tolerance < action_tolerance:
            raise ValueError("Tolerance cannot be lower than the action tolerance")
        self.tolerance = tolerance
        self.action_tolerance = action_tolerance
        self.leaf_analysis_width = leaf_analysis_width_ratio
        self.separate_leaves = separate_leaves
        if central_axis:
            self.image._central_axis = central_axis
        if invert:
            self.image.invert()
        self._orientation = orientation
        if sag_adjustment != 0:
            sag_pixels = int(round(sag_adjustment * self.image.dpmm))
            self.image.adjust_for_sag(sag_pixels, self.orientation)

        if self.orientation == Orientation.UP_DOWN:
            leaf_prof = np.mean(self.image, 0)
        else:
            leaf_prof = np.mean(self.image, 1)
        leaf_prof = MultiProfile(leaf_prof)
        leaf_prof.normalize()
        peak_idxs, peak_vals = leaf_prof.find_fwxm_peaks(
            min_distance=0.02, threshold=height_threshold, max_number=num_pickets,
            peak_sort=peak_sort, required_prominence=required_prominence)
        if len(peak_idxs) == 0:
            raise ValueError(
                "No pickets were found. This can mean either an incorrect orientation "
                "or incorrect inversion. Try passing the correct orientation; if that "
                "fails, also set invert=True.")
        if picket_spacing is None:
            picket_spacing = np.median(np.diff(np.sort(peak_idxs)))

        self.mlc_meas = []
        for leaf_num, center, width in self._leaves_in_view(leaf_analysis_width_ratio):
            for picket_num, (picket_idx, picket_peak_val) in enumerate(zip(peak_idxs, peak_vals)):
                window = self._get_mlc_window(leaf_center=center, leaf_width=width,
                                              approx_idx=picket_idx, spacing=picket_spacing)
                if self._is_mlc_peak_in_window(window, height_threshold,
                                               edge_threshold, picket_peak_val):
                    self.mlc_meas.append(MLCValue(
                        picket_num=picket_num, approx_idx=picket_idx, leaf_width=width,
                        leaf_center=center, picket_spacing=picket_spacing,
                        orientation=self.orientation,
                        leaf_analysis_width_ratio=leaf_analysis_width_ratio,
                        tolerance=tolerance, action_tolerance=action_tolerance,
                        leaf_num=leaf_num, approx_peak_val=picket_peak_val,
                        image_window=window, image=self.image, fwxm=fwxm,
                        separate_leaves=separate_leaves, nominal_gap_mm=nominal_gap_mm))
        if not self.mlc_meas:
            raise ValueError(
                "No MLC measurements were found. This may be due to an incorrect "
                "inversion (try invert=True) or an incorrect orientation.")

        # every kiss window's FWXM in one batched call on the device
        profiles = [m.kiss_profile_values for m in self.mlc_meas]
        max_w = max(len(p) for p in profiles)
        batch = np.zeros((len(profiles), max_w), dtype=np.float32)
        for i, p in enumerate(profiles):
            batch[i, :len(p)] = p
        lefts, rights = _batched_fwxm(batch, fwxm / 100, self.device)
        for m, left, right in zip(self.mlc_meas, lefts, rights):
            m.set_positions(left, right)

        # drop leaf rows that do not have the median number of kisses
        counts: dict = {}
        for m in self.mlc_meas:
            counts.setdefault(m.leaf_num, []).append(m)
        median_num = statistics.median(len(v) for v in counts.values())
        full_leaves = {leaf for leaf, v in counts.items() if len(v) == median_num}
        if any(m.leaf_num not in full_leaves for m in self.mlc_meas):
            warnings.warn(
                "Some leaves were removed from analysis because they were not detected "
                "for all pickets. If valid leaves are missing try adjusting "
                "height_threshold or edge_threshold")
        self.mlc_meas = [m for m in self.mlc_meas if m.leaf_num in full_leaves]

        self.pickets = [
            Picket([m for m in self.mlc_meas if m.picket_num == picket_num],
                   orientation=self.orientation, image=self.image, tolerance=tolerance,
                   nominal_gap=nominal_gap_mm, separate_leaves=separate_leaves,
                   log_fits=self._log_fits)
            for picket_num in range(len(peak_idxs))]
        self._is_analyzed = True

    def _is_mlc_peak_in_window(self, window, height_threshold, edge_threshold,
                               picket_peak_val) -> bool:
        if self.orientation == Orientation.UP_DOWN:
            std = np.std(window, axis=1)
        else:
            std = np.std(window, axis=0)
        is_above = np.max(window) > height_threshold * picket_peak_val
        is_not_at_edge = max(std) < edge_threshold * np.median(std)
        return is_above and is_not_at_edge

    def _get_mlc_window(self, leaf_center, leaf_width, approx_idx, spacing) -> np.ndarray:
        leaf_width_px = leaf_width * self.image.dpmm
        leaf_center_px = leaf_center * self.image.dpmm + (
            self.image.shape[0] / 2 if self.orientation == Orientation.UP_DOWN
            else self.image.shape[1] / 2)
        if self.orientation == Orientation.UP_DOWN:
            left_edge = max(int(approx_idx - spacing / 2), 0)
            right_edge = min(int(approx_idx + spacing / 2), self.image.shape[1])
            top_edge = max(int(leaf_center_px - leaf_width_px / 2), 0)
            bottom_edge = min(int(leaf_center_px + leaf_width_px / 2), self.image.shape[0])
            return self.image[top_edge:bottom_edge, left_edge:right_edge]
        top_edge = max(int(approx_idx - spacing / 2), 0)
        bottom_edge = min(int(approx_idx + spacing / 2), self.image.shape[0])
        left_edge = max(int(leaf_center_px - leaf_width_px / 2), 0)
        right_edge = min(int(leaf_center_px + leaf_width_px / 2), self.image.shape[1])
        return self.image[top_edge:bottom_edge, left_edge:right_edge]

    def _leaves_in_view(self, analysis_width) -> list[tuple[int, float, float]]:
        pixel_range = (self.image.shape[0] / 2
                       if self.orientation == Orientation.UP_DOWN
                       else self.image.shape[1] / 2)
        pixel_range -= max(self.mlc.widths[0] * analysis_width,
                           self.mlc.widths[-1] * analysis_width) * self.image.dpmm
        return [(leaf_num, center, width)
                for leaf_num, center, width in zip(self.mlc.leaves, self.mlc.centers,
                                                   self.mlc.widths)
                if abs(center) < pixel_range / self.image.dpmm]

    # -- output -------------------------------------------------------------
    def results(self, as_list: bool = False) -> str | list[str]:
        offsets = " ".join(f"{pk.dist2cax:.1f}" for pk in self.pickets)
        results = [
            "Picket Fence Results:",
            f"Gantry Angle (\N{DEGREE SIGN}): {self.image.gantry_angle:2.1f}",
            f"Collimator Angle (\N{DEGREE SIGN}): {self.image.collimator_angle:2.1f}",
            f"Tolerance (mm): {self.tolerance}",
            f"Leaves passing (%): {self.percent_passing:2.1f}",
            f"Absolute median error (mm): {self.abs_median_error:2.3f}mm",
            f"Mean picket spacing (mm): {self.mean_picket_spacing:2.1f}mm",
            f"Picket offsets from CAX (mm): {offsets}",
            f"Max Error: {self.max_error:2.3f}mm on Picket: {self.max_error_picket}, "
            f"Leaf: {self.max_error_leaf}",
            f"MLC Skew: {self.mlc_skew():2.3f} degrees",
        ]
        if self.failed_leaves():
            results.append(f"Failing leaves: {self.failed_leaves()}")
        if not as_list:
            return "\n".join(results)
        return results

    def _generate_results_data(self) -> PFResult:
        picket_widths = {
            f"picket_{pk}": {key: self.picket_width_stat(pk, key)
                             for key in ("max", "mean", "median", "min")}
            for pk in range(len(self.pickets))}
        errors_by_leaf = {}
        positions_by_leaf = {}
        cax_position = (self.image.center.x if self.orientation == Orientation.UP_DOWN
                        else self.image.center.y)
        cax_physical = cax_position / self.image.dpmm
        for _leaf, group_iter in groupby(self.mlc_meas, key=lambda m: m.leaf_num):
            leaf_items = list(group_iter)
            leaf_names = leaf_items[0].full_leaf_nums
            for idx, leaf_name in enumerate(leaf_names):
                positions_by_leaf[str(leaf_name)] = [
                    cax_physical - m.position_mm[idx] for m in leaf_items]
                errors_by_leaf[str(leaf_name)] = [m.error[idx] for m in leaf_items]
        return PFResult(
            tolerance_mm=self.tolerance,
            action_tolerance_mm=self.action_tolerance,
            percent_leaves_passing=self.percent_passing,
            number_of_pickets=self.num_pickets,
            absolute_median_error_mm=self.abs_median_error,
            max_error_mm=self.max_error,
            max_error_picket=self.max_error_picket,
            max_error_leaf=self.max_error_leaf,
            mean_picket_spacing_mm=self.mean_picket_spacing,
            offsets_from_cax_mm=[pk.dist2cax for pk in self.pickets],
            passed=self.passed,
            failed_leaves=self.failed_leaves(),
            mlc_skew=self.mlc_skew(),
            picket_widths=picket_widths,
            mlc_positions_by_leaf=dict(sorted(positions_by_leaf.items())),
            mlc_errors_by_leaf=dict(sorted(errors_by_leaf.items())),
            cax=self.image.center.dict(),
        )

    # -- reports (JAX picketfence.py:786-906) --------------------------------
    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {
            "Max error": QuaacDatum(value=self.max_error, unit="mm"),
            "Absolute median error": QuaacDatum(value=self.abs_median_error, unit="mm"),
            "Percent passing": QuaacDatum(value=self.percent_passing, unit="%"),
            "Number of pickets": QuaacDatum(value=self.num_pickets),
            "Mean picket spacing": QuaacDatum(value=self.mean_picket_spacing, unit="mm"),
            "MLC skew": QuaacDatum(value=self.mlc_skew(), unit="degrees"),
        }

    def plot_analyzed_image(self, guard_rails: bool = True, mlc_peaks: bool = True,
                            overlay: bool = True, leaf_error_subplot: bool = True,
                            show: bool = True, figure_size: tuple | None = None, **kwargs):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figure_size)
        ax.imshow(self.image.array, cmap="gray")
        if guard_rails:
            for idx, picket in enumerate(self.pickets):
                picket.add_guards_to_axes(ax, idx)
        if mlc_peaks:
            for meas in self.mlc_meas:
                meas.plot2axes(ax)
        ax.set_title("Picket Fence Analysis")
        if show:
            plt.show()
        return fig, ax

    def plot_leaf_profile(self, leaf, picket: int, show: bool = True):
        import matplotlib.pyplot as plt

        matches = [m for m in self.mlc_meas
                   if leaf in m.full_leaf_nums and m.picket_num == picket]
        if len(matches) != 1:
            raise ValueError(f"Could not find a unique measurement for leaf {leaf}, picket {picket}")
        ax = matches[0].plot_detailed_profile()
        ax.set_title(f"MLC profile Leaf: {leaf}, Picket: {picket}")
        if show:
            plt.show()
        return ax

    def plotly_analyzed_images(self, mlc_peaks: bool = True, overlay: bool = True,
                               show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """The analysed image with its guard rails and MLC marks, and the
        histogram of the leaf errors, as plotly-schema figures
        (:mod:`.core.plotly_utils`): ``{name: Figure}``."""
        from .core import plotly_utils as pu

        if not self._is_analyzed:
            raise RuntimeError("The image must be analyzed first. Use .analyze().")
        figs: dict[str, pu.Figure] = {}
        fig = pu.image_figure(self.image.array, title="Picket Fence Analysis",
                              show_colorbar=show_colorbar, **kwargs)
        x_data = np.arange(self.image.shape[0] if self.orientation == Orientation.UP_DOWN
                           else self.image.shape[1])
        for picket in self.pickets:
            for left, right in zip(picket.left_guard_separated, picket.right_guard_separated):
                for guard in (left, right):
                    gx, gy = ((guard(x_data), x_data)
                              if self.orientation == Orientation.UP_DOWN
                              else (x_data, guard(x_data)))
                    fig.add_trace(pu.scatter_trace(
                        gx, gy, name="Guard rail", mode="lines",
                        line={"color": "green", "width": 1}, showlegend=False))
        if mlc_peaks:
            for meas in self.mlc_meas:
                for idx, line in enumerate(meas.marker_lines):
                    fig.add_trace(pu.scatter_trace(
                        [line.point1.x, line.point2.x], [line.point1.y, line.point2.y],
                        mode="lines", name="MLC",
                        line={"color": meas.bg_color[idx], "width": 2}, showlegend=False))
        fig.update_layout(showlegend=show_legend)
        figs["Picket Fence"] = fig

        hist = pu.Figure()
        hist.add_trace(pu.histogram_trace(self._flattened_errors(), name="Errors"))
        pu.add_vertical_line(hist, self.tolerance, color="red", width=3)
        pu.add_vertical_line(hist, -self.tolerance, color="red", width=3)
        pu.add_title(hist, "Leaf error histogram")
        hist.update_layout(xaxis_title="Error (mm)", yaxis_title="Counts",
                           showlegend=show_legend)
        figs["Histogram"] = hist
        if show:
            for f in figs.values():
                f.show()
        return figs

    def plot_histogram(self, bins: int = 10, show: bool = True) -> None:
        import matplotlib.pyplot as plt

        if not self._is_analyzed:
            raise ValueError("The PF image has not been analyzed. Use .analyze() first.")
        errors = self._flattened_errors()
        fig, ax = plt.subplots()
        ax.axvline(self.tolerance, color="r", linewidth=3)
        ax.axvline(-self.tolerance, color="r", linewidth=3)
        ax.grid(True)
        ax.hist(errors, bins=bins)
        if show:
            plt.show()

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The results as a one-page PDF (:mod:`.core.pdf`); needs no
        matplotlib."""
        from .core import pdf

        canvas = pdf.PylinacCanvas(filename, page_title="Picket Fence Analysis",
                                   metadata=metadata, logo=logo)
        canvas.add_text(text=self.results(as_list=True), location=(2, 25.5), font_size=11)
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class PicketFenceBatch:
    """Analyse a batch of same-geometry picket fence images in one batched
    pipeline on the card.

    All images must share shape, dpmm and MLC model; heterogeneous sessions
    should be bucketed by the caller.
    """

    def __init__(self, images: Sequence, mlc: MLC | MLCArrangement | str = MLC.MILLENNIUM,
                 crop_mm: int = 3, filter: int | None = None,
                 image_kwargs: dict | None = None):
        # the host only LOADS pixels (DICOM decode + crop, numpy views);
        # de-spiking, inversion, extra filtering, ground and normalise run in
        # the device pipeline
        self.images: list[image.BaseImage] = []
        for item in images:
            if isinstance(item, image.BaseImage):
                img = item
            else:
                img = image.LinacDicomImage(item, **(image_kwargs or {}))
                crop_px = int(round(crop_mm * img.dpmm))
                if crop_px:
                    img.crop(pixels=crop_px)
            self.images.append(img)
        if not self.images:
            raise ValueError("No images were provided")
        self._extra_filter = filter if isinstance(filter, int) else 0
        self.mlc = _get_mlc_arrangement(mlc)
        self._is_analyzed = False

    @staticmethod
    def _host_inversion_hint(arr: np.ndarray) -> bool:
        """Corner-sample inversion test on the raw array (the pipeline redoes
        it on the card; this one only conditions orientation detection and
        the picket-spacing estimate). The whole-image mean is subsampled."""
        H, W = arr.shape
        rp, cp, b = max(int(0.01 * H), 1), max(int(0.01 * W), 1), 10
        corners = np.stack([
            arr[rp:rp + b, cp:cp + b], arr[rp:rp + b, W - cp - b:W - cp],
            arr[H - rp - b:H - rp, cp:cp + b],
            arr[H - rp - b:H - rp, W - cp - b:W - cp]])
        return bool(corners.mean() > arr[::4, ::4].mean())

    @staticmethod
    def _detect_orientation(arr: np.ndarray) -> Orientation:
        temp = arr.copy()
        med = np.median(temp)
        temp[temp < med] = med
        row_sum = np.sum(temp, 0)
        col_sum = np.sum(temp, 1)
        row80, row90 = np.percentile(row_sum, [85, 99])
        col80, col90 = np.percentile(col_sum, [85, 99])
        return (Orientation.LEFT_RIGHT if (row90 - row80) < (col90 - col80)
                else Orientation.UP_DOWN)

    def _leaf_config(self, H: int, dpmm: float, analysis_ratio: float, device):
        """Leaf row windows in canonical UP-DOWN orientation. Returns
        (config, leaf numbers, tallest window)."""
        pixel_range = H / 2
        pixel_range -= max(self.mlc.widths[0] * analysis_ratio,
                           self.mlc.widths[-1] * analysis_ratio) * dpmm
        leaves, tops, heights, centers, widths = [], [], [], [], []
        for leaf_num, center, width in zip(self.mlc.leaves, self.mlc.centers,
                                           self.mlc.widths):
            if abs(center) >= pixel_range / dpmm:
                continue
            c_px = center * dpmm + H / 2
            w_px = width * dpmm
            top = max(int(c_px - w_px / 2), 0)
            bottom = min(int(c_px + w_px / 2), H)
            leaves.append(leaf_num)
            tops.append(top)
            heights.append(bottom - top)
            centers.append(c_px)
            widths.append(w_px)
        cfg = PFLeafConfig(
            tops=torch.tensor(tops, dtype=torch.long, device=device),
            heights=torch.tensor(heights, dtype=torch.long, device=device),
            centers_px=torch.tensor(centers, dtype=torch.float32, device=device),
            widths_px=torch.tensor(widths, dtype=torch.float32, device=device))
        return cfg, np.asarray(leaves), max(heights)

    def analyze(self, tolerance: float = 0.5, action_tolerance: float | None = None,
                num_pickets: int | None = None, invert: bool = False,
                leaf_analysis_width_ratio: float = 0.4,
                height_threshold: float = 0.5, edge_threshold: float = 1.5,
                peak_sort: str = "peak_heights", required_prominence: float = 0.2,
                fwxm: int = 50, separate_leaves: bool = False,
                nominal_gap_mm: float = 3,
                orientation: Orientation | str | None = None,
                w_max: int | None = None, chunk: int = 32, mesh=None,
                device: str | torch.device | None = None) -> None:
        """Analyse the batch on ``device`` (``None`` means ``"cuda"``, and
        raises when no CUDA device exists). Arguments as
        ``pylinac_tpu.picketfence.PicketFenceBatch.analyze``.

        ``mesh``: a :class:`~pylinac_tpu_torch.parallel.mesh.Mesh` whose
        ``data`` axis shards the images, each shard through the same
        pipeline on its device
        (:func:`~pylinac_tpu_torch.parallel.mesh.sharded_pf_batch`; JAX
        ``picketfence.py:1022-1029``, ``:1155-1158``); per-image results
        equal the unsharded run's. The rest runs on the mesh's first
        device, and a ``device`` that differs from it raises
        ``ValueError``."""
        if mesh is not None:
            from .parallel.mesh import mesh_device

            device = mesh_device(mesh, device, "PicketFenceBatch.analyze")
        else:
            device = resolve_device(device, "PicketFenceBatch.analyze")
        if action_tolerance is not None and tolerance < action_tolerance:
            raise ValueError("Tolerance cannot be lower than the action tolerance")
        self.tolerance = tolerance
        self.action_tolerance = action_tolerance
        self.separate_leaves = separate_leaves

        # orientation is a pure function of the loaded pixels, which stay
        # fixed for the batch's lifetime: repeat analyses reuse it
        okey = (orientation, bool(invert), len(self.images))
        ocached = getattr(self, "_orient_cache", None)
        with profiling.stage("pf.host_orient"):
            if ocached is not None and ocached[0] == okey:
                self._orientations = ocached[1]
            else:
                self._orientations = []
                for img in self.images:
                    raw = np.asarray(img.array)
                    if orientation:
                        orient = convert_to_enum(orientation, Orientation)
                    else:
                        # a coarse binary decision: detect on a 4x-subsampled,
                        # inversion-conditioned copy
                        sub = raw[::4, ::4]
                        if self._host_inversion_hint(raw) ^ invert:
                            sub = sub.max() + sub.min() - sub.astype(np.float32)
                        orient = self._detect_orientation(sub)
                    self._orientations.append(orient)
                self._orient_cache = (okey, self._orientations)
            arrays = [np.asarray(img.array) if orient == Orientation.UP_DOWN
                      else np.asarray(img.array).T
                      for img, orient in zip(self.images, self._orientations)]
        shapes = {a.shape for a in arrays}
        if len(shapes) != 1:
            raise ValueError(
                f"All images in a batch must share one canonical shape; got {shapes}")
        dpmms = {round(float(img.dpmm), 6) for img in self.images}
        if len(dpmms) != 1:
            raise ValueError(f"All images in a batch must share dpmm; got {dpmms}")
        dpmm = self.images[0].dpmm
        H, W = arrays[0].shape

        cfg, self._leaf_nums, h_max = self._leaf_config(
            H, dpmm, leaf_analysis_width_ratio, device)
        H_MAX = -(-h_max // 8) * 8
        if w_max is None:
            wkey = (bool(invert), height_threshold, required_prominence, W)
            wcached = getattr(self, "_wmax_cache", None)
            if wcached is not None and wcached[0] == wkey:
                w_max = wcached[1]
            else:
                # picket spacing from the first image's host-conditioned mean
                # profile (inversion hint + ground)
                with profiling.stage("pf.wmax_est"):
                    a0 = arrays[0].astype(np.float32)
                    if self._host_inversion_hint(arrays[0]) ^ invert:
                        a0 = a0.max() + a0.min() - a0
                    prof = a0.mean(axis=0)
                    prof -= prof.min()
                    idxs, _ = peaks.find_peaks(
                        prof / prof.max(), threshold=height_threshold,
                        peak_separation=0.02, required_prominence=required_prominence)
                    spacing_est = (float(np.median(np.diff(np.sort(idxs))))
                                   if len(idxs) > 1 else W)
                    w_max = int(min(-(-int(spacing_est + 2) // 64) * 64, W))
                self._wmax_cache = (wkey, w_max)
        # stage the RAW batch in its stored dtype (uint16 frames widen on the
        # card); the loaded pixels stay fixed for the batch's lifetime, so
        # the device copy is reused by repeat analyses
        stage_key = (tuple(self._orientations), len(arrays), str(device))
        staged = getattr(self, "_stage_cache", None)
        if staged is None or staged[0] != stage_key:
            with profiling.stage("pf.h2d_stage"):
                stacked = np.stack(arrays)
                if stacked.dtype.kind == "f" and stacked.dtype.itemsize > 4:
                    stacked = stacked.astype(np.float32)
                staged = (stage_key, torch.from_numpy(stacked).to(device))
            self._stage_cache = staged
        batch = staged[1]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        params = PFParams(
            height_threshold=f32(height_threshold),
            edge_threshold=f32(edge_threshold),
            required_prominence=f32(required_prominence),
            fwxm=f32(fwxm),
            dpmm=f32(dpmm),
            cax_col=f32(W / 2 - 0.5),
            analysis_ratio=f32(leaf_analysis_width_ratio),
            nominal_gap_px=f32(nominal_gap_mm / 2 * dpmm),
            invert=bool(invert))
        static = dict(K_P=16, W_MAX=w_max, H_MAX=H_MAX, num_pickets=num_pickets,
                      peak_sort=peak_sort, separate_leaves=separate_leaves,
                      chunk=min(chunk, len(arrays)), extra_filter=self._extra_filter)
        if mesh is not None:
            # as in JAX, the mesh branch has no stage of its own
            from .parallel.mesh import sharded_pf_batch

            out = sharded_pf_batch(batch, cfg, params, mesh, **static)
            self._out = {k: v.cpu().numpy() for k, v in out.items()}
        else:
            with profiling.stage("pf.dispatch"):
                out = picket_fence_batch(batch, cfg, params, **static)
            # JAX's pf.spec timed the packed wire's tree spec, which the port
            # has not: the fetch below is its pf.fetch_unpack without the unpack
            with profiling.stage("pf.fetch_unpack"):
                self._out = {k: v.cpu().numpy() for k, v in out.items()}
        if not self._out["kiss_valid"].any():
            raise ValueError(
                "No MLC measurements were found in the batch. This may be due to "
                "an incorrect inversion (try invert=True) or orientation.")
        self._dpmm = float(dpmm)
        self._is_analyzed = True

    # -- result construction -------------------------------------------------
    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """Per-image :class:`PFResult` list built from the fetched arrays."""
        if not self._is_analyzed:
            raise ValueError("The batch has not been analyzed. Use .analyze() first.")
        results = [self._image_result(i) for i in range(len(self.images))]
        if as_dict:
            return [r.model_dump() for r in results]
        if as_json:
            return [r.model_dump_json() for r in results]
        return results

    def _image_result(self, i: int) -> PFResult:
        o = self._out
        valid = o["kiss_valid"][i]                      # (L, K_P)
        picket_valid = o["picket_valid"][i]             # (K_P,)
        if not picket_valid.any():
            raise ValueError(
                f"No pickets were found in image {i}. Try passing the correct "
                "orientation or invert=True.")
        errors = o["errors_mm"][i]                      # (L, K_P, n)
        pos_px = o["positions_px"][i]
        widths_mm = o["width_px"][i] / self._dpmm
        dist2cax = o["dist2cax_mm"][i]
        fits = o["fits"][i]
        picket_slots = np.nonzero(picket_valid)[0]      # found order = index order
        n_lines = errors.shape[-1]

        line_valid = np.repeat(valid[..., None], n_lines, axis=-1)
        abs_err = np.abs(errors)
        flat_err = abs_err[line_valid]
        passed_lines = abs_err[line_valid] < self.tolerance
        percent_passing = float(100 * passed_lines.sum() / passed_lines.size)
        max_error = float(flat_err.max())
        l_i, p_i, s_i = np.unravel_index(
            np.argmax(np.where(line_valid, abs_err, -1.0)), abs_err.shape)
        max_error_picket = int(np.searchsorted(picket_slots, p_i))
        leaf_num = int(self._leaf_nums[l_i])
        if self.separate_leaves:
            max_error_leaf = f"{(LEFT_MLC_PREFIX, RIGHT_MLC_PREFIX)[s_i]}{leaf_num}"
        else:
            max_error_leaf = leaf_num

        offsets = [float(dist2cax[p]) for p in picket_slots]
        sorted_off = np.sort(offsets)
        mean_spacing = (float(np.mean(np.abs(np.diff(sorted_off))))
                        if len(offsets) > 1 else 0.0)
        skew = float(np.mean([np.rad2deg(fits[p, 0]) for p in picket_slots]))

        # per-picket width stats over the valid kisses
        w_masked = np.where(valid, widths_mm, np.nan)[:, picket_slots]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slots
            w_max = np.nanmax(w_masked, axis=0)
            w_mean = np.nanmean(w_masked, axis=0)
            w_min = np.nanmin(w_masked, axis=0)
        # np.sort puts NaNs last, so the median of the valid entries is the
        # mean of the two middle order statistics
        w_sorted = np.sort(w_masked, axis=0)
        cnt = valid[:, picket_slots].sum(axis=0)
        safe = np.maximum(cnt, 1)
        cols = np.arange(w_sorted.shape[1])
        w_med = (w_sorted[(safe - 1) // 2, cols] + w_sorted[safe // 2, cols]) / 2
        picket_widths = {
            f"picket_{rank}": {"max": float(w_max[rank]), "mean": float(w_mean[rank]),
                               "median": float(w_med[rank]), "min": float(w_min[rank])}
            for rank in range(len(picket_slots))}

        cax_physical = (self.images[i].shape[1 if self._orientations[i] == Orientation.UP_DOWN else 0] / 2 - 0.5) / self._dpmm
        pos_mm = cax_physical - pos_px[:, picket_slots, :] / self._dpmm  # (L,P,S)
        err_sel = errors[:, picket_slots, :]
        vsel = valid[:, picket_slots]                                    # (L,P)
        leaf_any = vsel.any(axis=1)
        fail_ls = ((np.abs(err_sel) >= self.tolerance)
                   & vsel[:, :, None]).any(axis=1)                       # (L,S)
        positions_by_leaf: dict[str, list[float]] = {}
        errors_by_leaf: dict[str, list[float]] = {}
        failed: list = []
        for li in np.nonzero(leaf_any)[0]:
            leaf = self._leaf_nums[li]
            names = ([f"{LEFT_MLC_PREFIX}{leaf}", f"{RIGHT_MLC_PREFIX}{leaf}"]
                     if self.separate_leaves else [int(leaf)])
            sel = vsel[li]
            for s, name in enumerate(names):
                positions_by_leaf[str(name)] = pos_mm[li, sel, s].tolist()
                errors_by_leaf[str(name)] = err_sel[li, sel, s].astype(
                    np.float64).tolist()
                if fail_ls[li, s]:
                    failed.append(name)

        return PFResult(
            tolerance_mm=self.tolerance,
            action_tolerance_mm=self.action_tolerance,
            percent_leaves_passing=percent_passing,
            number_of_pickets=len(picket_slots),
            absolute_median_error_mm=float(np.median(flat_err)),
            max_error_mm=max_error,
            max_error_picket=max_error_picket,
            max_error_leaf=max_error_leaf,
            mean_picket_spacing_mm=mean_spacing,
            offsets_from_cax_mm=offsets,
            passed=bool(max_error < self.tolerance),
            failed_leaves=failed,
            mlc_skew=skew,
            picket_widths=picket_widths,
            mlc_positions_by_leaf=dict(sorted(positions_by_leaf.items())),
            mlc_errors_by_leaf=dict(sorted(errors_by_leaf.items())),
            cax=self.images[i].center.dict(),
        )


def analyze_batch(images: Sequence, mlc: MLC | MLCArrangement | str = MLC.MILLENNIUM,
                  **analyze_kwargs) -> list[PFResult]:
    """Load, analyse and return per-image :class:`PFResult` in one call."""
    init_keys = ("crop_mm", "filter", "image_kwargs")
    init_kwargs = {k: analyze_kwargs.pop(k) for k in init_keys if k in analyze_kwargs}
    batch = PicketFenceBatch(images, mlc=mlc, **init_kwargs)
    batch.analyze(**analyze_kwargs)
    return batch.results_data()
