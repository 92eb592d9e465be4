"""VMAT QA: DRGS (dose rate and gantry speed), DRMLC (dose rate and MLC
speed) and DRCS (dose rate and collimator speed).

Port of ``pylinac_tpu/vmat.py`` (``:1-610``): ``ImageType`` (``:37``), the
result models (``:43-79``) as dataclasses, ``Segment`` (``:81``),
``CollimatorDeviation`` (``:109``), ``VMATBase`` (``:132``: loading with
``ground`` and ``check_inversion``, ``from_zip``, ``analyze``, ``results``,
``passed`` and the deviations), ``VMATLinearBase`` (``:347``), ``DRGS``
(``:423``), ``DRMLC`` (``:444``) and ``DRCS`` (``:465``), the three with
``capture_warnings`` as in JAX. The decorator wraps only the public
functions of a class's own body, so ``DRCS.analyze`` captures its warnings
and ``DRGS`` and ``DRMLC``, whose ``analyze`` is ``VMATBase``'s, capture
none: their field-centre warning reaches the caller only, and
``results_data().warnings`` stays ``[]``, as in JAX.

The ratio image, the segments and the profiles are host numpy, as in the
JAX package. DRCS's image identification takes a size-10 median of each
frame on ``device`` (``ops/filters.median_filter``, the general sort: JAX
has no kernel for it either); the constructors take ``device=None``, which
means CUDA and raises without it.

The reports (``VMATBase`` ``:234-344``, DRCS's QuAAC ``:550``):
``publish_pdf`` through :mod:`.core.pdf`, ``to_quaac`` and
``plotly_analyzed_images`` need no matplotlib; ``plot_analyzed_image``
imports it inside, and raises ``ModuleNotFoundError`` where it is missing.

Not ported: ``from_url``, ``from_demo_images`` and ``run_demo``
(downloads).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import math
import warnings
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .core import image
from .core.array_utils import normalize
from .core.geometry import Point
from .core.io import TemporaryZipDirectory
from .core.profile import CircleProfile, FWXMProfile, Normalization
from .core.roi import RectangleROI
from .core.scale import wrap180
from .core.utilities import (DataModel, QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin,
                              resolve_device)
from .core.warnings import capture_warnings
from .ops.filters import median_filter


class ImageType(enum.Enum):
    DMLC = "dmlc"  #:
    OPEN = "open"  #:
    PROFILE = "profile"  #:


@dataclasses.dataclass(kw_only=True)
class SegmentResult(DataModel):
    """One segment's result."""

    passed: bool
    x_position_mm: float
    angular_position_deg: float
    r_corr: float
    r_dev: float
    center_x_y: dict
    stdev: float


@dataclasses.dataclass(kw_only=True)
class CollimatorResult(DataModel):
    angle_deviation: float
    angle_nominal: float


@dataclasses.dataclass(kw_only=True)
class VMATResult(ResultBase):
    """The results of a VMAT test."""

    test_type: str
    tolerance_percent: float
    max_deviation_percent: float
    abs_mean_deviation: float
    passed: bool
    segment_data: list[SegmentResult]
    named_segment_data: dict[str, SegmentResult]


@dataclasses.dataclass(kw_only=True)
class DRCSResult(VMATResult):
    rotation_offset_deg: float
    collimator_data: dict[str, CollimatorResult]


class Segment(RectangleROI):
    """A segment ROI on the DMLC/open ratio image."""

    def __init__(self, center_point: Point, width: float, height: float,
                 ratio_image: np.ndarray, tolerance: float, rotation: float = 0):
        self.r_dev: float = 0.0
        self._tolerance = tolerance
        self._ratio_image = ratio_image
        super().__init__(ratio_image, width, height, center_point, rotation)

    @property
    def r_corr(self) -> float:
        """The segment's mean DMLC/open ratio times 100."""
        return float(self.pixels_flat.mean() * 100)

    @property
    def stdev(self) -> float:
        return float(self.pixels_flat.std())

    @property
    def passed(self) -> bool:
        return abs(self.r_dev) < self._tolerance * 100

    def get_bg_color(self) -> str:
        return "blue" if self.passed else "red"


@dataclasses.dataclass
class CollimatorDeviation:
    """A DRCS collimator spoke: its name, nominal angle and two points on
    it."""

    name: str
    angle_nominal: float
    points: tuple[Point, Point]

    @staticmethod
    def calculate_angle_measured(point1: Point, point2: Point) -> float:
        angle_im = np.arctan2(point2.y - point1.y, point2.x - point1.x)
        return float(-(np.rad2deg(angle_im) + 90) % 360)

    @property
    def angle_measured(self) -> float:
        return self.calculate_angle_measured(self.points[0], self.points[1])

    @property
    def angle_deviation(self) -> float:
        return wrap180(self.angle_measured - self.angle_nominal)


class VMATBase(ABC, ResultsDataMixin, QuaacMixin):
    """The machinery the VMAT tests share."""

    _result_header: str
    _result_short_header: str
    text_rotation: float = 90

    def __init__(self, image_paths: Sequence, ground=True, check_inversion=True,
                 device=None, **kwargs):
        super().__init__()
        self.device = resolve_device(device, type(self).__name__)
        if len(image_paths) != 2:
            raise ValueError("Exactly 2 images (open, DMLC) must be passed")
        image1, image2 = self._load_images(image_paths, ground=ground, **kwargs)
        if check_inversion:
            image1, image2 = self._check_inversion(image1, image2)
        self._identify_images(image1, image2)
        self.segments: list[Segment] = []
        self._tolerance = 0

    @property
    @abstractmethod
    def default_segment_size_mm(self) -> tuple[float, float]:
        pass

    @property
    @abstractmethod
    def default_roi_config(self) -> dict:
        pass

    @classmethod
    def from_zip(cls, path, **kwargs):
        """The pair in a zip archive (its two files in name order)."""
        with TemporaryZipDirectory(path) as tmpzip:
            files = sorted(str(p) for p in Path(tmpzip).rglob("*") if p.is_file())
            return cls(image_paths=files, **kwargs)

    def analyze(self, tolerance: float = 1.5, segment_size_mm: tuple | None = None,
                roi_config: dict | None = None, invert_image_order: bool = False):
        """The segments of the DMLC/open ratio image and their deviations
        from the mean."""
        if segment_size_mm is None:
            segment_size_mm = self.default_segment_size_mm
        if roi_config is None:
            roi_config = self.default_roi_config
        if invert_image_order:
            self.open_image, self.dmlc_image = self.dmlc_image, self.open_image
        self._tolerance = tolerance / 100
        self.roi_config = roi_config
        # zero where the open image is zero (outside the field), so the
        # division warns of nothing; the segments lie in the field
        open_arr = self.open_image.array
        self.ratio_image = np.divide(
            self.dmlc_image.array, open_arr,
            out=np.zeros_like(open_arr, dtype=float), where=open_arr != 0)
        self._calculate_segments(segment_size_mm)
        self._update_r_corrs()

    @staticmethod
    def _load_images(image_paths, ground, **kwargs):
        image1 = image.load(image_paths[0], **kwargs)
        image2 = image.load(image_paths[1], **kwargs)
        if ground:
            image1.ground()
            image2.ground()
        return image1, image2

    @staticmethod
    def _check_inversion(image1, image2):
        for img in (image1, image2):
            img.check_inversion()
        return image1, image2

    @abstractmethod
    def _identify_images(self, image1, image2):
        pass

    @abstractmethod
    def _calculate_segments(self, segment_size_mm):
        pass

    @abstractmethod
    def _roi_profiles(self, image1, image2):
        pass

    def results(self) -> str:
        passfail = "PASS" if self.passed else "FAIL"
        string = (f"{self._result_header}\nTest Results (Tol. +/-"
                  f"{self._tolerance * 100:2.2}%): {passfail}\n")
        string += (f"Max Deviation: {self.max_r_deviation:2.3}%\n"
                   f"Absolute Mean Deviation: {self.avg_abs_r_deviation:2.3}%")
        return string

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        rd = self.results_data(as_dict=True)
        data = {
            "Max Deviation": QuaacDatum(value=rd["max_deviation_percent"], unit="%"),
            "Absolute Mean Deviation": QuaacDatum(value=rd["abs_mean_deviation"], unit="%"),
        }
        for segment, seg_data in rd["named_segment_data"].items():
            data[f"{segment} Rcorr"] = QuaacDatum(value=seg_data["r_corr"])
            data[f"{segment} Rdev"] = QuaacDatum(value=seg_data["r_dev"], unit="%")
        return data

    def _update_r_corrs(self):
        avg_r_corr = np.array([s.r_corr for s in self.segments]).mean()
        for segment in self.segments:
            segment.r_dev = ((segment.r_corr / avg_r_corr) * 100) - 100

    @property
    def passed(self) -> bool:
        return all(s.passed for s in self.segments)

    @property
    def r_devs(self) -> np.ndarray:
        return np.array([s.r_dev for s in self.segments])

    @property
    def avg_abs_r_deviation(self) -> float:
        return float(np.abs(self.r_devs).mean())

    @property
    def avg_r_deviation(self) -> float:
        return float(self.r_devs.mean())

    @property
    def max_r_deviation(self) -> float:
        return float(np.max(np.abs(self.r_devs)))

    # -- reports (JAX vmat.py:270-344) ----------------------------------------
    def plot_analyzed_image(self, show: bool = True, show_text: bool = True, **plt_kwargs):
        """The open and DMLC images with the segments, and the median
        profiles."""
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(ncols=3, sharex=True, **plt_kwargs)
        for img, ax, title in zip((self.open_image, self.dmlc_image), axes, ("Open", "DMLC")):
            ax.imshow(img.array, cmap="gray")
            for segment in self.segments:
                segment.plot2axes(ax, edgecolor=segment.get_bg_color())
            ax.set_title(title)
        dmlc_prof, open_prof = self._roi_profiles(self.dmlc_image, self.open_image)
        axes[2].plot(dmlc_prof.values, label="DMLC")
        axes[2].plot(open_prof.values, label="Open")
        axes[2].set_title("Median Profiles")
        axes[2].legend(loc="lower center")
        if show:
            plt.tight_layout(h_pad=1.5)
            plt.show()
        return fig, axes

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`): the open and
        DMLC images with the segments as paths (rotated ones too), and the
        median profiles: ``{name: Figure}``."""
        from .core import plotly_utils as pu

        if not getattr(self, "segments", None):
            raise RuntimeError("The images must be analyzed first. Use .analyze().")
        figs: dict[str, pu.Figure] = {}
        for img, title in zip((self.open_image, self.dmlc_image), ("Open", "DMLC")):
            fig = pu.image_figure(img.array, title=f"{title} Image",
                                  show_colorbar=show_colorbar, **kwargs)
            for segment in self.segments:
                path = "M " + " L ".join(f"{p.x},{p.y}" for p in segment.vertices) + " Z"
                fig.layout.setdefault("shapes", []).append({
                    "type": "path", "path": path,
                    "line": {"color": segment.get_bg_color(), "width": 2}})
            figs[title] = fig
        dmlc_prof, open_prof = self._roi_profiles(self.dmlc_image, self.open_image)
        prof_fig = pu.Figure()
        prof_fig.add_trace(pu.scatter_trace(
            np.arange(len(dmlc_prof.values)), dmlc_prof.values, name="DMLC"))
        prof_fig.add_trace(pu.scatter_trace(
            np.arange(len(open_prof.values)), open_prof.values, name="Open"))
        pu.add_title(prof_fig, "Median Profiles")
        prof_fig.update_layout(xaxis_title="Pixel", showlegend=show_legend)
        figs["Median Profiles"] = prof_fig
        if show:
            for f in figs.values():
                f.show()
        return figs

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None, logo=None):
        """The results as a one-page PDF (:mod:`.core.pdf`); needs no
        matplotlib."""
        from .core import pdf

        canvas = pdf.PylinacCanvas(filename,
                                   page_title=f"{self._result_short_header} VMAT Analysis",
                                   metadata=metadata, logo=logo)
        text = [
            f"{self._result_header} VMAT results:",
            f"Source-to-Image Distance (mm): {self.open_image.sid:2.0f}",
            f"Tolerance (%): {self._tolerance * 100:2.1f}",
            f"Absolute mean deviation (%): {self.avg_abs_r_deviation:2.2f}",
            f"Maximum deviation (%): {self.max_r_deviation:2.2f}",
        ]
        if hasattr(self, "rotation_offset_deg"):
            text.append(f"Rotation offset (deg): {self.rotation_offset_deg:2.2f}")
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 5))
        canvas.finish()

    def _segment_results(self, position_key: str, angle) -> tuple[list, dict]:
        segment_data, named = [], {}
        for segment, (roi_name, roi_data) in zip(self.segments, self.roi_config.items()):
            seg = SegmentResult(
                passed=segment.passed, r_corr=segment.r_corr, r_dev=segment.r_dev,
                center_x_y=segment.center.dict(), x_position_mm=roi_data[position_key],
                stdev=segment.stdev, angular_position_deg=angle(roi_data))
            segment_data.append(seg)
            named[roi_name] = seg
        return segment_data, named


class VMATLinearBase(VMATBase, ABC):
    """DRGS and DRMLC: segments in a row across the field."""

    text_rotation = 90

    @property
    def default_segment_size_mm(self) -> tuple[float, float]:
        return 5, 100

    def _identify_images(self, image1, image2):
        """The DMLC image is the one whose field values vary more, unless the
        fields differ in width by more than the narrower one."""
        profile1, profile2 = self._roi_profiles(image1=image1, image2=image2)
        field1 = profile1.field_values()
        field2 = profile2.field_values()
        if abs(len(field1) - len(field2)) > min(len(field1), len(field2)):
            if len(field1) > len(field2):
                self.open_image, self.dmlc_image = image1, image2
            else:
                self.open_image, self.dmlc_image = image2, image1
        elif np.std(field1) > np.std(field2):
            self.dmlc_image, self.open_image = image1, image2
        else:
            self.dmlc_image, self.open_image = image2, image1

    def _roi_profiles(self, image1, image2) -> list[FWXMProfile]:
        profiles = []
        for orig in (image1, image2):
            img = copy.deepcopy(orig)
            img.ground()
            img.check_inversion()
            profile = FWXMProfile(np.mean(img.array, axis=0), ground=True,
                                  normalization=Normalization.BEAM_CENTER)
            profile.stretch()
            profile.normalize(np.percentile(profile.values, 90))
            profiles.append(profile)
        return profiles

    def _generate_results_data(self) -> VMATResult:
        segment_data, named = self._segment_results("offset_mm", lambda _: 0)
        return VMATResult(
            test_type=self._result_header,
            tolerance_percent=self._tolerance * 100,
            max_deviation_percent=self.max_r_deviation,
            abs_mean_deviation=self.avg_abs_r_deviation,
            passed=self.passed,
            segment_data=segment_data,
            named_segment_data=named)

    def _calculate_segments(self, segment_size_mm):
        y = self.open_image.center.y
        _, open_prof = self._roi_profiles(self.dmlc_image, self.open_image)
        x_field_center = round(open_prof.center_idx)
        image_width = self.dmlc_image.shape[1]
        if not (image_width / 3 <= x_field_center <= image_width * 2 / 3):
            warnings.warn(
                "The detected VMAT field center is outside the center third of the "
                "image; using the image center instead.", UserWarning)
            x_field_center = round(self.open_image.center.x)
        dpmm = self.open_image.dpmm
        for roi_data in self.roi_config.values():
            x = x_field_center + roi_data["offset_mm"] * dpmm
            self.segments.append(Segment(
                Point(x, y), width=segment_size_mm[0] * dpmm,
                height=segment_size_mm[1] * dpmm, ratio_image=self.ratio_image,
                tolerance=self._tolerance))


@capture_warnings
class DRGS(VMATLinearBase):
    """The dose rate and gantry speed VMAT test."""

    _result_header = "Dose Rate & Gantry Speed"
    _result_short_header = "DR/GS"

    @property
    def default_roi_config(self) -> dict:
        return {f"ROI {i + 1}": {"offset_mm": offset}
                for i, offset in enumerate((-60, -40, -20, 0, 20, 40, 60))}


@capture_warnings
class DRMLC(VMATLinearBase):
    """The dose rate and MLC speed VMAT test."""

    _result_header = "Dose Rate & MLC Speed"
    _result_short_header = "DR/MLCS"

    @property
    def default_roi_config(self) -> dict:
        return {f"ROI {i + 1}": {"offset_mm": offset}
                for i, offset in enumerate((-45, -15, 15, 45))}


@capture_warnings
class DRCS(VMATBase):
    """The dose rate and collimator speed VMAT test: segments on a circle,
    and the collimator spokes' angles."""

    text_rotation = 0
    _result_header = "Dose Rate & Collimator Speed"
    _result_short_header = "DR/CS"
    _default_radial_distance = 50

    @property
    def default_segment_size_mm(self) -> tuple[float, float]:
        return 40, 10

    @property
    def default_roi_config(self) -> dict:
        return {f"ROI {i + 1}": {"radial_distance": self._default_radial_distance,
                                 "angle": angle}
                for i, angle in enumerate((-120, -60, 0, 60, 120))}

    @property
    def default_collimator_config(self) -> dict[str, float]:
        return {"A": 150, "B": 90, "C": 30, "D": 330, "E": 270, "F": 210}

    @property
    def default_collimator_radial_distances(self) -> tuple[float, float]:
        return 30, 70

    @property
    def rotation_offset_deg(self) -> float:
        return float(np.mean([cd.angle_deviation for cd in self.collimator_deviations]))

    def analyze(self, tolerance: float = 1.5, segment_size_mm: tuple | None = None,
                roi_config: dict | None = None,
                collimator_radial_distances: tuple[float, float] | None = None,
                collimator_config: dict | None = None,
                invert_image_order: bool = False):
        super().analyze(tolerance, segment_size_mm, roi_config,
                        invert_image_order=invert_image_order)
        cc = collimator_config or self.default_collimator_config
        crd = collimator_radial_distances or self.default_collimator_radial_distances
        self._calculate_collimator_deviations(cc, crd)

    def _median_sum(self, img) -> float:
        """The sum of the frame's size-10 median, normalised to its maximum."""
        arr = torch.from_numpy(np.asarray(img.array, np.float32)).to(self.device)
        return normalize(median_filter(arr, 10).cpu().numpy()).sum()

    def _identify_images(self, image1, image2):
        """The open image is the one whose normalised median sums higher."""
        if self._median_sum(image1) > self._median_sum(image2):
            self.open_image, self.dmlc_image = image1, image2
        else:
            self.open_image, self.dmlc_image = image2, image1

    def _roi_profiles(self, image1, image2):
        profiles = []
        for orig in (image1, image2):
            img = copy.deepcopy(orig)
            img.ground()
            profiles.append(FWXMProfile(np.median(img.array, axis=0), ground=True,
                                        normalization=Normalization.MAX))
        return profiles

    def _generate_results_data(self) -> DRCSResult:
        segment_data, named = self._segment_results("radial_distance", lambda r: r["angle"])
        coll_data = {cd.name: CollimatorResult(angle_deviation=cd.angle_deviation,
                                               angle_nominal=cd.angle_nominal)
                     for cd in self.collimator_deviations}
        return DRCSResult(
            test_type=self._result_header,
            tolerance_percent=self._tolerance * 100,
            max_deviation_percent=self.max_r_deviation,
            abs_mean_deviation=self.avg_abs_r_deviation,
            passed=self.passed,
            segment_data=segment_data,
            named_segment_data=named,
            rotation_offset_deg=self.rotation_offset_deg,
            collimator_data=coll_data)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        rd = self.results_data(as_dict=True)
        data = super()._quaac_datapoints()
        data["Rotation Offset"] = QuaacDatum(value=rd["rotation_offset_deg"], unit="deg")
        return data

    def _calculate_segments(self, segment_size_mm):
        dpmm = self.open_image.dpmm
        cx, cy = self.open_image.center.x, self.open_image.center.y
        for roi_data in self.roi_config.values():
            r_px = roi_data["radial_distance"] * dpmm
            im_angle = -roi_data["angle"] - 90
            theta = np.deg2rad(im_angle)
            self.segments.append(Segment(
                center_point=Point(cx + r_px * np.cos(theta), cy + r_px * np.sin(theta)),
                width=segment_size_mm[0] * dpmm, height=segment_size_mm[1] * dpmm,
                ratio_image=self.ratio_image, tolerance=self._tolerance, rotation=im_angle))

    def _calculate_collimator_deviations(self, collimator_config, collimator_radial_distances):
        """Each configured spoke: the peak pair, one on each circle of the
        ratio image, whose angle lies nearest its nominal angle."""
        if len(collimator_config) < 1:
            self.collimator_deviations = []
            return
        sorted_angles = np.sort(np.fromiter(collimator_config.values(), dtype=float))
        gaps = np.diff(sorted_angles)
        wrap_gap = (sorted_angles[0] + 360) - sorted_angles[-1]
        min_diff_angle = min(np.min(gaps) if len(gaps) else wrap_gap, wrap_gap)

        crd_px = np.array(collimator_radial_distances) * self.dmlc_image.dpmm
        peaks = []
        for crd in crd_px:
            circle_profile = CircleProfile(
                center=self.dmlc_image.center, radius=crd,
                image_array=self.ratio_image, start_angle=math.pi / 2)
            min_distance = 2 * np.pi * crd / 360 * 0.9 * min_diff_angle
            circle_profile.find_peaks(min_distance=min_distance, threshold=0.8)
            peaks.append(circle_profile.peaks)
        if not peaks:
            raise ValueError("Could not detect collimator lines.")
        num_detected = len(peaks[0])
        if any(len(p) != num_detected for p in peaks):
            raise ValueError(
                "Could not consistently detect collimator lines across radii. "
                f"Detected {[len(p) for p in peaks]} peaks across radii.")
        if len(collimator_config) > num_detected:
            raise ValueError(
                f"Configured {len(collimator_config)} collimator spokes but only "
                f"detected {num_detected}.")
        candidate_points = list(zip(*peaks))
        measured_angles = np.array([
            CollimatorDeviation.calculate_angle_measured(pts[0], pts[1])
            for pts in candidate_points])
        self.collimator_deviations = []
        for name, nominal in collimator_config.items():
            deltas = np.abs(wrap180(measured_angles - float(nominal)))
            pts = candidate_points[int(np.argmin(deltas))]
            self.collimator_deviations.append(
                CollimatorDeviation(name, float(nominal), (pts[0], pts[1])))
