"""2D planar phantom analysis (kV/MV imaging QA).

Port of ``pylinac_tpu/planar_imaging.py``: ``PlanarResult`` ``:49``,
``LightRadResult`` ``:65``, the helpers ``:76-163`` (``hough_line`` and
``hough_line_peaks`` host numpy), ``_CannyRegion`` ``:165``,
``ImagePhantomBase`` ``:188-500``, the light/rad family
(``StandardImagingFC2`` ``:788``, ``IMTLRad``, ``DoselabRLf``,
``IsoAlign``, ``SNCFSQA``), the low-contrast and MTF phantoms
(``LasVegas`` ``:1069``, ``ElektaLasVegas``, ``PTWEPIDQC`` ``:1216``,
``IBAPrimusA`` ``:1273``, ``StandardImagingQC3`` ``:1378``,
``StandardImagingQCkV``, ``SNCkV`` ``:1461``, ``SNCMV``, ``SNCMV12510``,
``LeedsTOR`` ``:1574``, ``LeedsTORBlue``, ``DoselabMC2kV`` ``:1753``,
``DoselabMC2MV``) and ``ACRDigitalMammography`` ``:1849`` with its speck
and fibre ROIs and ``ACRDigitalMammographyResult``.

Detection runs on ``analyze``'s ``device`` (``None`` means CUDA):
:func:`.ops.edges.canny` on the frame, then ``keep_largest`` (K = 96,
8-connected) and ``regionprops`` (K = 128, no hull), which label through
``csrc/ccl.cu``. The FC-2 family's 3x3 medians run ``csrc/median3x3.cu``
on the frame, its high-pass Gaussian in XLA's contracted sums
(:mod:`.ops.filters`); the mammography fibres run :func:`.ops.vesselness.frangi`,
a binary closing and ``regionprops`` on the device. ROI sampling, MTF and
contrast are host numpy, as in JAX; the circle profiles stay on the CPU.
The class-level ROI lists are shared between instances, as in JAX.

The reports (``ImagePhantomBase`` ``:521-784``, the FC-2 family's
``:930-999``, Las Vegas's contrast graph ``:1141``, the mammography ROIs'
drawing ``:1986``, ``:2061`` and ``ACRDigitalMammography`` ``:2195-2230``)
are JAX's: ``to_quaac`` and ``plotly_analyzed_images`` need no matplotlib;
the plots, ``save_analyzed_image`` and ``publish_pdf`` (which embeds their
PNGs) import it inside and raise ``ModuleNotFoundError`` without it. Not
ported: the demo and URL loaders.
"""

from __future__ import annotations

import dataclasses
import io
import math
import warnings
import webbrowser
from pathlib import Path
from typing import BinaryIO, Callable

import numpy as np
import torch

from .core import contrast, image, pdf
from .core.contrast import Contrast
from .core.exceptions import NotAnalyzed
from .core.geometry import Circle, Point, Rectangle, Vector
from .core.mtf import MTF
from .core.profile import CollapsedCircleProfile, FWXMProfilePhysical, Normalization
from .core.roi import DiskROI, HighContrastDiskROI, LowContrastDiskROI, RectangleROI
from .core.utilities import (QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin,
                             resolve_device)
from .core.warnings import capture_warnings
from .metrics.image import SizedDiskLocator
from .metrics.utils import RegionView, valid_region_views
from .ops import label as tlabel
from .ops.edges import canny
from .ops.filters import gaussian_filter, median_filter
from .ops.morphology import binary_closing, rotate_footprint
from .ops.threshold import threshold_yen
from .ops.vesselness import frangi


@dataclasses.dataclass(kw_only=True)
class PlanarResult(ResultBase):
    """The planar phantoms' result, the JAX model's fields in its order."""

    analysis_type: str
    median_contrast: float
    median_cnr: float
    num_contrast_rois_seen: int
    phantom_center_x_y: tuple[float, float]
    low_contrast_rois: list[dict]
    phantom_area: float
    mtf_lp_mm: list[dict] | None = None
    percent_integral_uniformity: float | None = None


@dataclasses.dataclass(kw_only=True)
class LightRadResult(ResultBase):
    """The light/rad phantoms' result."""

    field_size_x_mm: float
    field_size_y_mm: float
    field_epid_offset_x_mm: float
    field_epid_offset_y_mm: float
    field_bb_offset_x_mm: float
    field_bb_offset_y_mm: float


def _middle_of_bbox_region(region) -> tuple:
    return ((region.bbox[2] - region.bbox[0]) / 2 + region.bbox[0],
            (region.bbox[3] - region.bbox[1]) / 2 + region.bbox[1])


def bbox_center(region) -> Point:
    r, c = _middle_of_bbox_region(region)
    return Point(x=c, y=r)


def is_square(region, instance: object, rtol=0.2) -> bool:
    height = region.bbox[2] - region.bbox[0]
    width = region.bbox[3] - region.bbox[1]
    return math.isclose(height / width, 1, rel_tol=rtol)


def is_centered(region, instance: object, rtol=0.3) -> bool:
    img_center = (instance.image.center.y, instance.image.center.x)
    return np.allclose(_middle_of_bbox_region(region), img_center, rtol=rtol)


def is_right_size(region, instance: object, rtol=0.1) -> bool:
    return bool(np.isclose(region.bbox_area, instance.phantom_bbox_size_px,
                           rtol=rtol))


def percent_integral_uniformity(max: float, min: float) -> float:
    """PIU with a small constant guarding division by zero."""
    return 100 * (1 - (max - min + 1e-6) / (max + min + 1e-6))


def take_centermost_roi(rprops: list, image_shape: tuple[int, int]):
    """The region closest to the image center."""
    center = Point(image_shape[1] / 2, image_shape[0] / 2)
    return min(rprops, key=lambda r: bbox_center(r).distance_to(center))


# ---------------------------------------------------------------------------
# Hough line transform (replaces skimage.transform.hough_line for the
# Doselab MC2 angle finder and the jaw orthogonality). The accumulation is a
# vectorized projection and one bincount over the flattened (distance,
# angle) index, host numpy: the counts of JAX's ``np.add.at``, several
# times faster.
# ---------------------------------------------------------------------------

def hough_line(image: np.ndarray, theta: np.ndarray):
    rows, cols = np.nonzero(image)
    offset = int(np.ceil(np.hypot(*image.shape)))
    nbins = 2 * offset + 1
    n_theta = len(theta)
    if not len(rows):
        return np.zeros((nbins, n_theta), np.uint64), theta, np.arange(-offset, offset + 1)
    dists = cols[:, None] * np.cos(theta) + rows[:, None] * np.sin(theta)
    idx = np.round(dists).astype(int) + offset
    flat = (idx * n_theta + np.arange(n_theta)).ravel()
    acc = np.bincount(flat, minlength=nbins * n_theta).reshape(nbins, n_theta)
    return acc.astype(np.uint64), theta, np.arange(-offset, offset + 1)


def hough_line_peaks(hspace, angles, dists, min_distance=9, min_angle=10,
                     num_peaks=np.inf):
    """Greedy peak selection with (dist, angle) suppression windows.

    A line near theta = +/-90deg votes at BOTH ends of the angle axis (with
    negated distance), so suppression also covers each accepted peak's
    antipodal twin — matching skimage's wrap handling."""
    n_dist, n_angle = hspace.shape
    order = np.argsort(hspace, axis=None)[::-1]
    accepted = []
    suppressors = []  # (i, j) windows incl. antipodal twins

    def near(i, j, si, sj):
        return abs(i - si) <= min_distance and abs(j - sj) <= min_angle

    for flat in order:
        i, j = np.unravel_index(flat, hspace.shape)
        if hspace[i, j] == 0:
            break
        if any(near(i, j, si, sj) for si, sj in suppressors):
            continue
        accepted.append((i, j))
        suppressors.append((i, j))
        # antipodal twin: angle shifted by pi (the full axis), dist mirrored
        twin_j = j + n_angle if j < n_angle / 2 else j - n_angle
        suppressors.append((n_dist - 1 - i, twin_j))
        if len(accepted) >= num_peaks:
            break
    accums = np.array([hspace[i, j] for i, j in accepted])
    return accums, np.array([angles[j] for _, j in accepted]), np.array(
        [dists[i] for i, _ in accepted])


class _CannyRegion:
    """RegionView + the canny mask it came from, exposing the skimage
    ``image``/``image_intensity`` crops the phantom finders use."""

    def __init__(self, view: RegionView, mask: np.ndarray, intensity: np.ndarray):
        self._view = view
        self._mask = mask
        self._intensity = intensity

    def __getattr__(self, item):
        return getattr(self._view, item)

    @property
    def image(self) -> np.ndarray:
        r0, c0, r1, c1 = self._view.bbox
        return self._mask[r0:r1, c0:c1]

    @property
    def image_intensity(self) -> np.ndarray:
        r0, c0, r1, c1 = self._view.bbox
        return self._intensity[r0:r1, c0:c1]


class ImagePhantomBase(ResultsDataMixin, QuaacMixin):
    """Planar phantom analysis engine."""

    _demo_filename: str
    common_name: str
    _LABEL_KWARGS = frozenset({"show_roi_labels", "roi_label_font_size"})
    high_contrast_roi_settings: dict = {}
    high_contrast_rois: list = []
    low_contrast_roi_settings: dict = {}
    low_contrast_rois: list = []
    low_contrast_background_roi_settings: dict = {}
    low_contrast_background_rois: list = []
    low_contrast_background_value = None
    phantom_outline_object = None
    detection_conditions: list[Callable] = [is_centered, is_right_size]
    detection_canny_settings = {"sigma": 2, "percentiles": (0.001, 0.01)}
    phantom_bbox_size_mm2: float
    roi_match_condition: str = "max"
    mtf: MTF | None = None

    def __init__(self, filepath: str | BinaryIO | Path, normalize: bool = True,
                 image_kwargs: dict | None = None):
        super().__init__()
        self.image = image.load(filepath, **(image_kwargs or {}))
        if normalize:
            self.image.ground()
            self.image.normalize()
        self._angle_override = None
        self._size_override = None
        self._center_override = None
        self._high_contrast_threshold = None
        self._low_contrast_threshold = None
        self._phantom_region_cache = None
        self.x_adjustment = 0.0
        self.y_adjustment = 0.0
        self.angle_adjustment = 0.0
        self.roi_size_factor = 1.0
        self.scaling_factor = 1.0
        self._device = None

    def _preprocess(self):
        pass

    def _check_inversion(self):
        pass

    # ------------------------------------------------------------------ #
    #                          phantom detection                         #
    # ------------------------------------------------------------------ #

    @property
    def device(self) -> torch.device:
        """Where detection, the frame filters and the fibres run: the
        ``device`` of the last ``analyze`` (``None`` means CUDA)."""
        return resolve_device(self._device, type(self).__name__)

    def _get_canny_regions(self) -> list[_CannyRegion]:
        """Canny edges, the 96 largest 8-connected edge components, then
        their region properties, on the analysis device."""
        settings = self.detection_canny_settings
        arr = np.asarray(self.image.array, np.float32)
        dev_arr = torch.from_numpy(arr).to(self.device)
        edges = canny(dev_arr, sigma=float(settings["sigma"]),
                      low_threshold=float(settings["percentiles"][0]),
                      high_threshold=float(settings["percentiles"][1]),
                      use_quantiles=True)
        # low-threshold edges hold unbounded noise clutter: keep the largest
        # components (the phantom outline is by far the biggest), which
        # bounds the slot count; the detection reads no solidity (no hull)
        K = 96
        big = tlabel.keep_largest(edges, K=K, min_area=20, connectivity=2)
        regions = tlabel.regionprops(big, dev_arr, K=K + 32, connectivity=2, hull=False)
        views = valid_region_views(regions)
        edge_mask = edges.cpu().numpy()
        return [_CannyRegion(v, edge_mask, arr) for v in views]

    @property
    def phantom_ski_region(self) -> _CannyRegion:
        if self._phantom_region_cache is not None:
            return self._phantom_region_cache
        regions = self._get_canny_regions()
        sorted_regions = sorted((r for r in regions if r.bbox_area > 100),
                                key=lambda r: -r.bbox_area)
        blobs = [i for i, region in enumerate(sorted_regions)
                 if all(cond(region, self) for cond in self.detection_conditions)]
        if not blobs:
            raise ValueError(
                "Unable to find the phantom in the image. Potential solutions: "
                "check the SSD was passed correctly, check that the phantom "
                "isn't at the edge of the field, check that the phantom is "
                "centered along the CAX.")
        if self.roi_match_condition == "max":
            best = max(blobs, key=lambda i: sorted_regions[i].bbox_area)
        else:  # closest in size to the known size
            best = min(blobs, key=lambda i: abs(
                sorted_regions[i].bbox_area - self.phantom_bbox_size_px))
        self._phantom_region_cache = sorted_regions[best]
        return self._phantom_region_cache

    def _invalidate_phantom_region(self):
        self._phantom_region_cache = None

    @property
    def magnification_factor(self) -> float:
        return self.image.sad / self._ssd

    @property
    def phantom_bbox_size_px(self) -> float:
        return (self.phantom_bbox_size_mm2 * (self.image.dpmm ** 2)
                * (self.magnification_factor ** 2))

    def _find_ssd(self):
        """'auto': search at SAD, then 5cm above the SID."""
        if isinstance(self._ssd, str) and self._ssd.lower() == "auto":
            self._ssd = self.image.metadata.get("RadiationMachineSAD", 1000)
            try:
                self.phantom_ski_region
            except ValueError:
                self._ssd = self.image.metadata.get("RTImageSID", 1500) - 50
                self._invalidate_phantom_region()
                self.phantom_ski_region

    # ------------------------------------------------------------------ #
    #                              analysis                              #
    # ------------------------------------------------------------------ #

    def analyze(self, low_contrast_threshold: float = 0.05,
                high_contrast_threshold: float = 0.5, invert: bool = False,
                angle_override: float | None = None,
                center_override: tuple | None = None,
                size_override: float | None = None,
                ssd: float | str = "auto",
                low_contrast_method: str = Contrast.MICHELSON,
                visibility_threshold: float = 100,
                x_adjustment: float = 0, y_adjustment: float = 0,
                angle_adjustment: float = 0, roi_size_factor: float = 1,
                scaling_factor: float = 1, device=None) -> None:
        """Detect the phantom and sample its ROIs; detection runs on
        ``device`` (``None`` means CUDA)."""
        self._device = device
        resolve_device(device, type(self).__name__)
        self._angle_override = angle_override
        self._center_override = center_override
        self._size_override = size_override
        self._high_contrast_threshold = high_contrast_threshold
        self._low_contrast_threshold = low_contrast_threshold
        self._low_contrast_method = low_contrast_method
        self.visibility_threshold = visibility_threshold
        self.mtf = None
        if roi_size_factor <= 0 or scaling_factor <= 0:
            raise ValueError("ROI size factor and scaling factor must be positive")
        if center_override and any((x_adjustment, y_adjustment)):
            raise ValueError(
                "Cannot set both overrides and adjustments. Use one or the other.")
        if angle_adjustment and angle_override:
            raise ValueError(
                "Cannot set the angle override and angle adjustment "
                "simultaneously. Use one or the other.")
        if size_override and scaling_factor != 1:
            raise ValueError(
                "Cannot set the size override and scaling factor "
                "simultaneously. Use one or the other.")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self._ssd = ssd
        self._find_ssd()
        self._check_inversion()
        if invert:
            self.image.invert()
        self._preprocess()
        if self.high_contrast_roi_settings:
            self.high_contrast_rois = self._sample_high_contrast_rois()
            spacings = [roi["lp/mm"]
                        for roi in self.high_contrast_roi_settings.values()]
            self.mtf = MTF.from_high_contrast_diskset(
                diskset=self.high_contrast_rois, spacings=spacings)
        if self.low_contrast_background_roi_settings:
            (self.low_contrast_background_rois,
             self.low_contrast_background_value) = \
                self._sample_low_contrast_background_rois()
        if self.low_contrast_roi_settings:
            self.low_contrast_rois = self._sample_low_contrast_rois()

    def _sample_low_contrast_rois(self) -> list[LowContrastDiskROI]:
        return [LowContrastDiskROI.from_phantom_center(
            self.image, self.phantom_angle + stng["angle"],
            self.phantom_radius * stng["roi radius"] * self.roi_size_factor,
            self.phantom_radius * stng["distance from center"],
            self.phantom_center, self._low_contrast_threshold,
            self.low_contrast_background_value,
            contrast_method=self._low_contrast_method,
            visibility_threshold=self.visibility_threshold)
            for stng in self.low_contrast_roi_settings.values()]

    def _sample_low_contrast_background_rois(self):
        bg_rois = [LowContrastDiskROI.from_phantom_center(
            self.image, self.phantom_angle + stng["angle"],
            self.phantom_radius * stng["roi radius"] * self.roi_size_factor,
            self.phantom_radius * stng["distance from center"],
            self.phantom_center, self._low_contrast_threshold)
            for stng in self.low_contrast_background_roi_settings.values()]
        avg_bg = np.mean([roi.pixel_value for roi in bg_rois])
        return bg_rois, avg_bg

    def _sample_high_contrast_rois(self) -> list[HighContrastDiskROI]:
        return [HighContrastDiskROI.from_phantom_center(
            self.image, self.phantom_angle + stng["angle"],
            self.phantom_radius * stng["roi radius"] * self.roi_size_factor,
            self.phantom_radius * stng["distance from center"],
            self.phantom_center, self._high_contrast_threshold)
            for stng in self.high_contrast_roi_settings.values()]

    # ------------------------------------------------------------------ #
    #                          derived geometry                          #
    # ------------------------------------------------------------------ #

    @property
    def phantom_center(self) -> Point:
        if self._center_override is not None:
            return Point(self._center_override)
        adjustment = Point(x=self.x_adjustment * self.image.dpmm,
                           y=self.y_adjustment * self.image.dpmm)
        c = self._phantom_center_calc()
        return Point(c.x + adjustment.x, c.y + adjustment.y)

    @property
    def phantom_radius(self) -> float:
        if self._size_override is not None:
            return self._size_override
        return self._phantom_radius_calc() * self.scaling_factor

    @property
    def phantom_angle(self) -> float:
        if self._angle_override is not None:
            return self._angle_override
        return self._phantom_angle_calc() + self.angle_adjustment

    @property
    def phantom_area(self) -> float:
        """Area of the outline object in mm^2."""
        return self._create_phantom_outline_object().area / self.image.dpmm ** 2

    def _phantom_center_calc(self) -> Point:
        return bbox_center(self.phantom_ski_region)

    def _phantom_angle_calc(self) -> float:
        return 0.0

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area)

    def _create_phantom_outline_object(self):
        outline_type = list(self.phantom_outline_object)[0]
        settings = list(self.phantom_outline_object.values())[0]
        if outline_type == "Rectangle":
            return Rectangle(width=self.phantom_radius * settings["width ratio"],
                             height=self.phantom_radius * settings["height ratio"],
                             center=self.phantom_center,
                             rotation=self.phantom_angle)
        if outline_type == "Circle":
            return Circle(center_point=self.phantom_center,
                          radius=self.phantom_radius * settings["radius ratio"])
        raise ValueError(
            "An outline object was passed but was not a Circle or Rectangle.")

    # ------------------------------------------------------------------ #
    #                         results & reporting                        #
    # ------------------------------------------------------------------ #

    def _lcr_min(self) -> float:
        return min(roi.pixel_value for roi in self.low_contrast_rois)

    def _lcr_max(self) -> float:
        return max(roi.pixel_value for roi in self.low_contrast_rois)

    def _wl_spread(self) -> float:
        return abs(self._lcr_max() - self._lcr_min())

    def window_floor(self) -> float | None:
        if self.low_contrast_rois:
            return self._lcr_min() - self._wl_spread()
        return None

    def window_ceiling(self) -> float | None:
        if self.low_contrast_rois:
            return self._lcr_max() + self._wl_spread()
        return None

    def percent_integral_uniformity(self, percentiles=(1, 99)) -> float | None:
        if not self.low_contrast_rois:
            return None
        pius = [percent_integral_uniformity(
            max=roi.percentile(percentiles[1]), min=roi.percentile(percentiles[0]))
            for roi in self.low_contrast_rois]
        return min(pius)

    def results(self, as_list: bool = False) -> str | list[str]:
        text = [f"{self.common_name} results:", f"File: {self.image.truncated_path}"]
        if self.low_contrast_rois:
            text += [
                f"Median Contrast: "
                f"{np.median([roi.contrast for roi in self.low_contrast_rois]):2.2f}",
                f"Median CNR: "
                f"{np.median([roi.contrast_to_noise for roi in self.low_contrast_rois]):2.1f}",
                f'# Low contrast ROIs "seen": '
                f"{sum(roi.passed_visibility for roi in self.low_contrast_rois):2.0f} "
                f"of {len(self.low_contrast_rois)}",
                f"Area: {self.phantom_area:2.2f} mm^2",
            ]
        if self.high_contrast_rois:
            text += [
                f"MTF 80% (lp/mm): {self.mtf.relative_resolution(80):2.2f}",
                f"MTF 50% (lp/mm): {self.mtf.relative_resolution(50):2.2f}",
                f"MTF 30% (lp/mm): {self.mtf.relative_resolution(30):2.2f}",
            ]
        return text if as_list else "\n".join(text)

    def _generate_results_data(self) -> PlanarResult:
        if self._low_contrast_threshold is None:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        data = PlanarResult(
            analysis_type=self.common_name,
            median_contrast=float(np.median(
                [roi.contrast for roi in self.low_contrast_rois])),
            median_cnr=float(np.median(
                [roi.contrast_to_noise for roi in self.low_contrast_rois])),
            num_contrast_rois_seen=int(sum(
                roi.passed_visibility for roi in self.low_contrast_rois)),
            phantom_center_x_y=(self.phantom_center.x, self.phantom_center.y),
            low_contrast_rois=[roi.as_dict() for roi in self.low_contrast_rois],
            percent_integral_uniformity=self.percent_integral_uniformity(),
            phantom_area=self.phantom_area,
        )
        if self.mtf is not None:
            data.mtf_lp_mm = [{p: self.mtf.relative_resolution(p)}
                              for p in list(range(10, 100, 10))[::-1]]
        return data

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data()
        return {
            "Median Contrast": QuaacDatum(
                value=data.median_contrast, unit="",
                description="Median contrast of the low contrast ROIs"),
            "Median CNR": QuaacDatum(
                value=data.median_cnr, unit="",
                description="Median contrast-to-noise ratio"),
            "Num Contrast ROIs Seen": QuaacDatum(
                value=data.num_contrast_rois_seen, unit=""),
            "Percent Integral Uniformity": QuaacDatum(
                value=data.percent_integral_uniformity, unit="%"),
            "Phantom area": QuaacDatum(value=data.phantom_area, unit="pixels"),
        }

    def plot_analyzed_image(self, image: bool = True, low_contrast: bool = True,
                            high_contrast: bool = True, show: bool = True,
                            split_plots: bool = False,
                            show_roi_labels: bool = False,
                            roi_label_font_size="medium", **plt_kwargs):
        import matplotlib.pyplot as plt

        plot_low = low_contrast and bool(self.low_contrast_rois)
        plot_high = high_contrast and bool(self.high_contrast_rois)
        num_plots = sum((image, plot_low, plot_high))
        figs, names = [], []
        if split_plots:
            axes = []
            for _ in range(num_plots):
                fig, axis = plt.subplots(1)
                figs.append(fig)
                axes.append(axis)
        else:
            fig, axes = plt.subplots(1, num_plots)
            figs = [fig]
            if num_plots < 2:
                axes = [axes]
            axes = list(np.atleast_1d(np.asarray(axes)).ravel())
        if image:
            img_ax = axes.pop(0)
            names.append("image")
            img_ax.imshow(self.image.array, cmap="gray",
                          vmin=self.window_floor(), vmax=self.window_ceiling())
            img_ax.axis("off")
            img_ax.set_title(f"{self.common_name} Phantom Analysis")
            if self.phantom_outline_object is not None:
                outline = self._create_phantom_outline_object()
                if isinstance(outline, Circle):
                    img_ax.add_patch(plt.Circle(
                        (outline.center.x, outline.center.y), outline.radius,
                        fill=False, edgecolor="b"))
                else:
                    img_ax.add_patch(plt.Rectangle(
                        (outline.center.x - outline.width / 2,
                         outline.center.y - outline.height / 2),
                        outline.width, outline.height, angle=0,
                        fill=False, edgecolor="b"))
            for roi in self.low_contrast_background_rois:
                img_ax.add_patch(plt.Circle((roi.center.x, roi.center.y),
                                            roi.radius, fill=False, edgecolor="b"))
            for roi in self.low_contrast_rois:
                img_ax.add_patch(plt.Circle((roi.center.x, roi.center.y),
                                            roi.radius, fill=False,
                                            edgecolor=roi.plot_color))
            if self.high_contrast_rois:
                for roi, mtf in zip(self.high_contrast_rois,
                                    self.mtf.norm_mtfs.values()):
                    color = ("b" if mtf > self._high_contrast_threshold else "r")
                    img_ax.add_patch(plt.Circle((roi.center.x, roi.center.y),
                                                roi.radius, fill=False,
                                                edgecolor=color))
            img_ax.scatter(x=self.phantom_center.x, y=self.phantom_center.y,
                           marker="x")
        if plot_low:
            lowcon_ax = axes.pop(0)
            names.append("low_contrast")
            self._plot_lowcontrast_graph(lowcon_ax)
        if plot_high:
            hicon_ax = axes.pop(0)
            names.append("high_contrast")
            self._plot_highcontrast_graph(hicon_ax)
        if show:
            plt.show()
        return figs, names

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`): the marked
        image and the low- and high-contrast graphs, ``{name: Figure}``."""
        from .core import plotly_utils as pu

        figs: dict[str, pu.Figure] = {}
        fig = pu.image_figure(self.image.array,
                              title=f"{self.common_name} Phantom Analysis",
                              show_colorbar=show_colorbar,
                              zmin=self.window_floor(), zmax=self.window_ceiling(),
                              **kwargs)
        shapes = fig.layout.setdefault("shapes", [])
        if self.phantom_outline_object is not None:
            outline = self._create_phantom_outline_object()
            if isinstance(outline, Circle):
                shapes.append({
                    "type": "circle",
                    "x0": outline.center.x - outline.radius,
                    "x1": outline.center.x + outline.radius,
                    "y0": outline.center.y - outline.radius,
                    "y1": outline.center.y + outline.radius,
                    "line": {"color": "blue"}})
            else:
                shapes.append({
                    "type": "rect",
                    "x0": outline.center.x - outline.width / 2,
                    "x1": outline.center.x + outline.width / 2,
                    "y0": outline.center.y - outline.height / 2,
                    "y1": outline.center.y + outline.height / 2,
                    "line": {"color": "blue"}})
        for roi in self.low_contrast_background_rois:
            shapes.append({
                "type": "circle",
                "x0": roi.center.x - roi.radius, "x1": roi.center.x + roi.radius,
                "y0": roi.center.y - roi.radius, "y1": roi.center.y + roi.radius,
                "line": {"color": "blue"}})
        for roi in self.low_contrast_rois:
            shapes.append({
                "type": "circle",
                "x0": roi.center.x - roi.radius, "x1": roi.center.x + roi.radius,
                "y0": roi.center.y - roi.radius, "y1": roi.center.y + roi.radius,
                "line": {"color": roi.plot_color}})
        if self.high_contrast_rois:
            for roi, mtf in zip(self.high_contrast_rois,
                                self.mtf.norm_mtfs.values()):
                color = "blue" if mtf > self._high_contrast_threshold else "red"
                shapes.append({
                    "type": "circle",
                    "x0": roi.center.x - roi.radius, "x1": roi.center.x + roi.radius,
                    "y0": roi.center.y - roi.radius, "y1": roi.center.y + roi.radius,
                    "line": {"color": color}})
        fig.add_trace(pu.marker_trace([self.phantom_center.x],
                                      [self.phantom_center.y], name="Center",
                                      symbol="x", showlegend=show_legend))
        figs["Image"] = fig

        if self.low_contrast_rois:
            low = pu.Figure()
            low.add_trace(pu.scatter_trace(
                np.arange(len(self.low_contrast_rois)),
                [r.contrast for r in self.low_contrast_rois],
                name="Contrast", mode="lines+markers"))
            low.add_trace(pu.scatter_trace(
                np.arange(len(self.low_contrast_rois)),
                [r.contrast_to_noise for r in self.low_contrast_rois],
                name="CNR", mode="lines+markers", yaxis="y2"))
            pu.add_horizontal_line(low, self._low_contrast_threshold,
                                   color="magenta")
            pu.add_title(low, "Low-frequency Contrast")
            low.update_layout(xaxis_title="ROI #", yaxis_title="Contrast",
                              showlegend=show_legend)
            low.layout["yaxis2"] = {"title": "CNR", "overlaying": "y",
                                    "side": "right"}
            figs["Low Contrast"] = low
        if self.high_contrast_rois:
            hi = pu.Figure()
            hi.add_trace(pu.scatter_trace(
                list(self.mtf.norm_mtfs.keys()),
                list(self.mtf.norm_mtfs.values()),
                name="rMTF", mode="lines+markers"))
            pu.add_horizontal_line(hi, self._high_contrast_threshold)
            pu.add_title(hi, "High-frequency rMTF")
            hi.update_layout(xaxis_title="Line pairs / mm",
                             yaxis_title="relative MTF", showlegend=show_legend)
            figs["High Contrast"] = hi
        if show:
            for f in figs.values():
                f.show()
        return figs

    def _plot_lowcontrast_graph(self, axes):
        (line1,) = axes.plot(
            [roi.contrast for roi in self.low_contrast_rois],
            marker="o", color="m", label="Contrast")
        axes.axhline(self._low_contrast_threshold, color="m")
        axes.grid(True)
        axes.set_title("Low-frequency Contrast")
        axes.set_xlabel("ROI #")
        axes.set_ylabel("Contrast")
        axes2 = axes.twinx()
        axes2.set_ylabel("CNR")
        (line2,) = axes2.plot(
            [roi.contrast_to_noise for roi in self.low_contrast_rois],
            marker="^", label="CNR")
        axes.legend(handles=[line1, line2])

    def _plot_highcontrast_graph(self, axes):
        axes.plot(list(self.mtf.norm_mtfs.keys()),
                  list(self.mtf.norm_mtfs.values()), marker="*")
        axes.axhline(self._high_contrast_threshold, color="k")
        axes.grid(True)
        axes.set_title("High-frequency rMTF")
        axes.set_xlabel("Line pairs / mm")
        axes.set_ylabel("relative MTF")

    def save_analyzed_image(self, filename=None, split_plots: bool = False,
                            to_streams: bool = False, **kwargs):
        import matplotlib.pyplot as plt

        if filename is None and to_streams is False:
            raise ValueError("Must pass in a filename unless saving to streams.")
        figs, names = self.plot_analyzed_image(show=False, split_plots=split_plots,
                                               **kwargs)
        for key in ("image", "low_contrast", "high_contrast", "show",
                    *self._LABEL_KWARGS):
            kwargs.pop(key, None)
        if not split_plots:
            plt.savefig(filename, **kwargs)
            return None
        if not to_streams:
            import os.path as osp

            f, ext = osp.splitext(filename)
            filenames = [f + "_" + name + ext for name in names]
        else:
            filenames = [io.BytesIO() for _ in names]
        for fig, fname in zip(figs, filenames):
            fig.savefig(fname, **kwargs)
        if to_streams:
            return dict(zip(names, filenames))
        return filenames

    def publish_pdf(self, filename: str, notes: str | None = None,
                    open_file: bool = False, metadata: dict | None = None,
                    logo=None):
        canvas = pdf.PylinacCanvas(
            filename, page_title=f"{self.common_name} Phantom Analysis",
            metadata=metadata, logo=logo)
        canvas.add_text(text=self.results(as_list=True), location=(1.5, 25),
                        font_size=14)
        if notes is not None:
            canvas.add_text(text="Notes:", location=(1, 5.5), font_size=12)
            canvas.add_text(text=notes, location=(1, 5))
        data = io.BytesIO()
        self.save_analyzed_image(data, image=True, low_contrast=False,
                                 high_contrast=False)
        canvas.add_image(data, location=(1, 3.5), dimensions=(19, 19))
        if self.high_contrast_rois:
            canvas.add_new_page()
            data = io.BytesIO()
            self.save_analyzed_image(data, image=False, low_contrast=False,
                                     high_contrast=True)
            canvas.add_image(data, location=(1, 7), dimensions=(19, 19))
        if self.low_contrast_rois:
            canvas.add_new_page()
            data = io.BytesIO()
            self.save_analyzed_image(data, image=False, low_contrast=True,
                                     high_contrast=False)
            canvas.add_image(data, location=(1, 7), dimensions=(19, 19))
        canvas.finish()
        if open_file:
            webbrowser.open(filename)

# --------------------------------------------------------------------------- #
#                          light/rad (FC-2 family)                            #
# --------------------------------------------------------------------------- #

@capture_warnings
class StandardImagingFC2(ImagePhantomBase):
    """SI FC-2 light/rad phantom."""

    common_name = "SI FC-2"
    _demo_filename = "fc2.dcm"
    # mm offsets from image center to the nominal BB positions
    bb_positions_10x10 = {"TL": [-40, -40], "BL": [-40, 40],
                          "TR": [40, -40], "BR": [40, 40]}
    bb_positions_15x15 = {"TL": [-65, -65], "BL": [-65, 65],
                          "TR": [65, -65], "BR": [65, 65]}
    bb_sampling_box_size_mm = 10
    field_strip_width_mm = 5
    bb_size_mm = 4

    def analyze(self, invert: bool = False, fwxm: int = 50,
                bb_edge_threshold_mm: float = 10,
                kernel_size_multiplier: float = 2.0, device=None) -> None:
        """Field edges from strip profiles, then the BBs; the frame's
        medians, the high-pass and the BB windows run on ``device``
        (``None`` means CUDA)."""
        self._device = device
        resolve_device(device, type(self).__name__)
        self.bb_edge_threshold_mm = bb_edge_threshold_mm
        self.kernel_size_multiplier = kernel_size_multiplier
        self._check_inversion()
        if invert:
            self.image.invert()
        (self.field_center, self.field_width_x,
         self.field_width_y) = self._find_field_info(fwxm=fwxm)
        self.bb_center = self._find_overall_bb_centroid(fwxm=fwxm)
        self.epid_center = self.image.center

    def _check_inversion(self):
        self.image.check_inversion()

    def _find_field_info(self, fwxm: int):
        """Strip-sample through the image center in both planes."""
        sample_width = self.field_strip_width_mm / 2 * self.image.dpmm
        x_bounds = (int(self.image.center.x - sample_width),
                    int(self.image.center.x + sample_width))
        y_img = np.mean(self.image[:, x_bounds[0]:x_bounds[1]], 1)
        y_prof = FWXMProfilePhysical(values=y_img, dpmm=self.image.dpmm,
                                     normalization=Normalization.BEAM_CENTER,
                                     ground=True, fwxm_height=fwxm)
        y = y_prof.center_idx
        field_width_y = y_prof.field_width_mm
        y_bounds = (int(self.image.center.y - sample_width),
                    int(self.image.center.y + sample_width))
        x_img = np.mean(self.image[y_bounds[0]:y_bounds[1], :], 0)
        x_prof = FWXMProfilePhysical(values=x_img, dpmm=self.image.dpmm,
                                     normalization=Normalization.BEAM_CENTER,
                                     ground=True, fwxm_height=fwxm)
        x = x_prof.center_idx
        field_width_x = x_prof.field_width_mm
        return Point(x=x, y=y), field_width_x, field_width_y

    def _find_overall_bb_centroid(self, fwxm: int) -> Point:
        self.bb_centers = bb_centers = self._detect_bb_centers(fwxm)
        return Point(x=np.mean([p.x for p in bb_centers.values()]),
                     y=np.mean([p.y for p in bb_centers.values()]))

    def _detect_bb_centers(self, fwxm: int) -> dict:
        bb_positions = {}
        nominal_positions = self._determine_bb_set(fwxm=fwxm)
        device = self.device
        self.image.filter(size=3, kind="median", device=device)
        for key, position in nominal_positions.items():
            near_edge = self._is_bb_near_edge(bb_position=position)
            if near_edge:
                # a high-pass lifts the BB off the nearby field edge for the
                # weighted centroid; the Gaussian is JAX's jitted graph's sums
                original_array = np.copy(self.image.array)
                arr = self.image.array.astype(np.float32)
                bb_radius_px = self.bb_size_mm / 2 * self.image.dpmm
                bg = gaussian_filter(torch.from_numpy(arr).to(device),
                                     float(bb_radius_px * self.kernel_size_multiplier)
                                     ).cpu().numpy()
                self.image.array = arr - bg
                self.image.filter(size=3, kind="median", device=device)
            points = self.image.compute(
                SizedDiskLocator.from_center_physical(
                    expected_position_mm=position,
                    search_window_mm=(self.bb_sampling_box_size_mm,
                                      self.bb_sampling_box_size_mm),
                    radius_mm=self.bb_size_mm / 2,
                    radius_tolerance_mm=self.bb_size_mm / 2, device=device))
            if near_edge:
                self.image.array = original_array
            bb_positions[key] = points[0]
        return bb_positions

    def _determine_bb_set(self, fwxm: int) -> dict:
        if not np.allclose(self.field_width_x, self.field_width_y, atol=10):
            raise ValueError(
                "The detected y and x field sizes were too different from one "
                "another. They should be within 1cm from each other. Detected "
                f"field sizes: x={self.field_width_x:.2f}mm, "
                f"y={self.field_width_y:.2f}mm")
        return (self.bb_positions_15x15 if self.field_width_x > 140
                else self.bb_positions_10x10)

    def _is_bb_near_edge(self, bb_position) -> bool:
        threshold = self.bb_edge_threshold_mm
        near_horizontal = abs(bb_position[0]) > self.field_width_x / 2 - threshold
        near_vertical = abs(bb_position[1]) > self.field_width_y / 2 - threshold
        return near_horizontal or near_vertical

    @property
    def field_epid_offset_mm(self) -> Vector:
        return (self.epid_center.as_vector()
                - self.field_center.as_vector()) / self.image.dpmm

    @property
    def field_bb_offset_mm(self) -> Vector:
        return (self.bb_center.as_vector()
                - self.field_center.as_vector()) / self.image.dpmm

    def results(self, as_list: bool = False) -> str | list[str]:
        text = [
            f"{self.common_name} results:",
            f"File: {self.image.truncated_path}",
            f"The detected inplane field size was {self.field_width_y:2.1f}mm",
            f"The detected crossplane field size was {self.field_width_x:2.1f}mm",
            f"The inplane field was {self.field_epid_offset_mm.y:2.1f}mm "
            "from the EPID CAX",
            f"The crossplane field was {self.field_epid_offset_mm.x:2.1f}mm "
            "from the EPID CAX",
            f"The inplane field was {self.field_bb_offset_mm.y:2.1f}mm "
            "from the BB inplane center",
            f"The crossplane field was {self.field_bb_offset_mm.x:2.1f}mm "
            "from the BB crossplane center",
        ]
        return text if as_list else "\n".join(text)

    def _generate_results_data(self) -> LightRadResult:
        if not hasattr(self, "field_center"):
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        return LightRadResult(
            field_size_x_mm=self.field_width_x,
            field_size_y_mm=self.field_width_y,
            field_epid_offset_x_mm=self.field_epid_offset_mm.x,
            field_epid_offset_y_mm=self.field_epid_offset_mm.y,
            field_bb_offset_x_mm=self.field_bb_offset_mm.x,
            field_bb_offset_y_mm=self.field_bb_offset_mm.y)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data()
        return {
            "Field size (X)": QuaacDatum(value=data.field_size_x_mm, unit="mm"),
            "Field size (Y)": QuaacDatum(value=data.field_size_y_mm, unit="mm"),
            "Field EPID offset (X)": QuaacDatum(
                value=data.field_epid_offset_x_mm, unit="mm"),
            "Field EPID offset (Y)": QuaacDatum(
                value=data.field_epid_offset_y_mm, unit="mm"),
            "Field BB offset (X)": QuaacDatum(
                value=data.field_bb_offset_x_mm, unit="mm"),
            "Field BB offset (Y)": QuaacDatum(
                value=data.field_bb_offset_y_mm, unit="mm"),
        }

    def plot_analyzed_image(self, show: bool = True, **kwargs):
        import matplotlib.pyplot as plt

        for key in ImagePhantomBase._LABEL_KWARGS:
            kwargs.pop(key, None)
        fig, axes = plt.subplots(1)
        axes.imshow(self.image.array, cmap="gray")
        axes.axis("off")
        axes.set_title(f"{self.common_name} Phantom Analysis")
        axes.axhline(y=self.bb_center.y, color="g", xmin=0.25, xmax=0.75,
                     label="BB Centroid")
        axes.axvline(x=self.bb_center.x, color="g", ymin=0.25, ymax=0.75)
        axes.axhline(y=self.epid_center.y, color="b", label="EPID Center")
        axes.axvline(x=self.epid_center.x, color="b")
        axes.axhline(y=self.field_center.y, xmin=0.15, xmax=0.85, color="red",
                     label="Field Center")
        axes.axvline(x=self.field_center.x, ymin=0.15, ymax=0.85, color="red")
        axes.legend()
        if show:
            plt.show()
        return [fig], ["image"]

    def save_analyzed_image(self, filename=None, to_streams: bool = False,
                            **kwargs):
        import matplotlib.pyplot as plt

        if filename is None and to_streams is False:
            raise ValueError("Must pass in a filename unless saving to streams.")
        figs, names = self.plot_analyzed_image(show=False, **kwargs)
        if not to_streams:
            plt.savefig(filename, **kwargs)
            return None
        streams = [io.BytesIO() for _ in names]
        for fig, stream in zip(figs, streams):
            fig.savefig(stream, **kwargs)
        return dict(zip(names, streams))

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None, logo=None):
        canvas = pdf.PylinacCanvas(
            filename, page_title=f"{self.common_name} Phantom Analysis",
            metadata=metadata, logo=logo)
        canvas.add_text(text=self.results(as_list=True), location=(1.5, 25),
                        font_size=14)
        if notes is not None:
            canvas.add_text(text="Notes:", location=(1, 5.5), font_size=12)
            canvas.add_text(text=notes, location=(1, 5))
        data = io.BytesIO()
        self.save_analyzed_image(data, to_streams=True)
        canvas.add_image(list(self.save_analyzed_image(to_streams=True).values())[0],
                         location=(1, 3.5), dimensions=(19, 19))
        canvas.finish()
        if open_file:
            webbrowser.open(filename)

@capture_warnings
class IMTLRad(StandardImagingFC2):
    """IMT L-Rad single-center-BB light/rad phantom."""

    common_name = "IMT L-Rad"
    _demo_filename = "imtlrad.dcm"
    center_only_bb = {"Center": [0, 0]}
    bb_sampling_box_size_mm = 12
    field_strip_width_mm = 5
    bb_size_mm = 3

    def _determine_bb_set(self, fwxm: int) -> dict:
        return self.center_only_bb


@capture_warnings
class DoselabRLf(StandardImagingFC2):
    """Doselab RLf light/rad phantom."""

    common_name = "Doselab RLf"
    _demo_filename = "Doselab_RLf.dcm"
    bb_positions_10x10 = {"TL": [-17, -45], "BL": [-45, 17],
                          "TR": [45, -17], "BR": [17, 45]}

    def _determine_bb_set(self, fwxm: int) -> dict:
        return self.bb_positions_10x10


@capture_warnings
class IsoAlign(StandardImagingFC2):
    """PTW Iso-Align light/rad phantom."""

    common_name = "PTW Iso-Align"
    _demo_filename = "ptw_isoalign.dcm"
    bb_positions = {"Center": [0, 0], "Top": [0, -25], "Bottom": [0, 25],
                    "Left": [-25, 0], "Right": [25, 0]}
    field_strip_width_mm = 10

    def _determine_bb_set(self, fwxm: int) -> dict:
        return self.bb_positions


@capture_warnings
class SNCFSQA(StandardImagingFC2):
    """SNC FSQA light/rad phantom; one offset BB defines a virtual center."""

    common_name = "SNC FSQA"
    _demo_filename = "FSQA_15x15.dcm"
    center_only_bb = {"TR": [40, -40]}
    field_strip_width_mm = 5

    def _determine_bb_set(self, fwxm: int) -> dict:
        return self.center_only_bb

    def _find_overall_bb_centroid(self, fwxm: int) -> Point:
        self.bb_centers = self._detect_bb_centers(fwxm)
        tr = self.bb_centers["TR"]
        virtual = Point(tr.x - 40 * self.image.dpmm, tr.y + 40 * self.image.dpmm)
        self.bb_centers["Virtual Center"] = virtual
        return virtual


# --------------------------------------------------------------------------- #
#                            low-contrast phantoms                            #
# --------------------------------------------------------------------------- #

@capture_warnings
class LasVegas(ImagePhantomBase):
    """Las Vegas MV low-contrast phantom."""

    _demo_filename = "lasvegas.dcm"
    common_name = "Las Vegas"
    phantom_bbox_size_mm2 = 20260
    detection_conditions = [is_centered, is_right_size]
    phantom_outline_object = {"Rectangle": {"width ratio": 0.62, "height ratio": 0.62}}
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.24, "angle": 0, "roi radius": 0.03},
        "roi 2": {"distance from center": 0.24, "angle": 90, "roi radius": 0.03},
        "roi 3": {"distance from center": 0.24, "angle": 180, "roi radius": 0.03},
        "roi 4": {"distance from center": 0.24, "angle": 270, "roi radius": 0.03},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.107, "angle": 0.5, "roi radius": 0.028},
        "roi 2": {"distance from center": 0.141, "angle": 39.5, "roi radius": 0.028},
        "roi 3": {"distance from center": 0.205, "angle": 58, "roi radius": 0.028},
        "roi 4": {"distance from center": 0.179, "angle": -76.5, "roi radius": 0.016},
        "roi 5": {"distance from center": 0.095, "angle": -63.5, "roi radius": 0.016},
        "roi 6": {"distance from center": 0.042, "angle": 0.5, "roi radius": 0.016},
        "roi 7": {"distance from center": 0.097, "angle": 65.5, "roi radius": 0.016},
        "roi 8": {"distance from center": 0.178, "angle": 76.5, "roi radius": 0.016},
        "roi 9": {"distance from center": 0.174, "angle": -97.5, "roi radius": 0.012},
        "roi 10": {"distance from center": 0.088, "angle": -105.5, "roi radius": 0.012},
        "roi 11": {"distance from center": 0.024, "angle": -183.5, "roi radius": 0.012},
        "roi 12": {"distance from center": 0.091, "angle": 105.5, "roi radius": 0.012},
        "roi 13": {"distance from center": 0.179, "angle": 97.5, "roi radius": 0.012},
        "roi 14": {"distance from center": 0.189, "angle": -113.5, "roi radius": 0.007},
        "roi 15": {"distance from center": 0.113, "angle": -131.5, "roi radius": 0.007},
        "roi 16": {"distance from center": 0.0745, "angle": -181.5, "roi radius": 0.007},
        "roi 17": {"distance from center": 0.115, "angle": 130, "roi radius": 0.007},
        "roi 18": {"distance from center": 0.191, "angle": 113, "roi radius": 0.007},
        "roi 19": {"distance from center": 0.2085, "angle": -124.6, "roi radius": 0.003},
        "roi 20": {"distance from center": 0.146, "angle": -144.3, "roi radius": 0.003},
    }

    def _preprocess(self):
        self._check_direction()

    def _check_inversion(self):
        """Histogram of the phantom region decides inversion."""
        roi = self.phantom_ski_region
        phantom_array = self.image.array[roi.bbox[0]:roi.bbox[2],
                                         roi.bbox[1]:roi.bbox[3]]
        sub = image.load(phantom_array)
        sub.crop(int(sub.shape[0] * 0.1))
        p5 = np.percentile(sub.array, 0.5)
        p50 = np.percentile(sub.array, 50)
        p95 = np.percentile(sub.array, 99.5)
        if abs(p50 - p5) > abs(p50 - p95):
            self.image.invert()

    def _check_direction(self) -> None:
        """Flip left-right if the phantom faces the wrong way."""
        circle = CollapsedCircleProfile(
            self.phantom_center, self.phantom_radius * 0.175, self.image.array,
            ccw=False, width_ratio=0.16, num_profiles=5)
        roll_amount = int(np.where(circle.values == circle.values.min())[0][0])
        circle.roll(roll_amount)
        circle.filter(size=0.015, kind="median")
        valley_idxs, _ = circle.find_peaks(max_number=2)
        if valley_idxs[0] > valley_idxs[1]:
            self.image.array = np.fliplr(self.image.array)
            self._invalidate_phantom_region()

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 1.626

    def _phantom_angle_calc(self) -> float:
        return 0.0

    def _plot_lowcontrast_graph(self, axes):
        (line1,) = axes.plot([r.contrast for r in self.low_contrast_rois],
                             marker="o", color="m", label="Contrast")
        axes.axhline(self._low_contrast_threshold, color="m")
        axes.grid(True)
        axes.set_title("Low-frequency Contrast")
        axes.set_xlabel("ROI #")
        axes.set_ylabel("Contrast")
        axes2 = axes.twinx()
        axes2.set_ylabel("CNR")
        (line2,) = axes2.plot(
            [r.contrast_to_noise for r in self.low_contrast_rois],
            marker="^", label="CNR")
        axes3 = axes.twinx()
        axes3.set_ylabel("Visibility")
        (line3,) = axes3.plot([r.visibility for r in self.low_contrast_rois],
                              marker="*", color="blue", label="Visibility")
        axes3.axhline(self.visibility_threshold, color="blue")
        axes3.spines.right.set_position(("axes", 1.2))
        axes.legend(handles=[line1, line2, line3])

    def results(self, as_list: bool = False) -> str | list[str]:
        text = [f"{self.common_name} results:",
                f"File: {self.image.truncated_path}",
                f"Median Contrast: "
                f"{np.median([r.contrast for r in self.low_contrast_rois]):2.2f}",
                f"Median CNR: "
                f"{np.median([r.contrast_to_noise for r in self.low_contrast_rois]):2.1f}",
                f'# Low contrast ROIs "seen": '
                f"{sum(r.passed_visibility for r in self.low_contrast_rois):2.0f} "
                f"of {len(self.low_contrast_rois)}"]
        return text if as_list else "\n".join(text)


@capture_warnings
class ElektaLasVegas(LasVegas):
    """Elekta's Las Vegas variant."""

    _demo_filename = "elekta_las_vegas.dcm"
    common_name = "Elekta Las Vegas"
    phantom_bbox_size_mm2 = 140 * 140
    phantom_outline_object = {"Rectangle": {"width ratio": 0.61, "height ratio": 0.61}}
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.24, "angle": 0, "roi radius": 0.03},
        "roi 2": {"distance from center": 0.24, "angle": 90, "roi radius": 0.03},
        "roi 3": {"distance from center": 0.24, "angle": 180, "roi radius": 0.03},
        "roi 4": {"distance from center": 0.24, "angle": 270, "roi radius": 0.03},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.161, "angle": 0.4, "roi radius": 0.024},
        "roi 2": {"distance from center": 0.181, "angle": 28.6, "roi radius": 0.024},
        "roi 3": {"distance from center": 0.238, "angle": 47.45, "roi radius": 0.024},
        "roi 4": {"distance from center": 0.183, "angle": -70.6, "roi radius": 0.015},
        "roi 5": {"distance from center": 0.107, "angle": -55.1, "roi radius": 0.015},
        "roi 6": {"distance from center": 0.061, "angle": 1, "roi radius": 0.015},
        "roi 7": {"distance from center": 0.107, "angle": 55.15, "roi radius": 0.015},
        "roi 8": {"distance from center": 0.185, "angle": 71.1, "roi radius": 0.015},
        "roi 9": {"distance from center": 0.175, "angle": -97.3, "roi radius": 0.011},
        "roi 10": {"distance from center": 0.09, "angle": -104.3, "roi radius": 0.011},
        "roi 11": {"distance from center": 0.022, "angle": -180, "roi radius": 0.011},
        "roi 12": {"distance from center": 0.088, "angle": 104.6, "roi radius": 0.011},
        "roi 13": {"distance from center": 0.1757, "angle": 97.26, "roi radius": 0.011},
        "roi 14": {"distance from center": 0.1945, "angle": -116.58, "roi radius": 0.006},
        "roi 15": {"distance from center": 0.124, "angle": -135.11, "roi radius": 0.006},
        "roi 16": {"distance from center": 0.0876, "angle": 179.85, "roi radius": 0.006},
        "roi 17": {"distance from center": 0.1227, "angle": 135.4, "roi radius": 0.006},
        "roi 18": {"distance from center": 0.1947, "angle": 116.65, "roi radius": 0.006},
        "roi 19": {"distance from center": 0.2258, "angle": -129.53, "roi radius": 0.003},
        "roi 20": {"distance from center": 0.1699, "angle": -148.57, "roi radius": 0.003},
        "roi 21": {"distance from center": 0.145, "angle": -179.82, "roi radius": 0.003},
        "roi 22": {"distance from center": 0.1682, "angle": 149, "roi radius": 0.003},
    }


@capture_warnings
class PTWEPIDQC(ImagePhantomBase):
    """PTW EPID QC phantom."""

    _demo_filename = "PTW-EPID-QC.dcm"
    common_name = "PTW EPID QC"
    phantom_bbox_size_mm2 = 250 ** 2
    detection_conditions = [is_centered, is_right_size]
    detection_canny_settings = {"sigma": 4, "percentiles": (0.001, 0.01)}
    phantom_outline_object = {"Rectangle": {"width ratio": 8.55, "height ratio": 8.55}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 1.5, "angle": -135, "roi radius": 0.35,
                  "lp/mm": 0.15},
        "roi 2": {"distance from center": 3.1, "angle": -109, "roi radius": 0.35,
                  "lp/mm": 0.21},
        "roi 3": {"distance from center": 3.4, "angle": -60, "roi radius": 0.3,
                  "lp/mm": 0.27},
        "roi 4": {"distance from center": 1.9, "angle": -60, "roi radius": 0.25,
                  "lp/mm": 0.33},
        "roi 5": {"distance from center": 3.68, "angle": -90, "roi radius": 0.18,
                  "lp/mm": 0.5},
        "roi 6": {"distance from center": 2.9, "angle": -90, "roi radius": 0.08,
                  "lp/mm": 2},
        "roi 7": {"distance from center": 2.2, "angle": -90, "roi radius": 0.04,
                  "lp/mm": 3},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 3.87, "angle": 31, "roi radius": 0.3},
        "roi 2": {"distance from center": 3.48, "angle": 17, "roi radius": 0.3},
        "roi 3": {"distance from center": 3.3, "angle": 0, "roi radius": 0.3},
        "roi 4": {"distance from center": 3.48, "angle": -17, "roi radius": 0.3},
        "roi 5": {"distance from center": 3.87, "angle": -31, "roi radius": 0.3},
        "roi 6": {"distance from center": 3.87, "angle": 149, "roi radius": 0.3},
        "roi 7": {"distance from center": 3.48, "angle": 163, "roi radius": 0.3},
        "roi 8": {"distance from center": 3.3, "angle": 180, "roi radius": 0.3},
        "roi 9": {"distance from center": 3.48, "angle": 197, "roi radius": 0.3},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 3.85, "angle": -148, "roi radius": 0.3},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.116

    def _phantom_angle_calc(self) -> float:
        return 0

    def _check_inversion(self):
        """Phantom interior should be mostly bright."""
        roi = self.phantom_ski_region
        phantom_array = self.image.array[roi.bbox[0]:roi.bbox[2],
                                         roi.bbox[1]:roi.bbox[3]]
        p5, p50, p95 = np.percentile(phantom_array, [2, 50, 98])
        if abs(p50 - p5) < abs(p50 - p95):
            self.image.invert()


@capture_warnings
class IBAPrimusA(ImagePhantomBase):
    """IBA Primus A phantom; detection keys on the central crosshair."""

    common_name = "IBA Primus A"
    _demo_filename = "iba_primus.dcm"
    phantom_bbox_size_mm2 = 15 ** 2
    detection_conditions = [is_centered, is_right_size, is_square]
    phantom_outline_object = {"Rectangle": {"width ratio": 10.75,
                                            "height ratio": 10.75}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 5.19, "angle": 86.65, "roi radius": 0.12,
                  "lp/mm": 0.6},
        "roi 2": {"distance from center": 4.92, "angle": 89.5, "roi radius": 0.1,
                  "lp/mm": 0.7},
        "roi 3": {"distance from center": 4.68, "angle": 92.3, "roi radius": 0.09,
                  "lp/mm": 0.8},
        "roi 4": {"distance from center": 4.45, "angle": 95.4, "roi radius": 0.08,
                  "lp/mm": 0.9},
        "roi 5": {"distance from center": 4.23, "angle": 99.5, "roi radius": 0.07,
                  "lp/mm": 1},
        "roi 6": {"distance from center": 4.07, "angle": 102.7, "roi radius": 0.06,
                  "lp/mm": 1.2},
        "roi 7": {"distance from center": 3.92, "angle": 105.73, "roi radius": 0.05,
                  "lp/mm": 1.4},
        "roi 8": {"distance from center": 3.82, "angle": 108.65, "roi radius": 0.04,
                  "lp/mm": 1.6},
        "roi 9": {"distance from center": 4.59, "angle": 74.4, "roi radius": 0.04,
                  "lp/mm": 1.8},
        "roi 10": {"distance from center": 4.4, "angle": 76.2, "roi radius": 0.035,
                   "lp/mm": 2.0},
        "roi 11": {"distance from center": 4.19, "angle": 77.77, "roi radius": 0.03,
                   "lp/mm": 2.2},
        "roi 12": {"distance from center": 4, "angle": 79.6, "roi radius": 0.03,
                   "lp/mm": 2.5},
        "roi 13": {"distance from center": 3.67, "angle": 83.1, "roi radius": 0.025,
                   "lp/mm": 2.8},
    }
    low_contrast_roi_settings = {
        f"roi {i + 1}": {"distance from center": 3.95, "angle": angle,
                         "roi radius": 0.15}
        for i, angle in enumerate(
            [19, 5, -9, -23, -37, -51, -65, -79, -107, -121, -135, -149,
             -163, -177, -191])
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 3.95, "angle": -205, "roi radius": 0.15},
    }

    def _check_inversion(self):
        """The crosshair center should be less intense than adjacent area."""
        crosshair_disk = DiskROI(self.image.array,
                                 radius=self.phantom_radius / 2,
                                 center=self.phantom_center)
        adjacent_disk = DiskROI.from_phantom_center(
            self.image.array, angle=0, roi_radius=self.phantom_radius / 2,
            dist_from_center=self.phantom_radius,
            phantom_center=self.phantom_center)
        if crosshair_disk.pixel_value < adjacent_disk.pixel_value:
            self.image.invert()

    @property
    def phantom_angle(self) -> float:
        if getattr(self, "_cached_angle", None) is None:
            self._cached_angle = super().phantom_angle
        return self._cached_angle

    def _phantom_angle_calc(self) -> float:
        """Fine-tune via the two ends of the dynamic wedge steps."""
        prof = CollapsedCircleProfile(
            center=self.phantom_center, radius=self.phantom_radius * 4.37,
            image_array=self.image.array, start_angle=-np.pi / 2)
        # JAX's size-5 median of the (1, N) float32 profile: the general
        # sort, on the CPU as its host profile is
        filtered = median_filter(torch.from_numpy(
            np.asarray(prof.values[None, :], np.float32)), 5).numpy()[0] \
            if prof.values.ndim == 1 else prof.values
        delta_array = np.argsort(np.diff(filtered))
        first = delta_array[0]
        second = None
        one_degree = delta_array.size / 360
        for idx in delta_array:
            if first + one_degree < idx or idx < first - one_degree:
                second = idx
                break
        if not second:
            warnings.warn(
                "The phantom angle was not able to be fine-tuned; a default "
                "of 0 is being used instead. Ensure the image is not rotated.")
            return 0
        angle = (0.5 - ((second - first) / 2 + first) / prof.values.size) * 360
        near_cardinal = (-95 < angle < -85) or (85 < angle < 95) or (-5 < angle < 5)
        if near_cardinal:
            return angle
        warnings.warn(
            "The phantom angle was not able to be fine-tuned; a default of 0 "
            "is being used instead. Ensure the image is not rotated.")
        return 0

    def _phantom_radius_calc(self):
        return math.sqrt(self.phantom_ski_region.bbox_area)


@capture_warnings
class StandardImagingQC3(ImagePhantomBase):
    """SI QC-3 MV phantom."""

    _demo_filename = "qc3.dcm"
    common_name = "SI QC-3"
    phantom_bbox_size_mm2 = 168 ** 2
    detection_conditions = [is_centered, is_right_size]
    phantom_outline_object = {"Rectangle": {"width ratio": 7.5, "height ratio": 6}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 2.8, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.1},
        "roi 2": {"distance from center": -2.8, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.2},
        "roi 3": {"distance from center": 1.45, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.25},
        "roi 4": {"distance from center": -1.45, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.45},
        "roi 5": {"distance from center": 0, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.76},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 2, "angle": -90, "roi radius": 0.5},
        "roi 2": {"distance from center": 2.4, "angle": 55, "roi radius": 0.5},
        "roi 3": {"distance from center": 2.4, "angle": -55, "roi radius": 0.5},
        "roi 4": {"distance from center": 2.4, "angle": 128, "roi radius": 0.5},
        "roi 5": {"distance from center": 2.4, "angle": -128, "roi radius": 0.5},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 2, "angle": 90, "roi radius": 0.5},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.0896

    def _phantom_angle_calc(self) -> float:
        """The phantom stand angles the phantom at +/-45 degrees."""
        angle = np.degrees(self.phantom_ski_region.orientation)
        if np.isclose(angle, 45, atol=5):
            return 45
        if np.isclose(angle, -45, atol=5):
            return -45
        raise ValueError(
            "The phantom angle was not near +/-45 degrees. "
            "Please adjust the phantom.")


@capture_warnings
class StandardImagingQCkV(StandardImagingQC3):
    """SI QC-kV phantom."""

    _demo_filename = "SI-QC-kV.dcm"
    common_name = "SI QC-kV"
    phantom_bbox_size_mm2 = 142 ** 2
    detection_conditions = [is_centered, is_right_size]
    phantom_outline_object = {"Rectangle": {"width ratio": 7.8, "height ratio": 6.4}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 2.8, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.66},
        "roi 2": {"distance from center": -2.8, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 0.98},
        "roi 3": {"distance from center": 1.45, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 1.50},
        "roi 4": {"distance from center": -1.45, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 2.00},
        "roi 5": {"distance from center": 0, "angle": 0, "roi radius": 0.5,
                  "lp/mm": 2.46},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 2, "angle": -90, "roi radius": 0.5},
        "roi 2": {"distance from center": 2.4, "angle": 55, "roi radius": 0.5},
        "roi 3": {"distance from center": 2.4, "angle": -55, "roi radius": 0.5},
        "roi 4": {"distance from center": 2.4, "angle": 128, "roi radius": 0.5},
        "roi 5": {"distance from center": 2.4, "angle": -128, "roi radius": 0.5},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 2, "angle": 90, "roi radius": 0.5},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.0989


@capture_warnings
class SNCkV(ImagePhantomBase):
    """Sun Nuclear kV-QA phantom."""

    _demo_filename = "SNC-kV.dcm"
    common_name = "SNC kV-QA"
    phantom_bbox_size_mm2 = 134 ** 2
    roi_match_condition = "closest"
    detection_conditions = [is_centered, is_right_size, is_square]
    phantom_outline_object = {"Rectangle": {"width ratio": 7.7, "height ratio": 5.6}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 1.8, "angle": 0, "roi radius": 0.7,
                  "lp/mm": 0.6},
        "roi 2": {"distance from center": -1.8, "angle": 90, "roi radius": 0.7,
                  "lp/mm": 1.2},
        "roi 3": {"distance from center": -1.8, "angle": 0, "roi radius": 0.7,
                  "lp/mm": 1.8},
        "roi 4": {"distance from center": 1.8, "angle": 90, "roi radius": 0.7,
                  "lp/mm": 2.4},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 2.6, "angle": -45, "roi radius": 0.6},
        "roi 2": {"distance from center": 2.6, "angle": -135, "roi radius": 0.6},
        "roi 3": {"distance from center": 2.6, "angle": 45, "roi radius": 0.6},
        "roi 4": {"distance from center": 2.6, "angle": 135, "roi radius": 0.6},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.5, "angle": 90, "roi radius": 0.25},
        "roi 2": {"distance from center": 0.5, "angle": -90, "roi radius": 0.25},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.1071

    def _phantom_angle_calc(self) -> float:
        """Manufacturer stand angles the phantom at 135 degrees."""
        angle = np.degrees(self.phantom_ski_region.orientation) + 180
        if np.isclose(angle, 135, atol=5):
            return angle
        raise ValueError(
            "The phantom angle was not near 135 degrees per manufacturer "
            "recommendations. Please adjust the phantom.")


@capture_warnings
class SNCMV(SNCkV):
    """Sun Nuclear MV-QA phantom."""

    _demo_filename = "SNC-MV.dcm"
    common_name = "SNC MV-QA"
    phantom_bbox_size_mm2 = 118 ** 2
    phantom_outline_object = {"Rectangle": {"width ratio": 7.5, "height ratio": 7.5}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": -2.3, "angle": 0, "roi radius": 0.8,
                  "lp/mm": 0.1},
        "roi 2": {"distance from center": 2.3, "angle": 90, "roi radius": 0.8,
                  "lp/mm": 0.2},
        "roi 3": {"distance from center": 2.3, "angle": 0, "roi radius": 0.8,
                  "lp/mm": 0.5},
        "roi 4": {"distance from center": -2.3, "angle": 90, "roi radius": 0.8,
                  "lp/mm": 1.0},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 3.4, "angle": -45, "roi radius": 0.7},
        "roi 2": {"distance from center": 3.4, "angle": 45, "roi radius": 0.7},
        "roi 3": {"distance from center": 3.4, "angle": 135, "roi radius": 0.7},
        "roi 4": {"distance from center": 3.4, "angle": -135, "roi radius": 0.7},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.7, "angle": 0, "roi radius": 0.2},
        "roi 2": {"distance from center": -0.7, "angle": 0, "roi radius": 0.2},
    }

    def _phantom_angle_calc(self) -> float:
        return 45

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.095


@capture_warnings
class SNCMV12510(SNCMV):
    """Older SNC MV-QA phantom, model 1251000."""

    _demo_filename = "SNC_MV_12510.dcm"
    common_name = "SNC MV-QA (12510)"
    phantom_bbox_size_mm2 = 130 ** 2
    phantom_outline_object = {"Rectangle": {"width ratio": 7.3, "height ratio": 6.2}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": -1.7, "angle": 0, "roi radius": 0.7,
                  "lp/mm": 0.1},
        "roi 2": {"distance from center": 2.0, "angle": 80, "roi radius": 0.7,
                  "lp/mm": 0.2},
        "roi 3": {"distance from center": 2.4, "angle": 0, "roi radius": 0.7,
                  "lp/mm": 0.5},
        "roi 4": {"distance from center": -2.0, "angle": 100, "roi radius": 0.7,
                  "lp/mm": 1.0},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 3.1, "angle": -40, "roi radius": 0.7},
        "roi 2": {"distance from center": 3.1, "angle": 40, "roi radius": 0.7},
        "roi 3": {"distance from center": 2.5, "angle": 130, "roi radius": 0.7},
        "roi 4": {"distance from center": 2.5, "angle": -130, "roi radius": 0.7},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 1.0, "angle": 0, "roi radius": 0.2},
        "roi 2": {"distance from center": -0.2, "angle": 0, "roi radius": 0.2},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.105


@capture_warnings
class LeedsTOR(ImagePhantomBase):
    """Leeds TOR 18 kV phantom."""

    _demo_filename = "leeds.dcm"
    common_name = "Leeds"
    phantom_bbox_size_mm2 = 148 ** 2
    _is_ccw = False
    phantom_outline_object = {"Circle": {"radius ratio": 0.97}}
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.2895, "angle": 54.62,
                  "roi radius": 0.04, "lp/mm": 0.5},
        "roi 2": {"distance from center": 0.187, "angle": 25.1,
                  "roi radius": 0.04, "lp/mm": 0.56},
        "roi 3": {"distance from center": 0.1848, "angle": 335.5,
                  "roi radius": 0.04, "lp/mm": 0.63},
        "roi 4": {"distance from center": 0.238, "angle": 80.06,
                  "roi radius": 0.03, "lp/mm": 0.71},
        "roi 5": {"distance from center": 0.0916, "angle": 62.96,
                  "roi radius": 0.03, "lp/mm": 0.8},
        "roi 6": {"distance from center": 0.093, "angle": -64,
                  "roi radius": 0.02, "lp/mm": 0.9},
        "roi 7": {"distance from center": 0.239, "angle": 101.98,
                  "roi radius": 0.015, "lp/mm": 1.0},
        "roi 8": {"distance from center": 0.0907, "angle": 122.62,
                  "roi radius": 0.015, "lp/mm": 1.12},
        "roi 9": {"distance from center": 0.09515, "angle": 239.07,
                  "roi radius": 0.015, "lp/mm": 1.25},
        "roi 10": {"distance from center": 0.2596, "angle": 115.8,
                   "roi radius": 0.012, "lp/mm": 1.4},
        "roi 11": {"distance from center": 0.138, "angle": 145,
                   "roi radius": 0.012, "lp/mm": 1.6},
        "roi 12": {"distance from center": 0.13967, "angle": 216.4,
                   "roi radius": 0.010, "lp/mm": 1.8},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.65, "angle": 30, "roi radius": 0.025},
        "roi 2": {"distance from center": 0.65, "angle": 120, "roi radius": 0.025},
        "roi 3": {"distance from center": 0.65, "angle": 210, "roi radius": 0.025},
        "roi 4": {"distance from center": 0.65, "angle": 300, "roi radius": 0.025},
    }
    low_contrast_roi_settings = {
        f"roi {i + 1}": {"distance from center": 0.785, "angle": angle,
                         "roi radius": 0.025}
        for i, angle in enumerate(
            [30, 45, 60, 75, 90, 105, 120, 135, 150,
             210, 225, 240, 255, 270, 285, 300, 315, 330])
    }

    def _phantom_angle_calc(self) -> float:
        """Angle from the lead square's peak on a circular profile."""
        if getattr(self, "_cached_leeds_angle", None) is not None:
            return self._cached_leeds_angle
        start_angle_deg = self._determine_start_angle_for_circle_profile()
        circle = self._circle_profile_for_phantom_angle(start_angle_deg,
                                                        is_ccw=True)
        peak_idx, _ = circle.find_fwxm_peaks(threshold=0.6, max_number=1)
        shift_percent = peak_idx[0] / len(circle.values)
        shift_radians_corrected = 2 * np.pi - shift_percent * 2 * np.pi
        self._cached_leeds_angle = (np.degrees(shift_radians_corrected)
                                    + start_angle_deg)
        return self._cached_leeds_angle

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 0.515

    def _determine_start_angle_for_circle_profile(self) -> float:
        """Use 90 degrees if the lead square peak straddles the profile wrap."""
        circle = self._circle_profile_for_phantom_angle(0)
        peak_idxs, _ = circle.find_fwxm_peaks(threshold=0.6, max_number=4)
        on_left_half = [x < len(circle.values) / 2 for x in peak_idxs]
        aligned_to_zero_deg = not (all(on_left_half) or not any(on_left_half))
        return 90 if aligned_to_zero_deg else 0

    def _preprocess(self) -> None:
        self._check_if_counter_clockwise()

    def _sample_high_contrast_rois(self) -> list[HighContrastDiskROI]:
        """Centered on the high-res block, which can be offset from center."""
        regions = self._get_canny_regions()
        high_res_block_size = self.phantom_bbox_size_px * 0.23
        sorted_regions = sorted(
            (r for r in regions
             if math.isclose(r.bbox_area, high_res_block_size, rel_tol=0.75)
             and (bbox_center(r).distance_to(self.phantom_center)
                  < 0.1 * self.phantom_radius)),
            key=lambda r: -bbox_center(r).distance_to(self.phantom_center))
        if not sorted_regions:
            raise ValueError(
                "Could not find high-resolution block within the leeds "
                "phantom. Try rotating the image.")
        self.high_res_center = high_res_center = bbox_center(sorted_regions[0])
        return [HighContrastDiskROI.from_phantom_center(
            self.image, self.phantom_angle + stng["angle"],
            self.phantom_radius * stng["roi radius"],
            self.phantom_radius * stng["distance from center"],
            high_res_center, self._high_contrast_threshold)
            for stng in self.high_contrast_roi_settings.values()]

    def _check_if_counter_clockwise(self) -> None:
        """Flip if the low-contrast bubbles run the wrong way."""
        circle = self._circle_profile_for_phantom_angle(0)
        peak_idx, _ = circle.find_fwxm_peaks(threshold=0.6, max_number=1)
        circle.values = np.roll(circle.values, -int(peak_idx[0]))
        _, first_set = circle.find_peaks(search_region=(0.05, 0.45), threshold=0,
                                         min_distance=0.025, max_number=9)
        _, second_set = circle.find_peaks(search_region=(0.55, 0.95), threshold=0,
                                          min_distance=0.025, max_number=9)
        self._is_ccw = max(first_set) > max(second_set)
        if not self._is_ccw:
            self.image.fliplr()
            self._invalidate_phantom_region()

    def _circle_profile_for_phantom_angle(
            self, start_angle_deg: float, is_ccw: bool = False
    ) -> CollapsedCircleProfile:
        circle = CollapsedCircleProfile(
            self.phantom_center, self.phantom_radius * 0.79, self.image.array,
            width_ratio=0.04, ccw=is_ccw,
            start_angle=np.deg2rad(start_angle_deg))
        circle.ground()
        circle.filter(size=0.01)
        circle.invert()
        return circle

    def _check_inversion(self):
        """If the lead square area is darker than the profile median, invert."""
        circle = self._circle_profile_for_phantom_angle(start_angle_deg=0)
        p2, p50, p98 = np.percentile(circle.values, [2, 50, 98])
        if abs(p50 - p98) < abs(p50 - p2):
            self.image.invert()


@capture_warnings
class LeedsTORBlue(LeedsTOR):
    """Older blue-ring Leeds with slightly offset ROIs."""

    common_name = "Leeds (Blue)"
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.3, "angle": 54.8,
                  "roi radius": 0.04, "lp/mm": 0.5},
        "roi 2": {"distance from center": 0.187, "angle": 25.1,
                  "roi radius": 0.04, "lp/mm": 0.56},
        "roi 3": {"distance from center": 0.187, "angle": -27.5,
                  "roi radius": 0.04, "lp/mm": 0.63},
        "roi 4": {"distance from center": 0.252, "angle": 79.7,
                  "roi radius": 0.03, "lp/mm": 0.71},
        "roi 5": {"distance from center": 0.092, "angle": 63.4,
                  "roi radius": 0.03, "lp/mm": 0.8},
        "roi 6": {"distance from center": 0.094, "angle": -65,
                  "roi radius": 0.02, "lp/mm": 0.9},
        "roi 7": {"distance from center": 0.252, "angle": -260,
                  "roi radius": 0.02, "lp/mm": 1.0},
        "roi 8": {"distance from center": 0.094, "angle": -240,
                  "roi radius": 0.018, "lp/mm": 1.12},
        "roi 9": {"distance from center": 0.0958, "angle": -120,
                  "roi radius": 0.018, "lp/mm": 1.25},
        "roi 10": {"distance from center": 0.27, "angle": 115,
                   "roi radius": 0.015, "lp/mm": 1.4},
        "roi 11": {"distance from center": 0.13, "angle": 150,
                   "roi radius": 0.011, "lp/mm": 1.6},
        "roi 12": {"distance from center": 0.135, "angle": -150,
                   "roi radius": 0.011, "lp/mm": 1.8},
    }
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.6, "angle": 30, "roi radius": 0.025},
        "roi 2": {"distance from center": 0.6, "angle": 120, "roi radius": 0.025},
        "roi 3": {"distance from center": 0.6, "angle": 210, "roi radius": 0.025},
        "roi 4": {"distance from center": 0.6, "angle": 300, "roi radius": 0.025},
    }
    low_contrast_roi_settings = {
        f"roi {i + 1}": {"distance from center": 0.83, "angle": angle,
                         "roi radius": 0.025}
        for i, angle in enumerate(
            [30, 45, 60, 75, 90, 105, 120, 135, 150,
             210, 225, 240, 255, 270, 285, 300, 315, 330])
    }


@capture_warnings
class DoselabMC2kV(ImagePhantomBase):
    """Doselab MC2 kV-area phantom."""

    common_name = "Doselab MC2 kV"
    _demo_filename = "Doselab_kV.dcm"
    phantom_bbox_size_mm2 = 26300
    detection_conditions = [is_right_size]
    phantom_outline_object = {"Rectangle": {"width ratio": 0.55, "height ratio": 0.63}}
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 0.27, "angle": 48.5, "roi radius": 0.025},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.27, "angle": -48.5, "roi radius": 0.025},
        "roi 2": {"distance from center": 0.225, "angle": -65, "roi radius": 0.025},
        "roi 3": {"distance from center": 0.205, "angle": -88.5, "roi radius": 0.025},
        "roi 4": {"distance from center": 0.22, "angle": -110, "roi radius": 0.025},
        "roi 5": {"distance from center": 0.22, "angle": 110, "roi radius": 0.025},
        "roi 6": {"distance from center": 0.205, "angle": 88.5, "roi radius": 0.025},
        "roi 7": {"distance from center": 0.225, "angle": 65, "roi radius": 0.025},
    }
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.17, "angle": -20,
                  "roi radius": 0.013, "lp/mm": 0.6},
        "roi 2": {"distance from center": 0.16, "angle": -2,
                  "roi radius": 0.007, "lp/mm": 1.2},
        "roi 3": {"distance from center": 0.164, "angle": 12.8,
                  "roi radius": 0.005, "lp/mm": 1.8},
        "roi 4": {"distance from center": 0.175, "angle": 24.7,
                  "roi radius": 0.0035, "lp/mm": 2.4},
    }

    def _phantom_radius_calc(self) -> float:
        return math.sqrt(self.phantom_ski_region.bbox_area) * 1.214

    def _phantom_angle_calc(self) -> float:
        """Constrained Hough line search around the nominal 45-degree setup."""
        nominal_angle_deg = 45
        max_angle_deviation = 10
        angle_resolution = 0.01
        min_distance_mm = 70
        min_distance_px = int(min_distance_mm * self.image.dpmm)
        half = max_angle_deviation / 2
        num_angles = int(max_angle_deviation / angle_resolution + 1)
        angles_rad = np.deg2rad(np.linspace(
            nominal_angle_deg - half, nominal_angle_deg + half, num=num_angles))
        roi = self.phantom_ski_region
        hspace, angles, dists = hough_line(roi.image, theta=angles_rad)
        _, peak_angles, _ = hough_line_peaks(
            hspace, angles, dists, min_distance=min_distance_px, num_peaks=2)
        if len(peak_angles) != 2:
            warnings.warn("Could not determine phantom roll. Setting roll to 45.",
                          UserWarning)
            return 45.0
        return float(np.mean(np.rad2deg(peak_angles)))


@capture_warnings
class DoselabMC2MV(DoselabMC2kV):
    """Doselab MC2 MV-area phantom."""

    common_name = "Doselab MC2 MV"
    _demo_filename = "Doselab_MV.dcm"
    high_contrast_roi_settings = {
        "roi 1": {"distance from center": 0.23, "angle": -135.3,
                  "roi radius": 0.012, "lp/mm": 0.1},
        "roi 2": {"distance from center": 0.173, "angle": 161,
                  "roi radius": 0.012, "lp/mm": 0.2},
        "roi 3": {"distance from center": 0.237, "angle": 133,
                  "roi radius": 0.012, "lp/mm": 0.4},
        "roi 4": {"distance from center": 0.298, "angle": 122.9,
                  "roi radius": 0.01, "lp/mm": 0.8},
    }


# --------------------------------------------------------------------------- #
#                         ACR Digital Mammography                             #
# --------------------------------------------------------------------------- #

ACR_SCORE_COLORS = {0: "red", 0.5: "yellow", 1: "green"}


@dataclasses.dataclass(kw_only=True)
class ACRDigitalMammographyResult(ResultBase):
    """The ACR digital mammography phantom's result."""

    analysis_type: str
    phantom_center_x_y: tuple[float, float]
    phantom_area: float
    mass_score: int
    mass_rois: list[dict]
    speck_group_score: float
    speck_group_rois: list[dict]
    fiber_score: float
    fiber_rois: list[dict]


@capture_warnings
class ACRDigitalMammography(ImagePhantomBase):
    """ACR Digital Mammography QC phantom.

    Scores masses (low-contrast disks), speck groups (microcalcification
    clusters), and fibers (Frangi vesselness on the device)."""

    common_name = "ACR Digital Mammography"
    _demo_filename = "ACRDigitalMammography.dcm"
    phantom_bbox_size_mm2 = 130 * 70
    roi_match_condition = "closest"
    detection_canny_settings = {"sigma": 9, "percentiles": (0.001, 0.01)}
    detection_conditions = [is_right_size]
    phantom_outline_object = {"Rectangle": {"width ratio": 70,
                                            "height ratio": 130}}
    low_contrast_background_roi_settings = {
        "roi 1": {"distance from center": 40.738, "angle": 72.72, "roi radius": 3.00},
        "roi 2": {"distance from center": 22.441, "angle": 57.37, "roi radius": 3.00},
        "roi 3": {"distance from center": 12.150, "angle": -5.19, "roi radius": 3.00},
        "roi 4": {"distance from center": 24.323, "angle": -60.17, "roi radius": 3.00},
        "roi 5": {"distance from center": 42.844, "angle": -73.60, "roi radius": 3.00},
    }
    low_contrast_roi_settings = {
        "roi 1": {"distance from center": 53.662, "angle": 65.68, "roi radius": 3.00},
        "roi 2": {"distance from center": 36.382, "angle": 52.59, "roi radius": 2.25},
        "roi 3": {"distance from center": 23.825, "angle": 21.94, "roi radius": 1.50},
        "roi 4": {"distance from center": 24.731, "angle": -26.67, "roi radius": 1.14},
        "roi 5": {"distance from center": 38.153, "angle": -54.60, "roi radius": 0.75},
        "roi 6": {"distance from center": 55.674, "angle": -66.61, "roi radius": 0.60},
    }
    speck_group_roi_settings = {
        "roi 1": {"x offset": 1, "y offset": 49, "size": 20.0, "speck_diameter": 0.33},
        "roi 2": {"x offset": 1, "y offset": 29, "size": 20.0, "speck_diameter": 0.28},
        "roi 3": {"x offset": 1, "y offset": 9, "size": 20.0, "speck_diameter": 0.23},
        "roi 4": {"x offset": 1, "y offset": -11, "size": 20.0, "speck_diameter": 0.20},
        "roi 5": {"x offset": 1, "y offset": -31, "size": 20.0, "speck_diameter": 0.17},
        "roi 6": {"x offset": 1, "y offset": -51, "size": 20.0, "speck_diameter": 0.14},
    }
    speck_roi_settings = {
        "roi 1": {"distance from center": 0.0, "angle": 0, "search_radius": 3.0},
        "roi 2": {"distance from center": 6.6, "angle": 35, "search_radius": 3.0},
        "roi 3": {"distance from center": 6.6, "angle": 107, "search_radius": 3.0},
        "roi 4": {"distance from center": 6.6, "angle": 179, "search_radius": 3.0},
        "roi 5": {"distance from center": 6.6, "angle": 251, "search_radius": 3.0},
        "roi 6": {"distance from center": 6.6, "angle": 323, "search_radius": 3.0},
    }
    fibers_roi_settings = {
        "roi 1": {"x offset": -20, "y offset": 50, "size": 19.5,
                  "fiber_diameter": 0.89, "fiber_orientation": 45},
        "roi 2": {"x offset": -20, "y offset": 30, "size": 19.5,
                  "fiber_diameter": 0.75, "fiber_orientation": -45},
        "roi 3": {"x offset": -20, "y offset": 10, "size": 19.5,
                  "fiber_diameter": 0.61, "fiber_orientation": 45},
        "roi 4": {"x offset": -20, "y offset": -10, "size": 19.5,
                  "fiber_diameter": 0.54, "fiber_orientation": -45},
        "roi 5": {"x offset": -20, "y offset": -30, "size": 19.5,
                  "fiber_diameter": 0.40, "fiber_orientation": 45},
        "roi 6": {"x offset": -20, "y offset": -50, "size": 19.5,
                  "fiber_diameter": 0.30, "fiber_orientation": -45},
    }

    class SpeckGroupROI(RectangleROI):
        """One microcalcification cluster: a rect sample + 6 speck disks."""

        class SpeckROI(DiskROI):
            @classmethod
            def from_speck_group_center(cls, array, angle, dist_from_center,
                                        center, search_radius, speck_radius,
                                        background_mean, background_std,
                                        contrast_method,
                                        visibility_threshold):
                center = cls._get_shifted_center(angle, dist_from_center,
                                                 center)
                return cls(array, center, search_radius, speck_radius,
                           background_mean, background_std, contrast_method,
                           visibility_threshold)

            def __init__(self, array, center, search_radius, speck_radius,
                         background_mean, background_std, contrast_method,
                         visibility_threshold):
                super().__init__(array, search_radius, center)
                self.speck_radius = speck_radius
                self.background_mean = background_mean
                self.background_std = background_std
                self.contrast_method = contrast_method
                self.visibility_threshold = visibility_threshold
                self.intensity = self.max
                self.visibility = contrast.visibility(
                    array=np.array([self.intensity, background_mean]),
                    radius=speck_radius, std=background_std,
                    algorithm=contrast_method)
                self.passed_visibility = bool(
                    self.visibility >= visibility_threshold)
                # JAX's nanargmax of the full-frame masked array, over the
                # disk's window only
                self.center = self.masked_argmax()

            def as_dict(self) -> dict:
                return {
                    "speck_radius": self.speck_radius,
                    "speck max intensity": self.intensity,
                    "background mean intensity": self.background_mean,
                    "background std intensity": self.background_std,
                    "contrast method": self.contrast_method,
                    "visibility": self.visibility,
                    "visibility threshold": self.visibility_threshold,
                    "passed visibility": bool(self.passed_visibility),
                    "center_x_y": (self.center.x, self.center.y),
                }

        def __init__(self, array, roi_size, roi_center, speck_roi_settings,
                     speck_radius, dpmm, contrast_method,
                     visibility_threshold, half_thresh, full_thresh):
            super().__init__(array=array, width=roi_size, height=roi_size,
                             center=roi_center)
            self.half_thresh = half_thresh
            self.full_thresh = full_thresh
            self.specks: list = []
            for stng_roi in speck_roi_settings.values():
                roi = self.SpeckROI.from_speck_group_center(
                    array=array, angle=stng_roi["angle"],
                    search_radius=dpmm * stng_roi["search_radius"],
                    dist_from_center=dpmm * stng_roi["distance from center"],
                    center=self.center, speck_radius=speck_radius,
                    background_mean=self.mean, background_std=self.std,
                    contrast_method=contrast_method,
                    visibility_threshold=visibility_threshold)
                self.specks.append(roi)
            self.num_specks_visible = sum(
                x.passed_visibility for x in self.specks)
            self.score = 0
            if self.num_specks_visible >= half_thresh:
                self.score = 0.5
            if self.num_specks_visible >= full_thresh:
                self.score = 1

        def plot2axes(self, axes, fill: bool = False, alpha: float = 1.0,
                      **kwargs):
            color = ACR_SCORE_COLORS[self.score]
            super().plot2axes(axes, edgecolor=color, fill=fill, alpha=alpha)
            for roi in self.specks:
                roi.plot2axes(
                    axes,
                    edgecolor="green" if roi.passed_visibility else "red",
                    fill=fill, alpha=alpha)

        def as_dict(self) -> dict:
            return {"num_specks_visible": self.num_specks_visible,
                    "score": self.score,
                    "specks": [s.as_dict() for s in self.specks]}

    class FiberROI(RectangleROI):
        """Fiber detection via Frangi vesselness + rotated-gap closing."""

        def __init__(self, array, roi_size, roi_center, fiber_diameter,
                     fiber_len_half_thresh, fiber_len_full_thresh,
                     fiber_orientation, fiber_orientation_tolerance, dpmm,
                     sigmas_ratio, max_gap, device=None):
            device = resolve_device(device, "FiberROI")
            super().__init__(array=array, width=dpmm * roi_size,
                             height=dpmm * roi_size, center=roi_center)
            pixel_size = 1 / dpmm
            self.fiber_diameter = fiber_diameter
            self.fiber_len_half_thresh = fiber_len_half_thresh
            self.fiber_len_full_thresh = fiber_len_full_thresh

            img_frangi = frangi(
                torch.from_numpy(self.pixel_array.astype(np.float32)).to(device),
                sigmas=tuple(float(s * dpmm * fiber_diameter) for s in sigmas_ratio),
                black_ridges=False).cpu().numpy()
            img_bin = img_frangi > threshold_yen(img_frangi)
            fp = rotate_footprint(np.ones((5, math.ceil(dpmm * 0.5 * max_gap))),
                                  -fiber_orientation)
            img_clo = binary_closing(torch.from_numpy(img_bin).to(device), fp)
            regions = tlabel.regionprops(img_clo, K=32, connectivity=1, hull=False)
            views = valid_region_views(regions)
            self.region = max(views, key=lambda r: r.major_axis_length)
            self.fiber_length = self.region.major_axis_length * pixel_size
            self.score = 0
            diff = abs(np.rad2deg(self.region.orientation) - fiber_orientation)
            if diff > fiber_orientation_tolerance:
                return
            if self.fiber_length >= fiber_len_half_thresh:
                self.score = 0.5
            if self.fiber_length >= fiber_len_full_thresh:
                self.score = 1.0

        @property
        def plot_color(self) -> str:
            return ACR_SCORE_COLORS[self.score]

        def as_dict(self) -> dict:
            return {
                "fiber_diameter": self.fiber_diameter,
                "fiber_length": self.fiber_length,
                "fiber_orientation": np.rad2deg(self.region.orientation),
                "fiber_len_half_thresh": self.fiber_len_half_thresh,
                "fiber_len_full_thresh": self.fiber_len_full_thresh,
                "score": self.score,
            }

        def plot2axes(self, axes, fill: bool = False, alpha: float = 1.0,
                      **kwargs):
            super().plot2axes(axes=axes, edgecolor=self.plot_color)

    def _phantom_radius_calc(self) -> float:
        """Mammography ROIs are placed in physical mm: radius = dpmm."""
        return self.dpmm

    def _phantom_angle_calc(self) -> float:
        return 0

    @property
    def dpmm(self) -> float:
        return self.image.dpmm

    def window_ceiling(self):
        return float(np.max(self.phantom_ski_region.image_intensity))

    def window_floor(self):
        return float(np.min(self.phantom_ski_region.image_intensity))

    def analyze(self, low_contrast_threshold: float = 0.05,
                invert: bool = True, angle_override: float | None = None,
                center_override: tuple | None = None,
                size_override: float | None = None, ssd="auto",
                low_contrast_method: str = Contrast.MICHELSON,
                low_contrast_visibility_threshold: float = 20,
                speck_group_contrast_method: str = Contrast.WEBER,
                speck_group_visibility_threshold: float = 50,
                speck_group_half_thresh: int = 2,
                speck_group_full_thresh: int = 4,
                fiber_sigmas_ratio: tuple = (0.75, 1),
                fiber_max_gap: float = 4.0,
                fiber_len_half_thresh: float = 5,
                fiber_len_full_thresh: float = 8,
                fiber_orientation_tolerance: float = 5,
                x_adjustment: float = 0, y_adjustment: float = 0,
                angle_adjustment: float = 0, roi_size_factor: float = 1,
                scaling_factor: float = 1, device=None) -> None:
        super().analyze(
            low_contrast_threshold=low_contrast_threshold, invert=invert,
            angle_override=angle_override, center_override=center_override,
            size_override=size_override, ssd=ssd,
            low_contrast_method=low_contrast_method,
            visibility_threshold=low_contrast_visibility_threshold,
            x_adjustment=x_adjustment, y_adjustment=y_adjustment,
            angle_adjustment=angle_adjustment,
            roi_size_factor=roi_size_factor, scaling_factor=scaling_factor,
            device=device)
        self._analyze_speck_group(
            contrast_method=speck_group_contrast_method,
            visibility_threshold=speck_group_visibility_threshold,
            half_thresh=speck_group_half_thresh,
            full_thresh=speck_group_full_thresh)
        self._analyze_fibers(
            sigmas_ratio=fiber_sigmas_ratio, max_gap=fiber_max_gap,
            fiber_orientation_tolerance=fiber_orientation_tolerance,
            fiber_len_half_thresh=fiber_len_half_thresh,
            fiber_len_full_thresh=fiber_len_full_thresh)

    def _offset_to_global(self, x_offset_mm: float,
                          y_offset_mm: float) -> Point:
        """Phantom-frame mm offset -> global pixel point (rotation-aware)."""
        a = np.deg2rad(self.phantom_angle)
        dx = self.dpmm * x_offset_mm
        dy = self.dpmm * y_offset_mm
        gx = self.phantom_center.x + dx * np.cos(a) - dy * np.sin(a)
        gy = self.phantom_center.y + dx * np.sin(a) + dy * np.cos(a)
        return Point(gx, gy)

    def _analyze_speck_group(self, contrast_method, visibility_threshold,
                             half_thresh, full_thresh) -> None:
        self.speck_groups: list = []
        for stng_grp in self.speck_group_roi_settings.values():
            center = self._offset_to_global(stng_grp["x offset"],
                                            stng_grp["y offset"])
            grp = self.SpeckGroupROI(
                array=self.image.array,
                roi_size=self.dpmm * stng_grp["size"],
                roi_center=center,
                speck_roi_settings=self.speck_roi_settings,
                speck_radius=self.dpmm * 0.5 * stng_grp["speck_diameter"],
                dpmm=self.dpmm, contrast_method=contrast_method,
                visibility_threshold=visibility_threshold,
                half_thresh=half_thresh, full_thresh=full_thresh)
            self.speck_groups.append(grp)

    def _analyze_fibers(self, sigmas_ratio, max_gap,
                        fiber_orientation_tolerance, fiber_len_half_thresh,
                        fiber_len_full_thresh) -> None:
        self.fibers: list = []
        for stng in self.fibers_roi_settings.values():
            center = self._offset_to_global(stng["x offset"], stng["y offset"])
            roi = self.FiberROI(
                array=self.image.array, roi_size=stng["size"],
                roi_center=center, fiber_diameter=stng["fiber_diameter"],
                fiber_len_half_thresh=fiber_len_half_thresh,
                fiber_len_full_thresh=fiber_len_full_thresh,
                fiber_orientation=stng["fiber_orientation"]
                + self.phantom_angle,
                fiber_orientation_tolerance=fiber_orientation_tolerance,
                dpmm=self.dpmm, sigmas_ratio=sigmas_ratio, max_gap=max_gap,
                device=self.device)
            self.fibers.append(roi)

    def results(self, as_list: bool = False) -> str | list[str]:
        text = [f"{self.common_name} results:",
                f"File: {self.image.truncated_path}"]
        num_masses = sum(roi.passed_visibility
                         for roi in self.low_contrast_rois)
        text += [
            f"Median Contrast: "
            f"{np.median([roi.contrast for roi in self.low_contrast_rois]):2.2f}",
            f'Masses "seen": {num_masses:2.0f} of {len(self.low_contrast_rois)}',
        ]
        speck_scores = ", ".join(f"{g.score:.1f}" for g in self.speck_groups)
        text.append(f"Speck Group Scores: {speck_scores}")
        fiber_scores = ", ".join(f"{f.score:.1f}" for f in self.fibers)
        text.append(f"Fiber Scores: {fiber_scores}")
        return text if as_list else "\n".join(text)

    def _generate_results_data(self) -> ACRDigitalMammographyResult:
        if self._low_contrast_threshold is None:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        lcr = self.low_contrast_rois
        return ACRDigitalMammographyResult(
            analysis_type=self.common_name,
            phantom_center_x_y=(self.phantom_center.x, self.phantom_center.y),
            mass_score=int(sum(roi.passed_visibility for roi in lcr)),
            mass_rois=[roi.as_dict() for roi in lcr],
            phantom_area=self.phantom_area,
            speck_group_score=sum(g.score for g in self.speck_groups),
            speck_group_rois=[s.as_dict() for s in self.speck_groups],
            fiber_score=sum(f.score for f in self.fibers),
            fiber_rois=[f.as_dict() for f in self.fibers])

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data()
        return {
            "Mass ROI Score": QuaacDatum(
                value=data.mass_score, unit="",
                description="Number of Mass ROIs 'seen'"),
            "Fiber Score": QuaacDatum(value=data.fiber_score, unit="",
                                      description="Fiber ACR score"),
            "Speck Group Score": QuaacDatum(
                value=data.speck_group_score, unit="",
                description="Speck Group ACR score"),
        }

    def plot_analyzed_image(self, image: bool = True, low_contrast: bool = True,
                            high_contrast: bool = True, show: bool = True,
                            split_plots: bool = False, **plt_kwargs):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.imshow(self.image.array, cmap="gray", vmin=self.window_floor(),
                  vmax=self.window_ceiling())
        for roi in self.low_contrast_background_rois:
            ax.add_patch(plt.Circle((roi.center.x, roi.center.y), roi.radius,
                                    fill=False, edgecolor="b"))
        for roi in self.low_contrast_rois:
            color = "green" if roi.contrast > roi.contrast_threshold else "red"
            ax.add_patch(plt.Circle((roi.center.x, roi.center.y), roi.radius,
                                    fill=False, edgecolor=color))
        for grp in self.speck_groups:
            grp.plot2axes(ax)
        for fiber in self.fibers:
            fiber.plot2axes(ax)
        ax.set_title(f"{self.common_name} Phantom Analysis")
        if show:
            plt.show()
        return [fig], ["image"]
