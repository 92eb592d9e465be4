"""GE Helios daily CT QA phantom analysis.

Port of ``pylinac_tpu/helios.py``: ``HeliosContrastScaleModule`` (``:47``,
Plexiglass against water), ``HeliosHighContrastModule`` (``:92``, the
bar-pattern rMTF through :class:`pylinac_tpu_torch.core.mtf.MTF`),
``HeliosLowContrastModule`` (``:144``, a 15 x 15 grid of 5 mm cells) and
the three-slice ``HeliosLowContrastMultiSliceModule`` (``:190``),
``HeliosNoiseUniformityModule`` (``:223``), ``GEHeliosCTDaily`` (``:310``,
with its own ``localize`` and the variance-based ``find_origin_slice``
``:351-383``) and the result models (``:82-307``) as dataclasses. All of it
sits on the port's CatPhan engine (:mod:`pylinac_tpu_torch.ct`).

``analyze(device=None)`` runs on CUDA unless the caller passes another
device, and raises without one: the stack's localisation launches
``csrc/ccl.cu`` (label and hole modes) on the pooled stack, and the
origin-slice search builds one ``Slice`` per image, as JAX does, each of
whose region searches is one label and one holes launch at B = 1. The ROIs
stay numpy on the host. ``capture_warnings`` wraps the public functions of
the class's own body, as in JAX.

Not ported: the plots, ``save_images``, ``publish_pdf``,
``_quaac_datapoints`` and the demo loader.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .core.geometry import Point
from .core.mtf import MTF
from .core.roi import RectangleROI
from .core.utilities import DataModel, ResultBase, not_ported, resolve_device
from .core.warnings import capture_warnings
from .ct import CatPhanBase, CatPhanModule, Slice

SECTION_3_OFFSET_MM = 60
HELIOS_LOW_CONTRAST_SLICE_OFFSETS_INDEX = {"slice_1": 0, "slice_2": -1, "slice_3": -2}

# CatPhanBase's reports draw the CatPhan family's modules; these classes
# have reports of their own, which wait for ROADMAP item 11
_REPORTS = ("plot_analyzed_image", "plot_analyzed_subimage", "plot_images", "plot_side_view",
             "plotly_analyzed_images", "publish_pdf", "to_quaac")


def _rectangles(module, settings: dict) -> dict[str, RectangleROI]:
    """The module's rectangle ROIs of converted ``settings``."""
    return {name: RectangleROI.from_phantom_center(
                array=module.image, width=setting["width_pixels"],
                height=setting["height_pixels"], angle=setting["angle_corrected"],
                dist_from_center=setting["distance_pixels"],
                phantom_center=module.phan_center)
            for name, setting in settings.items()}


class HeliosContrastScaleModule(CatPhanModule):
    """Plexiglass against water."""

    common_name = "Contrast Scale"
    attr_name = "contrast_scale_module"
    roi_settings = {
        "Plexiglass": {"width": 10, "height": 10, "distance": 35, "angle": -135},
        "Water": {"width": 10, "height": 10, "distance": 75, "angle": -90},
    }

    def _setup_rois(self) -> None:
        self.rois = _rectangles(self, self.roi_settings)

    @property
    def contrast_difference(self) -> float:
        """Mean HU difference: Plexiglass - Water."""
        return self.rois["Plexiglass"].mean - self.rois["Water"].mean

    def as_dict(self) -> dict:
        return {"data": {
            "mean_hu": {name: roi.mean for name, roi in self.rois.items()},
            "std": {name: roi.std for name, roi in self.rois.items()}}}


@dataclasses.dataclass(kw_only=True)
class HeliosContrastScaleModuleOutput(DataModel):
    offset: float
    roi_settings: dict
    rois: dict
    mean_hu_water: float
    mean_hu_plastic: float
    hu_difference: float
    std_dev_water: float


class HeliosHighContrastModule(CatPhanModule):
    """Bar-pattern spatial resolution."""

    common_name = "High Contrast"
    attr_name = "high_contrast_module"
    roi_settings = {
        "1.6mm": {"width": 8, "height": 8, "distance": 42, "angle": -53, "bar_size": 1.6},
        "1.3mm": {"width": 7, "height": 7, "distance": 21, "angle": -62, "bar_size": 1.3},
        "1.0mm": {"width": 6, "height": 6, "distance": 5, "angle": -120, "bar_size": 1.0},
        "0.8mm": {"width": 5, "height": 5, "distance": 16, "angle": 146, "bar_size": 0.8},
    }

    def _setup_rois(self) -> None:
        self.rois = _rectangles(self, self.roi_settings)

    @property
    def mtf(self) -> MTF:
        """The rMTF of the bar ROIs; frequency = 1 / (2 x bar size)."""
        spacings = [1 / (2 * roi["bar_size"]) for roi in self.roi_settings.values()]
        return MTF.from_high_contrast_diskset(spacings=spacings,
                                              diskset=list(self.rois.values()))

    def as_dict(self) -> dict:
        return {name: roi.std for name, roi in self.rois.items()}


@dataclasses.dataclass(kw_only=True)
class HeliosHighContrastModuleOutput(DataModel):
    offset: float
    rois: dict
    mtf_lp_mm: dict
    std_dev_1_6mm: float
    std_dev_1_3mm: float
    std_dev_1_0mm: float
    std_dev_0_8mm: float


class HeliosLowContrastModule(CatPhanModule):
    """A 15 x 15 grid of 5 mm cells over the uniform water region."""

    common_name = "Low Contrast Detectability"
    attr_name = "low_contrast_module"
    cell_size: float = 5.0
    num_cells: int = 15

    def _setup_rois(self) -> None:
        self.common_name = f"Low Contrast - {self.slice_num + 1}"
        roi_size_px = self.cell_size / self.mm_per_pixel
        total_size_px = roi_size_px * self.num_cells
        half_grid = total_size_px / 2
        half_roi = roi_size_px / 2
        self.rois = []
        for row in range(self.num_cells):
            for col in range(self.num_cells):
                center = Point(
                    self.phan_center.x - half_grid + col * roi_size_px + half_roi,
                    self.phan_center.y - half_grid + row * roi_size_px + half_roi)
                self.rois.append(RectangleROI(array=self.image, width=roi_size_px,
                                              height=roi_size_px, center=center))

    @property
    def mean(self) -> float:
        return float(np.mean([roi.mean for roi in self.rois]))

    @property
    def std(self) -> float:
        """The standard deviation of the cells' means."""
        return float(np.std([roi.mean for roi in self.rois]))


@dataclasses.dataclass(kw_only=True)
class HeliosLowContrastModuleOutput(DataModel):
    offset: float
    settings: dict
    mean: float
    std: float


class HeliosLowContrastMultiSliceModule:
    """Low contrast across three adjacent slices of Section 3."""

    roi_settings = {
        "slice_1": {"offset": HELIOS_LOW_CONTRAST_SLICE_OFFSETS_INDEX["slice_1"]},
        "slice_2": {"offset": HELIOS_LOW_CONTRAST_SLICE_OFFSETS_INDEX["slice_2"]},
        "slice_3": {"offset": HELIOS_LOW_CONTRAST_SLICE_OFFSETS_INDEX["slice_3"]},
    }

    def __init__(self, catphan) -> None:
        self.slices: dict[str, HeliosLowContrastModule] = {}
        slice_spacing = catphan.dicom_stack.slice_spacing
        for key, value in self.roi_settings.items():
            offset_mm = int(value["offset"] * slice_spacing + SECTION_3_OFFSET_MM)
            self.slices[key] = HeliosLowContrastModule(catphan, offset=offset_mm)

    @property
    def mean(self) -> float:
        return float(np.mean([s.mean for s in self.slices.values()]))

    @property
    def std(self) -> float:
        return float(np.mean([s.std for s in self.slices.values()]))


@dataclasses.dataclass(kw_only=True)
class HeliosLowContrastMultiSliceModuleOutput(DataModel):
    slices: dict
    mean: float
    std: float
    low_contrast_mean: float
    low_contrast_std: float


class HeliosNoiseUniformityModule(CatPhanModule):
    """Noise and centre-to-edge uniformity."""

    common_name = "Noise & Uniformity"
    attr_name = "noise_uniformity_module"
    roi_settings = {
        "Center": {"width": 15, "height": 15, "distance": 0, "angle": 0},
        "12 o'clock": {"width": 15, "height": 15, "distance": 75, "angle": -90},
        "3 o'clock": {"width": 15, "height": 15, "distance": 75, "angle": 0},
    }
    noise_roi_settings = {
        "Center": {"width": 25, "height": 25, "distance": 0, "angle": 0},
    }

    def _setup_rois(self) -> None:
        self.rois = _rectangles(self, self.roi_settings)
        self.noise_rois = _rectangles(self, self.noise_roi_settings)

    @property
    def noise_center_std(self) -> float:
        return self.noise_rois["Center"].std

    @property
    def mean_outer(self) -> float:
        return float(np.mean([self.rois["12 o'clock"].mean, self.rois["3 o'clock"].mean]))

    @property
    def uniformity_difference(self) -> float:
        return float(self.rois["Center"].mean - self.mean_outer)

    def as_dict(self) -> dict:
        return {"mean_hu": {name: roi.mean for name, roi in self.rois.items()},
                "std": {name: roi.std for name, roi in self.rois.items()}}


@dataclasses.dataclass(kw_only=True)
class HeliosNoiseUniformityModuleOutput(DataModel):
    offset: float
    roi_settings: dict
    rois: dict
    noise_center_std: float
    mean_outer: float
    means_diff: float
    center_mean_hu: float
    center_noise_std_dev: float
    three_oclock_mean_hu: float
    twelve_oclock_mean_hu: float
    average_outer_mean_hu: float
    center_outer_mean_difference: float


@dataclasses.dataclass(kw_only=True)
class GEHeliosResult(ResultBase):
    phantom_model: str
    phantom_roll_deg: float
    origin_slice: int
    num_images: int
    contrast_scale: HeliosContrastScaleModuleOutput
    high_contrast: HeliosHighContrastModuleOutput
    low_contrast: HeliosLowContrastMultiSliceModuleOutput
    noise_uniformity: HeliosNoiseUniformityModuleOutput


@not_ported(*_REPORTS)
@capture_warnings
class GEHeliosCTDaily(CatPhanBase):
    """GE Helios daily CT QA."""

    _model = "GE Helios CT Daily"
    catphan_radius_mm = 107.5
    min_num_images = 8
    clear_borders = False
    contrast_scale_module = HeliosContrastScaleModule
    high_contrast_module = HeliosHighContrastModule
    low_contrast_multi_slice = HeliosLowContrastMultiSliceModule
    noise_uniformity_module = HeliosNoiseUniformityModule

    def analyze(self, x_adjustment: float = 0, y_adjustment: float = 0,
                angle_adjustment: float = 0, roi_size_factor: float = 1,
                scaling_factor: float = 1, origin_slice: int | None = None,
                device=None) -> None:
        """Full analysis on ``device`` (``None`` means ``"cuda"``, and raises
        when no CUDA device exists)."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self.roll_slice_offset = 0
        self.localize(origin_slice=origin_slice)
        self.contrast_scale_module = type(self).contrast_scale_module(
            self, offset=0, clear_borders=self.clear_borders)
        self.high_contrast_module = type(self).high_contrast_module(
            self, offset=0, clear_borders=self.clear_borders)
        self.low_contrast_multi_slice = type(self).low_contrast_multi_slice(self)
        self.noise_uniformity_module = type(self).noise_uniformity_module(
            self, offset=SECTION_3_OFFSET_MM, clear_borders=self.clear_borders)

    def localize(self, origin_slice: int | None = None) -> None:
        """The phantom's axis, the origin slice (unless given) and the
        roll; no refinement of the origin."""
        if getattr(self, "_slice_centroids", None) is None:
            self._slice_centroids = self._batched_phantom_centroids()
        self._phantom_center_func = self.find_phantom_axis()
        if origin_slice is not None:
            self.origin_slice = origin_slice
        else:
            self.origin_slice = self.find_origin_slice()
        self.catphan_roll = self.find_phantom_roll() + self.angle_adjustment
        if not self._ensure_physical_scan_extent():
            raise ValueError(
                "The physical scan extent does not cover the extent of "
                "module configuration. This means not all modules were "
                "included in the scan. Rescan the phantom to include all "
                "relevant modules, or change the offset values.")

    def find_origin_slice(self) -> int:
        """Section 1: the slices whose pixel variance inside 80 % of the
        phantom's radius is over half the highest one's, their mean index.
        Each image builds its own :class:`Slice` (a B = 1 region search)."""
        num_slices = len(self.dicom_stack)
        variances = np.zeros(num_slices)
        for idx in range(num_slices):
            slice_obj = Slice(self, slice_num=idx, combine=False,
                              clear_borders=self.clear_borders)
            if not slice_obj.is_phantom_in_view():
                continue
            center = slice_obj.phan_center
            radius_px = self.catphan_radius_mm * 0.8 / self.mm_per_pixel
            arr = np.asarray(slice_obj.image.array)
            h, w = arr.shape
            yy, xx = np.mgrid[:h, :w]
            disk = ((yy - center.y) ** 2 + (xx - center.x) ** 2) < radius_px**2
            variances[idx] = float(np.var(arr[disk]))
        max_variance = variances.max()
        candidate_indices = np.argwhere(variances > max_variance / 2)
        return int(np.mean(candidate_indices))

    def find_phantom_roll(self, func: Callable | None = None) -> float:
        """The phantom sits in a bracket: its roll is always 0."""
        return 0.0

    def _module_offsets(self) -> list[float]:
        absolute_origin_position = self.dicom_stack[self.origin_slice].z_position
        return [absolute_origin_position, absolute_origin_position + SECTION_3_OFFSET_MM]

    def results(self, as_str: bool = True) -> str | tuple:
        lines = [f" - {self._model} Results - ",
                 f"Phantom Roll: {self.catphan_roll:2.2f} deg"]
        for name, roi in self.contrast_scale_module.rois.items():
            lines.append(f"Contrast Scale {name} Mean HU: {roi.mean:2.2f}")
            lines.append(f"Contrast Scale {name} Std: {roi.std:2.2f}")
        lines.append(f"Contrast Difference: "
                     f"{self.contrast_scale_module.contrast_difference:2.2f}")
        for name, roi in self.high_contrast_module.rois.items():
            lines.append(f"High Contrast {name} ROI Std: {roi.std:2.2f}")
        for resolution in range(10, 91, 10):
            lp_mm = self.high_contrast_module.mtf.relative_resolution(resolution)
            lines.append(f"MTF {resolution}% (lp/mm): {lp_mm:2.2f}")
        for slice_name, mod in self.low_contrast_multi_slice.slices.items():
            lines.append(f"Low Contrast {slice_name} Mean: {mod.mean:2.2f}")
        for slice_name, mod in self.low_contrast_multi_slice.slices.items():
            lines.append(f"Low Contrast {slice_name} Std: {mod.std:2.2f}")
        lines.append(f"Low Contrast Mean: {self.low_contrast_multi_slice.mean:2.2f}")
        lines.append(f"Low Contrast Standard Deviation: "
                     f"{self.low_contrast_multi_slice.std:2.2f}")
        for name, roi in self.noise_uniformity_module.rois.items():
            lines.append(f"Noise Uniformity {name} Mean HU: {roi.mean:2.2f}")
            lines.append(f"Noise Uniformity {name} Std: {roi.std:2.2f}")
        lines.append(f"Noise Center Std: {self.noise_uniformity_module.noise_center_std:2.2f}")
        lines.append(f"Mean Outer HU: {self.noise_uniformity_module.mean_outer:2.2f}")
        lines.append(f"Uniformity Difference: "
                     f"{self.noise_uniformity_module.uniformity_difference:2.2f}")
        return "\n".join(lines) if as_str else tuple(lines)

    def _generate_results_data(self) -> GEHeliosResult:
        hc = self.high_contrast_module
        mtfs = {r: hc.mtf.relative_resolution(r) for r in range(10, 91, 10)}
        lc = self.low_contrast_multi_slice
        slice_outputs = {
            k: HeliosLowContrastModuleOutput(
                offset=lc.roi_settings[k]["offset"],
                settings={"cell_size": v.cell_size, "num_cells": v.num_cells},
                mean=v.mean, std=v.std)
            for k, v in lc.slices.items()}
        cs = self.contrast_scale_module
        nu = self.noise_uniformity_module
        return GEHeliosResult(
            phantom_model=self._model,
            phantom_roll_deg=self.catphan_roll,
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            contrast_scale=HeliosContrastScaleModuleOutput(
                offset=0, roi_settings=cs.roi_settings, rois=cs.as_dict(),
                mean_hu_water=cs.rois["Water"].mean,
                mean_hu_plastic=cs.rois["Plexiglass"].mean,
                hu_difference=cs.contrast_difference,
                std_dev_water=cs.rois["Water"].std),
            high_contrast=HeliosHighContrastModuleOutput(
                offset=0, rois=hc.as_dict(), mtf_lp_mm=mtfs,
                std_dev_1_6mm=hc.rois["1.6mm"].std, std_dev_1_3mm=hc.rois["1.3mm"].std,
                std_dev_1_0mm=hc.rois["1.0mm"].std, std_dev_0_8mm=hc.rois["0.8mm"].std),
            low_contrast=HeliosLowContrastMultiSliceModuleOutput(
                slices=slice_outputs, mean=lc.mean, std=lc.std,
                low_contrast_mean=lc.mean, low_contrast_std=lc.std),
            noise_uniformity=HeliosNoiseUniformityModuleOutput(
                offset=SECTION_3_OFFSET_MM, roi_settings=nu.roi_settings,
                rois=nu.as_dict(), noise_center_std=nu.noise_center_std,
                mean_outer=nu.mean_outer, means_diff=nu.uniformity_difference,
                center_mean_hu=nu.rois["Center"].mean,
                center_noise_std_dev=nu.noise_center_std,
                three_oclock_mean_hu=nu.rois["3 o'clock"].mean,
                twelve_oclock_mean_hu=nu.rois["12 o'clock"].mean,
                average_outer_mean_hu=nu.mean_outer,
                center_outer_mean_difference=nu.uniformity_difference))
