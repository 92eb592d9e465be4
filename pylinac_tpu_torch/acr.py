"""ACR CT 464 and ACR MRI Large phantom analysis.

Port of ``pylinac_tpu/acr.py``. The CT half: ``CTModule`` (``:58``),
``UniformityModule`` (``:84``), ``SpatialResolutionModule`` (``:106``, the
8-bar rMTF through :class:`~pylinac_tpu_torch.core.roi.HighContrastDiskROI`
and ``MTF.from_high_contrast_diskset``), ``LowContrastModule`` (``:154``)
and ``ACRCT`` (``:195``). The MR half: ``MRSlice11PositionModule``
(``:410``), ``MRSlice1Module`` (``:455``), ``MRUniformityModule``
(``:555``), ``MRLowContrastModule`` (``:646``) with its multi-slice
``MRLowContrastMultiSliceModule`` (``:799``), ``GeometricDistortionModule``
(``:834``), ``SagittalLocalizationModule`` (``:905``) and ``ACRMRILarge``
(``:981``: its own ``localize`` ``:1007``, roll, ``_select_echo_images``
and ``_select_sagittal_image``). The result models are dataclasses with the
JAX models' fields. All of it sits on the port's CatPhan engine
(:mod:`pylinac_tpu_torch.ct`).

``analyze(device=None)`` runs on CUDA unless the caller passes another
device, and raises without one. There the stack's localisation launches
``csrc/ccl.cu`` (label and hole modes) on the pooled stack and the roll
slice's region search both modes at B = 1; for the MR phantom the
geometric-distortion slice and the sagittal localiser fill their holes
through ``csrc/flood.cu`` (:func:`ops.label.fill_holes`), and each
low-contrast slice keeps its 64 largest regions
(:func:`ops.label.keep_largest`, a label launch) and measures them
(:func:`ops.label.regionprops`, label and holes). The ROIs, profiles and
MTFs stay numpy on the host, as in JAX. ``capture_warnings`` wraps the
public functions of each class's own body, as in JAX: ``ACRMRILarge``'s
``analyze`` captures its "Multiple echoes found" warning.

Removing the other echoes and the sagittal image deletes each image and
its metadata from the stack once, as on JAX's eager stack, whose
``metadatas`` is a new list (the JAX code's second ``del`` on it changes
nothing and is left out). The cached host volume of the localisation is
built after both were taken out.

The reports (the modules' ``plot_rois`` and the sagittal ``plot``, ACR CT
``:217-397``, ACR MRI ``:1001-1212``): the plots, ``save_images`` and
``publish_pdf``, which embeds the saved images, import matplotlib inside
and raise ``ModuleNotFoundError`` where it is missing; ACR CT's
``to_quaac`` and the generic ``plotly_analyzed_images`` (``CatPhanBase``'s)
need none. As in JAX, ``ACRMRILarge.to_quaac`` reaches ``CatPhanBase``'s
datapoints, which read a ``ctp404`` the class has not, and raises
``AttributeError``. Not ported: the demo loaders.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from .core.array_utils import fill_middle_zeros, find_nearest_idx
from .core.contrast import Contrast
from .core.geometry import Line, Point
from .core.mtf import MTF
from .core.profile import FWXMProfile
from .core.roi import DiskROI, HighContrastDiskROI, LowContrastDiskROI, RectangleROI
from .core.utilities import DataModel, QuaacDatum, ResultBase, resolve_device
from .core.warnings import capture_warnings
from .ct import (CatPhanBase, CatPhanModule, Slice, ThicknessROI, get_regions,
                 publish_images_pdf, rois_to_results, save_figures, wrapped)
from .metrics.utils import valid_region_views
from .ops import label as tlabel
from .ops.filters import gaussian_filter, scharr
from .ops.interp import map_coordinates
from .ops.threshold import otsu_threshold, threshold_li

# CT
CT_UNIFORMITY_MODULE_OFFSET_MM = 70
CT_SPATIAL_RESOLUTION_MODULE_OFFSET_MM = 100
CT_LOW_CONTRAST_MODULE_OFFSET_MM = 30

# MR
MR_SLICE11_MODULE_OFFSET_MM = 100
MR_GEOMETRIC_DISTORTION_MODULE_OFFSET_MM = 40
MR_UNIFORMITY_MODULE_OFFSET_MM = 60
MR_LOW_CONTRAST_MODULE_OFFSETS_MM = {8: 70, 9: 80, 10: 90, 11: 100}


def _filled(mask: np.ndarray, device) -> np.ndarray:
    """A host mask with its holes filled on ``device`` (``csrc/flood.cu``
    on the card), as float64."""
    mask = torch.as_tensor(np.ascontiguousarray(mask), device=device)
    return tlabel.fill_holes(mask).cpu().numpy().astype(float)


# --------------------------------------------------------------------------
# ACR CT 464
# --------------------------------------------------------------------------
class CTModule(CatPhanModule):
    """HU linearity."""

    common_name = "HU Linearity"
    attr_name = "ct_calibration_module"
    roi_dist_mm = 63
    roi_radius_mm = 10
    roi_settings = {
        "Air": {"angle": 45, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"angle": 225, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"angle": 135, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Bone": {"angle": -45, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Water": {"angle": 180, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    window_min = -200
    window_max = 200


@dataclasses.dataclass(kw_only=True)
class CTModuleOutput(DataModel):
    offset: float
    roi_distance_from_center_mm: float
    roi_radius_mm: float
    roi_settings: dict
    rois: dict


class UniformityModule(CatPhanModule):
    """HU uniformity: four ROIs at 66 mm and the centre."""

    attr_name = "uniformity_module"
    common_name = "HU Uniformity"
    roi_dist_mm = 66
    roi_radius_mm = 11
    roi_settings = {
        "Top": {"angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Right": {"angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Bottom": {"angle": 90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Left": {"angle": 180, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Center": {"angle": 0, "distance": 0, "radius": roi_radius_mm},
    }
    window_min = -50
    window_max = 50


@dataclasses.dataclass(kw_only=True)
class UniformityModuleOutput(CTModuleOutput):
    center_roi_stdev: float


class SpatialResolutionModule(CatPhanModule):
    """Eight bar-pattern groups and their rMTF."""

    attr_name = "spatial_resolution_module"
    common_name = "Spatial Resolution"
    roi_dist_mm = 70
    roi_radius_mm = 6
    roi_settings = {
        "10oclock": {"angle": -135, "distance": roi_dist_mm, "radius": roi_radius_mm,
                     "lp/mm": 0.4},
        "9oclock": {"angle": -180, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 0.5},
        "7oclock": {"angle": 135, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 0.6},
        "6oclock": {"angle": 90, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 0.7},
        "4oclock": {"angle": 45, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 0.8},
        "3oclock": {"angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 0.9},
        "2oclock": {"angle": -45, "distance": roi_dist_mm, "radius": roi_radius_mm,
                    "lp/mm": 1.0},
        "12oclock": {"angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm,
                     "lp/mm": 1.2},
    }

    def _setup_rois(self) -> None:
        for name, setting in self.roi_settings.items():
            self.rois[name] = HighContrastDiskROI.from_phantom_center(
                self.image, setting["angle_corrected"], setting["radius_pixels"],
                setting["distance_pixels"], self.phan_center, contrast_threshold=1.0)

    @property
    def mtf(self) -> MTF:
        spacings = [roi["lp/mm"] for roi in self.roi_settings.values()]
        return MTF.from_high_contrast_diskset(spacings=spacings,
                                              diskset=list(self.rois.values()))

    def plot_rois(self, axis) -> None:
        for roi in self.rois.values():
            roi.plot2axes(axis, edgecolor="g")


@dataclasses.dataclass(kw_only=True)
class SpatialResolutionModuleOutput(CTModuleOutput):
    lpmm_to_rmtf: dict


class LowContrastModule(CatPhanModule):
    """One low-contrast ROI against its background: the CNR."""

    attr_name = "low_contrast_module"
    common_name = "Low Contrast"
    roi_dist_mm = 60
    roi_radius_mm = 6
    roi_settings = {
        "ROI": {"angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    background_roi_settings = {
        "ROI": {"angle": -115, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    window_min = 50
    window_max = 150

    def cnr(self) -> float:
        """|A - B| / SD(B), per the ACR guidance."""
        return (abs(self.rois["ROI"].pixel_value - self.background_rois["ROI"].pixel_value)
                / self.background_rois["ROI"].std)


@dataclasses.dataclass(kw_only=True)
class LowContrastModuleOutput(CTModuleOutput):
    cnr: float


@dataclasses.dataclass(kw_only=True)
class ACRCTResult(ResultBase):
    phantom_model: str
    phantom_roll_deg: float
    origin_slice: int
    num_images: int
    ct_module: CTModuleOutput
    uniformity_module: UniformityModuleOutput
    low_contrast_module: LowContrastModuleOutput
    spatial_resolution_module: SpatialResolutionModuleOutput


def _ct_output(cls, module, offset, **extra):
    return cls(offset=offset, roi_distance_from_center_mm=module.roi_dist_mm,
               roi_radius_mm=module.roi_radius_mm, roi_settings=module.roi_settings,
               rois={name: roi.pixel_value for name, roi in module.rois.items()}, **extra)


@capture_warnings
class ACRCT(CatPhanBase):
    """ACR CT 464 phantom analysis."""

    _model = "ACR CT 464"
    catphan_radius_mm = 100
    air_bubble_radius_mm = 14
    min_num_images = 4
    localization_radius = 70
    ct_calibration_module = CTModule
    low_contrast_module = LowContrastModule
    spatial_resolution_module = SpatialResolutionModule
    uniformity_module = UniformityModule
    clear_borders = False

    def plot_analyzed_subimage(self, *args, **kwargs):
        raise NotImplementedError("Use `plot_images`")

    def save_analyzed_subimage(self, *args, **kwargs):
        raise NotImplementedError("Use `save_images`")

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
        cls = type(self)
        self.ct_calibration_module = cls.ct_calibration_module(
            self, offset=0, clear_borders=self.clear_borders)
        self.uniformity_module = cls.uniformity_module(
            self, offset=CT_UNIFORMITY_MODULE_OFFSET_MM, clear_borders=self.clear_borders)
        self.spatial_resolution_module = cls.spatial_resolution_module(
            self, offset=CT_SPATIAL_RESOLUTION_MODULE_OFFSET_MM,
            clear_borders=self.clear_borders)
        self.low_contrast_module = cls.low_contrast_module(
            self, offset=CT_LOW_CONTRAST_MODULE_OFFSET_MM, clear_borders=self.clear_borders)

    def find_phantom_roll(self, func=lambda roi: roi.bbox_area) -> float:
        """The roll from the two air bubbles, the candidates sorted by size
        and not by centrality (both air ROIs are on the right)."""
        return super().find_phantom_roll(func)

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs):
        import matplotlib.pyplot as plt

        fig = plt.figure(**plt_kwargs)
        grid_size = (2, 3)
        self.ct_calibration_module.plot(plt.subplot2grid(grid_size, (0, 0)))
        self.uniformity_module.plot(plt.subplot2grid(grid_size, (0, 1)))
        self.spatial_resolution_module.plot(plt.subplot2grid(grid_size, (0, 2)))
        self.low_contrast_module.plot(plt.subplot2grid(grid_size, (1, 0)))
        self.spatial_resolution_module.mtf.plot(plt.subplot2grid(grid_size, (1, 2)))
        self.plot_side_view(plt.subplot2grid(grid_size, (1, 1)))
        plt.tight_layout()
        if show:
            plt.show()
        return fig

    def save_analyzed_image(self, filename, **plt_kwargs) -> None:
        fig = self.plot_analyzed_image(show=False, **plt_kwargs)
        fig.savefig(filename)

    def plot_images(self, show: bool = True, **plt_kwargs) -> dict:
        """A figure per module, the rMTF and the side view:
        ``{name: Figure}``."""
        import matplotlib.pyplot as plt

        figs = {}
        modules = {"hu": self.ct_calibration_module,
                   "uniformity": self.uniformity_module,
                   "spatial resolution": self.spatial_resolution_module,
                   "low contrast": self.low_contrast_module}
        for key, module in modules.items():
            fig, ax = plt.subplots(**plt_kwargs)
            module.plot(ax)
            figs[key] = fig
        fig, ax = plt.subplots(**plt_kwargs)
        figs["mtf"] = fig
        self.spatial_resolution_module.mtf.plot(ax)
        fig, ax = plt.subplots(**plt_kwargs)
        figs["side"] = fig
        self.plot_side_view(ax)
        plt.tight_layout()
        if show:
            plt.show()
        return figs

    def save_images(self, directory=None, to_stream: bool = False, **plt_kwargs) -> list:
        """:meth:`plot_images` as PNG files in ``directory`` or as streams."""
        return save_figures(self.plot_images(show=False, **plt_kwargs), directory, to_stream)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        results_data = self.results_data(as_dict=True)
        data = {"Phantom Roll": QuaacDatum(value=results_data["phantom_roll_deg"],
                                           unit="degrees")}
        for name, value in results_data["ct_module"]["rois"].items():
            data[f"{name} HU"] = QuaacDatum(value=value, unit="HU")
        for name, value in results_data["uniformity_module"]["rois"].items():
            data[f"{name} Uniformity HU"] = QuaacDatum(value=value, unit="HU")
        for name, value in results_data["spatial_resolution_module"]["lpmm_to_rmtf"].items():
            data[f"{name} lp/mm"] = QuaacDatum(value=value, unit="rMTF")
        for name, value in results_data["low_contrast_module"]["rois"].items():
            data[f"{name} CNR"] = QuaacDatum(value=value, unit="CNR")
        return data

    def publish_pdf(self, filename, notes: str | None = None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The HU, contrast and uniformity lines and a page per module
        image; the images need matplotlib."""
        texts = [
            " - ACR CT 464 Results - ",
            f"HU Linearity ROIs: {self.ct_calibration_module.roi_vals_as_str}",
            f"Low contrast visibility: {self.low_contrast_module.cnr():2.2f}",
            f"Uniformity ROIs: {self.uniformity_module.roi_vals_as_str}",
        ]
        images = self.save_images(to_stream=True)
        publish_images_pdf(filename, f"{self._model} Analysis", texts, (1.5, 23), images,
                           notes, open_file, metadata, logo)

    def results(self) -> str:
        return (
            f"\n - ACR CT 464 QA Test - \n"
            f"HU ROIs: {self.ct_calibration_module.roi_vals_as_str}\n"
            f"Contrast to Noise Ratio: {self.low_contrast_module.cnr():2.2f}\n"
            f"Uniformity ROIs: {self.uniformity_module.roi_vals_as_str}\n"
            f"Uniformity Center ROI standard deviation: "
            f"{self.uniformity_module.rois['Center'].std:2.2f}\n"
            f"MTF 50% (lp/mm): "
            f"{self.spatial_resolution_module.mtf.relative_resolution(50):2.2f}\n")

    def _generate_results_data(self) -> ACRCTResult:
        uniformity = self.uniformity_module
        return ACRCTResult(
            phantom_model="ACR CT 464",
            phantom_roll_deg=self.catphan_roll,
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            ct_module=_ct_output(CTModuleOutput, self.ct_calibration_module, 0),
            uniformity_module=_ct_output(
                UniformityModuleOutput, uniformity, CT_UNIFORMITY_MODULE_OFFSET_MM,
                center_roi_stdev=uniformity.rois["Center"].std),
            spatial_resolution_module=_ct_output(
                SpatialResolutionModuleOutput, self.spatial_resolution_module,
                CT_SPATIAL_RESOLUTION_MODULE_OFFSET_MM,
                lpmm_to_rmtf=self.spatial_resolution_module.mtf.norm_mtfs),
            low_contrast_module=_ct_output(
                LowContrastModuleOutput, self.low_contrast_module,
                CT_LOW_CONTRAST_MODULE_OFFSET_MM, cnr=self.low_contrast_module.cnr()))

    def _module_offsets(self) -> list[float]:
        absolute_origin_position = self.dicom_stack[self.origin_slice].z_position
        return [absolute_origin_position + offset for offset in (
            0, CT_UNIFORMITY_MODULE_OFFSET_MM, CT_LOW_CONTRAST_MODULE_OFFSET_MM,
            CT_SPATIAL_RESOLUTION_MODULE_OFFSET_MM)]


# --------------------------------------------------------------------------
# ACR MRI Large
# --------------------------------------------------------------------------
class MRSlice11PositionModule(CatPhanModule):
    """The slice-position bars of slice 11."""

    common_name = "Slice Position, Slice 11"
    roi_settings = {
        "Left": {"width": 2, "height": 25, "distance": 65, "angle": 2.5},
        "Right": {"width": 2, "height": 25, "distance": 65, "angle": -2.5},
    }

    def _setup_rois(self) -> None:
        for name, setting in self.roi_settings.items():
            # -90: the bars extend downward, not rightward
            self.rois[name] = RectangleROI.from_phantom_center(
                self.image, setting["width_pixels"], setting["height_pixels"],
                self.catphan_roll - 90 + setting["angle"], setting["distance_pixels"],
                self.phan_center)

    @property
    def bar_difference_mm(self) -> float:
        """The height difference between the two angled bars."""
        idxs = []
        for roi in (self.rois["Right"], self.rois["Left"]):
            prof = roi.pixel_array.max(axis=int(np.argmin(roi.pixel_array.shape)))
            mid_height = (prof.max() - prof.min()) / 2 + prof.min()
            idxs.append(find_nearest_idx(prof, mid_height))
        return (idxs[0] - idxs[1]) * self.mm_per_pixel

    @property
    def slice_shift_mm(self) -> float:
        """The bars are at 45 degrees: the S/I shift is half their difference."""
        return self.bar_difference_mm / 2

    def plot_rois(self, axis) -> None:
        for roi in self.rois.values():
            roi.plot2axes(axis, edgecolor="blue")


@dataclasses.dataclass(kw_only=True)
class MRSlice11ModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    bar_difference_mm: float
    slice_shift_mm: float


class MRSlice1Module(CatPhanModule):
    """Slice 1: the thickness ramps, the position bars and the resolution
    grids."""

    common_name = "Slice 1 (Thickness, Offset, Resolution)"
    thickness_roi_settings = {
        "Top": {"width": 100, "height": 3, "distance": -3},
        "Bottom": {"width": 100, "height": 3, "distance": 2.5},
    }
    roi_settings = {
        "Row Reference": {"radius": 9, "distance": 58, "angle": 135, "lp/mm": 0},
        "Col Reference": {"radius": 9, "distance": 58, "angle": 135, "lp/mm": 0},
        "Row 1.1": {"radius": 3, "distance": 40, "angle": 116, "lp/mm": 1 / 1.1},
        "Col 1.1": {"radius": 3, "distance": 44, "angle": 104, "lp/mm": 1 / 1.1},
        "Row 1.0": {"radius": 3, "distance": 36, "angle": 81, "lp/mm": 1.0},
        "Col 1.0": {"radius": 3, "distance": 44, "angle": 74, "lp/mm": 1.0},
        "Row 0.9": {"radius": 2, "distance": 46, "angle": 52, "lp/mm": 1 / 0.9},
        "Col 0.9": {"radius": 2, "distance": 55, "angle": 51, "lp/mm": 1 / 0.9},
    }
    position_roi_settings = {
        "Left": {"width": 2, "height": 25, "distance": 65, "angle": 2.5},
        "Right": {"width": 2, "height": 25, "distance": 65, "angle": -2.5},
    }
    spacings = [0, 1 / 1.1, 1, 1 / 0.9]

    def _setup_rois(self) -> None:
        self.thickness_rois = {}
        self.position_rois = {}
        for name, setting in self.thickness_roi_settings.items():
            self.thickness_rois[name] = ThicknessROI.from_phantom_center(
                self.image, setting["width_pixels"], setting["height_pixels"],
                self.catphan_roll + 90, setting["distance_pixels"], self.phan_center)
        for name, setting in self.roi_settings.items():
            self.rois[name] = HighContrastDiskROI.from_phantom_center(
                self.image, setting["angle_corrected"], setting["radius_pixels"],
                setting["distance_pixels"], self.phan_center, contrast_threshold=1.0)
        for name, setting in self.position_roi_settings.items():
            self.position_rois[name] = ThicknessROI.from_phantom_center(
                self.image, setting["width_pixels"], setting["height_pixels"],
                self.catphan_roll - 90 + setting["angle"], setting["distance_pixels"],
                self.phan_center)

    @property
    def bar_difference_mm(self) -> float:
        idxs = []
        for name in ("Left", "Right"):
            values = self.position_rois[name].long_profile.values
            mid = (values.max() - values.min()) / 2 + values.min()
            idxs.append(find_nearest_idx(values, mid))
        return (idxs[1] - idxs[0]) * self.mm_per_pixel

    @property
    def slice_shift_mm(self) -> float:
        return self.bar_difference_mm / 2

    def plot_rois(self, axis) -> None:
        for roi in self.position_rois.values():
            roi.plot2axes(axis, edgecolor="blue")
        for roi in self.thickness_rois.values():
            roi.plot2axes(axis, edgecolor="blue")
        for roi in self.rois.values():
            roi.plot2axes(axis, edgecolor="g")

    @property
    def measured_slice_thickness_mm(self) -> float:
        """0.2 x (T x B) / (T + B) of the two crossed ramps (ACR manual)."""
        top = self.thickness_rois["Top"].wire_fwhm * self.mm_per_pixel
        bottom = self.thickness_rois["Bottom"].wire_fwhm * self.mm_per_pixel
        return 0.2 * (top * bottom) / (top + bottom)

    @property
    def row_mtf(self) -> MTF:
        return MTF.from_high_contrast_diskset(
            spacings=self.spacings,
            diskset=[roi for name, roi in self.rois.items() if "Row" in name])

    @property
    def col_mtf(self) -> MTF:
        return MTF.from_high_contrast_diskset(
            spacings=self.spacings,
            diskset=[roi for name, roi in self.rois.items() if "Col" in name])


@dataclasses.dataclass(kw_only=True)
class MRSlice1ModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    bar_difference_mm: float
    slice_shift_mm: float
    measured_slice_thickness_mm: float
    row_mtf_50: float
    col_mtf_50: float
    row_mtf_lp_mm: dict
    col_mtf_lp_mm: dict


class MRUniformityModule(CatPhanModule):
    """The percent integral uniformity (PIU) and percent-signal ghosting."""

    common_name = "Signal Uniformity"
    roi_settings = {
        # 80 px radius ~= 200 cm2, per the manual
        "Center": {"angle": 90, "distance": 5, "radius": 80},
    }
    ghost_roi_settings = {
        # ~900 mm2, per the manual
        "Top": {"angle": -90, "distance": 110, "width": 60, "height": 15},
        "Bottom": {"angle": 90, "distance": 110, "width": 60, "height": 15},
        "Left": {"angle": 180, "distance": 110, "width": 15, "height": 60},
        "Right": {"angle": 0, "distance": 110, "width": 15, "height": 60},
    }

    def __init__(self, catphan, offset):
        self.tesla = float(catphan.dicom_stack.metadata.MagneticFieldStrength)
        self.ghost_rois = {}
        super().__init__(catphan, tolerance=None, offset=offset)

    def _setup_rois(self) -> None:
        super()._setup_rois()
        for name, roi in self.ghost_roi_settings.items():
            self.ghost_rois[name] = RectangleROI.from_phantom_center(
                self.image, roi["width_pixels"], roi["height_pixels"],
                roi["angle"] + self.catphan_roll, roi["distance_pixels"], self.phan_center)

    def plot_rois(self, axis) -> None:
        super().plot_rois(axis)
        for roi in self.ghost_rois.values():
            roi.plot2axes(axis, edgecolor="yellow")

    @property
    def percent_image_uniformity(self) -> float:
        """PIU, section 5.3 of the ACR MR manual."""
        piu_high = np.percentile(self.rois["Center"].pixel_values, 99)
        piu_low = np.percentile(self.rois["Center"].pixel_values, 1)
        return 100 * (1 - ((piu_high - piu_low) / (piu_high + piu_low)))

    @property
    def piu_passed(self) -> bool:
        if self.tesla < 3:
            return bool(self.percent_image_uniformity > 85)
        return bool(self.percent_image_uniformity > 80)

    @property
    def ghosting_ratio(self) -> float:
        top = self.ghost_rois["Top"].pixel_value
        bottom = self.ghost_rois["Bottom"].pixel_value
        left = self.ghost_rois["Left"].pixel_value
        right = self.ghost_rois["Right"].pixel_value
        return abs(((top + bottom) - (left + right)) / (2 * self.rois["Center"].pixel_value))

    @property
    def psg(self) -> float:
        return self.ghosting_ratio * 100

    @property
    def psg_passed(self) -> bool:
        return bool(self.psg < 3.0)


@dataclasses.dataclass(kw_only=True)
class MRUniformityModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    ghost_roi_settings: dict
    ghost_rois: dict
    psg: float
    ghosting_ratio: float
    piu_passed: bool
    piu: float


def _build_mr_lc_background_settings() -> dict:
    return {f"spoke_{i + 1}": {"angle": angle, "radius": 2.5, "distances": [0, 20, 32]}
            for i, angle in enumerate([-90, -54, -18, 18, 54, 90, 126, 162, 198, 234])}


class MRLowContrastModule(CatPhanModule):
    """The low-contrast spokes of one slice: the complete spokes (all three
    disks visible) up to the first incomplete one."""

    attr_name = "low_contrast_module"
    low_contrast_region_radius = 40  # mm

    _distances = [12.75, 25.50, 38.25]
    _rsf = 0.8 / 2  # diameter -> radius factor
    roi_settings = {
        "spoke_1": {"angle": -90, "radius": 7.0 * _rsf, "distances": _distances},
        "spoke_2": {"angle": -54, "radius": 6.4 * _rsf, "distances": _distances},
        "spoke_3": {"angle": -18, "radius": 5.8 * _rsf, "distances": _distances},
        "spoke_4": {"angle": 18, "radius": 5.2 * _rsf, "distances": _distances},
        "spoke_5": {"angle": 54, "radius": 4.6 * _rsf, "distances": _distances},
        "spoke_6": {"angle": 90, "radius": 3.9 * _rsf, "distances": _distances},
        "spoke_7": {"angle": 126, "radius": 3.3 * _rsf, "distances": _distances},
        "spoke_8": {"angle": 162, "radius": 2.7 * _rsf, "distances": _distances},
        "spoke_9": {"angle": 198, "radius": 2.1 * _rsf, "distances": _distances},
        "spoke_10": {"angle": 234, "radius": 1.5 * _rsf, "distances": _distances},
    }
    _bg_distances = [0, 20, 32]
    _bg_roi_radius = 2.5
    background_roi_settings = _build_mr_lc_background_settings()

    def __init__(self, catphan, contrast_method: str, tolerance: float, offset: int,
                 spoke_start_angle: float, visibility_sanity_multiplier: float):
        self.contrast_method = contrast_method
        self._spoke_start_angle = spoke_start_angle
        self.visibility_sanity_multiplier = visibility_sanity_multiplier
        super().__init__(catphan, tolerance, offset)

    @property
    def window_min(self) -> int:
        return int(self.low_contrast_region.min)

    @property
    def window_max(self) -> int:
        return int(self.low_contrast_region.max)

    def _convert_units_in_settings(self) -> None:
        super()._convert_units_in_settings()
        for settings in (self.roi_settings, self.background_roi_settings):
            for setting in settings.values():
                setting["distances_pixels"] = [
                    d * self.scaling_factor / self.mm_per_pixel for d in setting["distances"]]

    def _setup_rois(self) -> None:
        """The low-contrast region, then three disks on each spoke."""
        self.common_name = f"Low Contrast - {self.slice_num + 1}"
        self.rois = {}
        self.background_rois = {}
        rad_pix = self.low_contrast_region_radius / self.mm_per_pixel
        nominal_area = rad_pix * rad_pix * np.pi
        # the LC region is the hole in the edge map: label the inverse of
        # the edge mask and take the region closest to the nominal area
        edge_mask = self._edge_mask()
        K = 64
        inv = tlabel.keep_largest(~edge_mask, K=K)
        regions = tlabel.regionprops(inv, K=K + 16, connectivity=1, hull=False)
        views = valid_region_views(regions)
        if not views:
            raise ValueError("Unable to find the Low Contrast region.")
        lc_region = min(views, key=lambda x: abs(x.area - nominal_area))
        if abs(lc_region.area / nominal_area - 1) >= 0.3:
            raise ValueError("Unable to find the Low Contrast region.")
        lc_center = Point(lc_region.centroid[1], lc_region.centroid[0])
        self.low_contrast_region = DiskROI(self.image, rad_pix, lc_center)

        for spoke_name in self.roi_settings:
            lc_rois, bg_rois = [], []
            for idx in range(len(self.roi_settings[spoke_name]["distances_pixels"])):
                bg_setting = self.background_roi_settings[spoke_name]
                bg_roi = LowContrastDiskROI.from_phantom_center(
                    self.image, bg_setting["angle_corrected"] + self._spoke_start_angle,
                    bg_setting["radius_pixels"], bg_setting["distances_pixels"][idx],
                    lc_center)
                bg_rois.append(bg_roi)
                lc_setting = self.roi_settings[spoke_name]
                lc_roi = LowContrastDiskROI.from_phantom_center(
                    self.image, lc_setting["angle_corrected"] + self._spoke_start_angle,
                    max(lc_setting["radius_pixels"], 1), lc_setting["distances_pixels"][idx],
                    lc_center, contrast_reference=bg_roi.mean,
                    contrast_method=self.contrast_method, visibility_threshold=self.tolerance)
                lc_rois.append(lc_roi)
            self.rois[spoke_name] = lc_rois
            self.background_rois[spoke_name] = bg_rois

    def _edge_mask(self) -> torch.Tensor:
        """The slice's edge mask on the analysis device: Scharr, a sigma-1
        Gaussian, Otsu x 0.8."""
        dev = torch.as_tensor(self.image.array.astype(np.float32), device=self.device)
        # JAX's two jitted graphs' sums (ops/filters docstring)
        edges = gaussian_filter(scharr(dev), 1.0)
        thres = otsu_threshold(edges) * 0.8
        return edges > thres

    @property
    def score(self) -> int:
        """The complete spokes (all three disks visible), up to the first
        incomplete one."""
        spoke1 = self.rois[list(self.roi_settings.keys())[0]]
        max_visibility = max(r.visibility for r in spoke1)
        sanity_visibility = max_visibility * self.visibility_sanity_multiplier
        is_visible = [all(self.roi_is_visible(r, sanity_visibility) for r in s)
                      for s in self.rois.values()]
        return len(is_visible) if all(is_visible) else int(np.argmin(is_visible))

    @staticmethod
    def roi_is_visible(roi: LowContrastDiskROI, sanity_visibility: float) -> bool:
        return roi.passed_visibility and roi.visibility < sanity_visibility

    def as_dict(self) -> dict:
        return {spoke_name: [roi.as_dict() for roi in spoke_rois]
                for spoke_name, spoke_rois in self.rois.items()}

    def plot_rois(self, axis) -> None:
        spoke1 = self.rois[list(self.roi_settings.keys())[0]]
        max_visibility = max(r.visibility for r in spoke1)
        sanity_visibility = max_visibility * self.visibility_sanity_multiplier
        self.low_contrast_region.plot2axes(axis, edgecolor="blue")
        for spoke in self.rois.values():
            for roi in spoke:
                color = "green" if self.roi_is_visible(roi, sanity_visibility) else "red"
                roi.plot2axes(axis, edgecolor=color)
        for spoke in self.background_rois.values():
            for roi in spoke:
                roi.plot2axes(axis, edgecolor="blue")


@dataclasses.dataclass(kw_only=True)
class MRLowContrastModuleOutput(DataModel):
    offset: float
    slice_num: int
    spoke_settings: dict
    background_settings: dict
    score: int
    spokes: dict


class MRLowContrastMultiSliceModule:
    """Low contrast across slices 8-11."""

    roi_settings = {
        "slice_8": {"offset": MR_LOW_CONTRAST_MODULE_OFFSETS_MM[8], "spoke_start_angle": 0},
        "slice_9": {"offset": MR_LOW_CONTRAST_MODULE_OFFSETS_MM[9], "spoke_start_angle": 9},
        "slice_10": {"offset": MR_LOW_CONTRAST_MODULE_OFFSETS_MM[10], "spoke_start_angle": 18},
        "slice_11": {"offset": MR_LOW_CONTRAST_MODULE_OFFSETS_MM[11], "spoke_start_angle": 27},
    }

    def __init__(self, catphan, contrast_method: str, visibility_threshold: float,
                 visibility_sanity_multiplier: float):
        self.slices: dict[str, MRLowContrastModule] = {}
        for key, value in self.roi_settings.items():
            self.slices[key] = MRLowContrastModule(
                catphan=catphan, contrast_method=contrast_method,
                tolerance=visibility_threshold, offset=value["offset"],
                spoke_start_angle=value["spoke_start_angle"],
                visibility_sanity_multiplier=visibility_sanity_multiplier)

    @property
    def score(self) -> int:
        return sum(s.score for s in self.slices.values())


@dataclasses.dataclass(kw_only=True)
class MRLowContrastMultiSliceModuleOutput(DataModel):
    score: int
    low_contrast_rois: dict


class GeometricDistortionModule(CatPhanModule):
    """The phantom's width along four directions from FWHM profiles of the
    binarised, hole-filled slice."""

    common_name = "Geometric Distortion"

    def _setup_rois(self) -> None:
        px_to_cut_off = int(round(5 / self.mm_per_pixel))
        self.profiles = {}
        threshold = float(otsu_threshold(
            torch.as_tensor(self.image.array.astype(np.float32), device=self.device)))
        bin_image = _filled(self.image.array > threshold, self.device)
        # horizontal
        data = bin_image[int(self.phan_center.y), :]
        prof = FWXMProfile(values=fill_middle_zeros(data, cutoff_px=px_to_cut_off))
        line = Line(Point(prof.field_edge_idx(side="left"), self.phan_center.y),
                    Point(prof.field_edge_idx(side="right"), self.phan_center.y))
        self.profiles["horizontal"] = {
            "width (mm)": prof.field_width_px * self.mm_per_pixel, "line": line}
        # vertical
        data = bin_image[:, int(self.phan_center.x)]
        prof = FWXMProfile(values=fill_middle_zeros(data, cutoff_px=px_to_cut_off))
        line = Line(Point(self.phan_center.x, prof.field_edge_idx(side="left")),
                    Point(self.phan_center.x, prof.field_edge_idx(side="right")))
        self.profiles["vertical"] = {
            "width (mm)": prof.field_width_px * self.mm_per_pixel, "line": line}
        # diagonals: bilinear samples along the +-45 degree lines, the
        # coordinates float32 as JAX stages them, mirrored past the edges
        xs = np.arange(0, self.image.shape[1])
        binary = torch.from_numpy(bin_image.astype(np.float32))
        for name, slope in (("negative diagonal", 1), ("positive diagonal", -1)):
            b = self.phan_center.y - slope * self.phan_center.x
            ys = slope * xs + b
            coords = torch.from_numpy(np.stack([ys, xs]).astype(np.float32))
            samples = map_coordinates(binary, coords, mode="mirror").numpy()
            prof = FWXMProfile(values=fill_middle_zeros(samples, cutoff_px=px_to_cut_off))
            left_i = int(round(prof.field_edge_idx(side="left")))
            right_i = int(round(prof.field_edge_idx(side="right")))
            line = Line(Point(xs[left_i], ys[left_i]), Point(xs[right_i], ys[right_i]))
            # the diagonal's pixel spacing is the hypotenuse
            self.profiles[name] = {
                "width (mm)": prof.field_width_px * self.mm_per_pixel * math.sqrt(2),
                "line": line}

    def distances(self) -> dict:
        return {name: f"{p['width (mm)']:2.2f}mm" for name, p in self.profiles.items()}

    def plot_rois(self, axis):
        for profile_data in self.profiles.values():
            profile_data["line"].plot2axes(axis, width=2, color="blue")


@dataclasses.dataclass(kw_only=True)
class MRGeometricDistortionModuleOutput(DataModel):
    offset: int
    profiles: dict
    distances: dict


class SagittalLocalizationModule:
    """The phantom's length on the sagittal localiser at four columns."""

    common_name = "Sagittal Distortion"
    roi_settings: dict = {
        "ROI1": {"offset": -60},
        "ROI2": {"offset": -25},
        "ROI3": {"offset": 25},
        "ROI4": {"offset": 75},
    }  # mm left or right of the phantom's centroid
    window_min = None
    window_max = None

    def __init__(self, image, device=None):
        """``image``: the sagittal localiser, or None. Its holes are filled
        on ``device`` (``None`` means ``"cuda"``)."""
        self.rois = {}
        self.profiles = {}
        if image is None:
            return
        self.image = image
        threshold = round(threshold_li(image.array))
        bin_image = _filled(image.array > threshold,
                            resolve_device(device, "SagittalLocalizationModule"))
        centroid = np.argwhere(bin_image).mean(axis=0)
        pixel_size = 1 / image.dpmm
        for key, val in self.roi_settings.items():
            col = round(centroid[1] + val["offset"] * pixel_size)
            prof = FWXMProfile(values=bin_image[:, col])
            line = Line(Point(col, prof.field_edge_idx(side="left")),
                        Point(col, prof.field_edge_idx(side="right")))
            self.profiles[key] = {"width (mm)": prof.field_width_px * pixel_size, "line": line}
            self.rois[key] = line

    def distances(self) -> dict:
        return {name: f"{p['width (mm)']:2.2f}mm" for name, p in self.profiles.items()}

    def plot(self, axis):
        axis.imshow(self.image.array, cmap="gray", vmin=self.window_min, vmax=self.window_max)
        self.plot_rois(axis)
        axis.autoscale(tight=True)
        axis.set_title(self.common_name)
        axis.axis("off")

    def plot_rois(self, axis):
        for profile_data in self.profiles.values():
            profile_data["line"].plot2axes(axis, width=2, color="blue")


@dataclasses.dataclass(kw_only=True)
class MRSagittalLocalizationModuleOutput(DataModel):
    profiles: dict
    distances: dict


@dataclasses.dataclass(kw_only=True)
class ACRMRIResult(ResultBase):
    phantom_model: str
    phantom_roll_deg: float
    origin_slice: int
    num_images: int
    slice1: MRSlice1ModuleOutput
    slice11: MRSlice11ModuleOutput
    uniformity_module: MRUniformityModuleOutput
    geometric_distortion_module: MRGeometricDistortionModuleOutput
    sagittal_localizer_module: MRSagittalLocalizationModuleOutput
    low_contrast_multi_slice_module: MRLowContrastMultiSliceModuleOutput


@capture_warnings
class ACRMRILarge(CatPhanBase):
    """ACR MRI Large phantom analysis."""

    _model = "ACR MRI Large"
    catphan_radius_mm = 100
    min_num_images = 4
    air_bubble_radius_mm = 20
    slice1 = MRSlice1Module
    geometric_distortion = GeometricDistortionModule
    uniformity_module = MRUniformityModule
    slice11 = MRSlice11PositionModule
    sagittal_localization = SagittalLocalizationModule
    low_contrast_multi_slice = MRLowContrastMultiSliceModule
    has_sagittal_module: bool = False
    clip_in_localization = False

    def plot_analyzed_subimage(self, *args, **kwargs):
        raise NotImplementedError("Use `plot_images`")

    def save_analyzed_subimage(self, *args, **kwargs):
        raise NotImplementedError("Use `save_images`")

    def localize(self) -> None:
        """Slice 1 is the first image: only the axis and the roll are found."""
        if getattr(self, "_slice_centroids", None) is None:
            self._slice_centroids = self._batched_phantom_centroids()
        self._phantom_center_func = self.find_phantom_axis()
        self.catphan_roll = self.find_phantom_roll() + self.angle_adjustment
        if not self._ensure_physical_scan_extent():
            raise ValueError(
                "The physical scan extent does not cover the extent of module "
                "configuration. This means not all modules were included in "
                "the scan. Rescan the phantom to include all relevant "
                "modules, or change the offset values.")

    def _module_offsets(self) -> list[float]:
        absolute_origin_position = self.dicom_stack[self.origin_slice].z_position
        relative = [0, MR_GEOMETRIC_DISTORTION_MODULE_OFFSET_MM,
                    MR_UNIFORMITY_MODULE_OFFSET_MM, MR_SLICE11_MODULE_OFFSET_MM]
        relative.extend(MR_LOW_CONTRAST_MODULE_OFFSETS_MM.values())
        return [absolute_origin_position + offset for offset in relative]

    def find_phantom_roll(self) -> float:
        """The roll from slice 1's top-left 20 mm circular hole (at -135
        degrees)."""
        slc = Slice(self, self.origin_slice)
        _, regions, _ = get_regions(slc)
        try:
            circle_bubbles = [r for r in regions
                              if self._is_right_area(r) and self._is_right_eccentricity(r)]
            exact_size = np.pi * ((self.air_bubble_radius_mm / self.mm_per_pixel) ** 2)
            most_similar = sorted(circle_bubbles,
                                  key=lambda r: abs(r.area_filled - exact_size))[0]
            y_dist = most_similar.centroid[0] - slc.phan_center.y
            x_dist = most_similar.centroid[1] - slc.phan_center.x
            return float(np.rad2deg(np.arctan2(y_dist, x_dist)) + 135)
        except Exception:
            raise RuntimeError(
                "Could not determine the roll of the phantom. Ensure the "
                "20mm top-left circle is visible on Slice 1")

    def analyze(self, echo_number: int | None = None, x_adjustment: float = 0,
                y_adjustment: float = 0, angle_adjustment: float = 0,
                roi_size_factor: float = 1, scaling_factor: float = 1,
                low_contrast_method: str = Contrast.WEBER,
                low_contrast_visibility_threshold: float = 0.001,
                low_contrast_visibility_sanity_multiplier: float = 3, device=None) -> None:
        """Full analysis on ``device`` (``None`` means ``"cuda"``, and raises
        when no CUDA device exists)."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self.roll_slice_offset = 0
        self._select_echo_images(echo_number)
        sagittal_image = self._select_sagittal_image()
        self.has_sagittal_module = sagittal_image is not None
        self.localize()
        cls = type(self)
        self.slice1 = cls.slice1(self, offset=0)
        self.geometric_distortion = cls.geometric_distortion(
            self, offset=MR_GEOMETRIC_DISTORTION_MODULE_OFFSET_MM)
        self.uniformity_module = cls.uniformity_module(self, offset=MR_UNIFORMITY_MODULE_OFFSET_MM)
        self.slice11 = cls.slice11(self, offset=MR_SLICE11_MODULE_OFFSET_MM)
        self.sagittal_localization = cls.sagittal_localization(sagittal_image,
                                                               device=self._device)
        self.low_contrast_multi_slice = cls.low_contrast_multi_slice(
            self, contrast_method=low_contrast_method,
            visibility_threshold=low_contrast_visibility_threshold,
            visibility_sanity_multiplier=low_contrast_visibility_sanity_multiplier)

    def _select_echo_images(self, echo_number: int | None) -> None:
        """Keep only the images of one echo (the lowest by default)."""
        try:
            all_echos = {int(i.metadata.EchoNumbers) for i in self.dicom_stack}
        except AttributeError:
            return
        if echo_number is None:
            echo_number = min(all_echos)
            if len(all_echos) > 1:
                warnings.warn(
                    f"Multiple echoes found ({all_echos}) and no echo number "
                    f"was passed. Using echo # {echo_number}")
        if echo_number not in all_echos:
            raise ValueError(
                f"Echo number {echo_number} was passed but not found in the "
                f"dataset. Found echo numbers: {all_echos}. Remove the "
                "echo_number parameter or pick a valid echo number.")
        to_pop = [idx for idx, img in enumerate(list(self.dicom_stack))
                  if int(img.metadata.EchoNumbers) != echo_number]
        for idx in sorted(to_pop, reverse=True):
            del self.dicom_stack[idx]

    def _select_sagittal_image(self, max_dist: float = 0.01):
        """Take the sagittal image, if there is one, out of the stack and
        return it."""
        nominal = np.array([0, 1, 0, 0, 0, -1])
        metadatas = self.dicom_stack.metadatas
        try:
            orientation = [m.ImageOrientationPatient for m in metadatas]
        except AttributeError:
            return None
        dist = np.linalg.norm(np.array(orientation, dtype=float) - nominal, axis=1)
        if np.sum(dist < max_dist) > 1:
            raise ValueError("There are too many sagittal images in the dataset.")
        if dist.min() >= max_dist:
            return None
        min_index = int(dist.argmin())
        image = self.dicom_stack[min_index]
        del self.dicom_stack[min_index]
        return image

    def results(self, as_str: bool = True) -> str | tuple:
        string = (
            f" - {self._model} Results - ",
            f"Geometric Distortions: {self.geometric_distortion.distances()}",
            f"Slice Thickness: {self.slice1.measured_slice_thickness_mm:2.2f}mm",
            f"Slice 1 S/I Position shift: {self.slice1.slice_shift_mm:2.2f}mm",
            f"Slice 11 S/I Position shift: {self.slice11.slice_shift_mm:2.2f}mm",
            f"Uniformity PIU: {self.uniformity_module.percent_image_uniformity:2.2f}",
            f"Percent-signal ghosting: {self.uniformity_module.psg:2.2f}%",
            f"Uniformity Center ROI standard deviation: "
            f"{self.uniformity_module.rois['Center'].std:2.2f}",
            f"Row-wise MTF 50% (lp/mm): {self.slice1.row_mtf.relative_resolution(50):2.2f}",
            f"Column-wise MTF 50% (lp/mm): {self.slice1.col_mtf.relative_resolution(50):2.2f}",
            f"Sagittal Distortions: {self.sagittal_localization.distances()}",
            f"Low Contrast Score: {self.low_contrast_multi_slice.score}",
        )
        return "\n".join(string) if as_str else string

    def _detected_modules(self):
        return [self.slice1, self.slice11, self.uniformity_module, self.geometric_distortion]

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs):
        import matplotlib.pyplot as plt

        modules = [self.slice1, self.geometric_distortion, self.uniformity_module, self.slice11]
        modules.extend(self.low_contrast_multi_slice.slices.values())
        if self.has_sagittal_module:
            modules.append(self.sagittal_localization)
        fig, axs = plt.subplots(3, 4, **plt_kwargs)
        axes = axs.ravel()
        for ax, module in zip(axes, modules):
            module.plot(ax)
        ax_idx = len(modules)
        self.plot_side_view(axes[ax_idx])
        ax_idx += 1
        self.slice1.row_mtf.plot(axes[ax_idx], label="Row-wise rMTF")
        self.slice1.col_mtf.plot(axes[ax_idx], label="Column-wise rMTF")
        axes[ax_idx].legend()
        for i in range(ax_idx + 1, len(axes)):
            axes[i].set_visible(False)
        plt.tight_layout()
        if show:
            plt.show()
        return fig

    def plot_images(self, show: bool = True, **plt_kwargs) -> dict:
        """A figure per module (the sagittal one where present), the rMTFs
        and the side view: ``{name: Figure}``."""
        import matplotlib.pyplot as plt

        figs = {}
        modules = {"geometric": self.geometric_distortion,
                   "slice 1": self.slice1,
                   "signal uniformity": self.uniformity_module,
                   "slice 11": self.slice11}
        modules |= self.low_contrast_multi_slice.slices
        if self.has_sagittal_module:
            modules["sagittal"] = self.sagittal_localization
        for key, module in modules.items():
            fig, ax = plt.subplots(**plt_kwargs)
            module.plot(ax)
            figs[key] = fig
        fig, ax = plt.subplots(**plt_kwargs)
        self.slice1.row_mtf.plot(ax, label="Row-wise rMTF")
        self.slice1.col_mtf.plot(ax, label="Column-wise rMTF")
        ax.legend()
        figs["rMTF"] = fig
        fig, ax = plt.subplots(**plt_kwargs)
        figs["side"] = fig
        self.plot_side_view(ax)
        if show:
            plt.show()
        return figs

    def save_images(self, directory=None, to_stream: bool = False, **plt_kwargs) -> list:
        """:meth:`plot_images` as PNG files in ``directory`` or as streams."""
        return save_figures(self.plot_images(show=False, **plt_kwargs), directory, to_stream)

    def publish_pdf(self, filename, notes: str | None = None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The results and a page per module image; the images need
        matplotlib."""
        images = self.save_images(to_stream=True)
        publish_images_pdf(filename, f"{self._model} Analysis",
                           wrapped(self.results(as_str=False)), (1.5, 25), images,
                           notes, open_file, metadata, logo)

    def _generate_results_data(self) -> ACRMRIResult:
        resolutions = range(10, 91, 10)
        row_mtfs = {r: self.slice1.row_mtf.relative_resolution(r) for r in resolutions}
        col_mtfs = {r: self.slice1.col_mtf.relative_resolution(r) for r in resolutions}
        low_contrast_rois = {
            k: MRLowContrastModuleOutput(
                offset=MR_LOW_CONTRAST_MODULE_OFFSETS_MM[v.slice_num + 1],
                slice_num=v.slice_num + 1, spoke_settings=v.roi_settings,
                background_settings=v.background_roi_settings, score=v.score,
                spokes=v.as_dict())
            for k, v in self.low_contrast_multi_slice.slices.items()}
        # lines are not JSON: the outputs keep the widths only
        geo_profiles = {name: {"width (mm)": p["width (mm)"]}
                        for name, p in self.geometric_distortion.profiles.items()}
        sag_profiles = {name: {"width (mm)": p["width (mm)"]}
                        for name, p in self.sagittal_localization.profiles.items()}
        uniformity = self.uniformity_module
        return ACRMRIResult(
            phantom_model=self._model,
            phantom_roll_deg=self.catphan_roll,
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            slice1=MRSlice1ModuleOutput(
                offset=0, roi_settings=self.slice1.roi_settings,
                rois=rois_to_results(self.slice1.rois),
                bar_difference_mm=self.slice1.bar_difference_mm,
                slice_shift_mm=self.slice1.slice_shift_mm,
                measured_slice_thickness_mm=self.slice1.measured_slice_thickness_mm,
                row_mtf_50=self.slice1.row_mtf.relative_resolution(50),
                col_mtf_50=self.slice1.col_mtf.relative_resolution(50),
                row_mtf_lp_mm=row_mtfs, col_mtf_lp_mm=col_mtfs),
            slice11=MRSlice11ModuleOutput(
                offset=MR_SLICE11_MODULE_OFFSET_MM,
                bar_difference_mm=self.slice11.bar_difference_mm,
                slice_shift_mm=self.slice11.slice_shift_mm,
                rois=rois_to_results(self.slice11.rois),
                roi_settings=self.slice11.roi_settings),
            geometric_distortion_module=MRGeometricDistortionModuleOutput(
                offset=MR_GEOMETRIC_DISTORTION_MODULE_OFFSET_MM, profiles=geo_profiles,
                distances=self.geometric_distortion.distances()),
            uniformity_module=MRUniformityModuleOutput(
                offset=0, roi_settings=uniformity.roi_settings,
                rois=rois_to_results(uniformity.rois),
                ghost_roi_settings=uniformity.ghost_roi_settings,
                ghost_rois=rois_to_results(uniformity.ghost_rois),
                psg=uniformity.psg, ghosting_ratio=uniformity.ghosting_ratio,
                piu=uniformity.percent_image_uniformity, piu_passed=uniformity.piu_passed),
            sagittal_localizer_module=MRSagittalLocalizationModuleOutput(
                profiles=sag_profiles, distances=self.sagittal_localization.distances()),
            low_contrast_multi_slice_module=MRLowContrastMultiSliceModuleOutput(
                score=self.low_contrast_multi_slice.score,
                low_contrast_rois=low_contrast_rois))
