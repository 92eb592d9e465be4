"""CatPhan CT/CBCT QA: CatPhan 503, 504, 600, 604 and 700, single scan and
batched.

Port of ``pylinac_tpu/ct.py``: the result models (``:70-123``) as
dataclasses, ``SpatialResolutionROI`` ``:129``, ``HUDiskROI`` ``:135``,
``ThicknessROI`` ``:161``, the region
finders ``get_regions`` ``:289`` and ``get_regions_batch`` ``:376`` (the
device route, ``_regions_fused`` ``:275`` and ``_regions_fused_batch``
``:344``), ``_stack_phantom_regions`` ``:471``, ``Slice`` ``:530``, the
modules (``CatPhanModule`` ``:606`` to ``CTP515CP700`` ``:1325``, with
CatPhan700's ``CTP404CP700`` ``:951`` and bar-pattern ``CTP528CP700``
``:1178``), ``CatPhanBase`` ``:1332`` (folders and zips, eager or lazy
stacks) and the models (``CatPhan700`` ``:2113``), and ``CatPhanBatch``
``:2129``.

Localisation runs on the device given to ``analyze``: the whole stack is
staged once per scan and cached, then pooled, clipped, Scharr-filtered,
blurred, thresholded (Otsu) and labelled in one batched pass, whose
connected components come from the hand-written CUDA kernel
(:mod:`pylinac_tpu_torch.ops.ccl`) in label and hole-root modes. The roll
bubbles and the geometry nodes take the same mask stage and kernel, batched
across the scans of a :class:`CatPhanBatch` or one slice at a time (B = 1)
for a single scan. The module stage (HU disks, wire ramps, MTF profile, NPS,
low-contrast disks) stays numpy on the host, as in the JAX package.

The 25 :mod:`.profiling` stages of the JAX module sit at the same places
(``localize``, ``ctp404`` ... ``ctp528.mtf_batch``); they cost nothing
outside ``profiling.collect()``.

The models carry ``capture_warnings`` as in the JAX package, which wraps
only the methods of a class's own body; ``analyze`` is ``CatPhanBase``'s,
so ``results_data().warnings`` stays empty, as JAX's does.

``CatPhanBatch.analyze(mesh=...)`` shards the localisation pass over a
:class:`~pylinac_tpu_torch.parallel.mesh.Mesh`. The reports
(``:1858-2011``, with the modules' drawing ``:131-180``, ``:698-709``,
``:874-905``, ``:1002``, ``:1132`` and ``plot_side_view`` ``:1552``):
``publish_pdf`` through :mod:`.core.pdf`, ``to_quaac`` and
``plotly_analyzed_images`` need no matplotlib; the matplotlib plots import
it inside, and raise ``ModuleNotFoundError`` where it is missing.

Not ported: demo and URL loading and the host C++ CCL route
(``label_native``).
"""

from __future__ import annotations

import copy
import dataclasses
import os.path as osp
import textwrap
import warnings
from functools import cached_property
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import profiling
from .core import image
from .core.contrast import Contrast
from .core.geometry import Line, Point
from .core.image import z_position
from .core.mtf import MTF
from .core.profile import CollapsedCircleProfile, FWXMProfile
from .core.roi import DiskROI, LowContrastDiskROI, RectangleROI
from .core.utilities import (DataModel, QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin,
                              resolve_device)
from .core.warnings import capture_warnings
from .metrics.utils import RegionView
from .ops import label as tlabel
from .ops.filters import gaussian_filter, scharr
from .ops.peaks import find_peaks_rows
from .ops.stats import nps_bundle
from .ops.threshold import otsu_threshold_batch

# ramp angle correction: the wire is at 23 degrees, which lengthens its
# projection (CatPhan manual, "Scan slice geometry")
RAMP_ANGLE_RATIO = 0.42

# nominal HU values (midpoints of the manual's ranges)
AIR = -1000
LUNG_7112 = -868
PMP = -196
LDPE = -104
POLY = -47
WATER = 0
ACRYLIC = 115
BONE_20 = 237
DELRIN = 365
BONE_50 = 725
TEFLON = 1000


# --------------------------------------------------------------------------
# Result models
# --------------------------------------------------------------------------
@dataclasses.dataclass(kw_only=True)
class ROIResult(DataModel):
    name: str
    value: float
    stdev: float
    difference: float | None
    nominal_value: float | None
    passed: bool | None


@dataclasses.dataclass(kw_only=True)
class CTP404Result(DataModel):
    offset: int
    low_contrast_visibility: float
    thickness_passed: bool
    measured_slice_thickness_mm: float
    thickness_num_slices_combined: int
    geometry_passed: bool
    avg_line_distance_mm: float
    line_distances_mm: list[float]
    hu_linearity_passed: bool
    hu_tolerance: float
    hu_rois: dict[str, ROIResult]


@dataclasses.dataclass(kw_only=True)
class CTP486Result(DataModel):
    uniformity_index: float
    integral_non_uniformity: float
    nps_avg_power: float
    nps_max_freq: float
    passed: bool
    rois: dict[str, ROIResult]


@dataclasses.dataclass(kw_only=True)
class CTP515Result(DataModel):
    cnr_threshold: float
    num_rois_seen: int
    roi_settings: dict
    roi_results: dict


@dataclasses.dataclass(kw_only=True)
class CTP528Result(DataModel):
    start_angle_radians: float | None
    mtf_lp_mm: dict
    roi_settings: dict[str, dict]


@dataclasses.dataclass(kw_only=True)
class CatphanResult(ResultBase):
    catphan_model: str
    catphan_roll_deg: float
    origin_slice: int
    num_images: int
    ctp404: CTP404Result
    ctp486: CTP486Result | None = None
    ctp528: CTP528Result | None = None
    ctp515: CTP515Result | None = None


# --------------------------------------------------------------------------
# ROI flavours
# --------------------------------------------------------------------------
class SpatialResolutionROI(RectangleROI):
    """A (rotated) rectangle over one bar group of the CatPhan 700's
    spatial-resolution module."""

    @property
    def plot_color(self):
        return "blue"


class HUDiskROI(DiskROI):
    """A disk ROI with a nominal HU value and tolerance. ``background_mean``
    and ``background_std`` are accepted and unused, as in the JAX package."""

    def __init__(self, array, angle, roi_radius, dist_from_center, phantom_center,
                 nominal_value=None, tolerance=None, background_mean=None,
                 background_std=None):
        new_center = self._get_shifted_center(angle, dist_from_center, phantom_center)
        super().__init__(array, roi_radius, new_center)
        self.nominal_val = nominal_value
        self.tolerance = tolerance

    @property
    def value_diff(self) -> float:
        return self.pixel_value - self.nominal_val

    @property
    def passed(self) -> bool:
        if self.tolerance:
            return abs(self.value_diff) <= self.tolerance
        return True

    @property
    def plot_color(self) -> str:
        return "green" if self.passed else "red"


class ThicknessROI(RectangleROI):
    """A rectangle ROI over an angled wire ramp, for slice thickness."""

    @cached_property
    def long_profile(self) -> FWXMProfile:
        # a small host array: the blur runs on the CPU
        with profiling.stage("ctp404.thickness_profile"):
            arr = gaussian_filter(
                torch.from_numpy(np.array(self.pixel_array, dtype=np.float32)), 1.0).numpy()
            return FWXMProfile(values=arr.max(axis=int(np.argmin(arr.shape))))

    @cached_property
    def wire_fwhm(self) -> float:
        return self.long_profile.field_width_px

    @property
    def plot_color(self) -> str:
        return "blue"


# --------------------------------------------------------------------------
# Region finding on the device
# --------------------------------------------------------------------------
def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _mask_batch(arrs: torch.Tensor, centers_yx: tuple[float, float] | None,
                radius: float, use_otsu: bool, scale08: bool):
    """The mask stage shared by every region finder (``_edges_and_mask``,
    ``ct.py:199``): Scharr edges blurred with a sigma-1 Gaussian, thresholded
    per image by Otsu or the mean, within a disk when ``centers_yx`` is
    given, times 0.8 when ``scale08``. Returns (masks, edges), (B, H, W)."""
    b, h, w = arrs.shape
    dev = arrs.device
    # the sums as the vmapped JAX graphs give them (ops/filters docstring)
    edges = gaussian_filter(scharr(arrs.to(torch.float32)), 1.0, dims=(-2, -1))
    if centers_yx is not None:
        cy, cx = _f32(centers_yx[0], dev), _f32(centers_yx[1], dev)
        r = _f32(radius, dev)
        yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        if use_otsu:
            thres = otsu_threshold_batch(edges, mask=disk)
        else:
            thres = (torch.where(disk, edges, 0.0).sum(dim=(1, 2))
                     / disk.sum().clamp(min=1))
    else:
        thres = otsu_threshold_batch(edges) if use_otsu else edges.mean(dim=(1, 2))
    if scale08:
        thres = thres * 0.8
    return edges > thres[:, None, None], edges


def _views(host: tlabel.Regions, keep: np.ndarray) -> list[RegionView]:
    return [RegionView(host, i) for i in np.nonzero(keep)[0]]


def get_regions(slice_or_arr, clear_borders: bool = True, threshold: str = "otsu",
                minmax: bool = True, device=None):
    """Scharr edges, threshold, then labelled region properties of one
    slice or array on ``device`` (the slice's own device for a
    :class:`Slice`). The K slots grow 4x while they are full, up to 512.

    Returns (None, region views, number of regions), as the JAX function;
    its ``fill_holes``, which changes nothing there, is not ported."""
    if isinstance(slice_or_arr, Slice):
        arr = slice_or_arr.image.array
        center = slice_or_arr.image.center
        centers_yx = (float(center.y), float(center.x))
        radius = 110 / slice_or_arr.mm_per_pixel
        scale08 = True
        device = slice_or_arr.device
    else:
        arr = np.asarray(slice_or_arr)
        centers_yx = None
        radius = 0.0
        scale08 = False
    dev = torch.as_tensor(np.asarray(arr, np.float32), device=device)[None]
    bw, edges = _mask_batch(dev, centers_yx, radius, threshold == "otsu", scale08)
    K = 32
    while True:
        host = tlabel.regionprops(bw[0], edges[0], K=K, connectivity=2, hull=False,
                                  minmax=minmax).to_numpy()
        if host.valid.sum() < K or K >= 512:
            break
        K *= 4
    views = _views(host, host.valid & ~host.touches_border if clear_borders else host.valid)
    return None, views, len(views)


def get_regions_batch(arrs: list[np.ndarray], centers_yx: tuple[float, float] | None,
                      radius: float, threshold: str = "otsu", scale08: bool = False,
                      clear_borders: bool = True, minmax: bool = True,
                      device=None) -> list[list[RegionView]] | None:
    """:func:`get_regions` of same-shape arrays in one batched pass on
    ``device``; ``centers_yx`` turns on the disk-masked threshold of the
    :class:`Slice` branch. Returns one list of region views per array, or
    None when any array's regions fill the K = 32 slots (the caller then
    takes the per-array path, which grows K)."""
    dev = torch.as_tensor(np.stack(arrs).astype(np.float32), device=device)
    K = 32
    bw, edges = _mask_batch(dev, centers_yx, radius, threshold == "otsu", scale08)
    host = tlabel.regionprops_batch(bw, edges, K=K, connectivity=2, hull=False,
                                    minmax=minmax).to_numpy()
    out = []
    for i in range(len(arrs)):
        valid = host.valid[i]
        if valid.sum() >= K:
            return None
        row = tlabel.Regions(*[f[i] for f in host])
        out.append(_views(row, valid & ~row.touches_border if clear_borders else valid))
    return out


def _stack_phantom_regions(raw_vol: torch.Tensor, K: int, clear_borders: bool,
                           ds: int, clip: bool) -> tuple[tlabel.Regions, torch.Tensor]:
    """Whole-stack localisation on the volume's device: ``ds`` x ``ds``
    mean-pool, clip to +-1000 HU, Scharr, Gaussian, Otsu, then batched
    region properties. Returns ((N, K) regions, per-slice maximum of the
    pooled unclipped Scharr edges)."""
    n, h, w = raw_vol.shape
    if ds > 1:
        vol = raw_vol.reshape(n, h // ds, ds, w // ds, ds).mean(dim=(2, 4))
    else:
        vol = raw_vol
    clipped = vol.clamp(-1000, 1000) if clip else vol
    bw, edges = _mask_batch(clipped, None, 0.0, use_otsu=True, scale08=False)
    # CT reads neither solidity nor the bbox and min/max intensities
    regions = tlabel.regionprops_batch(bw, edges, K=K, connectivity=2, hull=False,
                                       minmax=False)
    if clear_borders:
        regions = tlabel.clear_border(regions)
    return regions, scharr(vol).amax(dim=(1, 2))


def combine_surrounding_slices(dicomstack, nominal_slice_num: int,
                               slices_plusminus: int = 1, mode: str = "mean") -> np.ndarray:
    """Combine a slice with its neighbours by mean, median or max."""
    slices = range(nominal_slice_num - slices_plusminus,
                   nominal_slice_num + slices_plusminus + 1)
    array_stack = np.dstack(tuple(dicomstack[s].array for s in slices))
    if mode == "mean":
        return np.mean(array_stack, 2)
    if mode == "median":
        return np.median(array_stack, 2)
    return np.max(array_stack, 2)


def rois_to_results(dict_mapping: dict[str, DiskROI]) -> dict[str, ROIResult]:
    return {
        name: ROIResult(
            name=name, value=roi.pixel_value, stdev=roi.std,
            difference=getattr(roi, "value_diff", None),
            nominal_value=getattr(roi, "nominal_val", None),
            passed=getattr(roi, "passed", None))
        for name, roi in dict_mapping.items()}


# --------------------------------------------------------------------------
# Slices and modules
# --------------------------------------------------------------------------
class Slice:
    """One analysed CT slice, optionally combined with its neighbours."""

    def __init__(self, catphan, slice_num: int | None = None, combine: bool = True,
                 combine_method: str = "mean", num_slices: int = 0,
                 clear_borders: bool = True, original_image=None):
        if slice_num is not None:
            self.slice_num = slice_num
        if combine and num_slices > 0:
            vol = getattr(catphan, "_host_vol", None)
            lo = self.slice_num - num_slices
            hi = self.slice_num + num_slices
            if vol is not None and lo >= 0 and hi < vol.shape[0]:
                # the same reduction over the cached float32 stack (exact for
                # integer-valued sources; float64 accumulation)
                seg = vol[lo:hi + 1]
                if combine_method == "mean":
                    array = seg.mean(axis=0, dtype=np.float64)
                elif combine_method == "median":
                    array = np.median(seg.astype(np.float64), axis=0)
                else:
                    array = seg.max(axis=0)
            else:
                array = combine_surrounding_slices(
                    catphan.dicom_stack, self.slice_num, mode=combine_method,
                    slices_plusminus=num_slices)
        elif original_image is not None:
            array = original_image
        else:
            array = catphan.dicom_stack[self.slice_num].array
        self.image = image.load(array if isinstance(array, np.ndarray) else array.array)
        self.catphan_size = catphan.catphan_size
        self.mm_per_pixel = catphan.mm_per_pixel
        self.clear_borders = clear_borders
        self.clip_in_localization = catphan.clip_in_localization
        self.device = catphan._device
        if catphan._phantom_center_func:
            self._phantom_center_func = catphan._phantom_center_func

    @cached_property
    def phantom_roi(self) -> RegionView:
        """The region matching the phantom's expected size."""
        dev = torch.as_tensor(np.asarray(self.image.array, np.float32), device=self.device)
        if float(scharr(dev).max()) < 0.1:
            raise ValueError("No edges were found in the image that look like the phantom")
        if self.clip_in_localization:
            clipped = np.clip(self.image.array, a_min=-1000, a_max=1000)
        else:
            clipped = self.image.array
        _, regions, num_roi = get_regions(
            clipped, threshold="otsu", clear_borders=self.clear_borders,
            device=self.device)
        if num_roi < 1:
            raise ValueError(f"The number of ROIs detected {num_roi} was not the number expected (1)")
        catphan_region = sorted(
            regions, key=lambda x: np.abs(x.filled_area - self.catphan_size))[0]
        if (self.catphan_size * 1.3 < catphan_region.filled_area
                or catphan_region.filled_area < self.catphan_size / 1.3):
            raise ValueError("Unable to find ROI of expected size of the phantom")
        return catphan_region

    def is_phantom_in_view(self) -> bool:
        try:
            self.phantom_roi
            return True
        except ValueError:
            return False

    @property
    def phan_center(self) -> Point:
        x = self._phantom_center_func[0](self.slice_num)
        y = self._phantom_center_func[1](self.slice_num)
        return Point(x=x, y=y)


class CatPhanModule(Slice):
    """Base of a CTP module: ROI settings in mm and degrees become pixel ROIs."""

    common_name: str = ""
    combine_method: str = "mean"
    num_slices: int = 0
    roi_settings: dict = {}
    background_roi_settings: dict = {}
    window_min = None
    window_max = None
    attr_name: str = ""

    def __init__(self, catphan, tolerance: float | None = None, offset: int = 0,
                 clear_borders: bool = True):
        self.model = ""
        self._offset = offset
        self.origin_slice = catphan.origin_slice
        self.tolerance = tolerance
        self.slice_thickness = catphan.dicom_stack.metadata.SliceThickness
        self.slice_spacing = catphan.dicom_stack.slice_spacing
        self.catphan_roll = catphan.catphan_roll
        self.roi_size_factor = catphan.roi_size_factor
        self.scaling_factor = catphan.scaling_factor
        self.roll_slice_offset = catphan.roll_slice_offset
        self.mm_per_pixel = catphan.mm_per_pixel
        self.rois: dict[str, HUDiskROI] = {}
        self.background_rois: dict[str, HUDiskROI] = {}
        # copy the class-level settings: unit conversion must not change
        # state shared between instances
        self.roi_settings = copy.deepcopy(self.roi_settings)
        self.background_roi_settings = copy.deepcopy(self.background_roi_settings)
        with profiling.stage(f"{self.attr_name}.combine"):
            Slice.__init__(self, catphan, combine_method=self.combine_method,
                           num_slices=self.num_slices, clear_borders=clear_borders)
        self._convert_units_in_settings()
        with profiling.stage(f"{self.attr_name}.preprocess"):
            self.preprocess(catphan)
        with profiling.stage(f"{self.attr_name}.rois"):
            self._setup_rois()

    def _convert_units_in_settings(self) -> None:
        setting_groups = [getattr(self, attr) for attr in dir(self)
                          if attr.endswith("roi_settings")]
        for roi_settings in setting_groups:
            for settings in roi_settings.values():
                if not isinstance(settings, dict):
                    continue
                for key in ("distance", "radial_distance", "transversal_distance"):
                    if settings.get(key) is not None:
                        settings[f"{key}_pixels"] = (
                            settings[key] * self.scaling_factor / self.mm_per_pixel)
                if settings.get("angle") is not None:
                    settings["angle_corrected"] = settings["angle"] + self.catphan_roll
                for key in ("radius", "width", "height"):
                    if settings.get(key) is not None:
                        settings[f"{key}_pixels"] = (
                            settings[key] * self.roi_size_factor / self.mm_per_pixel)

    def preprocess(self, catphan):
        pass

    @property
    def slice_num(self) -> int:
        return int(self.origin_slice + round(self._offset / self.slice_spacing))

    @slice_num.setter
    def slice_num(self, value):  # Slice.__init__ assigns it
        self.__dict__["slice_num"] = value

    def _setup_rois(self) -> None:
        for name, setting in self.background_roi_settings.items():
            self.background_rois[name] = HUDiskROI(
                self.image, setting["angle_corrected"], setting["radius_pixels"],
                setting["distance_pixels"], self.phan_center)
        for name, setting in self.roi_settings.items():
            self.rois[name] = HUDiskROI(
                self.image, setting["angle_corrected"], setting["radius_pixels"],
                setting["distance_pixels"], self.phan_center, setting.get("value", 0),
                self.tolerance)

    def plot_rois(self, axis) -> None:
        for roi in self.rois.values():
            roi.plot2axes(axis, edgecolor=roi.plot_color)
        for roi in self.background_rois.values():
            roi.plot2axes(axis, edgecolor="blue")

    def plot(self, axis):
        axis.imshow(self.image.array, cmap="gray", vmin=self.window_min, vmax=self.window_max)
        self.plot_rois(axis)
        axis.autoscale(tight=True)
        axis.set_title(f"{self.common_name} ({self.slice_num + 1})")
        axis.axis("off")

    @property
    def roi_vals_as_str(self) -> str:
        return ", ".join(f"{name}: {roi.pixel_value}" for name, roi in self.rois.items())


class CTP404CP504(CatPhanModule):
    """CTP404: HU linearity, slice thickness and geometry."""

    attr_name = "ctp404"
    common_name = "HU Linearity"
    roi_dist_mm = 58.7
    roi_radius_mm = 5
    roi_settings = {
        "Air": {"value": AIR, "angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "PMP": {"value": PMP, "angle": -120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "LDPE": {"value": LDPE, "angle": 180, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"value": POLY, "angle": 120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"value": ACRYLIC, "angle": 60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Delrin": {"value": DELRIN, "angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Teflon": {"value": TEFLON, "angle": -60, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    background_roi_settings = {
        "1": {"angle": -30, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "2": {"angle": -150, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "3": {"angle": -210, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "4": {"angle": 30, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    thickness_roi_height = 40
    thickness_roi_width = 10
    thickness_roi_distance_mm = 38
    thickness_roi_settings = {
        "Left": {"angle": 180, "width": thickness_roi_width, "height": thickness_roi_height, "distance": thickness_roi_distance_mm},
        "Bottom": {"angle": 90, "width": thickness_roi_height, "height": thickness_roi_width, "distance": thickness_roi_distance_mm},
        "Right": {"angle": 0, "width": thickness_roi_width, "height": thickness_roi_height, "distance": thickness_roi_distance_mm},
        "Top": {"angle": -90, "width": thickness_roi_height, "height": thickness_roi_width, "distance": thickness_roi_distance_mm},
    }
    geometry_roi_size_mm = 35
    geometry_roi_settings = {
        "Top-Horizontal": (0, 1),
        "Bottom-Horizontal": (2, 3),
        "Left-Vertical": (0, 2),
        "Right-Vertical": (1, 3),
    }

    def __init__(self, catphan, offset, hu_tolerance, thickness_tolerance,
                 scaling_tolerance, clear_borders: bool = True,
                 thickness_slice_straddle: str | int = "auto",
                 expected_hu_values: dict | None = None):
        self.mm_per_pixel = catphan.mm_per_pixel
        self.hu_tolerance = hu_tolerance
        self.thickness_tolerance = thickness_tolerance
        self.scaling_tolerance = scaling_tolerance
        self.thickness_rois: dict[str, ThicknessROI] = {}
        self.lines: dict[str, GeometricLine] = {}
        self.thickness_slice_straddle = thickness_slice_straddle
        self.expected_hu_values = expected_hu_values
        self.thickness_roi_settings = copy.deepcopy(self.thickness_roi_settings)
        super().__init__(catphan, tolerance=hu_tolerance, offset=offset,
                         clear_borders=clear_borders)

    def preprocess(self, catphan) -> None:
        self._defer_geometry = getattr(catphan, "_defer_geometry", False)
        if (isinstance(self.thickness_slice_straddle, str)
                and self.thickness_slice_straddle.lower() == "auto"):
            self.pad = 1 if float(catphan.dicom_stack.metadata.SliceThickness) < 3.5 else 0
        else:
            self.pad = self.thickness_slice_straddle
        self.thickness_image = Slice(
            catphan, combine_method="mean", num_slices=self.num_slices + self.pad,
            slice_num=self.slice_num, clear_borders=self.clear_borders).image

    def _setup_rois(self) -> None:
        if self.expected_hu_values is not None:
            for name, value in self.expected_hu_values.items():
                if name in self.roi_settings:
                    self.roi_settings[name]["value"] = value
        super()._setup_rois()
        self._setup_thickness_rois()
        if len(self.geometry_roi_settings) > 0:
            self._setup_geometry_rois()

    def _setup_thickness_rois(self) -> None:
        for name, setting in self.thickness_roi_settings.items():
            self.thickness_rois[name] = ThicknessROI.from_phantom_center(
                self.thickness_image, setting["width_pixels"],
                setting["height_pixels"], setting["angle_corrected"],
                setting["distance_pixels"], self.phan_center)

    def _geometry_crop(self) -> tuple[np.ndarray, tuple, tuple]:
        boxsize = self.geometry_roi_size_mm / self.mm_per_pixel
        xbounds = (int(self.phan_center.x - boxsize), int(self.phan_center.x + boxsize))
        ybounds = (int(self.phan_center.y - boxsize), int(self.phan_center.y + boxsize))
        geo_img = self.image[ybounds[0]:ybounds[1], xbounds[0]:xbounds[1]].copy()
        geo_img = geo_img - np.median(geo_img)
        nearest_extreme = min(abs(geo_img.max()), abs(geo_img.min()))
        geo_clipped_abs = np.abs(np.clip(geo_img, a_min=-nearest_extreme,
                                         a_max=nearest_extreme))
        return geo_clipped_abs, xbounds, ybounds

    def _setup_geometry_rois(self) -> None:
        geo_clipped_abs, xbounds, ybounds = self._geometry_crop()
        if self._defer_geometry:
            # CatPhanBatch finds every scan's nodes in one batched pass after
            # the per-scan walk
            self._deferred_geo = (geo_clipped_abs, xbounds, ybounds)
            return
        _, regions, num_roi = get_regions(geo_clipped_abs, clear_borders=False,
                                          device=self.device)
        self._finalize_geometry(regions, num_roi, xbounds, ybounds)

    def _finalize_geometry(self, regions, num_roi: int, xbounds, ybounds) -> None:
        if num_roi < 4:
            raise ValueError("Unable to locate the Geometric nodes")
        if num_roi > 4:
            regions = sorted(regions, key=lambda x: x.filled_area, reverse=True)[:4]
        sorted_regions = sorted(regions, key=lambda x: 2 * x.centroid[0] + x.centroid[1])
        centers = [Point(r.weighted_centroid[1] + xbounds[0],
                         r.weighted_centroid[0] + ybounds[0]) for r in sorted_regions]
        for name, order in self.geometry_roi_settings.items():
            self.lines[name] = GeometricLine(
                centers[order[0]], centers[order[1]], self.mm_per_pixel,
                self.scaling_tolerance)

    @property
    def lcv(self) -> float:
        """Low-contrast visibility."""
        return (2 * abs(self.rois["LDPE"].pixel_value - self.rois["Poly"].pixel_value)
                / (self.rois["LDPE"].std + self.rois["Poly"].std))

    @property
    def passed_hu(self) -> bool:
        return all(roi.passed for roi in self.rois.values())

    @property
    def passed_thickness(self) -> bool:
        return (self.slice_thickness - self.thickness_tolerance
                < self.meas_slice_thickness
                < self.slice_thickness + self.thickness_tolerance)

    @property
    def meas_slice_thickness(self) -> float:
        """Mean wire FWHM thickness, corrected for the ramp angle."""
        return np.mean(sorted(
            roi.wire_fwhm * self.mm_per_pixel * RAMP_ANGLE_RATIO
            for roi in self.thickness_rois.values())) / (1 + 2 * self.pad)

    @property
    def avg_line_length(self) -> float:
        return float(np.mean([line.length_mm for line in self.lines.values()]))

    @property
    def passed_geometry(self) -> bool:
        return all(line.passed for line in self.lines.values())

    def plot_linearity(self, axis=None, plot_delta: bool = True):
        import matplotlib.pyplot as plt

        nominal_x = [roi.nominal_val for roi in self.rois.values()]
        if axis is None:
            _, axis = plt.subplots()
        if plot_delta:
            values = [roi.value_diff for roi in self.rois.values()]
            nominal_measurements = [0] * len(values)
            ylabel = "HU Delta"
        else:
            values = [roi.pixel_value for roi in self.rois.values()]
            nominal_measurements = nominal_x
            ylabel = "Measured Values"
        points = axis.plot(nominal_x, values, "g+", markersize=15, mew=2)
        axis.plot(nominal_x, nominal_measurements)
        axis.plot(nominal_x, np.array(nominal_measurements) + self.hu_tolerance, "r--")
        axis.plot(nominal_x, np.array(nominal_measurements) - self.hu_tolerance, "r--")
        axis.margins(0.05)
        axis.grid(True)
        axis.set_xlabel("Nominal Values")
        axis.set_ylabel(ylabel)
        axis.set_title("HU linearity")
        return points

    def plot_rois(self, axis) -> None:
        super().plot_rois(axis)
        for roi in self.thickness_rois.values():
            roi.plot2axes(axis, edgecolor="blue")
        for line in self.lines.values():
            line.plot2axes(axis, color=line.pass_fail_color)


class CTP404CP503(CTP404CP504):
    """The CatPhan 503's CTP404 (the 504's)."""


class CTP404CP600(CTP404CP504):
    roi_dist_mm = 58.7
    roi_radius_mm = 5
    roi_settings = {
        "Air": {"value": AIR, "angle": 90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "PMP": {"value": PMP, "angle": 60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "LDPE": {"value": LDPE, "angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"value": POLY, "angle": -60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"value": ACRYLIC, "angle": -120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Delrin": {"value": DELRIN, "angle": -180, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Teflon": {"value": TEFLON, "angle": 120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Vial": {"value": WATER, "angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }

    def _setup_rois(self) -> None:
        super()._setup_rois()
        if self.rois["Vial"].pixel_value < -500:  # no vial: closer to air
            self.rois.pop("Vial")


class CTP404CP604(CTP404CP504):
    roi_dist_mm = 58.7
    roi_radius_mm = 5
    roi_settings = {
        "Air": {"value": AIR, "angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "PMP": {"value": PMP, "angle": -120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "50% Bone": {"value": BONE_50, "angle": -150, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "LDPE": {"value": LDPE, "angle": 180, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"value": POLY, "angle": 120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"value": ACRYLIC, "angle": 60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "20% Bone": {"value": BONE_20, "angle": 30, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Delrin": {"value": DELRIN, "angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Teflon": {"value": TEFLON, "angle": -60, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    background_roi_settings = {
        "1": {"angle": -30, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "2": {"angle": -210, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }


class CTP404CP700(CTP404CP504):
    """The CatPhan 700's HU module (CTP682): eleven plugs."""

    roi_dist_mm = 58.7
    roi_radius_mm = 5
    roi_settings = {
        "Air": {"value": AIR, "angle": 180 - -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "PMP": {"value": PMP, "angle": 180 - -120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Lung": {"value": LUNG_7112, "angle": 180 - -165, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Delrin": {"value": DELRIN, "angle": 180 - 165, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"value": POLY, "angle": 180 - 120, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Teflon": {"value": TEFLON, "angle": 180 - 90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Bone 20%": {"value": BONE_20, "angle": 180 - 60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "LDPE": {"value": LDPE, "angle": 180 - 15, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Bone 50%": {"value": BONE_50, "angle": 180 - -15, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"value": ACRYLIC, "angle": 180 - -60, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Vial": {"value": WATER, "angle": 180 - -135, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }
    background_roi_settings = {
        "1": {"angle": -37.5, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "2": {"angle": -142.5, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "3": {"angle": 142.5, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "4": {"angle": 37.5, "distance": roi_dist_mm, "radius": roi_radius_mm},
    }


class CTP486(CatPhanModule):
    """HU uniformity module."""

    attr_name = "ctp486"
    common_name = "HU Uniformity"
    roi_dist_mm = 53
    roi_radius_mm = 10
    nominal_value = 0
    roi_settings = {
        "Top": {"value": nominal_value, "angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Right": {"value": nominal_value, "angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Bottom": {"value": nominal_value, "angle": 90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Left": {"value": nominal_value, "angle": 180, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Center": {"value": nominal_value, "angle": 0, "distance": 0, "radius": roi_radius_mm},
    }

    def _setup_rois(self) -> None:
        super()._setup_rois()
        self.nps_rois = {}
        for name, setting in self.roi_settings.items():
            self.nps_rois[name] = RectangleROI.from_phantom_center(
                array=self.image, width=setting["radius_pixels"] * 2,
                height=setting["radius_pixels"] * 2,
                angle=setting["angle_corrected"],
                dist_from_center=setting["distance_pixels"],
                phantom_center=self.phan_center)

    @property
    def overall_passed(self) -> bool:
        return all(roi.passed for roi in self.rois.values())

    @property
    def uniformity_index(self) -> float:
        """Elstrom et al eq 2."""
        center = self.rois["Center"]
        uis = [100 * ((roi.pixel_value - center.pixel_value) / (center.pixel_value + 1000))
               for roi in self.rois.values()]
        return uis[int(np.argmax(np.abs(uis)))]

    @property
    def integral_non_uniformity(self) -> float:
        """Elstrom et al eq 1."""
        maxhu = max(roi.pixel_value for roi in self.rois.values())
        minhu = min(roi.pixel_value for roi in self.rois.values())
        return (maxhu - minhu) / (maxhu + minhu + 2000)

    @cached_property
    def _nps(self) -> tuple[np.ndarray, np.ndarray, float, float]:
        """(ps2d, ps1d, avg_power, max_freq) of the ROI stack, on the CPU:
        the stack is a few hundred KB."""
        with profiling.stage("ctp486.nps"):
            rois = [r.pixel_array for r in self.nps_rois.values()]
            length = min(min(r.shape) for r in rois)
            stacked = np.stack([r[:length, :length] for r in rois])
            ps2d, ps1d, avg, maxf = nps_bundle(
                torch.from_numpy(stacked.astype(np.float32)), pixel_size=self.mm_per_pixel)
            return ps2d.numpy(), ps1d.numpy(), float(avg), float(maxf)

    @property
    def power_spectrum_2d(self) -> np.ndarray:
        return self._nps[0]

    @property
    def power_spectrum_1d(self) -> np.ndarray:
        return self._nps[1]

    @property
    def avg_noise_power(self) -> float:
        return self._nps[2]

    @property
    def max_noise_power_frequency(self) -> float:
        return self._nps[3]

    def plot_profiles(self, axis=None) -> None:
        import matplotlib.pyplot as plt

        if axis is None:
            _, axis = plt.subplots()
        axis.plot(self.image[int(self.phan_center.y), :], "g", label="Horizontal")
        axis.plot(self.image[:, int(self.phan_center.x)], "b", label="Vertical")
        axis.autoscale(tight=True)
        axis.axhline(self.nominal_value + self.tolerance, color="r", linewidth=3)
        axis.axhline(self.nominal_value - self.tolerance, color="r", linewidth=3)
        axis.grid(True)
        axis.set_ylabel("HU")
        axis.legend(loc=8, fontsize="small", title="")
        axis.set_title("Uniformity Profiles")


class CTP528(CatPhanModule):
    """Marker base of the spatial-resolution modules."""


class CTP528CP504(CTP528):
    """Spatial resolution from a collapsed circle profile over the line
    pairs."""

    attr_name = "ctp528"
    common_name = "Spatial Resolution"
    radius2linepairs_mm = 47
    combine_method = "max"
    num_slices = 3
    boundaries = (0, 0.107, 0.173, 0.236, 0.286, 0.335, 0.387, 0.434, 0.479)
    start_angle = np.pi
    ccw = True
    roi_settings = {
        "region 1": {"start": boundaries[0], "end": boundaries[1], "num peaks": 2, "num valleys": 1, "peak spacing": 0.021, "gap size (cm)": 0.5, "lp/mm": 0.1},
        "region 2": {"start": boundaries[1], "end": boundaries[2], "num peaks": 3, "num valleys": 2, "peak spacing": 0.01, "gap size (cm)": 0.25, "lp/mm": 0.2},
        "region 3": {"start": boundaries[2], "end": boundaries[3], "num peaks": 4, "num valleys": 3, "peak spacing": 0.006, "gap size (cm)": 0.167, "lp/mm": 0.3},
        "region 4": {"start": boundaries[3], "end": boundaries[4], "num peaks": 4, "num valleys": 3, "peak spacing": 0.00557, "gap size (cm)": 0.125, "lp/mm": 0.4},
        "region 5": {"start": boundaries[4], "end": boundaries[5], "num peaks": 4, "num valleys": 3, "peak spacing": 0.004777, "gap size (cm)": 0.1, "lp/mm": 0.5},
        "region 6": {"start": boundaries[5], "end": boundaries[6], "num peaks": 5, "num valleys": 4, "peak spacing": 0.00398, "gap size (cm)": 0.083, "lp/mm": 0.6},
        "region 7": {"start": boundaries[6], "end": boundaries[7], "num peaks": 5, "num valleys": 4, "peak spacing": 0.00358, "gap size (cm)": 0.071, "lp/mm": 0.7},
        "region 8": {"start": boundaries[7], "end": boundaries[8], "num peaks": 5, "num valleys": 4, "peak spacing": 0.0027866, "gap size (cm)": 0.063, "lp/mm": 0.8},
    }

    def _setup_rois(self):
        pass

    def _convert_units_in_settings(self):
        pass

    @cached_property
    def mtf(self) -> MTF:
        """Peak/valley relative MTF over the line-pair regions."""
        with profiling.stage("ctp528.mtf"):
            return self._compute_mtf()

    def _compute_mtf(self) -> MTF:
        maxs, mins = [], []
        for value in self.roi_settings.values():
            max_indices, max_values = self.circle_profile.find_peaks(
                min_distance=value["peak spacing"], max_number=value["num peaks"],
                search_region=(value["start"], value["end"]))
            if len(max_values) != value["num peaks"]:
                break
            maxs.append(max_values.mean())
            _, min_values = self.circle_profile.find_valleys(
                min_distance=value["peak spacing"], max_number=value["num valleys"],
                search_region=(int(min(max_indices)), int(max(max_indices))))
            mins.append(min_values.mean())
        if not maxs:
            raise ValueError("Did not find any spatial resolution pairs to analyze.")
        spacings = [roi["lp/mm"] for roi in self.roi_settings.values()]
        return MTF(lp_spacings=spacings[:len(maxs)], lp_maximums=maxs, lp_minimums=mins)

    @property
    def radius2linepairs(self) -> float:
        return self.radius2linepairs_mm * self.scaling_factor / self.mm_per_pixel

    def plot_rois(self, axis) -> None:
        self.circle_profile.plot2axes(axis, edgecolor="blue", plot_peaks=False)

    @cached_property
    def circle_profile(self) -> CollapsedCircleProfile:
        with profiling.stage("ctp528.circle_profile"):
            circle_profile = CollapsedCircleProfile(
                self.phan_center, self.radius2linepairs, image_array=self.image,
                start_angle=self.start_angle + np.deg2rad(self.catphan_roll),
                width_ratio=0.04 * self.roi_size_factor, sampling_ratio=2, ccw=self.ccw)
            circle_profile.filter(0.001, kind="gaussian")
            circle_profile.ground()
            return circle_profile


class CTP528CP604(CTP528CP504):
    """The CatPhan 604's CTP528 (the 504's)."""


class CTP528CP503(CTP528CP504):
    """The CatPhan 503's CTP528 (the 504's)."""


def _build_528_settings(boundaries) -> dict:
    npeaks = (2, 3, 4, 4, 4, 5, 5, 5)
    nvalleys = (1, 2, 3, 3, 3, 4, 4, 4)
    spacing = (0.021, 0.01, 0.006, 0.00557, 0.004777, 0.00398, 0.00358, 0.0027866)
    gaps = (0.5, 0.25, 0.167, 0.125, 0.1, 0.083, 0.071, 0.063)
    return {
        f"region {i + 1}": {
            "start": boundaries[i], "end": boundaries[i + 1],
            "num peaks": npeaks[i], "num valleys": nvalleys[i],
            "peak spacing": spacing[i], "gap size (cm)": gaps[i],
            "lp/mm": (i + 1) / 10,
        }
        for i in range(8)
    }


class CTP528CP600(CTP528CP504):
    start_angle = np.pi - 0.1
    ccw = False
    boundaries = (0, 0.127, 0.195, 0.255, 0.304, 0.354, 0.405, 0.453, 0.496)
    roi_settings = _build_528_settings(boundaries)


class CTP528CP700(CTP528):
    """The CatPhan 700's spatial resolution (CTP714): the max and min of
    eight rotated rectangles over its bar groups of 0.1-0.8 lp/mm."""

    attr_name = "ctp528"
    common_name = "Spatial Resolution"
    combine_method = "max"
    num_slices = 3
    start_angle = None
    roi_settings = {
        "region 1": {"lp/mm": 0.1, "radial_distance": 50, "transversal_distance": -7, "rotation": -90, "width": 3, "height": 11},
        "region 2": {"lp/mm": 0.2, "radial_distance": 50, "transversal_distance": 11, "rotation": -90, "width": 3, "height": 11},
        "region 3": {"lp/mm": 0.3, "radial_distance": 50, "transversal_distance": -5.5, "rotation": -45, "width": 3, "height": 10},
        "region 4": {"lp/mm": 0.4, "radial_distance": 50, "transversal_distance": 9.5, "rotation": -45, "width": 3, "height": 8.5},
        "region 5": {"lp/mm": 0.5, "radial_distance": 50, "transversal_distance": -9, "rotation": 0, "width": 3, "height": 8},
        "region 6": {"lp/mm": 0.6, "radial_distance": 50, "transversal_distance": 2, "rotation": 0, "width": 3, "height": 7},
        "region 7": {"lp/mm": 0.7, "radial_distance": 50, "transversal_distance": 12, "rotation": 0, "width": 3, "height": 6},
        "region 8": {"lp/mm": 0.8, "radial_distance": 50, "transversal_distance": -10.5, "rotation": 45, "width": 3, "height": 4},
    }

    def _setup_rois(self) -> None:
        roll = np.deg2rad(self.catphan_roll)
        for name, setting in self.roi_settings.items():
            rot = np.deg2rad(setting["rotation"])
            # the ROI placed in the phantom's polar frame, then the phantom
            # in the image
            local = np.array([setting["radial_distance_pixels"],
                              setting["transversal_distance_pixels"]])
            c, s = np.cos(rot), np.sin(rot)
            rotated = np.array([local[0] * c - local[1] * s,
                                local[0] * s + local[1] * c])
            cg, sg = np.cos(roll), np.sin(roll)
            global_xy = np.array([rotated[0] * cg - rotated[1] * sg,
                                  rotated[0] * sg + rotated[1] * cg])
            center = Point(global_xy[0] + self.phan_center.x,
                           global_xy[1] + self.phan_center.y)
            self.rois[name] = SpatialResolutionROI(
                array=self.image.array, width=setting["width_pixels"],
                height=setting["height_pixels"], center=center,
                rotation=setting["rotation"] + self.catphan_roll)

    @cached_property
    def mtf(self) -> MTF:
        return MTF.from_high_contrast_diskset(
            spacings=[r["lp/mm"] for r in self.roi_settings.values()],
            diskset=self.rois.values())


class GeometricLine(Line):
    """A node-to-node line on the geometry slice."""

    nominal_length_mm = 50

    def __init__(self, geo_roi1: Point, geo_roi2: Point, mm_per_pixel: float,
                 tolerance: float):
        super().__init__(geo_roi1, geo_roi2)
        self.mm_per_pixel = mm_per_pixel
        self.tolerance = tolerance

    @property
    def passed(self) -> bool:
        return (self.nominal_length_mm - self.tolerance < self.length_mm
                < self.nominal_length_mm + self.tolerance)

    @property
    def length_mm(self) -> float:
        return self.length * self.mm_per_pixel

    @property
    def pass_fail_color(self) -> str:
        return "blue" if self.passed else "red"


class CTP515(CatPhanModule):
    """Low-contrast module."""

    attr_name = "ctp515"
    common_name = "Low Contrast"
    num_slices = 1
    roi_dist_mm = 50
    roi_radius_mm = [6, 3.5, 3, 2.5, 2, 1.5]
    roi_angles = [-87.4, -69.1, -52.7, -38.5, -25.1, -12.9]
    roi_settings = {
        "15": {"angle": roi_angles[0], "distance": roi_dist_mm, "radius": roi_radius_mm[0]},
        "9": {"angle": roi_angles[1], "distance": roi_dist_mm, "radius": roi_radius_mm[1]},
        "8": {"angle": roi_angles[2], "distance": roi_dist_mm, "radius": roi_radius_mm[2]},
        "7": {"angle": roi_angles[3], "distance": roi_dist_mm, "radius": roi_radius_mm[3]},
        "6": {"angle": roi_angles[4], "distance": roi_dist_mm, "radius": roi_radius_mm[4]},
        "5": {"angle": roi_angles[5], "distance": roi_dist_mm, "radius": roi_radius_mm[5]},
    }
    background_roi_dist_ratio = 0.75
    background_roi_radius_mm = 4
    WINDOW_SIZE = 50

    def __init__(self, catphan, tolerance, cnr_threshold, offset, contrast_method,
                 visibility_threshold, clear_borders: bool = True):
        self.cnr_threshold = cnr_threshold
        self.contrast_method = contrast_method
        self.visibility_threshold = visibility_threshold
        super().__init__(catphan, tolerance=tolerance, offset=offset,
                         clear_borders=clear_borders)

    def _setup_rois(self):
        for name, setting in self.roi_settings.items():
            self.background_rois[name + "-outer"] = LowContrastDiskROI.from_phantom_center(
                self.image, setting["angle_corrected"],
                self.background_roi_radius_mm / self.mm_per_pixel,
                setting["distance_pixels"] * (2 - self.background_roi_dist_ratio),
                self.phan_center)
            self.background_rois[name + "-inner"] = LowContrastDiskROI.from_phantom_center(
                self.image, setting["angle_corrected"],
                self.background_roi_radius_mm / self.mm_per_pixel,
                setting["distance_pixels"] * self.background_roi_dist_ratio,
                self.phan_center)
            background_val = float(np.mean([
                self.background_rois[name + "-outer"].pixel_value,
                self.background_rois[name + "-inner"].pixel_value]))
            self.rois[name] = LowContrastDiskROI.from_phantom_center(
                self.image, setting["angle_corrected"], setting["radius_pixels"],
                setting["distance_pixels"], self.phan_center,
                contrast_reference=background_val, cnr_threshold=self.cnr_threshold,
                contrast_method=self.contrast_method,
                visibility_threshold=self.visibility_threshold)

    @property
    def rois_visible(self) -> int:
        return sum(roi.passed_visibility for roi in self.rois.values())

    @property
    def window_min(self) -> float:
        return min(r.pixel_value for r in self.background_rois.values()) - self.WINDOW_SIZE

    @property
    def window_max(self) -> float:
        return max(r.pixel_value for r in self.rois.values()) + self.WINDOW_SIZE


def _build_515_settings(angles, dist, radii) -> dict:
    return {name: {"angle": angles[i], "distance": dist, "radius": radii[i]}
            for i, name in enumerate(("15", "9", "8", "7", "6", "5"))}


class CTP515CP600(CTP515):
    roi_angles = [a + 180 for a in [-87.4, -69.1, -52.7, -38.5, -25.1, -12.9]]
    roi_dist_mm = 50
    roi_radius_mm = [6, 3.5, 3, 2.5, 2, 1.5]
    roi_settings = _build_515_settings(roi_angles, roi_dist_mm, roi_radius_mm)


class CTP515CP700(CTP515CP600):
    """The CatPhan 700's low-contrast module (the 600's)."""


# --------------------------------------------------------------------------
# CatPhanBase and the models
# --------------------------------------------------------------------------
class CatPhanBase(ResultsDataMixin, QuaacMixin):
    """CatPhan loading and analysis."""

    _model: str = ""
    air_bubble_radius_mm = 7
    localization_radius = 59
    was_from_zip = False
    min_num_images = 39
    clear_borders = True
    hu_origin_slice_variance = 400
    _phantom_center_func = None
    clip_in_localization = False
    roll_slice_offset: float = 0
    #: 2x2 mean-pool the stack before the batched localisation; the phantom
    #: is a ~500 mm^2 disk, so its pooled centroid moves < 0.1 px
    localization_downsample = 2
    modules: dict = {}
    catphan_radius_mm: float

    def __init__(self, folderpath, check_uid: bool = True,
                 memory_efficient_mode: bool = False, is_zip: bool = False):
        """A folder of the series' slices, or a zip of them when ``is_zip``.
        ``memory_efficient_mode`` keeps the slices' paths and metadata and
        decodes the pixels on access (a zip then stays extracted while the
        stack lives); the analysis decodes the series once into its cached
        host volume either way."""
        super().__init__()
        self.origin_slice = 0
        self.catphan_roll = 0
        self._device = None
        if isinstance(folderpath, (str, Path)) and not is_zip and not osp.isdir(folderpath):
            raise NotADirectoryError("Path given was not a Directory/Folder")
        if not memory_efficient_mode:
            stack = image.DicomImageStack
        elif is_zip:
            stack = image.LazyZipDicomImageStack
        else:
            stack = image.LazyDicomImageStack
        if is_zip:
            self.dicom_stack = stack.from_zip(folderpath, check_uid=check_uid,
                                              min_number=self.min_num_images)
            self.was_from_zip = True
        else:
            self.dicom_stack = stack(folderpath, check_uid=check_uid,
                                     min_number=self.min_num_images)

    @classmethod
    def from_zip(cls, zip_file, check_uid: bool = True, memory_efficient_mode: bool = False):
        """The scan from a zip archive of its slices."""
        return cls(folderpath=zip_file, check_uid=check_uid,
                   memory_efficient_mode=memory_efficient_mode, is_zip=True)

    # -- localisation -------------------------------------------------------
    def localize(self, origin_slice: int | None) -> None:
        with profiling.stage("find_phantom_axis"):
            if getattr(self, "_slice_centroids", None) is None:
                self._slice_centroids = self._batched_phantom_centroids()
            self._phantom_center_func = self.find_phantom_axis()
        if origin_slice is not None:
            self.origin_slice = origin_slice
        else:
            with profiling.stage("find_origin_slice"):
                self.origin_slice = self.find_origin_slice()
        with profiling.stage("find_phantom_roll"):
            self.catphan_roll = self.find_phantom_roll() + self.angle_adjustment
        if origin_slice is None:
            with profiling.stage("refine_origin_slice"):
                self.origin_slice = self.refine_origin_slice(
                    initial_slice_num=self.origin_slice)
        if not self._ensure_physical_scan_extent():
            raise ValueError(
                "The physical scan extent does not match the module configuration. "
                "Not all modules were included in the scan.")

    def _module_offsets(self) -> list[float]:
        absolute_origin_position = self.dicom_stack[self.origin_slice].z_position
        return [absolute_origin_position + config["offset"]
                for config in self.modules.values()]

    def _ensure_physical_scan_extent(self) -> bool:
        z_positions = [z_position(m) for m in self.dicom_stack.metadatas]
        return (round(min(self._module_offsets()), 1) >= round(min(z_positions), 1)
                and round(max(self._module_offsets()), 1) <= round(max(z_positions), 1))

    def find_phantom_axis(self):
        """Fit the phantom centres across slices to linear functions of z.
        Slices the batched localisation could not decide (K overflow) take
        the per-slice path."""
        z, center_x, center_y = [], [], []
        batched = getattr(self, "_slice_centroids", None)
        if batched is None:
            batched = self._batched_phantom_centroids()
        for idx in range(len(self.dicom_stack)):
            if batched is not None and batched[idx] is not None:
                cy, cx = batched[idx]
                if not np.isnan(cy):
                    z.append(idx)
                    center_y.append(cy)
                    center_x.append(cx)
                continue
            # decoded only here: a lazy stack decodes on every access
            slc = Slice(self, slice_num=idx, clear_borders=self.clear_borders,
                        original_image=self.dicom_stack[idx])
            if slc.is_phantom_in_view():
                roi = slc.phantom_roi
                z.append(idx)
                center_y.append(roi.centroid[0])
                center_x.append(roi.centroid[1])
        zs = np.array(z)
        center_xs = np.array(center_x) + self.x_adjustment
        center_ys = np.array(center_y) + self.y_adjustment
        x_idxs = np.argwhere(np.isclose(np.median(center_xs), center_xs, atol=3, rtol=0.01))
        y_idxs = np.argwhere(np.isclose(np.median(center_ys), center_ys, atol=3, rtol=0.01))
        common = np.intersect1d(x_idxs, y_idxs)
        fit_zx = np.poly1d(np.polyfit(zs[common], center_xs[common], deg=1, rcond=1e-5))
        fit_zy = np.poly1d(np.polyfit(zs[common], center_ys[common], deg=1, rcond=1e-5))
        return fit_zx, fit_zy

    def _stage_on_device(self, ds: int, vol: np.ndarray) -> torch.Tensor:
        """The full-resolution float32 stack on the analysis device, staged
        once per scan and device and reused by repeat analyses."""
        cache = getattr(self, "_loc_dev_cache", None)
        if cache is None or cache[0] != str(self._device):
            cache = (str(self._device), torch.from_numpy(vol).to(self._device))
            self._loc_dev_cache = cache
        return cache[1]

    def _batched_phantom_centroids(self):
        """Per-slice phantom centroids from one batched localisation pass: a
        list with (cy, cx) where the phantom was found, (nan, nan) where the
        slice fails the checks of :meth:`Slice.phantom_roi`, or None where
        the K slots overflowed (per-slice path). None outright for a stack
        of mixed slice shapes."""
        staged = self._loc_stage_host()
        if staged is None:
            return None
        ds, vol = staged
        K = 32
        regions, max_edges = _stack_phantom_regions(
            self._stage_on_device(ds, vol), K, self.clear_borders, ds,
            self.clip_in_localization)
        return self._centroids_from_host(regions.to_numpy(), max_edges.cpu().numpy(),
                                         ds, range(vol.shape[0]), K)

    def _loc_stage_host(self):
        """(ds, float32 stack) of the scan, cached for its lifetime, or None
        for mixed slice shapes. Pooling and the HU clip run on the device."""
        vol = getattr(self, "_host_vol", None)
        if vol is None:
            try:
                vol = np.stack([self.dicom_stack[i].array
                                for i in range(len(self.dicom_stack))]).astype(np.float32)
            except ValueError:
                return None
            self._host_vol = vol
        ds = self.localization_downsample
        if ds <= 1 or vol.shape[1] % ds or vol.shape[2] % ds:
            ds = 1
        return ds, vol

    def _centroids_from_host(self, host, max_edges, ds, idx_range, K=32):
        """Per-slice accept/reject and centroid mapping from host region
        slots (shared by the single-scan and batched paths)."""
        expected_area = self.catphan_size / ds**2
        out = []
        for idx in idx_range:
            if max_edges[idx] < 0.1:
                out.append((np.nan, np.nan))  # "no edges"
                continue
            valid_idxs = np.nonzero(host.valid[idx])[0]
            if len(valid_idxs) >= K:
                out.append(None)  # slots full: per-slice K escalation
                continue
            if len(valid_idxs) == 0:
                out.append((np.nan, np.nan))
                continue
            areas = host.area_filled[idx][valid_idxs]
            best = valid_idxs[int(np.argmin(np.abs(areas - expected_area)))]
            area = float(host.area_filled[idx][best])
            if expected_area * 1.3 < area or area < expected_area / 1.3:
                out.append((np.nan, np.nan))
                continue
            # pooled pixel i covers full pixels [ds*i, ds*i + ds): its centre
            # is at ds*i + (ds - 1)/2
            out.append((float(host.centroid_r[idx][best]) * ds + (ds - 1) / 2,
                        float(host.centroid_c[idx][best]) * ds + (ds - 1) / 2))
        return out

    @property
    def mm_per_pixel(self) -> float:
        spacing = self.dicom_stack.metadata.PixelSpacing
        return spacing[0] if isinstance(spacing, list) else spacing

    def find_origin_slice(self) -> int:
        """Scan every other slice in view for the HU-linearity module."""
        cached = getattr(self, "_slice_centroids", None)
        in_view = []
        for image_number in range(0, self.num_images, 2):
            if cached is not None and cached[image_number] is not None:
                if not np.isnan(cached[image_number][0]):
                    in_view.append(image_number)
            else:
                slc = Slice(self, image_number, combine=False,
                            clear_borders=self.clear_borders)
                if slc.is_phantom_in_view():
                    in_view.append(image_number)
        variation_limit = max(100, self.dicom_stack.metadata.SliceThickness * -100 + 300)
        profs = self._origin_profile_stack(in_view)
        hu_slices = []
        if profs is not None:
            low_end, high_end = np.percentile(profs, [2, 98], axis=1)
            median = np.median(profs, axis=1)
            middle_variation = (np.percentile(profs, 80, axis=1)
                                - np.percentile(profs, 20, axis=1))
            for i, image_number in enumerate(in_view):
                if ((low_end[i] < median[i] - self.hu_origin_slice_variance)
                        and (high_end[i] > median[i] + self.hu_origin_slice_variance)
                        and (middle_variation[i] < variation_limit)):
                    hu_slices.append(image_number)
        else:
            for image_number in in_view:
                slc = Slice(self, image_number, combine=False,
                            clear_borders=self.clear_borders)
                prof = CollapsedCircleProfile(
                    slc.phan_center, radius=self.localization_radius / self.mm_per_pixel,
                    image_array=slc.image, width_ratio=0.05, num_profiles=5).values
                low_end, high_end = np.percentile(prof, [2, 98])
                median = np.median(prof)
                middle_variation = np.percentile(prof, 80) - np.percentile(prof, 20)
                if ((low_end < median - self.hu_origin_slice_variance)
                        and (high_end > median + self.hu_origin_slice_variance)
                        and (middle_variation < variation_limit)):
                    hu_slices.append(image_number)
        if not hu_slices:
            raise ValueError("No slices were found that resembled the HU linearity module")
        hu_slices = np.array(hu_slices)
        c = int(round(float(np.median(hu_slices))))
        ln = len(hu_slices)
        hu_slices = hu_slices[((c + ln / 2) >= hu_slices) & (hu_slices >= (c - ln / 2))]
        center_hu_slice = int(round(float(np.median(hu_slices))))
        if self._is_within_image_extent(center_hu_slice):
            return center_hu_slice

    def _origin_profile_stack(self, idxs: list[int]) -> np.ndarray | None:
        """The origin scan's collapsed circle profiles (width ratio 0.05, 5
        rings, start 0, ccw) of every candidate slice as one gather over the
        cached host stack; None asks for the per-slice path."""
        vol = getattr(self, "_host_vol", None)
        if vol is None:
            return None
        if not idxs:
            return np.empty((0, 1))
        radius = self.localization_radius / self.mm_per_pixel
        radii = np.linspace(radius * 0.95, radius * 1.05, 5)
        size = np.pi * radii.max() * 2
        interval = (2 * np.pi) / size
        rads = np.arange(0, 2 * np.pi - interval, interval)[::-1]
        cx = np.array([float(self._phantom_center_func[0](i)) for i in idxs])
        cy = np.array([float(self._phantom_center_func[1](i)) for i in idxs])
        # centres too close to the edge take the per-slice path, which
        # raises CircleProfile's error
        if ((cx + radii.max() >= vol.shape[2]) | (cx - radii.max() < 0)
                | (cy + radii.max() >= vol.shape[1]) | (cy - radii.max() < 0)).any():
            return None
        xx = np.round(np.cos(rads)[None, None, :] * radii[None, :, None]
                      + cx[:, None, None]).astype(int)
        yy = np.round(np.sin(rads)[None, None, :] * radii[None, :, None]
                      + cy[:, None, None]).astype(int)
        yy = np.clip(yy, 0, vol.shape[1] - 1)
        xx = np.clip(xx, 0, vol.shape[2] - 1)
        sub = vol[np.asarray(idxs)[:, None, None], yy, xx].astype(np.float64)
        return sub.sum(axis=1) / len(radii)

    def refine_origin_slice(self, initial_slice_num: int) -> int:
        return initial_slice_num

    def _is_right_area(self, region) -> bool:
        thresh = np.pi * ((self.air_bubble_radius_mm / self.mm_per_pixel) ** 2)
        return thresh * 2 > region.filled_area > thresh / 2

    def _is_right_eccentricity(self, region) -> bool:
        return region.eccentricity < 0.5

    def find_phantom_roll(self, func: Callable | None = None) -> float:
        """Roll from the two air bubbles of the HU slice."""
        slice_offset = round(self.roll_slice_offset / self.dicom_stack.slice_spacing)
        slice_num = self.origin_slice + slice_offset
        slc = Slice(self, slice_num, clear_borders=self.clear_borders)
        pre = getattr(self, "_pre_roll_regions", None)
        if pre is not None and func is None and pre[0] == slice_num:
            regions = pre[1]
        else:
            # bbox and min/max only when a caller's sort key needs them
            _, regions, _ = get_regions(slc, minmax=func is not None)
        hu_bubbles = [r for r in regions
                      if self._is_right_area(r) and self._is_right_eccentricity(r)]
        func = func or (lambda x: abs(x.centroid[1] - slc.phan_center.x))
        central_bubbles = sorted(hu_bubbles, key=func)[:2]
        sorted_bubbles = sorted(central_bubbles, key=lambda x: x.centroid[0])
        if len(sorted_bubbles) < 2:
            warnings.warn("Could not determine phantom roll. Setting roll to 0.", UserWarning)
            return 0.0
        y_dist = sorted_bubbles[1].centroid[0] - sorted_bubbles[0].centroid[0]
        x_dist = sorted_bubbles[1].centroid[1] - sorted_bubbles[0].centroid[1]
        return float(np.rad2deg(np.arctan2(y_dist, x_dist)) - 90)

    @property
    def num_images(self) -> int:
        return len(self.dicom_stack)

    def _is_within_image_extent(self, image_num: int) -> bool:
        if self.num_images - 1 > image_num > 1:
            return True
        raise ValueError(
            "The determined image number is beyond the image extent. Either the "
            "entire dataset wasn't loaded or the entire phantom wasn't scanned.")

    @property
    def catphan_size(self) -> float:
        return np.pi * (self.catphan_radius_mm**2) / (self.mm_per_pixel**2)

    # -- analysis -----------------------------------------------------------
    def analyze(self, hu_tolerance: float = 40, scaling_tolerance: float = 1,
                thickness_tolerance: float = 0.2, low_contrast_tolerance: float = 1,
                cnr_threshold: float = 15, zip_after: bool = False,
                contrast_method: str = Contrast.MICHELSON,
                visibility_threshold: float = 0.15,
                thickness_slice_straddle: str | int = "auto",
                expected_hu_values: dict | None = None,
                x_adjustment: float = 0, y_adjustment: float = 0,
                angle_adjustment: float = 0, roi_size_factor: float = 1,
                scaling_factor: float = 1, origin_slice: int | None = None,
                roll_slice_offset: float = 0,
                device: str | torch.device | None = None) -> None:
        """Full analysis on ``device`` (``None`` means ``"cuda"``, and raises
        when no CUDA device exists). Other arguments as
        ``pylinac_tpu.ct.CatPhanBase.analyze``; ``zip_after`` is accepted
        and, as there, does nothing."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self.roll_slice_offset = roll_slice_offset
        with profiling.stage("localize"):
            self.localize(origin_slice)
        ctp404, offset = self._get_module(CTP404CP504, raise_empty=True)
        with profiling.stage("ctp404"):
            self.ctp404 = ctp404(
                self, offset=offset, hu_tolerance=hu_tolerance,
                thickness_tolerance=thickness_tolerance,
                scaling_tolerance=scaling_tolerance, clear_borders=self.clear_borders,
                thickness_slice_straddle=thickness_slice_straddle,
                expected_hu_values=expected_hu_values)
        if self._has_module(CTP486):
            ctp486, offset = self._get_module(CTP486)
            with profiling.stage("ctp486"):
                self.ctp486 = ctp486(self, offset=offset, tolerance=hu_tolerance,
                                     clear_borders=self.clear_borders)
        if self._has_module(CTP528):
            ctp528, offset = self._get_module(CTP528)
            with profiling.stage("ctp528"):
                self.ctp528 = ctp528(self, offset=offset, tolerance=None,
                                     clear_borders=self.clear_borders)
        if self._has_module(CTP515):
            ctp515, offset = self._get_module(CTP515)
            with profiling.stage("ctp515"):
                self.ctp515 = ctp515(
                    self, tolerance=low_contrast_tolerance, cnr_threshold=cnr_threshold,
                    offset=offset, contrast_method=contrast_method,
                    visibility_threshold=visibility_threshold,
                    clear_borders=self.clear_borders)

    def _has_module(self, module_of_interest) -> bool:
        return any(issubclass(module, module_of_interest) for module in self.modules)

    def _get_module(self, module_of_interest, raise_empty: bool = False):
        for module, values in self.modules.items():
            if issubclass(module, module_of_interest):
                return module, values.get("offset")
        if raise_empty:
            raise ValueError(f"Tried to find the {module_of_interest} or a subclass of it.")

    # -- outputs ------------------------------------------------------------
    def results(self, as_list: bool = False) -> str | list[list[str]]:
        results = [[
            f" - CBCT/CT {self._model} QA Test - ",
            " - CTP 404 Results - ",
            f"HU Linearity tolerance: {self.ctp404.hu_tolerance}",
            "HU Linearity ROIs:",
            *textwrap.wrap(self.ctp404.roi_vals_as_str, width=50),
            f"HU Passed?: {self.ctp404.passed_hu}",
            f"Low contrast visibility: {self.ctp404.lcv:2.2f}",
            f"Geometric Line Average (mm): {self.ctp404.avg_line_length:2.2f}",
            f"Geometry Passed?: {self.ctp404.passed_geometry}",
            f"Measured Slice Thickness (mm): {self.ctp404.meas_slice_thickness:2.3f}",
            f"Slice Thickness Passed? {self.ctp404.passed_thickness}",
        ]]
        if self._has_module(CTP528):
            results.append([
                " - CTP528 Results - ",
                f"MTF 80% (lp/mm): {self.ctp528.mtf.relative_resolution(80):2.2f}",
                f"MTF 50% (lp/mm): {self.ctp528.mtf.relative_resolution(50):2.2f}",
                f"MTF 30% (lp/mm): {self.ctp528.mtf.relative_resolution(30):2.2f}",
            ])
        if self._has_module(CTP486):
            results.append([
                " - CTP486 Results - ",
                f"Uniformity tolerance: {self.ctp486.tolerance}",
                f"Uniformity ROIs: {self.ctp486.roi_vals_as_str}",
                f"Uniformity index: {self.ctp486.uniformity_index:2.3f}",
                f"Integral non-uniformity: {self.ctp486.integral_non_uniformity:2.4f}",
                f"Uniformity Passed?: {self.ctp486.overall_passed}",
            ])
        if self._has_module(CTP515):
            results.append([
                " - CTP515 Results - ",
                f"CNR threshold: {self.ctp515.cnr_threshold}",
                f"Low contrast ROIs 'seen': {self.ctp515.rois_visible}",
            ])
        if not as_list:
            return "\n".join("\n".join(r) for r in results)
        return results

    def _generate_results_data(self) -> CatphanResult:
        data = CatphanResult(
            catphan_model=self._model,
            catphan_roll_deg=self.catphan_roll,
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            ctp404=CTP404Result(
                offset=self.ctp404._offset,
                low_contrast_visibility=self.ctp404.lcv,
                thickness_passed=self.ctp404.passed_thickness,
                measured_slice_thickness_mm=self.ctp404.meas_slice_thickness,
                thickness_num_slices_combined=self.ctp404.num_slices + self.ctp404.pad,
                geometry_passed=self.ctp404.passed_geometry,
                avg_line_distance_mm=self.ctp404.avg_line_length,
                line_distances_mm=[line.length_mm for line in self.ctp404.lines.values()],
                hu_linearity_passed=self.ctp404.passed_hu,
                hu_tolerance=self.ctp404.hu_tolerance,
                hu_rois=rois_to_results(self.ctp404.rois)))
        if self._has_module(CTP486):
            data.ctp486 = CTP486Result(
                passed=self.ctp486.overall_passed,
                uniformity_index=self.ctp486.uniformity_index,
                integral_non_uniformity=self.ctp486.integral_non_uniformity,
                rois=rois_to_results(self.ctp486.rois),
                nps_avg_power=self.ctp486.avg_noise_power,
                nps_max_freq=self.ctp486.max_noise_power_frequency)
        if self._has_module(CTP528):
            data.ctp528 = CTP528Result(
                roi_settings=self.ctp528.roi_settings,
                start_angle_radians=self.ctp528.start_angle,
                mtf_lp_mm={p: self.ctp528.mtf.relative_resolution(p)
                           for p in range(10, 91, 10)})
        if self._has_module(CTP515):
            data.ctp515 = CTP515Result(
                cnr_threshold=self.ctp515.cnr_threshold,
                num_rois_seen=self.ctp515.rois_visible,
                roi_settings=self.ctp515.roi_settings,
                roi_results={key: roi.as_dict() for key, roi in self.ctp515.rois.items()})
        return data

    # -- reports (JAX ct.py:1858-2011) ----------------------------------------
    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = {
            "Slice thickness": QuaacDatum(value=self.ctp404.meas_slice_thickness, unit="mm"),
            "Geometric line average": QuaacDatum(value=self.ctp404.avg_line_length, unit="mm"),
            "Low contrast visibility": QuaacDatum(value=self.ctp404.lcv),
        }
        for name, roi in self.ctp404.rois.items():
            data[f"{name} HU"] = QuaacDatum(value=roi.pixel_value, unit="HU")
        return data

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs) -> None:
        import matplotlib.pyplot as plt

        plt.figure(**plt_kwargs)
        grid_size = (2, 4)
        hu_ax = plt.subplot2grid(grid_size, (0, 1))
        self.ctp404.plot(hu_ax)
        hu_lin_ax = plt.subplot2grid(grid_size, (0, 2))
        self.ctp404.plot_linearity(hu_lin_ax)
        if self._has_module(CTP486):
            unif_ax = plt.subplot2grid(grid_size, (0, 0))
            self.ctp486.plot(unif_ax)
        if self._has_module(CTP528):
            sr_ax = plt.subplot2grid(grid_size, (1, 0))
            self.ctp528.plot(sr_ax)
            mtf_ax = plt.subplot2grid(grid_size, (0, 3))
            self.ctp528.mtf.plot(mtf_ax)
        if self._has_module(CTP515):
            locon_ax = plt.subplot2grid(grid_size, (1, 1))
            self.ctp515.plot(locon_ax)
        plt.tight_layout()
        if show:
            plt.show()

    def plot_side_view(self, axis=None) -> None:
        """A coronal side view of the stack with the module slices marked."""
        import matplotlib.pyplot as plt

        if axis is None:
            _, axis = plt.subplots()
        vol = np.stack([img.array for img in self.dicom_stack])
        mid = vol.shape[1] // 2
        axis.imshow(vol[:, mid, :], cmap="gray", aspect="auto")
        try:
            for offset in self._module_offsets():
                zs = [img.z_position for img in self.dicom_stack]
                idx = int(np.argmin(np.abs(np.asarray(zs) - offset)))
                axis.axhline(idx, color="b", alpha=0.5)
        except (AttributeError, NotImplementedError):
            pass
        axis.set_title("Side View")

    @staticmethod
    def _plotly_module_fig(module, show_colorbar: bool = True):
        """A module's slice with its ROI circles, as a plotly-schema figure."""
        from .core import plotly_utils as pu

        fig = pu.image_figure(module.image.array,
                              title=f"{module.common_name} ({module.slice_num + 1})",
                              show_colorbar=show_colorbar)
        shapes = fig.layout.setdefault("shapes", [])
        for roi, color in ([(r, getattr(r, "plot_color", "green")) for r in module.rois.values()]
                           + [(r, "blue") for r in module.background_rois.values()]):
            if not hasattr(roi, "radius"):
                continue
            shapes.append({
                "type": "circle",
                "x0": roi.center.x - roi.radius, "x1": roi.center.x + roi.radius,
                "y0": roi.center.y - roi.radius, "y1": roi.center.y + roi.radius,
                "line": {"color": color, "width": 2}})
        return fig

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`) of each analysed
        module, the HU linearity and the MTF: ``{name: Figure}``. A class
        without a CTP404 gets one ROI figure per analysed module, and an
        rMTF where a module has one."""
        from .core import plotly_utils as pu

        if not hasattr(self, "ctp404"):
            return self._plotly_generic_modules(show=show, show_colorbar=show_colorbar,
                                                show_legend=show_legend)
        figs: dict[str, pu.Figure] = {}
        figs["CTP404"] = self._plotly_module_fig(self.ctp404, show_colorbar)
        lin = pu.Figure()
        nominal = [roi.nominal_val for roi in self.ctp404.rois.values()]
        deltas = [roi.value_diff for roi in self.ctp404.rois.values()]
        lin.add_trace(pu.marker_trace(nominal, deltas, name="HU delta", symbol="cross",
                                      color="green"))
        pu.add_horizontal_line(lin, 0, color="gray")
        pu.add_title(lin, "HU Linearity")
        lin.update_layout(xaxis_title="Nominal HU", yaxis_title="HU Delta",
                          showlegend=show_legend)
        figs["HU Linearity"] = lin
        if self._has_module(CTP486):
            figs["CTP486"] = self._plotly_module_fig(self.ctp486, show_colorbar)
        if self._has_module(CTP528):
            figs["CTP528"] = self._plotly_module_fig(self.ctp528, show_colorbar)
            mtf = pu.Figure()
            mtf.add_trace(pu.scatter_trace(list(self.ctp528.mtf.norm_mtfs.keys()),
                                           list(self.ctp528.mtf.norm_mtfs.values()),
                                           name="rMTF", mode="lines+markers"))
            pu.add_title(mtf, "RMTF")
            mtf.update_layout(xaxis_title="Line pairs / mm", yaxis_title="Relative MTF",
                              showlegend=show_legend)
            figs["MTF"] = mtf
        if self._has_module(CTP515):
            figs["CTP515"] = self._plotly_module_fig(self.ctp515, show_colorbar)
        if show:
            for f in figs.values():
                f.show()
        return figs

    def _plotly_generic_modules(self, show: bool, show_colorbar: bool, show_legend: bool):
        """A ROI figure per analysed module attribute, and an rMTF where the
        module has one."""
        from .core import plotly_utils as pu

        figs: dict[str, pu.Figure] = {}
        for name in dir(self):
            if name.startswith("_"):
                continue
            try:
                mod = getattr(self, name)
            except Exception:
                continue
            if not isinstance(mod, CatPhanModule):
                continue
            key = getattr(mod, "common_name", name)
            figs[key] = self._plotly_module_fig(mod, show_colorbar)
            mtf = getattr(mod, "mtf", None)
            if mtf is not None and hasattr(mtf, "norm_mtfs"):
                f = pu.Figure()
                f.add_trace(pu.scatter_trace(list(mtf.norm_mtfs.keys()),
                                             list(mtf.norm_mtfs.values()),
                                             name="rMTF", mode="lines+markers"))
                pu.add_title(f, f"{key} rMTF")
                f.update_layout(xaxis_title="Line pairs / mm", yaxis_title="Relative MTF",
                                showlegend=show_legend)
                figs[f"{key} MTF"] = f
        if not figs:
            raise RuntimeError("The scan must be analyzed first. Use .analyze().")
        if show:
            for f in figs.values():
                f.show()
        return figs

    def publish_pdf(self, filename, notes=None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The results as a PDF (:mod:`.core.pdf`); needs no matplotlib."""
        from .core import pdf

        canvas = pdf.PylinacCanvas(filename, page_title=f"CatPhan {self._model} Analysis",
                                   metadata=metadata, logo=logo)
        flat = [line for group in self.results(as_list=True) for line in group]
        canvas.add_text(text=flat, location=(2, 25.5), font_size=9)
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


def save_figures(figs: dict, directory=None, to_stream: bool = False) -> list:
    """Each figure of ``figs`` as PNG: a ``BytesIO`` each when ``to_stream``,
    else ``<name>.png`` in ``directory`` (the working directory by default);
    the streams or absolute paths, in order. The CT siblings'
    ``save_images`` (JAX ``acr.py:295``, ``helios.py:435``, ``quart.py:394``)."""
    import io

    paths = []
    for name, fig in figs.items():
        if to_stream:
            path = io.BytesIO()
        else:
            destination = Path(directory) if directory is not None else Path.cwd()
            path = (destination / name).with_suffix(".png").absolute()
        fig.savefig(path)
        paths.append(path)
    return paths


def publish_images_pdf(filename, page_title: str, lines, location: tuple[float, float],
                       images, notes=None, open_file: bool = False,
                       metadata: dict | None = None, logo=None) -> None:
    """A PDF of the notes, then ``lines`` from ``location`` down at 0.5 cm
    a line, then a page per PNG of ``images`` (:mod:`.core.pdf`): the CT
    siblings' ``publish_pdf`` (JAX ``acr.py:374``, ``:1190``,
    ``helios.py:463``, ``quart.py:411``)."""
    from .core import pdf

    canvas = pdf.PylinacCanvas(filename, page_title=page_title, metadata=metadata, logo=logo)
    if notes is not None:
        canvas.add_text(text="Notes:", location=(1, 4.5), font_size=14)
        canvas.add_text(text=notes, location=(1, 4))
    x, y = location
    for idx, text in enumerate(lines):
        canvas.add_text(text=text, location=(x, y - idx * 0.5))
    for img in images:
        canvas.add_new_page()
        canvas.add_image(img, location=(1, 5), dimensions=(18, 18))
    canvas.finish()
    if open_file:
        import webbrowser

        webbrowser.open(filename)


def wrapped(results) -> list[str]:
    """``results`` (strings) wrapped at 110 characters, one list of lines."""
    return [line for r in results for line in textwrap.wrap(r, width=110)]


@capture_warnings
class CatPhan503(CatPhanBase):
    """CatPhan 503: CTP404, CTP486, CTP528."""

    _model = "503"
    catphan_radius_mm = 97
    modules = {
        CTP404CP503: {"offset": 0},
        CTP486: {"offset": -110},
        CTP528CP503: {"offset": -30},
    }


@capture_warnings
class CatPhan504(CatPhanBase):
    """CatPhan 504: CTP404, CTP486, CTP528, CTP515."""

    _model = "504"
    catphan_radius_mm = 101
    modules = {
        CTP404CP504: {"offset": 0},
        CTP486: {"offset": -65},
        CTP528CP504: {"offset": 30},
        CTP515: {"offset": -30},
    }


@capture_warnings
class CatPhan604(CatPhanBase):
    """CatPhan 604: CTP404, CTP486, CTP528, CTP515."""

    _model = "604"
    catphan_radius_mm = 101
    modules = {
        CTP404CP604: {"offset": 0},
        CTP486: {"offset": -80},
        CTP528CP604: {"offset": 40},
        CTP515: {"offset": -40},
    }


@capture_warnings
class CatPhan600(CatPhanBase):
    """CatPhan 600: CTP404, CTP486, CTP528, CTP515."""

    _model = "600"
    catphan_radius_mm = 101
    modules = {
        CTP404CP600: {"offset": 0},
        CTP486: {"offset": -160},
        CTP515CP600: {"offset": -110},
        CTP528CP600: {"offset": -70},
    }

    def find_phantom_roll(self, func: Callable | None = None) -> float:
        """The 600's top air ROI may hold a water vial."""
        angle = super().find_phantom_roll(lambda x: -x.centroid[0])
        return angle if abs(angle) < 10 else angle + 75


@capture_warnings
class CatPhan700(CatPhanBase):
    """CatPhan 700: CTP682 (HU), CTP714 (spatial resolution), CTP712
    (uniformity), CTP515."""

    _model = "700"
    catphan_radius_mm = 101
    modules = {
        CTP404CP700: {"offset": 0},
        CTP515CP700: {"offset": -80},
        CTP486: {"offset": -160},
        CTP528CP700: {"offset": -40},
    }


# ===========================================================================
# Batched session API: many CatPhan scans, one localisation pass
# ===========================================================================
class CatPhanBatch:
    """Analyse several same-geometry CatPhan scans with the localisation of
    all their slices in one batched pass on the device, the roll bubbles of
    every scan in a second and the geometry nodes in a third. Per-scan
    results equal :meth:`CatPhanBase.analyze` on the same data.

    Scans must share the phantom model, slice shape and pixel spacing (one
    clinical protocol).
    """

    def __init__(self, folders: list, model=None):
        model = model or CatPhan504
        self.cts = [model(f) for f in folders]
        if not self.cts:
            raise ValueError("No scans were provided")

    def analyze(self, mesh=None, device: str | torch.device | None = None,
                **analyze_kwargs) -> None:
        """Analyse every scan on ``device`` (``None`` means ``"cuda"``, and
        raises when no CUDA device exists); other arguments as
        :meth:`CatPhanBase.analyze`.

        ``mesh``: a :class:`~pylinac_tpu_torch.parallel.mesh.Mesh` whose
        ``data`` axis shards the slices of every scan for the localisation
        pass (:func:`~pylinac_tpu_torch.parallel.mesh.
        sharded_stack_phantom_regions`; JAX ``ct.py:2150-2156``,
        ``:2182-2189``); per-slice results equal the unsharded run's. The
        rest runs on the mesh's first device, and a ``device`` that
        differs from it raises ``ValueError``."""
        if mesh is not None:
            from .parallel.mesh import mesh_device

            device = mesh_device(mesh, device, "CatPhanBatch.analyze")
        else:
            device = resolve_device(device, "CatPhanBatch.analyze")
        with profiling.stage("batch_stage_host"):
            staged = []
            for ct in self.cts:
                st = ct._loc_stage_host()
                if st is None:
                    raise ValueError("A scan has heterogeneous slice shapes")
                staged.append(st)
        shape_set = {st[1].shape[1:] for st in staged}
        if len({st[0] for st in staged}) != 1 or len(shape_set) != 1:
            raise ValueError(f"All scans must share slice geometry; got shapes {shape_set}")
        ds = staged[0][0]
        vols = []
        for ct, (_, vol) in zip(self.cts, staged):
            ct._device = device
            vols.append(ct._stage_on_device(ds, vol))
        K = 32
        with profiling.stage("batch_localize"):
            if mesh is not None:
                from .parallel.mesh import sharded_stack_phantom_regions

                host, max_edges = sharded_stack_phantom_regions(
                    torch.cat(vols), K, self.cts[0].clear_borders, ds,
                    self.cts[0].clip_in_localization, mesh)
            else:
                regions, max_edges = _stack_phantom_regions(
                    torch.cat(vols), K, self.cts[0].clear_borders, ds,
                    self.cts[0].clip_in_localization)
                host, max_edges = regions.to_numpy(), max_edges.cpu().numpy()
            offset = 0
            for ct, (_, vol) in zip(self.cts, staged):
                n = vol.shape[0]
                ct._slice_centroids = ct._centroids_from_host(
                    host, max_edges, ds, range(offset, offset + n), K)
                offset += n
        with profiling.stage("batch_roll_prepass"):
            self._roll_prepass(analyze_kwargs)
        try:
            for ct in self.cts:
                ct._defer_geometry = True
                # the roll pre-pass found this scan's origin slice already
                kwargs = dict(analyze_kwargs)
                kwargs.setdefault("origin_slice", getattr(ct, "origin_slice", None))
                ct.analyze(device=device, **kwargs)
            with profiling.stage("batch_finalize_geometry"):
                self._finalize_geometry_batch(device)
            self._mtf_prepass()
        finally:
            for ct in self.cts:
                ct._defer_geometry = False

    def _roll_prepass(self, analyze_kwargs: dict) -> None:
        """Find every scan's air-bubble regions (the roll slice's mask
        stage and region properties) in one batched pass, and seed
        ``_pre_roll_regions`` so that each scan's ``find_phantom_roll``
        reuses them."""
        slcs = []
        for ct in self.cts:
            ct.x_adjustment = analyze_kwargs.get("x_adjustment", 0)
            ct.y_adjustment = analyze_kwargs.get("y_adjustment", 0)
            ct.roll_slice_offset = analyze_kwargs.get("roll_slice_offset", 0)
            with profiling.stage("prepass.axis"):
                ct._phantom_center_func = ct.find_phantom_axis()
            origin = analyze_kwargs.get("origin_slice")
            with profiling.stage("prepass.origin"):
                ct.origin_slice = (int(origin) if origin is not None
                                   else ct.find_origin_slice())
            slice_num = ct.origin_slice + round(ct.roll_slice_offset
                                                / ct.dicom_stack.slice_spacing)
            with profiling.stage("prepass.slice"):
                slcs.append((slice_num, Slice(ct, slice_num, clear_borders=ct.clear_borders)))
        arrs = [np.asarray(s.image.array) for _, s in slcs]
        if len({a.shape for a in arrs}) != 1:
            return  # mixed roll-slice shapes: per-scan path
        center = slcs[0][1].image.center
        with profiling.stage("prepass.regions"):
            views = get_regions_batch(arrs, (float(center.y), float(center.x)),
                                      110 / slcs[0][1].mm_per_pixel, scale08=True,
                                      clear_borders=True, minmax=False,
                                      device=self.cts[0]._device)
        if views is None:
            return  # K overflow: per-scan escalation path
        for ct, (slice_num, _), v in zip(self.cts, slcs, views):
            ct._pre_roll_regions = (slice_num, v)

    def _mtf_prepass(self) -> None:
        """Seed each scan's CTP528 ``mtf`` with the peak half of every
        line-pair setting found for all scans at once by
        :func:`find_peaks_rows` (the same result as the per-scan search).
        The valleys stay per scan: their window depends on that scan's
        peaks. Only circle-profile modules (``CTP528CP504`` and its
        subclasses) take part; the JAX package took every CTP528 here."""
        mods = [ct.ctp528 for ct in self.cts
                if isinstance(getattr(ct, "ctp528", None), CTP528CP504)
                and "mtf" not in ct.ctp528.__dict__]
        if len(mods) < 2:
            return
        profs = [np.asarray(m.circle_profile.values, np.float32) for m in mods]
        if len({p.shape for p in profs}) != 1:
            return
        stacked = np.stack(profs)
        settings = list(mods[0].roi_settings.values())
        with profiling.stage("ctp528.mtf_batch"):
            peaks_by_setting = [
                find_peaks_rows(stacked, threshold=0.3, peak_separation=value["peak spacing"],
                                max_number=value["num peaks"],
                                search_region=(value["start"], value["end"]))
                for value in settings]
        for si, m in enumerate(mods):
            maxs, mins = [], []
            for value, rows_out in zip(settings, peaks_by_setting):
                max_indices, props = rows_out[si]
                max_values = props["peak_heights"]
                if len(max_values) != value["num peaks"]:
                    break
                maxs.append(np.asarray(max_values).mean())
                _, min_values = m.circle_profile.find_valleys(
                    min_distance=value["peak spacing"], max_number=value["num valleys"],
                    search_region=(int(min(max_indices)), int(max(max_indices))))
                mins.append(min_values.mean())
            if not maxs:
                continue  # the per-scan path raises its own error
            spacings = [roi["lp/mm"] for roi in m.roi_settings.values()]
            m.__dict__["mtf"] = MTF(lp_spacings=spacings[:len(maxs)],
                                    lp_maximums=maxs, lp_minimums=mins)

    def _finalize_geometry_batch(self, device) -> None:
        """The deferred CTP404 geometry-node searches, one batched pass per
        crop shape."""
        groups: dict[tuple, list] = {}
        for ct in self.cts:
            if getattr(ct.ctp404, "_deferred_geo", None) is not None:
                groups.setdefault(ct.ctp404._deferred_geo[0].shape, []).append(ct.ctp404)
        for group in groups.values():
            crops = [m._deferred_geo[0] for m in group]
            views = get_regions_batch(crops, None, 0.0, clear_borders=False, device=device)
            for i, m in enumerate(group):
                crop, xbounds, ybounds = m._deferred_geo
                if views is None:
                    _, regions, num_roi = get_regions(crop, clear_borders=False,
                                                      device=device)
                else:
                    regions, num_roi = views[i], len(views[i])
                m._finalize_geometry(regions, num_roi, xbounds, ybounds)
                m._deferred_geo = None

    def results_data(self, as_dict: bool = False, as_json: bool = False) -> list:
        return [ct.results_data(as_dict=as_dict, as_json=as_json) for ct in self.cts]

    def results(self) -> list:
        return [ct.results() for ct in self.cts]
