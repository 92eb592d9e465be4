"""Quart DVT phantom analysis (Halcyon and Ethos CBCT QA).

Port of ``pylinac_tpu/quart.py`` (``:1-456``): the result models
(``:46-81``) as dataclasses, ``QuartHUModule`` (``:84``: HU linearity with
the optional water vial, slice thickness from the inverted air gaps, SNR and
CNR), ``HypersightQuartHUModule`` (``:155``), ``QuartUniformityModule``
(``:162``), ``QuartGeometryModule`` (``:183``: the phantom's width from
horizontal and vertical FWHM profiles of a 3x3-median slice, and the
-700 to -200 HU edge distances) and ``QuartDVT`` (``:247``: its own
``_is_right_area``, ``find_phantom_roll`` and ``analyze``) with
``HypersightQuartDVT`` (``:445``, deprecated). All of it sits on the port's
CatPhan engine (:mod:`pylinac_tpu_torch.ct`).

``QuartDVT.analyze(device=None)`` runs on CUDA unless the caller passes
another device, and raises without one: there the stack's localisation and
the roll slice's ``get_regions`` launch ``csrc/ccl.cu``, and the geometry
module's 3x3 median launches ``csrc/median3x3.cu``. The modules' ROIs and
profiles stay numpy on the host. ``capture_warnings`` wraps the public
functions of each class's own body, as in JAX: ``QuartDVT.analyze``
captures the roll warnings; ``HypersightQuartDVT``'s deprecation warning,
raised in ``__init__``, is not captured.

The reports (``QuartGeometryModule.plot_rois`` ``:214``, ``QuartDVT``
``:314-433``, and what it inherits from ``CatPhanBase``: ``plot_side_view``,
the generic ``plotly_analyzed_images`` and ``to_quaac``): the plots,
``save_images`` and ``publish_pdf``, which embeds the saved images, import
matplotlib inside and raise ``ModuleNotFoundError`` where it is missing;
``plotly_analyzed_images`` needs none. As in JAX, ``to_quaac`` reaches
``CatPhanBase``'s datapoints, which read a ``ctp404`` the class has not,
and raises ``AttributeError``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from .core.geometry import Line, Point
from .core.profile import FWXMProfilePhysical
from .core.utilities import DataModel, ResultBase, resolve_device
from .core.warnings import capture_warnings
from .ct import (
    AIR,
    CTP404CP504,
    CTP486,
    WATER,
    CatPhanBase,
    CatPhanModule,
    Slice,
    get_regions,
    publish_images_pdf,
    rois_to_results,
    save_figures,
    wrapped,
)
from .ops.filters import median_filter

UNIFORMITY_OFFSET_MM = -45
GEOMETRY_OFFSET_MM = 45
ACRYLIC = 120
POLY = -35
TEFLON = 990


@dataclasses.dataclass(kw_only=True)
class QuartHUModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    measured_slice_thickness_mm: float
    signal_to_noise: float
    contrast_to_noise: float


@dataclasses.dataclass(kw_only=True)
class QuartGeometryModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    distances: dict
    high_contrast_distances: dict
    mean_high_contrast_distance: float


@dataclasses.dataclass(kw_only=True)
class QuartUniformityModuleOutput(DataModel):
    offset: int
    roi_settings: dict
    rois: dict
    passed: bool


@dataclasses.dataclass(kw_only=True)
class QuartDVTResult(ResultBase):
    phantom_model: str
    phantom_roll_deg: float
    origin_slice: int
    num_images: int
    hu_module: QuartHUModuleOutput
    uniformity_module: QuartUniformityModuleOutput
    geometric_module: QuartGeometryModuleOutput


class QuartHUModule(CTP404CP504):
    """HU linearity with the optional water vial, slice thickness and
    SNR/CNR; no geometry nodes."""

    roi_dist_mm = 52.5
    roi_radius_mm = 6
    vial_radius_mm = 12
    roi_settings = {
        "Air": {"value": AIR, "angle": -90, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Poly": {"value": POLY, "angle": 0, "distance": roi_dist_mm, "radius": roi_radius_mm},
        "Acrylic": {"value": ACRYLIC, "angle": 45, "distance": roi_dist_mm,
                    "radius": roi_radius_mm},
        "Teflon": {"value": TEFLON, "angle": 180, "distance": roi_dist_mm,
                   "radius": roi_radius_mm},
        "Water": {"value": WATER, "angle": -45, "distance": roi_dist_mm,
                  "radius": vial_radius_mm},
    }
    background_roi_settings = {}
    geometry_roi_settings = {}
    thickness_roi_height = 25
    thickness_roi_width = 15
    thickness_roi_distance_mm = 32
    thickness_roi_settings = {
        "Bottom": {"angle": 90, "width": thickness_roi_height, "height": thickness_roi_width,
                   "distance": thickness_roi_distance_mm},
        "Top": {"angle": -90, "width": thickness_roi_height, "height": thickness_roi_width,
                "distance": thickness_roi_distance_mm},
    }

    def _setup_rois(self) -> None:
        """Drop the water ROI when its slot is not water (an empty vial)."""
        super()._setup_rois()
        if "Water" in self.rois and abs(self.rois["Water"].pixel_value - 0) > 50:
            self.rois.pop("Water")

    def _setup_geometry_rois(self) -> None:
        pass  # the Quart has no geometry nodes

    def _setup_thickness_rois(self) -> None:
        """The thickness markers are air gaps, not wires: invert first."""
        self.thickness_image.invert()
        super()._setup_thickness_rois()

    @property
    def meas_slice_thickness(self) -> float:
        """The mean gap FWHM times tan(30 deg), the gaps' inclination."""
        INCLINATION_CORRECTION = 0.577
        return float(np.mean(sorted(
            roi.wire_fwhm * self.mm_per_pixel * INCLINATION_CORRECTION
            for roi in self.thickness_rois.values())) / (1 + 2 * self.pad))

    @property
    def signal_to_noise(self) -> float:
        """(HU of poly + 1000) / its standard deviation."""
        return (self.rois["Poly"].pixel_value + 1000) / self.rois["Poly"].std

    @property
    def contrast_to_noise(self) -> float:
        """|HU of poly - HU of acrylic| / acrylic's standard deviation."""
        return (abs(self.rois["Poly"].pixel_value - self.rois["Acrylic"].pixel_value)
                / self.rois["Acrylic"].std)


class HypersightQuartHUModule(QuartHUModule):
    """The Hypersight variant: the water vial is always there."""

    def _setup_rois(self) -> None:
        CTP404CP504._setup_rois(self)


class QuartUniformityModule(CTP486):
    """Uniformity: five ROIs of 10 mm, four at 53 mm and the centre."""

    common_name = "HU Uniformity"
    roi_dist_mm = 53
    roi_radius_mm = 10
    nominal_value = 120
    roi_settings = {
        "Top": {"value": nominal_value, "angle": -90, "distance": roi_dist_mm,
                "radius": roi_radius_mm},
        "Right": {"value": nominal_value, "angle": 0, "distance": roi_dist_mm,
                  "radius": roi_radius_mm},
        "Bottom": {"value": nominal_value, "angle": 90, "distance": roi_dist_mm,
                   "radius": roi_radius_mm},
        "Left": {"value": nominal_value, "angle": 180, "distance": roi_dist_mm,
                 "radius": roi_radius_mm},
        "Center": {"value": nominal_value, "angle": 0, "distance": 0,
                   "radius": roi_radius_mm},
    }


class QuartGeometryModule(CatPhanModule):
    """The phantom's size from horizontal and vertical FWHM profiles, and
    its -700 to -200 HU edge distances."""

    attr_name = "geometry_module"
    common_name = "Geometric Distortion"

    def _setup_rois(self) -> None:
        self.profiles = {}
        arr = torch.from_numpy(self.image.array.astype(np.float32)).to(self.device)
        img = median_filter(arr, 3).cpu().numpy()
        img = img - img.min()
        self.horiz_array = img[int(self.phan_center.y), :]
        prof = FWXMProfilePhysical(values=self.horiz_array, dpmm=1 / self.mm_per_pixel)
        line = Line(Point(round(prof.field_edge_idx("left")), self.phan_center.y),
                    Point(round(prof.field_edge_idx("right")), self.phan_center.y))
        self.profiles["horizontal"] = {"width (mm)": prof.field_width_mm, "line": line}
        self.vert_array = img[:, int(self.phan_center.x)]
        prof = FWXMProfilePhysical(values=self.vert_array, dpmm=1 / self.mm_per_pixel)
        line = Line(Point(self.phan_center.x, round(prof.field_edge_idx("left"))),
                    Point(self.phan_center.x, round(prof.field_edge_idx("right"))))
        self.profiles["vertical"] = {"width (mm)": prof.field_width_mm, "line": line}

    def plot_rois(self, axis) -> None:
        for profile_data in self.profiles.values():
            profile_data["line"].plot2axes(axis, width=2, color="blue")

    def distances(self) -> dict[str, float]:
        return {f"{name} mm": p["width (mm)"] for name, p in self.profiles.items()}

    def high_contrast_resolutions(self) -> dict:
        """The distance from -700 HU to -200 HU at each of the phantom's four
        edges; the stack is shifted so that -1000 HU is 0, hence 300 and
        800."""
        dists = {"Top": np.nan, "Bottom": np.nan, "Left": np.nan, "Right": np.nan}
        edge_5mm = int(5 / self.mm_per_pixel)
        keys = iter(dists)
        for array in (self.horiz_array, self.vert_array):
            split_idx = len(array) // 2
            for profile_data in (array[:split_idx], array[split_idx:][::-1]):
                edge_idx = int(np.argmax(np.diff(profile_data)))
                edge_data = profile_data[max(edge_idx - edge_5mm, 0): edge_idx + edge_5mm]
                # invert the value-to-index mapping, monotonic about the edge
                order = np.argsort(edge_data)
                idx_300, idx_800 = np.interp(
                    [300, 800], edge_data[order], np.arange(len(edge_data))[order])
                dists[next(keys)] = abs(idx_800 - idx_300) * self.mm_per_pixel
        return dists

    def mean_high_contrast_resolution(self) -> float:
        return float(np.mean(list(self.high_contrast_resolutions().values())))


@capture_warnings
class QuartDVT(CatPhanBase):
    """Quart DVT CBCT phantom analysis."""

    _model = "Quart DVT"
    hu_origin_slice_variance = 300
    catphan_radius_mm = 80
    hu_module_class = QuartHUModule
    uniformity_module_class = QuartUniformityModule
    geometry_module_class = QuartGeometryModule

    def _is_right_area(self, region) -> bool:
        """Looser area bounds than CatPhan's: the air inserts can touch the
        localiser box."""
        thresh = np.pi * ((self.air_bubble_radius_mm / self.mm_per_pixel) ** 2)
        return thresh * 2.5 > region.area_filled > thresh / 2

    def find_phantom_roll(self, func: Callable | None = None) -> float:
        """The roll from the two inserts on the vertical axis."""
        if func is not None:
            return super().find_phantom_roll(func=func)
        slice_offset = round(self.roll_slice_offset / self.dicom_stack.slice_spacing)
        slice_num = self.origin_slice + slice_offset
        slc = Slice(self, slice_num, clear_borders=self.clear_borders)
        _, regions, _ = get_regions(slc)
        x_tolerance_px = self.air_bubble_radius_mm / self.mm_per_pixel * 2
        hu_bubbles = [r for r in regions
                      if (self._is_right_area(r) and self._is_right_eccentricity(r)
                          and abs(r.centroid[1] - slc.phan_center.x) < x_tolerance_px)]
        sorted_bubbles = sorted(hu_bubbles, key=lambda x: x.centroid[0])
        if len(sorted_bubbles) < 2:
            warnings.warn("Could not reliably determine Quart phantom roll. "
                          "Setting roll to 0.", UserWarning)
            return 0.0
        y_dist = sorted_bubbles[-1].centroid[0] - sorted_bubbles[0].centroid[0]
        x_dist = sorted_bubbles[-1].centroid[1] - sorted_bubbles[0].centroid[1]
        phan_roll = float(np.rad2deg(np.arctan2(y_dist, x_dist)) - 90)
        if abs(phan_roll) > 10:
            warnings.warn("Phantom roll could not be reliably determined. "
                          "Setting roll to 0.", UserWarning)
            phan_roll = 0
        return phan_roll

    def analyze(self, hu_tolerance: float = 40, scaling_tolerance: float = 1,
                thickness_tolerance: float = 0.2, cnr_threshold: float = 5,
                x_adjustment: float = 0, y_adjustment: float = 0,
                angle_adjustment: float = 0, roi_size_factor: float = 1,
                scaling_factor: float = 1, origin_slice: int | None = None,
                roll_slice_offset: float = -8, device=None):
        """Full analysis on ``device`` (``None`` means ``"cuda"``, and raises
        when no CUDA device exists). ``cnr_threshold`` is accepted and, as
        in the JAX package, unused."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self.roll_slice_offset = roll_slice_offset
        self.localize(origin_slice=origin_slice)
        self.hu_module = self.hu_module_class(
            self, offset=0, hu_tolerance=hu_tolerance,
            thickness_tolerance=thickness_tolerance, scaling_tolerance=scaling_tolerance)
        self.uniformity_module = self.uniformity_module_class(
            self, offset=UNIFORMITY_OFFSET_MM, tolerance=hu_tolerance)
        self.geometry_module = self.geometry_module_class(
            self, tolerance=3, offset=GEOMETRY_OFFSET_MM)

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs) -> None:
        import matplotlib.pyplot as plt

        plt.figure(**plt_kwargs)
        grid_size = (2, 3)
        self.hu_module.plot(plt.subplot2grid(grid_size, (0, 1)))
        self.hu_module.plot_linearity(plt.subplot2grid(grid_size, (0, 2)))
        self.uniformity_module.plot(plt.subplot2grid(grid_size, (1, 0)))
        self.uniformity_module.plot_profiles(plt.subplot2grid(grid_size, (1, 2)))
        self.geometry_module.plot(plt.subplot2grid(grid_size, (0, 0)))
        self.plot_side_view(plt.subplot2grid(grid_size, (1, 1)))
        plt.tight_layout()
        if show:
            plt.show()

    def plot_analyzed_subimage(self, *args, **kwargs) -> None:
        raise NotImplementedError()

    def results(self, as_str: bool = True) -> str | tuple:
        items = (
            f"\n - {self._model} QA Test - \n",
            f"HU Linearity ROIs: {self.hu_module.roi_vals_as_str}\n",
            f"HU Passed?: {self.hu_module.passed_hu}\n",
            f"Measured Slice Thickness (mm): {self.hu_module.meas_slice_thickness:2.3f}\n",
            f"Slice Thickness Passed? {self.hu_module.passed_thickness}\n",
            f"Uniformity ROIs: {self.uniformity_module.roi_vals_as_str}\n",
            f"Uniformity Passed?: {self.uniformity_module.overall_passed}\n",
            f"Geometric width: {self.geometry_module.distances()}",
            f"High-Contrast distance (mm): "
            f"{self.geometry_module.mean_high_contrast_resolution():2.3f}",
        )
        return "\n".join(items) if as_str else items

    def _generate_results_data(self) -> QuartDVTResult:
        geometry = self.geometry_module
        return QuartDVTResult(
            phantom_model=self._model,
            phantom_roll_deg=self.catphan_roll,
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            uniformity_module=QuartUniformityModuleOutput(
                offset=UNIFORMITY_OFFSET_MM,
                roi_settings=self.uniformity_module.roi_settings,
                rois=rois_to_results(self.uniformity_module.rois),
                passed=self.uniformity_module.overall_passed),
            geometric_module=QuartGeometryModuleOutput(
                offset=GEOMETRY_OFFSET_MM,
                roi_settings=geometry.roi_settings,
                rois=rois_to_results(geometry.rois),
                distances=geometry.distances(),
                high_contrast_distances=geometry.high_contrast_resolutions(),
                mean_high_contrast_distance=geometry.mean_high_contrast_resolution()),
            hu_module=QuartHUModuleOutput(
                offset=0,
                roi_settings=self.hu_module.roi_settings,
                rois=rois_to_results(self.hu_module.rois),
                measured_slice_thickness_mm=self.hu_module.meas_slice_thickness,
                signal_to_noise=self.hu_module.signal_to_noise,
                contrast_to_noise=self.hu_module.contrast_to_noise))

    def plot_images(self, show: bool = True, **plt_kwargs) -> dict:
        """A figure per module and the side view: ``{name: Figure}``."""
        import matplotlib.pyplot as plt

        figs = {}
        modules = {"HU linearity": self.hu_module,
                   "HU uniformity": self.uniformity_module,
                   "Geometry": self.geometry_module}
        for key, module in modules.items():
            fig, ax = plt.subplots(**plt_kwargs)
            module.plot(ax)
            figs[key] = fig
        fig, ax = plt.subplots(**plt_kwargs)
        self.plot_side_view(ax)
        figs["side"] = fig
        if show:
            plt.show()
        return figs

    def save_images(self, directory=None, to_stream: bool = False, **plt_kwargs):
        """:meth:`plot_images` as PNG files in ``directory`` (their paths),
        or as streams (``{name: BytesIO}``)."""
        figs = self.plot_images(show=False, **plt_kwargs)
        paths = save_figures(figs, directory, to_stream)
        return dict(zip(figs, paths)) if to_stream else paths

    def publish_pdf(self, filename, notes: str | None = None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The results and a page per module image; the images need
        matplotlib."""
        images = self.save_images(to_stream=True)
        publish_images_pdf(filename, f"{self._model} Analysis",
                           wrapped(self.results(as_str=False)), (1.5, 25),
                           images.values(), notes, open_file, metadata, logo)

    def _module_offsets(self) -> list[float]:
        absolute_origin_position = self.dicom_stack[self.origin_slice].z_position
        return [absolute_origin_position + offset
                for offset in (0, UNIFORMITY_OFFSET_MM, GEOMETRY_OFFSET_MM)]

    def _detected_modules(self) -> list[CatPhanModule]:
        return [self.uniformity_module, self.hu_module, self.geometry_module]


@capture_warnings
class HypersightQuartDVT(QuartDVT):
    """Deprecated: QuartDVT handles the water vial itself now."""

    _model = "Hypersight Quart DVT"
    hu_module_class = HypersightQuartHUModule

    def __init__(self, **kwargs):
        warnings.warn(
            "This class is now deprecated. Please use the QuartDVT class "
            "instead as it now handles the water vial that differentiated "
            "this class", DeprecationWarning)
        super().__init__(**kwargs)
