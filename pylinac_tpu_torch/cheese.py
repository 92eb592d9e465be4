"""'Cheese' electron-density phantom analysis: TomoCheese and the CIRS 062M.

Port of ``pylinac_tpu/cheese.py``: the result models ``CheeseResult``
(``:26``) and ``TomoCheeseResult`` (``:33``) as dataclasses,
``CheeseModule`` (``:58``), ``TomoCheeseModule`` (``:76``),
``CheesePhantomBase`` (``:108``: ``analyze(roi_config=...)``, the roll from
the outer ring's highest insert, ``results``), ``TomoCheese`` (``:250``),
``CIRSHUModule`` (``:271``) and ``CIRS062M`` (``:301``, with its own
``find_origin_slice`` ``:317-350``). All of it sits on the port's CatPhan
engine (:mod:`pylinac_tpu_torch.ct`).

``analyze(device=None)`` runs on CUDA unless the caller passes another
device, and raises without one: the stack's localisation launches
``csrc/ccl.cu`` (label and hole modes) on the pooled stack, and CIRS's
origin-slice search one label and one holes launch at B = 1 for each
image it looks at (every other slice, one ``Slice`` each, as in JAX). The
ROIs and profiles stay numpy on the host. ``capture_warnings`` wraps the
public functions of each class's own body, as in JAX: TomoCheese's body
has none, CIRS's ``find_origin_slice``; the roll finder prints, as JAX's.

The reports (``CheeseModule.plot_rois`` ``:71``, ``CheesePhantomBase``
``:158-238`` with ``plot_density_curve`` ``:174``): the plots and
``publish_pdf``, which embeds the analysed image, import matplotlib inside
and raise ``ModuleNotFoundError`` where it is missing; ``to_quaac`` and
the generic ``plotly_analyzed_images`` (``CatPhanBase``'s) need none. Not
ported: the demo loaders.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .core.profile import CollapsedCircleProfile
from .core.roi import DiskROI
from .core.scale import wrap360
from .core.utilities import QuaacDatum, ResultBase, resolve_device
from .core.warnings import capture_warnings
from .ct import CatPhanBase, CatPhanModule, Slice


@dataclasses.dataclass(kw_only=True)
class CheeseResult(ResultBase):
    origin_slice: int
    num_images: int
    phantom_roll: float
    rois: dict


@dataclasses.dataclass(kw_only=True)
class TomoCheeseResult(CheeseResult):
    """With explicit roi_N fields for backwards compatibility."""

    roi_1: dict
    roi_2: dict
    roi_3: dict
    roi_4: dict
    roi_5: dict
    roi_6: dict
    roi_7: dict
    roi_8: dict
    roi_9: dict
    roi_10: dict
    roi_11: dict
    roi_12: dict
    roi_13: dict
    roi_14: dict
    roi_15: dict
    roi_16: dict
    roi_17: dict
    roi_18: dict
    roi_19: dict
    roi_20: dict


class CheeseModule(CatPhanModule):
    """A single-slice module of bolt-hole plugs."""

    common_name: str
    roi_settings: dict

    def _setup_rois(self) -> None:
        for name, setting in self.roi_settings.items():
            self.rois[name] = DiskROI.from_phantom_center(
                self.image, setting["angle_corrected"],
                setting["radius_pixels"], setting["distance_pixels"],
                self.phan_center)

    def plot_rois(self, axis) -> None:
        for name, roi in self.rois.items():
            roi.plot2axes(axis, edgecolor="blue", text=name)


class TomoCheeseModule(CheeseModule):
    """Tomo Cheese: 20 plugs on an inner (65 mm) and an outer (110 mm) ring."""

    common_name = "Tomo Cheese"
    inner_roi_dist_mm = 65
    outer_roi_dist_mm = 110
    roi_radius_mm = 12
    roi_settings = {
        "1": {"angle": -75, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "2": {"angle": -67.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "3": {"angle": -45, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "4": {"angle": -22.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "5": {"angle": -15, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "6": {"angle": 15, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "7": {"angle": 22.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "8": {"angle": 45, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "9": {"angle": 67.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "10": {"angle": 75, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "11": {"angle": 105, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "12": {"angle": 112.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "13": {"angle": 135, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "14": {"angle": 157.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "15": {"angle": 165, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "16": {"angle": -165, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "17": {"angle": -157.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "18": {"angle": -135, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
        "19": {"angle": -112.5, "distance": inner_roi_dist_mm, "radius": roi_radius_mm},
        "20": {"angle": -105, "distance": outer_roi_dist_mm, "radius": roi_radius_mm},
    }


class CheesePhantomBase(CatPhanBase):
    """The single-module cheese phantom engine."""

    model: str
    module_class: type[CheeseModule]
    clip_in_localization = True

    def analyze(self, roi_config: dict | None = None, x_adjustment: float = 0,
                y_adjustment: float = 0, angle_adjustment: float = 0,
                roi_size_factor: float = 1, scaling_factor: float = 1,
                origin_slice: int | None = None, device=None) -> None:
        """Full analysis on ``device`` (``None`` means ``"cuda"``, and raises
        when no CUDA device exists). ``roi_config`` maps ROI names to their
        known densities ({"1": {"density": 1.1}, ...}) and is kept, as in
        the JAX package, for the density curve."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.x_adjustment = x_adjustment
        self.y_adjustment = y_adjustment
        self.angle_adjustment = angle_adjustment
        self.roi_size_factor = roi_size_factor
        self.scaling_factor = scaling_factor
        self.roll_slice_offset = 0
        self.localize(origin_slice=origin_slice)
        self.module = self.module_class(self, clear_borders=self.clear_borders)
        self.roi_config = roi_config

    def _roi_angles(self) -> list[float]:
        return [wrap360(s["angle"]) for s in self.module_class.roi_settings.values()]

    def _ensure_physical_scan_extent(self) -> bool:
        return True  # only one module

    def find_phantom_roll(self, func: Callable | None = None) -> float:
        """The roll from the outer ring's highest insert against its nearest
        nominal angle; 0, with a printed note, past 5 degrees or without a
        peak."""
        slc = Slice(self, self.origin_slice, clear_borders=self.clear_borders)
        circle = CollapsedCircleProfile(
            slc.phan_center, self.localization_radius / self.mm_per_pixel,
            slc.image.array, ccw=False, width_ratio=0.05, num_profiles=5)
        # peaks only; air pockets cause bad range shifts
        circle.values = np.where(circle.values < 0, 0, circle.values)
        peak_idxs, _ = circle.find_fwxm_peaks(max_number=1)
        if len(peak_idxs):
            angle = peak_idxs[0] / len(circle) * 360
            shifts = [angle - a for a in self._roi_angles()]
            min_shift = shifts[int(np.argmin([abs(s) for s in shifts]))]
            if -5 < min_shift < 5:
                return float(min_shift)
            print(f"Detected shift of {min_shift} was >5 degrees; automatic "
                  "roll compensation aborted. Setting roll to 0.")
            return 0
        print("No low-HU regions found in the outer ROI circle; automatic "
              "roll compensation aborted. Setting roll to 0.")
        return 0

    def plot_analyzed_image(self, show: bool = True, **plt_kwargs) -> None:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(**plt_kwargs)
        self.module.plot(ax)
        plt.tight_layout()
        if show:
            plt.show()

    def results(self, as_list: bool = False) -> str | list[str]:
        results = [f" - {self.model} Phantom Analysis - ", " - HU Module - "]
        results += [f"ROI {name} median: {roi.pixel_value:.1f}, stdev: {roi.std:.1f}"
                    for name, roi in self.module.rois.items()]
        return results if as_list else "\n".join(results)

    def plot_density_curve(self, show: bool = True, **plt_kwargs):
        """The known density of each configured ROI against its HU, sorted
        by density."""
        import matplotlib.pyplot as plt

        if not self.roi_config:
            raise ValueError(
                "No ROI density configuration was passed to the analyze "
                "method. Re-analyze with densities first.")
        xs, ys = [], []
        for roi_num, roi_data in self.roi_config.items():
            xs.append(roi_data["density"])
            ys.append(self.module.rois[roi_num].pixel_value)
        sorted_args = np.argsort(xs)
        xs = np.array(xs)[sorted_args]
        ys = np.array(ys)[sorted_args]
        fig, ax = plt.subplots(**plt_kwargs)
        ax.plot(xs, ys, linestyle="-.", marker="D")
        ax.set_title("Density vs HU curve")
        ax.set_ylabel("HU")
        ax.set_xlabel("Density")
        ax.grid("on")
        plt.tight_layout()
        if show:
            plt.show()

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        results_data = self.results_data(as_dict=True)
        data = {"Phantom roll": QuaacDatum(value=results_data["phantom_roll"], unit="degrees")}
        for roi_num, roi_data in results_data["rois"].items():
            data[f"ROI {roi_num}"] = QuaacDatum(value=roi_data["median"], unit="HU")
        return data

    def save_analyzed_image(self, filename, **kwargs):
        import matplotlib.pyplot as plt

        self.plot_analyzed_image(show=False, **kwargs)
        plt.savefig(filename)

    def publish_pdf(self, filename, notes: str | None = None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The ROI results and a page with the analysed image; the image
        needs matplotlib."""
        import io

        from .core import pdf

        canvas = pdf.PylinacCanvas(filename, page_title=f"{self.model} Phantom",
                                   metadata=metadata, logo=logo)
        if notes is not None:
            canvas.add_text(text="Notes:", location=(1, 4.5), font_size=14)
            canvas.add_text(text=notes, location=(1, 4))
        canvas.add_text(text=self.results(as_list=True), location=(3, 23), font_size=16)
        data = io.BytesIO()
        self.save_analyzed_image(data)
        canvas.add_new_page()
        canvas.add_image(data, location=(0, 4), dimensions=(22, 22))
        canvas.finish()
        if open_file:
            import webbrowser

            webbrowser.open(filename)

    def save_analyzed_subimage(self) -> None:
        raise NotImplementedError("There are no sub-images for cheese-like phantoms")

    def plot_analyzed_subimage(self) -> None:
        raise NotImplementedError("There are no sub-images for cheese-like phantoms")

    def _generate_results_data(self) -> CheeseResult:
        return CheeseResult(
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            phantom_roll=self.catphan_roll,
            rois={name: roi.as_dict() for name, roi in self.module.rois.items()})


@capture_warnings
class TomoCheese(CheesePhantomBase):
    """The TomoTherapy 'Cheese' phantom."""

    model = "Tomotherapy Cheese"
    air_bubble_radius_mm = 14
    localization_radius = 110
    min_num_images = 10
    catphan_radius_mm = 150
    module_class = TomoCheeseModule

    def _generate_results_data(self) -> TomoCheeseResult:
        rois = {name: roi.as_dict() for name, roi in self.module.rois.items()}
        return TomoCheeseResult(
            origin_slice=self.origin_slice,
            num_images=self.num_images,
            phantom_roll=self.catphan_roll,
            rois=rois,
            **{f"roi_{i}": rois[str(i)] for i in range(1, 21)})


class CIRSHUModule(CheeseModule):
    """CIRS 062M: 17 plugs on the centre, an inner (60 mm) and an outer
    (115 mm) ring."""

    common_name = "CIRS electron density"
    outer_radius_mm = 115
    inner_radius_mm = 60
    roi_radius_mm = 10
    roi_settings = {
        "1": {"angle": 0, "distance": 0, "radius": roi_radius_mm},
        "2": {"angle": -90, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "3": {"angle": -90, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "4": {"angle": -45, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "5": {"angle": -45, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "6": {"angle": 0, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "7": {"angle": 0, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "8": {"angle": 45, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "9": {"angle": 45, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "10": {"angle": 90, "distance": inner_radius_mm, "radius": roi_radius_mm},
        # closer to the ring; the bottom of the phantom is flatter than the top
        "11": {"angle": 90, "distance": outer_radius_mm - 5, "radius": roi_radius_mm},
        "12": {"angle": 135, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "13": {"angle": 135, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "14": {"angle": 180, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "15": {"angle": 180, "distance": outer_radius_mm, "radius": roi_radius_mm},
        "16": {"angle": -135, "distance": inner_radius_mm, "radius": roi_radius_mm},
        "17": {"angle": -135, "distance": outer_radius_mm, "radius": roi_radius_mm},
    }


@capture_warnings
class CIRS062M(CheesePhantomBase):
    """The CIRS electron density phantom (062M)."""

    model = "CIRS Electron Density (062M)"
    air_bubble_radius_mm = 30
    clear_borders = False
    hu_origin_slice_variance = 150
    localization_radius = 115
    catphan_radius_mm = 155
    min_num_images = 10
    module_class = CIRSHUModule

    def find_origin_slice(self) -> int:
        """The HU module's slice with a looser variation test than the
        CatPhan engine's: every other slice in view builds its own
        :class:`Slice`, whose region search runs at B = 1."""
        hu_slices = []
        for image_number in range(0, self.num_images, 2):
            slc = Slice(self, image_number, combine=False, clear_borders=self.clear_borders)
            if slc.is_phantom_in_view():
                circle_prof = CollapsedCircleProfile(
                    slc.phan_center, radius=self.localization_radius / self.mm_per_pixel,
                    image_array=slc.image.array, width_ratio=0.05, num_profiles=5)
                prof = circle_prof.values
                low_end, high_end = np.percentile(prof, [2, 98])
                median = np.median(prof)
                middle_variation = np.percentile(prof, 60) - np.percentile(prof, 40)
                variation_limit = max(
                    100, self.dicom_stack.metadata.SliceThickness * -100 + 300)
                # as in JAX: "and" binds tighter than "or"
                if ((low_end < median - self.hu_origin_slice_variance)
                        or (high_end > median + self.hu_origin_slice_variance)
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
        raise ValueError("The origin slice was not within the image extent")
