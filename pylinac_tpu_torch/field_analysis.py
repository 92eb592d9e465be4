"""Field analysis (flatness, symmetry, penumbra, field size) of open-field
images and SNC Profiler exports.

Port of ``pylinac_tpu/field_analysis.py``: the protocol functions
(``:36-92``), ``Protocol`` (``:127``), ``Device`` (``:136``),
``DeviceResult`` and ``FieldResult`` (``:142-186``, dataclasses with the
pydantic models' fields, order, types and defaults), ``FieldAnalysis``
(``:189-453``: ``analyze``, ``results``, ``results_data``),
``DeviceFieldAnalysis`` (``:526-642``), ``FieldAnalysisBatch``
(``:645-913``, its ``mesh`` through :mod:`pylinac_tpu_torch.parallel.mesh`)
and ``analyze_field_batch`` (``:916``). Plots, the PDF, plotly and QuAAC
wait for ROADMAP item 11; the demo loaders are not ported.

``FieldAnalysisBatch`` is the device path. Its host staging is the JAX
class's (``:758-800``: cached beam-centre ratios, strips, central-ROI
statistics, in float64 numpy by :mod:`pylinac_tpu_torch.ops.field_host`),
so its strips equal the JAX class's bit for bit; the (B, H) and (B, W)
float32 strips and the parameters then go to the device, one call of
:func:`pylinac_tpu_torch.ops.field_pipeline.field_analysis_strips_batch`
analyses every profile there, and the result comes back in one copy.
``filter=3`` runs the 3x3 median on the constructor's device
(``csrc/median3x3.cu`` on the card), one launch for a stack of images that
share a shape.

The single-image ``FieldAnalysis`` runs its filter on ``device`` and its
profile math on the host, as the JAX package kept it there (every array is
under its ``SMALL_ELEMS``); ``DeviceFieldAnalysis`` runs on the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from enum import Enum
from math import ceil, floor

import numpy as np
import torch

from .core import image
from .core.array_utils import median3x3_array
from .core.exceptions import NotAnalyzed
from .core.geometry import Point
from .core.io import SNCProfiler
from .core.profile import Centering, Edge, Interpolation, Normalization, SingleProfile
from .core.roi import RectangleROI
from .core.utilities import ResultBase, ResultsDataMixin, convert_to_enum, resolve_device
from .ops import field_host


def flatness_dose_difference(profile: SingleProfile, in_field_ratio: float = 0.8, **kwargs) -> float:
    """Varian flatness: 100·|max−min|/(max+min) (reference ``field_analysis.py:37``)."""
    dmax = profile.field_calculation(
        in_field_ratio=in_field_ratio, calculation="max",
        slope_exclusion_ratio=kwargs.get("slope_exclusion_ratio", 0.2))
    dmin = profile.field_calculation(
        in_field_ratio=in_field_ratio, calculation="min",
        slope_exclusion_ratio=kwargs.get("slope_exclusion_ratio", 0.2))
    return 100 * abs(dmax - dmin) / (dmax + dmin)


def flatness_dose_ratio(profile: SingleProfile, in_field_ratio: float = 0.8, **kwargs) -> float:
    """Elekta flatness: 100·max/min (reference ``field_analysis.py:60``)."""
    dmax = profile.field_calculation(in_field_ratio=in_field_ratio, calculation="max")
    dmin = profile.field_calculation(in_field_ratio=in_field_ratio, calculation="min")
    return 100 * (dmax / dmin)


def symmetry_point_difference(profile: SingleProfile, in_field_ratio: float, **kwargs) -> float:
    """Varian symmetry: max point difference about the CAX, % of CAX value."""
    field = profile.field_data(
        in_field_ratio=in_field_ratio,
        slope_exclusion_ratio=kwargs.get("slope_exclusion_ratio", 0.2))
    field_values = field["field values"]
    cax_value = field["beam center value (@rounded)"]
    sym_vals = [100 * (lt - rt) / cax_value
                for lt, rt in zip(field_values, field_values[::-1])]
    return sym_vals[int(np.argmax(np.abs(sym_vals)))]


def symmetry_pdq_iec(profile: SingleProfile, in_field_ratio: float, **kwargs) -> float:
    """Elekta symmetry: max point-difference-quotient (IEC), signed."""
    field = profile.field_data(
        in_field_ratio=in_field_ratio,
        slope_exclusion_ratio=kwargs.get("slope_exclusion_ratio", 0.2))
    field_values = field["field values"]

    def calc_sym(lt, rt) -> float:
        sym1 = lt / rt
        sym2 = rt / lt
        sign = np.sign(sym1) if abs(sym1) > abs(sym2) else np.sign(sym2)
        return max(abs(lt / rt), abs(rt / lt)) * sign

    sym_values = [calc_sym(lt, rt) for lt, rt in zip(field_values, field_values[::-1])]
    return sym_values[int(np.argmax(np.abs(sym_values)))]


def symmetry_area(profile: SingleProfile, in_field_ratio: float, **kwargs) -> float:
    """Siemens symmetry: area ratio about the beam center."""
    data = profile.field_data(
        in_field_ratio=in_field_ratio,
        slope_exclusion_ratio=kwargs.get("slope_exclusion_ratio", 0.2))
    n = len(data["field values"])
    area_left = np.sum(data["field values"][: floor(n / 2)])
    area_right = np.sum(data["field values"][ceil(n / 2):])
    return 100 * (area_left - area_right) / (area_left + area_right)


varian_protocol = {
    "symmetry": {"calc": symmetry_point_difference, "unit": "%"},
    "flatness": {"calc": flatness_dose_difference, "unit": "%"},
}
elekta_protocol = {
    "symmetry": {"calc": symmetry_pdq_iec, "unit": ""},
    "flatness": {"calc": flatness_dose_ratio, "unit": ""},
}
siemens_protocol = {
    "symmetry": {"calc": symmetry_area, "unit": ""},
    "flatness": {"calc": flatness_dose_difference, "unit": ""},
}


class Protocol(Enum):
    """Protocols for flatness/symmetry definitions."""

    NONE = {}  #:
    VARIAN = varian_protocol  #:
    SIEMENS = siemens_protocol  #:
    ELEKTA = elekta_protocol  #:


class Device(Enum):
    """Supported measurement devices."""

    PROFILER = {"device": SNCProfiler, "detector spacing (mm)": 5}  #:


@dataclasses.dataclass(kw_only=True)
class DeviceResult(ResultBase):
    """Typed results of :class:`DeviceFieldAnalysis`, in the JAX model's
    field order."""

    protocol: str
    protocol_results: dict
    centering_method: str | None
    normalization_method: str | None
    interpolation_method: str | None
    edge_detection_method: str
    top_penumbra_mm: float
    bottom_penumbra_mm: float
    left_penumbra_mm: float
    right_penumbra_mm: float
    geometric_center_index_x_y: tuple[float, float]
    beam_center_index_x_y: tuple[float, float]
    field_size_vertical_mm: float
    field_size_horizontal_mm: float
    beam_center_to_top_mm: float
    beam_center_to_bottom_mm: float
    beam_center_to_left_mm: float
    beam_center_to_right_mm: float
    cax_to_top_mm: float
    cax_to_bottom_mm: float
    cax_to_left_mm: float
    cax_to_right_mm: float
    top_position_index_x_y: tuple[float, float]
    top_horizontal_distance_from_cax_mm: float
    top_vertical_distance_from_cax_mm: float
    top_horizontal_distance_from_beam_center_mm: float
    top_vertical_distance_from_beam_center_mm: float
    left_slope_percent_mm: float
    right_slope_percent_mm: float
    top_slope_percent_mm: float
    bottom_slope_percent_mm: float
    top_penumbra_percent_mm: float = 0
    bottom_penumbra_percent_mm: float = 0
    left_penumbra_percent_mm: float = 0
    right_penumbra_percent_mm: float = 0

    def __post_init__(self):
        super().__post_init__()
        # pydantic's coercion: each pair element a float, numpy scalars in
        # the protocol results as Python floats
        for name in ("geometric_center_index_x_y", "beam_center_index_x_y",
                     "top_position_index_x_y"):
            setattr(self, name, tuple(float(v) for v in getattr(self, name)))
        self.protocol_results = {k: float(v) for k, v in self.protocol_results.items()}


@dataclasses.dataclass(kw_only=True)
class FieldResult(DeviceResult):
    """Typed results of :class:`FieldAnalysis` and of each image of
    :class:`FieldAnalysisBatch` (reference ``field_analysis.py:412``)."""

    central_roi_mean: float = 0
    central_roi_max: float = 0
    central_roi_std: float = 0
    central_roi_min: float = 0


class FieldAnalysis(ResultsDataMixin):
    """Analyze an open-field image for flatness/symmetry/penumbra/field size.

    ``filter`` (a median size) runs on ``device`` (``None`` means CUDA; a 3x3
    median launches ``csrc/median3x3.cu`` there); the profiles are analysed
    on the host."""

    def __init__(self, path, filter: int | None = None, image_kwargs: dict | None = None,
                 device=None):
        self._path = path
        self.image = image.load(path, **(image_kwargs or {}))
        if filter:
            self.image.filter(size=filter, device=device)
        self._is_analyzed = False
        self._from_device = False
        self.image.check_inversion_by_histogram()

    def _determine_center(self, centering: Centering) -> tuple[float, float]:
        vert_sum = np.sum(self.image.array, axis=1)
        horiz_sum = np.sum(self.image.array, axis=0)
        v_prof = SingleProfile(vert_sum)
        h_prof = SingleProfile(horiz_sum)
        if centering == Centering.GEOMETRIC_CENTER:
            horiz_ratio = v_prof.geometric_center()["index (exact)"] / self.image.shape[0]
            vert_ratio = h_prof.geometric_center()["index (exact)"] / self.image.shape[1]
        else:
            horiz_ratio = v_prof.beam_center()["index (exact)"] / self.image.shape[0]
            vert_ratio = h_prof.beam_center()["index (exact)"] / self.image.shape[1]
        return vert_ratio, horiz_ratio

    def _get_vert_values(self, vert_position: float, vert_width: float):
        w = self.image.array.shape[1]
        left_edge = max(int(round(w * vert_position - w * vert_width / 2)), 0)
        right_edge = min(int(round(w * vert_position + w * vert_width / 2)) + 1, w)
        return np.mean(self.image.array[:, left_edge:right_edge], 1), left_edge, right_edge

    def _get_horiz_values(self, horiz_position: float, horiz_width: float):
        h = self.image.array.shape[0]
        bottom_edge = max(int(round(h * horiz_position - h * horiz_width / 2)), 0)
        top_edge = min(int(round(h * horiz_position + h * horiz_width / 2)) + 1, h)
        return np.mean(self.image.array[bottom_edge:top_edge, :], 0), bottom_edge, top_edge

    def _extract_profiles(self, horiz_position, horiz_width,
                          interpolation_resolution_mm, vert_position, vert_width,
                          edge_detection_method, edge_smoothing_ratio, ground,
                          interpolation, normalization_method, centering,
                          hill_window_ratio) -> None:
        if centering in (Centering.BEAM_CENTER, Centering.GEOMETRIC_CENTER):
            vert_position, horiz_position = self._determine_center(centering)
        kw = dict(dpmm=self.image.dpmm, interpolation=interpolation,
                  interpolation_resolution_mm=interpolation_resolution_mm, ground=ground,
                  edge_detection_method=edge_detection_method,
                  normalization_method=normalization_method,
                  edge_smoothing_ratio=edge_smoothing_ratio,
                  hill_window_ratio=hill_window_ratio)
        horiz_values, self._upper_h_index, self._lower_h_index = self._get_horiz_values(
            horiz_position, horiz_width)
        self.horiz_profile = SingleProfile(horiz_values, **kw)
        vert_values, self._left_v_index, self._right_v_index = self._get_vert_values(
            vert_position, vert_width)
        self.vert_profile = SingleProfile(vert_values, **kw)

    def analyze(self, protocol: Protocol = Protocol.VARIAN,
                centering: Centering | str = Centering.BEAM_CENTER,
                vert_position: float = 0.5, horiz_position: float = 0.5,
                vert_width: float = 0, horiz_width: float = 0,
                in_field_ratio: float = 0.8, slope_exclusion_ratio: float = 0.2,
                invert: bool = False, is_FFF: bool = False,
                penumbra: tuple[float, float] = (20, 80),
                interpolation: Interpolation | str | None = Interpolation.LINEAR,
                interpolation_resolution_mm: float = 0.1, ground: bool = True,
                normalization_method: Normalization | str = Normalization.BEAM_CENTER,
                edge_detection_method: Edge | str = Edge.INFLECTION_DERIVATIVE,
                edge_smoothing_ratio: float = 0.003,
                hill_window_ratio: float = 0.15, **kwargs) -> None:
        """Analyze the field image, with the reference's parameter semantics
        (``field_analysis.py:565``)."""
        edge_detection_method = convert_to_enum(edge_detection_method, Edge)
        if is_FFF and edge_detection_method == Edge.FWHM:
            warnings.warn(
                "Using FWHM for an FFF beam is not advised. Consider using "
                "INFLECTION_DERIVATIVE or INFLECTION_HILL")
        if invert:
            self.image.invert()
        interpolation = convert_to_enum(interpolation, Interpolation)
        normalization_method = convert_to_enum(normalization_method, Normalization)
        centering = convert_to_enum(centering, Centering)

        self._protocol = protocol
        self._penumbra = penumbra
        self._centering = centering
        self._is_FFF = is_FFF
        self._edge_detection = edge_detection_method
        self._in_field_ratio = in_field_ratio
        self._slope_exclusion_ratio = slope_exclusion_ratio
        self._hill_window_ratio = hill_window_ratio
        self._interpolation_method = interpolation
        self._normalization_method = normalization_method
        self._extract_profiles(
            horiz_position, horiz_width, interpolation_resolution_mm, vert_position,
            vert_width, edge_detection_method, edge_smoothing_ratio, ground,
            interpolation, normalization_method, centering, hill_window_ratio)
        width = max(abs(self._left_v_index - self._right_v_index), 2)
        height = max(abs(self._upper_h_index - self._lower_h_index), 2)
        center = Point(width / 2 + self._left_v_index, height / 2 + self._upper_h_index)
        self.central_roi = RectangleROI(
            array=self.image.array, width=width, height=height, center=center)
        self._profile_results(in_field_ratio, slope_exclusion_ratio, penumbra, kwargs)

    def _profile_results(self, in_field_ratio, slope_exclusion_ratio, penumbra,
                         kwargs: dict) -> None:
        """The results of the two profiles, shared with
        :class:`DeviceFieldAnalysis`."""
        self._results = {}
        v_pen = self.vert_profile.penumbra(penumbra[0], penumbra[1])
        h_pen = self.horiz_profile.penumbra(penumbra[0], penumbra[1])
        self._results["top_penumbra_mm"] = v_pen["left penumbra width (exact) mm"]
        self._results["bottom_penumbra_mm"] = v_pen["right penumbra width (exact) mm"]
        self._results["left_penumbra_mm"] = h_pen["left penumbra width (exact) mm"]
        self._results["right_penumbra_mm"] = h_pen["right penumbra width (exact) mm"]
        if self._edge_detection == Edge.INFLECTION_HILL:
            self._results["top_penumbra_percent_mm"] = abs(v_pen["left gradient (exact) %/mm"])
            self._results["bottom_penumbra_percent_mm"] = abs(v_pen["right gradient (exact) %/mm"])
            self._results["left_penumbra_percent_mm"] = abs(h_pen["left gradient (exact) %/mm"])
            self._results["right_penumbra_percent_mm"] = abs(h_pen["right gradient (exact) %/mm"])
        self._results["geometric_center_index_x_y"] = (
            self.horiz_profile.geometric_center()["index (exact)"],
            self.vert_profile.geometric_center()["index (exact)"])
        self._results["beam_center_index_x_y"] = (
            self.horiz_profile.beam_center()["index (exact)"],
            self.vert_profile.beam_center()["index (exact)"])
        v_full = self.vert_profile.field_data(in_field_ratio=1.0,
                                              slope_exclusion_ratio=slope_exclusion_ratio)
        h_full = self.horiz_profile.field_data(in_field_ratio=1.0,
                                               slope_exclusion_ratio=slope_exclusion_ratio)
        self._results["field_size_vertical_mm"] = v_full["width (exact) mm"]
        self._results["field_size_horizontal_mm"] = h_full["width (exact) mm"]
        self._results["beam_center_to_top_mm"] = v_full["left distance->beam center (exact) mm"]
        self._results["beam_center_to_bottom_mm"] = v_full["right distance->beam center (exact) mm"]
        self._results["beam_center_to_left_mm"] = h_full["left distance->beam center (exact) mm"]
        self._results["beam_center_to_right_mm"] = h_full["right distance->beam center (exact) mm"]
        self._results["cax_to_top_mm"] = v_full["left distance->CAX (exact) mm"]
        self._results["cax_to_bottom_mm"] = v_full["right distance->CAX (exact) mm"]
        self._results["cax_to_left_mm"] = h_full["left distance->CAX (exact) mm"]
        self._results["cax_to_right_mm"] = h_full["right distance->CAX (exact) mm"]

        h_field = self.horiz_profile.field_data(in_field_ratio=in_field_ratio,
                                                slope_exclusion_ratio=slope_exclusion_ratio)
        v_field = self.vert_profile.field_data(in_field_ratio=in_field_ratio,
                                               slope_exclusion_ratio=slope_exclusion_ratio)
        self._results["top_position_index_x_y"] = (
            h_field['"top" index (exact)'], v_field['"top" index (exact)'])
        self._results["top_horizontal_distance_from_cax_mm"] = h_field['"top"->CAX (exact) mm']
        self._results["top_vertical_distance_from_cax_mm"] = v_field['"top"->CAX (exact) mm']
        self._results["top_horizontal_distance_from_beam_center_mm"] = h_field['"top"->beam center (exact) mm']
        self._results["top_vertical_distance_from_beam_center_mm"] = v_field['"top"->beam center (exact) mm']
        self._results["left_slope_percent_mm"] = h_field["left slope (%/mm)"]
        self._results["right_slope_percent_mm"] = h_field["right slope (%/mm)"]
        self._results["top_slope_percent_mm"] = v_field["left slope (%/mm)"]
        self._results["bottom_slope_percent_mm"] = v_field["right slope (%/mm)"]

        self._extra_results = {}
        kwargs = {**kwargs, "slope_exclusion_ratio": slope_exclusion_ratio}
        for name, item in self._protocol.value.items():
            self._extra_results[f"{name}_horizontal"] = item["calc"](
                self.horiz_profile, in_field_ratio, **kwargs)
            self._extra_results[f"{name}_vertical"] = item["calc"](
                self.vert_profile, in_field_ratio, **kwargs)
        self._is_analyzed = True

    def results(self, as_str: bool = True) -> str | list[str]:
        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        results = [
            "Field Analysis Results",
            "----------------------",
            f"File: {self._path}",
            f"Protocol: {self._protocol.name}",
        ]
        if not self._from_device:
            results += [f"Centering method: {self._centering.value}"]
        results += [
            f"Normalization method: {self.horiz_profile._norm_method.value}",
            f"Interpolation: {self.horiz_profile._interp_method.value}",
            f"Edge detection method: {self.horiz_profile._edge_method.value}",
            "",
            f"Penumbra width ({self._penumbra[0]}/{self._penumbra[1]}):",
            f"Left: {self._results['left_penumbra_mm']:3.1f}mm",
            f"Right: {self._results['right_penumbra_mm']:3.1f}mm",
            f"Top: {self._results['top_penumbra_mm']:3.1f}mm",
            f"Bottom: {self._results['bottom_penumbra_mm']:3.1f}mm",
            "",
            "Field Size:",
            f"Horizontal: {self._results['field_size_horizontal_mm']:3.1f}mm",
            f"Vertical: {self._results['field_size_vertical_mm']:3.1f}mm",
            "",
            "CAX to edge distances:",
            f"CAX -> Top edge: {self._results['cax_to_top_mm']:3.1f}mm",
            f"CAX -> Bottom edge: {self._results['cax_to_bottom_mm']:3.1f}mm",
            f"CAX -> Left edge: {self._results['cax_to_left_mm']:3.1f}mm",
            f"CAX -> Right edge: {self._results['cax_to_right_mm']:3.1f}mm",
            "",
            f"Top slope: {self._results['top_slope_percent_mm']:3.3f}%/mm",
            f"Bottom slope: {self._results['bottom_slope_percent_mm']:3.3f}%/mm",
            f"Left slope: {self._results['left_slope_percent_mm']:3.3f}%/mm",
            f"Right slope: {self._results['right_slope_percent_mm']:3.3f}%/mm",
            "",
            "Protocol data:",
            "--------------",
        ]
        for name, item in self._protocol.value.items():
            results.append(f"Vertical {name}: {self._extra_results[name + '_vertical']:3.3f}{item['unit']}")
            results.append(f"Horizontal {name}: {self._extra_results[name + '_horizontal']:3.3f}{item['unit']}")
            results.append("")
        if as_str:
            return "\n".join(results)
        return results

    def _generate_results_data(self) -> FieldResult:
        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        return FieldResult(
            **self._results,
            protocol=self._protocol.name,
            centering_method=getattr(self._centering, "value", None),
            normalization_method=self.horiz_profile._norm_method.value,
            interpolation_method=self.horiz_profile._interp_method.value,
            edge_detection_method=self.horiz_profile._edge_method.value,
            protocol_results=self._extra_results,
            central_roi_max=self.central_roi.max,
            central_roi_mean=self.central_roi.mean,
            central_roi_min=self.central_roi.min,
            central_roi_std=self.central_roi.std,
        )


class DeviceFieldAnalysis(FieldAnalysis):
    """Field analysis of measurement-device data, an SNC Profiler's
    ``.prs`` export (reference ``:1558``); on the host, its profiles hold
    about 60 detectors."""

    def __init__(self, path: str, device: Device):
        self.device = device.value["device"](path=path)
        self._path = path
        self._from_device = True
        self._is_analyzed = False

    def analyze(self, protocol: Protocol = Protocol.VARIAN,
                in_field_ratio: float = 0.8, slope_exclusion_ratio: float = 0.2,
                is_FFF: bool = False, penumbra: tuple = (20, 80),
                interpolation_resolution_mm: float = 0.1,
                normalization_method: Normalization | str = Normalization.GEOMETRIC_CENTER,
                edge_detection_method: Edge | str = Edge.INFLECTION_HILL,
                edge_smoothing_ratio: float = 0.003,
                hill_window_ratio: float = 0.15, ground: bool = True, **kwargs) -> None:
        self._protocol = protocol
        self._penumbra = penumbra
        self._centering = None
        self._is_FFF = is_FFF
        self._edge_detection = convert_to_enum(edge_detection_method, Edge)
        self._in_field_ratio = in_field_ratio
        self._slope_exclusion_ratio = slope_exclusion_ratio
        self._hill_window_ratio = hill_window_ratio
        self._interpolation_method = Interpolation.NONE
        self._normalization_method = convert_to_enum(normalization_method, Normalization)

        x_prof, y_prof, _, _ = self.device.to_profiles(
            dpmm=None, interpolation=Interpolation.NONE, ground=ground,
            edge_detection_method=self._edge_detection,
            normalization_method=self._normalization_method,
            edge_smoothing_ratio=edge_smoothing_ratio,
            hill_window_ratio=hill_window_ratio)
        # the detector spacing in mm sets dpmm
        spacing = Device.PROFILER.value["detector spacing (mm)"]
        x_prof.dpmm = 1 / spacing
        y_prof.dpmm = 1 / spacing
        self.horiz_profile = x_prof
        self.vert_profile = y_prof
        self._profile_results(in_field_ratio, slope_exclusion_ratio, penumbra, kwargs)

    def _generate_results_data(self) -> DeviceResult:
        if not self._is_analyzed:
            raise NotAnalyzed("Image is not analyzed yet. Use analyze() first.")
        return DeviceResult(
            **self._results,
            protocol=self._protocol.name,
            centering_method=None,
            normalization_method=self.horiz_profile._norm_method.value,
            interpolation_method=self.horiz_profile._interp_method.value,
            edge_detection_method=self.horiz_profile._edge_method.value,
            protocol_results=self._extra_results,
        )


# the strip pipeline's protocol names
_PROTOCOL_KINDS = {
    Protocol.VARIAN: ("difference", "point difference"),
    Protocol.ELEKTA: ("ratio", "pdq"),
    Protocol.SIEMENS: ("difference", "area"),
    Protocol.NONE: ("difference", "point difference"),
}


def _fetch(tree: dict) -> dict:
    """A dict of (B,) tensors, nested one level at most, as numpy float64
    arrays, in one device-to-host copy."""
    leaves = [(outer, inner) for outer, sub in tree.items() for inner in sub]
    stacked = torch.stack([tree[o][i].to(torch.float32) for o, i in leaves]).cpu().numpy()
    out: dict = {outer: {} for outer in tree}
    for row, (outer, inner) in zip(stacked, leaves):
        out[outer][inner] = row.astype(np.float64)
    return out


class FieldAnalysisBatch:
    """Analyze a batch of same-geometry open-field images on one device,
    every profile in one pipeline call
    (:mod:`pylinac_tpu_torch.ops.field_pipeline`).

    The batch replaces looping ``FieldAnalysis.analyze`` over a QA session
    (reference per-image semantics: ``field_analysis.py:565``). All images
    share shape and dpmm. FWHM, INFLECTION_DERIVATIVE and INFLECTION_HILL
    (masked Levenberg-Marquardt fits of every edge at once) with LINEAR
    interpolation; for the cubic spline use the single-image class.

    ``device`` is where ``filter`` runs and the default of ``analyze``
    (``None`` means CUDA)."""

    def __init__(self, images, filter: int | None = None,
                 image_kwargs: dict | None = None, device=None):
        self._device = device
        self.images = [image.load(item, **(image_kwargs or {})) for item in images]
        if not self.images:
            raise ValueError("No images were provided")
        if filter:
            self._filter(filter, resolve_device(device, "FieldAnalysisBatch"))
        for img in self.images:
            img.check_inversion_by_histogram()
        # the centring stage reads only the projections and the extrema
        # (``invert`` maps them linearly), so analyze() never re-reads the
        # frames for them
        self._col_sums = [np.asarray(i.array).sum(axis=0, dtype=np.float64)
                          for i in self.images]
        self._row_sums = [np.asarray(i.array).sum(axis=1, dtype=np.float64)
                          for i in self.images]
        self._extrema = [(float(np.min(i.array)), float(np.max(i.array)))
                         for i in self.images]
        # beam centres depend only on the loaded images and the invert flag
        self._bc_cache: dict[bool, tuple[np.ndarray, np.ndarray]] = {}
        self._is_analyzed = False

    def _filter(self, size: int, device: torch.device) -> None:
        """The images' median filter: a 3x3 median of images that share a
        shape and a dtype is one ``median3x3`` launch on the stack; anything
        else goes image by image through :meth:`BaseImage.filter`."""
        arrays = [np.asarray(img.array) for img in self.images]
        if size == 3 and len({(a.shape, a.dtype) for a in arrays}) == 1:
            for img, filtered in zip(self.images, median3x3_array(np.stack(arrays), device)):
                img.array = filtered
        else:
            for img in self.images:
                img.filter(size=size, device=device)

    def analyze(self, protocol: Protocol = Protocol.VARIAN,
                centering: Centering | str = Centering.BEAM_CENTER,
                vert_position: float = 0.5, horiz_position: float = 0.5,
                vert_width: float = 0, horiz_width: float = 0,
                in_field_ratio: float = 0.8, slope_exclusion_ratio: float = 0.2,
                invert: bool = False, is_FFF: bool = False,
                penumbra: tuple[float, float] = (20, 80),
                interpolation: Interpolation | str | None = Interpolation.LINEAR,
                interpolation_resolution_mm: float = 0.1, ground: bool = True,
                normalization_method: Normalization | str = Normalization.BEAM_CENTER,
                edge_detection_method: Edge | str = Edge.INFLECTION_DERIVATIVE,
                edge_smoothing_ratio: float = 0.003,
                hill_window_ratio: float = 0.15, mesh=None, device=None,
                **kwargs) -> None:
        """Batch equivalent of :meth:`FieldAnalysis.analyze` on ``device``
        (``None`` takes the constructor's; that ``None`` means CUDA).

        ``mesh``: a :class:`~pylinac_tpu_torch.parallel.mesh.Mesh` whose
        ``data`` axis shards the strips
        (:func:`~pylinac_tpu_torch.parallel.mesh.sharded_fa_strips_batch`;
        JAX ``field_analysis.py:698-704``, ``:813-821``); per-image results
        equal the unsharded run's. The rest runs on the mesh's first
        device, and a ``device`` that differs from it raises
        ``ValueError``."""
        from .ops.field_pipeline import FAParams, field_analysis_strips_batch

        if mesh is not None:
            from .parallel.mesh import mesh_device

            device = mesh_device(mesh, device, "FieldAnalysisBatch.analyze")
        else:
            device = resolve_device(self._device if device is None else device,
                                    "FieldAnalysisBatch.analyze")
        edge = convert_to_enum(edge_detection_method, Edge)
        interpolation = convert_to_enum(interpolation, Interpolation)
        normalization = convert_to_enum(normalization_method, Normalization)
        centering = convert_to_enum(centering, Centering)
        if interpolation != Interpolation.LINEAR:
            raise ValueError("Batch mode requires LINEAR interpolation; use FieldAnalysis")
        if is_FFF and edge == Edge.FWHM:
            warnings.warn(
                "Using FWHM for an FFF beam is not advised. Consider using "
                "INFLECTION_DERIVATIVE or INFLECTION_HILL")

        shapes = {img.shape for img in self.images}
        if len(shapes) != 1:
            raise ValueError(f"All images in a batch must share one shape; got {shapes}")
        dpmms = {round(float(img.dpmm), 6) for img in self.images}
        if len(dpmms) != 1:
            raise ValueError(f"All images in a batch must share dpmm; got {dpmms}")
        dpmm = float(self.images[0].dpmm)
        H, W = self.images[0].shape

        self._protocol = protocol
        self._centering = centering
        self._edge = edge
        self._interp = interpolation
        self._norm = normalization
        flat_name, sym_name = _PROTOCOL_KINDS[protocol]

        # host staging: the pipeline reads two 1D strips an image, so the
        # projections, the centring and the strips are numpy here
        # (reference: field_analysis.py:215-268)
        B = len(self.images)
        if centering == Centering.BEAM_CENTER:
            if bool(invert) not in self._bc_cache:
                col_sums = np.stack(self._col_sums)
                row_sums = np.stack(self._row_sums)
                if invert:
                    # invert (a -> max + min - a) maps the projections linearly
                    span = np.asarray([mn + mx for mn, mx in self._extrema])
                    col_sums = H * span[:, None] - col_sums
                    row_sums = W * span[:, None] - row_sums
                self._bc_cache[bool(invert)] = (
                    field_host.beam_center_ratio_np_batch(col_sums),
                    field_host.beam_center_ratio_np_batch(row_sums))
            v_positions, h_positions = self._bc_cache[bool(invert)]
        elif centering == Centering.GEOMETRIC_CENTER:
            v_positions = np.full(B, ((W - 1) / 2.0) / W)
            h_positions = np.full(B, ((H - 1) / 2.0) / H)
        else:
            v_positions = np.full(B, vert_position)
            h_positions = np.full(B, horiz_position)

        vert_strips = np.empty((B, H), np.float32)
        horiz_strips = np.empty((B, W), np.float32)
        roi_stats: list[dict] = []
        for i, img in enumerate(self.images):
            arr = np.asarray(img.array)
            lv, rv = field_host.strip_indices(W, float(v_positions[i]), vert_width)
            uh, lh = field_host.strip_indices(H, float(h_positions[i]), horiz_width)
            vs = arr[:, lv:rv].mean(axis=1)
            hs = arr[uh:lh, :].mean(axis=0)
            stats = field_host.central_roi_stats_np(arr, lv, rv, uh, lh)
            if invert:
                mn, mx = self._extrema[i]
                vert_strips[i] = (mn + mx) - vs
                horiz_strips[i] = (mn + mx) - hs
                stats = {"mean": (mn + mx) - stats["mean"], "std": stats["std"],
                         "max": (mn + mx) - stats["min"], "min": (mn + mx) - stats["max"]}
            else:
                vert_strips[i] = vs
                horiz_strips[i] = hs
            roi_stats.append(stats)

        params = FAParams.from_vector(
            (dpmm, in_field_ratio, slope_exclusion_ratio, penumbra[0], penumbra[1],
             vert_position, horiz_position, vert_width, horiz_width), device)
        static = dict(
            samples_v=int(round(H / (dpmm * interpolation_resolution_mm))),
            samples_h=int(round(W / (dpmm * interpolation_resolution_mm))),
            edge=edge.value, centering=centering.value, normalization=normalization.value,
            flatness=flat_name, symmetry=sym_name, ground=ground,
            edge_smoothing_ratio=edge_smoothing_ratio, hill_window_ratio=hill_window_ratio)
        if mesh is not None:
            from .parallel.mesh import sharded_fa_strips_batch

            out = sharded_fa_strips_batch(vert_strips, horiz_strips, params, mesh, **static)
        else:
            out = field_analysis_strips_batch(
                torch.from_numpy(vert_strips).to(device),
                torch.from_numpy(horiz_strips).to(device), params, **static)
        self._out = _fetch(out)
        self._out["central_roi"] = {
            k: np.asarray([s[k] for s in roi_stats], np.float64)
            for k in ("mean", "std", "max", "min")}
        self._is_analyzed = True

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """Per-image :class:`FieldResult` list from the fetched arrays."""
        if not self._is_analyzed:
            raise NotAnalyzed("The batch is not analyzed. Use analyze() first.")
        results = [self._image_result(i) for i in range(len(self.images))]
        if as_dict:
            return [r.model_dump() for r in results]
        if as_json:
            return [r.model_dump_json() for r in results]
        return results

    def _image_result(self, i: int) -> FieldResult:
        v = {k: float(a[i]) for k, a in self._out["vert"].items()}
        h = {k: float(a[i]) for k, a in self._out["horiz"].items()}
        roi = {k: float(a[i]) for k, a in self._out["central_roi"].items()}
        extra = {}
        for name in self._protocol.value:  # the single path's key order
            extra[f"{name}_horizontal"] = h[name]
            extra[f"{name}_vertical"] = v[name]
        grads = {}
        if self._edge == Edge.INFLECTION_HILL:
            grads = dict(
                top_penumbra_percent_mm=v["penumbra_left_grad_pct_mm"],
                bottom_penumbra_percent_mm=v["penumbra_right_grad_pct_mm"],
                left_penumbra_percent_mm=h["penumbra_left_grad_pct_mm"],
                right_penumbra_percent_mm=h["penumbra_right_grad_pct_mm"])
        return FieldResult(
            **grads,
            protocol=self._protocol.name,
            protocol_results=extra,
            centering_method=getattr(self._centering, "value", None),
            normalization_method=self._norm.value,
            interpolation_method=self._interp.value,
            edge_detection_method=self._edge.value,
            top_penumbra_mm=v["penumbra_left_mm"],
            bottom_penumbra_mm=v["penumbra_right_mm"],
            left_penumbra_mm=h["penumbra_left_mm"],
            right_penumbra_mm=h["penumbra_right_mm"],
            geometric_center_index_x_y=(h["geometric_center_idx"], v["geometric_center_idx"]),
            beam_center_index_x_y=(h["beam_center_idx"], v["beam_center_idx"]),
            field_size_vertical_mm=v["field_size_mm"],
            field_size_horizontal_mm=h["field_size_mm"],
            beam_center_to_top_mm=v["bc_to_left_mm"],
            beam_center_to_bottom_mm=v["bc_to_right_mm"],
            beam_center_to_left_mm=h["bc_to_left_mm"],
            beam_center_to_right_mm=h["bc_to_right_mm"],
            cax_to_top_mm=v["cax_to_left_mm"],
            cax_to_bottom_mm=v["cax_to_right_mm"],
            cax_to_left_mm=h["cax_to_left_mm"],
            cax_to_right_mm=h["cax_to_right_mm"],
            top_position_index_x_y=(h["top_idx"], v["top_idx"]),
            top_horizontal_distance_from_cax_mm=h["top_to_cax_mm"],
            top_vertical_distance_from_cax_mm=v["top_to_cax_mm"],
            top_horizontal_distance_from_beam_center_mm=h["top_to_bc_mm"],
            top_vertical_distance_from_beam_center_mm=v["top_to_bc_mm"],
            left_slope_percent_mm=h["left_slope_pct_mm"],
            right_slope_percent_mm=h["right_slope_pct_mm"],
            top_slope_percent_mm=v["left_slope_pct_mm"],
            bottom_slope_percent_mm=v["right_slope_pct_mm"],
            central_roi_mean=roi["mean"],
            central_roi_max=roi["max"],
            central_roi_min=roi["min"],
            central_roi_std=roi["std"],
        )


def analyze_field_batch(images, **analyze_kwargs) -> list[FieldResult]:
    """Load, analyze and return each image's :class:`FieldResult` in one
    call; ``filter``, ``image_kwargs`` and ``device`` go to the
    constructor."""
    init_keys = ("filter", "image_kwargs", "device")
    init_kwargs = {k: analyze_kwargs.pop(k) for k in init_keys if k in analyze_kwargs}
    batch = FieldAnalysisBatch(images, **init_kwargs)
    batch.analyze(**analyze_kwargs)
    return batch.results_data()
