"""1D profiles: what the CatPhan, field, VMAT and Quart analyses read, on
the host.

Port of part of ``pylinac_tpu/core/profile.py``: ``_interp1d`` (``:51``),
``ProfileMixin`` (``:65-99``: ``invert``, ``bit_invert``, ``normalize``,
``stretch``, ``convert_to_dtype``, ``ground``, ``filter``, ``__len__``,
``__getitem__``), the enums ``Interpolation``, ``Normalization``, ``Edge``
and ``Centering`` (``:102-125``), the new-style profiles (``:143-517``:
``ProfileBase`` with ``normalization=`` and ``interpolation_order=``,
``x_idx_at_x``, ``y_at_x``, ``x_at_y``, ``field_indices``,
``field_x_values``, ``center_idx``, ``geometric_center_idx``,
``cax_index``, ``field_values``, ``as_resampled`` and ``resample_to``;
``FWXMProfile``, ``InflectionDerivativeProfile`` and ``HillProfile``;
``PhysicalProfileMixin`` with ``gamma`` and its three ``*Physical``
classes), the legacy ``SingleProfile`` (``:519-963``: resampling with the
half-pixel offset, normalisation, the memo cache, ``fwxm_data``,
``field_data``, ``inflection_data`` by derivative and by Hill fits,
``penumbra``, ``field_calculation``), ``MultiProfile.find_peaks``,
``.find_valleys`` and ``.find_fwxm_peaks`` (``:994-1040``),
``CircleProfile`` with ``roll`` and ``CollapsedCircleProfile``
(``:1043-1200``), ``ProfileBase.compute`` (``:265``, the metrics of
:mod:`pylinac_tpu_torch.metrics.profile`), ``SingleProfile.resample``
(``:584``) and ``SingleProfile.gamma`` (``:965``); of the plots, the
circle profiles' ``plot2axes`` (``:1132``, ``:1185``), which the CatPhan
reports draw, with matplotlib imported inside. Peaks
come from :mod:`pylinac_tpu_torch.ops.peaks`, the smoothing from
:mod:`pylinac_tpu_torch.ops.filters`, the spline and the zoom from
:mod:`pylinac_tpu_torch.ops.interp` and the profile gammas from
:mod:`pylinac_tpu_torch.ops.gamma`, all on the CPU, where the profiles
live.
"""

from __future__ import annotations

import copy
import enum
import math
from functools import cached_property

import numpy as np
import torch

from . import array_utils as utils
from .geometry import Circle, Point
from .hill import Hill
from .utilities import convert_to_enum
from ..ops import filters
from ..ops.gamma import gamma_1d, gamma_geometric
from ..ops.interp import cubic_spline_interp, zoom1d
from ..ops.peaks import find_peaks

LEFT = "left"
RIGHT = "right"


def _interp_linear_extrap(x, xp, fp):
    """Linear interpolation with linear extrapolation (UnivariateSpline k=1 s=0)."""
    x = np.asarray(x, dtype=float)
    inner = np.interp(x, xp, fp)
    left_slope = (fp[1] - fp[0]) / (xp[1] - xp[0])
    right_slope = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
    out = np.where(x < xp[0], fp[0] + (x - xp[0]) * left_slope, inner)
    return np.where(x > xp[-1], fp[-1] + (x - xp[-1]) * right_slope, out)


def _interp1d(xp, fp, kind: str = "linear"):
    """scipy ``interp1d`` equivalent: linear with linear extrapolation, or
    the float32 not-a-knot cubic spline."""
    xp = np.asarray(xp, dtype=float)
    fp = np.asarray(fp, dtype=float)
    if kind == "linear":
        return lambda x: _interp_linear_extrap(x, xp, fp)
    if kind == "cubic":
        def cubic(x):
            out = cubic_spline_interp(torch.from_numpy(xp), torch.from_numpy(fp),
                                      torch.from_numpy(np.atleast_1d(np.asarray(x, np.float32))))
            return out.numpy().reshape(np.shape(x))
        return cubic
    raise ValueError(f"Unknown interpolation kind {kind}")


class ProfileMixin:
    """Manipulations of 1D profile data."""

    values: np.ndarray

    def invert(self) -> None:
        self.values = utils.invert(self.values)

    def bit_invert(self) -> None:
        self.values = utils.bit_invert(self.values)

    def normalize(self, norm_val: str | float | None = None) -> None:
        if norm_val == "max":
            norm_val = None
        self.values = utils.normalize(self.values, value=norm_val)

    def stretch(self, min: float = 0, max: float = 1) -> None:
        self.values = utils.stretch(self.values, min=min, max=max)

    def convert_to_dtype(self, dtype) -> None:
        self.values = utils.convert_to_dtype(self.values, dtype=dtype)

    def ground(self) -> float:
        min_val = self.values.min()
        self.values = utils.ground(self.values)
        return min_val

    def filter(self, size: float = 0.05, kind: str = "median") -> None:
        # 1D profiles stay on the CPU, where the JAX package kept arrays of
        # up to 2**18 elements (pylinac_tpu/ops/route.py:22)
        self.values = utils.filter(self.values, size=size, kind=kind, device="cpu")

    def __len__(self):
        return len(self.values)

    def __getitem__(self, items):
        return self.values[items]


class Interpolation(enum.Enum):
    NONE = None  #:
    LINEAR = "Linear"  #:
    SPLINE = "Spline"  #:


class Normalization(enum.Enum):
    NONE = None  #:
    GEOMETRIC_CENTER = "Geometric center"  #:
    BEAM_CENTER = "Beam center"  #:
    MAX = "Max"  #:


class Edge(enum.Enum):
    FWHM = "FWHM"  #:
    INFLECTION_DERIVATIVE = "Inflection Derivative"  #:
    INFLECTION_HILL = "Inflection Hill"  #:


class Centering(enum.Enum):
    MANUAL = "Manual"  #:
    BEAM_CENTER = "Beam center"  #:
    GEOMETRIC_CENTER = "Geometric center"  #:


class ProfileBase(ProfileMixin):
    """Base of the single-peak profiles: values over sorted x values,
    grounded and normalised on request; ``interpolation_order`` 1 is
    linear, any other the cubic spline."""

    def __init__(self, values, x_values=None, ground: bool = False,
                 normalization=Normalization.NONE, interpolation_order: int = 1):
        values = np.asarray(values)
        if values.ndim != 1:
            raise ValueError("Values must be 1D")
        self.metrics: list = []
        self.metric_values: dict[str, float] = {}
        self._interp_order = interpolation_order
        if x_values is None:
            x_values = np.arange(len(values), dtype=float)
        x_values = np.asarray(x_values, dtype=float)
        x_diff = np.diff(x_values)
        if len(x_diff) and x_diff.max() > 0 > x_diff.min():
            raise ValueError("X values must be monotonically increasing or decreasing")
        sort_idxs = np.argsort(x_values)
        self.x_values = x_values[sort_idxs]
        self.values = values[sort_idxs]
        if ground:
            self.values = utils.ground(self.values)
        normalization = convert_to_enum(normalization, Normalization)
        if normalization == Normalization.MAX:
            self.normalize()
        elif normalization == Normalization.GEOMETRIC_CENTER:
            self.normalize(utils.geometric_center_value(self.values))
        elif normalization == Normalization.BEAM_CENTER:
            self.normalize(self.y_at_x(self.center_idx))

    def _kind(self) -> str:
        return "linear" if self._interp_order == 1 else "cubic"

    def x_at_x_idx(self, x) -> float | np.ndarray:
        out = _interp1d(np.arange(len(self.x_values)), self.x_values, kind=self._kind())(x)
        return float(out) if np.size(out) == 1 else out

    def x_idx_at_x(self, x: float) -> int:
        return int(np.argmin(np.abs(self.x_values - x)))

    def y_at_x(self, x) -> float | np.ndarray:
        out = _interp1d(self.x_values, self.values, kind=self._kind())(x)
        return float(out) if np.size(out) == 1 else out

    def x_at_y(self, y, side: str) -> float | np.ndarray:
        """The x where the ``side`` half of the profile takes the value
        ``y`` (linear, over that half's values sorted)."""
        s = self.x_idx_at_x(self.center_idx)
        if side == LEFT:
            vals, xs = self.values[:s], self.x_values[:s]
        else:
            vals, xs = self.values[s:], self.x_values[s:]
        order = np.argsort(vals)
        out = np.interp(y, vals[order], xs[order])
        return float(out) if np.size(out) == 1 else out

    def field_edge_idx(self, side: str) -> float:
        raise NotImplementedError

    def field_indices(self, in_field_ratio: float) -> tuple[float, float, float]:
        xs = self.field_x_values(in_field_ratio)
        left, right = xs[0], xs[-1]
        return left, right, max(right, left) - min(right, left)

    def field_x_values(self, in_field_ratio: float) -> np.ndarray:
        """The x values inside the central ``in_field_ratio`` of the field."""
        left = self.field_edge_idx(side=LEFT)
        right = self.field_edge_idx(side=RIGHT)
        width = self.field_width_px
        f_left = left + (1 - in_field_ratio) / 2 * width
        f_right = right - (1 - in_field_ratio) / 2 * width
        lower = math.floor(min((f_left, f_right)))
        upper = math.ceil(max((f_left, f_right)))
        inner = np.nonzero((self.x_values >= lower) & (self.x_values <= upper))[0]
        return self.x_values[inner]

    @cached_property
    def center_idx(self) -> float:
        left = self.field_edge_idx(side=LEFT)
        right = self.field_edge_idx(side=RIGHT)
        return abs(right - left) / 2 + left

    @cached_property
    def geometric_center_idx(self) -> float:
        return self.x_at_x_idx(utils.geometric_center_idx(self.values))

    @cached_property
    def cax_index(self) -> float:
        return self.x_at_x_idx((len(self.x_values) - 1) / 2)

    @cached_property
    def field_width_px(self) -> float:
        left = self.field_edge_idx(side=LEFT)
        right = self.field_edge_idx(side=RIGHT)
        return max(right, left) - min(right, left)

    def field_values(self, in_field_ratio: float = 0.8) -> np.ndarray:
        return self.y_at_x(self.field_x_values(in_field_ratio))

    def as_resampled(self, interpolation_factor: float = 10, order: int = 3, **kwargs):
        """A profile of the same type, zoomed by ``interpolation_factor``
        (scipy ``zoom``, float32) over the same x range."""
        new_y = zoom1d(np.asarray(self.values, np.float32), interpolation_factor, order=order)
        new_x = np.linspace(self.x_values.min(), self.x_values.max(), len(new_y))
        return type(self)(values=new_y, x_values=new_x, ground=False,
                          normalization=Normalization.NONE, **kwargs)

    def resample_to(self, target_profile):
        """This profile linearly interpolated at another's x values (its
        physical ones where either is physical); a physical profile gives
        its non-physical base type."""
        if isinstance(target_profile, PhysicalProfileMixin):
            target_x = target_profile.physical_x_values
        else:
            target_x = target_profile.x_values
        self_x = self.physical_x_values if isinstance(self, PhysicalProfileMixin) else self.x_values
        if target_x.min() < self_x.min() - 1e-9 or target_x.max() > self_x.max() + 1e-9:
            raise ValueError(
                "The target profile x-values are outside this profile's range. "
                f"self: {self_x.min()} to {self_x.max()}; target: {target_x.min()} to {target_x.max()}")
        target_y = np.interp(target_x, self_x, self.values)
        if isinstance(self, PhysicalProfileMixin):
            output_type = self.__class__.__bases__[-1]
        else:
            output_type = self.__class__
        return output_type(values=target_y, x_values=np.asarray(target_x, dtype=float))

    def compute(self, metrics):
        """Run a metric or a list of them on this profile: one value, or a
        dict by name; a name taken already gets the suffix 2, 3, ..."""
        from ..metrics.profile import ProfileMetric

        values = {}
        if isinstance(metrics, ProfileMetric):
            metrics = [metrics]
        for metric in metrics:
            metric.inject_profile(self)
            self.metrics.append(metric)
            key = metric.full_name
            suffix = 1
            while key in values or key in self.metric_values:
                suffix += 1
                key = f"{metric.full_name}{suffix}"
            values[key] = metric.calculate()
        self.metric_values.update(values)
        if len(values) == 1:
            return values[key]
        return values


class FWXMProfile(ProfileBase):
    """Field edges at the full width at ``fwxm_height`` % of the maximum."""

    def __init__(self, values, x_values=None, ground: bool = False,
                 normalization=Normalization.NONE, fwxm_height: float = 50):
        self.fwxm_height = fwxm_height
        super().__init__(values=values, x_values=x_values, ground=ground,
                         normalization=normalization)

    def field_edge_idx(self, side: str) -> float:
        _, props = find_peaks(self.values, fwxm_height=self.fwxm_height / 100,
                              max_number=1)
        idx = props["left_ips"][0] if side == LEFT else props["right_ips"][0]
        return self.x_at_x_idx(idx)

    def as_resampled(self, interpolation_factor: float = 10, order: int = 3) -> FWXMProfile:
        return super().as_resampled(interpolation_factor=interpolation_factor,
                                    order=order, fwxm_height=self.fwxm_height)


class InflectionDerivativeProfile(ProfileBase):
    """Field edges at the extrema of the smoothed profile's derivative."""

    def __init__(self, values, x_values=None, ground: bool = False,
                 normalization=Normalization.NONE, edge_smoothing_ratio: float = 0.003):
        self.edge_smoothing_ratio = edge_smoothing_ratio
        super().__init__(values=values, x_values=x_values, ground=ground,
                         normalization=normalization)

    def _refine_extremum(self, f, x0: float, lo: float, hi: float, maximize: bool) -> float:
        """The extremum of ``f`` near ``x0``: 801 points over +-2, then a
        parabola through the best and its neighbours."""
        xs = np.linspace(max(lo, x0 - 2), min(hi, x0 + 2), 801)
        ys = f(xs)
        i = int(np.argmax(ys) if maximize else np.argmin(ys))
        if 0 < i < len(xs) - 1:
            y0, y1, y2 = ys[i - 1], ys[i], ys[i + 1]
            denom = y0 - 2 * y1 + y2
            if denom != 0:
                return xs[i] + 0.5 * (y0 - y2) / denom * (xs[1] - xs[0])
        return xs[i]

    def field_edge_idx(self, side: str) -> float:
        filtered = filters.gaussian_filter1d(
            torch.from_numpy(np.asarray(self.values, np.float32)),
            sigma=self.edge_smoothing_ratio * len(self.values)).numpy()
        diff = np.gradient(filtered)
        f = _interp1d(self.x_values, diff, kind="cubic")
        lo, hi = self.x_values.min(), self.x_values.max()
        if side == LEFT:
            guess = self.x_at_x_idx(np.argmax(diff))
            return self._refine_extremum(f, guess, lo, hi, maximize=True)
        guess = self.x_at_x_idx(np.argmin(diff))
        return self._refine_extremum(f, guess, lo, hi, maximize=False)

    def as_resampled(self, interpolation_factor: float = 10, order: int = 3):
        return ProfileBase.as_resampled(
            self, interpolation_factor=interpolation_factor, order=order,
            edge_smoothing_ratio=self.edge_smoothing_ratio)


class HillProfile(InflectionDerivativeProfile):
    """Field edges at the inflection of a Hill sigmoid fitted over a window
    (``hill_window_ratio`` of the field width) about each derivative edge."""

    def __init__(self, values, x_values=None, ground: bool = False,
                 normalization=Normalization.NONE, edge_smoothing_ratio: float = 0.003,
                 hill_window_ratio: float = 0.1):
        self.hill_window_ratio = hill_window_ratio
        super().__init__(values=values, x_values=x_values, ground=ground,
                         normalization=normalization,
                         edge_smoothing_ratio=edge_smoothing_ratio)

    def field_edge_idx(self, side: str) -> float:
        left_infl = super().field_edge_idx(side=LEFT)
        right_infl = super().field_edge_idx(side=RIGHT)
        window = (right_infl - left_infl) * self.hill_window_ratio
        edge = left_infl if side == LEFT else right_infl
        left_idx = self.x_idx_at_x(edge - window)
        right_idx = self.x_idx_at_x(edge + window)
        hill = Hill.fit(self.x_values[left_idx: right_idx + 1],
                        self.values[left_idx: right_idx + 1])
        return hill.inflection_idx()["index (exact)"]

    def as_resampled(self, interpolation_factor: float = 10, order: int = 3):
        return ProfileBase.as_resampled(
            self, interpolation_factor=interpolation_factor, order=order,
            edge_smoothing_ratio=self.edge_smoothing_ratio,
            hill_window_ratio=self.hill_window_ratio)


class PhysicalProfileMixin:
    """Physical (mm) x values for a profile of known ``dpmm``."""

    def __init__(self, dpmm: float | None):
        self.dpmm = dpmm
        self.implicit_dpmm = np.mean(np.diff(self.x_values)) if dpmm is None else dpmm

    @property
    def physical_x_values(self) -> np.ndarray:
        """Pixel centres in mm (x / dpmm plus half a pixel)."""
        if self.dpmm is None:
            return self.x_values
        return self.x_values / self.dpmm + 0.5 / self.dpmm

    @cached_property
    def field_width_mm(self) -> float:
        return self.field_width_px / self.implicit_dpmm

    def gamma(self, evaluation_profile, dose_to_agreement: float = 3,
              distance_to_agreement: float = 3, gamma_cap_value: float = 2,
              dose_threshold: float = 5, fill_value: float = np.nan,
              return_profiles: bool = False):
        """The geometric 1D gamma against another physical profile, both
        centred on their geometric centres, on the CPU (the profiles live
        there, as in the JAX package)."""
        if not isinstance(evaluation_profile, PhysicalProfileMixin):
            raise ValueError("The evaluation profile must also be a physical profile.")
        reference = copy.deepcopy(self)
        evaluation = copy.deepcopy(evaluation_profile)
        reference.x_values = reference.x_values - reference.geometric_center_idx
        evaluation.x_values = evaluation.x_values - evaluation.geometric_center_idx
        g = gamma_geometric(
            reference=np.asarray(reference.values, np.float32),
            reference_coordinates=np.asarray(reference.physical_x_values, np.float32),
            evaluation=np.asarray(evaluation.values, np.float32),
            evaluation_coordinates=np.asarray(evaluation.physical_x_values, np.float32),
            dose_to_agreement=dose_to_agreement, distance_to_agreement=distance_to_agreement,
            gamma_cap_value=gamma_cap_value, dose_threshold=dose_threshold,
            fill_value=fill_value, device="cpu").numpy()
        if return_profiles:
            return g, reference, evaluation
        return g

    def as_resampled(self, interpolation_resolution_mm: float = 0.1,
                     order: int = 3, **kwargs):
        """A profile of the same type at ``interpolation_resolution_mm``,
        its x values kept half-pixel-correct."""
        new_y = zoom1d(np.asarray(self.values, np.float32),
                       (1 / interpolation_resolution_mm) / self.dpmm, order=order)
        n_new = len(new_y)
        offset = 0.5 - 1 / (2 * (n_new / len(self.values)))
        new_x = np.linspace(self.x_values[0] - offset, self.x_values[-1] + offset, n_new)
        return self.__class__(values=new_y, x_values=new_x,
                              dpmm=1 / interpolation_resolution_mm, **kwargs)


class FWXMProfilePhysical(PhysicalProfileMixin, FWXMProfile):
    def __init__(self, values, dpmm: float | None = None, x_values=None,
                 ground: bool = False, normalization=Normalization.NONE,
                 fwxm_height: float = 50, **kwargs):
        FWXMProfile.__init__(self, values=values, x_values=x_values, ground=ground,
                             normalization=normalization, fwxm_height=fwxm_height)
        PhysicalProfileMixin.__init__(self, dpmm=dpmm)

    def as_resampled(self, interpolation_resolution_mm: float = 0.1, order: int = 3):
        return PhysicalProfileMixin.as_resampled(
            self, interpolation_resolution_mm=interpolation_resolution_mm,
            order=order, fwxm_height=self.fwxm_height)


class InflectionDerivativeProfilePhysical(PhysicalProfileMixin, InflectionDerivativeProfile):
    def __init__(self, values, dpmm: float | None = None, x_values=None,
                 ground: bool = False, normalization=Normalization.NONE,
                 edge_smoothing_ratio: float = 0.003, **kwargs):
        InflectionDerivativeProfile.__init__(
            self, values=values, x_values=x_values, ground=ground,
            normalization=normalization, edge_smoothing_ratio=edge_smoothing_ratio)
        PhysicalProfileMixin.__init__(self, dpmm=dpmm)

    def as_resampled(self, interpolation_resolution_mm: float = 0.1, order: int = 3):
        return PhysicalProfileMixin.as_resampled(
            self, interpolation_resolution_mm=interpolation_resolution_mm,
            order=order, edge_smoothing_ratio=self.edge_smoothing_ratio)


class HillProfilePhysical(PhysicalProfileMixin, HillProfile):
    def __init__(self, values, dpmm: float | None = None, x_values=None,
                 ground: bool = False, normalization=Normalization.NONE,
                 edge_smoothing_ratio: float = 0.003, hill_window_ratio: float = 0.1,
                 **kwargs):
        HillProfile.__init__(
            self, values=values, x_values=x_values, ground=ground,
            normalization=normalization, edge_smoothing_ratio=edge_smoothing_ratio,
            hill_window_ratio=hill_window_ratio)
        PhysicalProfileMixin.__init__(self, dpmm=dpmm)

    def as_resampled(self, interpolation_resolution_mm: float = 0.1, order: int = 3):
        return PhysicalProfileMixin.as_resampled(
            self, interpolation_resolution_mm=interpolation_resolution_mm,
            order=order, edge_smoothing_ratio=self.edge_smoothing_ratio,
            hill_window_ratio=self.hill_window_ratio)


class SingleProfile(ProfileMixin):
    """Single-peak profile with dict-based outputs (reference ``:1119``)."""

    def __init__(self, values: np.ndarray, dpmm: float = None,
                 interpolation=Interpolation.LINEAR, ground: bool = True,
                 interpolation_resolution_mm: float = 0.1,
                 interpolation_factor: float = 10,
                 normalization_method=Normalization.BEAM_CENTER,
                 edge_detection_method=Edge.FWHM,
                 edge_smoothing_ratio: float = 0.003,
                 hill_window_ratio: float = 0.1,
                 x_values: np.ndarray | None = None,
                 centering=Centering.BEAM_CENTER):
        self._interp_method = convert_to_enum(interpolation, Interpolation)
        self._interpolation_res = interpolation_resolution_mm
        self._interpolation_factor = interpolation_factor
        self._norm_method = convert_to_enum(normalization_method, Normalization)
        self._edge_method = convert_to_enum(edge_detection_method, Edge)
        self._edge_smoothing_ratio = edge_smoothing_ratio
        self._hill_window_ratio = hill_window_ratio
        self._centering = convert_to_enum(centering, Centering)
        self.values = np.asarray(values)
        self.dpmm = dpmm
        fitted_values, _, x_indices = self._interpolate(
            np.asarray(values), x_values, dpmm, interpolation_resolution_mm,
            interpolation_factor, self._interp_method)
        self.values = fitted_values
        self.x_indices = x_indices
        self._ground = ground
        if ground:
            fitted_values = fitted_values - fitted_values.min()
        self.values = self._normalize(fitted_values, self._norm_method)

    # -- interpolation machinery -------------------------------------------
    def _x_interp_to_original(self, location):
        out = _interp_linear_extrap(location, np.arange(len(self.x_indices)),
                                    self.x_indices)
        return float(out) if np.size(out) == 1 else out

    def _y_original_to_interp(self, location):
        out = _interp_linear_extrap(location, self.x_indices, self.values)
        return float(out) if np.size(out) == 1 else out

    def _sample_points_in_physical_window(self, left_edge: float, right_edge: float):
        lower, upper = sorted((left_edge, right_edge))
        start = int(np.searchsorted(self.x_indices, lower, side="left"))
        stop = int(np.searchsorted(self.x_indices, upper, side="right"))
        if stop - start < 3:
            left_idx = int(np.abs(self.x_indices - lower).argmin())
            right_idx = int(np.abs(self.x_indices - upper).argmin())
            start = min(left_idx, right_idx)
            stop = max(left_idx, right_idx) + 1
        if stop - start < 3:
            center = int(np.abs(self.x_indices - (lower + upper) / 2).argmin())
            start = max(0, center - 1)
            stop = min(len(self.x_indices), start + 3)
            start = max(0, stop - 3)
        x_samples = self.x_indices[start:stop]
        return x_samples, self._y_original_to_interp(x_samples)

    def resample(self, interpolation_factor: int = 10,
                 interpolation_resolution_mm: float = 0.1) -> "SingleProfile":
        """A new profile of these (already resampled) values at a new factor
        or resolution, with this one's settings."""
        dpmm = 1 / self._interpolation_res if self.dpmm else None
        return SingleProfile(
            values=self.values, x_values=self.x_indices, dpmm=dpmm,
            interpolation=self._interp_method, ground=self._ground,
            interpolation_resolution_mm=interpolation_resolution_mm,
            interpolation_factor=interpolation_factor,
            normalization_method=self._norm_method,
            edge_detection_method=self._edge_method,
            edge_smoothing_ratio=self._edge_smoothing_ratio,
            hill_window_ratio=self._hill_window_ratio)

    @staticmethod
    def _interpolate(values, x_values, dpmm, interpolation_resolution,
                     interpolation_factor, interp_method: Interpolation):
        """Resample to a fixed resolution with the half-pixel offset
        correction (the reference's 'BMF', ``core/profile.py:1329-1360``)."""
        if x_values is None:
            x_values = np.arange(len(values), dtype=float)
        if np.diff(x_values).min() < 0:
            raise ValueError("Profile values must be monotonically increasing")
        if interp_method == Interpolation.NONE:
            return values, dpmm, x_values
        if dpmm is not None:
            samples = int(round(len(x_values) / (dpmm * interpolation_resolution)))
            new_dpmm = 1 / interpolation_resolution
        else:
            samples = int(round(len(x_values) * interpolation_factor))
            new_dpmm = None
        offset = 0.5 - 1 / (2 * (samples / len(values)))
        kind = "linear" if interp_method == Interpolation.LINEAR else "cubic"
        f = _interp1d(x_values, values, kind=kind)
        new_x = np.linspace(x_values[0] - offset, x_values[-1] + offset, num=samples)
        return np.asarray(f(new_x)), new_dpmm, new_x

    def _normalize(self, values, method: Normalization) -> np.ndarray:
        if method == Normalization.NONE:
            return values
        if method == Normalization.MAX:
            return values / values.max()
        if method == Normalization.GEOMETRIC_CENTER:
            return values / self._geometric_center(values)["value (exact)"]
        # beam_center() reads self.values: set it for the call
        old = self.values
        self.values = values
        try:
            return values / self.beam_center()["value (@rounded)"]
        finally:
            self.values = old if old is not values else values

    def _geometric_center(self, values) -> dict:
        return {
            "index (exact)": self._x_interp_to_original(utils.geometric_center_idx(values)),
            "value (exact)": utils.geometric_center_value(values),
        }

    def _memoized(self, key: tuple, compute):
        """Memoise a computation keyed by a cheap fingerprint of the values,
        so the metric queries (flatness, symmetry, penumbra, width all read
        the field and inflection data) compute it once."""
        cache = getattr(self, "_memo_cache", None)
        if cache is None:
            cache = self._memo_cache = {}
        v = self.values
        # the position-weighted sum catches pure shifts that leave the
        # plain sum and the end samples unchanged
        fp = (v.shape[0], float(v[0]), float(v[-1]),
              float(v[v.shape[0] // 2]), float(v.sum()),
              float(np.dot(np.asarray(v, dtype=np.float64),
                           np.arange(v.shape[0], dtype=np.float64))))
        full_key = (key, fp)
        if full_key not in cache:
            cache[full_key] = compute()
        result = cache[full_key]
        return dict(result) if isinstance(result, dict) else result

    def geometric_center(self) -> dict:
        return self._geometric_center(self.values)

    def beam_center(self) -> dict:
        if self._edge_method == Edge.FWHM:
            data = self.fwxm_data(x=50)
            return {
                "index (rounded)": data["center index (rounded)"],
                "index (exact)": data["center index (exact)"],
                "value (@rounded)": data["center value (@rounded)"],
            }
        infl = self.inflection_data()
        mid = infl["left index (exact)"] + (
            infl["right index (exact)"] - infl["left index (exact)"]) / 2
        return {
            "index (rounded)": int(round(mid)),
            "index (exact)": mid,
            "value (@rounded)": self._y_original_to_interp(int(round(mid))),
        }

    def fwxm_data(self, x: int = 50) -> dict:
        return self._memoized(("fwxm", x), lambda: self._fwxm_data(x))

    def _fwxm_data(self, x: int = 50) -> dict:
        _, peak_props = find_peaks(self.values, fwxm_height=x / 100, max_number=1)
        left_idx = float(self._x_interp_to_original(peak_props["left_ips"][0]))
        right_idx = float(self._x_interp_to_original(peak_props["right_ips"][0]))
        width = right_idx - left_idx
        center_idx = (right_idx - left_idx) / 2 + left_idx
        data = {
            "width (exact)": width,
            "width (rounded)": int(round(width)),
            "center index (rounded)": int(round(center_idx)),
            "center index (exact)": center_idx,
            "center value (@rounded)": float(self._y_original_to_interp(int(round(center_idx)))),
            "left index (exact)": left_idx,
            "left index (rounded)": int(round(left_idx)),
            "left value (@rounded)": float(self._y_original_to_interp(int(round(left_idx)))),
            "right index (exact)": right_idx,
            "right index (rounded)": int(round(right_idx)),
            "right value (@rounded)": float(self._y_original_to_interp(int(round(right_idx)))),
            "field values": self._y_original_to_interp(
                self.x_indices[int(round(left_idx)): int(round(right_idx))]),
            "peak_props": peak_props,
        }
        if self.dpmm:
            data["width (exact) mm"] = data["width (exact)"] / self.dpmm
            data["left distance (exact) mm"] = abs(
                data["center index (exact)"] - data["left index (exact)"]) / self.dpmm
            data["right distance (exact) mm"] = abs(
                data["right index (exact)"] - data["center index (exact)"]) / self.dpmm
        return data

    def field_data(self, in_field_ratio: float = 0.8, slope_exclusion_ratio=0.2) -> dict:
        return self._memoized(
            ("field", in_field_ratio, slope_exclusion_ratio),
            lambda: self._field_data(in_field_ratio, slope_exclusion_ratio))

    def _field_data(self, in_field_ratio: float = 0.8, slope_exclusion_ratio=0.2) -> dict:
        if slope_exclusion_ratio >= in_field_ratio:
            raise ValueError("The exclusion region must be smaller than the field ratio")
        if self._edge_method == Edge.FWHM:
            data = self.fwxm_data(x=50)
            beam_center_idx = data["center index (exact)"]
            full_width = data["width (exact)"]
        else:
            data = self.inflection_data()
            beam_center_idx = self.beam_center()["index (exact)"]
            full_width = data["right index (exact)"] - data["left index (exact)"]
        beam_center_idx_r = int(round(beam_center_idx))
        cax_idx = self.geometric_center()["index (exact)"]
        cax_idx_r = int(round(cax_idx))

        center_idx = cax_idx if self._centering == Centering.GEOMETRIC_CENTER else beam_center_idx

        field_left_idx = center_idx - in_field_ratio * full_width / 2
        field_right_idx = center_idx + in_field_ratio * full_width / 2
        field_width = field_right_idx - field_left_idx

        inner_left_idx = center_idx - slope_exclusion_ratio * field_width / 2
        inner_right_idx = center_idx + slope_exclusion_ratio * field_width / 2

        left_x, left_y = self._sample_points_in_physical_window(field_left_idx, inner_left_idx)
        right_x, right_y = self._sample_points_in_physical_window(inner_right_idx, field_right_idx)
        left_fit = np.polyfit(left_x, left_y, deg=1)
        right_fit = np.polyfit(right_x, right_y, deg=1)

        top_x, top_y = self._sample_points_in_physical_window(inner_left_idx, inner_right_idx)
        fit_params = np.polyfit(top_x, top_y, deg=2)
        # the parabola's vertex, clipped to the window (the reference
        # minimises the negative polynomial within bounds)
        if fit_params[0] != 0:
            vertex = -fit_params[1] / (2 * fit_params[0])
        else:
            vertex = (top_x[0] + top_x[-1]) / 2
        if fit_params[0] < 0:  # opens downward: the interior vertex is the max
            top_idx = float(np.clip(vertex, top_x[0], top_x[-1]))
        else:  # opens upward: the max is at one of the ends
            y_ends = np.polyval(fit_params, [top_x[0], top_x[-1]])
            top_idx = float(top_x[0] if y_ends[0] >= y_ends[1] else top_x[-1])
        top_val = float(np.polyval(fit_params, top_idx))

        pixel_offset = center_idx - int(round(center_idx))
        x_shifted = self.x_indices + pixel_offset
        x_index_min = int(np.abs(x_shifted - field_left_idx).argmin())
        x_index_max = int(np.abs(x_shifted - field_right_idx).argmin())

        data = {
            "width (exact)": field_width,
            "beam center index (exact)": beam_center_idx,
            "beam center index (rounded)": beam_center_idx_r,
            "beam center value (@rounded)": self._y_original_to_interp(round(beam_center_idx)),
            "cax index (exact)": cax_idx,
            "cax index (rounded)": cax_idx_r,
            "cax value (@rounded)": self._y_original_to_interp(round(cax_idx)),
            "left index (exact)": field_left_idx,
            "left index (rounded)": int(round(field_left_idx)),
            "left value (@rounded)": self._y_original_to_interp(round(field_left_idx)),
            "left slope": left_fit[0],
            "left intercept": left_fit[1],
            "right slope": right_fit[0],
            "right intercept": right_fit[1],
            "left inner index (exact)": inner_left_idx,
            "left inner index (rounded)": int(round(inner_left_idx)),
            "right inner index (exact)": inner_right_idx,
            "right inner index (rounded)": int(round(inner_right_idx)),
            '"top" index (exact)': top_idx,
            '"top" index (rounded)': int(round(top_idx)),
            '"top" value (@exact)': top_val,
            "top params": fit_params,
            "right index (exact)": field_right_idx,
            "right index (rounded)": int(round(field_right_idx)),
            "right value (@rounded)": self._y_original_to_interp(round(field_right_idx)),
            "field values": self._y_original_to_interp(x_shifted[x_index_min: x_index_max + 1]),
        }
        if self.dpmm:
            data["width (exact) mm"] = data["width (exact)"] / self.dpmm
            data["left slope (%/mm)"] = data["left slope"] * self.dpmm * 100
            data["right slope (%/mm)"] = data["right slope"] * self.dpmm * 100
            data["left distance->beam center (exact) mm"] = abs(
                beam_center_idx - field_left_idx) / self.dpmm
            data["right distance->beam center (exact) mm"] = abs(
                field_right_idx - beam_center_idx) / self.dpmm
            data["left distance->CAX (exact) mm"] = abs(cax_idx - field_left_idx) / self.dpmm
            data["right distance->CAX (exact) mm"] = abs(cax_idx - field_right_idx) / self.dpmm
            data["left distance->top (exact) mm"] = abs(top_idx - field_left_idx) / self.dpmm
            data["right distance->top (exact) mm"] = abs(top_idx - field_right_idx) / self.dpmm
            data['"top"->beam center (exact) mm'] = (top_idx - beam_center_idx) / self.dpmm
            data['"top"->CAX (exact) mm'] = abs(top_idx - cax_idx) / self.dpmm
        return data

    def inflection_data(self) -> dict:
        return self._memoized(("inflection",), self._inflection_data)

    def _inflection_data(self) -> dict:
        if self._edge_method == Edge.FWHM:
            raise ValueError(
                "FWHM edge method does not have inflection points. Use a different edge detection method")
        smoothed = filters.gaussian_filter1d(
            torch.from_numpy(np.asarray(self.values, np.float32)),
            sigma=self._edge_smoothing_ratio * len(self.values))
        d1 = np.gradient(smoothed.numpy())
        peak_idxs, _ = MultiProfile(d1).find_peaks(threshold=0.8)
        valley_idxs, _ = MultiProfile(d1).find_valleys(threshold=0.8)
        left_idx = self._x_interp_to_original(peak_idxs[0])
        right_idx = self._x_interp_to_original(valley_idxs[-1])
        if self._edge_method == Edge.INFLECTION_DERIVATIVE:
            return {
                "left index (rounded)": int(round(left_idx)),
                "left index (exact)": left_idx,
                "right index (rounded)": int(round(right_idx)),
                "right index (exact)": right_idx,
                "left value (@rounded)": self._y_original_to_interp(int(round(left_idx))),
                "left value (@exact)": self._y_original_to_interp(left_idx),
                "right value (@rounded)": self._y_original_to_interp(int(round(right_idx))),
                "right value (@exact)": self._y_original_to_interp(right_idx),
            }
        # Hill: a sigmoid fitted around each derivative edge
        half_window = int(round(self._hill_window_ratio * abs(right_idx - left_idx) / 2))
        x_data = np.array([x for x in np.arange(left_idx - half_window,
                                                left_idx + half_window) if x >= 0])
        left_hill = Hill.fit(x_data, self._y_original_to_interp(x_data))
        left_infl = left_hill.inflection_idx()
        x_data = np.array([x for x in np.arange(right_idx - half_window,
                                                right_idx + half_window) if x < len(d1)])
        right_hill = Hill.fit(x_data, self._y_original_to_interp(x_data))
        right_infl = right_hill.inflection_idx()
        return {
            "left index (rounded)": left_infl["index (rounded)"],
            "left index (exact)": left_infl["index (exact)"],
            "right index (rounded)": right_infl["index (rounded)"],
            "right index (exact)": right_infl["index (exact)"],
            "left value (@exact)": left_hill.y(left_infl["index (exact)"]),
            "right value (@exact)": right_hill.y(right_infl["index (exact)"]),
            "left Hill params": left_hill.params,
            "right Hill params": right_hill.params,
        }

    def penumbra(self, lower: int = 20, upper: int = 80) -> dict:
        if lower > upper:
            raise ValueError("Upper penumbra value must be larger than the lower")
        if self._edge_method == Edge.FWHM:
            upper_data = self.fwxm_data(x=upper)
            lower_data = self.fwxm_data(x=lower)
            data = {
                f"left {lower}% index (exact)": lower_data["left index (exact)"],
                f"left {lower}% value (@rounded)": lower_data["left value (@rounded)"],
                f"left {upper}% index (exact)": upper_data["left index (exact)"],
                f"left {upper}% value (@rounded)": upper_data["left value (@rounded)"],
                f"right {lower}% index (exact)": lower_data["right index (exact)"],
                f"right {lower}% value (@rounded)": lower_data["right value (@rounded)"],
                f"right {upper}% index (exact)": upper_data["right index (exact)"],
                f"right {upper}% value (@rounded)": upper_data["right value (@rounded)"],
                "left values": self.values[lower_data["left index (rounded)"]: upper_data["left index (rounded)"]],
                "right values": self.values[upper_data["right index (rounded)"]: lower_data["right index (rounded)"]],
                "left penumbra width (exact)": abs(
                    upper_data["left index (exact)"] - lower_data["left index (exact)"]),
                "right penumbra width (exact)": abs(
                    upper_data["right index (exact)"] - lower_data["right index (exact)"]),
            }
            if self.dpmm:
                data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
                data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            return data
        if self._edge_method == Edge.INFLECTION_DERIVATIVE:
            infl = self.inflection_data()
            vmax = self.values.max()
            lower_left_pct = max(infl["left value (@exact)"] / vmax * lower / 50 * 100, 1)
            upper_left_pct = min(infl["left value (@exact)"] / vmax * upper / 50 * 100, 99)
            upper_left = self.fwxm_data(x=upper_left_pct)
            lower_left = self.fwxm_data(x=lower_left_pct)
            lower_right_pct = max(infl["right value (@exact)"] / vmax * lower / 50 * 100, 1)
            upper_right_pct = min(infl["right value (@exact)"] / vmax * upper / 50 * 100, 99)
            upper_right = self.fwxm_data(x=upper_right_pct)
            lower_right = self.fwxm_data(x=lower_right_pct)
            data = {
                f"left {lower}% index (exact)": lower_left["left index (exact)"],
                f"left {upper}% index (exact)": upper_left["left index (exact)"],
                f"right {lower}% index (exact)": lower_right["right index (exact)"],
                f"right {upper}% index (exact)": upper_right["right index (exact)"],
                "left values": self._y_original_to_interp(np.arange(
                    lower_left["left index (rounded)"], upper_left["left index (rounded)"])),
                "right values": self._y_original_to_interp(np.arange(
                    upper_right["right index (rounded)"], lower_right["right index (rounded)"])),
                "left penumbra width (exact)": abs(
                    upper_left["left index (exact)"] - lower_left["left index (exact)"]),
                "right penumbra width (exact)": abs(
                    upper_right["right index (exact)"] - lower_right["right index (exact)"]),
            }
            if self.dpmm:
                data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
                data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            return data
        # INFLECTION_HILL
        infl = self.inflection_data()
        left_hill = Hill.from_params(infl["left Hill params"])
        right_hill = Hill.from_params(infl["right Hill params"])
        lower_left_pct = infl["left value (@exact)"] * lower / 50
        lower_left_idx = left_hill.x(lower_left_pct)
        upper_left_pct = infl["left value (@exact)"] * upper / 50
        upper_left_idx = left_hill.x(upper_left_pct)
        lower_right_val = infl["right value (@exact)"] * lower / 50
        lower_right_idx = right_hill.x(lower_right_val)
        upper_right_val = infl["right value (@exact)"] * upper / 50
        upper_right_idx = right_hill.x(upper_right_val)
        data = {
            f"left {lower}% index (exact)": lower_left_idx,
            f"left {lower}% value (exact)": lower_left_pct,
            f"left {upper}% index (exact)": upper_left_idx,
            f"left {upper}% value (exact)": upper_left_pct,
            f"right {lower}% index (exact)": lower_right_idx,
            f"right {lower}% value (exact)": lower_right_val,
            f"right {upper}% index (exact)": upper_right_idx,
            f"right {upper}% value (exact)": upper_right_val,
            "left values": self.values[int(round(lower_left_idx)): int(round(upper_left_idx))],
            "right values": self.values[int(round(upper_right_idx)): int(round(lower_right_idx))],
            "left penumbra width (exact)": abs(upper_left_idx - lower_left_idx),
            "right penumbra width (exact)": abs(upper_right_idx - lower_right_idx),
            "left gradient (exact)": left_hill.gradient_at(infl["left index (exact)"]),
            "right gradient (exact)": right_hill.gradient_at(infl["right index (exact)"]),
        }
        if self.dpmm:
            data["left penumbra width (exact) mm"] = data["left penumbra width (exact)"] / self.dpmm
            data["left gradient (exact) %/mm"] = data["left gradient (exact)"] * self.dpmm * 100
            data["right penumbra width (exact) mm"] = data["right penumbra width (exact)"] / self.dpmm
            data["right gradient (exact) %/mm"] = data["right gradient (exact)"] * self.dpmm * 100
        return data

    def field_calculation(self, in_field_ratio: float = 0.8, calculation: str = "mean",
                          slope_exclusion_ratio: float = 0.2):
        field = self.field_data(in_field_ratio, slope_exclusion_ratio=slope_exclusion_ratio)
        vals = field["field values"]
        if calculation == "mean":
            return vals.mean()
        if calculation == "median":
            return float(np.median(vals))
        if calculation == "max":
            return vals.max()
        if calculation == "min":
            return vals.min()
        raise ValueError(f"Unknown calculation {calculation}")

    def gamma(self, evaluation_profile: "SingleProfile", distance_to_agreement: int = 1,
              dose_to_agreement: float = 1, gamma_cap_value: float = 2,
              dose_threshold: float = 5, global_dose: bool = True,
              fill_value: float = np.nan) -> np.ndarray:
        """Low's 1D gamma of ``evaluation_profile`` against this profile,
        over their x indices, on the CPU (``ops.gamma.gamma_1d``)."""
        if not self.dpmm or not evaluation_profile.dpmm:
            raise ValueError(
                "At least one profile does not have the dpmm attribute. "
                "Set it before gamma analysis.")
        g, _, _ = gamma_1d(
            reference=np.asarray(self.values, np.float32),
            evaluation=np.asarray(evaluation_profile.values, np.float32),
            reference_coordinates=np.asarray(self.x_indices, np.float32),
            evaluation_coordinates=np.asarray(evaluation_profile.x_indices, np.float32),
            dose_to_agreement=dose_to_agreement,
            distance_to_agreement=distance_to_agreement,
            gamma_cap_value=gamma_cap_value, global_dose=global_dose,
            dose_threshold=dose_threshold, fill_value=fill_value, device="cpu")
        return g.numpy()


class MultiProfile(ProfileMixin):
    """A profile with several peaks."""

    def __init__(self, values):
        self.values = np.asarray(values)
        self.peaks: list[Point] = []
        self.valleys: list[Point] = []

    def find_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                   max_number: int | None = None, search_region=(0.0, 1.0),
                   peak_sort: str = "prominences") -> tuple[np.ndarray, np.ndarray]:
        peak_idxs, props = find_peaks(
            self.values, threshold=threshold, peak_separation=min_distance,
            max_number=max_number, search_region=search_region, peak_sort=peak_sort)
        self.peaks = [Point(value=v, idx=i) for i, v in zip(peak_idxs, props["peak_heights"])]
        return peak_idxs, props["peak_heights"]

    def find_valleys(self, threshold: float = 0.3, min_distance: float = 0.05,
                     max_number: int | None = None,
                     search_region=(0.0, 1.0)) -> tuple[np.ndarray, np.ndarray]:
        valley_idxs, _ = find_peaks(
            -self.values, threshold=threshold, peak_separation=min_distance,
            max_number=max_number, search_region=search_region)
        self.valleys = [Point(value=self.values[i], idx=i) for i in valley_idxs]
        return valley_idxs, self.values[valley_idxs]

    def find_fwxm_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                        max_number: int | None = None, search_region=(0.0, 1.0),
                        peak_sort: str = "prominences",
                        required_prominence=None) -> tuple[np.ndarray, np.ndarray]:
        """Peaks placed at the centres of their full widths at half maximum,
        rounded to the nearest sample."""
        _, props = find_peaks(
            self.values, threshold=threshold, peak_separation=min_distance,
            max_number=max_number, search_region=search_region, peak_sort=peak_sort,
            required_prominence=required_prominence)
        fwxm_idxs = [int(round(lt + (rt - lt) / 2))
                     for lt, rt in zip(props["left_ips"], props["right_ips"])]
        fwxm_vals = [self.values[i] for i in fwxm_idxs]
        self.peaks = [Point(value=v, idx=i) for i, v in zip(fwxm_idxs, fwxm_vals)]
        return np.array(fwxm_idxs), np.array(fwxm_vals)


class CircleProfile(MultiProfile, Circle):
    """A profile sampled around a circle, nearest pixel (scipy
    map_coordinates order 0)."""

    def __init__(self, center: Point, radius: float, image_array,
                 start_angle: float = 0, ccw: bool = True, sampling_ratio: float = 1.0):
        Circle.__init__(self, center, radius)
        self._ensure_array_size(image_array, self.radius + self.center.x,
                                self.radius + self.center.y)
        self.image_array = image_array
        self.start_angle = start_angle
        self.ccw = ccw
        self.sampling_ratio = sampling_ratio
        self._x_locations = None
        self._y_locations = None
        MultiProfile.__init__(self, self._profile)

    @property
    def size(self) -> float:
        return np.pi * self.radius * 2 * self.sampling_ratio

    @property
    def _radians(self) -> np.ndarray:
        interval = (2 * np.pi) / self.size
        rads = np.arange(0 + self.start_angle,
                         (2 * np.pi) + self.start_angle - interval, interval)
        return rads[::-1] if self.ccw else rads

    @property
    def x_locations(self) -> np.ndarray:
        if self._x_locations is None:
            return np.cos(self._radians) * self.radius + self.center.x
        return self._x_locations

    @x_locations.setter
    def x_locations(self, arr):
        self._x_locations = arr

    @property
    def y_locations(self) -> np.ndarray:
        if self._y_locations is None:
            return np.sin(self._radians) * self.radius + self.center.y
        return self._y_locations

    @y_locations.setter
    def y_locations(self, arr):
        self._y_locations = arr

    @property
    def _profile(self) -> np.ndarray:
        yy = np.clip(np.round(self.y_locations).astype(int), 0, self.image_array.shape[0] - 1)
        xx = np.clip(np.round(self.x_locations).astype(int), 0, self.image_array.shape[1] - 1)
        return np.asarray(self.image_array)[yy, xx]

    def find_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                   max_number: int | None = None, search_region=(0.0, 1.0)):
        peak_idxs, peak_vals = super().find_peaks(threshold, min_distance,
                                                  max_number, search_region)
        self._map_peaks()
        return peak_idxs, peak_vals

    def find_valleys(self, threshold: float = 0.3, min_distance: float = 0.05,
                     max_number: int | None = None, search_region=(0.0, 1.0)):
        valley_idxs, valley_vals = super().find_valleys(threshold, min_distance,
                                                        max_number, search_region)
        self._map_peaks()
        return valley_idxs, valley_vals

    def find_fwxm_peaks(self, threshold: float = 0.3, min_distance: float = 0.05,
                        max_number: int | None = None, search_region=(0.0, 1.0)):
        peak_idxs, peak_vals = super().find_fwxm_peaks(threshold, min_distance,
                                                       max_number, search_region=search_region)
        self._map_peaks()
        return peak_idxs, peak_vals

    def roll(self, amount: int) -> None:
        """Roll the profile and its sample locations ``amount`` samples back."""
        self.values = np.roll(self.values, -amount)
        self.x_locations = np.roll(self.x_locations, -amount)
        self.y_locations = np.roll(self.y_locations, -amount)

    def _map_peaks(self) -> None:
        x_locations, y_locations = self.x_locations, self.y_locations
        for peak in self.peaks:
            peak.x = x_locations[int(peak.idx)]
            peak.y = y_locations[int(peak.idx)]

    def plot2axes(self, axes=None, edgecolor: str = "black", fill: bool = False,
                  plot_peaks: bool = True) -> None:
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle as mpl_Circle

        if axes is None:
            _, axes = plt.subplots()
            axes.imshow(self.image_array)
        axes.add_patch(mpl_Circle((self.center.x, self.center.y), edgecolor=edgecolor,
                                  radius=self.radius, fill=fill))
        if plot_peaks:
            x_locs = [p.x for p in self.peaks]
            y_locs = [p.y for p in self.peaks]
            axes.autoscale(enable=False)
            axes.scatter(x_locs, y_locs, s=40, marker="x", c=edgecolor)

    @staticmethod
    def _ensure_array_size(array, min_width, min_height) -> None:
        if array.shape[1] < min_width or array.shape[0] < min_height:
            raise ValueError("Array size not large enough to compute profile")


class CollapsedCircleProfile(CircleProfile):
    """A thick circular profile: the mean of ``num_profiles`` concentric
    rings."""

    def __init__(self, center: Point, radius: float, image_array,
                 start_angle: float = 0, ccw: bool = True, sampling_ratio: float = 1.0,
                 width_ratio: float = 0.1, num_profiles: int = 20):
        self.width_ratio = width_ratio
        self.num_profiles = num_profiles
        super().__init__(center, radius, image_array, start_angle, ccw, sampling_ratio)

    @property
    def _radii(self) -> np.ndarray:
        return np.linspace(self.radius * (1 - self.width_ratio),
                           self.radius * (1 + self.width_ratio), self.num_profiles)

    @property
    def size(self) -> float:
        return np.pi * max(self._radii) * 2 * self.sampling_ratio

    @property
    def _profile(self) -> np.ndarray:
        rads = self._radians
        radii = self._radii[:, None]
        xx = np.round(np.cos(rads)[None, :] * radii + self.center.x).astype(int)
        yy = np.round(np.sin(rads)[None, :] * radii + self.center.y).astype(int)
        yy = np.clip(yy, 0, self.image_array.shape[0] - 1)
        xx = np.clip(xx, 0, self.image_array.shape[1] - 1)
        return np.asarray(self.image_array)[yy, xx].sum(axis=0) / self.num_profiles

    def plot2axes(self, axes=None, edgecolor: str = "black", fill: bool = False,
                  plot_peaks: bool = True) -> None:
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle as mpl_Circle

        if axes is None:
            _, axes = plt.subplots()
            axes.imshow(self.image_array)
        for r in (self.radius * (1 + self.width_ratio), self.radius * (1 - self.width_ratio)):
            axes.add_patch(mpl_Circle((self.center.x, self.center.y), edgecolor=edgecolor,
                                      radius=r, fill=fill))
        if plot_peaks:
            x_locs = [p.x for p in self.peaks]
            y_locs = [p.y for p in self.peaks]
            axes.autoscale(enable=False)
            axes.scatter(x_locs, y_locs, s=20, marker="x", c=edgecolor)
