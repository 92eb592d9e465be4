"""Nuclear medicine and SPECT QA (NMQC-toolkit-style tests).

Port of ``pylinac_tpu/nuclear.py``: ``_curve_fit`` ``:47``,
``MaxCountRate`` ``:69``, ``PlanarUniformity`` ``:136`` with ``FOV``
``:217``, ``get_fov`` ``:345``, ``CenterOfRotation`` ``:386``,
``sinusoidal_fit`` ``:479``, ``weighted_centroid_3d`` ``:487``,
``TomographicResolution`` ``:545``, ``SimpleSensitivity`` ``:630`` with
``Nuclide`` ``:652``, ``FourBarResolution`` ``:732`` with
``DoubleGaussianProfile`` ``:801``, ``QuadrantResolution`` ``:889``,
``TomographicUniformity`` ``:975``, ``TomographicContrast`` ``:1084`` with
``TomographicROI`` ``:1140`` and the ``TomgraphicSphere`` type of its
results (``:1124``), and the host helpers ``_minimize_nm``
``:1300``, ``create_sphere_mask``, ``sample_sphere`` and ``contrast_f``
(``:1333-1361``; the search's objective reads the sphere's bounding box
only). The result models are dataclasses with the JAX models'
fields.

``analyze(..., device=None)`` runs on CUDA unless the caller passes another
device, and raises without one. On the device:

- the NEMA smoothing (:func:`.ops.filters.smooth3x3`, XLA's CPU order of
  the nine taps, exact on both devices);
- the small-object and small-hole removal and every ``regionprops``
  (K = 32, 4-connected, no hull): ``csrc/ccl.cu`` label and holes launches
  at B = 1, one pair a ``get_fov`` and one a slice of
  ``TomographicContrast.slice_data``;
- the isotropic erosion and the boundary of the FOVs;
- the float32 Levenberg-Marquardt fits (:func:`.ops.optimize.levenberg_marquardt`).

Everything else is host numpy, as in JAX: the binning, the thresholds, the
uniformity windows, the centroids and the sphere search (a host
Nelder-Mead). ``MaxCountRate``, ``SimpleSensitivity`` and
``QuadrantResolution`` do no device work: their ``device`` is checked, as
every entry point's, and unused. The fits' float32 sines and exponentials
and the LM step (a float64 solve here, float32 in JAX) are held to JAX's at
the parity bar, not to the bit.

The reports are JAX's: every class's ``to_quaac`` (its
``_quaac_datapoints``) needs no matplotlib; ``plot`` and ``plot_to`` import
it inside. JAX's nuclear classes have no ``publish_pdf``, and neither do
these.
"""

from __future__ import annotations

import dataclasses
import json
import math
from functools import cached_property
from pathlib import Path
from typing import Sequence, TypedDict

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from .core.contrast import michelson
from .core.geometry import Circle, Point, direction_to_coords
from .core.image import DicomImage, NMImageStack
from .core.mtf import MomentMTF
from .core.roi import DiskROI, HighContrastDiskROI, RectangleROI
from .core.utilities import (
    DataModel,
    QuaacDatum,
    QuaacMixin,
    ResultBase,
    ResultsDataMixin,
    resolve_device,
)
from .core.warnings import capture_warnings
from .metrics.image import WeightedCentroid
from .metrics.utils import valid_region_views
from .ops import label as tlabel
from .ops.filters import smooth3x3
from .ops.morphology import (
    block_reduce,
    find_boundaries,
    isotropic_erosion,
    remove_small_holes,
    remove_small_objects,
)
from .ops.optimize import levenberg_marquardt
from .ops.peaks import find_peaks


def _curve_fit(model, xs, ys, p0, device) -> np.ndarray:
    """Least squares of ``model(x, *params)`` to ``ys`` by float32
    Levenberg-Marquardt on ``device``; returns the parameters as float64,
    like scipy's ``popt``."""
    x = torch.as_tensor(np.asarray(xs, dtype=np.float32), device=device)[None]
    y = torch.as_tensor(np.asarray(ys, dtype=np.float32), device=device)[None]
    p = torch.as_tensor(np.asarray(p0, np.float32), device=device)[None]

    def residuals(params, x, y):
        return model(x, *[params[:, i:i + 1] for i in range(params.shape[1])]) - y

    popt = levenberg_marquardt(residuals, p, x, y)
    return popt[0].cpu().numpy().astype(float)


@dataclasses.dataclass(kw_only=True)
class MaxCountRateResults(ResultBase):
    max_countrate: float
    max_frame: int
    frame_duration: float
    sums: dict[int, float]


@capture_warnings
class MaxCountRate(ResultsDataMixin, QuaacMixin):
    """Maximum count rate of a gamma camera (NMQC 4.2)."""

    def __init__(self, path: str | Path) -> None:
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    def analyze(self, frame_duration: float = 1.0, device=None) -> None:
        """Each frame's counts over ``frame_duration`` (s); host sums of
        integer counts, exact in any order."""
        resolve_device(device, "MaxCountRate.analyze")
        self.frame_duration = frame_duration
        self.sums = {idx: float(img.array.sum()) / frame_duration
                     for idx, img in enumerate(self.stack.frames)}

    @property
    def max_countrate(self) -> float:
        return max(self.sums.values())

    @property
    def max_frame(self) -> int:
        return max(self.sums, key=self.sums.get)

    @property
    def max_time(self) -> float:
        return self.max_frame * self.frame_duration

    def results(self) -> str:
        return (f"Max countrate results for {self.path.name}\n"
                f"Max countrate: {self.max_countrate:.0f} counts/sec\n"
                f"Frame: {self.max_frame}\n"
                f"Time: {self.max_time:.1f} s\n")

    def _generate_results_data(self) -> MaxCountRateResults:
        return MaxCountRateResults(
            max_countrate=self.max_countrate, max_frame=self.max_frame,
            frame_duration=self.frame_duration, sums=self.sums)

    def plot(self, show: bool = True) -> None:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(np.asarray(list(self.sums.keys())) * self.frame_duration,
                list(self.sums.values()))
        ax.grid(True)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Count Rate (cps)")
        ax2 = ax.twiny()
        ax2.set_xlabel("Frame")
        ax2.set_xlim(np.asarray(ax.get_xlim()) / self.frame_duration)
        plt.tight_layout()
        ax.plot(self.max_time, self.max_countrate, "ro")
        if show:
            plt.show()

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {"Max Count Rate": QuaacDatum(
            value=self.max_countrate, unit="counts/s")}


@dataclasses.dataclass
class PlanarUniformityResults(DataModel):
    ufov_integral_uniformity: float
    ufov_differential_uniformity: float
    cfov_integral_uniformity: float
    cfov_differential_uniformity: float


@dataclasses.dataclass
class FOV:
    """A field of view of a gamma camera."""

    name: str
    fov: np.ndarray
    boundary_x: np.ndarray
    boundary_y: np.ndarray
    window_size: int

    @property
    def integral_uniformity(self) -> float:
        return integral_uniformity(self.fov[self.fov > 0])

    @cached_property
    def _differential_uniformities(self):
        non_zero = np.where(self.fov > 0, self.fov, np.nan)
        y_view = sliding_window_view(non_zero, window_shape=self.window_size, axis=0)
        x_view = sliding_window_view(non_zero, window_shape=self.window_size, axis=1)

        # the windowed Michelson contrast, (max - min) / (max + min), over
        # the windows that lie wholly inside the FOV
        def diffs(view):
            finite = np.all(np.isfinite(view), axis=-1)
            vmax = np.max(view, axis=-1)
            vmin = np.min(view, axis=-1)
            unif = (vmax - vmin) / (vmax + vmin) * 100
            out = {}
            ii, jj = np.nonzero(finite & np.isfinite(unif))
            for i, j in zip(ii, jj):
                out[(int(i), int(j))] = float(unif[i, j])
            return out

        return diffs(y_view), diffs(x_view)

    @property
    def differential_uniformity(self) -> float:
        max_y = max(self._differential_uniformities[0].values())
        max_x = max(self._differential_uniformities[1].values())
        return max(max_x, max_y)

    @property
    def max_point(self) -> tuple[int, int]:
        nan_array = np.where(self.fov == 0, np.nan, self.fov)
        p = np.unravel_index(np.nanargmax(nan_array), self.fov.shape)
        return int(p[0]), int(p[1])

    @property
    def min_point(self) -> tuple[int, int]:
        nan_array = np.where(self.fov == 0, np.nan, self.fov)
        p = np.unravel_index(np.nanargmin(nan_array), self.fov.shape)
        return int(p[0]), int(p[1])

    def plot_to(self, axis, color: str) -> None:
        from matplotlib.patches import Rectangle

        axis.scatter(self.boundary_x, self.boundary_y, color=color,
                     label=f"{self.name} Boundary", marker=".")
        axis.scatter(self.max_point[1], self.max_point[0], color=color,
                     marker="s", label=f"{self.name} Max")
        axis.scatter(self.min_point[1], self.min_point[0], color=color,
                     marker="x", label=f"{self.name} Min")
        max_x = max(self._differential_uniformities[1].values())
        max_y = max(self._differential_uniformities[0].values())
        if max_x > max_y:
            max_point = max(self._differential_uniformities[1],
                            key=self._differential_uniformities[1].get)
            width, height = self.window_size, 1
        else:
            max_point = max(self._differential_uniformities[0],
                            key=self._differential_uniformities[0].get)
            width, height = 1, self.window_size
        rect = Rectangle((max_point[1] - 0.5, max_point[0] - 0.5), width,
                         height, linewidth=1, edgecolor=color,
                         facecolor="none",
                         label=f"{self.name} Max Diff. Window")
        axis.add_patch(rect)
        axis.legend()


@capture_warnings
class PlanarUniformity(QuaacMixin):
    """NEMA planar uniformity of each frame's UFOV and CFOV."""

    def __init__(self, path: str | Path) -> None:
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    def analyze(self, ufov_ratio: float = 0.95, cfov_ratio: float = 0.75,
                window_size: int = 5, threshold: float = 0.75, device=None) -> None:
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.frame_results = {}
        for idx, frame in enumerate(self.stack.frames):
            cleaned_frame, _ = self.preprocess(frame, threshold=threshold, device=self._device)
            ufov_array, ufov_x, ufov_y = get_fov(cleaned_frame, ufov_ratio, self._device)
            ufov = FOV(name="UFOV", fov=ufov_array, boundary_x=ufov_x,
                       boundary_y=ufov_y, window_size=window_size)
            cfov_array, cfov_x, cfov_y = get_fov(cleaned_frame, cfov_ratio * ufov_ratio,
                                                 self._device)
            cfov = FOV(name="CFOV", fov=cfov_array, boundary_x=cfov_x,
                       boundary_y=cfov_y, window_size=window_size)
            self.frame_results[str(idx + 1)] = {
                "ufov": ufov, "cfov": cfov, "binned_frame": cleaned_frame}

    def results(self) -> str:
        s = []
        for key, result in self.frame_results.items():
            s.append(f"Frame {key}:\n")
            s.append(f"UFOV integral uniformity: "
                     f"{result['ufov'].integral_uniformity:.2f}%\n")
            s.append(f"UFOV differential uniformity "
                     f"{result['ufov'].differential_uniformity:.2f}%\n")
            s.append(f"CFOV integral uniformity: "
                     f"{result['cfov'].integral_uniformity:.2f}%\n")
            s.append(f"CFOV differential uniformity "
                     f"{result['cfov'].differential_uniformity:.2f}%\n")
            s.append("\n")
        return "".join(s)

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        data = {}
        for key, result in self.frame_results.items():
            r = PlanarUniformityResults(
                ufov_integral_uniformity=result["ufov"].integral_uniformity,
                ufov_differential_uniformity=result["ufov"].differential_uniformity,
                cfov_integral_uniformity=result["cfov"].integral_uniformity,
                cfov_differential_uniformity=result["cfov"].differential_uniformity)
            if as_dict:
                data[f"Frame {key}"] = r.model_dump()
            elif as_json:
                data[f"Frame {key}"] = r.model_dump_json()
            else:
                data[f"Frame {key}"] = r
        if as_json:
            data = json.dumps(data)
        return data

    @staticmethod
    def preprocess(frame, threshold: float, device=None):
        """NEMA binning, the smoothing kernel and the background cut; the
        binary frame loses its single-pixel objects and holes on
        ``device``."""
        device = resolve_device(device, "PlanarUniformity.preprocess")
        array = np.copy(frame.array)
        pixel_size = frame.metadata.PixelSpacing[0]
        bin_size = determine_binning(pixel_size)
        array = block_reduce(array, block_size=(bin_size, bin_size), func=np.sum)
        array = smooth3x3(torch.as_tensor(array.astype(np.float32), device=device)).cpu().numpy()
        array[0, :] = 0
        array[-1, :] = 0
        array[:, 0] = 0
        array[:, -1] = 0
        thresh = array[array > np.max(array) * 0.10].mean() * threshold
        array[array < thresh] = 0
        binary_frame = torch.as_tensor(array > 0, device=device)
        binary_frame = remove_small_objects(binary_frame, min_size=2)
        binary_frame = remove_small_holes(binary_frame, area_threshold=2)
        array[~binary_frame.cpu().numpy()] = 0
        return array, bin_size

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        first = data["Frame 1"]
        return {
            "UFOV Integral Uniformity": QuaacDatum(
                value=first["ufov_integral_uniformity"], unit="%"),
            "UFOV Differential Uniformity": QuaacDatum(
                value=first["ufov_differential_uniformity"], unit="%"),
            "CFOV Integral Uniformity": QuaacDatum(
                value=first["cfov_integral_uniformity"], unit="%"),
            "CFOV Differential Uniformity": QuaacDatum(
                value=first["cfov_differential_uniformity"], unit="%"),
        }

    def plot(self, show: bool = True, cmap: str = "gray"):
        import matplotlib.pyplot as plt

        figs, axes = [], []
        for key, result in self.frame_results.items():
            fig, axis = plt.subplots()
            nan_array = np.where(result["binned_frame"] == 0, np.nan,
                                 result["binned_frame"])
            axis.imshow(result["binned_frame"], cmap=cmap,
                        vmin=np.nanmin(nan_array), vmax=np.nanmax(nan_array))
            result["ufov"].plot_to(axis, color="y")
            result["cfov"].plot_to(axis, color="r")
            axis.legend(loc="upper right")
            fig.suptitle(f"Frame {key}")
            figs.append(fig)
            axes.append(axis)
        if show:
            plt.show()
        return figs, axes


def _largest_region(binary_frame: np.ndarray, array: np.ndarray, device):
    """The largest 4-connected region of a binary frame (``regionprops``,
    K = 32, no hull), as a :class:`RegionView`, or None."""
    regions = tlabel.regionprops(torch.as_tensor(binary_frame, device=device),
                                 torch.as_tensor(array.astype(np.float32), device=device),
                                 K=32, connectivity=1, hull=False)
    views = valid_region_views(regions)
    return max(views, key=lambda x: x.area) if views else None


def get_fov(array: np.ndarray, size: float, device=None):
    """The FOV array and its inner boundary for the size ratio ``size`` of
    the frame's largest region, on ``device``."""
    device = resolve_device(device, "get_fov")
    binary_frame = array > 0
    largest = _largest_region(binary_frame, array, device)
    bbox = largest.bbox
    longest_dim = max(bbox[2] - bbox[0], bbox[3] - bbox[1])
    erosion = int(round((1 - size) * longest_dim))
    eroded = isotropic_erosion(torch.as_tensor(binary_frame, device=device), radius=erosion / 2)
    boundary = find_boundaries(eroded, connectivity=1).cpu().numpy()
    eroded_binary = eroded.cpu().numpy()
    boundary_y, boundary_x = np.nonzero(boundary)
    fov_array = np.where(eroded_binary, array, 0)
    return fov_array, boundary_x, boundary_y


def integral_uniformity(array: np.ndarray) -> float:
    """IAEA integral uniformity: the Michelson contrast times 100."""
    return michelson(array) * 100


def determine_binning(pixel_size: float) -> int:
    """Bin until the pixel size is within the NEMA range of 4.48-8.32 mm."""
    binning = 1
    while pixel_size < 4.48:
        pixel_size *= 2
        binning *= 2
    return binning


@dataclasses.dataclass(kw_only=True)
class CenterOfRotationResults(ResultBase):
    x_deviation_mm: float
    y_deviation_mm: float


@capture_warnings
class CenterOfRotation(ResultsDataMixin, QuaacMixin):
    """Centre-of-rotation deviation from a sinusoid fit of the point
    source's centroid against the projection angle."""

    def __init__(self, path: str | Path):
        super().__init__()
        self.path = Path(path)
        self.stack = NMImageStack(path)

    def analyze(self, device=None) -> None:
        device = resolve_device(device, "CenterOfRotation.analyze")
        rot_info = self.stack.metadata.RotationInformationSequence[0]
        rot_sign = -1 if rot_info.RotationDirection == "CW" else 1
        start_angle = rot_info.StartAngle
        step_size = rot_info.AngularStep
        centroids = {}
        for idx, frame in enumerate(self.stack.frames):
            centroid = frame.compute(WeightedCentroid())
            angle = start_angle + rot_sign * idx * step_size
            centroids[angle] = centroid
        x_values = np.radians(list(centroids.keys()))
        half_pixel = self.stack.metadata.PixelSpacing[0] * 0.5
        y_values = (np.asarray([p.x for p in centroids.values()])
                    * self.stack.metadata.PixelSpacing[0] + half_pixel)
        params = _curve_fit(sinusoidal_fit, x_values, y_values,
                            p0=[np.mean(y_values), 1, 1, 1], device=device)
        fitted_y = sinusoidal_fit(x_values, *params)
        self.cor_x = {
            "x_values": x_values, "y_values": y_values,
            "a": params[0], "b": params[1], "c": params[2], "phi": params[3],
            "fitted_y_values": fitted_y, "residuals": y_values - fitted_y}
        y_values = (np.asarray([p.y for p in centroids.values()])
                    * self.stack.metadata.PixelSpacing[0] + half_pixel)
        self.cor_y = {"x_values": x_values, "residuals": y_values - np.mean(y_values)}

    @property
    def x_cor_deviation_mm(self) -> float:
        return float(np.max(np.abs(self.cor_x["residuals"])))

    @property
    def y_cor_deviation_mm(self) -> float:
        return float(np.max(np.abs(self.cor_y["residuals"])))

    def results(self) -> str:
        return (f"Center of Rotation results for {self.path.name}\n"
                f"X-axis center of rotation deviation (mm): "
                f"{self.x_cor_deviation_mm:.3f}\n"
                f"Y-axis center of rotation deviation (mm): "
                f"{self.y_cor_deviation_mm:.3f}\n")

    def _generate_results_data(self) -> CenterOfRotationResults:
        return CenterOfRotationResults(x_deviation_mm=self.x_cor_deviation_mm,
                                       y_deviation_mm=self.y_cor_deviation_mm)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {
            "X-axis Center of Rotation Deviation": QuaacDatum(
                value=self.x_cor_deviation_mm, unit="mm"),
            "Y-axis Center of Rotation Deviation": QuaacDatum(
                value=self.y_cor_deviation_mm, unit="mm"),
        }

    def plot(self, show: bool = True):
        import matplotlib.pyplot as plt

        figs, axes = [], []
        fig, ax = plt.subplots()
        ax.plot(self.cor_x["x_values"], self.cor_x["y_values"], "bo")
        ax.plot(self.cor_x["x_values"], self.cor_x["fitted_y_values"], "r-",
                label=f"{self.cor_x['a']:2.2f}{self.cor_x['b']:+2.3f}"
                      f"*sin({self.cor_x['c']:2.2f}*\N{GREEK SMALL LETTER THETA}"
                      f"{self.cor_x['phi']:+2.2f})")
        ax.legend()
        ax.set_xlabel("Angle (radians)")
        ax.set_ylabel("Position (mm)")
        ax.grid(True)
        fig.suptitle("Sine fit (X-axis)")
        figs.append(fig)
        axes.append(ax)
        for cor, axis_name in zip([self.cor_x, self.cor_y], ["X-axis", "Y-axis"]):
            fig, ax = plt.subplots()
            ax.plot(cor["x_values"], cor["residuals"], "bo")
            ax.set_xlabel("Angle (radians)")
            ax.set_ylabel("Residual Error (mm)")
            ax.grid(True)
            fig.suptitle(f"Residual error ({axis_name})")
            figs.append(fig)
            axes.append(ax)
        if show:
            plt.show()
        return figs, axes


def sinusoidal_fit(theta, a, b, c, phi):
    """IAEA p 176, method B (2): ``a + b sin(c theta + phi)``; numpy for
    arrays, torch for tensors."""
    sin = torch.sin if isinstance(theta, torch.Tensor) else np.sin
    return a + b * sin(c * theta + phi)


def weighted_centroid_3d(arr: np.ndarray):
    if np.sum(arr) == 0:
        return None
    z_idx, y_idx, x_idx = np.indices(arr.shape)
    total = np.sum(arr)
    return (np.sum(x_idx * arr) / total, np.sum(y_idx * arr) / total,
            np.sum(z_idx * arr) / total)


@dataclasses.dataclass(kw_only=True)
class TomographicResolutionResults(ResultBase):
    x_fwhm: float
    y_fwhm: float
    z_fwhm: float
    x_fwtm: float
    y_fwtm: float
    z_fwtm: float


@dataclasses.dataclass
class TomographicResolutionAxisData:
    axis: str
    profile_array: np.ndarray
    pixel_size: float
    device: torch.device = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        xs = np.arange(len(self.profile_array)) * self.pixel_size
        self.popt = _curve_fit(
            gaussian_fit, xs, self.profile_array,
            p0=[np.max(self.profile_array), np.mean(xs), self.pixel_size],
            device=resolve_device(self.device, "TomographicResolutionAxisData"))

    @property
    def fwhm(self) -> float:
        return fwhm_from_gaussian(self.popt[2])

    @property
    def fwtm(self) -> float:
        return fwtm_from_gaussian(self.popt[2])

    def plot(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        xs = np.arange(len(self.profile_array)) * self.pixel_size
        x_interp = np.linspace(0, len(self.profile_array),
                               num=len(self.profile_array) * 20) * self.pixel_size
        ax.plot(xs, self.profile_array, "bo", label="Raw Data")
        ax.set_xlim((self.popt[1] - 10 * self.popt[2]),
                    (self.popt[1] + 10 * self.popt[2]))
        ax.plot(x_interp, gaussian_fit(x_interp, *self.popt), "r-",
                label="Gaussian Fit")
        ax.grid(True)
        ax.set_xlabel("Distance (mm)")
        ax.set_ylabel("Counts")
        fig.suptitle(f"{self.axis}-axis profile")
        return fig, ax


@capture_warnings
class TomographicResolution(ResultsDataMixin, QuaacMixin):
    """Gaussian FWHM and FWTM along each axis through the 3D weighted
    centroid of a point source (IAEA 4.3.4)."""

    def __init__(self, path: str | Path) -> None:
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    def analyze(self, device=None) -> None:
        device = resolve_device(device, "TomographicResolution.analyze")
        array_3d = self.stack.as_3d_array()
        x, y, z = weighted_centroid_3d(array_3d)
        xy_frame = self.stack.frames[int(round(z))]
        p = xy_frame.compute(WeightedCentroid())
        spacing = self.stack.metadata.PixelSpacing[0]
        x_profile = xy_frame.array[int(round(p.y)), :]
        self.x_axis = TomographicResolutionAxisData("X", x_profile, spacing, device)
        y_profile = xy_frame.array[:, int(round(p.x))]
        self.y_axis = TomographicResolutionAxisData("Y", y_profile, spacing, device)
        z_profile = array_3d[:, int(round(p.y)), int(round(p.x))]
        dpmm = abs(self.stack.metadata.SpacingBetweenSlices)
        self.z_axis = TomographicResolutionAxisData("Z", z_profile, dpmm, device)

    def results(self) -> str:
        return (f"Tomographic Resolution results for {self.path.name}\n"
                f"X-axis FWHM (mm): {self.x_axis.fwhm:.3f}\n"
                f"Y-axis FWHM (mm): {self.y_axis.fwhm:.3f}\n"
                f"Z-axis FWHM (mm): {self.z_axis.fwhm:.3f}\n"
                f"X-axis FWTM (mm): {self.x_axis.fwtm:.3f}\n"
                f"Y-axis FWTM (mm): {self.y_axis.fwtm:.3f}\n"
                f"Z-axis FWTM (mm): {self.z_axis.fwtm:.3f}\n")

    def _generate_results_data(self) -> TomographicResolutionResults:
        return TomographicResolutionResults(
            x_fwhm=self.x_axis.fwhm, y_fwhm=self.y_axis.fwhm,
            z_fwhm=self.z_axis.fwhm, x_fwtm=self.x_axis.fwtm,
            y_fwtm=self.y_axis.fwtm, z_fwtm=self.z_axis.fwtm)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        return {name: QuaacDatum(value=data[key], unit="mm")
                for key, name in (("x_fwhm", "X-axis FWHM"),
                                  ("y_fwhm", "Y-axis FWHM"),
                                  ("z_fwhm", "Z-axis FWHM"),
                                  ("x_fwtm", "X-axis FWTM"),
                                  ("y_fwtm", "Y-axis FWTM"),
                                  ("z_fwtm", "Z-axis FWTM"))}

    def plot(self):
        figs, axes = [], []
        for axis in (self.x_axis, self.y_axis, self.z_axis):
            fig, ax = axis.plot()
            figs.append(fig)
            axes.append(ax)
        return figs, axes


def fwhm_from_gaussian(std: float) -> float:
    """FWHM from a Gaussian sigma; abs() because the fit may flip its sign."""
    return 2 * math.sqrt(2 * math.log(2)) * abs(std)


def fwtm_from_gaussian(std: float) -> float:
    """FWTM from a Gaussian sigma."""
    return 2 * math.sqrt(2 * math.log(10)) * abs(std)


def gaussian_fit(x, amplitude, mean, stddev):
    exp = torch.exp if isinstance(x, torch.Tensor) else np.exp
    return amplitude * exp(-((x - mean) ** 2) / (2 * (stddev ** 2)))


def two_peak_gaussian_fit(x, amplitude1, mean1, stddev1, amplitude2, mean2, stddev2):
    exp = torch.exp if isinstance(x, torch.Tensor) else np.exp
    return (amplitude1 * exp(-((x - mean1) ** 2) / (2 * (stddev1 ** 2)))
            + amplitude2 * exp(-((x - mean2) ** 2) / (2 * (stddev2 ** 2))))


class Nuclide:
    """Published half-lives (see nndc.bnl.gov/nudat3)."""

    Tc99m = {"half_life_s": 6.0067 * 60 * 60}
    Y90 = {"half_life_s": 64.1 * 60 * 60}
    I131 = {"half_life_s": 8.019 * 24 * 60 * 60}
    Ga67 = {"half_life_s": 3.261 * 24 * 60 * 60}
    In111 = {"half_life_s": 2.804 * 24 * 60 * 60}
    Lu177 = {"half_life_s": 6.647 * 24 * 60 * 60}


@dataclasses.dataclass(kw_only=True)
class SimpleSensitivityResults(ResultBase):
    phantom_cps: float
    background_cps: float
    half_life_s: float
    duration_s: float
    decay_correction: float
    sensitivity_mbq: float
    sensitivity_uci: float


@capture_warnings
class SimpleSensitivity(ResultsDataMixin, QuaacMixin):
    """IAEA 2.3.9 'simple' sensitivity."""

    def __init__(self, phantom_path: str | Path,
                 background_path: str | Path | None = None):
        super().__init__()
        self.phantom_path = Path(phantom_path)
        self.background_path = Path(background_path) if background_path is not None else None

    @property
    def phantom_cps(self) -> float:
        phantom_img = DicomImage(self.phantom_path, raw_pixels=True)
        return float(phantom_img.array.sum()) / self.duration_s

    @property
    def duration_s(self) -> float:
        phantom_img = DicomImage(self.phantom_path, raw_pixels=True)
        return phantom_img.metadata.ActualFrameDuration / 1000

    @property
    def background_cps(self) -> float:
        if self.background_path is None:
            return 0
        background_stack = NMImageStack(self.background_path)
        duration_s = background_stack.metadata.ActualFrameDuration / 1000
        avg_count = background_stack.as_3d_array().mean(axis=0).sum()
        return float(avg_count) / duration_s

    def analyze(self, activity_mbq: float, nuclide, device=None) -> None:
        resolve_device(device, "SimpleSensitivity.analyze")
        self.half_life_s = nuclide["half_life_s"]
        self.activity_mbq = activity_mbq

    @property
    def decay_correction(self) -> float:
        x = np.log(2) * self.duration_s / self.half_life_s
        return 1 / x * (1 - np.exp(-x))

    @property
    def sensitivity_mbq(self) -> float:
        return (self.phantom_cps / self.decay_correction
                - self.background_cps) / self.activity_mbq

    @property
    def sensitivity_uci(self) -> float:
        mbq_to_uci = 27.02702702702703
        cpm = 60
        return self.sensitivity_mbq * cpm / mbq_to_uci

    def results(self) -> str:
        return (f"Simple Sensitivity results for {self.phantom_path.name}\n"
                f"Phantom c/s: {self.phantom_cps:.0f}\n"
                f"Background c/p: {self.background_cps:.0f}\n"
                f"Half-life: {self.half_life_s:.0f}\n"
                f"Duration: {self.duration_s:.0f}\n"
                f"Decay Correction: {self.decay_correction:.3f}\n"
                f"Sensitivity (MBq): {self.sensitivity_mbq:.3f}\n"
                f"Sensitivity (uCi): {self.sensitivity_uci:.3f}\n")

    def _generate_results_data(self) -> SimpleSensitivityResults:
        return SimpleSensitivityResults(
            phantom_cps=self.phantom_cps, background_cps=self.background_cps,
            half_life_s=self.half_life_s, duration_s=self.duration_s,
            decay_correction=self.decay_correction,
            sensitivity_mbq=self.sensitivity_mbq,
            sensitivity_uci=self.sensitivity_uci)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        return {
            "Phantom Counts per Second": QuaacDatum(
                value=data["phantom_cps"], unit="cps"),
            "Sensitivity (MBq)": QuaacDatum(
                value=data["sensitivity_mbq"], unit="MBq"),
            "Sensitivity (uCi)": QuaacDatum(
                value=data["sensitivity_uci"], unit="uCi"),
        }


@dataclasses.dataclass
class DoubleGaussianProfile:
    """Two-peak Gaussian fit of a bar profile."""

    axis: str
    profile_array: np.ndarray
    pixel_size: float
    separation_mm: float
    device: torch.device = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        xs = np.arange(len(self.profile_array)) * self.pixel_size
        peak_idxs, _ = find_peaks(self.profile_array, max_number=2, threshold=0.1)
        self.popt = _curve_fit(
            two_peak_gaussian_fit, xs, self.profile_array,
            p0=[np.max(self.profile_array), peak_idxs[0] * self.pixel_size,
                self.pixel_size,
                np.max(self.profile_array), peak_idxs[1] * self.pixel_size,
                self.pixel_size],
            device=resolve_device(self.device, "DoubleGaussianProfile"))

    @property
    def fwhm(self) -> float:
        return (fwhm_from_gaussian(self.popt[2]) + fwhm_from_gaussian(self.popt[5])) / 2

    @property
    def fwtm(self) -> float:
        return (fwtm_from_gaussian(self.popt[2]) + fwtm_from_gaussian(self.popt[5])) / 2

    @property
    def measured_pixel_size(self) -> float:
        separation_px = abs(self.popt[4] - self.popt[1]) / self.pixel_size
        return self.separation_mm / separation_px

    @property
    def pixel_size_difference(self) -> float:
        return (self.measured_pixel_size - self.pixel_size) / self.pixel_size * 100

    def plot(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        xs = np.arange(len(self.profile_array)) * self.pixel_size
        x_interp = np.linspace(0, len(self.profile_array),
                               num=len(self.profile_array) * 20) * self.pixel_size
        ax.plot(xs, self.profile_array, "bo", label="Raw Data")
        ax.plot(x_interp, two_peak_gaussian_fit(x_interp, *self.popt), "r-",
                label="Gaussian Fit")
        ax.grid(True)
        ax.legend()
        ax.set_xlabel("Distance (mm)")
        ax.set_ylabel("Counts")
        fig.suptitle(f"{self.axis}-axis profile")
        return fig, ax


@dataclasses.dataclass(kw_only=True)
class FourBarResolutionResults(ResultBase):
    x_fwhm: float
    y_fwhm: float
    x_fwtm: float
    y_fwtm: float
    x_measured_pixel_size: float
    y_measured_pixel_size: float
    x_pixel_size_difference: float
    y_pixel_size_difference: float


@capture_warnings
class FourBarResolution(ResultsDataMixin, QuaacMixin):
    """X and Y line-spread resolution and pixel size from a four-bar
    phantom."""

    def __init__(self, path: str | Path):
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    def analyze(self, separation_mm: float = 100, roi_width_mm: float = 10,
                device=None) -> None:
        device = resolve_device(device, "FourBarResolution.analyze")
        pixel_size = self.stack.metadata.PixelSpacing[0]
        width_px = roi_width_mm / pixel_size
        height_px = separation_mm * 2 / pixel_size
        center = Point(self.stack.metadata.Rows / 2, self.stack.metadata.Columns / 2)
        self.y_prof = RectangleROI(self.stack.frames[0].array, width=width_px,
                                   height=height_px, center=center)
        v_array = self.y_prof.pixel_array.mean(axis=-1)
        self.y_axis = DoubleGaussianProfile("Y/Vertical", v_array, pixel_size,
                                            separation_mm, device)
        self.x_prof = RectangleROI(self.stack.frames[0].array, width=height_px,
                                   height=width_px, center=center)
        h_array = self.x_prof.pixel_array.mean(axis=0)
        self.x_axis = DoubleGaussianProfile("X/Horizontal", h_array, pixel_size,
                                            separation_mm, device)

    def results(self) -> str:
        return (
            f"Four Bar Resolution results for {self.path.name}\n"
            f"X-axis FWHM (mm): {self.x_axis.fwhm:.3f}\n"
            f"X-axis FWTM (mm): {self.x_axis.fwtm:.3f}\n"
            f"X-axis Measured Pixel size (mm): {self.x_axis.measured_pixel_size:.3f}\n"
            f"X-axis Pixel size difference (%): {self.x_axis.pixel_size_difference:.2f}\n"
            f"Y-axis FWHM (mm): {self.y_axis.fwhm:.3f}\n"
            f"Y-axis FWTM (mm): {self.y_axis.fwtm:.3f}\n"
            f"Y-axis Measured Pixel size (mm): {self.y_axis.measured_pixel_size:.3f}\n"
            f"Y-axis Pixel size difference (%): {self.y_axis.pixel_size_difference:.2f}\n")

    def _generate_results_data(self) -> FourBarResolutionResults:
        return FourBarResolutionResults(
            x_fwhm=self.x_axis.fwhm, y_fwhm=self.y_axis.fwhm,
            x_fwtm=self.x_axis.fwtm, y_fwtm=self.y_axis.fwtm,
            x_measured_pixel_size=self.x_axis.measured_pixel_size,
            y_measured_pixel_size=self.y_axis.measured_pixel_size,
            x_pixel_size_difference=self.x_axis.pixel_size_difference,
            y_pixel_size_difference=self.y_axis.pixel_size_difference)

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        return {
            "X-axis FWHM": QuaacDatum(value=data["x_fwhm"], unit="mm"),
            "Y-axis FWHM": QuaacDatum(value=data["y_fwhm"], unit="mm"),
            "X-axis Measured Pixel Size": QuaacDatum(
                value=data["x_measured_pixel_size"], unit="mm"),
            "Y-axis Measured Pixel Size": QuaacDatum(
                value=data["y_measured_pixel_size"], unit="mm"),
        }

    def plot(self, show: bool = True):
        import matplotlib.pyplot as plt

        figs, axes = [], []
        fig, ax = plt.subplots()
        figs.append(fig)
        axes.append(ax)
        ax.imshow(self.stack.frames[0].array, cmap="gray")
        self.x_prof.plot2axes(ax, edgecolor="y")
        self.y_prof.plot2axes(ax, edgecolor="y")
        fig.suptitle(f"Four Bar Resolution for {self.path.name}")
        for axis in (self.x_axis, self.y_axis):
            fig, ax = axis.plot()
            figs.append(fig)
            axes.append(ax)
        if show:
            plt.show()
        return figs, axes


@dataclasses.dataclass(kw_only=True)
class QuadrantResolutionResults(ResultBase):
    quadrants: dict[str, dict[str, float]]


@capture_warnings
class QuadrantResolution(ResultsDataMixin, QuaacMixin):
    """Bar-pattern MTF and FWHM of four quadrants by moments."""

    def __init__(self, path: str | Path) -> None:
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    def analyze(self, bar_widths: Sequence[float], roi_diameter_mm: float = 70,
                distance_from_center_mm: float = 130, device=None) -> None:
        resolve_device(device, "QuadrantResolution.analyze")
        if len(bar_widths) != 4:
            raise ValueError("Must have 4 bar widths")
        lpmm = 1 / (2 * np.asarray(bar_widths))
        self.rois = {}
        img_center = Point(self.stack.metadata.Rows / 2, self.stack.metadata.Columns / 2)
        angles = (45, -45, -135, 135)
        for angle, spacing in zip(angles, bar_widths):
            roi = HighContrastDiskROI.from_phantom_center(
                self.stack.frames[0].array, angle=angle, roi_radius=roi_diameter_mm,
                dist_from_center=distance_from_center_mm, phantom_center=img_center,
                contrast_threshold=0)
            self.rois[spacing] = roi
        self.mtf = MomentMTF.from_high_contrast_diskset(lpmm, list(self.rois.values()))

    def results(self) -> str:
        s = f"Quadrant Resolution results for {self.path.name}\n"
        for quadrant, ((lpmm, mtf), fwhm) in enumerate(
                zip(self.mtf.mtfs.items(), self.mtf.fwhms.values())):
            spacing = 1 / (lpmm * 2)
            s += (f"Quadrant {quadrant + 1}; Bar width: {spacing:.2f}mm; "
                  f"FWHM: {fwhm:.3f}mm; MTF: {mtf:.3f}\n")
        return s

    def _generate_results_data(self) -> QuadrantResolutionResults:
        return QuadrantResolutionResults(quadrants={
            f"{idx + 1}": {"mtf": float(mtf), "fwhm": float(fwhm), "lpmm": float(lpmm),
                           "spacing": float(1 / (lpmm * 2))}
            for idx, ((lpmm, mtf), fwhm) in enumerate(
                zip(self.mtf.mtfs.items(), self.mtf.fwhms.values()))})

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        return {f"Quadrant {key} MTF": QuaacDatum(value=value["mtf"], unit="")
                for key, value in data["quadrants"].items()}

    def plot(self, show: bool = True):
        import matplotlib.pyplot as plt

        figs, axes = [], []
        fig, ax = plt.subplots()
        figs.append(fig)
        axes.append(ax)
        ax.imshow(self.stack.frames[0].array, cmap="gray")
        for idx, (spacing, roi) in enumerate(self.rois.items()):
            roi.plot2axes(ax, edgecolor="y",
                          text=f"{idx + 1}: {spacing:.2f}mm")
        fig.suptitle(f"Quadrant Resolution for {self.path.name}")
        fig, ax = plt.subplots()
        figs.append(fig)
        axes.append(ax)
        self.mtf.plot(ax)
        fig, ax = plt.subplots()
        figs.append(fig)
        axes.append(ax)
        self.mtf.plot_fwhms(ax)
        if show:
            plt.show()
        return figs, axes


@dataclasses.dataclass(kw_only=True)
class TomographicUniformityResults(ResultBase):
    cfov_integral_uniformity: float
    cfov_differential_uniformity: float
    ufov_integral_uniformity: float
    ufov_differential_uniformity: float
    center_border_ratio: float
    first_frame: int
    last_frame: int


@capture_warnings
class TomographicUniformity(ResultsDataMixin, PlanarUniformity):
    """SPECT tomographic uniformity of a reconstructed cylinder: the mean
    of a frame range, analysed as a planar frame, and the NMQC centre-to-
    border ratio."""

    @property
    def frame_result(self) -> dict:
        return self.frame_results[self.frame_key]

    @property
    def frame_key(self) -> str:
        return f"{self.first_frame}:{self.last_frame}"

    def center_border_ratio(self, center_ratio: float, window_size: int) -> float:
        """NMQC centre-to-border ratio: the centre circle against the ring
        between the UFOV and the CFOV."""
        cleaned_frame, _ = self.preprocess(self.stack.frames[0], self.threshold,
                                           device=self._device)
        center_array, center_x, center_y = get_fov(cleaned_frame, center_ratio, self._device)
        center_fov = FOV(name="Center", fov=center_array, boundary_x=center_x,
                         boundary_y=center_y, window_size=window_size)
        self.frame_result["center_fov"] = center_fov
        mask = self.frame_result["cfov"].fov != 0
        ring = np.copy(self.frame_result["ufov"].fov)
        ring[mask] = np.nan
        ring[ring == 0] = np.nan
        center_array = np.where(center_array == 0, np.nan, center_array)
        return float(np.nanmean(center_array) / np.nanmean(ring))

    def analyze(self, first_frame: int = 0, last_frame: int = -1,
                ufov_ratio: float = 0.8, cfov_ratio: float = 0.75,
                center_ratio: float = 0.4, threshold: float = 0.75,
                window_size: int = 5, device=None) -> None:
        self.threshold = threshold
        array = self.stack.as_3d_array()
        if first_frame < 0:
            raise ValueError(
                "The first frame index is outside the array bounds. Increase "
                "the first frame index.")
        if last_frame < 0:
            last_frame += array.shape[0]
        if last_frame >= array.shape[0]:
            raise ValueError(
                "The last frame index is outside the array bounds. Decrease "
                "the last frame index.")
        if 0 < last_frame <= first_frame:
            raise ValueError("The first frame index must be less than the last frame index.")
        new_array = array[first_frame:last_frame, :, :].mean(axis=0)
        new_frame = self.stack.frames[0]
        new_frame.array = new_array
        self.stack.frames = [new_frame]
        self.first_frame = first_frame + 1
        self.last_frame = last_frame + 1
        super().analyze(ufov_ratio=ufov_ratio, threshold=threshold,
                        cfov_ratio=cfov_ratio, window_size=window_size, device=device)
        self.frame_results[self.frame_key] = self.frame_results.pop("1")
        self.center_ratio = self.center_border_ratio(
            center_ratio=center_ratio * ufov_ratio, window_size=window_size)

    def _generate_results_data(self) -> TomographicUniformityResults:
        return TomographicUniformityResults(
            cfov_integral_uniformity=self.frame_result["cfov"].integral_uniformity,
            cfov_differential_uniformity=self.frame_result["cfov"].differential_uniformity,
            ufov_integral_uniformity=self.frame_result["ufov"].integral_uniformity,
            ufov_differential_uniformity=self.frame_result["ufov"].differential_uniformity,
            center_border_ratio=self.center_ratio,
            first_frame=self.first_frame,
            last_frame=self.last_frame)

    def results(self) -> str:
        return (
            f"Tomographic Uniformity results for {self.path.name}\n"
            f"Frames: {self.first_frame}:{self.last_frame}\n"
            f"CFOV Integral Uniformity: "
            f"{self.frame_result['cfov'].integral_uniformity:.3f}%\n"
            f"CFOV Differential Uniformity: "
            f"{self.frame_result['cfov'].differential_uniformity:.3f}%\n"
            f"UFOV Integral Uniformity: "
            f"{self.frame_result['ufov'].integral_uniformity:.3f}%\n"
            f"UFOV Differential Uniformity: "
            f"{self.frame_result['ufov'].differential_uniformity:.3f}%\n"
            f"Center-to-Border ratio: {self.center_ratio:.3f}\n")

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        return {
            "CFOV Integral Uniformity": QuaacDatum(
                value=data["cfov_integral_uniformity"], unit="%"),
            "UFOV Integral Uniformity": QuaacDatum(
                value=data["ufov_integral_uniformity"], unit="%"),
            "Center-to-Border Ratio": QuaacDatum(
                value=data["center_border_ratio"], unit=""),
        }

    def plot(self, show: bool = True, cmap: str = "gray"):
        import matplotlib.pyplot as plt

        figs, axes = super().plot(show=False, cmap=cmap)
        self.frame_result["center_fov"].plot_to(axes[0], color="b")
        if show:
            plt.show()
        return figs, axes


@dataclasses.dataclass
class TomographicROI:
    """A spherical sample of a 3D array."""

    array3d: np.ndarray
    uniformity_baseline: float
    x: float
    y: float
    z: float
    radius: float
    number: str | int

    def __post_init__(self):
        self.sphere_array = sample_sphere(self.array3d, col=self.x, row=self.y, zed=self.z,
                                          radius=self.radius)

    @property
    def mean_value(self) -> float:
        return float(np.nanmean(self.sphere_array))

    @property
    def min_value(self) -> float:
        return float(np.nanmin(self.sphere_array))

    @property
    def mean_contrast(self) -> float:
        return michelson(np.asarray([self.mean_value, self.uniformity_baseline])) * 100

    @property
    def max_contrast(self) -> float:
        return michelson(np.asarray([self.min_value, self.uniformity_baseline])) * 100

    def plot_to(self, axis):
        d = DiskROI(array=self.array3d[int(round(self.z))],
                    radius=self.radius, center=Point(self.x, self.y))
        d.plot2axes(axes=axis, edgecolor="r", text=str(self.number))


class TomgraphicSphere(TypedDict):
    x: float
    y: float
    z: float
    radius: float
    mean: float
    mean_contrast: float
    max_contrast: float


@dataclasses.dataclass(kw_only=True)
class TomographicContrastResults(ResultBase):
    uniformity_baseline: float
    spheres: dict[str, TomgraphicSphere]


@capture_warnings
class TomographicContrast(ResultsDataMixin, QuaacMixin):
    """Jaszczak sphere contrast against the most uniform slice."""

    def __init__(self, path: str | Path):
        super().__init__()
        self.stack = NMImageStack(path)
        self.path = Path(path)

    @cached_property
    def slice_data(self) -> dict:
        """Per slice: the largest region's FOV (``regionprops`` and the
        erosion on the analysis's device), its area, centre, uniformity and
        mean; the slices whose area falls a standard deviation below the
        median are dropped."""
        device = self._device
        uniformities = {}
        array3d = self.stack.as_3d_array()
        global_max = array3d.max()
        for idx, frame in enumerate(self.stack.frames):
            arr = np.copy(frame.array)
            arr[arr < global_max * 0.10] = 0
            binary_frame = arr > 0
            largest = _largest_region(binary_frame, arr, device)
            if largest is None:
                continue
            bbox = largest.bbox
            longest_dim = max(bbox[2] - bbox[0], bbox[3] - bbox[1])
            erosion = int(round((1 - self.ufov_ratio) * longest_dim))
            eroded = isotropic_erosion(torch.as_tensor(binary_frame, device=device),
                                       radius=erosion / 2).cpu().numpy()
            fov_array = np.where(eroded, arr, np.nan)
            uniformities[str(idx + 1)] = {
                "fov diameter": longest_dim - erosion,
                "center": Point(x=largest.centroid[1], y=largest.centroid[0]),
                "area": int(np.count_nonzero(eroded)),
                "uniformity": michelson(fov_array),
                "value": float(np.nanmean(fov_array)),
            }
        median_area = np.median([v["area"] for v in uniformities.values()])
        std_area = np.std([v["area"] for v in uniformities.values()])
        return {k: v for k, v in uniformities.items() if v["area"] > median_area - std_area}

    @property
    def uniformity_frame(self) -> str:
        return min(self.slice_data, key=lambda x: self.slice_data.get(x)["uniformity"])

    @property
    def uniformity_value(self) -> float:
        return self.slice_data[self.uniformity_frame]["value"]

    def analyze(self, sphere_diameters_mm: Sequence[float] = (38, 31.8, 25.4, 19.1, 15.9, 12.7),
                sphere_angles: Sequence[float] = (-10, -70, -130, -190, 110, 50),
                ufov_ratio: float = 0.8, search_window_px: int = 5,
                search_slices: int = 3, device=None) -> None:
        self._device = resolve_device(device, "TomographicContrast.analyze")
        self.ufov_ratio = ufov_ratio
        uniformities = self.slice_data
        if len(sphere_diameters_mm) != len(sphere_angles):
            raise ValueError("The number of sphere diameters and angles must be the same.")
        max_unif_frame = max(uniformities, key=lambda x: uniformities[x]["uniformity"])
        unif = uniformities[max_unif_frame]
        unif_z = int(max_unif_frame) - 1
        array3d = self.stack.as_3d_array()
        rois = {}
        for idx, (angle, diameter) in enumerate(zip(sphere_angles, sphere_diameters_mm)):
            distance = math.sqrt(unif["area"] / math.pi) * 0.65
            radius = diameter / (2 * self.stack.metadata.PixelSpacing[0])
            col_x, row_y = direction_to_coords(unif["center"].x, unif["center"].y,
                                               distance, angle)
            bounds = np.array([
                [col_x - search_window_px, col_x + search_window_px],
                [row_y - search_window_px, row_y + search_window_px],
                [unif_z - search_slices, unif_z + search_slices]])

            def objective(coords, bounds=bounds, radius=radius):
                # clipped to the search bounds, which scipy's Nelder-Mead
                # takes as bounds
                c = np.clip(np.asarray(coords), bounds[:, 0], bounds[:, 1])
                return contrast_f(c, array3d, radius, self.uniformity_value)

            best = _minimize_nm(objective, np.array([col_x, row_y, unif_z]))
            col, row, zed = np.clip(best, bounds[:, 0], bounds[:, 1])
            rois[str(idx + 1)] = TomographicROI(
                array3d=array3d, x=col, y=row, z=zed, radius=radius,
                uniformity_baseline=self.uniformity_value, number=idx + 1)
        self.rois = rois

    def results(self) -> str:
        s = f"Tomographic Contrast results for {self.path.name}\n"
        s += f"Uniformity baseline: {self.uniformity_value:.1f}\n"
        for idx, roi in self.rois.items():
            s += (f"Sphere {idx}: X={roi.x:.2f},Y={roi.y:.2f},Z={roi.z:.2f} "
                  f"Mean: {roi.mean_value:.2f}; "
                  f"Mean Contrast: {roi.mean_contrast:.2f}; "
                  f"Max Contrast: {roi.max_contrast:.2f}\n")
        return s

    def _generate_results_data(self) -> TomographicContrastResults:
        return TomographicContrastResults(
            uniformity_baseline=self.uniformity_value,
            spheres={idx: TomgraphicSphere(
                x=float(roi.x), y=float(roi.y), z=float(roi.z), radius=float(roi.radius),
                mean=roi.mean_value, mean_contrast=roi.mean_contrast,
                max_contrast=roi.max_contrast)
                for idx, roi in self.rois.items()})

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        data = self.results_data(as_dict=True)
        datum = {f"Sphere {idx} Mean": QuaacDatum(value=s["mean"], unit="")
                 for idx, s in data["spheres"].items()}
        datum["Uniformity Baseline"] = QuaacDatum(
            value=data["uniformity_baseline"], unit="")
        return datum

    def plot(self, show: bool = True):
        import matplotlib.pyplot as plt

        roi_fig, roi_ax = plt.subplots()
        median_slice = int(round(np.median(
            [roi.z for roi in self.rois.values()])))
        roi_ax.imshow(self.stack.frames[median_slice].array, cmap="gray")
        for roi in self.rois.values():
            roi.plot_to(roi_ax)
        roi_ax.set_title(f"Sphere frame ({median_slice + 1})")
        unif_fig, unif_ax = plt.subplots()
        unif_ax.imshow(self.stack.frames[int(self.uniformity_frame) - 1].array,
                       cmap="gray")
        un_data = self.slice_data[self.uniformity_frame]
        Circle((un_data["center"].x, un_data["center"].y),
               radius=un_data["fov diameter"] / 2).plot2axes(
            unif_ax, edgecolor="b")
        unif_ax.set_title(f"Uniformity frame ({self.uniformity_frame})")
        cont_fig, cont_ax = plt.subplots()
        cont_ax.plot([int(i) for i in self.rois],
                     [roi.mean_contrast for roi in self.rois.values()],
                     color="b", marker="o", label="Mean Contrast")
        cont_ax.plot([int(i) for i in self.rois],
                     [roi.max_contrast for roi in self.rois.values()],
                     color="r", marker="o", label="Max Contrast")
        cont_ax.set_xlabel("Sphere Number")
        cont_ax.set_ylabel("Contrast (Michelson * 100)")
        cont_ax.legend()
        cont_ax.grid(True)
        cont_ax.set_title("Contrast vs Sphere Number")
        if show:
            plt.show()
        return (roi_fig, unif_fig, cont_fig), (roi_ax, unif_ax, cont_ax)


def _minimize_nm(f, x0: np.ndarray) -> np.ndarray:
    """Host Nelder-Mead (scipy's default coefficients and start simplex)
    for the sphere search, whose objective builds masks of its own."""
    n = len(x0)
    nonzdelt, zdelt = 0.05, 0.00025
    simplex = [np.asarray(x0, float)]
    for k in range(n):
        x = np.array(simplex[0], float)
        x[k] = x[k] * (1 + nonzdelt) if x[k] != 0 else zdelt
        simplex.append(x)
    simplex = np.asarray(simplex)
    fvals = np.array([f(x) for x in simplex])
    for _ in range(200 * n):
        order = np.argsort(fvals)
        simplex, fvals = simplex[order], fvals[order]
        if (np.max(np.abs(simplex[1:] - simplex[0])) < 1e-4
                and np.max(np.abs(fvals[1:] - fvals[0])) < 1e-4):
            break
        centroid = simplex[:-1].mean(axis=0)
        xr = centroid + (centroid - simplex[-1])
        fr = f(xr)
        if fr < fvals[0]:
            xe = centroid + 2 * (centroid - simplex[-1])
            fe = f(xe)
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
        elif fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)
            fc = f(xc)
            if fc < fvals[-1]:
                simplex[-1], fvals[-1] = xc, fc
            else:
                simplex[1:] = simplex[0] + 0.5 * (simplex[1:] - simplex[0])
                fvals[1:] = [f(x) for x in simplex[1:]]
    return simplex[np.argmin(fvals)]


def create_sphere_mask(array_shape, row: float, col: float, zed: float,
                       radius: float) -> np.ndarray:
    z, y, x = np.ogrid[:array_shape[0], :array_shape[1], :array_shape[2]]
    return (x - col) ** 2 + (y - row) ** 2 + (z - zed) ** 2 <= radius ** 2


def sample_sphere(array: np.ndarray, row: float, col: float, zed: float,
                  radius: float) -> np.ndarray:
    mask = create_sphere_mask(array.shape, row=row, col=col, zed=zed, radius=radius)
    out = np.full(array.shape, np.nan)
    out[mask] = array[mask]
    return out


def _sphere_values(array: np.ndarray, row: float, col: float, zed: float,
                   radius: float) -> np.ndarray:
    """The voxels of :func:`sample_sphere`'s sphere, as float64, read from
    its bounding box only."""
    lo = [max(int(np.floor(c - radius)) - 1, 0) for c in (zed, row, col)]
    hi = [max(min(int(np.ceil(c + radius)) + 2, n), 0)
          for c, n in zip((zed, row, col), array.shape)]
    z, y, x = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    mask = (x - col) ** 2 + (y - row) ** 2 + (z - zed) ** 2 <= radius ** 2
    return array[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][mask].astype(np.float64)


def contrast_f(coords, array: np.ndarray, radius: float, uniformity_baseline: float) -> float:
    """The negative Michelson contrast (x 100) of the sphere's mean against
    the baseline. The mean is taken over the sphere's bounding box, not the
    whole volume as JAX's ``nanmean`` of :func:`sample_sphere` takes it: the
    same voxels summed in another order, so the objective may differ from
    JAX's in its last bits, and a 128-slice search takes milliseconds a
    call instead of tens."""
    col, row, zed = coords
    values = _sphere_values(array, col=col, row=row, zed=zed, radius=radius)
    return -michelson(np.asarray([np.nanmean(values), uniformity_baseline])) * 100
