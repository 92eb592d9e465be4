"""MTFs, numpy only: the relative MTF from line-pair maxima and minima,
the moments MTF and the edge-spread-function MTF.

Port of ``pylinac_tpu/core/mtf.py``: ``MTF`` (``:16``, with
``from_high_contrast_diskset`` ``:66``), ``PeakValleyMTF`` (``:88``),
``moments_mtf`` and ``moments_fwhm`` (``:92``, ``:97``), ``MomentMTF``
(``:102``), ``_hann_window`` and ``_compute_esf_mtf`` (``:143``, ``:150``)
and ``EdgeSpreadFunctionMTF`` (``:159``), without their plots.
"""

from __future__ import annotations

import math
import warnings
from collections.abc import Callable, Sequence
from typing import Literal

import numpy as np

from .contrast import michelson


class MTF:
    """Relative MTF from line-pair max/min samples (reference ``core/mtf.py:32``)."""

    def __init__(self, lp_spacings: Sequence[float], lp_maximums: Sequence[float],
                 lp_minimums: Sequence[float]):
        self.spacings = lp_spacings
        self.maximums = lp_maximums
        self.minimums = lp_minimums
        if len(lp_spacings) != len(lp_maximums) != len(lp_minimums):
            raise ValueError(
                "The number of MTF spacings, maximums, and minimums must be equal.")
        if len(lp_spacings) < 2 or len(lp_maximums) < 2 or len(lp_minimums) < 2:
            raise ValueError(
                "The number of MTF spacings, maximums, and minimums must be greater than 1.")
        self.mtfs = {}
        self.norm_mtfs = {}
        for spacing, mx, mn in zip(lp_spacings, lp_maximums, lp_minimums):
            self.mtfs[spacing] = michelson(np.array((mx, mn)))
        self.mtfs = {k: v for k, v in sorted(self.mtfs.items(), key=lambda x: x[0])}
        for key, value in self.mtfs.items():
            self.norm_mtfs[key] = value / self.mtfs[lp_spacings[0]]
        if np.max(np.diff(list(self.norm_mtfs.values()))) > 0:
            warnings.warn(
                "The MTF does not drop monotonically; be sure the ROIs are correctly aligned.")

    def relative_resolution(self, x: float = 50) -> float:
        """The lp/mm at the given % of relative MTF (inverse linear interp +
        extrapolation; reference ``core/mtf.py:137``)."""
        ys = np.array(list(self.norm_mtfs.values()))
        xs = np.array(list(self.norm_mtfs.keys()))
        order = np.argsort(ys)
        ys_sorted = ys[order]
        xs_sorted = xs[order]
        target = x / 100
        # linear interp with linear extrapolation at the ends
        if target <= ys_sorted[0]:
            slope = (xs_sorted[1] - xs_sorted[0]) / (ys_sorted[1] - ys_sorted[0])
            mtf = xs_sorted[0] + (target - ys_sorted[0]) * slope
        elif target >= ys_sorted[-1]:
            slope = (xs_sorted[-1] - xs_sorted[-2]) / (ys_sorted[-1] - ys_sorted[-2])
            mtf = xs_sorted[-1] + (target - ys_sorted[-1]) * slope
        else:
            mtf = np.interp(target, ys_sorted, xs_sorted)
        if mtf > max(self.spacings):
            warnings.warn(
                f"MTF resolution wasn't calculated for {x}% that was asked for. "
                "The value returned is an extrapolation.")
        return float(mtf)

    @classmethod
    def from_high_contrast_diskset(cls, spacings: Sequence[float], diskset) -> "MTF":
        """The MTF of ROIs over line-pair groups: each ROI's max and min."""
        maximums = [roi.max for roi in diskset]
        minimums = [roi.min for roi in diskset]
        return cls(spacings, maximums, minimums)


class PeakValleyMTF(MTF):
    pass


def moments_mtf(mean: float, std: float) -> float:
    """Hander et al 1997 eq 8."""
    return math.sqrt(2 * (std**2 - mean)) / mean


def moments_fwhm(width: float, mean: float, std: float) -> float:
    """Hander et al 1997 eq A8."""
    return 1.058 * width * math.sqrt(np.log(mean / (math.sqrt(2 * (std**2 - mean)))))


class MomentMTF:
    """Moments-based MTF (Hander et al 1997): each line-pair group's MTF and
    FWHM from its ROI's mean and standard deviation."""

    def __init__(self, lpmms: Sequence[float], means: Sequence[float],
                 stds: Sequence[float]):
        self.lpmms = lpmms
        self.mtfs = {}
        self.fwhms = {}
        for lpmm, mean, std in zip(lpmms, means, stds):
            self.mtfs[lpmm] = moments_mtf(mean, std)
            bar_width = 1 / (2 * lpmm)  # a line pair is 2 bars
            self.fwhms[lpmm] = moments_fwhm(bar_width, mean, std)

    @classmethod
    def from_high_contrast_diskset(cls, lpmms: Sequence[float], diskset) -> "MomentMTF":
        means = [roi.mean for roi in diskset]
        stds = [roi.std for roi in diskset]
        return cls(lpmms, means, stds)


def _hann_window(n: int) -> np.ndarray:
    """scipy.signal.windows.hann (symmetric)."""
    if n == 1:
        return np.ones(1)
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


def _compute_esf_mtf(esf: np.ndarray, num_samples: int, windowing: Callable, **kwargs):
    lsf = np.gradient(esf)
    lsf_windowed = lsf * windowing(len(esf), **kwargs)
    mtf = np.abs(np.fft.fft(lsf_windowed, num_samples))
    mtf = mtf / mtf[0]
    return mtf[: num_samples // 2], esf, lsf, lsf_windowed


class EdgeSpreadFunctionMTF:
    """MTF from edge spread functions: the windowed gradient's FFT of each,
    normalised to its zero frequency, averaged."""

    def __init__(self, esf: list[np.ndarray], sample_spacing: float | None = None,
                 padding_mode: Literal["none", "fixed", "auto"] = "auto",
                 num_samples: int = 1024, windowing: Callable | None = _hann_window,
                 **kwargs):
        self.sample_spacing = sample_spacing
        windowing = windowing or (lambda n: np.ones(n))
        len_esf = np.unique([len(e) for e in esf])
        if padding_mode == "none":
            if len(len_esf) > 1:
                raise ValueError(
                    "If padding_mode='none', all ESF samples must have the same size")
            num_samples = int(len_esf[0])
        elif padding_mode == "fixed":
            if num_samples < max(len_esf):
                raise ValueError("num_samples must be larger than the largest array")
        elif padding_mode == "auto":
            next_pow2 = max(2 ** np.ceil(np.log2(len_esf)))
            num_samples = int(max(next_pow2, num_samples))
        pixel_spacing = 1 if sample_spacing is None else sample_spacing
        freq = np.fft.fftfreq(num_samples, d=pixel_spacing)
        self.freq = freq[: num_samples // 2]
        results = [_compute_esf_mtf(np.asarray(e, dtype=float), num_samples, windowing, **kwargs)
                   for e in esf]
        self._mtf, self._esf, self._lsf, self._lsf_windowed = (
            list(x) for x in zip(*results))
        self.mtf = np.mean(np.array(self._mtf), axis=0)

    def relative_resolution(self, x: float = 50) -> float:
        return float(np.interp(-x / 100, -self.mtf, self.freq))
