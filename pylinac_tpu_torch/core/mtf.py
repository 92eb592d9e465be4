"""Relative MTF from line-pair maxima and minima, numpy only.

Port of ``MTF`` (``pylinac_tpu/core/mtf.py:16``, with
``from_high_contrast_diskset`` ``:66``) without its plot. The moments and
edge-spread MTFs wait for the slices that use them.
"""

from __future__ import annotations

import warnings
from collections.abc import Sequence

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
