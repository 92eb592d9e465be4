"""Dosimetric leaf gap (DLG) from a sweeping-gap EPID image.

Port of ``pylinac_tpu/dlg.py`` (``:1-99``, ``DLG`` ``:21``): a profile
window across each leaf pair inside the field, the measured gap from the
profile's peak prominence, and a straight line through measured against
planned gap; the DLG is where that line crosses zero. Host numpy, with
:func:`pylinac_tpu_torch.ops.peaks.find_peaks` on the CPU, as the JAX
package routes 1D profiles, so ``DLG`` takes no device. ``plot_dlg``
(``:62``) imports matplotlib inside, and raises ``ModuleNotFoundError``
where it is missing.
"""

from __future__ import annotations

from math import ceil, floor
from typing import Sequence

import numpy as np

from .core import image
from .core.array_utils import invert
from .ops.peaks import find_peaks
from .picketfence import MLC


class DLG:
    """Dosimetric leaf gap from leaf-overlap profiles."""

    def __init__(self, path):
        self.image = image.LinacDicomImage(path)
        self.measured_dlg: float = -np.inf
        self.measured_dlg_per_leaf: list = []
        self.planned_dlg_per_leaf: list = []
        self._lin_fit = None

    def analyze(self, gaps: Sequence, mlc: MLC, y_field_size: float = 100,
                profile_width: int = 10):
        """Measure the DLG of an image whose leaf pairs close with the
        ``gaps`` (mm), one gap to each of ``len(gaps)`` equal bands of the
        ``y_field_size`` field, across a window ``profile_width`` mm either
        side of the centre."""
        measured_dlg_per_leaf = []
        planned_dlg_per_leaf = []
        arrangement = mlc.value["arrangement"]
        g = sorted(gaps)
        profile_width_px = round(self.image.dpmm * profile_width)
        mid_width = self.image.shape[1] / 2
        mid_height = self.image.shape[0] / 2
        for idx, center in enumerate(arrangement.centers):
            if -y_field_size / 2 < center < y_field_size / 2:
                center_px = center * self.image.dpmm
                width_px = arrangement.widths[idx] / 4 * self.image.dpmm
                top = ceil(mid_height + center_px + width_px)
                bottom = floor(mid_height + center_px - width_px)
                window = self.image[
                    bottom:top,
                    int(mid_width - profile_width_px):int(mid_width + profile_width_px)]
                planned_dlg_per_leaf.append(self._get_dlg_offset(y_field_size, center, g))
                measured_dlg_per_leaf.append(self._determine_measured_gap(window.mean(axis=0)))
        # the least-squares line; the DLG is the planned gap where it is 0
        slope, intercept = np.polyfit(planned_dlg_per_leaf, measured_dlg_per_leaf, 1)
        self._lin_fit = (slope, intercept)
        self.measured_dlg = float(intercept / slope)
        self.planned_dlg_per_leaf = planned_dlg_per_leaf
        self.measured_dlg_per_leaf = measured_dlg_per_leaf

    def plot_dlg(self, show: bool = True) -> None:
        """The measured against the planned gaps, with the fitted line, on
        the current axes."""
        import matplotlib.pyplot as plt

        if not self.measured_dlg_per_leaf:
            raise ValueError("Analyze the image before plotting with .analyze()")
        slope, intercept = self._lin_fit
        plt.plot(self.planned_dlg_per_leaf, self.measured_dlg_per_leaf, "gx")
        plt.plot(self.planned_dlg_per_leaf,
                 intercept + slope * np.array(self.planned_dlg_per_leaf),
                 "r", label="fitted line")
        plt.title(f"Measured DLG: {self.measured_dlg:2.3f}mm")
        plt.grid()
        if show:
            plt.show()

    @staticmethod
    def _get_dlg_offset(field_size: float, leaf_center: float, dlgs: Sequence) -> float:
        """The planned gap of the band that holds the leaf's centre."""
        roi_size = field_size / len(dlgs)
        y_bounds = [field_size / 2 - idx * roi_size for idx in range(len(dlgs) + 1)]
        for idx, gap in enumerate(dlgs):
            if y_bounds[idx + 1] < leaf_center < y_bounds[idx]:
                return gap

    @staticmethod
    def _determine_measured_gap(profile: np.ndarray) -> float:
        """The profile's peak prominence, negative for a dip."""
        profile = np.asarray(profile, float)
        mid_value = profile[int(len(profile) / 2)]
        inverted = mid_value < profile.mean()
        if inverted:
            profile = invert(profile)
        _, props = find_peaks(profile, max_number=1)
        if inverted:
            return -props["prominences"][0]
        return props["prominences"][0]
