"""The SNC Profiler's ``.prs`` text export, numpy only.

Port of ``SNCProfiler`` (``pylinac_tpu/core/io.py:82``). The demo and URL
retrieval of that module are not carried over: the port reads local files.
"""

from __future__ import annotations

import math

import numpy as np


class SNCProfiler:
    """Parser for Sun Nuclear Profiler .prs text exports
    (reference ``core/io.py:246``)."""

    def __init__(
        self,
        path: str,
        gain_row: int = 20,
        detector_row: int = 106,
        bias_row: int = 107,
        calibration_row: int = 108,
        data_row: int = -1,
        data_columns: slice = slice(5, 259),
    ):
        with open(path, encoding="cp437") as f:
            raw = f.read().splitlines()
        self.detectors = raw[detector_row].split("\t")[data_columns]
        self.bias = np.array(raw[bias_row].split("\t")[data_columns]).astype(float)
        self.calibration = np.array(raw[calibration_row].split("\t")[data_columns]).astype(float)
        self.data = np.array(raw[data_row].split("\t")[data_columns]).astype(float)
        self.gain = float(raw[gain_row].split("\t")[1])
        self.timetic = float(raw[data_row].split("\t")[2])
        self.integrated_dose = (
            self.calibration * (self.data - self.bias * self.timetic) / self.gain
        )

    def to_profiles(self, n_detectors_row: int = 63, **kwargs):
        """The dose array as the four axis SingleProfiles (x, y, +45, -45)."""
        from .profile import SingleProfile

        def drop_cax_sides(vals: np.ndarray) -> np.ndarray:
            x_vals = np.arange(start=1, stop=len(vals) + 3)
            half_idx = math.ceil(len(x_vals) / 2) - 1
            return np.delete(x_vals, [half_idx - 1, half_idx + 1])

        y_vals = self.integrated_dose[n_detectors_row: 2 * n_detectors_row + 2]
        y_prof = SingleProfile(y_vals, x_values=np.arange(1, len(y_vals) + 1), **kwargs)
        x_vals = self.integrated_dose[:n_detectors_row]
        x_prof = SingleProfile(x_vals, x_values=drop_cax_sides(x_vals), **kwargs)
        pos_vals = self.integrated_dose[2 * n_detectors_row + 2: 3 * n_detectors_row + 2]
        pos_prof = SingleProfile(pos_vals, x_values=drop_cax_sides(pos_vals), **kwargs)
        neg_vals = self.integrated_dose[3 * n_detectors_row + 2: 4 * n_detectors_row + 2]
        neg_prof = SingleProfile(neg_vals, x_values=drop_cax_sides(neg_vals), **kwargs)
        return x_prof, y_prof, pos_prof, neg_prof
