"""The SNC Profiler's ``.prs`` text export, numpy only, zip archives and
folder listings.

Port of ``TemporaryZipDirectory`` (``pylinac_tpu/core/io.py:21``),
``retrieve_filenames`` (``:35``) and ``SNCProfiler`` (``:82``). The demo and
URL retrieval of that module are not carried over: the port reads local
files.
"""

from __future__ import annotations

import math
import tempfile
import zipfile
from pathlib import Path
from typing import BinaryIO

import numpy as np


class TemporaryZipDirectory(tempfile.TemporaryDirectory):
    """A zip archive extracted to a temporary directory; context-managed.
    With ``delete=False`` leaving the context keeps the directory, which is
    then removed when the object is collected."""

    def __init__(self, zfile: str | Path | BinaryIO, delete: bool = True):
        super().__init__()
        self.delete = delete
        with zipfile.ZipFile(zfile) as zf:
            zf.extractall(self.name)

    def __exit__(self, exc, value, tb):
        if self.delete:
            super().__exit__(exc, value, tb)


def retrieve_filenames(directory: str | Path, func=None, recursive: bool = True,
                       **kwargs) -> list[str]:
    """The files of a folder (and its subfolders when ``recursive``), in
    sorted order, that pass ``func(path, **kwargs)``."""
    func = func or (lambda p: True)
    directory = Path(directory)
    it = directory.rglob("*") if recursive else directory.glob("*")
    return [str(p) for p in sorted(it) if p.is_file() and func(str(p), **kwargs)]


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
