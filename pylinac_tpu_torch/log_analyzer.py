"""Machine log analysis: Varian dynalogs and trajectory logs.

Port of ``pylinac_tpu/log_analyzer.py``: the axes and enums (``:39-165``),
``FluenceBase`` with ``calc_map`` (``:168-281``), ``ActualFluence``,
``ExpectedFluence``, ``GammaFluence`` (``:294``), ``FluenceStruct``,
``MLC`` (``:399``), ``JawStruct``, ``CouchStruct``, ``Subbeam``,
``SubbeamManager``, ``LogBase``, the dynalog reader (``Dynalog`` ``:989``)
and the trajectory-log reader (``TrajectoryLog`` ``:1216``, with
``to_csv``), ``MachineLogs`` (``:1396``, with ``from_zip``, ``avg_gamma``
and ``avg_gamma_pct``), and ``anonymize``, ``load_log``, ``is_log``,
``is_tlog`` and ``is_dlog`` (``:1480-1560``).

The logs are read on the host. A log's fluence maps and gamma run on the
device given to the log (``device=None`` means CUDA, and raises without
it): the map is :func:`.ops.fluence.interval_fluence`, in XLA's CPU order
on both devices, and the gamma is :meth:`.core.image.BaseImage.gamma`
(:func:`.ops.gamma.gamma_bakai`, plain torch). ``anonymize`` reads logs to
rename them and does no device work, so it reads them for the CPU.

The reports are JAX's (``:97-132``, ``:270-283``, ``:349-387``,
``:619-645``, ``:780-870``, ``:1084``, ``:1354``): the axes', maps',
histograms' and summaries' plots and saves, and each reader's
``publish_pdf``, which embeds their PNGs; all import matplotlib inside. The
maps they draw are host arrays already: ``calc_map`` brings each map back
from the device once. Not ported: ``from_url`` and URL loading, which fetch
files from outside.
"""

from __future__ import annotations

import copy
import csv
import enum
import itertools
import os
import os.path as osp
import shutil
import webbrowser
import zipfile
from io import BufferedReader, BytesIO
from pathlib import Path
from typing import BinaryIO, Sequence

import numpy as np
import torch

from .core import image, pdf
from .core.io import TemporaryZipDirectory, retrieve_filenames
from .core.utilities import (
    Structure,
    convert_to_enum,
    decode_binary,
    is_iterable,
    resolve_device,
)
from .ops.fluence import interval_fluence

MLC_FOV_WIDTH_MM = 400
MLC_FOV_HEIGHT_MM = 400
HDMLC_FOV_HEIGHT_MM = 220
DYNALOG_LEAF_CONVERSION = 1.96078  # physical plane -> isoplane scaling


class TreatmentType(enum.Enum):
    STATIC_IMRT = "Static IMRT"
    DYNAMIC_IMRT = "Dynamic IMRT"
    VMAT = "VMAT"
    IMAGING = "Imaging"


class MLCBank(enum.Enum):
    A = "A"
    B = "B"
    BOTH = "both"


class Fluence(enum.Enum):
    ACTUAL = "actual"
    EXPECTED = "expected"
    GAMMA = "gamma"


class Graph(enum.Enum):
    GAMMA = "gamma"
    HISTOGRAM = "histogram"
    RMS = "rms"


class NotALogError(IOError):
    """The passed file is not a valid machine log file."""


class NotADynalogError(IOError):
    """The passed file is not a valid dynalog file."""


class DynalogMatchError(IOError):
    """The dynalog companion file (A/B) cannot be found."""


class Axis:
    """Actual, expected and difference values of one machine axis."""

    def __init__(self, actual: np.ndarray, expected: np.ndarray | None = None):
        self.actual = actual
        self.expected = expected
        if expected is not None:
            try:
                if len(actual) != len(expected):
                    raise ValueError("Actual and expected Axis parameters are not equal length")
            except TypeError:
                pass

    @property
    def difference(self) -> np.ndarray:
        if self.expected is not None:
            return self.actual - self.expected
        raise AttributeError("Expected positions not passed to Axis")

    def plot_actual(self) -> None:
        self._plot("actual")

    def save_plot_actual(self, filename: str, **kwargs) -> None:
        self._plot("actual", show=False)
        self._save(filename, **kwargs)

    def plot_expected(self) -> None:
        self._plot("expected")

    def save_plot_expected(self, filename: str, **kwargs) -> None:
        self._plot("expected", show=False)
        self._save(filename, **kwargs)

    def plot_difference(self) -> None:
        self._plot("difference")

    def save_plot_difference(self, filename: str, **kwargs) -> None:
        self._plot("difference", show=False)
        self._save(filename, **kwargs)

    def _plot(self, param: str, show: bool = True):
        import matplotlib.pyplot as plt

        if param not in ("actual", "expected", "difference"):
            raise ValueError("param must be actual, expected, or difference")
        plt.plot(getattr(self, param))
        plt.grid(True)
        plt.autoscale(axis="x", tight=True)
        if show:
            plt.show()

    def _save(self, filename: str, **kwargs):
        import matplotlib.pyplot as plt

        plt.savefig(filename, **kwargs)


class AxisMovedMixin:
    AXIS_MOVE_THRESHOLD: float = 0.003

    @property
    def moved(self) -> bool:
        """Whether the axis moved during treatment."""
        return bool(np.std(self.actual) > self.AXIS_MOVE_THRESHOLD)


class LeafAxis(Axis, AxisMovedMixin):
    def __init__(self, actual, expected):
        super().__init__(actual, expected)


class GantryAxis(Axis, AxisMovedMixin):
    pass


class HeadAxis(Axis, AxisMovedMixin):
    pass


class CouchAxis(Axis, AxisMovedMixin):
    pass


class BeamAxis(Axis):
    pass


def _get_array_cmap():
    return "viridis"


class FluenceBase:
    """Base of the actual and expected fluence maps: ``calc_map`` gathers
    every leaf pair's aperture edges on the host, then builds the map in
    one device call."""

    resolution = -1
    FLUENCE_TYPE = ""

    def __init__(self, mlc_struct=None, mu_axis: Axis = None, jaw_struct=None, device=None):
        self.array: np.ndarray = np.empty((0, 0))
        self._mlc = mlc_struct
        self._mu = mu_axis
        self._jaws = jaw_struct
        self._device = device
        self._cache_key = None

    def is_map_calced(self, raise_error: bool = False) -> bool:
        calced = self.array.size > 0
        if not calced and raise_error:
            raise ValueError("Map has not yet been calculated. Use .calc_map() with desired "
                             "parameters first.")
        return calced

    def calc_map(self, resolution: float = 0.1, equal_aspect: bool = False) -> np.ndarray:
        key = (resolution, equal_aspect)
        if self._cache_key == key and self.array.size:
            return self.array

        height = HDMLC_FOV_HEIGHT_MM if self._mlc.hdmlc else MLC_FOV_HEIGHT_MM
        num_pairs = self._mlc.num_pairs
        width = int(MLC_FOV_WIDTH_MM / resolution)
        if equal_aspect:
            empty = np.zeros((int(height / resolution), width), float)
        else:
            empty = np.zeros((num_pairs, width), float)
        self.array = empty
        self.resolution = resolution
        self._cache_key = key

        snapshots = np.asarray(self._mlc.snapshot_idx, dtype=int)
        if snapshots.size < 1:
            return empty
        mu_matrix = getattr(self._mu, self.FLUENCE_TYPE)
        if np.max(mu_matrix) < 0.5:  # kV/MV setup, no dose
            return empty
        mu_differential = np.concatenate([[mu_matrix[0]], np.diff(mu_matrix)])
        mu_total = mu_matrix[-1]

        pos_offset = int(np.round(200 / resolution))
        # (P, S) leaf positions; bank A is the right side, bank B the left
        right = np.stack([
            np.round(getattr(self._mlc.leaf_axes[p], self.FLUENCE_TYPE)[snapshots]
                     * 10 / resolution) + pos_offset
            for p in range(1, num_pairs + 1)])
        left = np.stack([
            -np.round(getattr(self._mlc.leaf_axes[p + num_pairs], self.FLUENCE_TYPE)[snapshots]
                      * 10 / resolution) + pos_offset
            for p in range(1, num_pairs + 1)])
        left_jaw = np.round(200 / resolution - self._jaws.x1.actual[snapshots] * 10 / resolution)
        right_jaw = np.round(self._jaws.x2.actual[snapshots] * 10 / resolution + 200 / resolution)
        left_edges = np.maximum(left, left_jaw[None, :]).astype(np.int32)
        right_edges = np.minimum(right, right_jaw[None, :]).astype(np.int32)
        blocked = np.array([self._mlc.leaf_under_y_jaw(p) for p in range(1, num_pairs + 1)])

        device = self._device
        fluence = interval_fluence(
            torch.as_tensor(np.clip(left_edges, 0, width), device=device),
            torch.as_tensor(np.clip(right_edges, 0, width), device=device),
            torch.as_tensor(mu_differential[snapshots].astype(np.float32), device=device),
            torch.as_tensor(blocked, device=device), width).cpu().numpy()

        if mu_total == 25000:  # dynalog: normalise the arbitrary MU scale
            fluence = fluence / mu_total

        if equal_aspect:
            fluence = np.repeat(fluence, self._leaf_pixel_widths(resolution), axis=0)
        self.array = fluence
        return fluence

    def _leaf_pixel_widths(self, resolution: float) -> np.ndarray:
        """Each pair's pixel height for the equal-aspect map."""
        if not self._mlc.hdmlc:
            sizes = [10 / resolution] * 10 + [5 / resolution] * 40 + [10 / resolution] * 10
        else:
            sizes = [5 / resolution] * 14 + [2.5 / resolution] * 32 + [5 / resolution] * 14
        positions = np.cumsum([0] + sizes).astype(int)
        return np.diff(positions)[:self._mlc.num_pairs]

    def plot_map(self, show: bool = True) -> None:
        import matplotlib.pyplot as plt

        self.is_map_calced(raise_error=True)
        plt.clf()
        plt.imshow(self.array, aspect="auto", cmap=_get_array_cmap())
        if show:
            plt.show()

    def save_map(self, filename: str, **kwargs) -> None:
        import matplotlib.pyplot as plt

        self.plot_map(show=False)
        plt.savefig(filename, **kwargs)


class ActualFluence(FluenceBase):
    FLUENCE_TYPE = "actual"


class ExpectedFluence(FluenceBase):
    FLUENCE_TYPE = "expected"


class GammaFluence(FluenceBase):
    """The gamma (Bakai) of the actual fluence against the expected."""

    distTA = -1
    doseTA = -1
    threshold = -1
    pass_prcnt = -1
    avg_gamma = -1
    bins = [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 1.1]

    def __init__(self, actual_fluence: ActualFluence, expected_fluence: ExpectedFluence,
                 mlc_struct, device=None):
        self.array = np.empty((0, 0))
        self.passfail_array = np.empty((0, 0))
        self._actual_fluence = actual_fluence
        self._expected_fluence = expected_fluence
        self._mlc = mlc_struct
        self._device = device
        self._cache_key = None

    def calc_map(self, doseTA: float = 1, distTA: float = 1, threshold: float = 0.1,
                 resolution: float = 0.1, calc_individual_maps: bool = False) -> np.ndarray:
        key = (doseTA, distTA, threshold, resolution)
        if self._cache_key == key and self.array.size:
            return self.array
        if (not self._actual_fluence.is_map_calced()
                or resolution != self._actual_fluence.resolution):
            self._actual_fluence.calc_map(resolution)
        if (not self._expected_fluence.is_map_calced()
                or resolution != self._expected_fluence.resolution):
            self._expected_fluence.calc_map(resolution)

        actual_img = image.load(self._actual_fluence.array, dpi=25.4 / resolution)
        expected_img = image.load(self._expected_fluence.array, dpi=25.4 / resolution)
        gamma_map = actual_img.gamma(expected_img, doseTA=doseTA, distTA=distTA,
                                     threshold=threshold, device=self._device)

        self.avg_gamma = float(np.nanmean(gamma_map))
        if np.isnan(self.avg_gamma):
            self.avg_gamma = 0
        finite = gamma_map[~np.isnan(gamma_map)]
        pixels_passing = np.sum(finite < 1)
        all_calcd = np.sum(finite >= 0)
        self.pass_prcnt = float(pixels_passing / all_calcd * 100)
        gamma_map = np.nan_to_num(gamma_map)
        self.passfail_array = gamma_map >= 1
        self.distTA = distTA
        self.doseTA = doseTA
        self.threshold = threshold
        self.resolution = resolution
        self._cache_key = key
        self.array = gamma_map
        return gamma_map

    def histogram(self, bins: list | None = None):
        self.is_map_calced(raise_error=True)
        return np.histogram(self.array, bins=bins if bins is not None else self.bins)

    def plot_map(self, show: bool = True):
        import matplotlib.pyplot as plt

        self.is_map_calced(raise_error=True)
        plt.imshow(self.array, aspect="auto", vmax=1, cmap=_get_array_cmap())
        plt.colorbar()
        if show:
            plt.show()

    def plot_histogram(self, scale: str = "log", bins: list | None = None,
                       show: bool = True) -> None:
        import matplotlib.pyplot as plt

        if scale not in ("log", "linear"):
            raise ValueError("scale must be log or linear")
        self.is_map_calced(raise_error=True)
        plt.clf()
        plt.hist(self.array.flatten(), bins=bins if bins is not None else self.bins)
        plt.yscale(scale)
        if show:
            plt.show()

    def save_histogram(self, filename: str, scale: str = "log",
                       bins: list | None = None, **kwargs) -> None:
        import matplotlib.pyplot as plt

        self.plot_histogram(scale, bins, show=False)
        plt.savefig(filename, **kwargs)

    def plot_passfail_map(self) -> None:
        import matplotlib.pyplot as plt

        self.is_map_calced(raise_error=True)
        plt.imshow(self.passfail_array, cmap=_get_array_cmap())
        plt.show()


class FluenceStruct:
    """The actual, expected and gamma fluence of one log."""

    def __init__(self, mlc_struct=None, mu_axis: Axis = None, jaw_struct=None, device=None):
        self.actual = ActualFluence(mlc_struct, mu_axis, jaw_struct, device)
        self.expected = ExpectedFluence(mlc_struct, mu_axis, jaw_struct, device)
        self.gamma = GammaFluence(self.actual, self.expected, mlc_struct, device)


class MLC:
    """MLC leaf data and its RMS and error statistics. Leaf numbers are
    1-indexed, as Varian numbers them: bank A is leaves 1 .. num_pairs, bank
    B the rest."""

    def __init__(self, log_type, snapshot_idx=None, jaw_struct=None, hdmlc: bool = False,
                 subbeams=None):
        self.leaf_axes: dict[int, LeafAxis] = {}
        self.snapshot_idx = snapshot_idx
        self._jaws = jaw_struct
        self.hdmlc = hdmlc
        self.log_type = log_type
        self.subbeams = subbeams
        self._moving_cache = None

    @classmethod
    def from_dlog(cls, dlog, jaws, snapshot_data: np.ndarray, snapshot_idx):
        mlc = MLC(Dynalog, snapshot_idx, jaws)
        for leaf in range(1, (dlog.header.num_mlc_leaves // 2) + 1):
            axis = LeafAxis(expected=snapshot_data[(leaf - 1) * 4 + 14],
                            actual=snapshot_data[(leaf - 1) * 4 + 15])
            mlc.add_leaf_axis(axis, leaf)
        with open(dlog.b_logfile, encoding="utf-8") as csvf:
            dlgdata = list(csv.reader(csvf, delimiter=","))
            b_data = np.array(dlgdata[dlog.HEADER_LINE_LENGTH:], dtype=float).transpose()
        for leaf in range(1, (dlog.header.num_mlc_leaves // 2) + 1):
            axis = LeafAxis(expected=b_data[(leaf - 1) * 4 + 14],
                            actual=b_data[(leaf - 1) * 4 + 15])
            mlc.add_leaf_axis(axis, leaf_num=leaf + dlog.header.num_mlc_leaves // 2)
        # from 100ths of a mm at the physical plane to cm at the isoplane
        for leaf in range(1, mlc.num_leaves + 1):
            mlc.leaf_axes[leaf].actual = (
                mlc.leaf_axes[leaf].actual * DYNALOG_LEAF_CONVERSION / 1000)
            mlc.leaf_axes[leaf].expected = (
                mlc.leaf_axes[leaf].expected * DYNALOG_LEAF_CONVERSION / 1000)
        return mlc

    @classmethod
    def from_tlog(cls, tlog, subbeams, jaws, snapshot_data, snapshot_idx, column_iter):
        mlc = MLC(TrajectoryLog, snapshot_idx, jaws, tlog.is_hdmlc, subbeams=subbeams)
        for leaf_num in range(1, tlog.header.num_mlc_leaves + 1):
            leaf_axis = _get_axis(snapshot_data, next(column_iter), LeafAxis)
            mlc.add_leaf_axis(leaf_axis, leaf_num)
        return mlc

    @property
    def num_pairs(self) -> int:
        return int(self.num_leaves / 2)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_axes)

    @property
    def num_snapshots(self) -> int:
        return len(self.snapshot_idx)

    @property
    def num_moving_leaves(self) -> int:
        return len(self.moving_leaves)

    @property
    def moving_leaves(self) -> np.ndarray:
        if self._moving_cache is None:
            threshold = 0.01
            indices = []
            for leaf_num, leafdata in self.leaf_axes.items():
                if (self.log_type is TrajectoryLog and self.subbeams is not None
                        and len(self.subbeams)):
                    leaf_std = np.std(leafdata.actual[self.subbeams[-1]._snapshots])
                else:
                    leaf_std = np.std(leafdata.actual[self.snapshot_idx])
                if leaf_std > threshold:
                    indices.append(leaf_num)
            self._moving_cache = np.array(indices)
        return self._moving_cache

    def add_leaf_axis(self, leaf_axis: LeafAxis, leaf_num: int) -> None:
        self.leaf_axes[leaf_num] = leaf_axis

    def leaf_moved(self, leaf_num: int) -> bool:
        return leaf_num in self.moving_leaves

    def pair_moved(self, pair_num: int) -> bool:
        return self.leaf_moved(pair_num) or self.leaf_moved(pair_num + self.num_pairs)

    @property
    def _all_leaf_indices(self) -> np.ndarray:
        return np.array(range(1, len(self.leaf_axes) + 1))

    def get_RMS_avg(self, bank: MLCBank = MLCBank.BOTH, only_moving_leaves: bool = False) -> float:
        leaves = self.get_leaves(bank, only_moving_leaves)
        rms = np.mean(self.create_RMS_array(leaves))
        return 0 if np.isnan(rms) else float(rms)

    def get_RMS_max(self, bank: MLCBank = MLCBank.BOTH) -> float:
        leaves = self.get_leaves(bank)
        rms = np.max(self.create_RMS_array(leaves))
        return 0 if np.isnan(rms) else float(rms)

    def get_RMS_percentile(self, percentile: float = 95, bank: MLCBank = MLCBank.BOTH,
                           only_moving_leaves: bool = False) -> float:
        leaves = self.get_leaves(bank, only_moving_leaves)
        return float(np.percentile(self.create_RMS_array(leaves), percentile))

    def get_RMS(self, leaves_or_bank) -> np.ndarray:
        if isinstance(leaves_or_bank, (str, MLCBank)):
            leaves_or_bank = self.get_leaves(leaves_or_bank)
        elif not is_iterable(leaves_or_bank):
            raise TypeError("Input must be iterable, or specify an MLC bank")
        return self.create_RMS_array(np.array(leaves_or_bank))

    def get_leaves(self, bank: MLCBank = MLCBank.BOTH,
                   only_moving_leaves: bool = False) -> np.ndarray:
        bank = convert_to_enum(bank, MLCBank)
        if only_moving_leaves:
            leaves = np.copy(self.moving_leaves)
        else:
            leaves = np.copy(self._all_leaf_indices)
        if bank == MLCBank.A:
            leaves = leaves[leaves <= self.num_pairs]
        elif bank == MLCBank.B:
            leaves = leaves[leaves > self.num_pairs]
        return leaves

    def get_error_percentile(self, percentile: float = 95, bank: MLCBank = MLCBank.BOTH,
                             only_moving_leaves: bool = False) -> float:
        leaves = self.get_leaves(bank, only_moving_leaves)
        leaves = leaves - 1
        error_array = self.create_error_array(leaves)
        return float(np.percentile(np.abs(error_array), percentile))

    def create_error_array(self, leaves: Sequence[int], absolute: bool = True) -> np.ndarray:
        arr = self._abs_error_all_leaves if absolute else self._error_array_all_leaves
        return arr[leaves, :]

    def create_RMS_array(self, leaves: Sequence[int]) -> np.ndarray:
        leaves = np.asarray(leaves) - 1
        if len(leaves) == 0:
            return np.array([0])
        return self._RMS_array_all_leaves[leaves]

    @property
    def _abs_error_all_leaves(self) -> np.ndarray:
        return np.abs(self._error_array_all_leaves)

    @property
    def _error_array_all_leaves(self) -> np.ndarray:
        if getattr(self, "_error_cache", None) is None:
            mlc_error = np.zeros((self.num_leaves, self.num_snapshots))
            for leaf in range(self.num_leaves):
                mlc_error[leaf, :] = self.leaf_axes[leaf + 1].difference[self.snapshot_idx]
            self._error_cache = mlc_error
        return self._error_cache

    def _snapshot_array(self, dtype: str = "actual") -> np.ndarray:
        arr = np.zeros((self.num_leaves, self.num_snapshots))
        for leaf in range(self.num_leaves):
            arr[leaf, :] = getattr(self.leaf_axes[leaf + 1], dtype)[self.snapshot_idx]
        return arr

    @property
    def _RMS_array_all_leaves(self) -> np.ndarray:
        if getattr(self, "_rms_cache", None) is None:
            self._rms_cache = np.array([
                np.sqrt(np.sum(leafdata.difference[self.snapshot_idx] ** 2) / self.num_snapshots)
                for leafdata in self.leaf_axes.values()])
        return self._rms_cache

    def leaf_under_y_jaw(self, leaf_num: int) -> bool:
        """Whether the leaf is wholly behind a Y jaw."""
        outer_leaf_thickness = 10  # mm
        inner_leaf_thickness = 5
        mlc_position = 0
        if self.hdmlc:
            outer_leaf_thickness /= 2
            inner_leaf_thickness /= 2
            mlc_position = 100
        for leaf in range(1, leaf_num + 1):
            if 10 >= leaf or leaf >= 110:
                mlc_position += outer_leaf_thickness
            elif 50 >= leaf or leaf >= 70:
                mlc_position += inner_leaf_thickness
            else:
                mlc_position += outer_leaf_thickness
        y2_position = self._jaws.y2.actual.max() * 10 + 200
        y1_position = 200 - self._jaws.y1.actual.max() * 10
        if 10 >= leaf_num or leaf_num >= 110:
            thickness = outer_leaf_thickness
        elif 50 >= leaf_num or leaf_num >= 70:
            thickness = inner_leaf_thickness
        else:
            thickness = outer_leaf_thickness
        return mlc_position < y1_position or mlc_position - thickness > y2_position

    def get_snapshot_values(self, bank_or_leaf=MLCBank.BOTH, dtype: str = "actual") -> np.ndarray:
        if isinstance(bank_or_leaf, (str, MLCBank)):
            leaves = self.get_leaves(bank=bank_or_leaf)
            leaves = leaves - 1
        else:
            leaves = bank_or_leaf
        return self._snapshot_array(dtype)[leaves, :]

    def plot_mlc_error_hist(self, show: bool = True) -> None:
        import matplotlib.pyplot as plt

        plt.hist(self._abs_error_all_leaves.flatten())
        if show:
            plt.show()

    def save_mlc_error_hist(self, filename: str, **kwargs) -> None:
        import matplotlib.pyplot as plt

        self.plot_mlc_error_hist(show=False)
        plt.savefig(filename, **kwargs)

    def plot_rms_by_leaf(self, show: bool = True) -> None:
        import matplotlib.pyplot as plt

        plt.clf()
        rms = self.get_RMS(MLCBank.BOTH)
        plt.bar(np.arange(len(rms))[::-1], rms, align="center")
        if show:
            plt.show()

    def save_rms_by_leaf(self, filename: str, **kwargs) -> None:
        import matplotlib.pyplot as plt

        self.plot_rms_by_leaf(show=False)
        plt.savefig(filename, **kwargs)


class JawStruct:
    """The X1, Y1, X2 and Y2 jaw axes."""

    def __init__(self, x1: HeadAxis, y1: HeadAxis, x2: HeadAxis, y2: HeadAxis):
        if not all(isinstance(j, HeadAxis) for j in (x1, y1, x2, y2)):
            raise TypeError("HeadAxis not passed into Jaw structure")
        self.x1 = x1
        self.y1 = y1
        self.x2 = x2
        self.y2 = y2


class CouchStruct:
    """The couch axes."""

    def __init__(self, vertical: CouchAxis, longitudinal: CouchAxis, lateral: CouchAxis,
                 rotational: CouchAxis, pitch: CouchAxis | None = None,
                 roll: CouchAxis | None = None):
        if not all(isinstance(c, CouchAxis)
                   for c in (vertical, longitudinal, lateral, rotational)):
            raise TypeError("Couch structure must be passed Couch Axes.")
        self.vert = vertical
        self.long = longitudinal
        self.latl = lateral
        self.rotn = rotational
        self.pitch = pitch
        self.roll = roll


class Subbeam:
    """A trajectory log's subbeam record."""

    def __init__(self, file, log_version: float):
        f = file
        self.control_point = decode_binary(f, int)
        self.mu_delivered = decode_binary(f, float)
        self.rad_time = decode_binary(f, float)
        self.sequence_num = decode_binary(f, int)
        chars = 512 if log_version >= 3 else 32
        self.beam_name = decode_binary(f, str, chars, 32)

    @property
    def gantry_angle(self) -> Axis:
        return self._get_metadata_axis("gantry")

    @property
    def collimator_angle(self) -> Axis:
        return self._get_metadata_axis("collimator")

    @property
    def jaw_x1(self) -> Axis:
        return self._get_metadata_axis("jaws", "x1")

    @property
    def jaw_x2(self) -> Axis:
        return self._get_metadata_axis("jaws", "x2")

    @property
    def jaw_y1(self) -> Axis:
        return self._get_metadata_axis("jaws", "y1")

    @property
    def jaw_y2(self) -> Axis:
        return self._get_metadata_axis("jaws", "y2")

    def _get_metadata_axis(self, attr, subattr=None) -> Axis:
        obj = getattr(self._axis_data, attr)
        if subattr is not None:
            obj = getattr(obj, subattr)
        actual = obj.actual[self._snapshots]
        expected = obj.expected[self._snapshots] if obj.expected is not None else actual
        return Axis(np.median(actual), np.median(expected))


class SubbeamManager:
    """The subbeams of a trajectory log, each with its own fluence."""

    def __init__(self, file, header):
        self.subbeams = [Subbeam(file, header.version) for _ in range(header.num_subbeams)]

    def post_hoc_metadata(self, axis_data, device=None):
        for subbeam_num, subbeam in enumerate(self.subbeams):
            self._set_subbeam_snapshots(axis_data, subbeam_num)
            mlc_subsection = copy.copy(axis_data.mlc)
            mlc_subsection.snapshot_idx = subbeam._snapshots
            mlc_subsection._moving_cache = None
            mlc_subsection._error_cache = None
            mlc_subsection._rms_cache = None
            subbeam.fluence = FluenceStruct(mlc_subsection, axis_data.mu, axis_data.jaws, device)

    def _set_subbeam_snapshots(self, axis_data, beam_num: int):
        subbeam = self.subbeams[beam_num]
        cp_by_snapshot = axis_data.control_point.actual
        cp_lower = subbeam.control_point
        try:
            cp_upper = self.subbeams[beam_num + 1].control_point
        except IndexError:
            cp_upper = cp_by_snapshot[-1]
        within = (cp_by_snapshot >= cp_lower) & (cp_by_snapshot < cp_upper)
        beam_on = axis_data.beam_hold.actual == 0
        subbeam._snapshots = [i for i, b in enumerate(within & beam_on) if b]
        subbeam._axis_data = axis_data

    def __getitem__(self, item) -> Subbeam:
        return self.subbeams[item]

    def __len__(self):
        return len(self.subbeams)


class LogBase:
    """Base of the dynalog and trajectory-log readers; ``device`` is where
    the fluence maps and the gamma run."""

    ANON_LINE = -1

    def __init__(self, filename, exclude_beam_off: bool = True, device=None):
        if is_log(filename):
            self.filename = filename
            self.exclude_beam_off = exclude_beam_off
        else:
            raise OSError(f"{filename} was not a valid log file")
        self.device = resolve_device(device, type(self).__name__)

    def report_basic_parameters(self, printout: bool = True) -> str:
        title = f"Results of file: {self.filename}\n"
        if self.treatment_type == TreatmentType.IMAGING.value:
            string = title + "Log is an Imaging field; no statistics can be calculated"
        else:
            mlc = self.axis_data.mlc
            self.fluence.gamma.calc_map()
            string = (
                title
                + f"Average RMS of all leaves: "
                  f"{mlc.get_RMS_avg(only_moving_leaves=False) * 10:3.3f} mm\n"
                + f"Max RMS error of all leaves: {mlc.get_RMS_max() * 10:3.3f} mm\n"
                + f"95th percentile error: "
                  f"{mlc.get_error_percentile(95, only_moving_leaves=False) * 10:3.3f} mm\n"
                + f"Number of beam holdoffs: {self.num_beamholds:1.0f}\n"
                + f"Gamma pass %: {self.fluence.gamma.pass_prcnt:2.2f}\n"
                + f"Gamma average: {self.fluence.gamma.avg_gamma:2.3f}\n")
        if printout:
            print(string)
        return string

    @property
    def treatment_type(self) -> str:
        if isinstance(self, TrajectoryLog):
            gantry_std = (max(np.asarray(subbeam.gantry_angle.actual).std()
                              for subbeam in self.subbeams)
                          if len(self.subbeams) else self.axis_data.gantry.actual.std())
            if np.isnan(gantry_std):
                return TreatmentType.IMAGING.value
        else:
            gantry_std = self.axis_data.gantry.actual.std()
        if gantry_std > 0.5:
            return TreatmentType.VMAT.value
        if self.axis_data.mu.actual.max() <= 2.1:
            return TreatmentType.IMAGING.value
        if self.axis_data.mlc.num_moving_leaves == 0 and isinstance(self, TrajectoryLog):
            return TreatmentType.STATIC_IMRT.value
        return TreatmentType.DYNAMIC_IMRT.value

    @property
    def _underscore_idx(self) -> int:
        base_filename = osp.basename(self.filename)
        under_index = base_filename.find("_")
        if under_index < 0:
            raise NameError(
                f"Filename `{base_filename}` has no underscore. Place an underscore between "
                "the patient ID and the rest of the filename and try again.")
        return under_index

    def _anonymize_destination(self, destination: str | None) -> str:
        if destination is None:
            return osp.dirname(self.filename)
        if not osp.isdir(destination):
            raise NotADirectoryError(
                f"Specified destination `{destination}` was not a valid directory")
        return destination

    def plot_summary(self, show: bool = True):
        import matplotlib.pyplot as plt

        self.fluence.gamma.is_map_calced(raise_error=True)
        ax = plt.subplot(2, 3, 1)
        self.plot_subfluence(Fluence.ACTUAL, ax, show=False)
        ax = plt.subplot(2, 3, 2)
        self.plot_subfluence(Fluence.EXPECTED, ax, show=False)
        ax = plt.subplot(2, 3, 3)
        self.plot_subfluence(Fluence.GAMMA, ax, show=False)
        ax = plt.subplot(2, 3, 4)
        self.plot_subgraph(Graph.GAMMA, ax, show=False)
        ax = plt.subplot(2, 3, 5)
        self.plot_subgraph(Graph.HISTOGRAM, ax, show=False)
        ax = plt.subplot(2, 3, 6)
        self.plot_subgraph("rms", ax, show=False)
        if show:
            plt.show()

    def save_summary(self, filename: str, **kwargs) -> None:
        import matplotlib.pyplot as plt

        self.plot_summary(show=False)
        plt.savefig(filename, **kwargs)
        plt.close()

    def plot_subfluence(self, img, ax=None, show: bool = True,
                        fontsize: int = 10):
        import matplotlib.pyplot as plt

        img = convert_to_enum(img, Fluence)
        if ax is None:
            ax = plt.subplot()
        ax.tick_params(axis="both", labelsize=8)
        if img in (Fluence.ACTUAL, Fluence.EXPECTED):
            title = img.value.capitalize() + " Image"
            ax.imshow(getattr(self.fluence, img.value).array.astype(np.float32),
                      aspect="auto", interpolation="none", cmap=_get_array_cmap())
        else:
            ax.imshow(self.fluence.gamma.array.astype(np.float32),
                      aspect="auto", interpolation="none", vmax=1,
                      cmap=_get_array_cmap())
            title = "Gamma Map"
        ax.autoscale(tight=True)
        ax.set_title(title, fontsize=fontsize)
        if show:
            plt.show()

    def save_subimage(self, filename, img, fontsize: int = 10, **kwargs):
        import matplotlib.pyplot as plt

        plt.figure()
        self.plot_subfluence(img, show=False, fontsize=fontsize)
        plt.savefig(filename, **kwargs)
        plt.close()

    def plot_subgraph(self, graph, ax=None, show: bool = True,
                      fontsize: int = 10, labelsize: int = 8):
        import matplotlib.pyplot as plt

        graph = convert_to_enum(graph, Graph)
        if ax is None:
            ax = plt.subplot()
        if graph == Graph.GAMMA:
            title = "Gamma Histogram"
            ax.hist(self.fluence.gamma.array.flatten(),
                    bins=self.fluence.gamma.bins)
            ax.set_yscale("log")
        elif graph == Graph.HISTOGRAM:
            title = "Leaf Histogram"
            ax.hist(self.axis_data.mlc._abs_error_all_leaves.flatten())
        else:
            title = "Leaf RMS (mm)"
            ax.set_xlim([-0.5, self.axis_data.mlc.num_leaves + 0.5])
            rms = self.axis_data.mlc.get_RMS("both")
            ax.bar(np.arange(len(rms))[::-1], rms * 10, align="center")
        ax.set_title(title, fontsize=fontsize)
        ax.tick_params(axis="both", labelsize=labelsize)
        ax.grid(True)
        if show:
            plt.show()

    def save_subgraph(self, filename, graph, fontsize: int = 10,
                      labelsize: int = 8, **kwargs):
        import matplotlib.pyplot as plt

        plt.figure()
        self.plot_subgraph(graph, show=False, fontsize=fontsize,
                           labelsize=labelsize)
        plt.savefig(filename, **kwargs)
        plt.close()


class DynalogHeader(Structure):
    """The six fixed header rows of a dynalog A-file (CSV rows 0-5):
    version, patient name, plan file name, tolerance, leaves per bank and
    clinac scale, in the Varian file's order."""

    def __init__(self, dlogdata):
        version, patient, plan, tol, banks, scale = dlogdata[:6]
        super().__init__(
            version=str(version),
            patient_name=patient,
            plan_filename=plan,
            tolerance=int(tol[0]),
            num_mlc_leaves=int(banks[0]) * 2,  # the file gives one bank's count
            clinac_scale=int(scale[0]))


class DynalogAxisData:
    """The snapshot columns of a dynalog."""

    #: the snapshot rows of the dynalog A-file: column -> (name, scale);
    #: angles in tenths of a degree, carriages in microns
    COLUMNS = (
        ("mu", 1), ("previous_segment_num", 1), ("beam_hold", 1),
        ("beam_on", 1), ("prior_dose_index", 1), ("next_dose_index", 1),
        ("gantry", 0.1), ("collimator", 0.1),
        ("jaw_y1", 0.1), ("jaw_y2", 0.1), ("jaw_x1", 0.1), ("jaw_x2", 0.1),
        ("carriage_A", 1e-3), ("carriage_B", 1e-3),
    )

    def __init__(self, log, dlogdata):
        snapshot_data = np.array(dlogdata[6:], dtype=np.float64).transpose()
        self.num_snapshots = np.size(snapshot_data, 1)
        cols = {name: snapshot_data[i] * scale for i, (name, scale) in enumerate(self.COLUMNS)}

        def correct_vmat_mu(mu_array):
            # VMAT dynalogs record the gantry angle in the MU column: the
            # cumulative |gantry| movement becomes a 25000-normalised MU
            if mu_array[-1] == 25000:
                return mu_array
            abs_diff = np.abs(np.diff(mu_array))
            return np.concatenate([[0], np.cumsum(abs_diff) / np.sum(abs_diff)]) * 25000

        corrected_mu = correct_vmat_mu(cols["mu"])
        self.mu = Axis(corrected_mu, corrected_mu)
        for name in ("previous_segment_num", "beam_hold", "beam_on", "prior_dose_index",
                     "next_dose_index"):
            setattr(self, name, Axis(cols[name]))
        self.gantry = GantryAxis(cols["gantry"])
        self.collimator = HeadAxis(cols["collimator"])
        self.jaws = JawStruct(HeadAxis(cols["jaw_x1"]), HeadAxis(cols["jaw_y1"]),
                              HeadAxis(cols["jaw_x2"]), HeadAxis(cols["jaw_y2"]))
        self.carriage_A = Axis(cols["carriage_A"])
        self.carriage_B = Axis(cols["carriage_B"])
        if log.exclude_beam_off:
            hold_idx = np.where(self.beam_hold.actual == 0)[0]
            beamon_idx = np.where(self.beam_on.actual == 1)[0]
            snapshot_idx = np.intersect1d(hold_idx, beamon_idx)
        else:
            snapshot_idx = list(range(self.num_snapshots))
        self.mlc = MLC.from_dlog(log, self.jaws, snapshot_data, snapshot_idx)


class Dynalog(LogBase):
    """A Varian dynalog A/B file pair."""

    ANON_LINE = 1
    HEADER_LINE_LENGTH = 6

    def __init__(self, filename, exclude_beam_off: bool = True, device=None):
        super().__init__(filename, exclude_beam_off, device)
        if not is_dlog(self.filename):
            raise NotADynalogError(f"{self.filename} was not a valid Dynalog file")
        if not self._has_other_file:
            raise DynalogMatchError("Didn't find the matching dynalog file")
        with open(self.a_logfile, encoding="utf-8") as a_log:
            dlgdata = list(csv.reader(a_log, delimiter=","))
        self.header = DynalogHeader(dlgdata)
        self.axis_data = DynalogAxisData(self, dlgdata)
        self.fluence = FluenceStruct(self.axis_data.mlc, self.axis_data.mu,
                                     self.axis_data.jaws, self.device)

    @property
    def _has_other_file(self) -> bool:
        return self.identify_other_file(self.filename, raise_find_error=False) is not None

    @property
    def a_logfile(self) -> str:
        other = self.identify_other_file(self.filename)
        return self.filename if osp.basename(self.filename).startswith("A") else other

    @property
    def b_logfile(self) -> str:
        other = self.identify_other_file(self.filename)
        return self.filename if osp.basename(self.filename).startswith("B") else other

    @property
    def num_beamholds(self) -> int:
        return int(np.sum(np.diff(self.axis_data.beam_hold.actual) > 0))

    def anon_file_renames(self, destination: str, suffix: str) -> dict:
        base_a = osp.basename(self.a_logfile)
        base_b = osp.basename(self.b_logfile)
        anon_a = osp.join(destination,
                          base_a[:self._underscore_idx] + "_Anonymous" + suffix + ".dlg")
        anon_b = osp.join(destination,
                          base_b[:self._underscore_idx] + "_Anonymous" + suffix + ".dlg")
        return {self.a_logfile: anon_a, self.b_logfile: anon_b}

    def anon_files(self, destination: str, suffix: str):
        return self.anon_file_renames(destination, suffix).values()

    def anonymize(self, inplace: bool = False, destination: str | None = None,
                  suffix: str | None = None) -> list[str]:
        suffix = suffix or ""
        dest_dir = self._anonymize_destination(destination)
        renames = self.anon_file_renames(dest_dir, suffix)
        method = os.rename if inplace else shutil.copy
        for old, new in renames.items():
            method(old, new)
        for file in self.anon_files(dest_dir, suffix):
            with open(file, encoding="utf-8") as f:
                txtdata = f.readlines()
            txtdata[self.ANON_LINE] = "Patient ID:\tAnonymous_" + suffix + "\n"
            with open(file, mode="w", encoding="utf-8") as f:
                f.writelines(txtdata)
        return list(renames.values())

    @staticmethod
    def identify_other_file(first_dlg_file: str, raise_find_error: bool = True) -> str | None:
        dlg_dir, dlg_file = osp.split(first_dlg_file)
        if dlg_file.startswith("A"):
            file2get = dlg_file.replace("A", "B", 1)
        elif dlg_file.startswith("B"):
            file2get = dlg_file.replace("B", "A", 1)
        else:
            raise ValueError(
                "Unable to decipher log names; ensure dynalogs start with 'A' and 'B'")
        other_filename = osp.join(dlg_dir, file2get)
        if osp.isfile(other_filename):
            return other_filename
        if raise_find_error:
            raise FileNotFoundError(
                "Complementary dlg file not found; ensure A and B-file are in same directory.")
        return None

    def publish_pdf(self, filename: str, notes=None, metadata: dict = None,
                    open_file: bool = False, logo=None):
        self.fluence.gamma.calc_map()
        canvas = pdf.PylinacCanvas(filename, page_title="Dynalog Analysis",
                                   metadata=metadata, logo=logo)
        mlc = self.axis_data.mlc
        canvas.add_text(text=[
            "Dynalog results:",
            f"Average RMS (mm): {mlc.get_RMS_avg() * 10:2.2f}",
            f"Max RMS (mm): {mlc.get_RMS_max() * 10:2.2f}",
            f"95th Percentile error (mm): {mlc.get_error_percentile(95) * 10:2.2f}",
            f"Number of beam holdoffs: {self.num_beamholds}",
            f"Gamma pass (%): {self.fluence.gamma.pass_prcnt:2.1f}",
            f"Gamma average: {self.fluence.gamma.avg_gamma:2.2f}",
        ], location=(10, 25.5))
        for idx, (x, y, graph) in enumerate(zip(
                (2, 11, 2, 11), (14, 14, 6, 6),
                (Fluence.ACTUAL, Fluence.EXPECTED, Fluence.GAMMA, ""))):
            data = BytesIO()
            if idx != 3:
                self.save_subimage(data, graph, fontsize=20)
            else:
                self.save_subgraph(data, Graph.GAMMA, fontsize=20, labelsize=12)
            canvas.add_image(data, location=(x, y), dimensions=(9, 9))
        if notes is not None:
            canvas.add_text(location=(1, 5.5), font_size=14, text="Notes:")
            canvas.add_text(location=(1, 5), text=notes)
        canvas.add_new_page()
        for x, y, graph in zip((5, 5), (13, 2), (Graph.HISTOGRAM, Graph.RMS)):
            data = BytesIO()
            self.save_subgraph(data, graph, fontsize=20, labelsize=12)
            canvas.add_image(location=(x, y), dimensions=(13, 13),
                             image_data=data)
        canvas.finish()
        if open_file:
            webbrowser.open(filename)


class TrajectoryLogAxisData:
    """The snapshot columns of a trajectory log."""

    #: the machine axes of a trajectory-log snapshot row, two floats each
    #: (expected, actual), so axis i starts at column 2 i; the couch pitch
    #: and roll exist from format 3.0 on; the leaf axes follow the listed
    #: ones (read by MLC.from_tlog)
    AXES = (
        ("collimator", HeadAxis), ("gantry", GantryAxis),
        ("jaw_y1", HeadAxis), ("jaw_y2", HeadAxis),
        ("jaw_x1", HeadAxis), ("jaw_x2", HeadAxis),
        ("couch_vrt", CouchAxis), ("couch_lng", CouchAxis),
        ("couch_lat", CouchAxis), ("couch_rtn", CouchAxis),
    )
    AXES_V3 = (("couch_pitch", CouchAxis), ("couch_roll", CouchAxis))
    AXES_TAIL = (
        ("mu", BeamAxis), ("beam_hold", BeamAxis), ("control_point", BeamAxis),
        ("carriage_A", HeadAxis), ("carriage_B", HeadAxis),
    )

    def __init__(self, log, file, subbeams):
        step_size = int(np.sum(log.header.samples_per_axis)) * 2
        snapshot_data = decode_binary(file, float, step_size * log.header.num_snapshots)
        snapshot_data = np.asarray(snapshot_data).reshape(log.header.num_snapshots, -1)
        layout = self.AXES + (self.AXES_V3 if log.header.version >= 3 else ()) + self.AXES_TAIL
        ax = {name: _get_axis(snapshot_data, 2 * i, kind)
              for i, (name, kind) in enumerate(layout)}
        self.collimator = ax["collimator"]
        self.gantry = ax["gantry"]
        self.jaws = JawStruct(ax["jaw_x1"], ax["jaw_y1"], ax["jaw_x2"], ax["jaw_y2"])
        self.couch = CouchStruct(ax["couch_vrt"], ax["couch_lng"], ax["couch_lat"],
                                 ax["couch_rtn"], ax.get("couch_pitch"), ax.get("couch_roll"))
        self.mu = ax["mu"]
        self.beam_hold = ax["beam_hold"]
        self.control_point = ax["control_point"]
        self.carriage_A = ax["carriage_A"]
        self.carriage_B = ax["carriage_B"]
        if log.exclude_beam_off:
            snapshot_idx = np.where(self.beam_hold.actual == 0)[0]
        else:
            snapshot_idx = list(range(log.header.num_snapshots))
        # the leaf axes start right after the machine axes
        leaf_iter = itertools.count(start=2 * len(layout), step=2)
        self.mlc = MLC.from_tlog(log, subbeams, self.jaws, snapshot_data, snapshot_idx,
                                 leaf_iter)


class TrajectoryLogHeader:
    """The binary header, signature 'VOSTL'."""

    def __init__(self, file: BinaryIO):
        f = file
        self.header = decode_binary(f, str, 16)
        self.version = float(decode_binary(f, str, 16))
        self.header_size = decode_binary(f, int)
        self.sampling_interval = decode_binary(f, int)
        self.num_axes = decode_binary(f, int)
        self.axis_enum = decode_binary(f, int, self.num_axes)
        self.samples_per_axis = decode_binary(f, int, self.num_axes)
        self.num_mlc_leaves = int(np.atleast_1d(self.samples_per_axis)[-1]) - 2
        self.axis_scale = decode_binary(f, int)
        self.num_subbeams = decode_binary(f, int)
        self.is_truncated = decode_binary(f, int)
        self.num_snapshots = decode_binary(f, int)
        if self.version >= 4.0:
            self.mlc_model = decode_binary(f, int)
            self.metadata = Metadata(f, self.num_axes)
        else:
            self.mlc_model = decode_binary(f, int, cursor_shift=1024 - (64 + self.num_axes * 8))


class Metadata:
    """The metadata block of format 4.0 and later."""

    def __init__(self, stream: BinaryIO, num_axes: int):
        full_data = decode_binary(stream, str, 745,
                                  cursor_shift=1024 - (64 + (num_axes * 8)) - 745)
        fields = full_data.split("\r\n")
        self.patient_id = fields[0].split("\t")[1]
        self.plan_name = fields[1].split("\t")[1]
        self.sop_instance_uid = fields[2].split("\t")[1]
        self.mu_planned = float(fields[3].split("\t")[1])
        self.mu_remaining = float(fields[4].split("\t")[1])
        self.energy = fields[5].split("\t")[1]
        self.beam_name = fields[6].split("\t")[1]


class TrajectoryLog(LogBase):
    """A Varian TrueBeam trajectory log."""

    ANON_LINE = 0

    def __init__(self, filename, exclude_beam_off: bool = True, device=None):
        super().__init__(filename, exclude_beam_off, device)
        self._read_txt_file()
        if isinstance(filename, (BytesIO, BufferedReader)):
            filename.seek(0)
            self._read_it(filename)
        else:
            with open(self.filename, mode="rb") as tlogfile:
                self._read_it(tlogfile)
        self.subbeams.post_hoc_metadata(self.axis_data, self.device)
        if not self.treatment_type == TreatmentType.IMAGING.value:
            self.fluence = FluenceStruct(self.axis_data.mlc, self.axis_data.mu,
                                         self.axis_data.jaws, self.device)

    def _read_it(self, tlogfile: BinaryIO):
        self.header = TrajectoryLogHeader(tlogfile)
        self.subbeams = SubbeamManager(tlogfile, self.header)
        self.axis_data = TrajectoryLogAxisData(self, tlogfile, self.subbeams)

    def _read_txt_file(self) -> None:
        self.txt = None
        if ".bin" in str(self.filename):
            txt_filename = str(self.filename).replace(".bin", ".txt")
            if osp.isfile(txt_filename):
                self.txt = {}
                with open(txt_filename, encoding="utf-8") as txtfile:
                    for line in txtfile.readlines():
                        items = line.split(":")
                        if len(items) == 2:
                            self.txt[items[0].strip()] = items[1].strip()

    @property
    def txt_filename(self) -> str | None:
        if self.txt is not None:
            return self.filename.replace(".bin", ".txt")
        return None

    @property
    def num_beamholds(self) -> int:
        return int(np.sum(np.diff(self.axis_data.beam_hold.actual) > 0))

    @property
    def is_hdmlc(self) -> bool:
        return self.header.mlc_model == 3

    def anon_file_renames(self, destination: str, suffix: str) -> dict:
        base_filename = osp.basename(self.filename)
        anon_base = "Anonymous" + suffix + base_filename[self._underscore_idx:]
        anon_filename = osp.join(destination, anon_base)
        filenames = {self.filename: anon_filename}
        if self.txt_filename is not None:
            filenames[self.txt_filename] = anon_filename.replace(".bin", ".txt")
        return filenames

    def anonymize(self, inplace: bool = False, destination: str | None = None,
                  suffix: str | None = None) -> list[str]:
        suffix = suffix or ""
        dest_dir = self._anonymize_destination(destination)
        renames = self.anon_file_renames(dest_dir, suffix)
        method = os.rename if inplace else shutil.copy
        for old, new in renames.items():
            method(old, new)
        txt_file = renames.get(self.txt_filename)
        if txt_file:
            with open(txt_file, encoding="utf-8") as f:
                txtdata = f.readlines()
            txtdata[self.ANON_LINE] = "Patient ID:\tAnonymous_" + suffix + "\n"
            with open(txt_file, mode="w", encoding="utf-8") as f:
                f.writelines(txtdata)
        bin_file = renames[self.filename]
        if self.header.version >= 4:
            with open(self.filename, mode="rb") as log_file:
                header_size = (16 + 16 + 4 + 4 + 4 + 4 * self.header.num_axes
                               + 4 * self.header.num_axes + 4 + 4 + 4 + 4 + 4)
                header_data = log_file.read(header_size)
                metadata = decode_binary(log_file, str, 745, strip_empty=False)
                fields = metadata.split("\r\n")
                fields[0] = fields[0].split("\t")[0] + "\tAnonymous" + suffix
                anon_metadata = bytes("\r\n".join(fields).encode("ascii"))
                rest_of_data = log_file.read()
            with open(bin_file, mode="wb") as new_log_file:
                new_log_file.write(header_data)
                new_log_file.write(anon_metadata)
                new_log_file.write(rest_of_data)
        return list(renames.values())

    def to_csv(self, filename: str | None = None) -> str:
        if filename is None:
            filename = self.filename.replace("bin", "csv")
        elif not filename.endswith(".csv"):
            filename += ".csv"
        with open(filename, mode="w", encoding="utf-8") as csv_file:
            writer = csv.writer(csv_file, lineterminator="\n")
            h = self.header
            header_titles = (
                "Tlog File:", "Signature:", "Version:", "Header Size:", "Sampling Inteval:",
                "Number of Axes:", "Axis Enumeration:", "Samples per Axis:", "Axis Scale:",
                "Number of Subbeams:", "Is Truncated?", "Number of Snapshots:", "MLC Model:")
            header_values = (
                self.filename, h.header, h.version, h.header_size, h.sampling_interval,
                h.num_axes, h.axis_enum, h.samples_per_axis, h.axis_scale, h.num_subbeams,
                h.is_truncated, h.num_snapshots, h.mlc_model)
            for title, value in zip(header_titles, header_values):
                write_single_value(writer, title, value)
            ad = self.axis_data
            data_titles = ("Gantry", "Collimator", "Jaws X1", "Jaws X2", "Jaws Y1", "Jaws Y2",
                           "Couch Lat", "Couch Lng", "Couch Vert", "Couch Rtn", "Couch Pitch",
                           "Couch Roll", "MU", "Beam Hold", "Control Point", "Carriage A",
                           "Carriage B")
            data_values = (ad.gantry, ad.collimator, ad.jaws.x1, ad.jaws.x2, ad.jaws.y1,
                           ad.jaws.y2, ad.couch.latl, ad.couch.long, ad.couch.vert,
                           ad.couch.rotn, ad.couch.pitch, ad.couch.roll, ad.mu, ad.beam_hold,
                           ad.control_point, ad.carriage_A, ad.carriage_B)
            data_units = ("degrees", "degrees", "cm", "cm", "cm", "cm", "cm", "cm", "cm",
                          "degrees", "degrees", "degrees", "MU", None, None, "cm", "cm")
            for title, value, unit in zip(data_titles, data_values, data_units):
                if value:
                    write_array(writer, title, value, unit)
            for leaf_num, leaf in self.axis_data.mlc.leaf_axes.items():
                write_array(writer, "Leaf " + str(leaf_num), leaf, "cm")
        return filename

    def publish_pdf(self, filename, metadata: dict = None, notes=None,
                    open_file: bool = False, logo=None):
        if self.treatment_type == TreatmentType.IMAGING.value:
            raise ValueError(
                "Log is of imaging type (e.g. kV setup) and does not contain "
                "relevant gamma/leaf data")
        self.fluence.gamma.calc_map()
        canvas = pdf.PylinacCanvas(filename, page_title="Trajectory Log Analysis",
                                   metadata=metadata, logo=logo)
        mlc = self.axis_data.mlc
        canvas.add_text(text=[
            "Trajectory Log results:",
            f"Average RMS (mm): {mlc.get_RMS_avg() * 10:2.2f}",
            f"Max RMS (mm): {mlc.get_RMS_max() * 10:2.2f}",
            f"95th Percentile error (mm): {mlc.get_error_percentile(95) * 10:2.2f}",
            f"Number of beam holdoffs: {self.num_beamholds}",
            f"Gamma pass (%): {self.fluence.gamma.pass_prcnt:2.1f}",
            f"Gamma average: {self.fluence.gamma.avg_gamma:2.2f}",
        ], location=(10, 25.5))
        for x, y, graph in zip((2, 11, 2, 11), (14, 14, 6, 6),
                               (Fluence.ACTUAL, Fluence.EXPECTED,
                                Fluence.GAMMA, "")):
            data = BytesIO()
            if graph != "":
                self.save_subimage(data, graph, fontsize=20)
            else:
                self.save_subgraph(data, Graph.GAMMA, fontsize=20, labelsize=12)
            canvas.add_image(data, location=(x, y), dimensions=(9, 9))
        if notes is not None:
            canvas.add_text(location=(1, 5.5), font_size=14, text="Notes:")
            canvas.add_text(location=(1, 5), text=notes)
        canvas.add_new_page()
        for x, y, graph in zip((5, 5), (13, 2), (Graph.HISTOGRAM, Graph.RMS)):
            data = BytesIO()
            self.save_subgraph(data, graph, fontsize=20, labelsize=12)
            canvas.add_image(location=(x, y), dimensions=(13, 13),
                             image_data=data)
        canvas.finish()
        if open_file:
            webbrowser.open(filename)


class MachineLogs(list):
    """The logs of a folder (trajectory logs, then dynalog pairs), each
    read for ``device``."""

    def __init__(self, folder: str, recursive: bool = True, device=None):
        super().__init__()
        self.device = resolve_device(device, "MachineLogs")
        self.load_folder(folder, recursive)

    @classmethod
    def from_zip(cls, zfile: str, device=None):
        with TemporaryZipDirectory(zfile) as tzd:
            logs = cls(tzd, device=device)
        return logs

    @property
    def num_logs(self) -> int:
        return len(self)

    @property
    def num_tlogs(self) -> int:
        return sum(isinstance(log, TrajectoryLog) for log in self)

    @property
    def num_dlogs(self) -> int:
        return sum(isinstance(log, Dynalog) for log in self)

    def load_folder(self, directory: str, recursive: bool = True):
        for file in _get_log_filenames(directory, recursive=recursive):
            self.append(file)

    def _check_empty(self) -> None:
        if len(self) == 0:
            raise ValueError("No logs have been loaded yet.")

    def report_basic_parameters(self) -> None:
        print(f"Number of logs: {len(self)}")
        print(f"Average gamma: {self.avg_gamma():3.2f}")
        print(f"Average gamma pass percent: {self.avg_gamma_pct():3.1f}")

    def append(self, obj) -> None:
        if isinstance(obj, str):
            if is_tlog(obj):
                super().append(TrajectoryLog(obj, device=self.device))
            elif is_dlog(obj):
                super().append(Dynalog(obj, device=self.device))
        elif isinstance(obj, (Dynalog, TrajectoryLog)):
            super().append(obj)
        else:
            raise TypeError("Can only append machine logs or log file paths")

    def avg_gamma(self, doseTA: float = 1, distTA: float = 1, threshold: float = 0.1,
                  resolution: float = 0.1) -> float:
        self._check_empty()
        gammas = []
        for log in self:
            log.fluence.gamma.calc_map(doseTA, distTA, threshold, resolution)
            gammas.append(log.fluence.gamma.avg_gamma)
        return float(np.mean(gammas))

    def avg_gamma_pct(self, doseTA: float = 1, distTA: float = 1, threshold: float = 0.1,
                      resolution: float = 0.1) -> float:
        self._check_empty()
        pcts = []
        for log in self:
            log.fluence.gamma.calc_map(doseTA, distTA, threshold, resolution)
            pcts.append(log.fluence.gamma.pass_prcnt)
        return float(np.mean(pcts))

    def to_csv(self) -> list[str]:
        """Write the trajectory logs to CSV; dynalogs are text already."""
        return [log.to_csv() for log in self if isinstance(log, TrajectoryLog)]

    def anonymize(self, inplace: bool = False, suffix: str | None = None):
        self._check_empty()
        file_list = []
        for log in self:
            file_list += log.anonymize(inplace=inplace, suffix=suffix)
        return file_list


def anonymize(source: str, inplace: bool = False, destination: str = None,
              recursive: bool = True):
    """Anonymize a log or a folder of logs (read for the CPU: renaming does
    no device work)."""

    def _anonymize(filepath):
        log = load_log(filepath, device="cpu")
        log.anonymize(inplace=inplace, destination=destination)

    if osp.isfile(source):
        _anonymize(source)
    elif osp.isdir(source):
        for file in _get_log_filenames(source, recursive=recursive):
            _anonymize(file)


def load_log(file_or_dir: str, exclude_beam_off: bool = True, recursive: bool = True,
             device=None):
    """A log, a folder of logs or a zip of logs, read for ``device``."""
    if osp.isfile(file_or_dir):
        if zipfile.is_zipfile(file_or_dir):
            logs = MachineLogs.from_zip(file_or_dir, device=device)
            if len(logs) == 1:
                return logs[0]
            return logs
        if not is_log(file_or_dir):
            raise NotALogError("Not a valid log")
        if is_tlog(file_or_dir):
            return TrajectoryLog(file_or_dir, exclude_beam_off, device=device)
        return Dynalog(file_or_dir, exclude_beam_off, device=device)
    if osp.isdir(file_or_dir):
        return MachineLogs(file_or_dir, recursive, device=device)
    raise NotALogError(
        f"'{file_or_dir}' did not point to a valid file, directory, or ZIP archive")


def is_log(filename) -> bool:
    return is_tlog(filename) or is_dlog(filename)


def is_tlog(filename) -> bool:
    return _is_log(filename, ("VOSTL",))


def is_dlog(filename) -> bool:
    return _is_log(filename, ("B", "A"))


def _is_log(filename, keys: Sequence[str]) -> bool:
    if isinstance(filename, (BytesIO, BufferedReader)):
        pos = filename.tell()
        header_sample = filename.read(5).decode(errors="ignore")
        filename.seek(pos)
        return any(key in header_sample for key in keys)
    if isinstance(filename, (str, Path)) and osp.isfile(filename):
        try:
            with open(filename, mode="rb") as f:
                header_sample = f.read(5).decode()
            return any(key in header_sample for key in keys)
        except Exception:
            return False
    return False


def write_single_value(writer, description, value, unit=None):
    writer.writerow([description, str(value), unit])


def write_array(writer, description, value, unit=None):
    for dtype, attr in zip((" Expected", " Actual"), ("expected", "actual")):
        if getattr(value, attr) is None:
            continue
        if unit is None:
            dtype_desc = description + dtype
        else:
            dtype_desc = description + dtype + " in units of " + unit
        arr2write = np.insert(np.asarray(getattr(value, attr)).astype(object), 0, dtype_desc)
        writer.writerow(arr2write)


def _get_log_filenames(directory: str, recursive: bool = True) -> list:
    tlogs = retrieve_filenames(directory, is_tlog, recursive=recursive)
    dlogs = retrieve_filenames(directory, is_dlog, recursive=recursive)
    idx = 0
    while idx < len(dlogs):
        opp_file = Dynalog.identify_other_file(dlogs[idx], raise_find_error=False)
        if opp_file in dlogs:
            del dlogs[dlogs.index(opp_file)]
        else:
            del dlogs[idx]
            idx -= 1
        idx += 1
    return tlogs + dlogs


def _get_axis(snapshot_data, column, axis_type):
    return axis_type(expected=snapshot_data[:, column], actual=snapshot_data[:, column + 1])
