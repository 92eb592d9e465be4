"""Host image model: DICOM images, arrays and CT stacks as numpy arrays.

Port of the part of ``pylinac_tpu/core/image.py`` that the batched picket
fence, the CatPhan and the Winston-Lutz analyses use: ``load`` (``:89``),
``BaseImage`` (``:201``: ``center``, ``filter`` (``:270``), ``crop`` with
``edges``, ``invert``,
``ground``, ``normalize``, ``check_inversion_by_histogram``, ``compute``,
``shape``, indexing and the numpy array protocol, and ``gamma``, the Bakai
approximation, ``:377-402``), ``DicomImage`` (``:522``: load,
``z_position``, ``slice_spacing``, ``sid``, ``sad``, ``dpi``, ``dpmm``,
``cax``), ``LinacDicomImage`` (``:635-694``: axis angles from tags, file
names or overrides), ``ArrayImage`` (``:739``, with ``dpi``, ``sid`` and
``dpmm``), ``z_position`` (``:775``),
``DicomImageStack`` (``:796-879``: UID filter, z-sort, ``slice_spacing``,
``metadata``) and ``_rescale_dicom_values`` (``:142``). Pixels stay on the
host as numpy; the analyses stage them on the card. The lazy and zip
stacks wait.
"""

from __future__ import annotations

import os.path as osp
import re
from collections import Counter
from pathlib import Path

import numpy as np

from . import dcm
from .array_utils import filter as _filter_array
from .array_utils import ground, invert, normalize
from .geometry import Point
from .utilities import resolve_device

MM_PER_INCH = 25.4


def _rescale_dicom_values(unscaled, metadata, raw_pixels, invert_pixels):
    """Apply rescale slope/intercept and intensity-sign inversion."""
    if raw_pixels:
        return unscaled
    slope = metadata.get("RescaleSlope")
    intercept = metadata.get("RescaleIntercept")
    scaled = unscaled
    if slope is not None and intercept is not None:
        scaled = unscaled * slope + intercept
    sign = metadata.get("PixelIntensityRelationshipSign")
    if invert_pixels or (invert_pixels is None and sign == -1):
        scaled = scaled.max() - scaled + scaled.min()
    return scaled


class BaseImage:
    """A numpy pixel array with the array operations the analyses use."""

    array: np.ndarray

    def __init__(self, path):
        if isinstance(path, (str, Path)) and not osp.isfile(path):
            raise FileExistsError(
                f"File `{path}` does not exist. Verify the file path name.")
        self.path = path if isinstance(path, (str, Path)) else ""

    @property
    def center(self) -> Point:
        return Point((self.shape[1] / 2) - 0.5, (self.shape[0] / 2) - 0.5)

    def filter(self, size: float | int = 0.05, kind: str = "median", device=None) -> None:
        """Median or Gaussian filter of the array on ``device`` (``None``
        means CUDA; a 3x3 median launches ``csrc/median3x3.cu`` there)."""
        device = resolve_device(device, "BaseImage.filter")
        self.array = _filter_array(self.array, size=size, kind=kind, device=device)

    def crop(self, pixels: int = 15,
             edges: tuple[str, ...] = ("top", "bottom", "left", "right")) -> None:
        if pixels < 0:
            raise ValueError("Pixels to remove must be a positive number")
        if pixels == 0:
            return
        if "top" in edges:
            self.array = self.array[pixels:, :]
        if "bottom" in edges:
            self.array = self.array[:-pixels, :]
        if "left" in edges:
            self.array = self.array[:, pixels:]
        if "right" in edges:
            self.array = self.array[:, :-pixels]
        if self.array.size == 0:
            raise ValueError("Too many pixels removed; array is empty")

    def invert(self) -> None:
        self.array = invert(self.array)

    def ground(self) -> float:
        min_val = self.array.min()
        self.array = ground(self.array)
        return min_val

    def normalize(self, norm_val=None) -> None:
        if norm_val == "max":
            norm_val = None
        self.array = normalize(self.array, value=norm_val)

    def check_inversion_by_histogram(self, percentiles=(5, 50, 95)) -> bool:
        """Invert when the median is closer to the high percentile than to
        the low one."""
        was_inverted = False
        p_low = np.percentile(self.array, percentiles[0])
        p_mid = np.percentile(self.array, percentiles[1])
        p_high = np.percentile(self.array, percentiles[2])
        if abs(p_mid - p_low) > abs(p_mid - p_high):
            was_inverted = True
            self.invert()
        return was_inverted

    def gamma(self, comparison_image: BaseImage, doseTA: float = 1, distTA: float = 1,
              threshold: float = 0.1, ground: bool = True, normalize: bool = True,
              device=None) -> np.ndarray:
        """Bakai-approximation gamma against a comparison image of the same
        DPI (within 0.1) and size (within 1.1 px), each checked for inversion
        by its histogram on a copy; computed on ``device`` (``None`` means
        CUDA) by :func:`pylinac_tpu_torch.ops.gamma.gamma_bakai`."""
        from ..ops.gamma import gamma_bakai

        def _is_close(a, b, delta):
            return abs(a - b) <= delta

        if not _is_close(self.dpi, comparison_image.dpi, delta=0.1):
            raise AttributeError(
                f"The image DPIs do not match: {self.dpi:.2f} vs. {comparison_image.dpi:.2f}")
        if not (_is_close(self.shape[1], comparison_image.shape[1], 1.1)
                and _is_close(self.shape[0], comparison_image.shape[0], 1.1)):
            raise AttributeError(
                f"The images are not the same size: {self.shape} vs. {comparison_image.shape}")
        ref = ArrayImage(np.copy(self.array))
        ref.check_inversion_by_histogram()
        comp = ArrayImage(np.copy(comparison_image.array))
        comp.check_inversion_by_histogram()
        return gamma_bakai(ref.array, comp.array, dpmm=self.dpmm, doseTA=doseTA,
                           distTA=distTA, threshold=threshold, ground=ground,
                           normalize=normalize, device=device).cpu().numpy()

    def compute(self, metrics):
        """Compute plugin image metrics (:mod:`pylinac_tpu_torch.metrics.image`):
        one metric's value, or a dict of values by metric name."""
        from ..metrics.image import MetricBase

        if not hasattr(self, "metrics"):
            self.metrics, self.metric_values = [], {}
        values = {}
        if isinstance(metrics, MetricBase):
            metrics = [metrics]
        for metric in metrics:
            metric.inject_image(self)
            self.metrics.append(metric)
            value = metric.context_calculate()
            key = metric.full_name
            suffix = 1
            while key in values or key in self.metric_values:
                suffix += 1
                key = f"{metric.full_name}{suffix}"
            values[key] = value
        self.metric_values.update(values)
        if len(values) == 1:
            return values[key]
        return values

    @property
    def shape(self):
        return self.array.shape

    def __getitem__(self, item):
        return self.array[item]

    def __array__(self, dtype=None, copy=None):
        # without this, np.asarray(image) would iterate and copy the array
        if dtype is None or dtype == self.array.dtype:
            return self.array if not copy else self.array.copy()
        return self.array.astype(dtype)

    def __len__(self):
        return len(self.array)


def load(path, **kwargs) -> BaseImage:
    """An image from an image object, a numpy array or a DICOM file."""
    if isinstance(path, BaseImage):
        return path
    if isinstance(path, np.ndarray):
        return ArrayImage(path, **kwargs)
    if dcm.is_dicom(path):
        return DicomImage(path, **kwargs)
    raise TypeError(
        f"The argument `{path}` was not found to be a valid DICOM file or array")


class ArrayImage(BaseImage):
    """An image made directly from a numpy array, with an optional DPI at
    the detector and SID (the DPI scales to isocentre by SID / 1000)."""

    def __init__(self, array: np.ndarray, *, dpi: float | None = None,
                 sid: float | None = None, dtype=None):
        self.array = np.asarray(array, dtype=dtype)
        self._dpi = dpi
        self.sid = sid
        self.path = ""

    @property
    def dpmm(self) -> float | None:
        dpi = self.dpi
        return None if dpi is None else dpi / MM_PER_INCH

    @property
    def dpi(self) -> float | None:
        if self._dpi is None:
            return None
        return self._dpi if self.sid is None else self._dpi * (self.sid / 1000)


class DicomImage(BaseImage):
    """An image from a DICOM file (path, bytes or binary stream)."""

    def __init__(self, path, *, dtype=None, dpi: float | None = None,
                 sid: float | None = None, sad: float = 1000,
                 raw_pixels: bool = False, invert_pixels: bool | None = None):
        super().__init__(path)
        self._sid = sid
        self._dpi = dpi
        self._sad = sad
        self.metadata = dcm.dcmread(
            path if isinstance(path, (str, Path, bytes)) else path.read())
        arr = self.metadata.pixel_array
        self.array = arr.astype(dtype) if dtype is not None else arr.copy()
        self.array = _rescale_dicom_values(
            self.array, self.metadata, raw_pixels=raw_pixels,
            invert_pixels=invert_pixels)

    @property
    def z_position(self) -> float:
        return z_position(self.metadata)

    @property
    def slice_spacing(self) -> float:
        spacing = self.metadata.get("SpacingBetweenSlices")
        if spacing is not None:
            return abs(spacing)
        return self.metadata.SliceThickness

    @property
    def sid(self) -> float | None:
        v = self.metadata.get("RTImageSID")
        if v is not None:
            try:
                return float(v)
            except (TypeError, ValueError):
                pass
        return self._sid

    @property
    def sad(self) -> float:
        v = self.metadata.get("RadiationMachineSAD")
        if v is not None:
            try:
                return float(v)
            except (TypeError, ValueError):
                pass
        return self._sad

    @property
    def dpi(self) -> float | None:
        dpmm = self.dpmm
        return self._dpi if dpmm is None else dpmm * MM_PER_INCH

    @property
    def dpmm(self) -> float | None:
        """Dots per mm at isocentre, scaled by SID/SAD."""
        dpmm = None
        for tag in ("PixelSpacing", "ImagePlanePixelSpacing", "ImagerPixelSpacing"):
            mmpd = self.metadata.get(tag)
            if mmpd is not None:
                if isinstance(mmpd, (int, float)):
                    mmpd = [mmpd]
                dpmm = 1 / mmpd[0]
                break
        if dpmm is not None and self.sid is not None:
            dpmm *= self.sid / self.sad
        elif dpmm is None and self._dpi is not None:
            dpmm = self._dpi / MM_PER_INCH
        return dpmm

    @property
    def cax(self) -> Point:
        """Beam CAX, accounting for EPID translations."""
        try:
            translation = self.metadata.XRayImageReceptorTranslation
            mag_factor = self.sid / self.sad
            x = self.center.x - translation[0] * self.dpmm / mag_factor
            y = self.center.y + translation[1] * self.dpmm / mag_factor
        except (AttributeError, ValueError, TypeError):
            return self.center
        return Point(x, y)


class LinacDicomImage(DicomImage):
    """A DICOM image from a linac: gantry, collimator and couch angles from
    the tags, from the file name (``use_filenames``) or from ``gantry``,
    ``coll`` and ``couch`` overrides."""

    gantry_keyword = "Gantry"
    collimator_keyword = "Coll"
    couch_keyword = "Couch"

    def __init__(self, path, use_filenames: bool = False,
                 axes_precision: int | None = None,
                 missing_axis_value: float | str = 0, **kwargs):
        self._axis_overrides = {}
        for axis in ("gantry", "coll", "couch"):
            if axis in kwargs:
                self._axis_overrides[axis] = kwargs.pop(axis)
        super().__init__(path, **kwargs)
        self._use_filenames = use_filenames
        self._axes_precision = axes_precision
        self._missing_axis_value = missing_axis_value

    def _get_axis_value(self, axis_str: str, axis_dcm_attr: str, override_key: str) -> float:
        if override_key in self._axis_overrides:
            return float(self._axis_overrides[override_key])
        if self._use_filenames:
            filename = osp.basename(str(self.path))
            match = re.search(rf"(?<={axis_str})\d+\.?\d*", filename, flags=re.IGNORECASE)
            if match is None:
                if self._missing_axis_value == "raise":
                    raise ValueError(
                        f"The filename {filename} did not contain a {axis_str} value")
                return float(self._missing_axis_value)
            return self._round(float(match.group()))
        value = self.metadata.get(axis_dcm_attr)
        if value is None:
            if self._missing_axis_value == "raise":
                raise ValueError(f"No {axis_dcm_attr} tag found in the DICOM file")
            return float(self._missing_axis_value)
        return self._round(float(value))

    def _round(self, value: float) -> float:
        wrapped = value % 360
        if self._axes_precision is not None:
            wrapped = round(wrapped, self._axes_precision)
        if wrapped in (360.0,):
            wrapped = 0.0
        return wrapped

    @property
    def gantry_angle(self) -> float:
        return self._get_axis_value(self.gantry_keyword, "GantryAngle", "gantry")

    @property
    def collimator_angle(self) -> float:
        return self._get_axis_value(self.collimator_keyword, "BeamLimitingDeviceAngle", "coll")

    @property
    def couch_angle(self) -> float:
        return self._get_axis_value(self.couch_keyword, "PatientSupportAngle", "couch")


def z_position(metadata: dcm.Dataset) -> float:
    """Z position of a slice: ImagePositionPatient[2], else SliceLocation."""
    try:
        return float(metadata.ImagePositionPatient[2])
    except AttributeError:
        return float(metadata.SliceLocation)


class DicomImageStack:
    """An eager stack of DICOM CT/MR slices from a folder (searched
    recursively), filtered to the most common series and sorted by z. Any
    DICOM file with pixel data counts as a slice, as in the JAX loader."""

    images: list[DicomImage]

    def __init__(self, folder, dtype=None, min_number: int = 39,
                 check_uid: bool = True, raw_pixels: bool = False):
        paths = [str(p) for p in sorted(Path(folder).rglob("*")) if p.is_file()]
        candidates = [DicomImage(p, dtype=dtype, raw_pixels=raw_pixels)
                      for p in paths if dcm.is_dicom_image(p)]
        if check_uid:
            candidates = self._filter_uid(candidates, min_number)
        candidates.sort(key=lambda img: img.z_position)
        self.images = candidates
        if len(self.images) < 2:
            raise FileNotFoundError(f"No CT images were found in {folder}")

    @staticmethod
    def _filter_uid(images: list[DicomImage], min_number: int) -> list[DicomImage]:
        uids = [img.metadata.get("SeriesInstanceUID") for img in images]
        if not uids:
            return images
        most_common, count = Counter(uids).most_common(1)[0]
        if count < min_number:
            raise ValueError(
                f"The minimum number of CT images ({min_number}) was not found")
        return [img for img in images if img.metadata.get("SeriesInstanceUID") == most_common]

    @property
    def metadata(self) -> dcm.Dataset:
        return self.images[0].metadata

    @property
    def metadatas(self) -> list[dcm.Dataset]:
        return [img.metadata for img in self.images]

    @property
    def slice_spacing(self) -> float:
        """Median z-gap between slices."""
        zs = sorted(img.z_position for img in self.images)
        return float(np.median(np.abs(np.diff(zs))))

    def __getitem__(self, item) -> DicomImage:
        return self.images[item]

    def __len__(self):
        return len(self.images)
