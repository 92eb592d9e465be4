"""Host image model: a DICOM image loaded to a numpy array.

Port of the part of ``pylinac_tpu/core/image.py`` that
``PicketFenceBatch.__init__`` uses (``picketfence.py:928-937``):
``BaseImage`` (``:201``: ``center``, ``crop``, ``shape``), ``DicomImage``
(``:522``: load, ``sid``, ``sad``, ``dpmm``), ``LinacDicomImage`` (``:635``)
and ``_rescale_dicom_values`` (``:142``), unchanged. Pixels stay on the host
as numpy; the analysis stages them on the card.
"""

from __future__ import annotations

import os.path as osp
from pathlib import Path

import numpy as np

from . import dcm
from .geometry import Point

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

    @property
    def shape(self):
        return self.array.shape


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


class LinacDicomImage(DicomImage):
    """A DICOM image from a linac. The JAX class adds gantry, collimator and
    couch angles, which the batched picket fence does not read."""
