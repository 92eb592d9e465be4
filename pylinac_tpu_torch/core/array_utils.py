"""Host array helpers.

Port of ``normalize`` (``pylinac_tpu/core/array_utils.py:28``), ``invert``
(``:33``), ``ground`` (``:49``), ``filter`` (``:53``), ``stretch``
(``:73``), ``get_dtype_info`` (``:85``), ``array_to_dicom`` (``:143``) and
``_rt_image_position`` (``:136``). The port's simulators make integer arrays only, so the JAX
``array_to_dicom``'s float-to-uint16 rescale is not carried over: a float
array is rejected by ``Dataset.set_pixel_data``. ``filter`` runs the port's
filters on the CPU, where the profiles live, as the JAX function routed
them to its in-process CPU backend.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dcm


def ground(array: np.ndarray, value: float = 0) -> np.ndarray:
    return array - array.min() + value


def normalize(array: np.ndarray, value: float | None = None) -> np.ndarray:
    val = array.max() if value is None else value
    return array / val


def invert(array: np.ndarray) -> np.ndarray:
    """Value inversion, max + min - a, in the array's own dtype."""
    return -array + array.max() + array.min()


def get_dtype_info(dtype) -> np.iinfo | np.finfo:
    try:
        return np.iinfo(dtype)
    except ValueError:
        return np.finfo(dtype)


def stretch(array: np.ndarray, min: float = 0, max: float = 1) -> np.ndarray:
    """Ground and normalise to fit [min, max]."""
    if max <= min:
        raise ValueError(f"Max must be larger than min. Passed max of {max} was <= {min}")
    dtype_info = get_dtype_info(array.dtype)
    if max > dtype_info.max:
        raise ValueError(f"Max of {max} larger than datatype maximum {dtype_info.max}")
    if min < dtype_info.min:
        raise ValueError(f"Min of {min} smaller than datatype minimum {dtype_info.min}")
    return ground(normalize(ground(array)) * (max - min), value=min)


def filter(array: np.ndarray, size: float | int = 0.05, kind: str = "median") -> np.ndarray:
    """Median or Gaussian filter; a float ``size`` in (0, 1) is a fraction
    of the array's length."""
    from ..ops import filters

    if isinstance(size, float):
        if 0 < size < 1:
            size = max(int(round(len(array) * size)), 1)
        else:
            raise ValueError("Float was passed but was not between 0 and 1")
    if kind == "median":
        out = filters._median_general(torch.from_numpy(np.array(array)), int(size))
        return out.numpy().astype(array.dtype)
    if kind == "gaussian":
        x = torch.from_numpy(np.array(array, dtype=np.float32))
        return filters.gaussian_filter(x, float(size)).numpy()
    raise ValueError(f"Filter type {kind} unsupported. Use 'median' or 'gaussian'")


def _rt_image_position(array: np.ndarray, dpmm: float) -> list[float]:
    """RT Image Position tag value for an array centred at the origin."""
    rows, cols = array.shape
    px = 1.0 / dpmm
    return [-(cols * px / 2) + px / 2, -(rows * px / 2) + px / 2]


def array_to_dicom(array: np.ndarray, sid: float, gantry: float, coll: float,
                   couch: float, dpi: float | None = None,
                   extra_tags: dict | None = None) -> dcm.Dataset:
    """An RT Image DICOM dataset holding a 2D integer array."""
    if array.ndim != 2:
        raise ValueError("Array must be 2D")
    ds = dcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.481.1"  # RT Image Storage
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = dcm.generate_uid()
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.Modality = "RTIMAGE"
    ds.ImageType = ["ORIGINAL", "PRIMARY", "PORTAL"]
    ds.PatientName = "pylinac-tpu"
    ds.PatientID = "123456789"
    ds.RTImageSID = sid
    ds.RadiationMachineSAD = 1000.0
    ds.GantryAngle = gantry
    ds.BeamLimitingDeviceAngle = coll
    ds.PatientSupportAngle = couch
    if dpi is not None:
        dpmm = dpi / 25.4
        pixel_mm = 1.0 / dpmm
        ds.ImagePlanePixelSpacing = [pixel_mm, pixel_mm]
        ds.RTImagePosition = _rt_image_position(array, dpmm)
    ds.set_pixel_data(np.ascontiguousarray(array))
    if extra_tags:
        for key, value in extra_tags.items():
            setattr(ds, key, value)
    return ds
