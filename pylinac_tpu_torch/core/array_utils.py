"""Host array helpers.

Port of ``geometric_center_idx`` (``pylinac_tpu/core/array_utils.py:15``),
``geometric_center_value`` (``:20``), ``normalize`` (``:28``), ``invert``
(``:33``), ``ground`` (``:49``), ``filter`` (``:53``), ``stretch``
(``:73``), ``get_dtype_info`` (``:85``), ``array_to_dicom`` (``:143``) and
``_rt_image_position`` (``:136``), and ``median3x3_array``, the 3x3
median of an image or a stack through the kernel. The port's simulators make integer arrays only, so the JAX
``array_to_dicom``'s float-to-uint16 rescale is not carried over: a float
array is rejected by ``Dataset.set_pixel_data``. ``filter`` runs the port's
filters on the device it is given: the CPU by default, where the profiles
live (the JAX function kept arrays of up to ``2**18`` elements on its
in-process CPU backend), and the card for an image
(:meth:`pylinac_tpu_torch.core.image.BaseImage.filter`), where a 3x3
median launches ``csrc/median3x3.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dcm


def geometric_center_idx(array: np.ndarray) -> float:
    """Centre index of a profile, (n - 1) / 2."""
    return (array.shape[0] - 1) / 2.0


def geometric_center_value(array: np.ndarray) -> float:
    """Centre value of a profile (the mean of the two central samples when
    the length is even)."""
    n = array.shape[0]
    if n % 2 == 0:
        return (array[n // 2] + array[n // 2 - 1]) / 2.0
    return array[(n - 1) // 2]


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


# the 3x3 median kernel computes in float32 or int32: the dtype each image
# dtype goes to there. The way there and back is exact, uint32 with its top
# bit flipped, which keeps its order in int32; float64 rounds to float32, as
# the JAX package (64-bit types off) rounds it on every backend.
_MEDIAN3X3_DTYPES = {np.uint8: torch.float32, np.int8: torch.float32,
                     np.uint16: torch.float32, np.int16: torch.float32,
                     np.float16: torch.float32, np.float32: torch.float32,
                     np.float64: torch.float32, np.int32: torch.int32,
                     np.uint32: torch.int32}
_TOP_BIT = np.uint32(0x80000000)


def median3x3_array(array: np.ndarray, device="cpu") -> np.ndarray:
    """3x3 median (scipy "reflect" edges) of an (H, W) image, or of each
    image of a (B, H, W) stack, in the array's dtype: one
    :func:`pylinac_tpu_torch.ops.median.median3x3` call on ``device``. Other
    dtypes (int64, uint64, bool) take the plain sort on the CPU and raise a
    TypeError on the card."""
    from ..ops import filters

    device = torch.device(device)
    work = _MEDIAN3X3_DTYPES.get(array.dtype.type)
    if work is None:
        if device.type != "cpu":
            raise TypeError(f"the 3x3 median kernel takes float32 or int32, which "
                            f"cannot hold every {array.dtype} value")
        images = torch.from_numpy(np.array(array)).reshape(-1, *array.shape[-2:])
        out = torch.stack([filters._median_general(image, 3) for image in images])
        return out.reshape(array.shape).numpy()
    a = np.ascontiguousarray(array)
    if a.dtype == np.uint32:
        a = (a ^ _TOP_BIT).view(np.int32)
    out = filters.median_filter(torch.from_numpy(a).to(device).to(work), 3).cpu().numpy()
    if array.dtype == np.uint32:
        return out.view(np.uint32) ^ _TOP_BIT
    return out.astype(array.dtype)


def filter(array: np.ndarray, size: float | int = 0.05, kind: str = "median",
           device="cpu") -> np.ndarray:
    """Median or Gaussian filter on ``device``; a float ``size`` in (0, 1) is
    a fraction of the array's length. The median keeps the array's dtype; a
    3x3 median of a 2D array is :func:`median3x3_array`. The Gaussian
    returns float32."""
    from ..ops import filters

    if isinstance(size, float):
        if 0 < size < 1:
            size = max(int(round(len(array) * size)), 1)
        else:
            raise ValueError("Float was passed but was not between 0 and 1")
    device = torch.device(device)
    if kind == "median":
        size = int(size)
        if size == 3 and array.ndim == 2:
            return median3x3_array(array, device)
        x = torch.from_numpy(np.array(array)).to(device)
        return filters._median_general(x, size).cpu().numpy().astype(array.dtype)
    if kind == "gaussian":
        x = torch.from_numpy(np.array(array, dtype=np.float32)).to(device)
        return filters.gaussian_filter(x, float(size)).cpu().numpy()
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
