"""Host array helpers.

Port of ``geometric_center_idx`` (``pylinac_tpu/core/array_utils.py:15``),
``geometric_center_value`` (``:20``), ``normalize`` (``:28``), ``invert``
(``:33``), ``bit_invert`` (``:38``), ``ground`` (``:49``), ``filter`` (``:53``), ``stretch``
(``:73``), ``get_dtype_info`` (``:85``), ``convert_to_dtype`` (``:92``),
``array_to_dicom`` (``:143``), ``_rt_image_position`` (``:136``),
``find_nearest_idx`` (``:104``), ``fill_middle_zeros`` (``:108``), the
``is_monotonic*`` trio (``:124-132``) and
``create_dicom_files_from_3d_array`` (``:185``, written through the port's
``core/dcm.py``), and ``median3x3_array``, the 3x3
median of an image or a stack through the kernel. ``array_to_dicom``
stretches a float array over uint16, as the JAX function does (the
projections of ``WinstonLutz.from_cbct``). ``filter`` and
``median3x3_array`` run on the device they are given, CUDA when it is
``None`` (a 3x3 median launches ``csrc/median3x3.cu`` there), as the JAX
function put a full image on the default device. The profiles pass
``device="cpu"`` (:meth:`pylinac_tpu_torch.core.profile.ProfileMixin.filter`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import dcm
from .utilities import resolve_device


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


def bit_invert(array: np.ndarray) -> np.ndarray:
    """Bitwise inversion, in the array's own (integer or bool) dtype."""
    try:
        return np.invert(array)
    except TypeError:
        raise ValueError(
            f"The datatype {array.dtype} could not be safely inverted. "
            "Cast to an integer-like datatype first.")


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


def convert_to_dtype(array: np.ndarray, dtype) -> np.ndarray:
    """Range-preserving dtype conversion (value 100 of uint8 becomes about
    25,690 of uint16)."""
    old_info = get_dtype_info(array.dtype)
    if isinstance(old_info, np.finfo):
        relative_values = stretch(array, min=0, max=1)
    else:
        relative_values = array.astype(float) / old_info.max
    new_info = get_dtype_info(dtype)
    new_range = new_info.max - new_info.min
    return np.array(relative_values * new_range - new_info.max - 1, dtype=dtype)


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


def find_nearest_idx(array: np.ndarray, value: float) -> int:
    """The index of the element nearest ``value`` (the first of ties)."""
    return int((np.abs(array - value)).argmin())


def fill_middle_zeros(array: np.ndarray, cutoff_px: int = 0) -> np.ndarray:
    """A 0/1 profile with the 0s between its first rising and its last
    falling edge set to 1, after zeroing ``cutoff_px`` samples at each end."""
    array = array.astype(float)
    if np.max(array) > 1 or np.min(array) < 0:
        raise ValueError("Array values must be between 0 and 1")
    if cutoff_px:
        array[:cutoff_px] = 0
        array[-cutoff_px:] = 0
    edges = np.diff(array)
    left_edge = np.min(np.where(edges > 0.5)[0])
    right_edge = np.max(np.where(edges < -0.5)[0])
    filled = array.copy()
    filled[left_edge + 1: right_edge + 1] = 1.0
    return filled


def is_monotonically_increasing(array: np.ndarray) -> bool:
    return bool(np.all(np.diff(array) > 0))


def is_monotonically_decreasing(array: np.ndarray) -> bool:
    return bool(np.all(np.diff(array) < 0))


def is_monotonic(array: np.ndarray) -> bool:
    return is_monotonically_increasing(array) or is_monotonically_decreasing(array)


def median3x3_array(array: np.ndarray, device=None) -> np.ndarray:
    """3x3 median (scipy "reflect" edges) of an (H, W) image, or of each
    image of a (B, H, W) stack, in the array's dtype: one
    :func:`pylinac_tpu_torch.ops.median.median3x3` call on ``device``
    (``None`` means CUDA, and raises without it). Other dtypes (int64,
    uint64, bool) take the plain sort on the CPU and raise a TypeError on
    the card."""
    from ..ops import filters

    device = resolve_device(device, "median3x3_array")
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
           device=None) -> np.ndarray:
    """Median or Gaussian filter on ``device`` (``None`` means CUDA, and
    raises without it); a float ``size`` in (0, 1) is
    a fraction of the array's length. The median keeps the array's dtype; a
    3x3 median of a 2D array is :func:`median3x3_array`. The Gaussian
    returns float32."""
    from ..ops import filters

    if isinstance(size, float):
        if 0 < size < 1:
            size = max(int(round(len(array) * size)), 1)
        else:
            raise ValueError("Float was passed but was not between 0 and 1")
    device = resolve_device(device, "filter")
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
    """An RT Image DICOM dataset holding a 2D array; a float array is
    stretched over uint16 first."""
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
    if array.dtype.kind == "f":
        array = convert_to_dtype(array, np.uint16)
    ds.set_pixel_data(np.ascontiguousarray(array))
    if extra_tags:
        for key, value in extra_tags.items():
            setattr(ds, key, value)
    return ds


def create_dicom_files_from_3d_array(array: np.ndarray, out_dir=None,
                                     slice_thickness: float = 1, pixel_size: float = 1):
    """A pseudo-CT DICOM series of a 3D array, one uint16 file a slice along
    its last axis, named ``{i}.dcm`` in ``out_dir`` (a new temporary folder
    when None); the folder."""
    import tempfile
    from pathlib import Path

    series_uid = dcm.generate_uid()
    out_dir = Path(out_dir) if out_dir is not None else Path(tempfile.mkdtemp())
    out_dir.mkdir(exist_ok=True, parents=True)
    for i in range(array.shape[-1]):
        ds = array_to_dicom(
            array[..., i].astype(np.uint16), sid=1000, gantry=0, coll=0, couch=0, dpi=25.4,
            extra_tags={
                "SeriesInstanceUID": series_uid,
                "ImagePositionPatient": [0.0, 0.0, float(i * slice_thickness)],
                "SliceThickness": slice_thickness,
                "PixelSpacing": [float(pixel_size), float(pixel_size)],
            })
        dcm.dcmwrite(out_dir / f"{i}.dcm", ds)
    return out_dir
