"""Host image model: DICOM and XIM images, arrays and CT stacks as numpy
arrays.

Port of the part of ``pylinac_tpu/core/image.py`` that the analyses use:
``equate_images`` (``:45``), ``load`` (``:89``, DICOM, XIM and arrays),
``load_multiples`` (``:113``), ``ImageLike`` (``:42``), ``BaseImage``
(``:201-470``: ``from_multiples`` (``:238``), ``truncated_path``,
``center``, ``physical_shape``, ``date_created``, ``filter`` (``:270``),
``crop`` with ``edges``, ``flipud``, ``fliplr``, ``invert``, ``bit_invert``,
``roll``, ``rot90``, ``rotate`` (``:308``, bilinear through
:func:`pylinac_tpu_torch.ops.interp.map_coordinates`), ``threshold``,
``as_binary``, ``dist2edge_min`` (``:336``), ``ground``, ``normalize``,
``check_inversion`` (``:352``), ``check_inversion_by_histogram``, ``gamma``,
the Bakai approximation (``:377-402``), ``compute``, ``as_dicom``,
``as_type``, ``shape``, ``size``, ``ndim``, ``dtype``, ``sum``, indexing,
the numpy array protocol, ``__sub__``, ``plot`` (``:471``) and the
``base_path`` and ``source`` set at ``:222-227``), ``XIM`` (``:494``, the
file parsed by :mod:`pylinac_tpu_torch.core.xim`), ``DicomImage`` (``:522``:
load, ``from_dataset`` (``:542``), ``save`` (``:548``) with
``_unscale_dicom_values``, ``z_position``, ``slice_spacing``, ``sid``,
``sad``, ``dpi``, ``dpmm``, ``cax``, ``as_dicom``), ``LinacDicomImage``
(``:635-694``: axis angles from tags, file names or overrides),
``ArrayImage`` (``:739``, with ``dpi``, ``sid`` and ``dpmm``),
``z_position`` (``:775``), ``DicomImageStack`` (``:796-879``: UID filter,
z-sort, ``slice_spacing``, ``metadata``, ``from_zip``, ``side_view``
``:847``, ``array_3d`` ``:857``, ``roll`` ``:861``, ``plot`` ``:865``,
``__delitem__`` ``:874``), ``LazyDicomImageStack`` (``:881``: paths and
metadata kept, pixels decoded on each item access, ``array_3d`` ``:945``
filled a slice at a time), ``LazyZipDicomImageStack`` (``:949``),
``FileImage`` (``:696``: TIFF, PNG and JPEG files through Pillow, with
``dpi`` and ``dpmm``), ``NMImageStack`` (``:963``), ``tiff_to_dicom``,
``load_raw_visionrt`` and ``load_raw_cyberknife`` (``:991-1010``) and
``_rescale_dicom_values`` (``:142``). Pixels stay on the host as numpy; the
analyses stage them on the card. A compressed slice
(``core/compressed_px.py``) loads as any other. Pillow is imported where a
file is opened, never with the module.
"""

from __future__ import annotations

import io as _io
import os.path as osp
import re
import warnings
from collections import Counter
from datetime import datetime
from pathlib import Path
from typing import Union

import numpy as np
import torch

from . import dcm
from .array_utils import filter as _filter_array
from .array_utils import bit_invert, convert_to_dtype, get_dtype_info, ground, invert, normalize
from .array_utils import stretch as stretcharray
from .geometry import Point
from .io import TemporaryZipDirectory, retrieve_filenames
from .utilities import resolve_device
from .xim import XimImage, is_xim

MM_PER_INCH = 25.4
FILE_TYPE = "file"
STREAM_TYPE = "stream"

ImageLike = Union["DicomImage", "ArrayImage", "FileImage", "LinacDicomImage"]


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


def _unscale_dicom_values(scaled, metadata, raw_pixels, invert_pixels):
    """Undo :func:`_rescale_dicom_values`."""
    if raw_pixels:
        return scaled
    sign = metadata.get("PixelIntensityRelationshipSign")
    if invert_pixels or (invert_pixels is None and sign == -1):
        unscaled = scaled.max() + scaled.min() - scaled
    else:
        unscaled = scaled
    slope = metadata.get("RescaleSlope")
    intercept = metadata.get("RescaleIntercept")
    if slope is not None and intercept is not None:
        unscaled = (unscaled - intercept) / slope
    return unscaled


class BaseImage:
    """A numpy pixel array with the array operations the analyses use."""

    array: np.ndarray
    path: str | Path

    def __init__(self, path):
        if isinstance(path, (str, Path)) and not osp.isfile(path):
            raise FileExistsError(
                f"File `{path}` does not exist. Verify the file path name.")
        if isinstance(path, (str, Path)):
            self.path = path
            self.base_path = osp.basename(path)
            self.source = FILE_TYPE
        else:
            self.path = ""
            self.source = STREAM_TYPE

    @classmethod
    def from_multiples(cls, filelist, method="mean", stretch=True, **kwargs):
        """The images of ``filelist`` combined by :func:`load_multiples`."""
        return load_multiples(filelist, method, stretch, **kwargs)

    @property
    def truncated_path(self) -> str:
        """The path, cut to its last 47 characters after "..." when longer
        than 50."""
        p = str(getattr(self, "path", ""))
        return "..." + p[-47:] if len(p) > 50 else p

    @property
    def center(self) -> Point:
        return Point((self.shape[1] / 2) - 0.5, (self.shape[0] / 2) - 0.5)

    @property
    def physical_shape(self) -> tuple[float, float]:
        """The image's height and width in mm."""
        return self.shape[0] / self.dpmm, self.shape[1] / self.dpmm

    def date_created(self, format: str = "%A, %B %d, %Y") -> str:
        """The DICOM creation date, else the study date, else the file's
        creation time, else "Unknown"."""
        date = None
        try:
            date = datetime.strptime(
                self.metadata.InstanceCreationDate
                + str(round(float(self.metadata.InstanceCreationTime))),
                "%Y%m%d%H%M%S").strftime(format)
        except Exception:  # a missing or malformed tag: the next source
            try:
                date = datetime.strptime(self.metadata.StudyDate, "%Y%m%d").strftime(format)
            except Exception:
                pass
        if date is None:
            try:
                date = datetime.fromtimestamp(osp.getctime(self.path)).strftime(format)
            except Exception:
                date = "Unknown"
        return date

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

    def flipud(self) -> None:
        self.array = np.flipud(self.array)

    def fliplr(self) -> None:
        self.array = np.fliplr(self.array)

    def invert(self) -> None:
        self.array = invert(self.array)

    def bit_invert(self) -> None:
        self.array = bit_invert(self.array)

    def roll(self, direction: str = "x", amount: int = 1) -> None:
        axis = 1 if direction == "x" else 0
        self.array = np.roll(self.array, amount, axis=axis)

    def rot90(self, n: int = 1) -> None:
        self.array = np.rot90(self.array, n)

    def rotate(self, angle: float, mode: str = "edge", *args, **kwargs) -> None:
        """Rotate counter-clockwise by ``angle`` degrees about the centre:
        bilinear, the sample points clipped to the image (edge padding), in
        float32 on the CPU, as the JAX method."""
        from ..ops.interp import map_coordinates

        h, w = self.array.shape
        cy, cx = (h - 1) / 2, (w - 1) / 2
        theta = np.deg2rad(angle)
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        # the inverse rotation of each output pixel
        ys = cy + np.cos(theta) * (yy - cy) - np.sin(theta) * (xx - cx)
        xs = cx + np.sin(theta) * (yy - cy) + np.cos(theta) * (xx - cx)
        coords = np.stack([np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]).astype(np.float32)
        self.array = map_coordinates(torch.from_numpy(np.asarray(self.array, np.float32)),
                                     torch.from_numpy(coords)).numpy()

    def threshold(self, threshold: float, kind: str = "high") -> None:
        """Zero every pixel below (``kind="high"``) or above the threshold."""
        if kind == "high":
            self.array = np.where(self.array >= threshold, self.array, 0)
        else:
            self.array = np.where(self.array <= threshold, self.array, 0)

    def as_binary(self, threshold: float) -> ArrayImage:
        return ArrayImage(np.where(self.array >= threshold, 1, 0))

    def dist2edge_min(self, point: Point | tuple) -> float:
        """The distance from ``point`` to the nearest image edge."""
        if isinstance(point, tuple):
            point = Point(point)
        rows, cols = self.shape[0], self.shape[1]
        return min(rows - point.y, cols - point.x, point.y, point.x)

    def check_inversion(self, box_size: int = 20,
                        position: tuple[float, float] = (0.0, 0.0)) -> None:
        """Invert when the mean of the four corner boxes is above the image
        mean."""
        row_pos = max(int(position[0] * self.array.shape[0]), 1)
        col_pos = max(int(position[1] * self.array.shape[1]), 1)
        lt_upper = self.array[row_pos: row_pos + box_size, col_pos: col_pos + box_size]
        rt_upper = self.array[row_pos: row_pos + box_size, -col_pos - box_size: -col_pos]
        lt_lower = self.array[-row_pos - box_size: -row_pos, col_pos: col_pos + box_size]
        rt_lower = self.array[-row_pos - box_size: -row_pos, -col_pos - box_size: -col_pos]
        avg = np.mean((lt_upper, lt_lower, rt_upper, rt_lower))
        if avg > np.mean(self.array.flatten()):
            self.invert()

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

    def as_dicom(self, *args, **kwargs):
        raise NotImplementedError(f"as_dicom is not implemented for {type(self).__name__}")

    def as_type(self, dtype) -> np.ndarray:
        return self.array.astype(dtype)

    @property
    def shape(self):
        return self.array.shape

    @property
    def size(self) -> int:
        return self.array.size

    @property
    def ndim(self) -> int:
        return self.array.ndim

    @property
    def dtype(self):
        return self.array.dtype

    def sum(self) -> float:
        return self.array.sum()

    def __getitem__(self, item):
        return self.array[item]

    def __array__(self, dtype=None, copy=None):
        # without this, np.asarray(image) would iterate and copy the array
        if dtype is None or dtype == self.array.dtype:
            return self.array if not copy else self.array.copy()
        return self.array.astype(dtype)

    def __len__(self):
        return len(self.array)

    def __sub__(self, other):
        return ArrayImage(self.array - other.array)

    def plot(self, ax=None, show: bool = True, clear_fig: bool = False,
             show_metrics: bool = True, metric_kwargs: dict | None = None, **kwargs):
        """The image on a matplotlib axes (a new one by default), with the
        computed metrics drawn over it (JAX ``core/image.py:471``)."""
        import matplotlib.pyplot as plt

        if ax is None:
            fig, ax = plt.subplots()
        if clear_fig:
            plt.clf()
        ax.imshow(self.array, cmap=kwargs.pop("cmap", "gray"), **kwargs)
        if show_metrics:
            for metric in getattr(self, "metrics", []):
                try:
                    metric.plot(ax, **(metric_kwargs or {}))
                except Exception:
                    pass
        if show:
            plt.show()
        return ax

    def plotly(self, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError("plotly is not available in this environment")


def _is_xim_file(path) -> bool:
    try:
        return is_xim(path)
    except Exception:  # not a path at all: not an XIM file, as in JAX
        return False


def _is_image_file(path) -> bool:
    """Whether Pillow opens ``path`` as an image."""
    try:
        from PIL import Image as pImage

        with pImage.open(path):
            return True
    except Exception:  # no image file, or no Pillow: not an image file, as in JAX
        return False


def load(path, **kwargs) -> BaseImage:
    """An image from an image object, a numpy array, a DICOM file, a Varian
    .xim file or an image file that Pillow reads (TIFF, PNG, JPEG)."""
    if isinstance(path, BaseImage):
        return path
    if isinstance(path, np.ndarray):
        return ArrayImage(path, **kwargs)
    if dcm.is_dicom(path):
        return DicomImage(path, **kwargs)
    if _is_xim_file(path):
        return XIM(path, **kwargs)
    if _is_image_file(path):
        return FileImage(path, **kwargs)
    raise TypeError(
        f"The argument `{path}` was not found to be a valid DICOM file, Image file, or array")


def equate_images(image1: BaseImage, image2: BaseImage,
                  device=None) -> tuple[BaseImage, BaseImage]:
    """Copies of two images cropped to the same physical size, the larger
    then resampled (bilinear, :func:`.ops.interp.map_coordinates` on
    ``device``) to the smaller's shape."""
    from ..ops.interp import map_coordinates

    image1 = ArrayImage(np.copy(image1.array), dpi=image1.dpi)
    image2 = ArrayImage(np.copy(image2.array), dpi=image2.dpi)
    phys_h1, phys_w1 = image1.physical_shape
    phys_h2, phys_w2 = image2.physical_shape
    if phys_h1 > phys_h2:
        diff = int(round((phys_h1 - phys_h2) * image1.dpmm / 2))
        if diff > 0:
            image1.crop(diff, edges=("top", "bottom"))
    elif phys_h2 > phys_h1:
        diff = int(round((phys_h2 - phys_h1) * image2.dpmm / 2))
        if diff > 0:
            image2.crop(diff, edges=("top", "bottom"))
    if phys_w1 > phys_w2:
        diff = int(round((phys_w1 - phys_w2) * image1.dpmm / 2))
        if diff > 0:
            image1.crop(diff, edges=("left", "right"))
    elif phys_w2 > phys_w1:
        diff = int(round((phys_w2 - phys_w1) * image2.dpmm / 2))
        if diff > 0:
            image2.crop(diff, edges=("left", "right"))
    if image1.shape != image2.shape:
        device = resolve_device(device, "equate_images")
        target_shape = (min(image1.shape[0], image2.shape[0]),
                        min(image1.shape[1], image2.shape[1]))
        for img in (image1, image2):
            if img.shape != target_shape:
                rr = np.linspace(0, img.shape[0] - 1, target_shape[0])
                cc = np.linspace(0, img.shape[1] - 1, target_shape[1])
                grid = np.stack(np.meshgrid(rr, cc, indexing="ij")).astype(np.float32)
                img.array = map_coordinates(
                    torch.as_tensor(np.asarray(img.array, np.float32), device=device),
                    torch.as_tensor(grid, device=device)).cpu().numpy()
    return image1, image2


def load_multiples(image_file_list, method: str = "mean", stretch_each: bool = True,
                   loader=load, **kwargs) -> BaseImage:
    """Combine several same-shape images into the first one by ``method``
    ("mean", "max" or "sum"), each stretched to [0, 1] first when
    ``stretch_each``."""
    img_list = [loader(path, **kwargs) for path in image_file_list]
    first_img = img_list[0]
    for img in img_list:
        if img.shape != first_img.shape:
            raise ValueError("Images were not the same shape")
        if stretch_each:
            img.array = stretcharray(img.array)
    new_array = np.stack([img.array for img in img_list], axis=-1)
    if method == "mean":
        combined = np.mean(new_array, axis=-1)
    elif method == "max":
        combined = np.max(new_array, axis=-1)
    elif method == "sum":
        combined = np.sum(new_array, axis=-1)
    else:
        raise ValueError(f"Unknown combination method {method}")
    first_img.array = combined
    first_img._raw_pixels = True
    return first_img


class ArrayImage(BaseImage):
    """An image made directly from a numpy array, with an optional DPI at
    the detector and SID (the DPI scales to isocentre by SID / 1000)."""

    def __init__(self, array: np.ndarray, *, dpi: float | None = None,
                 sid: float | None = None, dtype=None):
        self.array = np.asarray(array, dtype=dtype)
        self._dpi = dpi
        self.sid = sid
        self.source = STREAM_TYPE
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


class FileImage(BaseImage):
    """An image from a standard image file (TIFF, PNG, JPEG) read with
    Pillow; modes other than F, I, I;16, L and P become float32 ("F")."""

    def __init__(self, path, *, dpi: float | None = None, sid: float | None = None,
                 dtype=None):
        from PIL import Image as pImage

        super().__init__(path)
        pil_image = pImage.open(path)
        if pil_image.mode not in ("F", "I", "I;16", "L", "P"):
            pil_image = pil_image.convert("F")
        self.info = pil_image.info
        if dtype is not None:
            self.array = np.array(pil_image, dtype=dtype)
        else:
            self.array = np.array(pil_image)
        self._dpi = dpi
        self.sid = sid

    @property
    def dpi(self) -> float | None:
        """The file's DPI tag ("dpi" or "resolution"; below 3 counts as
        none), else the ``dpi`` given; scaled by SID / 1000 when ``sid`` is
        given."""
        dpi = None
        for key in ("dpi", "resolution"):
            dpi = self.info.get(key)
            if dpi is not None:
                dpi = float(dpi[0])
                if dpi < 3:
                    dpi = None
                break
        if dpi is None:
            dpi = self._dpi
        if self.sid is not None and dpi is not None:
            dpi *= self.sid / 1000
        return dpi

    @property
    def dpmm(self) -> float | None:
        try:
            return self.dpi / MM_PER_INCH
        except TypeError:
            return None


class XIM(BaseImage):
    """A Varian .xim image (:mod:`pylinac_tpu_torch.core.xim`)."""

    def __init__(self, file_path, read_pixels: bool = True):
        super().__init__(path=file_path)
        self._xim = XimImage(file_path, read_pixels=read_pixels)
        if self._xim.array is not None:
            self.array = self._xim.array

    @property
    def properties(self) -> dict:
        return self._xim.properties

    @property
    def dpmm(self) -> float:
        return self._xim.dpmm

    @property
    def dpi(self) -> float:
        return self.dpmm * MM_PER_INCH

    def as_dicom(self):
        return self._xim.as_dicom()

    def save_as(self, file, format=None):
        self._xim.save_as(file, format=format)


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
        self._original_dtype = self.metadata.pixel_array.dtype
        self._raw_pixels = raw_pixels
        self._invert_pixels = invert_pixels
        arr = self.metadata.pixel_array
        self.array = arr.astype(dtype) if dtype is not None else arr.copy()
        self.array = _rescale_dicom_values(
            self.array, self.metadata, raw_pixels=raw_pixels,
            invert_pixels=invert_pixels)

    @classmethod
    def from_dataset(cls, dataset: dcm.Dataset):
        """The image of a dataset in memory, written out and read back."""
        stream = _io.BytesIO()
        dcm.dcmwrite(stream, dataset)
        stream.seek(0)
        return cls(path=stream)

    def save(self, filename):
        """Write the image back out as DICOM, its values unscaled to the
        stored dtype (stretched to fit when they do not)."""
        unscaled = _unscale_dicom_values(
            self.array, self.metadata, self._raw_pixels, self._invert_pixels)
        info = get_dtype_info(self._original_dtype)
        if unscaled.max() > info.max or unscaled.min() < info.min:
            warnings.warn("Pixel values outside original dtype range; normalizing to fit.")
            unscaled = convert_to_dtype(unscaled, self._original_dtype)
        if self._raw_pixels:
            unscaled = convert_to_dtype(unscaled, self._original_dtype)
        self.metadata.set_pixel_data(
            np.ascontiguousarray(unscaled.astype(self._original_dtype)))
        dcm.dcmwrite(filename, self.metadata)
        return filename

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

    def as_dicom(self) -> dcm.Dataset:
        return self.metadata


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
        candidates = [DicomImage(p, dtype=dtype, raw_pixels=raw_pixels)
                      for p in retrieve_filenames(folder) if dcm.is_dicom_image(p)]
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

    @classmethod
    def from_zip(cls, zip_path, dtype=None, **kwargs):
        """The stack of the series in a zip archive, extracted to a
        temporary folder that is removed once the slices are loaded."""
        with TemporaryZipDirectory(zip_path) as tmpzip:
            return cls(tmpzip, dtype=dtype, **kwargs)

    @property
    def metadata(self) -> dcm.Dataset:
        return self.images[0].metadata

    @property
    def metadatas(self) -> list[dcm.Dataset]:
        return [img.metadata for img in self.images]

    def side_view(self, axis: int) -> np.ndarray:
        """The stack's maximum projection along ``axis`` of the (H, W, Z)
        volume."""
        return np.stack([i.array for i in self.images], axis=-1).max(axis=axis)

    @property
    def slice_spacing(self) -> float:
        """Median z-gap between slices."""
        zs = sorted(img.z_position for img in self.images)
        return float(np.median(np.abs(np.diff(zs))))

    def array_3d(self) -> np.ndarray:
        """The (Z, H, W) float32 volume."""
        return np.stack([img.array for img in self.images]).astype(np.float32)

    def roll(self, direction: str = "x", amount: int = 1) -> None:
        """Roll every slice by :meth:`BaseImage.roll`."""
        for img in self.images:
            img.roll(direction, amount)

    def plot(self, slice_idx: int = 0, **kwargs):
        """Slice ``slice_idx`` drawn by :meth:`BaseImage.plot`."""
        return self.images[slice_idx].plot(**kwargs)

    def __getitem__(self, item) -> DicomImage:
        return self.images[item]

    def __delitem__(self, key):
        del self.images[key]

    def __len__(self):
        return len(self.images)


class LazyDicomImageStack(DicomImageStack):
    """A stack that keeps each slice's path and metadata and decodes its
    pixels on every item access. Only CT and MR slices count. The CatPhan
    analysis decodes the series once into its cached host volume."""

    def __init__(self, folder, dtype=None, min_number: int = 39,
                 check_uid: bool = True, raw_pixels: bool = False):
        self._dtype = dtype
        self._raw_pixels = raw_pixels
        metas = []
        for path in retrieve_filenames(folder):
            try:
                ds = dcm.dcmread(path)
            except Exception:  # not DICOM: skipped, as the JAX loader does
                continue
            if ds.get("Modality") in ("CT", "MR") and "PixelData" in ds:
                metas.append((path, ds))
        if check_uid and metas:
            uids = [m[1].get("SeriesInstanceUID") for m in metas]
            most_common, count = Counter(uids).most_common(1)[0]
            if count < min_number:
                raise ValueError(
                    f"The minimum number of CT images ({min_number}) was not found")
            metas = [m for m in metas if m[1].get("SeriesInstanceUID") == most_common]
        metas.sort(key=lambda m: z_position(m[1]))
        self._paths = [m[0] for m in metas]
        self._metas = [m[1] for m in metas]
        if len(self._paths) < 2:
            raise FileNotFoundError(f"No CT images were found in {folder}")

    @property
    def metadata(self) -> dcm.Dataset:
        return self._metas[0]

    @property
    def metadatas(self) -> list[dcm.Dataset]:
        """Each slice's metadata, as a new list: deleting from it changes
        nothing, as on the eager stack."""
        return list(self._metas)

    @property
    def images(self) -> list[DicomImage]:
        """Every slice, decoded anew."""
        return [self[i] for i in range(len(self))]

    @images.setter
    def images(self, value) -> None:
        """Ignored, as in the JAX package: the slices are read from their
        files."""

    @property
    def slice_spacing(self) -> float:
        zs = sorted(z_position(m) for m in self._metas)
        return float(np.median(np.abs(np.diff(zs))))

    def array_3d(self) -> np.ndarray:
        """The (Z, H, W) float32 volume, filled a decoded slice at a time."""
        first = self[0].array
        volume = np.empty((len(self), *first.shape), np.float32)
        volume[0] = first
        for i in range(1, len(self)):
            volume[i] = self[i].array
        return volume

    def __getitem__(self, item) -> DicomImage:
        return DicomImage(self._paths[item], dtype=self._dtype, raw_pixels=self._raw_pixels)

    def __delitem__(self, key):
        """Drop a slice: its path and its metadata."""
        del self._paths[key]
        del self._metas[key]

    def __len__(self):
        return len(self._paths)


class LazyZipDicomImageStack(LazyDicomImageStack):
    """A lazy stack of the series in a zip archive, whose extracted folder
    lives as long as the stack."""

    @classmethod
    def from_zip(cls, zip_path, dtype=None, **kwargs):
        tmp = TemporaryZipDirectory(zip_path, delete=False)
        obj = cls(tmp.name, dtype=dtype, **kwargs)
        obj._tmp = tmp
        return obj


class NMImageStack:
    """The frames of one multi-frame NM DICOM file, each an
    :class:`ArrayImage` of float64 sharing the file's metadata."""

    def __init__(self, path):
        self.path = path
        self.metadata = dcm.dcmread(path)
        if self.metadata.get("Modality") != "NM":
            raise ValueError("The file is not an NM image")
        arr = self.metadata.pixel_array
        if arr.ndim == 2:
            arr = arr[None]
        self.frames = []
        for frame in arr:
            img = ArrayImage(np.asarray(frame, dtype=float))
            img.metadata = self.metadata  # shared file-level metadata
            self.frames.append(img)
        self.images = self.frames

    def as_3d_array(self) -> np.ndarray:
        return np.stack([f.array for f in self.frames]).astype(np.float32)

    def __len__(self):
        return len(self.frames)


def tiff_to_dicom(tiff_file, sid: float, gantry: float, coll: float, couch: float,
                  dpi: float | None = None) -> dcm.Dataset:
    """An RT Image dataset of a TIFF file; raises when neither the file nor
    ``dpi`` gives a DPI."""
    from .array_utils import array_to_dicom

    img = FileImage(tiff_file, dpi=dpi)
    if img.dpi is None:
        raise ValueError("TIFF file has no DPI tag; pass dpi explicitly")
    return array_to_dicom(img.array, sid=sid, gantry=gantry, coll=coll, couch=couch,
                          dpi=img.dpi)


def load_raw_visionrt(path: str | Path, shape: tuple[int, int] = (600, 960)) -> ArrayImage:
    """A raw VisionRT file: float32 little-endian."""
    arr = np.fromfile(path, dtype="<f4").reshape(shape)
    return ArrayImage(arr)


def load_raw_cyberknife(path: str | Path, shape: tuple[int, int] = (512, 512)) -> ArrayImage:
    """A raw CyberKnife image file: uint16 little-endian."""
    arr = np.fromfile(path, dtype="<u2").reshape(shape)
    return ArrayImage(arr)
