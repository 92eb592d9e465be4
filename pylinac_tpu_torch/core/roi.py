"""Region-of-interest sampling, numpy only.

Port of ``pylinac_tpu/core/roi.py``: ``bbox_center`` ``:32``,
``disk_pixels`` ``:40``, ``DiskROI`` ``:53``, ``LowContrastDiskROI``
``:125``, ``HighContrastDiskROI`` ``:239``, ``_polygon_pixels`` ``:257`` and
``RectangleROI`` ``:278``, with ``DiskROI.plot2axes`` (``:109``) and the
low-contrast plot colours (``:213-221``); matplotlib is imported inside the
drawing. The
mammography specks take the argmax of ``DiskROI.masked_array`` (``:100``)
over the disk's bounding window (``masked_argmax``, the same pixel without
a full-frame array a speck); the masked arrays themselves are not ported.
The statistics stay on the host, where the JAX package
computes them too.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from .contrast import Contrast, contrast, michelson as _michelson, rms as _rms, visibility, weber as _weber
from .geometry import Circle, Point, Rectangle


def michelson(arr):
    return _michelson(np.asarray(arr, dtype=float))


def weber(feature, background):
    return _weber(feature, background)


def ratio(arr):
    a = np.asarray(arr, dtype=float)
    return float(a[0] / a[1])


def rms(arr):
    return _rms(np.asarray(arr, dtype=float))


def bbox_center(region) -> Point:
    """The centre of a region's bounding box, ``bbox`` being (min row, min
    col, max row, max col)."""
    bbox = region.bbox
    y = abs(bbox[0] - bbox[2]) / 2 + min(bbox[0], bbox[2])
    x = abs(bbox[1] - bbox[3]) / 2 + min(bbox[1], bbox[3])
    return Point(x, y)


def disk_pixels(array: np.ndarray, center: Point, radius: float) -> np.ndarray:
    """Pixels whose centers are strictly inside the circle (skimage.draw.disk
    convention)."""
    h, w = array.shape
    rmin = max(int(np.floor(center.y - radius)) - 1, 0)
    rmax = min(int(np.ceil(center.y + radius)) + 2, h)
    cmin = max(int(np.floor(center.x - radius)) - 1, 0)
    cmax = min(int(np.ceil(center.x + radius)) + 2, w)
    yy, xx = np.mgrid[rmin:rmax, cmin:cmax]
    mask = ((yy - center.y) / radius) ** 2 + ((xx - center.x) / radius) ** 2 < 1
    return array[rmin:rmax, cmin:cmax][mask]


class DiskROI(Circle):
    """A disk-shaped region of interest."""

    @classmethod
    def from_phantom_center(cls, array, angle, roi_radius, dist_from_center, phantom_center):
        center = cls._get_shifted_center(angle, dist_from_center, phantom_center)
        return cls(array=array, center=center, radius=roi_radius)

    def __init__(self, array: np.ndarray, radius: float, center: Point):
        super().__init__(center_point=center, radius=radius)
        self._array = np.asarray(array)

    @staticmethod
    def _get_shifted_center(angle, dist_from_center, phantom_center) -> Point:
        y_shift = np.sin(np.deg2rad(angle)) * dist_from_center
        x_shift = np.cos(np.deg2rad(angle)) * dist_from_center
        return Point(phantom_center.x + x_shift, phantom_center.y + y_shift)

    @cached_property
    def pixel_values(self) -> np.ndarray:
        return self.circle_mask()

    @cached_property
    def pixel_value(self) -> float:
        """The median pixel value of the ROI."""
        return float(np.median(self.circle_mask()))

    @cached_property
    def mean(self) -> float:
        return float(np.mean(self.circle_mask()))

    @cached_property
    def std(self) -> float:
        return float(np.std(self.circle_mask()))

    @cached_property
    def min(self) -> float:
        return float(np.min(self.circle_mask()))

    @cached_property
    def max(self) -> float:
        return float(np.max(self.circle_mask()))

    def circle_mask(self) -> np.ndarray:
        """The pixel values inside the circular ROI."""
        return disk_pixels(self._array, self.center, self.radius)

    def masked_argmax(self) -> Point:
        """The pixel of the ROI's maximum, the first in row-major order: the
        ``np.nanargmax`` of JAX's full-frame ``masked_array``, taken over the
        ROI's bounding window only (the window keeps the image's order of
        pixels)."""
        h, w = self._array.shape
        r = self.radius
        r0 = max(int(np.floor(self.center.y - r)) - 1, 0)
        c0 = max(int(np.floor(self.center.x - r)) - 1, 0)
        r1 = min(int(np.ceil(self.center.y + r)) + 2, h)
        c1 = min(int(np.ceil(self.center.x + r)) + 2, w)
        yy, xx = np.mgrid[r0:r1, c0:c1]
        mask = ((yy - self.center.y) / r) ** 2 + ((xx - self.center.x) / r) ** 2 < 1
        img = np.full(mask.shape, np.nan, dtype=float)
        img[mask] = self._array[r0:r1, c0:c1][mask]
        row, col = np.unravel_index(np.nanargmax(img), img.shape)
        return Point(int(col + c0), int(row + r0))

    def plot2axes(self, axes=None, edgecolor: str = "black", fill: bool = False,
                  text: str = "", fontsize: str = "medium", **kwargs) -> None:
        import matplotlib.pyplot as plt

        if axes is None:
            _, axes = plt.subplots()
            axes.imshow(self._array)
        super().plot2axes(axes, edgecolor=edgecolor, fill=fill, text=str(text),
                          fontsize=fontsize, **kwargs)

    def as_dict(self) -> dict:
        data = super().as_dict()
        data.update({"median": self.pixel_value, "std": self.std})
        return data


class LowContrastDiskROI(DiskROI):
    """Disk ROI for low-contrast analysis."""

    @classmethod
    def from_phantom_center(cls, array, angle, roi_radius, dist_from_center,
                            phantom_center, contrast_threshold=None,
                            contrast_reference=None, cnr_threshold=None,
                            contrast_method=Contrast.MICHELSON,
                            visibility_threshold=0.1):
        center = cls._get_shifted_center(angle, dist_from_center, phantom_center)
        return cls(array=array, radius=roi_radius, center=center,
                   contrast_threshold=contrast_threshold,
                   contrast_reference=contrast_reference,
                   cnr_threshold=cnr_threshold, contrast_method=contrast_method,
                   visibility_threshold=visibility_threshold)

    def __init__(self, array, radius, center, contrast_threshold=None,
                 contrast_reference=None, cnr_threshold=None,
                 contrast_method=Contrast.MICHELSON, visibility_threshold=0.1):
        super().__init__(array, radius, center=center)
        self.contrast_threshold = contrast_threshold
        self.cnr_threshold = cnr_threshold
        self.contrast_reference = contrast_reference
        self.contrast_method = contrast_method
        self.visibility_threshold = visibility_threshold

    @property
    def _contrast_array(self) -> np.ndarray:
        return np.array((self.pixel_value, self.contrast_reference))

    @property
    def signal_to_noise(self) -> float:
        return float(np.array(self.pixel_value) / self.std)

    @property
    def contrast_to_noise(self) -> float:
        return float(np.array(self.contrast) / self.std)

    @property
    def michelson(self) -> float:
        return michelson(self._contrast_array)

    @property
    def weber(self) -> float:
        return weber(feature=self.pixel_value, background=self.contrast_reference)

    @property
    def rms(self) -> float:
        return rms(self._contrast_array)

    @property
    def ratio(self) -> float:
        return ratio(self._contrast_array)

    @property
    def contrast(self) -> float:
        return contrast(self._contrast_array, self.contrast_method)

    @property
    def cnr_constant(self) -> float:
        return self.contrast_to_noise * self.diameter

    @property
    def visibility(self) -> float:
        return visibility(array=self._contrast_array, radius=self.radius,
                          std=self.std, algorithm=self.contrast_method)

    @property
    def contrast_constant(self) -> float:
        return self.contrast * self.diameter

    @property
    def passed(self) -> bool:
        return self.contrast > self.contrast_threshold

    @property
    def passed_visibility(self) -> bool:
        return self.visibility > self.visibility_threshold

    @property
    def passed_contrast_constant(self) -> bool:
        return self.contrast_constant > self.contrast_threshold

    @property
    def passed_cnr_constant(self) -> bool:
        return self.cnr_constant > self.cnr_threshold

    @property
    def plot_color(self) -> str:
        return "green" if self.passed_visibility else "red"

    @property
    def plot_color_constant(self) -> str:
        return "green" if self.passed_contrast_constant else "red"

    @property
    def plot_color_cnr(self) -> str:
        return "green" if self.passed_cnr_constant else "red"

    def as_dict(self) -> dict:
        return {
            "contrast method": self.contrast_method,
            "visibility": self.visibility,
            "visibility threshold": self.visibility_threshold,
            "passed visibility": bool(self.passed_visibility),
            "contrast": self.contrast,
            "cnr": self.contrast_to_noise,
            "signal to noise": self.signal_to_noise,
        }

    def percentile(self, percentile: float) -> float:
        return float(np.percentile(self.circle_mask(), percentile))


class HighContrastDiskROI(DiskROI):
    """A disk ROI over a line-pair group, for the MTF: its max and min."""

    @classmethod
    def from_phantom_center(cls, array, angle, roi_radius, dist_from_center,
                            phantom_center, contrast_threshold):
        center = cls._get_shifted_center(angle, dist_from_center, phantom_center)
        return cls(array=array, radius=roi_radius, center=center,
                   contrast_threshold=contrast_threshold)

    def __init__(self, array, radius, center, contrast_threshold):
        super().__init__(array=array, radius=radius, center=center)
        self.contrast_threshold = contrast_threshold

    def __repr__(self):
        return f"High-Contrast Disk; max pixel: {self.max}, min pixel: {self.min}"


def _polygon_pixels(array: np.ndarray, row_coords, col_coords) -> tuple[np.ndarray, np.ndarray]:
    """Scanline polygon rasterization (skimage.draw.polygon semantics)."""
    h, w = array.shape
    rmin = max(int(np.floor(min(row_coords))), 0)
    rmax = min(int(np.ceil(max(row_coords))) + 1, h)
    cmin = max(int(np.floor(min(col_coords))), 0)
    cmax = min(int(np.ceil(max(col_coords))) + 1, w)
    yy, xx = np.mgrid[rmin:rmax, cmin:cmax]
    # even-odd point-in-polygon
    inside = np.zeros(yy.shape, dtype=bool)
    n = len(row_coords)
    for i in range(n):
        y1, x1 = row_coords[i], col_coords[i]
        y2, x2 = row_coords[(i + 1) % n], col_coords[(i + 1) % n]
        cond = ((y1 > yy) != (y2 > yy)) & (
            xx < (x2 - x1) * (yy - y1) / (y2 - y1 + 1e-30) + x1)
        inside ^= cond
    rr, cc = np.nonzero(inside)
    return rr + rmin, cc + cmin


class RectangleROI(Rectangle):
    """A rectangular (possibly rotated) region of interest."""

    @classmethod
    def from_phantom_center(cls, array, width, height, angle, dist_from_center,
                            phantom_center, rotation: float = 0.0):
        y_shift = np.sin(np.deg2rad(angle)) * dist_from_center
        x_shift = np.cos(np.deg2rad(angle)) * dist_from_center
        center = Point(phantom_center.x + x_shift, phantom_center.y + y_shift)
        return cls(array=array, width=width, height=height, center=center,
                   rotation=rotation)

    def __init__(self, array, width, height, center, rotation: float = 0.0):
        if width < 2:
            raise ValueError(f"The width must be >= 2. Given {width}")
        if height < 2:
            raise ValueError(f"The height must be >= 2. Given {height}")
        super().__init__(width, height, center, rotation=rotation)
        self._array = np.asarray(array)

    def __repr__(self):
        return f"Rectangle ROI @ {self.center}; mean pixel: {self.pixel_value}"

    @cached_property
    def pixels_flat(self) -> np.ndarray:
        corners_y = [self.bl_corner.y - 1, self.br_corner.y - 1,
                     self.tr_corner.y, self.tl_corner.y]
        corners_x = [self.bl_corner.x, self.br_corner.x - 1,
                     self.tr_corner.x - 1, self.tl_corner.x]
        rr, cc = _polygon_pixels(self._array, corners_y, corners_x)
        return self._array[rr, cc]

    @cached_property
    def pixel_array(self) -> np.ndarray:
        if self.rotation != 0:
            raise ValueError("pixel_array requires rotation == 0.")
        return self._array[
            int(np.round(self.tl_corner.y)): int(np.round(self.bl_corner.y)),
            int(np.round(self.bl_corner.x)): int(np.round(self.br_corner.x)),
        ]

    @cached_property
    def pixel_value(self) -> float:
        return float(np.mean(self.pixels_flat))

    @cached_property
    def mean(self) -> float:
        return float(np.mean(self.pixels_flat))

    @cached_property
    def std(self) -> float:
        return float(np.std(self.pixels_flat))

    @cached_property
    def min(self) -> float:
        return float(np.min(self.pixels_flat))

    @cached_property
    def max(self) -> float:
        return float(np.max(self.pixels_flat))
