"""Synthetic EPID image layers for picket fence, Winston-Lutz and open-field
images, numpy and scipy.

Port of ``pylinac_tpu/imggen/layers.py``: ``Layer`` ``:111``,
``PerfectConeLayer`` ``:119``, ``PerfectFieldLayer`` ``:170``,
``FilteredFieldLayer`` ``:198``, ``FilterFreeFieldLayer`` ``:221``,
``PerfectBBLayer`` ``:242``, ``RandomNoiseLayer`` ``:270``, ``SlopeLayer``
``:295`` with the helpers they use (``clip_add`` ``:20``,
``clip_multiply`` ``:25``, ``even_round`` ``:30``, ``gaussian2d`` ``:35``,
``rotate_point`` ``:43``, ``_disk_coords`` ``:49``, ``_polygon_coords``
``:61``, ``draw_rotated_rectangle`` ``:80``), and ``GaussianFilterLayer``
``:251``.
The blur uses ``scipy.ndimage.gaussian_filter`` (same "reflect" edges and
truncation as the JAX filter, computed in float64 where the JAX one ran in
float32, so a pixel may differ by one count after the cast back).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
from scipy import ndimage

from ..core.array_utils import geometric_center_idx


def clip_add(image1: np.ndarray, image2: np.ndarray, dtype=np.uint16) -> np.ndarray:
    combined = image1.astype(float) + image2.astype(float)
    return np.clip(combined, np.iinfo(dtype).min, np.iinfo(dtype).max).astype(dtype)


def clip_multiply(image1: np.ndarray, image2: np.ndarray, dtype=np.uint16) -> np.ndarray:
    combined = image1.astype(float) * image2.astype(float)
    return np.clip(combined, np.iinfo(dtype).min, np.iinfo(dtype).max).astype(dtype)


def even_round(num: float) -> int:
    num = int(round(num))
    return num + num % 2


def gaussian2d(mx, my, height, center_x, center_y, width_x, width_y, constant=0):
    width_x = float(width_x)
    width_y = float(width_y)
    return height * np.exp(
        -(((center_x - mx) / width_x) ** 2 + ((center_y - my) / width_y) ** 2) / 2
    ) + constant


def rotate_point(x: float, y: float, angle: float) -> tuple[float, float]:
    theta = np.radians(angle)
    return (x * np.cos(theta) - y * np.sin(theta),
            x * np.sin(theta) + y * np.cos(theta))


def _disk_coords(center: tuple[float, float], radius: float, shape):
    """Pixel coordinates strictly inside the circle (skimage disk convention)."""
    cy, cx = center
    rmin = max(int(np.floor(cy - radius)) - 1, 0)
    rmax = min(int(np.ceil(cy + radius)) + 2, shape[0])
    cmin = max(int(np.floor(cx - radius)) - 1, 0)
    cmax = min(int(np.ceil(cx + radius)) + 2, shape[1])
    yy, xx = np.mgrid[rmin:rmax, cmin:cmax]
    mask = ((yy - cy) / radius) ** 2 + ((xx - cx) / radius) ** 2 < 1
    return yy[mask], xx[mask]


def _polygon_coords(row_coords, col_coords, shape):
    """Scanline polygon pixel coords (skimage polygon convention)."""
    rmin = max(int(np.floor(min(row_coords))), 0)
    rmax = min(int(np.ceil(max(row_coords))) + 1, shape[0])
    cmin = max(int(np.floor(min(col_coords))), 0)
    cmax = min(int(np.ceil(max(col_coords))) + 1, shape[1])
    yy, xx = np.mgrid[rmin:rmax, cmin:cmax]
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


def draw_rotated_rectangle(shape, center, extent, angle: float):
    """Pixel coords of a rectangle rotated about its centre."""
    x0 = center[1] - extent[1] / 2
    x1 = center[1] + extent[1] / 2
    y0 = center[0] - extent[0] / 2
    y1 = center[0] + extent[0] / 2
    rect = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    theta = np.radians(angle)
    c, s = np.cos(theta), np.sin(theta)
    rotation = np.array([[c, -s], [s, c]])
    center_xy = np.array([center[1], center[0]])
    rotated = (rect - center_xy) @ rotation + center_xy
    return _polygon_coords(rotated[:, 1], rotated[:, 0], shape)


class Layer(ABC):
    """A composable image layer."""

    @abstractmethod
    def apply(self, image: np.ndarray, pixel_size: float, mag_factor: float) -> np.ndarray:
        pass


class PerfectConeLayer(Layer):
    """A cone field without flattening-filter effects."""

    def __init__(self, cone_size_mm: float = 10, cax_offset_mm=(0, 0),
                 alpha: float = 1.0, rotation: float = 0):
        self.cone_size_mm = cone_size_mm
        self.cax_offset_mm = cax_offset_mm
        self.alpha = alpha
        self.rotation = rotation

    def apply(self, image, pixel_size, mag_factor):
        cone_size_pix = mag_factor * (self.cone_size_mm / 2) / pixel_size
        off_y, off_x = rotate_point(
            x=self.cax_offset_mm[0] * mag_factor / pixel_size,
            y=self.cax_offset_mm[1] * mag_factor / pixel_size,
            angle=self.rotation)
        center = (off_y + (image.shape[0] / 2 - 0.5),
                  off_x + (image.shape[1] / 2 - 0.5))
        rr, cc = _disk_coords(center, cone_size_pix, image.shape)
        temp = np.zeros(image.shape)
        temp[rr, cc] = int(np.iinfo(image.dtype).max * self.alpha)
        return clip_add(image, temp)


class PerfectFieldLayer(Layer):
    """A square field without flattening-filter effects."""

    def __init__(self, field_size_mm=(10, 10), cax_offset_mm=(0, 0),
                 alpha: float = 1.0, rotation: float = 0):
        self.field_size_mm = field_size_mm
        self.cax_offset_mm = cax_offset_mm
        self.alpha = alpha
        self.rotation = rotation

    def _create_perfect_field(self, image, pixel_size, mag_factor):
        field_size_pix = [even_round(f * mag_factor / pixel_size)
                          for f in self.field_size_mm]
        cax_offset_pix = [v * mag_factor / pixel_size for v in self.cax_offset_mm]
        field_center = [offset + (shape / 2) - 0.5
                        for offset, shape in zip(cax_offset_pix, image.shape)]
        rr, cc = draw_rotated_rectangle(image.shape, center=field_center,
                                        extent=field_size_pix, angle=self.rotation)
        temp = np.zeros(image.shape)
        temp[rr, cc] = int(np.iinfo(image.dtype).max * self.alpha)
        return clip_add(image, temp), rr, cc

    def apply(self, image, pixel_size, mag_factor):
        image, _, _ = self._create_perfect_field(image, pixel_size, mag_factor)
        return image


class FilteredFieldLayer(PerfectFieldLayer):
    """A square field with flattening-filter 'horn' effects."""

    def __init__(self, field_size_mm=(10, 10), cax_offset_mm=(0, 0),
                 alpha: float = 1.0, gaussian_height: float = 0.03,
                 gaussian_sigma_mm: float = 32, rotation: float = 0):
        super().__init__(field_size_mm=field_size_mm, cax_offset_mm=cax_offset_mm,
                         alpha=alpha, rotation=rotation)
        self.gaussian_height = gaussian_height
        self.gaussian_sigma_mm = gaussian_sigma_mm

    def apply(self, image, pixel_size, mag_factor):
        image, rr, cc = self._create_perfect_field(image, pixel_size, mag_factor)
        height = -self.gaussian_height * np.iinfo(image.dtype).max
        width = self.gaussian_sigma_mm / pixel_size
        center_x = geometric_center_idx(image[:, 0])
        center_y = geometric_center_idx(image[0, :])
        horns = gaussian2d(rr, cc, height=height, center_x=center_x,
                           center_y=center_y, width_x=width, width_y=width)
        image[rr, cc] += horns.astype(image.dtype)
        return image


class FilterFreeFieldLayer(FilteredFieldLayer):
    """A square field with FFF (central peak) effects."""

    def __init__(self, field_size_mm=(10, 10), cax_offset_mm=(0, 0),
                 alpha: float = 1.0, gaussian_height: float = 0.4,
                 gaussian_sigma_mm: float = 80, rotation: float = 0):
        super().__init__(field_size_mm, cax_offset_mm, alpha, gaussian_height,
                         gaussian_sigma_mm, rotation=rotation)

    def apply(self, image, pixel_size, mag_factor):
        image, rr, cc = self._create_perfect_field(image, pixel_size, mag_factor)
        center_x = geometric_center_idx(image[:, 0])
        center_y = geometric_center_idx(image[0, :])
        n = gaussian2d(rr, cc, self.gaussian_height * np.iinfo(image.dtype).max,
                       center_x, center_y, self.gaussian_sigma_mm / pixel_size,
                       self.gaussian_sigma_mm / pixel_size,
                       constant=-self.gaussian_height * np.iinfo(image.dtype).max)
        image[rr, cc] += n.astype(image.dtype)
        return image


class PerfectBBLayer(PerfectConeLayer):
    """A BB: an attenuating (negative-alpha) disk."""

    def __init__(self, bb_size_mm: float = 5, cax_offset_mm=(0, 0),
                 alpha: float = -0.5, rotation: float = 0):
        super().__init__(cone_size_mm=bb_size_mm, cax_offset_mm=cax_offset_mm,
                         alpha=alpha, rotation=rotation)


class GaussianFilterLayer(Layer):
    """Gaussian blur simulating scatter."""

    def __init__(self, sigma_mm: float = 2):
        self.sigma_mm = sigma_mm

    def apply(self, image, pixel_size, mag_factor):
        sigma_pix = self.sigma_mm / pixel_size
        out = ndimage.gaussian_filter(np.asarray(image, np.float32), sigma_pix)
        return out.astype(image.dtype)


class RandomNoiseLayer(Layer):
    """Gaussian (dark-current-like) noise, from ``seed`` when one is given."""

    def __init__(self, mean: float = 0.0, sigma: float = 0.001, seed: int | None = None):
        self.mean = mean
        self.sigma = sigma
        self.seed = seed

    def apply(self, image, pixel_size, mag_factor):
        normalized_sigma = self.sigma * np.iinfo(image.dtype).max
        rng = np.random.default_rng(self.seed)
        noise = rng.normal(self.mean, normalized_sigma, size=image.shape)
        return clip_add(image, noise, dtype=image.dtype)


class SlopeLayer(Layer):
    """Multiplicative X/Y slope (simulates asymmetry)."""

    def __init__(self, slope_x: float, slope_y: float):
        self.slope_x = slope_x
        self.slope_y = slope_y

    def apply(self, image, pixel_size, mag_factor):
        nrows, ncols = image.shape
        y_scaling = (1 + self.slope_y * np.arange(nrows) / nrows).reshape(-1, 1)
        x_scaling = (1 + self.slope_x * np.arange(ncols) / ncols).reshape(1, -1)
        return clip_multiply(clip_multiply(image, y_scaling), x_scaling)
