"""Image filters with scipy.ndimage semantics (mode "reflect").

Port of ``pylinac_tpu/ops/filters.py``: the median filters
(``median_filter`` ``:105``, ``_median_general`` ``:122``, ``_reflect_pad``
``:24``, ``_window_stack`` ``:82``), the Gaussian (``gaussian_kernel1d``
``:43``, ``correlate1d`` ``:51``, ``gaussian_filter1d`` ``:67``,
``gaussian_filter`` ``:74``), the Sobel derivative (``sobel`` ``:156``)
and the Scharr edge filter (``scharr_component`` ``:165``, ``scharr``
``:172``). Median size 3 goes to
the hand-written kernel (:func:`pylinac_tpu_torch.ops.median.median3x3`);
any other size to the stack-and-sort form, as in the JAX package, where
only size 3 had a Pallas kernel.

The correlations are written as JAX writes them, a reflect pad and then a
sum of weighted shifted slices in the same order, with no convolution (so
no TF32 on the card). Each multiply and add rounds to float32 on its own,
on the CPU and on the card alike, so the port's two devices agree bit for
bit. Jitted JAX differs in the last bit at some pixels: XLA fuses the sum
and contracts some steps into fused multiply-adds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .median import median3x3


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of a length-``n`` axis padded by ``pad`` on each side in scipy
    "reflect" mode (d c b a | a b c d | d c b a), for any ``pad``."""
    idx = np.mod(np.arange(-pad, n + pad), 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def _window_stack(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """``size`` shifted copies of ``x`` along ``dim``, stacked on a new
    leading dim (reflect-padded)."""
    n = x.shape[dim]
    index = torch.as_tensor(_reflect_index(n, size - 1), device=x.device)
    xp = x.index_select(dim, index)
    start = (size - 1) - size // 2
    return torch.stack([xp.narrow(dim, start + i, n) for i in range(size)])


def _median_general(x: torch.Tensor, size: int) -> torch.Tensor:
    """N-D median over a ``size``-wide square footprint on every dim of
    ``x``: rank ``size**ndim // 2`` of the sorted window, as
    ``scipy.ndimage.median_filter``."""
    windows = x[None]
    for dim in range(x.dim()):
        windows = torch.cat([_window_stack(w, size, dim) for w in windows])
    return windows.sort(dim=0).values[windows.shape[0] // 2].to(x.dtype)


def median_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Median filter with a square footprint (scipy.ndimage.median_filter).

    Size 3 runs :func:`median3x3`, which takes (H, W) or (B, H, W) float32
    and filters the last two dims; other sizes filter every dim of ``x``."""
    if size <= 1:
        return x
    if size == 3:
        return median3x3(x)
    return _median_general(x, size)


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The 1D Gaussian kernel scipy.ndimage uses (order 0), float32."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def correlate1d(x: torch.Tensor, kernel: np.ndarray, dim: int = -1) -> torch.Tensor:
    """Correlate along one dim with "reflect" edges (scipy semantics), in
    float32: the running sum plus ``w * slice`` for each tap in order."""
    k = np.asarray(kernel, dtype=np.float32)
    pad = (len(k) - 1) // 2
    dim = dim % x.dim()
    n = x.shape[dim]
    index = torch.as_tensor(_reflect_index(n, pad), device=x.device)
    xp = x.to(torch.float32).index_select(dim, index)
    out = torch.zeros_like(xp.narrow(dim, 0, n))
    for i, w in enumerate(k):
        out = out + float(w) * xp.narrow(dim, i, n)
    return out


def gaussian_filter1d(x: torch.Tensor, sigma: float, dim: int = -1,
                      truncate: float = 4.0) -> torch.Tensor:
    if sigma <= 0:
        return x.to(torch.float32)
    return correlate1d(x, gaussian_kernel1d(sigma, truncate), dim=dim)


def gaussian_filter(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                    dims: tuple[int, ...] | None = None) -> torch.Tensor:
    """Separable Gaussian over ``dims`` (every dim when None, as
    scipy.ndimage.gaussian_filter); a batch of images passes ``(-2, -1)``."""
    out = x.to(torch.float32)
    for d in range(x.dim()) if dims is None else dims:
        out = gaussian_filter1d(out, sigma, dim=d, truncate=truncate)
    return out


_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_SCHARR_D = np.array([1.0, 0.0, -1.0], dtype=np.float32)
_SCHARR_S = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 16.0


def sobel(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """scipy.ndimage.sobel along one dim: the derivative along ``dim``,
    smoothing along every other dim of ``x``. Its taps are small integers, so
    every product is exact and a NaN spreads to its neighbours, as in JAX."""
    out = x.to(torch.float32)
    dim = dim % x.dim()
    for d in range(x.dim()):
        out = correlate1d(out, _SOBEL_D if d == dim else _SOBEL_S, dim=d)
    return out


def scharr_component(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Scharr derivative along ``dim`` of the image in the last two dims of
    ``x``, smoothed along the other one."""
    out = x.to(torch.float32)
    dim = dim % x.dim()
    for d in (x.dim() - 2, x.dim() - 1):
        out = correlate1d(out, _SCHARR_D / 2.0 if d == dim else _SCHARR_S, dim=d)
    return out


def scharr(x: torch.Tensor) -> torch.Tensor:
    """Scharr gradient magnitude (skimage.filters.scharr-like) of an (H, W)
    image or of each image of a (B, H, W) batch."""
    h = scharr_component(x, -2)
    v = scharr_component(x, -1)
    return torch.sqrt(h * h + v * v) / math.sqrt(2.0)
