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

The correlations are written as JAX writes them, a pad and then a sum of
weighted shifted slices in the same order, with no convolution (so no
TF32 on the card). Their sums are those a jitted JAX graph gives on the
CPU. Inside a loop fusion, XLA's CPU backend (LLVM) contracts each
``add`` that has a ``multiply`` operand of one use into a fused
multiply-add; where both operands are products it takes the first, after
its reassociation pass has put the deeper operand first. So a tap chain
``w0*s0 + w1*s1 + ... + wn*sn`` becomes ``fma(sn, wn, ... fma(s2, w2,
fma(s0, w0, w1*s1)))``, and Scharr's ``h*h + v*v`` becomes ``fma(h, h,
v*v)``; ``/ sqrt(2)`` is a multiply by the float32 reciprocal.
:func:`gaussian_filter`, :func:`scharr_component` and :func:`scharr` always
take this form: it reproduces JAX's jitted ``gaussian_filter`` (1D and 2D)
and every vmapped JAX graph of the CT mask stage bit for bit (its edges,
and the Otsu thresholds of :mod:`.threshold`). An unvmapped 2D ``scharr``
computes the reflect-padded border columns of its second pass in fusions
of their own, where LLVM shares the product of a symmetric tap between
neighbouring rows and does not contract it; there the port differs in
the last bit at some border pixels. :func:`correlate1d` and
:func:`gaussian_filter1d` round each multiply and add on its own unless
the caller passes ``fused=True``: which adds a graph contracts depends on
its fusion boundaries, so a 1D pass inside a larger JAX graph is the
caller's to match. An FMA is taken as :func:`.stats.fma_f32` takes it, a
float64 product plus the addend rounded once, the same on the CPU and on
the card; square roots are :func:`.stats.sqrt_f32`'s correctly rounded
ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .median import median3x3
from .stats import fma_f32, sqrt_f32


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


def _padded(x: torch.Tensor, pad: int, dim: int, mode: str) -> torch.Tensor:
    """``x`` in float32 padded by ``pad`` on each side of ``dim``: scipy
    "reflect", or zeros for "constant" (``jnp.pad``)."""
    n = x.shape[dim]
    x = x.to(torch.float32)
    if mode == "reflect":
        return x.index_select(dim, torch.as_tensor(_reflect_index(n, pad), device=x.device))
    shape = list(x.shape)
    shape[dim] = pad
    zeros = x.new_zeros(shape)
    return torch.cat([zeros, x, zeros], dim=dim)


def correlate1d(x: torch.Tensor, kernel: np.ndarray, dim: int = -1,
                fused: bool = False, mode: str = "reflect") -> torch.Tensor:
    """Correlate along one dim with "reflect" (scipy semantics) or zero
    ("constant") edges, in float32: the running sum plus ``w * slice`` for
    each tap in order, each op rounded, or with ``fused`` in XLA's
    contracted form (module docstring)."""
    k = np.asarray(kernel, dtype=np.float32)
    pad = (len(k) - 1) // 2
    dim = dim % x.dim()
    n = x.shape[dim]
    xp = _padded(x, pad, dim, mode)
    if fused and len(k) > 1:
        out = fma_f32(xp.narrow(dim, 0, n), float(k[0]), xp.narrow(dim, 1, n) * float(k[1]))
        for i in range(2, len(k)):
            out = fma_f32(xp.narrow(dim, i, n), float(k[i]), out)
        return out
    out = torch.zeros_like(xp.narrow(dim, 0, n))
    for i, w in enumerate(k):
        out = out + float(w) * xp.narrow(dim, i, n)
    return out


def gaussian_filter1d(x: torch.Tensor, sigma: float, dim: int = -1,
                      truncate: float = 4.0, fused: bool = False) -> torch.Tensor:
    if sigma <= 0:
        return x.to(torch.float32)
    return correlate1d(x, gaussian_kernel1d(sigma, truncate), dim=dim, fused=fused)


def gaussian_filter(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                    dims: tuple[int, ...] | None = None) -> torch.Tensor:
    """Separable Gaussian over ``dims`` (every dim when None, as
    scipy.ndimage.gaussian_filter); a batch of images passes ``(-2, -1)``.
    The sums are XLA's contracted ones (module docstring)."""
    out = x.to(torch.float32)
    for d in range(x.dim()) if dims is None else dims:
        out = gaussian_filter1d(out, sigma, dim=d, truncate=truncate, fused=True)
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
    ``x``, smoothed along the other one, in XLA's contracted sums."""
    out = x.to(torch.float32)
    dim = dim % x.dim()
    for d in (x.dim() - 2, x.dim() - 1):
        out = correlate1d(out, _SCHARR_D / 2.0 if d == dim else _SCHARR_S, dim=d,
                          fused=True)
    return out


# XLA folds ``/ sqrt(2)`` into a multiply by the float32 reciprocal
_INV_SQRT2 = float(np.float32(1.0) / np.float32(math.sqrt(2.0)))


def scharr(x: torch.Tensor) -> torch.Tensor:
    """Scharr gradient magnitude (skimage.filters.scharr-like) of an (H, W)
    image or of each image of a (B, H, W) batch, as a jitted JAX graph
    gives it (module docstring)."""
    h = scharr_component(x, -2)
    v = scharr_component(x, -1)
    return sqrt_f32(fma_f32(h, h, v * v)) * _INV_SQRT2


# the NEMA/IAEA 3 x 3 smoothing kernel (IAEA pub 1394 p 59), row-major
_NEMA_TAPS = (1 / 16, 2 / 16, 1 / 16, 2 / 16, 4 / 16, 2 / 16, 1 / 16, 2 / 16, 1 / 16)


def smooth3x3(x: torch.Tensor) -> torch.Tensor:
    """2D float32 correlation of an (H, W) image with the NEMA 3 x 3
    smoothing kernel ``[[1, 2, 1], [2, 4, 2], [1, 2, 1]] / 16`` and zero
    edges, the sum of ``jax.lax.conv_general_dilated(..., padding="SAME")``
    on the CPU.

    XLA's CPU convolution adds the nine products, taps ``t0 .. t8`` in
    row-major order over the kernel, as ``(((t0 + t1) + (t4 + t5)) +
    ((t2 + t3) + (t6 + t7))) + t8``: an eight-wide product whose lanes are
    paired and reduced, then the ninth tap. Cancellation probes of the JAX
    graph showed this tree at every position of the frame, and it gives
    JAX's frames bit for bit from 3 x 3 pixels up (frames of at most eight
    pixels, such as 2 x 3, take another order there). Each product is
    rounded on its own, so this holds because the kernel's products are
    exact (its taps are powers of two), whether or not XLA fuses them into
    its adds; the kernel is fixed for that reason. Elementwise float32 ops,
    so the same on the CPU and on the card, with no cuDNN and no TF32."""
    h, w = x.shape
    p = torch.nn.functional.pad(x.to(torch.float32)[None, None], (1, 1, 1, 1))[0, 0]
    t = [_NEMA_TAPS[3 * dy + dx] * p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return (((t[0] + t[1]) + (t[4] + t[5])) + ((t[2] + t[3]) + (t[6] + t[7]))) + t[8]
