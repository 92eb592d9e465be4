"""Canny edge detection (skimage.feature.canny semantics).

Port of ``pylinac_tpu/ops/edges.py``: ``canny`` ``:69`` with the
constant-mode normalised Gaussian ``_smooth`` ``:47`` (through
``_constant_correlate1d`` ``:29``), the roll-difference Sobel ``_sobel``
``:56``, ``jnp.hypot``'s lax form, the interpolating non-maximum
suppression, quantile thresholds and hysteresis.

JAX runs ``canny`` as one jitted graph. The sums follow that graph's
contractions on the CPU (``ops/filters`` docstring): each Gaussian tap
chain as ``correlate1d(fused=True)``; ``hypot``'s ``1 + r*r`` as one fused
multiply-add and its root correctly rounded (:func:`.stats.sqrt_f32`);
each interpolation ``c1 * (1 - w) + c2 * w`` as ``fma(c2, w, c1*(1 - w))``
(LLVM orders an add's operands by depth before it contracts the first);
the quantiles' ``lo * lw + hi * hw`` as ``fma(lo, lw, hi*hw)``
(``percentile_f32(fused=True)``). The same
form runs on the CPU and on the card, so both give JAX's edge mask.

The hysteresis labels the weak edges 8-connected through
:func:`.ccl.label_batch` at B = 1 (``csrc/ccl.cu`` on the card), then keeps
each weak component that holds a strong pixel: a ``scatter_reduce_``
``amax`` over the H*W + 1 root slots, as JAX's ``.at[].max``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ccl import label_batch
from .filters import correlate1d, gaussian_kernel1d
from .stats import fma_f32, percentile_f32, sqrt_f32

_EPS = float(np.float32(1e-12))


def _smooth(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Masked Gaussian: blur(image) / blur(ones), zero ("constant") edges."""
    k = gaussian_kernel1d(sigma)

    def blur(x):
        x = correlate1d(x, k, dim=0, fused=True, mode="constant")
        return correlate1d(x, k, dim=1, fused=True, mode="constant")

    return blur(image) / blur(torch.ones_like(image))


def _sobel(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Roll differences along ``axis``, then [1, 2, 1] along the other; the
    products by 2 are exact, so no contraction changes a sum."""
    d = torch.roll(x, -1, axis) - torch.roll(x, 1, axis)
    other = 1 - axis
    return (torch.roll(d, 1, other) + 2 * d) + torch.roll(d, -1, other)


def hypot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` as XLA's CPU fusion computes it: ``hi * sqrt(1 +
    (lo/hi)**2)`` with ``1 + r*r`` one fused multiply-add."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * sqrt_f32(fma_f32(r, r, 1.0)))
    inf = torch.isposinf(a) | torch.isposinf(b)
    return torch.where(inf, torch.full_like(out, float("inf")), out)


def canny(image: torch.Tensor, sigma: float = 1.0, low_threshold: float = 0.1,
          high_threshold: float = 0.2, use_quantiles: bool = False) -> torch.Tensor:
    """Boolean (H, W) edge map of an (H, W) image on its own device."""
    image = image.to(torch.float32)
    h, w = image.shape
    dev = image.device
    smoothed = _smooth(image, float(sigma))
    isobel = _sobel(smoothed, 0)
    jsobel = _sobel(smoothed, 1)
    magnitude = hypot_f32(isobel, jsobel)

    abs_i, abs_j = isobel.abs(), jsobel.abs()
    same_sign = (isobel * jsobel) >= 0

    def nbr(dr, dc):
        return torch.roll(magnitude, (-dr, -dc), (0, 1))

    def lerp(c1, c2, wt):
        # LLVM puts the deeper product (c2 is a select) first, and the
        # first product of an add is the one contracted
        return fma_f32(c2, wt, c1 * (1 - wt))

    w_h = abs_i / torch.clamp(abs_j, min=_EPS)
    c2_plus = torch.where(same_sign, nbr(1, 1), nbr(-1, 1))
    c2_minus = torch.where(same_sign, nbr(-1, -1), nbr(1, -1))
    horiz_max = ((magnitude >= lerp(nbr(0, 1), c2_plus, w_h))
                 & (magnitude >= lerp(nbr(0, -1), c2_minus, w_h)))
    w_v = abs_j / torch.clamp(abs_i, min=_EPS)
    d2_plus = torch.where(same_sign, nbr(1, 1), nbr(1, -1))
    d2_minus = torch.where(same_sign, nbr(-1, -1), nbr(-1, 1))
    vert_max = ((magnitude >= lerp(nbr(1, 0), d2_plus, w_v))
                & (magnitude >= lerp(nbr(-1, 0), d2_minus, w_v)))
    local_maxima = torch.where(abs_j >= abs_i, horiz_max, vert_max) & (magnitude > 0)
    # the 1-px border is out (skimage's eroded mask)
    interior = torch.zeros((h, w), dtype=torch.bool, device=dev)
    interior[1:h - 1, 1:w - 1] = True
    local_maxima = local_maxima & interior

    if use_quantiles:
        low, high = percentile_f32(magnitude[None], [low_threshold * 100, high_threshold * 100],
                                   fused=True)[0]
    else:
        low = torch.tensor(low_threshold, dtype=torch.float32, device=dev)
        high = torch.tensor(high_threshold, dtype=torch.float32, device=dev)
    weak = local_maxima & (magnitude >= low)
    strong = local_maxima & (magnitude >= high)

    # hysteresis: a weak component survives iff it holds a strong pixel
    labels = label_batch(weak[None].contiguous(), 2)[0].reshape(-1).to(torch.int64)
    slots = torch.where(labels < 0, h * w, labels)
    has_strong = torch.zeros(h * w + 1, dtype=torch.uint8, device=dev)
    has_strong.scatter_reduce_(0, slots, strong.reshape(-1).to(torch.uint8), reduce="amax")
    return weak & (has_strong[slots].reshape(h, w) > 0)
