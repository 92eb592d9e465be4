"""Frangi vesselness (skimage.filters.frangi equivalent).

Port of ``pylinac_tpu/ops/vesselness.py``: ``frangi`` ``:42`` with the
Gaussian-derivative Hessian (``_gaussian_derivative_kernels`` ``:20``,
``_hessian`` ``:30``). JAX runs ``frangi`` as one jitted graph; the
correlations take that graph's contracted form
(``correlate1d(fused=True)``), the eigenvalue sums ``a*a + b*b`` one fused
multiply-add each, the roots :func:`.stats.sqrt_f32`'s.

XLA's float32 ``exp`` on the CPU is its own polynomial; torch's differs
from it in some ulps, on the CPU and on the card alike. Here ``exp`` is
taken in float64 and rounded once, one form on both devices, so the card
and the CPU agree bit for bit; against JAX a vesselness value may differ
in its last bits (the fibre masks' differences are stated in the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import correlate1d
from .stats import fma_f32, sqrt_f32


def _gaussian_derivative_kernels(sigma: float, truncate: float = 4.0):
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    d1 = -x / sigma ** 2 * g
    d2 = (x ** 2 - sigma ** 2) / sigma ** 4 * g
    return g.astype(np.float32), d1.astype(np.float32), d2.astype(np.float32)


def _hessian(image: torch.Tensor, sigma: float):
    """(Hrr, Hrc, Hcc) scaled by sigma**2 (gamma-normalised, as skimage)."""
    g, d1, d2 = _gaussian_derivative_kernels(sigma)

    def corr(x, k, dim):
        return correlate1d(x, k, dim=dim, fused=True)

    s2 = float(np.float32(sigma ** 2))
    hrr = corr(corr(image, d2, 0), g, 1)
    hcc = corr(corr(image, g, 0), d2, 1)
    hrc = corr(corr(image, d1, 0), d1, 1)
    return hrr * s2, hrc * s2, hcc * s2


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def frangi(image: torch.Tensor, sigmas: tuple[float, ...], black_ridges: bool = False,
           beta: float = 0.5, gamma: float | None = None) -> torch.Tensor:
    """Vesselness of an (H, W) image on its own device: the max over scales
    of exp(-Rb**2 / 2b**2) * (1 - exp(-S**2 / 2g**2)) where the larger
    eigenvalue is negative. ``gamma=None`` takes half the scale's largest
    structureness, as skimage."""
    image = image.to(torch.float32)
    if black_ridges:
        image = -image
    out = torch.zeros_like(image)
    for sigma in sigmas:
        hrr, hrc, hcc = _hessian(image, float(sigma))
        tr_half = (hrr + hcc) / 2
        half_diff = (hrr - hcc) / 2
        disc = sqrt_f32(torch.clamp(fma_f32(half_diff, half_diff, hrc * hrc), min=0.0))
        e1 = tr_half + disc
        e2 = tr_half - disc
        # order by magnitude: lam1 the smaller
        swap = e1.abs() > e2.abs()
        lam1 = torch.where(swap, e2, e1)
        lam2 = torch.where(swap, e1, e2)
        lam2_safe = torch.where(lam2 == 0, torch.full_like(lam2, float(np.float32(1e-10))), lam2)
        rb2 = (lam1 / lam2_safe) ** 2
        s2 = fma_f32(lam1, lam1, lam2 * lam2)
        if gamma is None:
            g2 = torch.clamp(s2.max() / 4, min=float(np.float32(1e-10)))
        else:
            g2 = torch.tensor(float(np.float32(gamma ** 2)), device=image.device)
        # XLA folds the division by 2 * beta**2 into a multiply where it is
        # a power of two, as for the default beta
        v = _exp_f32(-rb2 / float(np.float32(2 * beta ** 2))) * (1 - _exp_f32(-s2 / (2 * g2)))
        v = torch.where(lam2 < 0, v, torch.zeros_like(v))
        out = torch.maximum(out, v)
    return out
