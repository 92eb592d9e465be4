"""Exact order statistics and percentiles, batched over a leading dim; the
noise power spectrum.

Port of ``pylinac_tpu/ops/stats.py:101-160`` (``order_statistics`` ``:114``,
``percentile_exact`` ``:144``). The JAX package searched float32 bit space
to avoid a TPU sort; on the card a per-image sort is the plain form. Both
give the exact k-th smallest values. ``torch.quantile`` is not used: it
refuses inputs of more than 2**24 elements, and ``percentile_exact`` mixes
its two order statistics in float32, as the JAX function does (``:158``).

The NPS chain (``noise_power_spectrum_2d`` ``:50``, ``radial_average``
``:61``, ``average_power`` ``:79``, ``max_frequency`` ``:85``,
``nps_bundle`` ``:90``) goes through ``torch.fft.fft2``; its float32 FFT
differs from XLA's in the last bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def order_statistics(values: torch.Tensor, ranks: Sequence[int]) -> torch.Tensor:
    """The exact k-th smallest elements (0-based ``ranks``) of each item of a
    (B, ...) batch, as float32 of shape (B, len(ranks))."""
    flat = values.reshape(values.shape[0], -1).to(torch.float32)
    index = torch.as_tensor(list(ranks), dtype=torch.long, device=values.device)
    return flat.sort(dim=1).values.index_select(1, index)


def percentile_exact(values: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``np.percentile(item, qs)`` (linear interpolation) for each item of a
    (B, ...) batch, as float32 of shape (B, len(qs))."""
    n = int(np.prod(values.shape[1:]))
    ranks, mix = [], []
    for q in qs:
        r = q / 100.0 * (n - 1)
        f = int(np.floor(r))
        ranks.extend((f, min(f + 1, n - 1)))
        mix.append(r - f)
    stats = order_statistics(values, ranks)
    lo, hi = stats[:, 0::2], stats[:, 1::2]
    w = torch.tensor(mix, dtype=torch.float32, device=values.device)
    return lo + w * (hi - lo)


def noise_power_spectrum_2d(rois: torch.Tensor, pixel_size: float) -> torch.Tensor:
    """2D NPS from a stack of square ROIs (N, L, L), ICRU 87 eq 11.1/11.2."""
    rois = rois.to(torch.float32)
    length = rois.shape[-1]
    demeaned = rois - rois.mean(dim=(-2, -1), keepdim=True)
    ffts = torch.fft.fft2(demeaned).abs() ** 2
    shifted = torch.fft.fftshift(ffts, dim=(-2, -1))
    return pixel_size ** 2 / length ** 2 * shifted.mean(dim=0)


def radial_average(arr: torch.Tensor) -> torch.Tensor:
    """Radial average of an (H, W) array about its centre pixel, in unit
    integer-radius bins."""
    h, w = arr.shape
    cy, cx = float(np.floor(h / 2.0)), float(np.floor(w / 2.0))
    y = torch.arange(h, dtype=torch.float32, device=arr.device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=arr.device)[None, :]
    r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2).to(torch.int64).reshape(-1)
    nbins = int(np.ceil(np.sqrt(h * h + w * w))) + 1
    tbin = torch.zeros(nbins, dtype=torch.float32, device=arr.device)
    tbin.scatter_add_(0, r, arr.reshape(-1).to(torch.float32))
    nr = torch.zeros(nbins, dtype=torch.float32, device=arr.device)
    nr.scatter_add_(0, r, torch.ones_like(r, dtype=torch.float32))
    return torch.where(nr > 0, tbin / nr.clamp(min=1), 0.0)


def average_power(nps1d: torch.Tensor) -> torch.Tensor:
    x = torch.linspace(0.0, 1.0, nps1d.shape[0], device=nps1d.device)
    return (x * nps1d).sum() / nps1d.sum()


def max_frequency(nps1d: torch.Tensor) -> torch.Tensor:
    return nps1d.argmax() / nps1d.shape[0]


def nps_bundle(rois: torch.Tensor, pixel_size: float):
    """(ps2d, ps1d, avg_power, max_freq) of a stack of square ROIs; the
    CTP486 uniformity module reads all four."""
    ps2d = noise_power_spectrum_2d(rois, pixel_size)
    ps1d = radial_average(ps2d)
    return ps2d, ps1d, average_power(ps1d), max_frequency(ps1d)
