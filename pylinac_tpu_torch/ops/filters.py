"""Median filtering with scipy.ndimage semantics (mode "reflect").

Port of the median part of ``pylinac_tpu/ops/filters.py`` (``median_filter``
``:105``, ``_median_general`` ``:122``, ``_reflect_pad`` ``:24``,
``_window_stack`` ``:82``). Size 3 goes to the hand-written kernel
(:func:`pylinac_tpu_torch.ops.median.median3x3`); any other size to the
stack-and-sort form, as in the JAX package, where only size 3 had a Pallas
kernel.
"""

from __future__ import annotations

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
