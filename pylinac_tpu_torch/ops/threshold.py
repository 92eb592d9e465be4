"""Otsu's threshold, batched, and Li's and Yen's thresholds on the host.

Port of ``otsu_threshold`` (``pylinac_tpu/ops/threshold.py:13-67``) with
its host branch: the histogram is a ``scatter_add_`` of float32 weights,
where the JAX TPU branch used a one-hot matmul. Weights are 0 or 1, so the
counts are exact in any order of adds. The class means' running sums are
not: XLA's CPU ``jnp.cumsum`` is a blocked reduce-window, which
:func:`cumsum_f32` adds in the same order, in float32, on either device
(torch's CPU ``cumsum`` accumulates in float64, its CUDA one in another
order); where the class variance is flat, its argmax then picks JAX's
bin. ``threshold_li`` (``:75``) and ``threshold_yen`` (``:104``) are host
numpy in both packages, copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch


_SCAN_BLOCK = 16


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 running sum along the last dim in the order of
    XLA's CPU ``jnp.cumsum``: a reduce-window rewritten in blocks of 16,
    each block summed in order, the block totals scanned the same way, and
    each output its block's offset plus its in-block sum."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros(x.shape[:-1] + (nb * _SCAN_BLOCK - n,))
    blocks = cumsum_f32(torch.cat([x, pad], dim=-1).reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    totals = cumsum_f32(blocks[..., -1])
    offsets = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    return (offsets[..., None] + blocks).reshape(*x.shape[:-1], -1)[..., :n]


def otsu_threshold_batch(images: torch.Tensor, nbins: int = 256,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu's threshold of each item of a (B, ...) batch, as float32 (B,):
    skimage.filters.threshold_otsu semantics, a histogram over [min, max]
    in ``nbins`` bins, returning the bin centre.

    ``mask`` (one item's shape, or the batch's) restricts each histogram to
    the selected pixels, as ``otsu_threshold(image[mask])`` would."""
    b = images.shape[0]
    flat = images.reshape(b, -1).to(torch.float32)
    if mask is not None:
        m = mask.expand_as(images).reshape(b, -1)
        vmin = torch.where(m, flat, float("inf")).amin(dim=1, keepdim=True)
        vmax = torch.where(m, flat, float("-inf")).amax(dim=1, keepdim=True)
        weights = m.to(torch.float32)
    else:
        vmin = flat.amin(dim=1, keepdim=True)
        vmax = flat.amax(dim=1, keepdim=True)
        weights = torch.ones_like(flat)
    span = (vmax - vmin).clamp(min=1e-20)
    idx = ((flat - vmin) / span * nbins).to(torch.int32).clamp(0, nbins - 1)
    hist = torch.zeros(b, nbins, dtype=torch.float32, device=flat.device)
    hist.scatter_add_(1, idx.to(torch.int64), weights)
    bins = torch.arange(nbins, dtype=torch.float32, device=flat.device)
    bin_centers = vmin + (bins + 0.5) * span / nbins

    w1 = cumsum_f32(hist)
    w2 = w1[:, -1:] - w1
    mu_cum = cumsum_f32(hist * bin_centers)
    mu1 = mu_cum / w1.clamp(min=1e-20)
    mu2 = (mu_cum[:, -1:] - mu_cum) / w2.clamp(min=1e-20)
    between = w1 * w2 * (mu1 - mu2) ** 2
    # a split with an empty side is invalid
    between = torch.where((w1 > 0) & (w2 > 0), between, float("-inf"))
    return bin_centers.gather(1, between.argmax(dim=1, keepdim=True))[:, 0]


def otsu_threshold(image: torch.Tensor, nbins: int = 256,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu's threshold of one image, as a float32 scalar tensor (see
    :func:`otsu_threshold_batch`)."""
    return otsu_threshold_batch(image[None], nbins,
                                None if mask is None else mask[None])[0]


def threshold_li(image, tolerance: float | None = None) -> float:
    """Li's iterative minimum cross-entropy threshold
    (skimage.filters.threshold_li semantics), on the host."""
    arr = np.asarray(image, dtype=float).ravel()
    arr = arr[np.isfinite(arr)]
    offset = arr.min()
    arr = arr - offset  # means must be positive for the log
    eps = arr[arr > 0].min() / 2 if np.any(arr > 0) else 1e-6
    arr = arr + eps
    tolerance = tolerance or np.ptp(arr) / 2 ** 10
    t_next = arr.mean()
    t_curr = -2 * tolerance
    while abs(t_next - t_curr) > tolerance:
        t_curr = t_next
        fore = arr > t_curr
        if not np.any(fore) or np.all(fore):
            break
        mean_fore = arr[fore].mean()
        mean_back = arr[~fore].mean()
        t_next = ((mean_back - mean_fore)
                  / (np.log(mean_back) - np.log(mean_fore)))
    return float(t_next - eps + offset)


def threshold_yen(image, nbins: int = 256) -> float:
    """Yen's maximum-correlation threshold (skimage.filters.threshold_yen
    semantics), on the host."""
    arr = np.asarray(image, dtype=float).ravel()
    arr = arr[np.isfinite(arr)]
    counts, bin_edges = np.histogram(arr, bins=nbins)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    pmf = counts.astype(float) / max(counts.sum(), 1)
    p1 = np.cumsum(pmf)
    p1_sq = np.cumsum(pmf**2)
    p2_sq = np.cumsum(pmf[::-1] ** 2)[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        crit = np.log(((p1_sq[:-1] * p2_sq[1:]) ** -1)
                      * (p1[:-1] * (1.0 - p1[:-1])) ** 2)
    crit = np.where(np.isfinite(crit), crit, -np.inf)
    return float(bin_centers[:-1][np.argmax(crit)])
