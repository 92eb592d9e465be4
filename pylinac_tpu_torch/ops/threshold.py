"""Otsu's threshold, batched.

Port of ``otsu_threshold`` (``pylinac_tpu/ops/threshold.py:13-67``) with
its host branch: the histogram is a ``scatter_add_`` of float32 weights,
where the JAX TPU branch used a one-hot matmul. Weights are 0 or 1, so the
counts are exact in any order of adds.
"""

from __future__ import annotations

import torch


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

    w1 = torch.cumsum(hist, dim=1)
    w2 = w1[:, -1:] - w1
    mu_cum = torch.cumsum(hist * bin_centers, dim=1)
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
