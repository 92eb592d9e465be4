"""Exact order statistics and percentiles, batched over a leading dim.

Port of ``pylinac_tpu/ops/stats.py:101-160`` (``order_statistics`` ``:114``,
``percentile_exact`` ``:144``). The JAX package searched float32 bit space
to avoid a TPU sort; on the card a per-image sort is the plain form. Both
give the exact k-th smallest values. ``torch.quantile`` is not used: it
refuses inputs of more than 2**24 elements, and ``percentile_exact`` mixes
its two order statistics in float32, as the JAX function does (``:158``).
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
