"""Fluence maps from machine-log apertures.

Port of ``pylinac_tpu/ops/fluence.py`` (``interval_fluence`` ``:25-61``):
each (leaf pair, snapshot) aperture adds its snapshot's MU over the bins
``[left, right)`` of its pair's row; a scatter of +MU at the left edges and
-MU at the right edges into a (P, width + 1) difference array, then a
running sum along the row.

The order of the float32 adds is XLA's on the CPU, on both devices. XLA's
CPU scatter applies the updates one after another in operand order: in a
bin, the left edges of its pair in snapshot order, then the right edges.
Here the updates are sorted stably by (pair, bin), which keeps that order
within a bin, and each bin's run is summed from 0 one update after another
by ``torch.segment_reduce`` (a sequential loop per segment on both
devices), so no two runs touch one bin and no atomics take part: repeated
runs on the card give the same bits. The running sum is
:func:`.threshold.cumsum_f32`'s, the blocked order of XLA's ``jnp.cumsum``.
"""

from __future__ import annotations

import torch

from .threshold import cumsum_f32


def interval_fluence(left_edges: torch.Tensor, right_edges: torch.Tensor,
                     mu_diff: torch.Tensor, pair_blocked: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Accumulate MU over per-snapshot apertures, on the tensors' device.

    ``left_edges`` and ``right_edges`` are (P, S) integer bins (the
    interval is ``[left, right)``), jaw-clamped and within ``[0, width]``;
    ``mu_diff`` the (S,) MU of each snapshot; ``pair_blocked`` the (P,)
    pairs hidden under the Y jaws, which add nothing. Returns the
    (P, width) float32 map."""
    P, S = left_edges.shape
    device = left_edges.device
    mu = mu_diff.to(torch.float32)[None, :].expand(P, S)
    valid = (right_edges > left_edges) & ~pair_blocked.to(torch.bool)[:, None]
    mu = torch.where(valid, mu, torch.zeros((), dtype=torch.float32, device=device))
    row = torch.arange(P, device=device, dtype=torch.int64)[:, None] * (width + 1)
    left = left_edges.to(torch.int64).clamp(0, width) + row
    right = right_edges.to(torch.int64).clamp(0, width) + row
    keys = torch.cat([left.reshape(-1), right.reshape(-1)])
    values = torch.cat([mu.reshape(-1), -mu.reshape(-1)])
    keys, order = torch.sort(keys, stable=True)
    bins, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(values[order][:, None], "sum", lengths=counts, axis=0,
                                unsafe=True)[:, 0]
    diff = torch.zeros(P * (width + 1), dtype=torch.float32, device=device)
    diff[bins] = sums
    return cumsum_f32(diff.reshape(P, width + 1))[:, :width]
