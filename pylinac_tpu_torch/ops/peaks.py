"""Fixed-shape 1D peak analysis (scipy.signal.find_peaks parity), batched.

Port of ``pylinac_tpu/ops/peaks.py``: ``PeakResult`` ``:28``,
``_local_maxima`` ``:48``, ``_distance_filter`` ``:65``, ``peak_analysis``
``:87``, ``compact_slots`` ``:171``, ``main_peak`` ``:210``,
``main_peak_ips`` ``:234``, ``select_top`` ``:253`` and the host wrappers
``find_peaks`` ``:315``, ``find_peaks_rows`` ``:383`` and ``find_valleys``
``:450``.

Where the JAX functions took one signal and were ``vmap``-ed, these take a
(B, N) batch of signals and return (B, K) slots. Nothing here syncs to the
host: slot collection uses a cumsum and a scatter where JAX used
``jnp.nonzero(size=K)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PeakResult(NamedTuple):
    """Fixed-size peak analysis of B signals. Invalid slots have
    ``valid=False``."""

    positions: torch.Tensor      # (B, K) int32 peak indices (into the signal)
    values: torch.Tensor         # (B, K) float32 peak heights
    prominences: torch.Tensor    # (B, K) float32
    left_bases: torch.Tensor     # (B, K) int32
    right_bases: torch.Tensor    # (B, K) int32
    widths: torch.Tensor         # (B, K) float32
    width_heights: torch.Tensor  # (B, K) float32
    left_ips: torch.Tensor       # (B, K) float32 interpolated left crossing
    right_ips: torch.Tensor      # (B, K) float32
    valid: torch.Tensor          # (B, K) bool
    overflowed: torch.Tensor     # (B,) bool: more raw maxima than K slots


def _column(x, v: torch.Tensor) -> torch.Tensor:
    """A scalar or per-signal (B,) parameter as float32, broadcastable
    against (B, K) slots."""
    t = torch.as_tensor(x, dtype=torch.float32, device=v.device)
    return t[:, None] if t.dim() == 1 else t


def _local_maxima(v: torch.Tensor) -> torch.Tensor:
    """(B, N) mask of plateau-aware local maxima (scipy midpoint rule)."""
    b, n = v.shape
    idx = torch.arange(n, device=v.device)
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    edge = torch.ones(b, 1, dtype=torch.bool, device=v.device)
    # a "run" is a maximal stretch of equal values
    change = torch.cat([edge, v[:, 1:] != v[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(change, idx, -1), dim=1).values
    change_r = torch.cat([v[:, :-1] != v[:, 1:], edge], dim=1)
    run_end = torch.cummin(torch.where(change_r, idx, n).flip(1), dim=1).values.flip(1)
    prev_val = torch.where(run_start > 0, v.gather(1, (run_start - 1).clamp(min=0)), inf)
    next_val = torch.where(run_end < n - 1, v.gather(1, (run_end + 1).clamp(max=n - 1)), inf)
    is_peak_run = (prev_val < v) & (next_val < v)
    mid = run_start + (run_end - run_start) // 2
    return is_peak_run & (idx == mid)


def _distance_filter(pos: torch.Tensor, val: torch.Tensor, valid: torch.Tensor,
                     distance: torch.Tensor, K: int) -> torch.Tensor:
    """scipy _select_by_peak_distance: visit peaks by descending height,
    removing not-yet-removed neighbours closer than ``distance``.

    The slots are permuted into visiting order once, with the (B, K, K)
    table of which slots lie within ``distance`` of which, so that each of
    the K sequential visits is four elementwise launches."""
    # stable ascending sort on height with invalid slots at -inf, so they
    # come first and never remove anything; then visit from the end
    order = torch.argsort(torch.where(valid, val, float("-inf")), dim=1, stable=True)
    pos_o = pos.gather(1, order)
    valid_o = valid.gather(1, order)
    ranks = torch.arange(K, device=pos.device)
    near = ((pos_o[:, :, None] - pos_o[:, None, :]).abs() < distance) & (ranks[:, None] != ranks)
    keep_o = torch.ones_like(valid_o)
    for r in range(K - 1, -1, -1):
        cond = valid_o[:, r:r + 1] & keep_o[:, r:r + 1]
        keep_o = keep_o & ~(cond & near[:, r])
    keep = torch.empty_like(keep_o).scatter_(1, order, keep_o)
    return valid & keep


def peak_analysis(
    v: torch.Tensor,
    K: int = 32,
    rel_height=0.5,
    height=float("-inf"),
    distance=1.0,
    min_width=0.0,
    required_prominence=None,
) -> PeakResult:
    """Peaks of each row of a (B, N) batch in K fixed slots. ``height`` and
    ``required_prominence`` may be scalars or per-row (B,) tensors."""
    v = v.to(torch.float32)
    b, n = v.shape
    idx = torch.arange(n, device=v.device)
    inf = float("inf")

    # height filter before slot collection (elementwise, as scipy applies it
    # first), so sub-threshold maxima cannot exhaust the K slots
    is_peak = _local_maxima(v) & (v >= _column(height, v))
    overflowed = is_peak.sum(dim=1) > K
    # the first K maxima, in order, into K slots (-1 = empty): a cumsum
    # gives each maximum its slot; the rest scatter into a spare slot K
    rank = torch.cumsum(is_peak, dim=1) - 1
    target = torch.where(is_peak & (rank < K), rank, K)
    pos = torch.full((b, K + 1), -1, dtype=torch.long, device=v.device)
    pos = pos.scatter(1, target, idx.expand(b, n))[:, :K]
    valid = pos >= 0
    safe_pos = pos.clamp(min=0)
    val = v.gather(1, safe_pos)

    # distance filter (scipy ceils the distance)
    dist = torch.ceil(torch.as_tensor(distance, dtype=torch.float32, device=v.device))
    valid = _distance_filter(pos, val, valid, dist, K)

    # prominences, over (B, K, N)
    vv = v[:, None, :]
    p = safe_pos[:, :, None]
    pv = val[:, :, None]
    higher_left = (vv > pv) & (idx < p)
    lo = torch.where(higher_left, idx, -1).amax(dim=2) + 1
    left_vals = torch.where((idx >= lo[:, :, None]) & (idx <= p), vv, inf)
    left_min = left_vals.amin(dim=2)
    # scipy keeps the base closest to the peak on each side
    left_bases = torch.where(left_vals == left_min[:, :, None], idx, -1).amax(dim=2)
    higher_right = (vv > pv) & (idx > p)
    hi = torch.where(higher_right, idx, n).amin(dim=2) - 1
    right_vals = torch.where((idx <= hi[:, :, None]) & (idx >= p), vv, inf)
    right_min = right_vals.amin(dim=2)
    right_bases = torch.where(right_vals == right_min[:, :, None], idx, n).amin(dim=2)
    proms = val - torch.maximum(left_min, right_min)

    if required_prominence is not None:
        valid = valid & (proms >= _column(required_prominence, v))

    # widths at rel_height (scipy _peak_widths)
    h = val - proms * rel_height
    hh = h[:, :, None]
    lmask = (idx >= left_bases[:, :, None]) & (idx <= p) & (vv <= hh)
    j = torch.where(lmask, idx, left_bases[:, :, None]).amax(dim=2)
    vj = v.gather(1, j)
    vjn = v.gather(1, (j + 1).clamp(max=n - 1))
    interp = (h - vj) / torch.where(vjn == vj, 1.0, vjn - vj)
    left_ips = torch.where(vj < h, j + interp, j.to(torch.float32))
    rmask = (idx >= p) & (idx <= right_bases[:, :, None]) & (vv <= hh)
    j2 = torch.where(rmask, idx, right_bases[:, :, None]).amin(dim=2)
    vj2 = v.gather(1, j2)
    vjp = v.gather(1, (j2 - 1).clamp(min=0))
    interp2 = (h - vj2) / torch.where(vjp == vj2, 1.0, vjp - vj2)
    right_ips = torch.where(vj2 < h, j2 - interp2, j2.to(torch.float32))
    widths = right_ips - left_ips
    valid = valid & (widths >= _column(min_width, v))

    return PeakResult(
        positions=pos.to(torch.int32), values=val, prominences=proms,
        left_bases=left_bases.to(torch.int32),
        right_bases=right_bases.to(torch.int32),
        widths=widths, width_heights=h, left_ips=left_ips, right_ips=right_ips,
        valid=valid, overflowed=overflowed)


def compact_slots(result: PeakResult, K_out: int) -> PeakResult:
    """Move valid slots to the front (keeping their order) and keep the
    first ``K_out``."""
    K = result.positions.shape[1]
    ar = torch.arange(K, device=result.valid.device)
    order = torch.argsort(torch.where(result.valid, ar, K + ar), dim=1)
    take = order[:, :K_out]

    def gather(f):
        return f.gather(1, take)

    n = result.valid.sum(dim=1, keepdim=True)
    new_valid = torch.arange(K_out, device=n.device) < n
    return PeakResult(
        positions=torch.where(new_valid, gather(result.positions), -1),
        values=gather(result.values),
        prominences=gather(result.prominences),
        left_bases=gather(result.left_bases),
        right_bases=gather(result.right_bases),
        widths=gather(result.widths),
        width_heights=gather(result.width_heights),
        left_ips=gather(result.left_ips),
        right_ips=gather(result.right_ips),
        valid=new_valid & gather(result.valid),
        overflowed=result.overflowed,
    )


class MainPeak(NamedTuple):
    """The most prominent peak of each of B signals."""

    pos: torch.Tensor   # (B,) int64 peak index
    val: torch.Tensor   # (B,) float32 height
    prom: torch.Tensor  # (B,) float32 prominence
    lb: torch.Tensor    # (B,) int64 left base
    rb: torch.Tensor    # (B,) int64 right base


def main_peak(v: torch.Tensor) -> MainPeak:
    """The most prominent peak of each row of (B, N): the global-max plateau
    (scipy midpoint convention), in O(N) with no slot budget."""
    n = v.shape[1]
    idx = torch.arange(n, device=v.device)
    pv = v.amax(dim=1, keepdim=True)
    # first index of the maximum, as jnp.argmax
    p0 = torch.where(v == pv, idx, n).amin(dim=1, keepdim=True)
    # contiguous equal-value run containing it → midpoint
    brk = v != pv
    run_start = torch.where((idx <= p0) & brk, idx, -1).amax(dim=1, keepdim=True) + 1
    run_end = torch.where((idx >= p0) & brk, idx, n).amin(dim=1, keepdim=True) - 1
    p = run_start + (run_end - run_start) // 2
    # nothing is higher, so the base windows span the whole signal
    left_vals = torch.where(idx <= p, v, float("inf"))
    left_min = left_vals.amin(dim=1, keepdim=True)
    lb = torch.where(left_vals == left_min, idx, -1).amax(dim=1)
    right_vals = torch.where(idx >= p, v, float("inf"))
    right_min = right_vals.amin(dim=1, keepdim=True)
    rb = torch.where(right_vals == right_min, idx, n).amin(dim=1)
    prom = (pv - torch.maximum(left_min, right_min))[:, 0]
    return MainPeak(p[:, 0], pv[:, 0], prom, lb, rb)


def main_peak_ips(v: torch.Tensor, pk: MainPeak, rel_height) -> tuple[torch.Tensor, torch.Tensor]:
    """Interpolated left and right crossings of each row's ``pk`` at
    ``rel_height`` (scipy ``peak_widths`` semantics)."""
    n = v.shape[1]
    idx = torch.arange(n, device=v.device)
    h = pk.val - pk.prom * rel_height
    lmask = (idx >= pk.lb[:, None]) & (idx <= pk.pos[:, None]) & (v <= h[:, None])
    j = torch.where(lmask, idx, pk.lb[:, None]).amax(dim=1)
    vj = v.gather(1, j[:, None])[:, 0]
    vjn = v.gather(1, (j + 1).clamp(max=n - 1)[:, None])[:, 0]
    interp = (h - vj) / torch.where(vjn == vj, 1.0, vjn - vj)
    left_ip = torch.where(vj < h, j + interp, j.to(torch.float32))
    rmask = (idx >= pk.pos[:, None]) & (idx <= pk.rb[:, None]) & (v <= h[:, None])
    j2 = torch.where(rmask, idx, pk.rb[:, None]).amin(dim=1)
    vj2 = v.gather(1, j2[:, None])[:, 0]
    vjp = v.gather(1, (j2 - 1).clamp(min=0)[:, None])[:, 0]
    interp2 = (h - vj2) / torch.where(vjp == vj2, 1.0, vjp - vj2)
    right_ip = torch.where(vj2 < h, j2 - interp2, j2.to(torch.float32))
    return left_ip, right_ip


def select_top(result: PeakResult, max_number: int | None,
               sort_key: str = "prominences") -> PeakResult:
    """Keep the ``max_number`` valid peaks with the largest ``sort_key``,
    in their left-to-right slots. ``"peak_heights"`` (the reference's name)
    sorts on ``values``; the JAX function looks it up as a field and raises."""
    if max_number is None:
        return result
    key = result.values if sort_key == "peak_heights" else getattr(result, sort_key)
    K = key.shape[1]
    masked = torch.where(result.valid, key, float("-inf"))
    order = torch.argsort(masked, dim=1, stable=True)  # ascending
    ar = torch.arange(K, device=key.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, ar)
    # rank K-1 is the largest; keep ranks >= K - max_number
    return result._replace(valid=result.valid & (rank >= K - max_number))


def find_peaks(
    values: np.ndarray,
    threshold: float = -np.inf,
    peak_separation: float = 0,
    max_number: int | None = None,
    fwxm_height: float = 0.5,
    min_width: int = 0,
    search_region: tuple[float, float] = (0.0, 1.0),
    peak_sort: str = "prominences",
    required_prominence: float | None = None,
    K: int = 64,
) -> tuple[np.ndarray, dict]:
    """Reference-compatible peak finder on a host profile: returns
    (peak_indices, props) as numpy, with ratio and integer arguments coerced
    as the reference does. Runs on the CPU, where the profile lives."""
    values = np.asarray(values, dtype=np.float32)
    n = len(values)
    if max_number is not None:
        K = min(K, max(16, 4 * int(max_number)))
    val_range = float(values.max() - values.min())
    if 0 <= threshold <= 1:
        threshold = float(values.min()) + threshold * val_range
    if 0 <= peak_separation <= 1:
        peak_separation = max(int(peak_separation * n), 1)
    if max(search_region) <= 1:
        lo = int(search_region[0] * n)
        hi = int(search_region[1] * n)
    else:
        lo, hi = int(search_region[0]), int(search_region[1])
    trimmed = torch.from_numpy(values[lo:hi].copy())[None]
    prominence = (None if required_prominence is None
                  else np.float32(required_prominence))
    # escalate K geometrically while the raw maxima overflow the slots
    while True:
        res = peak_analysis(trimmed, K=K, rel_height=1 - fwxm_height,
                            height=np.float32(threshold),
                            distance=float(peak_separation),
                            min_width=float(min_width),
                            required_prominence=prominence)
        res = select_top(res, max_number, peak_sort)
        if not bool(res.overflowed[0]) or K >= trimmed.shape[1]:
            break
        K = min(K * 4, max(trimmed.shape[1], 1))
    return _host_peaks(res, lo)[0]


def find_peaks_rows(
    rows: np.ndarray,
    threshold: float = -np.inf,
    peak_separation: float = 0,
    max_number: int | None = None,
    fwxm_height: float = 0.5,
    min_width: int = 0,
    search_region: tuple[float, float] = (0.0, 1.0),
    peak_sort: str = "prominences",
    required_prominence: float | None = None,
    K: int = 64,
) -> list[tuple[np.ndarray, dict]]:
    """:func:`find_peaks` of each row of a (B, N) stack of host profiles
    sharing every argument; ratio thresholds resolve per row, so the result
    equals looping :func:`find_peaks` over the rows."""
    rows = np.asarray(rows, dtype=np.float32)
    b, n = rows.shape
    if max_number is not None:
        K = min(K, max(16, 4 * int(max_number)))
    if 0 <= threshold <= 1:
        rmin, rmax = rows.min(axis=1), rows.max(axis=1)
        heights = (rmin + np.float32(threshold) * (rmax - rmin)).astype(np.float32)
    else:
        heights = np.full(b, threshold, np.float32)
    if 0 <= peak_separation <= 1:
        peak_separation = max(int(peak_separation * n), 1)
    if max(search_region) <= 1:
        lo = int(search_region[0] * n)
        hi = int(search_region[1] * n)
    else:
        lo, hi = int(search_region[0]), int(search_region[1])
    trimmed = torch.from_numpy(rows[:, lo:hi].copy())
    prominence = (None if required_prominence is None
                  else np.float32(required_prominence))
    # escalate K geometrically while the raw maxima overflow the slots
    while True:
        res = peak_analysis(trimmed, K=K, rel_height=1 - fwxm_height,
                            height=torch.from_numpy(heights),
                            distance=float(peak_separation),
                            min_width=float(min_width),
                            required_prominence=prominence)
        res = select_top(res, max_number, peak_sort)
        if not bool(res.overflowed.any()) or K >= trimmed.shape[1]:
            break
        K = min(K * 4, max(trimmed.shape[1], 1))
    return _host_peaks(res, lo)


def _host_peaks(res: PeakResult, lo: int) -> list[tuple[np.ndarray, dict]]:
    """Per row, the valid peaks' indices and scipy-style props, shifted by
    the search-region start ``lo``."""
    f = {name: getattr(res, name).numpy() for name in res._fields[:-1]}
    out = []
    for r in range(f["valid"].shape[0]):
        mask = f["valid"][r]
        props = {
            "prominences": f["prominences"][r][mask].astype(float),
            "left_bases": f["left_bases"][r][mask] + lo,
            "right_bases": f["right_bases"][r][mask] + lo,
            "widths": f["widths"][r][mask].astype(float),
            "width_heights": f["width_heights"][r][mask].astype(float),
            "left_ips": f["left_ips"][r][mask].astype(float) + lo,
            "right_ips": f["right_ips"][r][mask].astype(float) + lo,
            "peak_heights": f["values"][r][mask].astype(float),
        }
        out.append((f["positions"][r][mask].astype(np.int64) + lo, props))
    return out


def find_valleys(values: np.ndarray, **kwargs) -> tuple[np.ndarray, dict]:
    """Valleys of a host profile: :func:`find_peaks` of ``max + min - v``."""
    values = np.asarray(values, dtype=np.float32)
    return find_peaks(values.max() + values.min() - values, **kwargs)
