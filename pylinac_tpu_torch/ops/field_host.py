"""Host staging of the batched field analysis, numpy only.

Port of ``pylinac_tpu/ops/field_host.py``: ``resample_linear_np`` ``:21``,
``main_peak_np`` ``:37``, ``main_peak_ips_np`` ``:63``,
``beam_center_ratio_np`` ``:89``, ``beam_center_ratio_np_batch`` ``:102``,
``strip_indices`` ``:155`` and ``central_roi_stats_np`` ``:163``, copied so
that the port imports nothing of the JAX package.

The batched analysis needs two 1D strips and the central-ROI statistics of
each image, not the image. The projections, the beam centring and the strip
extraction run here in float64 numpy, as in the JAX package, so that the
port's strips equal its strips bit for bit and only about 2 (H + W) floats
an image go to the card (``pylinac_tpu_torch.field_analysis``). The
beam-centre math is the reference's ``_determine_center`` on a default
SingleProfile (``field_analysis.py:215``): the BMF half-pixel linear
resample x10, ground, the most prominent peak's crossings at 50 %.
"""

from __future__ import annotations

import numpy as np


def resample_linear_np(v: np.ndarray, samples: int) -> tuple[np.ndarray, float, float]:
    """Linear resample with the reference's half-pixel ('BMF') offset
    (``core/profile.py:1312-1360``): new x spans [-offset, n-1+offset];
    terminal segments extrapolate linearly.  Returns (values, x0, dx)."""
    v = np.asarray(v, dtype=np.float64)
    n = v.shape[0]
    f = samples / n
    offset = 0.5 - 1.0 / (2.0 * f)
    x0 = -offset
    dx = (n - 1.0 + 2.0 * offset) / (samples - 1)
    t = x0 + dx * np.arange(samples)
    i = np.clip(np.floor(t).astype(np.int64), 0, n - 2)
    y = v[i] + (v[i + 1] - v[i]) * (t - i)
    return y, float(x0), float(dx)


def main_peak_np(v: np.ndarray) -> tuple[int, float, float, int, int]:
    """The most prominent peak = global-max plateau midpoint (scipy
    convention); numpy mirror of :func:`ops.peaks.main_peak`.
    Returns (pos, val, prominence, left_base, right_base)."""
    v = np.asarray(v, dtype=np.float64)
    n = v.shape[0]
    p0 = int(np.argmax(v))
    pv = v[p0]
    # contiguous equal-value run containing the argmax -> midpoint
    brk = v != pv
    idx = np.arange(n)
    left_brk = idx[(idx <= p0) & brk]
    run_start = int(left_brk.max()) + 1 if left_brk.size else 0
    right_brk = idx[(idx >= p0) & brk]
    run_end = int(right_brk.min()) - 1 if right_brk.size else n - 1
    p = run_start + (run_end - run_start) // 2
    left_vals = v[: p + 1]
    left_min = left_vals.min()
    lb = int(np.flatnonzero(left_vals == left_min).max())
    right_vals = v[p:]
    right_min = right_vals.min()
    rb = p + int(np.flatnonzero(right_vals == right_min).min())
    prom = pv - max(left_min, right_min)
    return p, float(pv), float(prom), lb, rb


def main_peak_ips_np(v: np.ndarray, pk, rel_height: float) -> tuple[float, float]:
    """Interpolated left/right crossings at ``rel_height`` (scipy
    ``peak_widths`` semantics); numpy mirror of :func:`ops.peaks.main_peak_ips`."""
    v = np.asarray(v, dtype=np.float64)
    n = v.shape[0]
    pos, val, prom, lb, rb = pk
    h = val - prom * rel_height
    left = np.flatnonzero(v[lb: pos + 1] <= h)
    if left.size:
        j = lb + int(left.max())
        jn = min(j + 1, n - 1)
        denom = v[jn] - v[j] if v[jn] != v[j] else 1.0
        left_ip = j + (h - v[j]) / denom if v[j] < h else float(j)
    else:
        left_ip = float(lb)
    right = np.flatnonzero(v[pos: rb + 1] <= h)
    if right.size:
        j2 = pos + int(right.min())
        jp = max(j2 - 1, 0)
        denom = v[jp] - v[j2] if v[jp] != v[j2] else 1.0
        right_ip = j2 - (h - v[j2]) / denom if v[j2] < h else float(j2)
    else:
        right_ip = float(rb)
    return float(left_ip), float(right_ip)


def beam_center_ratio_np(sums: np.ndarray) -> float:
    """Beam-center position ratio of a row/column-sum profile; numpy mirror
    of the device :func:`ops.field_pipeline._beam_center_ratio`."""
    sums = np.asarray(sums, dtype=np.float64)
    n = sums.shape[0]
    samples = int(round(n * 10))
    v, x0, dx = resample_linear_np(sums, samples)
    v = v - v.min()
    pk = main_peak_np(v)
    l50, r50 = main_peak_ips_np(v, pk, 0.5)
    return (x0 + dx * (l50 + r50) / 2.0) / n


def beam_center_ratio_np_batch(sums: np.ndarray) -> np.ndarray:
    """Vectorized :func:`beam_center_ratio_np` over a (B, n) batch of
    projection profiles — one pass of rowwise numpy ops instead of B python
    loops (the staging hot path for large QA sessions)."""
    sums = np.atleast_2d(np.asarray(sums, dtype=np.float64))
    B, n = sums.shape
    samples = int(round(n * 10))
    f = samples / n
    offset = 0.5 - 1.0 / (2.0 * f)
    x0 = -offset
    dx = (n - 1.0 + 2.0 * offset) / (samples - 1)
    t = x0 + dx * np.arange(samples)
    i = np.clip(np.floor(t).astype(np.int64), 0, n - 2)
    v = sums[:, i] + (sums[:, i + 1] - sums[:, i]) * (t - i)
    v -= v.min(axis=1, keepdims=True)

    idx = np.arange(samples)
    rows = np.arange(B)
    # most prominent peak = global-max plateau midpoint
    p0 = np.argmax(v, axis=1)
    pv = v[rows, p0]
    brk = v != pv[:, None]
    left_side = (idx[None, :] <= p0[:, None]) & brk
    run_start = np.where(left_side, idx[None, :], -1).max(axis=1) + 1
    right_side = (idx[None, :] >= p0[:, None]) & brk
    run_end = np.where(right_side, idx[None, :], samples).min(axis=1) - 1
    p = run_start + (run_end - run_start) // 2
    pv = v[rows, p]
    # prominence bases (nothing is higher, windows span the signal)
    left_vals = np.where(idx[None, :] <= p[:, None], v, np.inf)
    left_min = left_vals.min(axis=1)
    lb = np.where(left_vals == left_min[:, None], idx[None, :], -1).max(axis=1)
    right_vals = np.where(idx[None, :] >= p[:, None], v, np.inf)
    right_min = right_vals.min(axis=1)
    rb = np.where(right_vals == right_min[:, None], idx[None, :], samples).min(axis=1)
    prom = pv - np.maximum(left_min, right_min)
    # interpolated crossings at 50% (scipy peak_widths semantics)
    h = pv - prom * 0.5
    lmask = (idx[None, :] >= lb[:, None]) & (idx[None, :] <= p[:, None]) & (v <= h[:, None])
    j = np.where(lmask, idx[None, :], lb[:, None]).max(axis=1)
    jn = np.minimum(j + 1, samples - 1)
    denom = v[rows, jn] - v[rows, j]
    denom = np.where(denom == 0, 1.0, denom)
    left_ip = np.where(v[rows, j] < h, j + (h - v[rows, j]) / denom, j.astype(np.float64))
    rmask = (idx[None, :] >= p[:, None]) & (idx[None, :] <= rb[:, None]) & (v <= h[:, None])
    j2 = np.where(rmask, idx[None, :], rb[:, None]).min(axis=1)
    jp = np.maximum(j2 - 1, 0)
    denom2 = v[rows, jp] - v[rows, j2]
    denom2 = np.where(denom2 == 0, 1.0, denom2)
    right_ip = np.where(v[rows, j2] < h, j2 - (h - v[rows, j2]) / denom2, j2.astype(np.float64))
    return (x0 + dx * (left_ip + right_ip) / 2.0) / n


def strip_indices(n: int, position: float, width: float) -> tuple[int, int]:
    """Strip [lo, hi) bounds along an ``n``-long axis — the reference's
    ``_get_vert_values`` rounding (``field_analysis.py:228``)."""
    lo = max(int(np.round(n * position - n * width / 2)), 0)
    hi = min(int(np.round(n * position + n * width / 2)) + 1, n)
    return lo, hi


def central_roi_stats_np(arr: np.ndarray, left_v: int, right_v: int,
                         upper_h: int, lower_h: int) -> dict[str, float]:
    """Mean/std/max/min of the rectangle between the two strips; same mask
    semantics as the fused kernel (RectangleROI rasterization excludes the
    bottom/right boundary row & column)."""
    H, W = arr.shape
    roi_w = max(abs(left_v - right_v), 2)
    roi_h = max(abs(upper_h - lower_h), 2)
    cx = roi_w / 2.0 + left_v
    cy = roi_h / 2.0 + upper_h
    c0 = int(np.round(cx - roi_w / 2.0))
    c1 = int(np.round(cx + roi_w / 2.0)) - 1
    r0 = int(np.round(cy - roi_h / 2.0))
    r1 = int(np.round(cy + roi_h / 2.0)) - 1
    sub = arr[max(r0, 0): max(r1, 0), max(c0, 0): max(c1, 0)]
    if sub.size == 0:
        sub = arr[max(r0, 0): max(r0, 0) + 1, max(c0, 0): max(c0, 0) + 1]
    sub = np.asarray(sub, dtype=np.float64)
    return {
        "mean": float(sub.mean()),
        "std": float(sub.std()),
        "max": float(sub.max()),
        "min": float(sub.min()),
    }
