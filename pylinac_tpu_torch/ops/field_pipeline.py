"""The batched field-analysis pipeline, in plain PyTorch on the device.

Port of ``pylinac_tpu/ops/field_pipeline.py``: ``FAParams`` ``:42``, the
profile pieces (``_resample_linear`` ``:59``, ``_y_at_frac`` ``:79``,
``_first_thresholded_peak`` ``:87``, ``_masked_linear_fit`` ``:107``,
``_masked_quadratic_fit`` ``:121``, ``_hill_fit_masked`` ``:144``,
``_hill_edges`` ``:169``), ``analyze_field_profile`` ``:195-424``,
``_beam_center_ratio`` ``:427``, ``field_analysis_image`` ``:444-516`` (here
:func:`field_analysis_batch`, ``:524-533``) and
``field_analysis_strips_batch`` ``:550-570``. The packed and one-wire
wrappers (``:536``, ``:572``, ``:589``) carried the JAX package over a
remote link and are not ported.

Where the JAX functions took one profile or image and were ``vmap``-ed,
these take a (B, N) batch of profiles or a (B, H, W) batch of frames and
return (B,) tensors. The string and integer arguments stay Python values,
as the JAX statics did. Nothing here reads a device value on the host: the
caller fetches the result dict once.

The arithmetic follows the JAX functions op for op in float32: the grid
is rounded as they round it (``x0`` and ``dx`` in float64, then float32),
Python scalars are taken as float32 as JAX takes weak-typed scalars, the
grid, ``to_orig`` and the linear interpolations round once as XLA's fused
multiply-adds do on the CPU (:func:`_fma`), and divisions by a scalar that
is not a power of two are true divisions (the card would multiply by a
reciprocal). Two changes keep the CPU and the card in step: the sums of
the fits and of the projections go through
:func:`pylinac_tpu_torch.ops.stats.wide_sum` (float64, rounded once), and
the 3x3 normal equations are solved in float64, where JAX added and solved
in float32. A parabola that opens upward puts the "top" at the higher
window end, a near-tie on a symmetric field that the last bit decides.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .filters import gaussian_filter1d
from .optimize import (hill_func, hill_gradient, hill_inflection, hill_params, hill_x_at_y,
                       levenberg_marquardt)
from .peaks import MainPeak, _distance_filter, _local_maxima, main_peak, main_peak_ips
from .stats import wide_sum

# slots for the above-threshold extrema of the smoothed derivative (the 0.8
# relative threshold keeps only the field edges, so a few slots suffice)
K_DERIV = 32


class FAParams(NamedTuple):
    """The per-batch analysis parameters, 0-d float32 tensors on the
    analysis's device."""

    dpmm: torch.Tensor                 # original-pixel dpmm
    in_field_ratio: torch.Tensor
    slope_exclusion_ratio: torch.Tensor
    pen_lower: torch.Tensor            # e.g. 20.
    pen_upper: torch.Tensor            # e.g. 80.
    vert_position: torch.Tensor        # ratio along W (manual centring)
    horiz_position: torch.Tensor       # ratio along H
    vert_width: torch.Tensor           # ratio of W
    horiz_width: torch.Tensor          # ratio of H

    @classmethod
    def from_vector(cls, values: Sequence[float], device) -> "FAParams":
        """The nine parameters, in field order, as float32 on ``device`` in
        one copy."""
        vec = torch.as_tensor(np.asarray(values, np.float32)).to(device)
        if vec.shape != (len(cls._fields),):
            raise ValueError(f"FAParams takes {len(cls._fields)} values, got {tuple(vec.shape)}")
        return cls(*vec.unbind())

    def to(self, device) -> "FAParams":
        return FAParams(*(p.to(device) for p in self))


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds weak-typed scalars."""
    return float(np.float32(x))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device: the card divides by a
    Python scalar as a multiply by its reciprocal."""
    return x / torch.full_like(x, c)


def _fl(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once, as XLA's fused
    multiply-add gives it: the product is exact in float64. (Rounding the
    float64 sum to float32 rounds twice, which can differ from one rounding
    only when the sum lies within 2**-53 of a float32 rounding midpoint.)"""
    return _fl(a.to(torch.float64) * b + c)


# ---------------------------------------------------------------------------
# profile building blocks
# ---------------------------------------------------------------------------
def _grid(n: int, samples: int, device) -> tuple[torch.Tensor, float, float]:
    """The resampled x of the BMF half-pixel offset in original-pixel
    coordinates, ``x0 + k dx`` in float32, and ``x0``, ``dx``."""
    f = samples / n
    offset = 0.5 - 1.0 / (2.0 * f)
    x0 = -offset
    dx = (n - 1.0 + 2.0 * offset) / (samples - 1)
    k = torch.arange(samples, dtype=torch.float64, device=device)
    return _fma(k, _f32(dx), _f32(x0)), _f32(x0), _f32(dx)


def _resample_linear(v: torch.Tensor, samples: int) -> tuple[torch.Tensor, float, float]:
    """Linear resample of each row of (B, n) with the reference's half-pixel
    ("BMF") offset (``core/profile.py:1312-1360``): the new x spans
    [-offset, n - 1 + offset] in ``samples`` points; the two ends ride the
    terminal segments. Returns (values, x0, dx) with x[k] = x0 + k dx."""
    n = v.shape[1]
    t, x0, dx = _grid(n, samples, v.device)
    i = torch.clamp(torch.floor(t).long(), 0, n - 2)
    vi, vi1 = v[:, i], v[:, i + 1]
    return _fma(vi1 - vi, t - i, vi), x0, dx


def _y_at_frac(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of each row of (B, n) ``v`` at fractional
    indices (B, m) or (B,), extrapolating along the terminal segments."""
    n = v.shape[1]
    flat = idx.dim() == 1
    idx = idx[:, None] if flat else idx
    i = torch.clamp(torch.floor(idx).long(), 0, n - 2)
    vi, vi1 = v.gather(1, i), v.gather(1, i + 1)
    out = _fma(vi1 - vi, idx - i, vi)
    return out[:, 0] if flat else out


def _first_thresholded_peak(sig: torch.Tensor, distance: float, first: bool) -> torch.Tensor:
    """Index of each row's first (or last) peak above the reference's 0.8
    relative threshold (``MultiProfile.find_peaks(threshold=0.8)``).

    The height filter comes before slot collection; the first ``K_DERIV``
    maxima that clear it take the slots, as ``jnp.nonzero(size=K_DERIV)``
    gave them, and the rest are dropped before the distance filter."""
    b, n = sig.shape
    lo, hi = sig.amin(dim=1, keepdim=True), sig.amax(dim=1, keepdim=True)
    is_pk = _local_maxima(sig) & (sig >= lo + 0.8 * (hi - lo))
    idx = torch.arange(n, device=sig.device)
    rank = torch.cumsum(is_pk, dim=1) - 1
    target = torch.where(is_pk & (rank < K_DERIV), rank, K_DERIV)
    pos = torch.full((b, K_DERIV + 1), -1, dtype=torch.long, device=sig.device)
    pos = pos.scatter(1, target, idx.expand(b, n))[:, :K_DERIV]
    valid = pos >= 0
    val = sig.gather(1, pos.clamp(min=0))
    dist = torch.full((), float(np.ceil(np.float32(distance))), device=sig.device)
    valid = _distance_filter(pos, val, valid, dist, K_DERIV)
    if first:
        return _fl(torch.where(valid, pos, n).amin(dim=1))
    return _fl(torch.where(valid, pos, 0).amax(dim=1))


def _masked_linear_fit(x: torch.Tensor, y: torch.Tensor,
                       m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """0/1-masked least-squares line y = a x + b of each row (np.polyfit
    degree 1 on the masked points, centred for float32)."""
    w = _fl(m)
    cnt = torch.clamp(wide_sum(w, 1), min=1.0)
    xm = wide_sum(w * x, 1) / cnt
    ym = wide_sum(w * y, 1) / cnt
    dxc = torch.where(m, x - xm[:, None], 0.0)
    var = wide_sum(dxc * dxc, 1)
    cov = wide_sum(dxc * (y - ym[:, None]), 1)
    a = cov / torch.clamp(var, min=1e-20)
    return a, ym - a * xm


def _masked_quadratic_fit(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor):
    """0/1-masked least-squares parabola y = a x^2 + b x + c of each row, by
    the 3x3 normal equations on a scaled, centred basis (np.polyfit degree
    2). Returns (a, b, c)."""
    w = _fl(m)
    cnt = torch.clamp(wide_sum(w, 1), min=1.0)
    xm = wide_sum(w * x, 1) / cnt
    hw = torch.clamp(torch.where(m, (x - xm[:, None]).abs(), 0.0).amax(dim=1), min=1e-6)
    u = torch.where(m, (x - xm[:, None]) / hw[:, None], 0.0)
    u2 = u * u
    s0, s1, s2 = wide_sum(w, 1), wide_sum(u, 1), wide_sum(u2, 1)
    s3, s4 = wide_sum(u2 * u, 1), wide_sum(u2 * u2, 1)
    g = torch.stack([torch.stack([s0, s1, s2], 1), torch.stack([s1, s2, s3], 1),
                     torch.stack([s2, s3, s4], 1)], 1)
    rhs = torch.stack([wide_sum(w * y, 1), wide_sum(u * y, 1), wide_sum(u2 * y, 1)], 1)
    sol = torch.linalg.solve_ex(g.to(torch.float64), rhs.to(torch.float64)[:, :, None],
                                check_errors=False)[0][:, :, 0].to(torch.float32)
    c0, c1, c2 = sol.unbind(1)
    # back to the unscaled x: x enters as (x - xm) / hw
    a = c2 / (hw * hw)
    b = c1 / hw - 2.0 * c2 * xm / (hw * hw)
    c = c0 - c1 * xm / hw + c2 * xm * xm / (hw * hw)
    return a, b, c


def _hill_residual(p, xs, y, m):
    return torch.where(m, hill_func(xs, *hill_params(p)) - y, 0.0)


def _hill_fit_masked(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                     n_iter: int = 60) -> torch.Tensor:
    """Hill fits of P masked rows (P, K): the solver and initial guess of
    :func:`pylinac_tpu_torch.ops.optimize.hill_fit` (reference
    ``core/hill.py:22``) over each row's run of valid slots, so the window
    length can differ from row to row. Returns (P, 4)."""
    K = m.shape[1]
    big = 1e30
    slots = torch.arange(K, device=m.device)
    n_valid = torch.clamp(m.sum(dim=1), min=2)
    first = torch.where(m, slots, K).amin(dim=1)
    first = torch.where(first == K, 0, first)       # jnp.argmax of no True is 0
    last = (first + n_valid - 1).clamp(max=K - 1)   # JAX clamps gathers
    mid = (first + n_valid // 2).clamp(max=K - 1)
    ymin = torch.where(m, y, big).amin(dim=1)
    ymax = torch.where(m, y, -big).amax(dim=1)
    slope_up = y.gather(1, last[:, None])[:, 0] > y.gather(1, first[:, None])[:, 0]
    p0 = torch.stack([ymin, ymax, x.gather(1, mid[:, None])[:, 0],
                      _fl(torch.where(slope_up, 10.0, -10.0))], dim=1)
    xs = torch.where(m, x, 1.0)  # masked-out x may be <= 0: guard the power
    return levenberg_marquardt(_hill_residual, p0, xs, y, m, n_iter=n_iter)


def _hill_edges(v: torch.Tensor, x0: float, dx: float, seed_left: torch.Tensor,
                seed_right: torch.Tensor, half_window: torch.Tensor, samples: int, K: int):
    """The left and right Hill sigmoids around the derivative-seeded edges
    of each row, fitted in one solve, and their inflections, in
    original-pixel coordinates (``SingleProfile._inflection_data``'s Hill
    branch, ``core/profile.py:840-859``): window x = arange(seed - hw,
    seed + hw) in unit original-pixel steps, the left one kept at x >= 0,
    the right one at x < len(interpolated)."""
    k = torch.arange(K, dtype=torch.float32, device=v.device)
    inf = float("inf")

    def window(seed, lo, hi):
        x = seed[:, None] - half_window[:, None] + k
        m = (k < 2.0 * half_window[:, None]) & (x >= lo) & (x < hi)
        return x, m, _y_at_frac(v, (x - x0) / dx)

    xl, ml, yl = window(seed_left, 0.0, inf)
    xr, mr, yr = window(seed_right, -inf, float(samples))
    params = _hill_fit_masked(torch.cat([xl, xr]), torch.cat([yl, yr]), torch.cat([ml, mr]))
    infl = hill_inflection(params)
    b = v.shape[0]
    return params[:b], params[b:], infl[:b], infl[b:]


def _gradient(x: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient`` of each row: first-order ends, central differences
    halved inside."""
    return torch.cat([x[:, 1:2] - x[:, 0:1], (x[:, 2:] - x[:, :-2]) * 0.5,
                      x[:, -1:] - x[:, -2:-1]], dim=1)


def _masked_pick(svals: torch.Tensor) -> torch.Tensor:
    """Each row's value of largest magnitude, the first such."""
    return svals.gather(1, svals.abs().argmax(dim=1, keepdim=True))[:, 0]


# ---------------------------------------------------------------------------
# the per-profile analysis
# ---------------------------------------------------------------------------
def analyze_field_profile(
    values: torch.Tensor,
    params: FAParams,
    *,
    samples: int,
    edge: str,                 # "FWHM" | "Inflection Derivative" | "Inflection Hill"
    centering: str,            # "Beam center" | "Geometric center" | "Manual"
    normalization: str,        # "Beam center" | "Max" | "None" | "Geometric center"
    flatness: str,             # "difference" | "ratio"
    symmetry: str,             # "point difference" | "pdq" | "area"
    ground: bool = True,
    edge_smoothing_ratio: float = 0.003,
    hill_window_ratio: float = 0.15,
) -> dict:
    """Every FieldAnalysis scalar of each row of a (B, n) profile batch, as
    (B,) tensors: ``SingleProfile`` and the protocol functions
    (``pylinac_tpu/field_analysis.py:36-92``) query by query."""
    n_orig = values.shape[1]
    v, x0, dx = _resample_linear(_fl(values), samples)
    if ground:
        v = v - v.amin(dim=1, keepdim=True)

    def to_orig(ip):
        return _fma(ip, dx, x0)

    def y_at_orig(xo):
        return _y_at_frac(v, (xo - x0) / dx)

    # the main peak (its selection is scale- and shift-invariant)
    pk = main_peak(v)
    l50, r50 = main_peak_ips(v, pk, 0.5)
    fwhm_center = (to_orig(l50) + to_orig(r50)) / 2.0
    fwhm_width = to_orig(r50) - to_orig(l50)

    # inflection-derivative edges (their indices do not depend on the
    # normalisation)
    if edge in ("Inflection Derivative", "Inflection Hill"):
        d1 = _gradient(gaussian_filter1d(v, sigma=edge_smoothing_ratio * samples))
        sep = float(max(int(0.05 * samples), 1))
        infl_left_orig = to_orig(_first_thresholded_peak(d1, sep, first=True))
        infl_right_orig = to_orig(_first_thresholded_peak(-d1, sep, first=False))
        beam_center_idx = infl_left_orig + (infl_right_orig - infl_left_orig) / 2.0
        full_width = infl_right_orig - infl_left_orig
    else:
        infl_left_orig = to_orig(l50)
        infl_right_orig = to_orig(r50)
        beam_center_idx = fwhm_center
        full_width = fwhm_width

    if edge == "Inflection Hill":
        # fixed slot budget: window length 2 hw <= ratio (n_orig + 1) + 1
        k_hill = int(hill_window_ratio * (n_orig + 2)) + 4
        seed_left, seed_right = infl_left_orig, infl_right_orig
        hill_hw = torch.round(hill_window_ratio * (seed_right - seed_left).abs() / 2.0)
        if normalization == "Beam center":
            # the single-image path takes the scale from Hill fits on the
            # grounded values, then fits again on the normalised ones
            _, _, il0, ir0 = _hill_edges(v, x0, dx, seed_left, seed_right, hill_hw,
                                         samples, k_hill)
            beam_center_idx = il0 + (ir0 - il0) / 2.0

    # normalisation (the reference's Normalization semantics)
    bc_val_rounded = y_at_orig(torch.round(beam_center_idx))
    if normalization == "Beam center":
        scale = bc_val_rounded
    elif normalization == "Max":
        scale = v.amax(dim=1)
    elif normalization == "Geometric center":
        mid = samples // 2
        scale = ((v[:, mid] + v[:, mid - 1]) / 2.0 if samples % 2 == 0
                 else v[:, (samples - 1) // 2])
    else:
        scale = torch.ones_like(bc_val_rounded)
    v = v / scale[:, None]
    pk = pk._replace(val=pk.val / scale, prom=pk.prom / scale)
    bc_val_rounded = bc_val_rounded / scale

    if edge == "Inflection Hill":
        # the final fits, on the normalised values
        hill_l, hill_r, infl_left_orig, infl_right_orig = _hill_edges(
            v, x0, dx, seed_left, seed_right, hill_hw, samples, k_hill)
        beam_center_idx = infl_left_orig + (infl_right_orig - infl_left_orig) / 2.0
        full_width = infl_right_orig - infl_left_orig
        bc_val_rounded = y_at_orig(torch.round(beam_center_idx))

    # to_orig((samples - 1) / 2.0) in float32, the same for every row
    geometric = np.float32(x0) + np.float32((samples - 1) / 2.0) * np.float32(dx)
    cax_idx = torch.full_like(beam_center_idx, float(geometric))
    center_idx = cax_idx if centering == "Geometric center" else beam_center_idx

    # ---- penumbra ----------------------------------------------------------
    hill_grads = None
    if edge == "FWHM":
        lo_l, lo_r = main_peak_ips(v, pk, 1.0 - _div(params.pen_lower, 100.0))
        hi_l, hi_r = main_peak_ips(v, pk, 1.0 - _div(params.pen_upper, 100.0))
        pen_left = (to_orig(hi_l) - to_orig(lo_l)).abs()
        pen_right = (to_orig(hi_r) - to_orig(lo_r)).abs()
    elif edge == "Inflection Hill":
        # from the fitted sigmoids (``SingleProfile.penumbra``'s Hill branch,
        # ``core/profile.py:916-948``)
        left_val = hill_func(infl_left_orig, *hill_l.unbind(1))
        right_val = hill_func(infl_right_orig, *hill_r.unbind(1))
        pen_left = (hill_x_at_y(hill_l, _div(left_val * params.pen_upper, 50.0))
                    - hill_x_at_y(hill_l, _div(left_val * params.pen_lower, 50.0))).abs()
        pen_right = (hill_x_at_y(hill_r, _div(right_val * params.pen_upper, 50.0))
                     - hill_x_at_y(hill_r, _div(right_val * params.pen_lower, 50.0))).abs()
        hill_grads = (hill_gradient(hill_l, infl_left_orig),
                      hill_gradient(hill_r, infl_right_orig))
    else:
        vmax = v.amax(dim=1)
        left_val = y_at_orig(infl_left_orig)
        right_val = y_at_orig(infl_right_orig)

        def pct(val, pen):
            return _div(val / vmax * pen, 50.0) * 100.0

        ll_pct = torch.clamp(pct(left_val, params.pen_lower), min=1.0)
        ul_pct = torch.clamp(pct(left_val, params.pen_upper), max=99.0)
        lr_pct = torch.clamp(pct(right_val, params.pen_lower), min=1.0)
        ur_pct = torch.clamp(pct(right_val, params.pen_upper), max=99.0)
        ll, _ = main_peak_ips(v, pk, 1.0 - _div(ll_pct, 100.0))
        ul, _ = main_peak_ips(v, pk, 1.0 - _div(ul_pct, 100.0))
        _, lr = main_peak_ips(v, pk, 1.0 - _div(lr_pct, 100.0))
        _, ur = main_peak_ips(v, pk, 1.0 - _div(ur_pct, 100.0))
        pen_left = (to_orig(ul) - to_orig(ll)).abs()
        pen_right = (to_orig(ur) - to_orig(lr)).abs()

    # ---- field data (at in_field_ratio and at 1.0) -------------------------
    x_idx, _, _ = _grid(n_orig, samples, v.device)

    def field_edges(ratio):
        f_left = center_idx - ratio * full_width / 2.0
        f_right = center_idx + ratio * full_width / 2.0
        return f_left, f_right, f_right - f_left

    f_left_full, f_right_full, width_full = field_edges(1.0)
    f_left, f_right, f_width = field_edges(params.in_field_ratio)
    in_left = center_idx - params.slope_exclusion_ratio * f_width / 2.0
    in_right = center_idx + params.slope_exclusion_ratio * f_width / 2.0
    lmask = (x_idx >= f_left[:, None]) & (x_idx <= in_left[:, None])
    rmask = (x_idx >= in_right[:, None]) & (x_idx <= f_right[:, None])
    tmask = (x_idx >= in_left[:, None]) & (x_idx <= in_right[:, None])
    lslope, _ = _masked_linear_fit(x_idx, v, lmask)
    rslope, _ = _masked_linear_fit(x_idx, v, rmask)
    qa, qb, _ = _masked_quadratic_fit(x_idx, v, tmask)
    t_lo = torch.where(tmask, x_idx, float("inf")).amin(dim=1)
    t_hi = torch.where(tmask, x_idx, float("-inf")).amax(dim=1)
    vertex = torch.where(qa != 0.0, -qb / (2.0 * qa), (t_lo + t_hi) / 2.0)
    y_lo = qa * t_lo * t_lo + qb * t_lo
    y_hi = qa * t_hi * t_hi + qb * t_hi
    top_idx = torch.where(qa < 0.0, torch.minimum(torch.maximum(vertex, t_lo), t_hi),
                          torch.where(y_lo >= y_hi, t_lo, t_hi))

    # the in-field window's values on the grid shifted by the centre's
    # fractional pixel (the reference's field-values extraction)
    off = center_idx - torch.round(center_idx)
    kmin = torch.clamp(torch.round((f_left - off - x0) / dx), 0, samples - 1).long()
    kmax = torch.clamp(torch.round((f_right - off - x0) / dx), 0, samples - 1).long()
    shift_frac = off / dx
    ks = torch.arange(samples, device=v.device)
    nf = kmax - kmin + 1
    fmask = ks < nf[:, None]
    fvals = _y_at_frac(v, _fl(kmin[:, None] + ks) + shift_frac[:, None])
    fvals_rev = _y_at_frac(v, _fl(kmin[:, None] + (nf[:, None] - 1 - ks)) + shift_frac[:, None])

    # ---- protocol: flatness ------------------------------------------------
    fmax = torch.where(fmask, fvals, float("-inf")).amax(dim=1)
    fmin = torch.where(fmask, fvals, float("inf")).amin(dim=1)
    if flatness == "ratio":
        flat = 100.0 * fmax / fmin
    else:
        flat = 100.0 * (fmax - fmin).abs() / (fmax + fmin)

    # ---- protocol: symmetry ------------------------------------------------
    if symmetry == "pdq":
        s1 = fvals / fvals_rev
        s2 = fvals_rev / fvals
        sign = torch.where(s1.abs() > s2.abs(), torch.sign(s1), torch.sign(s2))
        svals = torch.where(fmask, torch.maximum(s1.abs(), s2.abs()) * sign, 0.0)
        sym = _masked_pick(svals)
    elif symmetry == "area":
        half = _fl(nf) / 2.0
        area_left = wide_sum(torch.where(ks < torch.floor(half)[:, None], fvals, 0.0), 1)
        area_right = wide_sum(torch.where((ks >= torch.ceil(half)[:, None]) & fmask,
                                          fvals, 0.0), 1)
        sym = 100.0 * (area_left - area_right) / (area_left + area_right)
    else:  # point difference (Varian)
        svals = torch.where(fmask, 100.0 * (fvals - fvals_rev) / bc_val_rounded[:, None], 0.0)
        sym = _masked_pick(svals)

    mm = params.dpmm
    out = {
        "penumbra_left_mm": pen_left / mm,
        "penumbra_right_mm": pen_right / mm,
        "geometric_center_idx": cax_idx,
        "beam_center_idx": beam_center_idx,
        "field_size_mm": width_full / mm,
        "bc_to_left_mm": (beam_center_idx - f_left_full).abs() / mm,
        "bc_to_right_mm": (f_right_full - beam_center_idx).abs() / mm,
        "cax_to_left_mm": (cax_idx - f_left_full).abs() / mm,
        "cax_to_right_mm": (cax_idx - f_right_full).abs() / mm,
        "top_idx": top_idx,
        "top_to_cax_mm": (top_idx - cax_idx).abs() / mm,
        "top_to_bc_mm": (top_idx - beam_center_idx) / mm,
        "left_slope_pct_mm": lslope * mm * 100.0,
        "right_slope_pct_mm": rslope * mm * 100.0,
        "flatness": flat,
        "symmetry": sym,
    }
    if hill_grads is not None:
        out["penumbra_left_grad_pct_mm"] = (hill_grads[0] * mm * 100.0).abs()
        out["penumbra_right_grad_pct_mm"] = (hill_grads[1] * mm * 100.0).abs()
    return out


def _beam_center_ratio(sums: torch.Tensor) -> torch.Tensor:
    """Beam-centre position ratio of each row of a (B, n) projection: the
    reference's ``_determine_center`` on a default SingleProfile (LINEAR x10
    resample, FWHM edges); the index does not depend on the grounding."""
    n = sums.shape[1]
    v, x0, dx = _resample_linear(_fl(sums), int(round(n * 10)))
    v = v - v.amin(dim=1, keepdim=True)
    pk: MainPeak = main_peak(v)
    l50, r50 = main_peak_ips(v, pk, 0.5)
    return _div(x0 + dx * (l50 + r50) / 2.0, float(n))


# ---------------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------------
def field_analysis_batch(
    images,
    params: FAParams,
    *,
    samples_v: int,
    samples_h: int,
    edge: str,
    centering: str,
    normalization: str,
    flatness: str,
    symmetry: str,
    ground: bool = True,
    edge_smoothing_ratio: float = 0.003,
    hill_window_ratio: float = 0.15,
    device=None,
) -> dict:
    """A (B, H, W) batch of open-field frames to every FieldResult scalar,
    whole on ``device`` (``None`` means CUDA): the projections, the beam
    centring, the strips, both profiles' analyses and the central ROI.
    ``images`` is a tensor or an array of any real dtype, staged in its own
    dtype and widened to float32 on the device; ``params`` moves there too.
    Returns {"vert", "horiz", "central_roi": dicts of (B,) tensors,
    "strip_edges": (B, 4)}."""
    from ..core.utilities import resolve_device

    device = resolve_device(device, "field_analysis_batch")
    img = _fl(torch.as_tensor(images).to(device))
    params = params.to(device)
    B, H, W = img.shape

    if centering == "Beam center":
        vert_position = _beam_center_ratio(wide_sum(img, 1))
        horiz_position = _beam_center_ratio(wide_sum(img, 2))
    elif centering == "Geometric center":
        vert_position = torch.full((B,), _f32(((W - 1) / 2.0) / W), device=device)
        horiz_position = torch.full((B,), _f32(((H - 1) / 2.0) / H), device=device)
    else:
        vert_position = params.vert_position.expand(B)
        horiz_position = params.horiz_position.expand(B)

    # the strips: masked means, with the reference's rounding
    left_v = torch.clamp(torch.round(W * vert_position - W * params.vert_width / 2.0), min=0)
    right_v = torch.clamp(torch.round(W * vert_position + W * params.vert_width / 2.0) + 1,
                          max=W)
    cols = torch.arange(W, device=device)
    vmask = (cols >= left_v[:, None]) & (cols < right_v[:, None])                 # (B, W)
    vert_values = (wide_sum(torch.where(vmask[:, None, :], img, 0.0), 2)
                   / torch.clamp(vmask.sum(dim=1), min=1)[:, None])
    upper_h = torch.clamp(torch.round(H * horiz_position - H * params.horiz_width / 2.0), min=0)
    lower_h = torch.clamp(torch.round(H * horiz_position + H * params.horiz_width / 2.0) + 1,
                          max=H)
    rows = torch.arange(H, device=device)
    hmask = (rows >= upper_h[:, None]) & (rows < lower_h[:, None])                # (B, H)
    horiz_values = (wide_sum(torch.where(hmask[:, :, None], img, 0.0), 1)
                    / torch.clamp(hmask.sum(dim=1), min=1)[:, None])

    kw = dict(edge=edge, centering=centering, normalization=normalization,
              flatness=flatness, symmetry=symmetry, ground=ground,
              edge_smoothing_ratio=edge_smoothing_ratio, hill_window_ratio=hill_window_ratio)
    vert = analyze_field_profile(_fl(vert_values), params, samples=samples_v, **kw)
    horiz = analyze_field_profile(_fl(horiz_values), params, samples=samples_h, **kw)

    # the central ROI, the rectangle between the strip lines; its
    # rasterisation leaves out the bottom row and the right column
    # (RectangleROI.pixels_flat)
    roi_w = torch.clamp((left_v - right_v).abs(), min=2)
    roi_h = torch.clamp((upper_h - lower_h).abs(), min=2)
    cx = roi_w / 2.0 + left_v
    cy = roi_h / 2.0 + upper_h
    cmask = ((cols >= torch.round(cx - roi_w / 2.0)[:, None])
             & (cols < (torch.round(cx + roi_w / 2.0) - 1)[:, None]))
    rmask_rows = ((rows >= torch.round(cy - roi_h / 2.0)[:, None])
                  & (rows < (torch.round(cy + roi_h / 2.0) - 1)[:, None]))
    rmask = rmask_rows[:, :, None] & cmask[:, None, :]
    cnt = _fl(torch.clamp(rmask.sum(dim=(1, 2)), min=1))
    rmean = wide_sum(torch.where(rmask, img, 0.0).flatten(1), 1) / cnt
    dev2 = (img - rmean[:, None, None]) ** 2
    rvar = wide_sum(torch.where(rmask, dev2, 0.0).flatten(1), 1) / cnt
    central_roi = {
        "mean": rmean,
        "std": torch.sqrt(rvar),
        "max": torch.where(rmask, img, float("-inf")).amax(dim=(1, 2)),
        "min": torch.where(rmask, img, float("inf")).amin(dim=(1, 2)),
    }
    return {"vert": vert, "horiz": horiz, "central_roi": central_roi,
            "strip_edges": torch.stack([left_v, right_v, upper_h, lower_h], dim=1)}


def field_analysis_strips_batch(vert_strips: torch.Tensor, horiz_strips: torch.Tensor,
                                params: FAParams, *, samples_v: int, samples_h: int,
                                **static) -> dict:
    """The per-profile analysis of (B, H) vertical and (B, W) horizontal
    strips that the host cut (:mod:`pylinac_tpu_torch.ops.field_host`), on
    the strips' device: {"vert", "horiz": dicts of (B,) tensors}."""
    vert = analyze_field_profile(_fl(vert_strips), params, samples=samples_v, **static)
    horiz = analyze_field_profile(_fl(horiz_strips), params, samples=samples_h, **static)
    return {"vert": vert, "horiz": horiz}
