"""Interpolation in float32: the cubic interpolating spline through data
points (scipy ``interp1d`` kind "cubic"), scipy's 1D ``zoom`` and the
bilinear ``map_coordinates``.

Port of ``pylinac_tpu/ops/interp.py``: ``cubic_spline_interp`` (``:208``)
and ``_solve_tridiagonal`` (``:183``), ``spline_filter1d`` (``:32``, the
cubic B-spline prefilter), ``_cubic_bspline_weights`` (``:98``),
``map_coordinates1d_cubic`` (``:125``),
``zoom1d`` (``:139``, mode "nearest", the one ``as_resampled`` takes) and
``map_coordinates`` (``:173``, order 1 in mode "constant", what
``BaseImage.rotate`` takes of ``jax.scipy.ndimage.map_coordinates``, and
in mode "mirror", what ACR MRI's diagonal profiles take). The profiles are a few hundred to a
few thousand points on the host. The Thomas algorithm and the prefilter's
recursions are sequential scans, as the JAX functions' ``lax.scan``: here
Python loops over float32 scalars, each step rounded to float32.
"""

from __future__ import annotations

import functools
import itertools
import math
import operator

import numpy as np
import torch

CUBIC_POLE = math.sqrt(3.0) - 2.0


def _solve_tridiagonal(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                       d: np.ndarray) -> np.ndarray:
    """Thomas algorithm on float32 sub-, main and super-diagonals ``a``,
    ``b``, ``c`` and right-hand side ``d``."""
    n = b.shape[0]
    cps = np.empty(n, np.float32)
    dps = np.empty(n, np.float32)
    cp_prev = dp_prev = np.float32(0.0)
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (d[i] - a[i] * dp_prev) / denom
        cps[i], dps[i] = cp_prev, dp_prev
    xs = np.empty(n, np.float32)
    carry = np.float32(0.0)
    for i in range(n - 1, -1, -1):
        carry = dps[i] - cps[i] * carry
        xs[i] = carry
    return xs


def cubic_spline_interp(xp: torch.Tensor, fp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Not-a-knot cubic interpolating spline through (``xp``, ``fp``),
    evaluated at ``x``: scipy ``CubicSpline(bc_type="not-a-knot")`` to
    float32 precision for n >= 4. 1D CPU tensors in, float32 out."""
    xp = xp.to(torch.float32)
    fp = fp.to(torch.float32)
    x = x.to(torch.float32)
    n = xp.shape[0]
    h = torch.diff(xp)
    slope = torch.diff(fp) / h
    a = torch.zeros(n)
    b = torch.zeros(n)
    c = torch.zeros(n)
    d = torch.zeros(n)
    # interior rows: h[i] s[i-1] + 2 (h[i-1] + h[i]) s[i] + h[i-1] s[i+1]
    a[1:n - 1] = h[1:n - 1]
    b[1:n - 1] = 2.0 * (h[:n - 2] + h[1:n - 1])
    c[1:n - 1] = h[:n - 2]
    d[1:n - 1] = 3.0 * (slope[1:n - 1] * h[:n - 2] + slope[:n - 2] * h[1:n - 1])
    # not-a-knot at the left end
    b[0] = h[1]
    c[0] = xp[2] - xp[0]
    d[0] = ((h[0] + 2.0 * (xp[2] - xp[0])) * h[1] * slope[0]
            + h[0] ** 2 * slope[1]) / (xp[2] - xp[0])
    # not-a-knot at the right end
    a[n - 1] = xp[n - 1] - xp[n - 3]
    b[n - 1] = h[n - 3]
    d[n - 1] = (h[n - 2] ** 2 * slope[n - 3]
                + (2.0 * (xp[n - 1] - xp[n - 3]) + h[n - 2]) * h[n - 3] * slope[n - 2]
                ) / (xp[n - 1] - xp[n - 3])
    s = torch.from_numpy(_solve_tridiagonal(a.numpy(), b.numpy(), c.numpy(), d.numpy()))

    # locate each x's interval, then the Hermite form
    idx = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    x0 = xp[idx]
    hi = h[idx]
    t = (x - x0) / hi
    f0, f1 = fp[idx], fp[idx + 1]
    s0, s1 = s[idx], s[idx + 1]
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * f0 + h10 * hi * s0 + h01 * f1 + h11 * hi * s1


def spline_filter1d(x: np.ndarray) -> np.ndarray:
    """The cubic B-spline coefficients of a 1D float32 array under
    "nearest" edges (``scipy.ndimage.spline_filter1d(order=3)``)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n == 1:
        return x.copy()
    p = np.float32(CUBIC_POLE)
    y = x * np.float32((1.0 - CUBIC_POLE) * (1.0 - 1.0 / CUBIC_POLE))
    c = np.empty(n, np.float32)
    # an endless run of x[0] to the left: the causal start is a geometric sum
    c[0] = y[0] / np.float32(1.0 - CUBIC_POLE)
    for i in range(1, n):
        c[i] = y[i] + p * c[i - 1]
    # the causal output past the end runs c[n-1+j] = L + p^j (c[n-1] - L) with
    # L = y[n-1] / (1 - p); the anticausal recursion summed to infinity
    lim = y[n - 1] / np.float32(1.0 - CUBIC_POLE)
    d = c[n - 1] - lim
    out = np.empty(n, np.float32)
    out[n - 1] = (-p * lim / np.float32(1.0 - CUBIC_POLE)
                  - p * d / np.float32(1.0 - CUBIC_POLE * CUBIC_POLE))
    for i in range(n - 2, -1, -1):
        out[i] = p * (out[i + 1] - c[i])
    return out


def _cubic_bspline_weights(f: np.ndarray) -> tuple[np.ndarray, ...]:
    """B-spline weights of the taps at -1, 0, 1 and 2 from the floor."""
    f2 = f * f
    f3 = f2 * f
    return ((1.0 - 3.0 * f + 3.0 * f2 - f3) / 6.0, (4.0 - 6.0 * f2 + 3.0 * f3) / 6.0,
            (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) / 6.0, f3 / 6.0)


def map_coordinates1d_cubic(coeffs: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Prefiltered cubic B-spline coefficients evaluated at float32
    coordinates, the taps clamped to the ends ("nearest")."""
    n = coeffs.shape[-1]
    coords = np.asarray(coords, np.float32)
    i = np.floor(coords).astype(np.int32)
    f = coords - i.astype(np.float32)
    out = np.zeros_like(coords, dtype=np.float32)
    for tap, wt in zip((-1, 0, 1, 2), _cubic_bspline_weights(f)):
        out = out + wt * coeffs[np.clip(i + tap, 0, n - 1)]
    return out


def zoom1d(values: np.ndarray, zoom_factor: float, order: int = 3) -> np.ndarray:
    """``scipy.ndimage.zoom`` of a 1D array with ``grid_mode=False`` and
    mode "nearest": round(n zoom) samples, output i at input coordinate
    i (n - 1) / (m - 1); float32."""
    values = np.asarray(values, np.float32)
    n = values.shape[-1]
    m = int(round(n * zoom_factor))
    if m == n and zoom_factor == 1:
        return values.copy()
    denom = (m - 1) if m > 1 else 1
    coords = np.arange(m, dtype=np.float32) * np.float32(float(n - 1) / float(denom))
    if order == 0:
        return values[np.clip(np.round(coords).astype(np.int32), 0, n - 1)]
    if order == 1:
        return np.interp(coords, np.arange(n, dtype=np.float32), values).astype(np.float32)
    if order == 3:
        # scipy pads 12 edge samples for "nearest" before the prefilter
        npad = 12
        padded = np.concatenate([np.repeat(values[:1], npad), values,
                                 np.repeat(values[-1:], npad)])
        return map_coordinates1d_cubic(spline_filter1d(padded), coords + np.float32(npad))
    raise ValueError(f"Unsupported spline order {order}")


def _mirror_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """jax's index fixer of mode "mirror" (``d c b | a b c d | c b a``): a
    triangular wave of half-period ``size - 1``, so indices more than one
    period out fold back too."""
    s = size - 1
    return torch.remainder(index + s, 2 * s).sub_(s).abs_()


def map_coordinates(image: torch.Tensor, coords: torch.Tensor,
                    mode: str = "constant") -> torch.Tensor:
    """Bilinear samples of a float ``image`` at ``coords`` (one row of
    coordinates per dim), as ``jax.scipy.ndimage.map_coordinates`` with
    order 1 and mode "constant" (0 outside) or "mirror" (indices reflected
    about the edge pixels): each corner's weight product times its pixel,
    the corners summed in order, the later ones as fused multiply-adds."""
    if mode not in ("constant", "mirror"):
        raise NotImplementedError(f"map_coordinates takes mode constant or mirror, got {mode}")
    nodes = []
    for coordinate, size in zip(coords, image.shape):
        lower = torch.floor(coordinate)
        upper_weight = coordinate - lower
        idx = lower.to(torch.int64)
        if mode == "mirror":
            nodes.append([(_mirror_index(i, size), torch.ones_like(i, dtype=torch.bool), w)
                          for i, w in ((idx, 1 - upper_weight), (idx + 1, upper_weight))])
            continue
        nodes.append([(i.clamp(0, size - 1), (i >= 0) & (i < size), w)
                      for i, w in ((idx, 1 - upper_weight), (idx + 1, upper_weight))])
    out = None
    for corner in itertools.product(*nodes):
        value = image[tuple(i for i, _, _ in corner)]
        valid = functools.reduce(operator.and_, (v for _, v, _ in corner))
        weight = functools.reduce(operator.mul, (w for _, _, w in corner))
        value = torch.where(valid, value, torch.zeros((), dtype=image.dtype))
        if out is None:
            out = weight * value
        else:
            # XLA's CPU fusion adds each later corner as one fused
            # multiply-add; float64 holds the float32 product exactly
            out = (weight.double() * value.double() + out.double()).to(out.dtype)
    return out
