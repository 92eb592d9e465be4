"""Cubic interpolating spline through data points (scipy ``interp1d``
kind "cubic"), in float32.

Port of ``cubic_spline_interp`` (``pylinac_tpu/ops/interp.py:208``) and
``_solve_tridiagonal`` (``:183``). The single-image field analysis resamples
its profiles with it under ``Interpolation.SPLINE``; a profile is a few
hundred to a few thousand points on the host. The Thomas algorithm is a
sequential scan, as the JAX function's ``lax.scan``: here a Python loop
over float32 scalars, each step rounded to float32.
"""

from __future__ import annotations

import numpy as np
import torch


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
