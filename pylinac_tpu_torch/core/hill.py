"""A fitted Hill (4-parameter sigmoid) curve.

Port of ``pylinac_tpu/core/hill.py`` (``hill_func`` ``:11``,
``inv_hill_func`` ``:16``, ``math_pow`` ``:23``, ``Hill`` ``:27``). The fit
runs :func:`pylinac_tpu_torch.ops.optimize.hill_fit` on CPU tensors: one
profile edge holds a few dozen points, as the JAX package's ``route.put``
kept such arrays on its CPU backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import optimize


def hill_func(x, a, b, c, d):
    """a + (b-a) / (1 + (c/x)**d)"""
    return a + (b - a) / (1 + (c / x) ** d)


def inv_hill_func(y, fit_params) -> float:
    a, b, c, d = fit_params
    if (y > min(a, b)) and (y < max(a, b)) and (d != 0):
        return c * math_pow((y - a) / (b - y), 1 / d)
    return 0.0


def math_pow(base, exp):
    return float(np.sign(base) * (np.abs(base) ** exp))


class Hill:
    """A fitted Hill sigmoid."""

    def __init__(self, params: np.ndarray):
        self.params = np.asarray(params, dtype=float)

    @classmethod
    def fit(cls, x_data: np.ndarray, y_data: np.ndarray) -> "Hill":
        x = torch.from_numpy(np.asarray(x_data, np.float32))[None]
        y = torch.from_numpy(np.asarray(y_data, np.float32))[None]
        return cls(optimize.hill_fit(x, y)[0].numpy())

    @classmethod
    def from_params(cls, params) -> "Hill":
        return cls(np.asarray(params))

    def inflection_idx(self) -> dict:
        """Analytic inflection point of the sigmoid."""
        a, b, c, d = self.params
        idx = c * ((d - 1) / (d + 1)) ** (1 / d)
        return {"index (exact)": float(idx), "index (rounded)": int(round(idx))}

    def gradient_at(self, x: float) -> float:
        """Analytic dy/dx at x."""
        a, b, c, d = self.params
        cxd = (c / x) ** d
        return float((b - a) * d * cxd / (x * (cxd + 1) ** 2))

    def x(self, y: float) -> float:
        """Inverse: x at the given y."""
        a, b, c, d = self.params
        return float(c * ((y - a) / (b - y)) ** (1 / d))

    def y(self, x: float) -> float:
        a, b, c, d = self.params
        return float(hill_func(x, a, b, c, d))
