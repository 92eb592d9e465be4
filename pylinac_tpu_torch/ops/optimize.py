"""Nelder-Mead simplex minimisation in plain PyTorch.

Port of ``nelder_mead`` (``pylinac_tpu/ops/optimize.py:26-108``), step for
step in float32: scipy's initial simplex, the reflect / expand / contract /
shrink decisions, a stable sort of the simplex each iteration, and the
``xatol`` and ``fatol`` termination. The JAX function ran as a
``lax.while_loop`` inside a jitted pipeline; here it is a Python loop.

Callers run it on CPU tensors. Its one user, the Winston-Lutz isocentre
fit, is a 3-parameter minimax over a dozen rays: on the card each
iteration's dozen launches and the host sync of its termination test would
cost more than the whole fit. That is host placement, not a fallback: the
image work (fills, BB scan) stays on the card.

``levenberg_marquardt`` and ``hill_fit`` wait for the slices that use them.
"""

from __future__ import annotations

from typing import Callable

import torch


def nelder_mead(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    max_iter: int = 200,
    nonzdelt: float = 0.05,
    zdelt: float = 0.00025,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimise ``f`` from ``x0``; returns (x_best, f_best).

    ``f`` maps an (n,) float32 tensor to a scalar tensor. Stops after
    ``max_iter`` iterations or when every vertex is within ``xatol`` of the
    best and every value within ``fatol`` of the best."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    n = x0.shape[0]
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5

    # scipy's initial simplex
    pts = [x0]
    for k in range(n):
        y = x0.clone()
        y[k] = torch.where(x0[k] != 0, x0[k] * (1 + nonzdelt),
                           torch.tensor(zdelt, dtype=torch.float32))
        pts.append(y)
    sim = torch.stack(pts)                                    # (n + 1, n)
    fsim = torch.stack([f(p) for p in sim])

    def sort_simplex(sim, fsim):
        order = torch.argsort(fsim, stable=True)
        return sim[order], fsim[order]

    sim, fsim = sort_simplex(sim, fsim)
    for _ in range(max_iter):
        xtol_ok = torch.max(torch.abs(sim[1:] - sim[0])) <= xatol
        ftol_ok = torch.max(torch.abs(fsim[0] - fsim[1:])) <= fatol
        if bool(xtol_ok & ftol_ok):
            break
        xbar = torch.mean(sim[:-1], dim=0)
        xr = (1 + rho) * xbar - rho * sim[-1]
        fxr = f(xr)
        xe = (1 + rho * chi) * xbar - rho * chi * sim[-1]
        fxe = f(xe)
        xc = (1 + psi * rho) * xbar - psi * rho * sim[-1]
        fxc = f(xc)
        xcc = (1 - psi) * xbar + psi * sim[-1]
        fxcc = f(xcc)

        # scipy's decision tree, as the JAX function's masks
        use_expand = bool((fxr < fsim[0]) & (fxe < fxr))
        use_reflect = bool(((fxr < fsim[0]) & (fxe >= fxr))
                           | ((fxr >= fsim[0]) & (fxr < fsim[-2])))
        use_contract_out = bool((fxr >= fsim[-2]) & (fxr < fsim[-1]) & (fxc <= fxr))
        use_contract_in = bool((fxr >= fsim[-2]) & (fxr >= fsim[-1]) & (fxcc < fsim[-1]))
        if use_expand or use_reflect or use_contract_out or use_contract_in:
            if use_expand:
                new_pt, new_f = xe, fxe
            elif use_reflect:
                new_pt, new_f = xr, fxr
            elif use_contract_out:
                new_pt, new_f = xc, fxc
            else:
                new_pt, new_f = xcc, fxcc
            sim = torch.cat([sim[:-1], new_pt[None]])
            fsim = torch.cat([fsim[:-1], new_f[None]])
        else:
            # shrink toward the best vertex when no acceptable point was found
            sim = sim[0] + sigma * (sim - sim[0])
            fsim = torch.stack([f(p) for p in sim])
        sim, fsim = sort_simplex(sim, fsim)
    return sim[0], fsim[0]
