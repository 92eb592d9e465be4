"""Nelder-Mead, Levenberg-Marquardt and the Hill sigmoid in plain PyTorch.

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

``levenberg_marquardt`` (``:110-143``), ``hill_func`` (``:146``),
``hill_fit`` (``:151``), ``hill_inflection`` (``:171``), ``hill_gradient``
(``:177``) and ``hill_x_at_y`` (``:182``) take a leading problem dim where
the JAX functions were ``vmap``-ed: the field analysis fits every Hill edge
of a batch in one solve, on the card, with no host sync. The solver runs
a fixed number of iterations, as ``lax.scan`` did. Its Jacobian is
forward mode, as ``jax.jacfwd``: the problems stacked once a parameter,
each copy carrying that parameter's tangent as a dual number, which gives
``torch.func.jacfwd``'s columns bit for bit in one pass; its sums are
:func:`pylinac_tpu_torch.ops.stats.wide_sum` and its 4x4 solve is in
float64, so that the CPU and the card take the same steps.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

from .stats import wide_sum


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


def _jacobian(residual_fn: Callable, p: torch.Tensor, args_n: list[torch.Tensor],
              tangents: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The residuals (P, m) of P problems and their Jacobian (P, m, n), in
    forward mode: the problems stacked n times, copy j carrying the tangent
    of parameter j as a dual number, so one pass gives every column. The
    arithmetic is ``torch.func.jacfwd``'s (and ``jax.jacfwd``'s), column by
    column; ``args_n`` and ``tangents`` are the stacked arguments and the
    (nP, n) unit tangents."""
    P, n = p.shape
    with fwAD.dual_level():
        out = residual_fn(fwAD.make_dual(p.repeat(n, 1), tangents), *args_n)
        r, tangent = fwAD.unpack_dual(out)
    return r[:P], tangent.reshape(n, P, -1).permute(1, 2, 0)


def _stack_problems(args, n: int) -> list[torch.Tensor]:
    return [a.repeat(n, *([1] * (a.dim() - 1))) for a in args]


def _unit_tangents(P: int, n: int, device) -> torch.Tensor:
    return torch.eye(n, device=device).repeat_interleave(P, 0)


def levenberg_marquardt(residual_fn: Callable, p0: torch.Tensor, *args: torch.Tensor,
                        n_iter: int = 50, lambda0: float = 1e-3) -> torch.Tensor:
    """Damped least squares of P problems at once, for a fixed ``n_iter``
    steps with multiplicative damping (scipy ``curve_fit``'s default
    method for the small fits QA uses).

    ``residual_fn(p, *args)`` maps (P, n) parameters and ``args`` with a
    leading dim P to (P, m) residuals, each problem's row from its own row
    of each; ``p0`` is (P, n). A step is kept when it lowers the sum of
    squares. Returns the (P, n) float32 parameters."""
    p = p0.to(torch.float32)
    P, n = p.shape
    args_n = _stack_problems(args, n)
    tangents = _unit_tangents(P, n, p.device)
    lam = torch.full((P,), lambda0, dtype=torch.float32, device=p.device)
    for _ in range(n_iter):
        r, J = _jacobian(residual_fn, p, args_n, tangents)          # (P, m), (P, m, n)
        JtJ = wide_sum(J[:, :, :, None] * J[:, :, None, :], 1)      # (P, n, n)
        g = wide_sum(J * r[:, :, None], 1)                          # (P, n)
        damp = torch.diag_embed(torch.diagonal(JtJ, dim1=1, dim2=2) + 1e-12)
        A = JtJ + lam[:, None, None] * damp
        dp = torch.linalg.solve_ex(A.to(torch.float64), g.to(torch.float64)[:, :, None],
                                   check_errors=False)[0][:, :, 0].to(torch.float32)
        p_new = p - dp
        cost_old = wide_sum(r * r, 1)
        r_new = residual_fn(p_new, *args)
        cost_new = wide_sum(r_new * r_new, 1)
        improved = cost_new < cost_old
        p = torch.where(improved[:, None], p_new, p)
        lam = torch.where(improved, lam * 0.3, lam * 3.0).clamp(1e-10, 1e10)
    return p


def hill_func(x, a, b, c, d):
    """4-param sigmoid a + (b-a) / (1 + (c/x)**d) (reference ``core/hill.py:68``)."""
    return a + (b - a) / (1.0 + (c / x) ** d)


def hill_params(p: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The (P, 1) columns a, b, c, d of (P, 4) Hill parameters."""
    return p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]


def _hill_residual(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return hill_func(x, *hill_params(p)) - y


def hill_fit(x: torch.Tensor, y: torch.Tensor, n_iter: int = 60) -> torch.Tensor:
    """Fit the 4-param Hill sigmoid to each row of (P, m) ``x`` and ``y``;
    returns (P, 4) params (a, b, c, d). The initial guess is the
    reference's (``core/hill.py:22``): a = min, b = max, c = the middle x,
    d = +-10 by the slope's direction."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    slope_up = y[:, -1] > y[:, 0]
    p0 = torch.stack([y.amin(dim=1), y.amax(dim=1), x[:, x.shape[1] // 2],
                      torch.where(slope_up, 10.0, -10.0)], dim=1)
    return levenberg_marquardt(_hill_residual, p0, x, y, n_iter=n_iter)


def hill_inflection(params: torch.Tensor) -> torch.Tensor:
    """Analytic inflection x of each (.., 4) Hill sigmoid (reference
    ``core/hill.py:31``)."""
    c, d = params[..., 2], params[..., 3]
    return c * ((d - 1.0) / (d + 1.0)) ** (1.0 / d)


def hill_gradient(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dy/dx of each (P, 4) Hill function at its (P,) x, by
    ``torch.func.grad`` as the JAX function took ``jax.grad``."""
    def f(xx, pp):
        return hill_func(xx, pp[0], pp[1], pp[2], pp[3])

    return torch.func.vmap(torch.func.grad(f))(x, params)


def hill_x_at_y(params: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inverse of each (.., 4) Hill function at y (reference ``core/hill.py:55``)."""
    a, b, c, d = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    return c * ((y - a) / (b - y)) ** (1.0 / d)
