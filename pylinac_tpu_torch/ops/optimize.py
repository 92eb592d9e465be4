"""Nelder-Mead, Levenberg-Marquardt and the Hill sigmoid in plain PyTorch.

Port of ``nelder_mead`` (``pylinac_tpu/ops/optimize.py:26-108``), step for
step in float32: scipy's initial simplex, the reflect / expand / contract /
shrink decisions, a stable sort of the simplex each iteration, and the
``xatol`` and ``fatol`` termination. The JAX function runs as a
``lax.while_loop``; here it is a Python loop. Its two forms round as XLA
compiles them on the CPU (:func:`pylinac_tpu_torch.ops.stats.fma_f32` for
each fused multiply-add):

- ``nelder_mead``, the unvmapped call (Winston-Lutz ``_minimize_axis``,
  the single-image starshot). JAX runs it eagerly: the initial simplex op
  by op, then the loop as one compiled computation. XLA there folds the
  centroid's ``1 / n`` into each trial point's coefficient, so the points
  are ``S * k + b * worst`` of the sum ``S`` of the n best vertices, added
  in order, with ``S * k`` fused: k = fl(2/n), fl(3/n), fl(1.5/n) and
  fl(0.5/n) for the reflection, expansion and the outer and inner
  contractions (for n = 3, ``S * 1.0`` drops out of the expansion). The
  caller's objective is inlined into that loop, and its fused form
  serves the initial simplex too.
- ``nelder_mead_batch``, the vmapped call inside the jitted starshot
  pipeline (``pylinac_tpu/ops/star_pipeline.py:163``). XLA folds ``1 / n``
  there too; for the starshot's n = 2 it is exact, and this function's
  mean-based points (the expansion and outer contraction fused) give the
  same bits. With the starshot's distance written the same way it gives
  ``jax.vmap(nelder_mead)``'s bits on the star lines. For n = 2 both forms
  give the same points.

Callers run it on CPU tensors. Its users, the Winston-Lutz isocentre fit
(a 3-parameter minimax over a dozen rays) and the single-image starshot's
wobble, are tiny: on the card each iteration's dozen launches and the host
sync of its termination test would cost more than the whole fit. That is
host placement, not a fallback: the image work stays on the card.

``nelder_mead_batch`` is the same method over a leading problem dim, as
``jax.vmap(nelder_mead)`` ran it in the starshot pipeline
(``pylinac_tpu/ops/star_pipeline.py:163``): a problem that meets its
tolerances freezes while the others go on, as a batched
``lax.while_loop`` freezes it, so each problem takes the same steps, bit
for bit, as it would alone (and as :func:`nelder_mead` for n = 2). The
host reads the all-done flag only every ``_SYNC_EVERY`` = 16 iterations;
frozen problems do not move, so that number changes no result. The
starshot pipeline runs it on CPU tensors too (``ops/star_pipeline.py``,
measured there).

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

import warnings
from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

from .stats import fma_f32, wide_sum


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
    # the centroid's 1 / n folded into each trial point's coefficient
    inv_n = torch.tensor(1.0, dtype=torch.float32) / n
    k_r, k_e, k_c, k_cc = (float(torch.tensor(a, dtype=torch.float32) * inv_n)
                           for a in (1 + rho, 1 + rho * chi, 1 + psi * rho, 1 - psi))

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
        total = torch.zeros(n, dtype=torch.float32)
        for vertex in sim[:-1]:
            total = total + vertex
        worst = sim[-1]
        xr = fma_f32(total, k_r, -(rho * worst))
        fxr = f(xr)
        xe = fma_f32(total, k_e, -(rho * chi * worst))
        fxe = f(xe)
        xc = fma_f32(total, k_c, -(psi * rho * worst))
        fxc = f(xc)
        xcc = fma_f32(total, k_cc, psi * worst)
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


# iterations of nelder_mead_batch between reads of its all-done flag
_SYNC_EVERY = 16


def nelder_mead_batch(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    max_iter: int = 200,
    nonzdelt: float = 0.05,
    zdelt: float = 0.00025,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimise P problems from their (P, n) starts ``x0``; returns the
    (P, n) best points and (P,) best values.

    ``f`` maps (P, m, n) float32 points, m of them a problem, to (P, m)
    values, each problem's row by its own function; it runs on the device
    of ``x0``. The arithmetic is the vmapped form's (module docstring)."""
    x0 = x0.to(torch.float32)
    P, n = x0.shape
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5
    ar = torch.arange(P, device=x0.device)

    # scipy's initial simplex
    sim = x0[:, None, :].repeat(1, n + 1, 1)
    for k in range(n):
        sim[:, k + 1, k] = torch.where(x0[:, k] != 0, x0[:, k] * (1 + nonzdelt),
                                       torch.tensor(zdelt, dtype=torch.float32, device=x0.device))
    fsim = f(sim)                                              # (P, n + 1)

    def sort_simplex(sim, fsim):
        order = torch.argsort(fsim, dim=1, stable=True)
        return sim[ar[:, None], order], fsim.gather(1, order)

    sim, fsim = sort_simplex(sim, fsim)
    done = torch.zeros(P, dtype=torch.bool, device=x0.device)
    for i in range(max_iter):
        xtol_ok = torch.abs(sim[:, 1:] - sim[:, :1]).amax(dim=(1, 2)) <= xatol
        ftol_ok = torch.abs(fsim[:, :1] - fsim[:, 1:]).amax(dim=1) <= fatol
        done = done | (xtol_ok & ftol_ok)
        if i % _SYNC_EVERY == 0 and bool(done.all()):
            break
        xbar = torch.mean(sim[:, :-1], dim=1)                  # (P, n)
        worst = sim[:, -1]
        xr = (1 + rho) * xbar - rho * worst
        xe = fma_f32(xbar, 1 + rho * chi, -(rho * chi * worst))
        xc = fma_f32(xbar, 1 + psi * rho, -(psi * rho * worst))
        xcc = (1 - psi) * xbar + psi * worst
        fxr, fxe, fxc, fxcc = f(torch.stack([xr, xe, xc, xcc], dim=1)).unbind(1)

        # scipy's decision tree, as the JAX function's masks
        best, second, last = fsim[:, 0], fsim[:, -2], fsim[:, -1]
        use_expand = (fxr < best) & (fxe < fxr)
        use_reflect = ((fxr < best) & (fxe >= fxr)) | ((fxr >= best) & (fxr < second))
        use_contract_out = (fxr >= second) & (fxr < last) & (fxc <= fxr)
        use_contract_in = (fxr >= second) & (fxr >= last) & (fxcc < last)
        did_replace = use_expand | use_reflect | use_contract_out | use_contract_in

        def pick(e, r, c, cc):
            return torch.where(use_expand[:, None], e, torch.where(
                use_reflect[:, None], r, torch.where(use_contract_out[:, None], c, cc)))

        new_pt = pick(xe, xr, xc, xcc)
        new_f = pick(fxe[:, None], fxr[:, None], fxc[:, None], fxcc[:, None])
        sim_replaced = torch.cat([sim[:, :-1], new_pt[:, None]], dim=1)
        fsim_replaced = torch.cat([fsim[:, :-1], new_f], dim=1)
        # shrink toward the best vertex when no acceptable point was found
        sim_shrunk = sim[:, :1] + sigma * (sim - sim[:, :1])
        fsim_shrunk = f(sim_shrunk)
        sim_next = torch.where(did_replace[:, None, None], sim_replaced, sim_shrunk)
        fsim_next = torch.where(did_replace[:, None], fsim_replaced, fsim_shrunk)
        sim_next, fsim_next = sort_simplex(sim_next, fsim_next)
        sim = torch.where(done[:, None, None], sim, sim_next)
        fsim = torch.where(done[:, None], fsim, fsim_next)
    return sim[:, 0], fsim[:, 0]


def _jacobian(residual_fn: Callable, p: torch.Tensor, args_n: list[torch.Tensor],
              tangents: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The residuals (P, m) of P problems and their Jacobian (P, m, n), in
    forward mode: the problems stacked n times, copy j carrying the tangent
    of parameter j as a dual number, so one pass gives every column. The
    arithmetic is ``torch.func.jacfwd``'s (and ``jax.jacfwd``'s), column by
    column; ``args_n`` and ``tangents`` are the stacked arguments and the
    (nP, n) unit tangents."""
    P, n = p.shape
    with fwAD.dual_level(), warnings.catch_warnings():
        # torch loads its forward-mode decompositions at the first dual
        # number and newer releases warn there that torch.jit.script is
        # deprecated: a warning of torch's, not of the analysis
        warnings.filterwarnings("ignore", message=".*torch.jit.script.*",
                                category=DeprecationWarning)
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
