"""Gamma index (PyTorch): 2D Low-2004 table-I gamma, 1D gamma, Ju et al.
geometric gamma and the Bakai approximation.

Port of ``pylinac_tpu/ops/gamma.py``: ``gamma_2d`` (``:33``) and
``gamma_2d_batch`` (``:99``), whose offset loop is the hand-written kernel of
:mod:`pylinac_tpu_torch.ops.gamma2d`; ``_interp_extrap`` (``:159``),
``gamma_1d`` (``:170``), ``_point_segment_distance2`` (``:215``),
``gamma_geometric`` (``:228``) and ``gamma_bakai`` (``:286``), which are plain
PyTorch as they were plain JAX.

The 2D gamma takes the kernel on every shape. The JAX package's
``PYLINAC_TPU_GAMMA=xla`` switch and its VMEM gate
(``pallas_gamma.gamma2d_pallas_supported``) are not carried over: on the card
the kernel has no memory limit, and a switch would route the path to the
plain twin.

Scalars enter as JAX's weakly typed scalars do: rounded to float32 first,
then each operation in float32. A division by a scalar divides by a float32
tensor on the input's device, because CUDA PyTorch multiplies by the
reciprocal of a host scalar, which can differ in the last bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.utilities import resolve_device
from .gamma2d import _check_dta, _disk_offsets, gamma2d  # noqa: F401  (_disk_offsets: the JAX module's name)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def _f32_quotient(a, b) -> float:
    """``a / b`` divided in float32, as a jitted JAX function divides two
    scalar arguments."""
    return float(np.float32(a) / np.float32(b))


def _scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``device``."""
    return torch.tensor(_f32(x), dtype=torch.float32, device=device)


def _div(x: torch.Tensor, scalar) -> torch.Tensor:
    """``x / scalar`` with the scalar rounded to float32, divided exactly."""
    return x / _scalar(scalar, x.device)


def _stage(x, device: torch.device) -> torch.Tensor:
    """``x`` (an array, a list or a tensor) copied to ``device`` in its own
    dtype, then widened to float32 there."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device).to(torch.float32)


def _gamma_2d_staged(refs: torch.Tensor, evals: torch.Tensor, dose_to_agreement: float,
                     dta: int, gamma_cap_value: float, global_dose: bool,
                     dose_threshold: float, fill_value: float) -> torch.Tensor:
    """The prologue of ``gamma_2d`` (``:48-62``) on (B, H, W) float32 tensors,
    then one :func:`gamma2d` call for the whole batch."""
    if refs.shape != evals.shape:
        raise ValueError(f"reference {tuple(refs.shape)} and evaluation "
                         f"{tuple(evals.shape)} differ in shape")
    pct = _f32_quotient(dose_to_agreement, 100.0)
    dose_ta = pct * (refs.amax(dim=(1, 2), keepdim=True) if global_dose else refs)
    ref_n = refs / dose_ta
    eval_p = F.pad((evals / dose_ta)[:, None], (dta,) * 4, mode="replicate")[:, 0]
    return gamma2d(ref_n.contiguous(), eval_p.contiguous(), dta, gamma_cap_value,
                   _f32_quotient(dose_threshold, 100.0), fill_value)


def gamma_2d(reference, evaluation, dose_to_agreement: float = 1.0,
             distance_to_agreement: int = 1, gamma_cap_value: float = 2.0,
             global_dose: bool = True, dose_threshold: float = 5.0,
             fill_value: float = float("nan"), device=None) -> torch.Tensor:
    """2D gamma per Low 2004 Table I of one (H, W) pair (reference parity:
    ``core/gamma.py:229``): float32 (H, W) on ``device``.

    ``distance_to_agreement`` is in whole pixels. ``device=None`` means CUDA,
    where the offset loop is ``csrc/gamma2d.cu``."""
    dev = resolve_device(device, "gamma_2d")
    dta = _check_dta(distance_to_agreement)
    refs, evals = _stage(reference, dev), _stage(evaluation, dev)
    if refs.dim() != 2:
        raise ValueError(f"gamma_2d takes (H, W) images, got {tuple(refs.shape)}")
    return _gamma_2d_staged(refs[None], evals[None], dose_to_agreement, dta,
                            gamma_cap_value, global_dose, dose_threshold, fill_value)[0]


def gamma_2d_batch(references, evaluations, dose_to_agreement: float = 1.0,
                   distance_to_agreement: int = 1, gamma_cap_value: float = 2.0,
                   global_dose: bool = True, dose_threshold: float = 5.0,
                   fill_value: float = float("nan"), mesh=None, device=None) -> torch.Tensor:
    """Batched 2D gamma over (B, H, W) reference/evaluation pairs: float32
    (B, H, W) on ``device``, each pair as :func:`gamma_2d`.

    Host arrays go to the device once each in their own dtype (uint16 frames
    move half the bytes of float32) and widen there; the whole batch then
    runs in one kernel launch. ``mesh`` is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "gamma_2d_batch(mesh=...) is not ported: multi-device sharding waits for "
            "the 'Multi-device' item of ROADMAP.md")
    dev = resolve_device(device, "gamma_2d_batch")
    dta = _check_dta(distance_to_agreement)
    refs, evals = _stage(references, dev), _stage(evaluations, dev)
    if refs.dim() != 3:
        raise ValueError(f"gamma_2d_batch takes (B, H, W) stacks, got {tuple(refs.shape)}")
    return _gamma_2d_staged(refs, evals, dose_to_agreement, dta, gamma_cap_value,
                            global_dose, dose_threshold, fill_value)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in its own float32 steps: clamped to the
    end values outside ``xp``."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_extrap(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation with linear extrapolation beyond the ends
    (scipy interp1d fill_value='extrapolate' semantics)."""
    inner = _interp(x, xp, fp)
    left_slope = (fp[1] - fp[0]) / (xp[1] - xp[0])
    right_slope = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
    out = torch.where(x < xp[0], fp[0] + (x - xp[0]) * left_slope, inner)
    return torch.where(x > xp[-1], fp[-1] + (x - xp[-1]) * right_slope, out)


def gamma_1d(reference, evaluation, reference_coordinates=None, evaluation_coordinates=None,
             dose_to_agreement: float = 1.0, distance_to_agreement: float = 1,
             gamma_cap_value: float = 2.0, global_dose: bool = True,
             dose_threshold: float = 5.0, resolution_factor: int = 3,
             fill_value: float = float("nan"),
             device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Low Table-I 1D gamma with coordinate support (reference
    ``core/gamma.py:333``): for each reference point, the linearly
    interpolated evaluation at ``2·DTA·rf + 1`` points in the DTA window,
    min-reduced. Returns (gamma, eval_interp_values, eval_interp_x) on
    ``device``."""
    dev = resolve_device(device, "gamma_1d")
    reference, evaluation = _stage(reference, dev), _stage(evaluation, dev)
    n = reference.shape[0]
    ref_x = (torch.arange(n, dtype=torch.float32, device=dev) if reference_coordinates is None
             else _stage(reference_coordinates, dev))
    eval_x = (torch.arange(evaluation.shape[0], dtype=torch.float32, device=dev)
              if evaluation_coordinates is None else _stage(evaluation_coordinates, dev))

    ref_max = reference.max()
    threshold = _div(ref_max, 100.0) * _f32(dose_threshold)
    num = int(distance_to_agreement * resolution_factor * 2 + 1)
    # np.linspace's float64 points rounded to float32. jnp.linspace works in
    # float32 and XLA rewrites it (a reciprocal, fused multiply-adds), so its
    # points can differ from these in the last bit unless they are dyadic.
    offsets = torch.linspace(-distance_to_agreement, distance_to_agreement, num,
                             dtype=torch.float64, device=dev).to(torch.float32)
    eval_xs = ref_x[:, None] + offsets[None, :]  # (n, num)
    eval_vals = _interp_extrap(eval_xs, eval_x, evaluation)

    dist = offsets.abs()[None, :]
    dose = reference[:, None] - eval_vals
    # dose_to_agreement / 100.0 is a Python double in the JAX function
    pct = _f32(dose_to_agreement / 100.0)
    dose_ta = pct * ref_max if global_dose else pct * reference[:, None]
    capital_gamma = torch.sqrt(_div(dist * dist, distance_to_agreement ** 2)
                               + (dose * dose) / (dose_ta * dose_ta))
    gamma = torch.minimum(capital_gamma.amin(dim=1), _scalar(gamma_cap_value, dev))
    gamma = torch.where(reference < threshold, _scalar(fill_value, dev), gamma)
    return gamma, eval_vals.ravel(), eval_xs.ravel()


def _point_segment_distance2(px, py, x1, y1, x2, y2):
    """Squared distance from point to a segment (vectorized)."""
    vx = x2 - x1
    vy = y2 - y1
    wx = px - x1
    wy = py - y1
    seg_len2 = vx * vx + vy * vy
    t = torch.clamp((wx * vx + wy * vy) / torch.clamp(seg_len2, min=1e-20), 0.0, 1.0)
    dx = wx - t * vx
    dy = wy - t * vy
    return dx * dx + dy * dy


def gamma_geometric(reference, evaluation, reference_coordinates=None,
                    evaluation_coordinates=None, dose_to_agreement: float = 1.0,
                    distance_to_agreement: float = 1.0, gamma_cap_value: float = 2.0,
                    dose_threshold: float = 5.0, fill_value: float = float("nan"),
                    device=None) -> torch.Tensor:
    """Ju et al. geometric 1D gamma (reference ``core/gamma.py:105``): the
    distance of every (x, D) reference point to every evaluation polyline
    segment inside the DTA window, min-reduced."""
    dev = resolve_device(device, "gamma_geometric")
    reference, evaluation = _stage(reference, dev), _stage(evaluation, dev)
    n, m = reference.shape[0], evaluation.shape[0]
    ref_c = (torch.arange(n, dtype=torch.float32, device=dev) if reference_coordinates is None
             else _stage(reference_coordinates, dev))
    eval_c = (torch.arange(m, dtype=torch.float32, device=dev) if evaluation_coordinates is None
              else _stage(evaluation_coordinates, dev))

    threshold = _f32(dose_threshold / dose_to_agreement)
    ref_max = reference.max()
    scale = ref_max * _f32(dose_to_agreement)
    ref_n = reference * 100.0 / scale
    eval_n = evaluation * 100.0 / scale
    ref_x = _div(ref_c, distance_to_agreement)
    eval_x = _div(eval_c, distance_to_agreement)

    # the reference's vertex window: argmin of |eval_x - (ref_x -+ DTA)|,
    # widened by one each side; descending coordinates swap the bounds
    desc = bool(eval_x[-1] < eval_x[0])
    lo_diffs = (eval_x[None, :] - (ref_x[:, None] - _f32(distance_to_agreement))).abs()
    hi_diffs = (eval_x[None, :] - (ref_x[:, None] + _f32(distance_to_agreement))).abs()
    left_diffs, right_diffs = (hi_diffs, lo_diffs) if desc else (lo_diffs, hi_diffs)
    left_idx = (left_diffs.argmin(dim=1) - 1).clamp(min=0)
    right_idx = (right_diffs.argmin(dim=1) + 1).clamp(max=m - 1)

    seg_ids = torch.arange(m - 1, device=dev)
    seg_mask = (seg_ids[None, :] >= left_idx[:, None]) & (seg_ids[None, :] <= right_idx[:, None] - 1)
    d2 = _point_segment_distance2(
        ref_x[:, None], ref_n[:, None],
        eval_x[None, :-1], eval_n[None, :-1],
        eval_x[None, 1:], eval_n[None, 1:],
    )
    d2 = torch.where(seg_mask, d2, torch.inf)
    gamma = torch.minimum(torch.sqrt(d2.amin(dim=1)), _scalar(gamma_cap_value, dev))
    return torch.where(ref_n < threshold, _scalar(fill_value, dev), gamma)


def gamma_bakai(reference, evaluation, dpmm: float, doseTA: float = 1.0, distTA: float = 1.0,
                threshold: float = 0.1, ground: bool = True, normalize: bool = True,
                device=None) -> torch.Tensor:
    """Bakai et al. 2003 gamma approximation on images (the reference's
    ``BaseImage.gamma``, ``core/image.py:929-1018``): Sobel gradient, distTA
    in pixels, below-threshold reference pixels NaN'd before the
    gradient."""
    from .filters import sobel

    dev = resolve_device(device, "gamma_bakai")
    ref, ev = _stage(reference, dev), _stage(evaluation, dev)
    if ground:
        ref = ref - ref.min()
        ev = ev - ev.min()
    if normalize:
        ref = ref / ref.max()
        ev = ev / ev.max()

    ref = torch.where(ref < _f32(threshold) * ref.max(), torch.nan, ref)
    distTA_pixels = dpmm * distTA
    grad_img = torch.hypot(sobel(ref, dim=1), sobel(ref, dim=0))
    denominator = torch.sqrt(_f32((doseTA / 100.0) ** 2)
                             + _f32(distTA_pixels ** 2) * (grad_img * grad_img))
    return (ev - ref).abs() / denominator
