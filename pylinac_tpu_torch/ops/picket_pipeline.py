"""Batched picket fence pipeline: whole-batch MLC analysis on the card.

Port of ``pylinac_tpu/ops/picket_pipeline.py``: ``PFLeafConfig`` ``:38``,
``PFParams`` ``:48``, ``preprocess_pf_image`` ``:62``, ``_masked_median``
``:123``, ``_compact_valid`` ``:137``, ``_fit_line`` ``:148``,
``picket_fence_image`` ``:161`` and ``picket_fence_batch`` ``:338``.

The JAX functions analysed one image and were ``vmap``-ed over chunks under
``lax.map``; here every function takes the image batch as its leading dim,
and :func:`picket_fence_batch` loops over chunks of ``chunk`` images to bound
the (chunk, L, K_P, H_MAX, W_MAX) window workspace. The de-spike
``while_loop`` is a Python loop whose 3x3 median is the hand-written kernel
(:func:`pylinac_tpu_torch.ops.median.median3x3`).

Canonical orientation is UP-DOWN (pickets along columns, leaves along rows);
the host API transposes LEFT-RIGHT images before staging the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .filters import _median_general
from .median import median3x3
from .peaks import compact_slots, main_peak, main_peak_ips, peak_analysis, select_top
from .stats import percentile_exact

_F32 = torch.float32
_MAX_DESPIKE_PASSES = 5      # the reference's safety stop (picketfence.py:115)
_MIN_DISTANCE_FRAC = 0.02    # picket peak separation, as a fraction of the width


class PFLeafConfig(NamedTuple):
    """Leaf window geometry shared by every image of the batch."""

    tops: torch.Tensor         # (L,) int64 window top row (incl.)
    heights: torch.Tensor      # (L,) int64 window row count
    centers_px: torch.Tensor   # (L,) f32 leaf centre row (px)
    widths_px: torch.Tensor    # (L,) f32 leaf width (px)


class PFParams(NamedTuple):
    """Analysis parameters shared by the batch: 0-dim float32 tensors, and a
    Python bool for ``invert``."""

    height_threshold: torch.Tensor
    edge_threshold: torch.Tensor
    required_prominence: torch.Tensor
    fwxm: torch.Tensor               # e.g. 50.0
    dpmm: torch.Tensor
    cax_col: torch.Tensor            # image centre column ((W/2) - 0.5)
    analysis_ratio: torch.Tensor     # leaf_analysis_width_ratio
    nominal_gap_px: torch.Tensor     # nominal_gap_mm / 2 * dpmm (separate leaves)
    invert: bool = False             # explicit user inversion


def leaf_config_from_numpy(cfg, device) -> PFLeafConfig:
    """A :class:`PFLeafConfig` from any object with the JAX config's fields
    (``pylinac_tpu.ops.picket_pipeline.PFLeafConfig``), read as numpy."""
    return PFLeafConfig(
        tops=torch.tensor(np.asarray(cfg.tops, np.int64), device=device),
        heights=torch.tensor(np.asarray(cfg.heights, np.int64), device=device),
        centers_px=torch.tensor(np.asarray(cfg.centers_px, np.float32), device=device),
        widths_px=torch.tensor(np.asarray(cfg.widths_px, np.float32), device=device))


def params_from_numpy(params, device) -> PFParams:
    """A :class:`PFParams` from any object with the JAX params' fields
    (``pylinac_tpu.ops.picket_pipeline.PFParams``), read as numpy."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return PFParams(*(f32(getattr(params, name)) for name in PFParams._fields[:-1]),
                    invert=bool(np.asarray(params.invert)))


def _has_noise(a: torch.Tensor) -> torch.Tensor:
    """(B,) the reference's spike test: max beyond 1.25x the 99.5th
    percentile, or an extreme min (``picket_pipeline.py:80-92``)."""
    vmin, vmax = a.amin(dim=(1, 2)), a.amax(dim=(1, 2))
    near = percentile_exact(a, (0.5, 99.5))
    near_min, near_max = near[:, 0], near[:, 1]
    max_is_extreme = vmax > near_max * 1.25
    min_is_extreme = (vmin < near_min * 0.75) & (
        (vmin - near_min).abs() > 0.1 * (near_max - near_min))
    return max_is_extreme | min_is_extreme


def _despike(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3-median each (B, H, W) float32 image while it is spiky, at most
    5 times. Returns (images, passes per image).

    A vmapped ``while_loop`` freezes each image once its own condition
    fails; here an image leaves ``active`` for good at that point."""
    active = torch.ones(img.shape[0], dtype=torch.bool, device=img.device)
    passes = torch.zeros(img.shape[0], dtype=torch.int32, device=img.device)
    for _ in range(_MAX_DESPIKE_PASSES):
        active &= _has_noise(img)
        if not bool(active.any()):
            break
        img = torch.where(active[:, None, None], median3x3(img), img)
        passes += active.to(torch.int32)
    return img, passes


def preprocess_pf_image(img: torch.Tensor, *, extra_filter: int = 0,
                        invert: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) conditioning on the card: de-spike, corner-sample inversion
    check, optional extra median, ground and normalise. Returns (images,
    de-spike passes per image)."""
    img = img.to(_F32).contiguous()
    B, H, W = img.shape
    img, passes = _despike(img)

    # corner-sample inversion check (box_size=10, position=(0.01, 0.01))
    rp, cp, b = max(int(0.01 * H), 1), max(int(0.01 * W), 1), 10
    corners = torch.stack([
        img[:, rp:rp + b, cp:cp + b], img[:, rp:rp + b, W - cp - b:W - cp],
        img[:, H - rp - b:H - rp, cp:cp + b],
        img[:, H - rp - b:H - rp, W - cp - b:W - cp]], dim=1)
    do_inv = corners.mean(dim=(1, 2, 3)) > img.mean(dim=(1, 2))
    do_inv = do_inv ^ bool(invert)
    vmin = img.amin(dim=(1, 2), keepdim=True)
    vmax = img.amax(dim=(1, 2), keepdim=True)
    img = torch.where(do_inv[:, None, None], -img + vmax + vmin, img)

    if extra_filter > 1:
        img = torch.stack([_median_general(im, extra_filter) for im in img])

    img = img - img.amin(dim=(1, 2), keepdim=True)
    return img / img.amax(dim=(1, 2), keepdim=True), passes


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """np.median over the masked entries of the LAST dim (count-dependent
    middle pair, as numpy)."""
    s = torch.where(mask, values, float("inf")).sort(dim=-1).values
    cnt = mask.sum(dim=-1)
    lo = ((cnt - 1) // 2).clamp(min=0)
    hi = (cnt // 2).clamp(min=0)
    a = s.gather(-1, lo.expand(s.shape[:-1])[..., None])[..., 0]
    b = s.gather(-1, hi.expand(s.shape[:-1])[..., None])[..., 0]
    return (a + b) / 2.0


def _compact_valid(values: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Move the valid entries of each row to the front, keeping their order;
    the tail is +inf. Returns (values, count)."""
    K = values.shape[-1]
    ar = torch.arange(K, device=values.device)
    order = torch.argsort(torch.where(valid, ar, K + ar), dim=-1)
    n = valid.sum(dim=-1)
    out = torch.where(ar < n[..., None], values.gather(-1, order), float("inf"))
    return out, n


def _fit_line(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares line y = a*x + b over the last dim (centred
    for float32 stability). Returns (..., 2) = (a, b); zero-weight-safe."""
    wsum = w.sum(dim=-1).clamp(min=1e-9)
    xm = (w * x).sum(dim=-1) / wsum
    ym = (w * y).sum(dim=-1) / wsum
    dx = x - xm[..., None]
    var = (w * dx * dx).sum(dim=-1)
    cov = (w * dx * (y - ym[..., None])).sum(dim=-1)
    a = torch.where(var > 1e-12, cov / var.clamp(min=1e-12), 0.0)
    return torch.stack([a, ym - a * xm], dim=-1)


def picket_fence_image(
    img: torch.Tensor,
    cfg: PFLeafConfig,
    params: PFParams,
    *,
    K_P: int,
    W_MAX: int,
    H_MAX: int,
    num_pickets: int | None = None,
    peak_sort: str = "peak_heights",
    separate_leaves: bool = False,
    extra_filter: int = 0,
    preprocess: bool = True,
) -> dict:
    """Analyse a (B, H, W) batch of raw picket fence frames, conditioned
    first by :func:`preprocess_pf_image` (the JAX function with
    ``preprocess=True``, the form ``PicketFenceBatch`` runs). With
    ``preprocess=False`` the images are taken as they are, as JAX's
    default takes them (``sharded_picket_fence``), and no image is
    de-spiked.

    Returns fixed-shape tensors with a leading batch dim; invalid kiss and
    picket slots carry masks. The keys are those of the JAX function, plus
    ``despike_passes``."""
    B, H, W = img.shape
    L = cfg.tops.shape[0]
    dev = img.device
    if preprocess:
        img, passes = preprocess_pf_image(img, extra_filter=extra_filter,
                                          invert=params.invert)
    else:
        img = img.to(_F32)
        passes = torch.zeros(B, dtype=torch.int32, device=dev)

    # ---- picket peaks on the normalised mean leaf profile ------------------
    leaf_prof = img.mean(dim=1)
    leaf_prof = leaf_prof / leaf_prof.amax(dim=1, keepdim=True)
    vmin = leaf_prof.amin(dim=1)
    vmax = leaf_prof.amax(dim=1)
    height_abs = vmin + params.height_threshold * (vmax - vmin)
    sep = max(int(_MIN_DISTANCE_FRAC * W), 1)
    # generous slot count (noise maxima above the height threshold may
    # outnumber the pickets), then compact into the K_P working slots
    res = peak_analysis(leaf_prof, K=4 * K_P, rel_height=0.5, height=height_abs,
                        distance=float(sep),
                        required_prominence=params.required_prominence)
    res = select_top(res, num_pickets, peak_sort)
    res = compact_slots(res, K_P)
    fwxm_idx = torch.round(res.left_ips + (res.right_ips - res.left_ips) / 2).to(torch.int32)
    fwxm_idx = fwxm_idx.clamp(0, W - 1)
    picket_valid = res.valid
    picket_vals = leaf_prof.gather(1, fwxm_idx.long())
    n_pickets = picket_valid.sum(dim=1).to(torch.int32)

    # picket spacing: median diff of the sorted valid fwxm indices
    sorted_idx, n_valid = _compact_valid(fwxm_idx.to(_F32), picket_valid)
    diffs = sorted_idx[:, 1:] - sorted_idx[:, :-1]
    diff_ok = torch.arange(K_P - 1, device=dev) < (n_valid - 1)[:, None]
    spacing = _masked_median(torch.where(diff_ok, diffs, 0.0), diff_ok)
    spacing = torch.where(n_valid > 1, spacing, float(W_MAX))

    # ---- kiss windows: (L, K_P) grid per image -------------------------------
    approx = fwxm_idx.to(_F32)                                     # (B, K_P)
    half = spacing[:, None] / 2
    left_edge = (approx - half).to(torch.int32).clamp(min=0)
    right_edge = (approx + half).to(torch.int32).clamp(max=W)
    offset = (approx - half).clamp(min=0.0)                        # float, host parity

    cols = left_edge[:, :, None] + torch.arange(W_MAX, device=dev)  # (B, K_P, W_MAX)
    cmask = cols < right_edge[:, :, None]
    cols_safe = cols.clamp(0, W - 1).long()

    row_ar = torch.arange(H_MAX, device=dev)
    rows = cfg.tops[:, None] + row_ar[None, :]                     # (L, H_MAX)
    rmask = row_ar[None, :] < cfg.heights[:, None]
    rows_safe = rows.clamp(0, H - 1)

    # separable two-stage gather: leaf rows first, then each picket's columns
    row_slab = img[:, rows_safe]                                   # (B, L, H_MAX, W)
    bidx = torch.arange(B, device=dev)[:, None, None]
    win = row_slab[bidx, :, :, cols_safe]                          # (B, K_P, W_MAX, L, H_MAX)
    win = win.permute(0, 3, 1, 4, 2)                               # (B, L, K_P, H_MAX, W_MAX)
    wmask = rmask[None, :, None, :, None] & cmask[:, None, :, None, :]

    # validity (reference _is_mlc_peak_in_window): per-row std across window
    # columns; max(std) < edge_thr * median(std); max(win) > h_thr * peak_val
    cnt_c = cmask.sum(dim=2).clamp(min=1)[:, None, :, None]        # (B, 1, K_P, 1)
    mean_r = torch.where(wmask, win, 0.0).sum(dim=4) / cnt_c       # (B, L, K_P, H_MAX)
    var_r = torch.where(wmask, (win - mean_r[..., None]) ** 2, 0.0).sum(dim=4) / cnt_c
    std_r = torch.sqrt(var_r)
    row_ok = rmask[None, :, None, :]
    max_std = torch.where(row_ok, std_r, float("-inf")).amax(dim=3)
    med_std = _masked_median(std_r, row_ok.expand(std_r.shape))
    win_max = torch.where(wmask, win, float("-inf")).amax(dim=(3, 4))
    in_window = ((win_max > params.height_threshold * picket_vals[:, None, :])
                 & (max_std < params.edge_threshold * med_std))
    kiss_valid = in_window & picket_valid[:, None, :]

    # ---- kiss profiles: masked median over rows, ground, normalise ---------
    prof = _masked_median(win.transpose(3, 4),                     # (B, L, K_P, W_MAX, H_MAX)
                          rmask[None, :, None, None, :].expand(B, L, K_P, W_MAX, H_MAX))
    pc = cmask[:, None]                                            # (B, 1, K_P, W_MAX)
    pmin = torch.where(pc, prof, float("inf")).amin(dim=3, keepdim=True)
    prof = torch.where(pc, prof - pmin, 0.0)
    pmax = prof.amax(dim=3, keepdim=True)
    prof = torch.where(pmax > 0, prof / pmax.clamp(min=1e-20), prof)

    # ---- FWXM of the most prominent peak per kiss ---------------------------
    # the most prominent peak is the global-max plateau: computed directly,
    # immune to slot overflow on noisy profiles
    flat = prof.reshape(B * L * K_P, W_MAX)
    l_ips, r_ips = main_peak_ips(flat, main_peak(flat), 1 - params.fwxm / 100.0)
    l_ips = l_ips.reshape(B, L, K_P)
    r_ips = r_ips.reshape(B, L, K_P)
    width_px = r_ips - l_ips

    if separate_leaves:
        pos = torch.stack([l_ips, r_ips], dim=-1) + offset[:, None, :, None]
    else:
        pos = ((l_ips + r_ips) / 2 + offset[:, None, :])[..., None]  # (B, L, K_P, 1)
    n_lines = pos.shape[-1]

    # ---- leaf filtering: keep leaves with the median number of kisses ------
    counts = kiss_valid.sum(dim=2)                                 # (B, L)
    leaf_has = counts > 0
    med_count = _masked_median(counts.to(_F32), leaf_has)
    leaf_kept = leaf_has & (counts.to(_F32) == med_count[:, None])
    any_dropped = (leaf_has & ~leaf_kept).any(dim=1)
    kiss_valid = kiss_valid & leaf_kept[:, :, None]

    # ---- per-picket line fit (reference Picket.get_fit: x = upper marker
    # row, y = MLC position) -------------------------------------------------
    upper = cfg.centers_px - cfg.widths_px / 2 * params.analysis_ratio  # (L,)
    x_pts = upper[:, None].expand(L, n_lines).reshape(-1)               # (L*n,)
    y_pts = pos.permute(0, 2, 1, 3).reshape(B, K_P, L * n_lines)
    w_pts = (kiss_valid.to(_F32).permute(0, 2, 1)[..., None]
             .expand(B, K_P, L, n_lines).reshape(B, K_P, L * n_lines))
    fits = _fit_line(x_pts, y_pts, w_pts)                               # (B, K_P, 2)

    # ---- errors: (pos - fit(marker-line centre row)) / dpmm ----------------
    picket_at = fits[:, None, :, 0] * cfg.centers_px[None, :, None] + fits[:, None, :, 1]
    if separate_leaves:
        signs = torch.tensor([-1.0, 1.0], device=dev)
        picket_at = picket_at[..., None] + signs * params.nominal_gap_px
    else:
        picket_at = picket_at[..., None]
    errors_mm = (pos - picket_at) / params.dpmm                         # (B, L, K_P, n)

    # ---- picket summary: skew + distance to CAX ----------------------------
    mid_idx = int(round(H / 2))
    dist2cax_mm = (params.cax_col - (fits[..., 0] * mid_idx + fits[..., 1])) / params.dpmm

    return {
        "n_pickets": n_pickets,
        "picket_valid": picket_valid,
        "fwxm_idx": fwxm_idx,
        "spacing": spacing,
        "kiss_valid": kiss_valid,
        "leaf_kept": leaf_kept,
        "any_dropped": any_dropped,
        "width_px": width_px,
        "positions_px": pos,
        "errors_mm": errors_mm,
        "fits": fits,
        "dist2cax_mm": dist2cax_mm,
        "despike_passes": passes,
    }


def picket_fence_batch(
    images: torch.Tensor,
    cfg: PFLeafConfig,
    params: PFParams,
    *,
    K_P: int = 16,
    W_MAX: int = 256,
    H_MAX: int = 64,
    num_pickets: int | None = None,
    peak_sort: str = "peak_heights",
    separate_leaves: bool = False,
    chunk: int = 32,
    extra_filter: int = 0,
) -> dict:
    """Analyse a (B, H, W) batch on the device the images are on, ``chunk``
    images at a time to bound the (chunk, L, K_P, H_MAX, W_MAX) window
    workspace. Returns the dict of :func:`picket_fence_image` for all B."""
    outs = [picket_fence_image(
        images[i:i + chunk], cfg, params, K_P=K_P, W_MAX=W_MAX, H_MAX=H_MAX,
        num_pickets=num_pickets, peak_sort=peak_sort,
        separate_leaves=separate_leaves, extra_filter=extra_filter)
        for i in range(0, images.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
