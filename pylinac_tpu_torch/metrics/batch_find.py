"""Batched windowed BB search: the multi-threshold disk scan of a set of
search windows at once.

Port of ``pylinac_tpu/metrics/batch_find.py``: ``reference_cutoffs``
(``:35``), ``_kept_mask_bb`` (``:49``), ``bb_scan_core`` (``:75``) and
``batched_bb_windows`` (``:117``). The 52 thresholds of every window go
through one batched region-property pass (the CCL kernel, 4-connected, in
label and hole modes on the card); the five default BB conditions run as
masks over the K slots, and each window keeps the regions of its first
threshold with a kept region, as the sequential finder does. The weighted
centroids are float32 ``scatter_add_`` sums, whose order differs between
the CPU, the card and JAX: they agree within 1e-3 px.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.array_utils import stretch
from ..core.utilities import resolve_device
from ..ops.label import Regions, clear_border, regionprops_batch

# fixed threshold-slot count: the accumulated float scan of find_features
# yields 50 (occasionally 51) steps; sentinel cutoffs > 1 give empty masks
_T_SLOTS = 52


def reference_cutoffs(imin: float = 0.0, imax: float = 1.0) -> np.ndarray:
    """The threshold sequence of ``find_features``, accumulated in float64,
    as float32, padded to ``_T_SLOTS`` with sentinels."""
    step = (imax - imin) / 50
    cuts = []
    c = imin + step
    while c <= imax and len(cuts) < _T_SLOTS:
        cuts.append(c)
        c += step
    out = np.full(_T_SLOTS, 2.0, np.float32)
    out[: len(cuts)] = cuts
    return out


def _kept_mask_bb(regions: Regions, *, dpmm: float, bb_radius_mm: float,
                  tolerance_mm: float) -> torch.Tensor:
    """The default BB conditions (``metrics/features.py``: is_right_size_bb,
    is_round, is_right_circumference, is_symmetric, is_solid) as a mask
    over the (..., K) slots."""
    area_mm2 = regions.area_filled / (dpmm ** 2)
    larger = math.pi * (bb_radius_mm + tolerance_mm) ** 2
    smaller = max(math.pi * (bb_radius_mm - tolerance_mm) ** 2, 2.0)
    ok_size = (area_mm2 > smaller) & (area_mm2 < larger)

    bbox_area = ((regions.bbox_rmax - regions.bbox_rmin)
                 * (regions.bbox_cmax - regions.bbox_cmin)).to(torch.float32)
    fill_ratio = regions.area_filled / bbox_area.clamp(min=1.0)
    ok_round = (fill_ratio > math.pi / 4 * 0.8) & (fill_ratio < math.pi / 4 * 1.2)

    circum = regions.perimeter / dpmm
    ok_circ = ((circum > 2 * math.pi * (bb_radius_mm - tolerance_mm))
               & (circum < 2 * math.pi * (bb_radius_mm + tolerance_mm)))

    dy = (regions.bbox_rmax - regions.bbox_rmin).to(torch.float32)
    dx = (regions.bbox_cmax - regions.bbox_cmin).to(torch.float32)
    ok_sym = ~((dx > torch.maximum(dy * 1.05, dy + 3))
               | (dx < torch.minimum(dy * 0.95, dy - 3)))

    solidity = regions.area_filled / regions.convex_area.clamp(min=1.0)
    ok_solid = solidity > 0.9
    return regions.valid & ok_size & ok_round & ok_circ & ok_sym & ok_solid


def bb_scan_core(windows: torch.Tensor, cutoffs: torch.Tensor, *, K: int, dpmm: float,
                 bb_radius_mm: float, tolerance_mm: float) -> torch.Tensor:
    """(B, h, w) stretched windows and (T,) cutoffs → packed (B, 1 + 3K)
    float32: [found, kept (K), weighted centroid row (K), column (K)] of
    each window's first threshold with a kept region.

    The T * B masks go through one :func:`regionprops_batch` (4-connected,
    convex hull on, second moments off: the conditions and the centroids
    never read them)."""
    b, h, w = windows.shape
    t = cutoffs.shape[0]
    masks = (windows[None, :, :, :] > cutoffs[:, None, None, None]).reshape(t * b, h, w)
    intens = windows[None].expand(t, b, h, w).reshape(t * b, h, w)
    regions = clear_border(regionprops_batch(masks, intens, K=K, connectivity=1,
                                             moments=False))
    kept = _kept_mask_bb(regions, dpmm=dpmm, bb_radius_mm=bb_radius_mm,
                         tolerance_mm=tolerance_mm).reshape(t, b, K)
    wr = regions.weighted_centroid_r.reshape(t, b, K)
    wc = regions.weighted_centroid_c.reshape(t, b, K)
    any_t = kept.any(dim=2)                                  # (t, b)
    t_star = torch.argmax(any_t.to(torch.uint8), dim=0)      # first hit per window
    found = any_t.any(dim=0)
    img = torch.arange(b, device=windows.device)
    return torch.cat([found.to(torch.float32)[:, None],
                      kept[t_star, img].to(torch.float32),
                      wr[t_star, img], wc[t_star, img]], dim=1)


def batched_bb_windows(windows: list[np.ndarray], dpmm: float, bb_radius_mm: float,
                       tolerance_mm: float, invert: bool = True, K: int = 24,
                       device: str | torch.device | None = None) -> list[list[tuple[float, float]]]:
    """The BB scan of a list of same-dpmm search windows on ``device``
    (``None``: CUDA, which must exist).

    Windows are grouped by shape (edge cropping can shift a crop by a
    pixel); each group runs as one :func:`bb_scan_core`. Returns, per
    window, the kept weighted centroids (row, col) in window coordinates of
    the first successful threshold, or [] when nothing was found."""
    device = resolve_device(device, "batched_bb_windows")
    prepared = []
    for win in windows:
        w = np.asarray(win, np.float32)
        if invert:
            w = w.max() + w.min() - w
        prepared.append(stretch(w, min=0, max=1))

    results: list[list[tuple[float, float]]] = [[] for _ in prepared]
    groups: dict[tuple[int, int], list[int]] = {}
    for i, w in enumerate(prepared):
        groups.setdefault(w.shape, []).append(i)
    cutoffs = torch.from_numpy(reference_cutoffs()).to(device)
    for idxs in groups.values():
        stack = torch.from_numpy(np.stack([prepared[i] for i in idxs])).to(device)
        packed = bb_scan_core(stack, cutoffs, K=K, dpmm=float(dpmm),
                              bb_radius_mm=float(bb_radius_mm),
                              tolerance_mm=float(tolerance_mm)).cpu().numpy()
        for row, i in zip(packed, idxs):
            kept = row[1:1 + K].astype(bool)
            wr = row[1 + K:1 + 2 * K]
            wc = row[1 + 2 * K:1 + 3 * K]
            if bool(row[0]):
                results[i] = [(float(r), float(c)) for r, c, k in zip(wr, wc, kept) if k]
    return results
