"""Fixed-K region properties of labelled masks, batched.

Port of ``pylinac_tpu/ops/label.py``: ``Regions`` ``:156``,
``_perimeter_image`` ``:200``, ``fill_holes`` ``:224``, ``regionprops``
``:258``, ``_props_from_label`` ``:326``, ``clear_border`` ``:559``,
``regionprops_batch`` ``:628`` and ``keep_largest`` ``:664``. Labels and hole roots come from the CCL
kernel (:mod:`pylinac_tpu_torch.ops.ccl`), the border flood of
:func:`fill_holes` from the flood kernel (:mod:`pylinac_tpu_torch.ops.flood`);
everything else here is plain PyTorch on the tensors' device.

The slot semantics are JAX's: the K + 1 smallest component roots in
ascending order, K slots reported, so a mask with K or more regions shows
K valid slots and callers take the same overflow path as in JAX. Where the
JAX function matched pixels to slots through an (N, K + 1) compare matrix,
this one finds each pixel's slot with ``torch.searchsorted`` on the
ascending ids, counts with ``scatter_add_`` and sums with
:func:`ops.stats.slot_sums`. ``area_filled`` counts every
hole, as the JAX CPU branch does (``:452-461``); the JAX TPU branch keeps
only the K + 1 smallest-root holes (``:431-433``).

Counts (areas, hole areas) are float32 ``scatter_add_`` sums of 0/1,
integers below 2**24 and exact in any order, atomics on the card included.
The other sums go through :func:`ops.stats.slot_sums`, whose order is fixed
on each device: on the CPU float32 adds in pixel order, on the card float64
one-hot products rounded once to float32. The coordinate sums are integers
and exact on the card; on the CPU they are exact below 2**24, which the
second-moment sums ``rr*rr``, ``cc*cc`` and ``rr*cc`` pass within a few
hundred pixels at row 300, and the row and column sums of a large region
pass too. Those, and the intensity and perimeter sums, may differ between
the CPU, the card and JAX in float32's last bits, but every run on one
device gives the same bits.

Not ported: ``pack_regions`` and ``regions_to_host`` (``:694-725``), which
worked around the TPU link; :meth:`Regions.to_numpy` takes their place.
``label`` has no caller of its own: :func:`keep_largest` labels through
the batch entry.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .ccl import hole_roots_batch, label_batch
from .flood import flood_from_border, flood_from_border_batch
from .stats import slot_sums

_CROSS = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_DIAG = [(-1, -1), (-1, 1), (1, -1), (1, 1)]


class Regions(NamedTuple):
    """Fixed-size (..., K) region properties; slots with ``valid=False`` are
    empty. Coordinates follow skimage: centroid = (row, col). Fields are
    tensors on the analysis device, or numpy arrays after
    :meth:`to_numpy`."""

    valid: torch.Tensor               # (..., K) bool
    area: torch.Tensor                # (..., K) float32, pixel count (unfilled)
    area_filled: torch.Tensor         # (..., K) float32, holes filled
    centroid_r: torch.Tensor          # (..., K) float32
    centroid_c: torch.Tensor
    weighted_centroid_r: torch.Tensor
    weighted_centroid_c: torch.Tensor
    bbox_rmin: torch.Tensor           # (..., K) int32, skimage half-open
    bbox_cmin: torch.Tensor
    bbox_rmax: torch.Tensor
    bbox_cmax: torch.Tensor
    perimeter: torch.Tensor           # (..., K) float32, Freeman-weighted
    touches_border: torch.Tensor      # (..., K) bool
    convex_area: torch.Tensor         # (..., K) float32, D-direction hull estimate
    major_axis_length: torch.Tensor
    minor_axis_length: torch.Tensor
    eccentricity: torch.Tensor
    orientation: torch.Tensor         # (..., K) float32, skimage convention (rad)
    mean_intensity: torch.Tensor
    max_intensity: torch.Tensor
    min_intensity: torch.Tensor
    label_id: torch.Tensor            # (..., K + 1) int32 root-pixel label

    @property
    def solidity(self) -> np.ndarray:
        """Filled area over convex area, of host regions."""
        return self.area_filled / np.maximum(self.convex_area, 1.0)

    @property
    def bbox_area(self) -> np.ndarray:
        """Bounding-box area, of host regions."""
        return ((self.bbox_rmax - self.bbox_rmin)
                * (self.bbox_cmax - self.bbox_cmin)).astype(np.float32)

    def to_numpy(self) -> "Regions":
        """The same regions with every field as a host numpy array."""
        return Regions(*[f.cpu().numpy() for f in self])


_PERIM_WEIGHTS = np.zeros(50, dtype=np.float32)
_PERIM_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIM_WEIGHTS[[21, 33]] = math.sqrt(2.0)
_PERIM_WEIGHTS[[13, 23]] = (1.0 + math.sqrt(2.0)) / 2.0


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., i, j] = x[..., i - dy, j - dx]`` over the last two dims,
    ``fill`` where that falls outside (``_shift2d``, ``label.py:38``)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        x[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def _perimeter_image(lab: torch.Tensor) -> torch.Tensor:
    """Per-pixel Freeman perimeter contribution of (B, H, W) labels
    (skimage.measure.perimeter, neighbourhood 4), per label so that
    adjacent regions do not interact."""
    mask = lab >= 0
    shifts = _CROSS + _DIAG
    same = [(_shift(lab, dy, dx, -2) == lab) & mask for dy, dx in shifts]
    # a border pixel has a 4-neighbour outside its own label
    border = mask & ~(same[0] & same[1] & same[2] & same[3])
    # centre 1 + cross border neighbours 2 + diagonal border neighbours 10,
    # counting only border neighbours of the same label
    val = border.to(torch.int64)
    for i, (dy, dx) in enumerate(shifts):
        nb_border = _shift(border, dy, dx, False) & same[i]
        val = val + (2 if i < 4 else 10) * nb_border.to(torch.int64)
    weights = torch.as_tensor(_PERIM_WEIGHTS, device=lab.device)
    return torch.where(border, weights[val.clamp(0, 49)], 0.0)


def _fms(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``q - a * b`` in float32 with one rounding, as the fused multiply-add
    that XLA emits for it on the CPU. The float32 product is exact in
    float64. The central moments subtract two numbers of order r**2, so the
    rounding shows in the axis lengths (up to 2e-4 px at r = 40)."""
    return (q.double() - a.double() * b.double()).to(torch.float32)


def _slots(ids: torch.Tensor, values: torch.Tensor, dump: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each value's slot among the (B, K + 1) ascending ``ids``, or ``dump``
    where it is none of them; and whether it matched."""
    pos = torch.searchsorted(ids, values)
    hit = ids.gather(1, pos.clamp(max=ids.shape[1] - 1)) == values
    return torch.where(hit, pos, dump), hit


def _props_from_label(mask: torch.Tensor, lab: torch.Tensor, intensity: torch.Tensor,
                      holes: torch.Tensor, K: int = 32, hull: bool = True,
                      minmax: bool = True, moments: bool = True) -> Regions:
    """(B, K) region properties from (B, H, W) masks, their labels, the
    intensity image and the hole roots (see :func:`regionprops_batch`).

    ``minmax=False`` skips the bbox and min/max intensities (zeros, bbox max
    -1 before the half-open +1); ``moments=False`` zero-fills the axis
    lengths, eccentricity and orientation; ``hull=False`` sets the convex
    area to the filled area (solidity 1)."""
    b, h, w = mask.shape
    n = h * w
    dev = mask.device
    f32 = torch.float32
    flat_mask = mask.reshape(b, n)
    flat_lab = lab.reshape(b, n).to(torch.int64)
    ar = torch.arange(n, device=dev)

    # the root pixels are exactly those whose label is their own index; the
    # K + 1 smallest, ascending, sentinel n for empty slots
    roots = torch.where(flat_mask & (flat_lab == ar), ar, n)
    if n < K + 1:
        roots = torch.nn.functional.pad(roots, (0, K + 1 - n), value=n)
    ids = torch.topk(roots, K + 1, dim=1, largest=False, sorted=True).values
    valid = ids < n
    label_id = torch.where(valid, ids, -1).to(torch.int32)
    num = K + 2  # slots 0..K hold the K + 1 ids, slot K + 1 everything else
    slot, _ = _slots(ids, flat_lab, K + 1)

    def count(values: torch.Tensor, index: torch.Tensor = slot) -> torch.Tensor:
        # 0/1 values: exact in any order
        return torch.zeros(b, num, dtype=f32, device=dev).scatter_add_(1, index, values)[:, :K]

    def seg_extreme(values: torch.Tensor, reduce: str) -> torch.Tensor:
        init = float("-inf") if reduce == "amax" else float("inf")
        out = torch.full((b, num), init, dtype=f32, device=dev)
        return out.scatter_reduce_(1, slot, values, reduce, include_self=True)[:, :K]

    in_mask = flat_mask.to(f32)
    area = count(in_mask)

    # holes: background components off the border. The enclosing region of
    # a hole is the one directly above its topmost-leftmost pixel, whose
    # index is the hole's root.
    is_hole = holes.reshape(b, n) >= 0
    hole_root = holes.reshape(b, n).to(torch.int64).clamp(0, n - 1)
    above = (hole_root - w).clamp(0, n - 1)
    hole_region = torch.where(is_hole, flat_lab.gather(1, above), -1)
    hole_slot, hole_ok = _slots(ids, hole_region, K + 1)
    hole_areas = count(hole_ok.to(f32), hole_slot)
    area_filled = area + hole_areas

    rr = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w).reshape(n)
    cc = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w).reshape(n)
    flat_i = intensity.reshape(b, n).to(f32)
    ii = flat_i * in_mask
    on_border = ((rr == 0) | (rr == h - 1) | (cc == 0) | (cc == w - 1)).to(f32)
    perim_img = _perimeter_image(lab).reshape(b, n)

    cols = [rr * in_mask, cc * in_mask,              # centroid sums
            ii, rr * ii, cc * ii,                    # intensity sums
            on_border * in_mask, perim_img]          # border / perimeter
    if moments:
        cols += [rr * rr * in_mask, cc * cc * in_mask, rr * cc * in_mask]
    sums = slot_sums(torch.stack(cols, dim=-1), slot, K)
    sum_i = sums[..., 2]
    safe_area = area.clamp(min=1)
    centroid_r = sums[..., 0] / safe_area
    centroid_c = sums[..., 1] / safe_area
    wc_r = sums[..., 3] / sum_i.clamp(min=1e-20)
    wc_c = sums[..., 4] / sum_i.clamp(min=1e-20)
    mean_i = sum_i / safe_area
    touches = sums[..., 5] > 0
    perimeter = sums[..., 6]

    zeros = torch.zeros(b, K, dtype=f32, device=dev)
    if minmax:
        inf = float("inf")
        max_i = seg_extreme(torch.where(in_mask > 0, flat_i, -inf), "amax")
        min_i = seg_extreme(torch.where(in_mask > 0, flat_i, inf), "amin")
        # bbox on the region pixels (holes are interior: the filled bbox)
        big = float(h * w)
        rmin = seg_extreme(torch.where(in_mask > 0, rr, big), "amin")
        cmin = seg_extreme(torch.where(in_mask > 0, cc, big), "amin")
        rmax = seg_extreme(torch.where(in_mask > 0, rr, -1.0), "amax")
        cmax = seg_extreme(torch.where(in_mask > 0, cc, -1.0), "amax")
    else:
        max_i = min_i = rmin = cmin = zeros
        rmax = cmax = zeros - 1.0

    if moments:
        # central moments of the unfilled pixels, as skimage's inertia
        mu20 = _fms(sums[..., 7] / safe_area, centroid_r, centroid_r)
        mu02 = _fms(sums[..., 8] / safe_area, centroid_c, centroid_c)
        mu11 = _fms(sums[..., 9] / safe_area, centroid_r, centroid_c)
        common = torch.sqrt(((mu20 - mu02) ** 2 + 4 * mu11 ** 2).clamp(min=0.0))
        l1 = (mu20 + mu02 + common) / 2
        l2 = (mu20 + mu02 - common) / 2
        major = 4.0 * torch.sqrt(l1.clamp(min=0.0))
        minor = 4.0 * torch.sqrt(l2.clamp(min=0.0))
        ecc = torch.sqrt((1.0 - l2 / l1.clamp(min=1e-20)).clamp(min=0.0))
        # skimage: angle of the major axis against the row axis
        orientation = 0.5 * torch.atan2(2 * mu11, mu02 - mu20)
    else:
        major = minor = ecc = orientation = zeros

    if hull:
        convex_area = torch.maximum(_hull_area(in_mask, rr, cc, slot, K), area_filled)
    else:
        convex_area = area_filled

    def bbox(x: torch.Tensor) -> torch.Tensor:
        # empty slots hold +-inf; keep the cast defined
        return torch.nan_to_num(x, posinf=float(h * w), neginf=-1.0).to(torch.int32)

    return Regions(
        valid=valid[:, :K], area=area, area_filled=area_filled,
        centroid_r=centroid_r, centroid_c=centroid_c,
        weighted_centroid_r=wc_r, weighted_centroid_c=wc_c,
        bbox_rmin=bbox(rmin), bbox_cmin=bbox(cmin),
        bbox_rmax=bbox(rmax + 1), bbox_cmax=bbox(cmax + 1),
        perimeter=perimeter, touches_border=touches, convex_area=convex_area,
        major_axis_length=major, minor_axis_length=minor, eccentricity=ecc,
        orientation=orientation,
        mean_intensity=mean_i, max_intensity=max_i, min_intensity=min_i,
        label_id=label_id)


# elements of the (chunk, H*W, K) inside test of _hull_area: 128 MB of bool
_HULL_CHUNK_ELEMENTS = 2**27


def _hull_area(in_mask: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
               slot: torch.Tensor, K: int) -> torch.Tensor:
    """Convex-hull pixel counts of (B, K) slots from D = 32 support
    functions: a pixel centre is inside the hull iff its projection is at
    most the region's support in every direction. The estimate circumscribes
    the true hull with O(1/D^2) excess.

    The whole batch goes through each direction at once: one
    ``scatter_reduce_`` gives the (B, K + 2) supports, then one comparison
    the inside test. Images go in chunks that keep the (chunk, H*W, K) test
    near 128 MB. Every pixel's projection is the same float32 product and
    sum as in the JAX function (``ops/label.py:527-539``)."""
    D = 32
    thetas = np.arange(D) * (2 * np.pi / D)
    nx = torch.as_tensor(np.cos(thetas), dtype=torch.float32)
    ny = torch.as_tensor(np.sin(thetas), dtype=torch.float32)
    b, n = in_mask.shape
    chunk = max(1, _HULL_CHUNK_ELEMENTS // max(n * K, 1))
    region = in_mask > 0
    out = [torch.zeros(0, K, device=rr.device)]
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        inside = torch.ones(hi - lo, n, K, dtype=torch.bool, device=rr.device)
        for d in range(D):
            proj = rr * float(ny[d]) + cc * float(nx[d])
            support = torch.full((hi - lo, K + 2), float("-inf"), device=rr.device)
            support.scatter_reduce_(
                1, slot[lo:hi], torch.where(region[lo:hi], proj, float("-inf")),
                "amax", include_self=True)
            inside &= proj[None, :, None] <= support[:, None, :K] + 1e-3
        out.append(inside.sum(dim=1).to(torch.float32))
    return torch.cat(out)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes of one (H, W) bool mask, or of each of
    a (B, H, W) batch: background not 4-connected to the border becomes
    foreground.

    The TPU branch of the JAX function (``ops/label.py:230-233``) at every
    size: ``mask | (flood == 0)`` with the border flood of
    :func:`ops.flood.flood_from_border` (a batch: ``flood_from_border_batch``,
    one launch for all, as JAX's ``vmap`` batches the Pallas call), which
    launches ``csrc/flood.cu`` on the card. JAX took its XLA fill above the
    VMEM budget; the card has none."""
    if mask.dim() == 3:
        return mask | (flood_from_border_batch(mask.contiguous()) == 0)
    return mask | (flood_from_border(mask.contiguous()) == 0)


def clear_border(regions: Regions) -> Regions:
    """Invalidate the regions that touch the image border (skimage
    clear_border)."""
    return regions._replace(valid=regions.valid & ~regions.touches_border)


def regionprops_batch(masks: torch.Tensor, intensity: torch.Tensor | None = None,
                      K: int = 32, connectivity: int = 1, hull: bool = True,
                      minmax: bool = True, moments: bool = True) -> Regions:
    """Label (B, H, W) bool masks and compute (B, K) region properties.

    Labels the raw masks (like skimage) with :func:`ccl.label_batch`;
    ``area_filled`` adds each region's enclosed holes, found with
    :func:`ccl.hole_roots_batch`. The JAX function's ``fill``, which changes
    nothing there, and its ``max_iter`` and ``chunk`` are not ported."""
    masks = masks.to(torch.bool).contiguous()
    labs = label_batch(masks, connectivity)
    holes = hole_roots_batch(masks)
    if intensity is None:
        intensity = masks.to(torch.float32)
    return _props_from_label(masks, labs, intensity, holes, K=K, hull=hull,
                             minmax=minmax, moments=moments)


def regionprops(mask: torch.Tensor, intensity: torch.Tensor | None = None,
                K: int = 32, connectivity: int = 1, hull: bool = True,
                minmax: bool = True, moments: bool = True) -> Regions:
    """:func:`regionprops_batch` of one (H, W) mask: (K,) fields. The
    labelling runs through the batch entries with B = 1."""
    regions = regionprops_batch(mask[None], None if intensity is None else intensity[None],
                                K=K, connectivity=connectivity, hull=hull,
                                minmax=minmax, moments=moments)
    return Regions(*[f[0] for f in regions])


def keep_largest(mask: torch.Tensor, K: int = 64, min_area: int = 1,
                 connectivity: int = 1) -> torch.Tensor:
    """Keep only the K largest connected components of one (H, W) mask, by
    pixel count; ties with the K-th largest count keep every tied region,
    as JAX's ``counts >= max(kth, min_area)`` does.

    One label through :func:`ccl.label_batch` at B = 1 (``csrc/ccl.cu`` on
    the card), then float32 counts per root. JAX caps its XLA label at
    ``max_iter`` = 64 rounds; the kernel and its twin reach the fixpoint,
    which that label reaches too on the masks of the paths."""
    h, w = mask.shape
    mask = mask.to(torch.bool).contiguous()
    lab = label_batch(mask[None], connectivity)[0]
    flat = lab.reshape(-1).to(torch.int64)
    idx = torch.where(flat >= 0, flat, h * w)
    counts = torch.zeros(h * w + 1, dtype=torch.float32, device=mask.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    counts[h * w] = 0.0
    # the K-th largest count is the cut; ties may keep a few extra regions
    kth = torch.sort(counts).values[-min(K, h * w)]
    keep = (counts >= torch.clamp(kth, min=float(min_area))) & (counts > 0)
    return mask & keep[idx].reshape(h, w)
