"""Binary morphology (skimage.morphology equivalents).

Port of ``pylinac_tpu/ops/morphology.py``: ``_disk_kernel`` ``:19``,
``isotropic_erosion`` ``:27``, ``find_boundaries`` ``:45``,
``remove_small_objects`` ``:68``, ``remove_small_holes`` ``:82``,
``block_reduce`` ``:103``, ``_conv_binary`` ``:117``, ``binary_dilation``
``:125``, ``binary_erosion`` ``:131``, ``binary_closing`` ``:137``,
``rotate_footprint`` ``:142``.

The binary convolutions count pixels: a float32 ``conv2d`` of 0/1 values
with TF32 off on the card, rounded to the nearest integer. A direct sum of
such counts is exact in any order, but cuDNN may pick an FFT or Winograd
algorithm for a shape, whose counts come back a few ulps off (8.9999995,
1e-7); the rounding makes them exact whatever the algorithm. Labels come from :func:`.ccl.label_batch` at B = 1 (``csrc/ccl.cu``
on the card). ``block_reduce`` and ``rotate_footprint`` are host numpy in
both packages.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .ccl import label_batch


def _disk_kernel(radius: float) -> np.ndarray:
    r = int(np.ceil(radius))
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    # strict: survivors lie at distance >= radius from the background
    return (yy ** 2 + xx ** 2 < radius ** 2).astype(np.float32)


def _no_tf32(device: torch.device):
    if device.type == "cuda":
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


def _correlate_counts(x: torch.Tensor, kernel: np.ndarray, pads: tuple[int, int, int, int],
                      value: float = 0.0) -> torch.Tensor:
    """Counts of the (H', W') correlation of a float32 (H, W) 0/1 image with a
    0/1 kernel after a constant pad (left, right, top, bottom), as whole
    float32 numbers."""
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    xp = F.pad(x[None, None], pads, value=value)
    with _no_tf32(x.device):
        return torch.round(F.conv2d(xp, k[None, None])[0, 0])


def isotropic_erosion(mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Erode with a Euclidean disk: a pixel survives iff no background pixel
    lies within ``radius`` (skimage.morphology.isotropic_erosion); the
    border counts as background."""
    mask = mask.to(torch.bool)
    if radius <= 0:
        return mask
    k = _disk_kernel(radius)
    pad = (k.shape[0] - 1) // 2
    hits = _correlate_counts((~mask).to(torch.float32), k, (pad, pad, pad, pad), value=1.0)
    return mask & (hits == 0)


def _shifted(mask: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``jnp.roll(mask, (dy, dx))`` with the rolled-in rows and columns
    False."""
    h, w = mask.shape
    out = torch.zeros_like(mask)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        mask[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def find_boundaries(mask: torch.Tensor, connectivity: int = 1,
                    mode: str = "inner") -> torch.Tensor:
    """Inner boundaries: mask pixels with a background neighbour
    (skimage.segmentation.find_boundaries, mode 'inner')."""
    mask = mask.to(torch.bool)
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    any_bg = torch.zeros_like(mask)
    for dy, dx in shifts:
        any_bg = any_bg | ~_shifted(mask, dy, dx)
    return mask & any_bg


def _component_counts(lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot of each pixel, pixel count of each slot); background goes to
    the dump slot H*W."""
    h, w = lab.shape
    flat = lab.reshape(-1).to(torch.int64)
    idx = torch.where(flat >= 0, flat, h * w)
    counts = torch.zeros(h * w + 1, dtype=torch.int32, device=lab.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return idx, counts


def remove_small_objects(mask: torch.Tensor, min_size: int = 64,
                         connectivity: int = 1) -> torch.Tensor:
    """Drop connected components smaller than ``min_size`` pixels."""
    mask = mask.to(torch.bool).contiguous()
    h, w = mask.shape
    idx, counts = _component_counts(label_batch(mask[None], connectivity)[0])
    return mask & (counts >= min_size)[idx].reshape(h, w)


def remove_small_holes(mask: torch.Tensor, area_threshold: int = 64,
                       connectivity: int = 1) -> torch.Tensor:
    """Fill the holes (background components off the border) smaller than
    ``area_threshold`` pixels."""
    mask = mask.to(torch.bool).contiguous()
    h, w = mask.shape
    bg_lab = label_batch((~mask)[None].contiguous(), connectivity)[0]
    idx, counts = _component_counts(bg_lab)
    on_border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    on_border[0, :] = on_border[-1, :] = True
    on_border[:, 0] = on_border[:, -1] = True
    flags = torch.zeros(h * w + 1, dtype=torch.uint8, device=mask.device)
    border_slot = torch.where((on_border & (bg_lab >= 0)).reshape(-1), idx, h * w)
    flags.scatter_reduce_(0, border_slot, torch.ones_like(border_slot, dtype=torch.uint8),
                          reduce="amax")
    is_hole = (bg_lab >= 0) & (flags[bg_lab.clamp(0, h * w).reshape(-1).to(torch.int64)]
                               .reshape(h, w) == 0)
    small = (counts < area_threshold)[idx].reshape(h, w)
    return mask | (is_hole & small)


def block_reduce(arr: np.ndarray, block_size: tuple[int, int], func=np.sum) -> np.ndarray:
    """skimage.measure.block_reduce with zero padding to a block multiple."""
    by, bx = block_size
    h, w = arr.shape
    ph, pw = (-h) % by, (-w) % bx
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw)))
    h2, w2 = arr.shape
    view = arr.reshape(h2 // by, by, w2 // bx, bx)
    return func(func(view, axis=3), axis=1)


def _conv_binary(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Count of true pixels under the kernel at each position, with XLA's
    "SAME" padding (the odd pixel of an even kernel's pad goes after)."""
    kh, kw = np.asarray(kernel).shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    return _correlate_counts(mask.to(torch.float32), kernel,
                             (left, kw - 1 - left, top, kh - 1 - top))


def binary_dilation(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Dilation with an arbitrary footprint (flipped: a correlation)."""
    fp = np.ascontiguousarray(np.asarray(footprint, np.float32)[::-1, ::-1])
    return _conv_binary(mask, fp) > 0


def binary_erosion(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Erosion with an arbitrary footprint; the border counts as background."""
    fp = np.asarray(footprint, np.float32)
    return _conv_binary(mask, fp) >= fp.sum()


def binary_closing(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Dilation then erosion (skimage.morphology.binary_closing)."""
    return binary_erosion(binary_dilation(mask, footprint), footprint)


def rotate_footprint(footprint: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate a small binary footprint (nearest neighbour, resized), as
    skimage.transform.rotate(resize=True) for structuring elements."""
    fp = np.asarray(footprint, float)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    h, w = fp.shape
    H = int(np.ceil(abs(h * c) + abs(w * s)))
    W = int(np.ceil(abs(h * s) + abs(w * c)))
    yy, xx = np.mgrid[:H, :W]
    cy_o, cx_o = (H - 1) / 2, (W - 1) / 2
    cy_i, cx_i = (h - 1) / 2, (w - 1) / 2
    # inverse-rotate the output coordinates into the input
    ys = (yy - cy_o) * c - (xx - cx_o) * s + cy_i
    xs = (yy - cy_o) * s + (xx - cx_o) * c + cx_i
    yi = np.round(ys).astype(int)
    xi = np.round(xs).astype(int)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.zeros((H, W))
    out[valid] = fp[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)][valid]
    return out > 0.5
