"""Border flood of the background: the hand-written CUDA kernel and its twins.

Port of the Pallas TPU kernels of ``pylinac_tpu/ops/pallas_label.py``:
``flood_from_border`` (``:220``, kernel ``_flood_kernel`` ``:165``) and
``filled_centroid_packed`` (``:634``, kernel ``_flood_packed_kernel``
``:510``). Both compute the background pixels 4-connected to the image
border; the second then takes the centre of mass of the hole-filled mask.
One CUDA source, ``csrc/flood.cu``, serves both with two entries. It reaches
the exact fixpoint; the Pallas kernels' iteration caps (256 sweeps, 64
rounds) are not carried over.

:func:`flood_from_border_batch` and :func:`filled_centroid_batch` launch the
kernel for a CUDA tensor and take the plain PyTorch twins
:func:`flood_from_border_reference` and :func:`filled_centroid_reference`
only for a CPU tensor. :func:`flood_from_border` takes one image and calls
the batch entry with B = 1.

Each entry is one cooperative launch over the whole card: 128 x 128 px
tiles, closed in grid-wide rounds until a round changes nothing
(``csrc/flood.cu``). :func:`flood_rounds` reports how many rounds a batch
took.

Not ported: ``_pack_cols`` (``:604``), ``_choose_bc`` (``:621``),
``flood_packed_supported`` (``:665``) and the VMEM budget. The card has no
VMEM limit, so the kernel serves every frame size; the kernel packs its own
bits on the card. The only limit is B * H * W < 2**31; the grid is the
number of blocks the card holds at once, or the number of tiles if fewer.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ccl import _check, label_reference

KERNEL = "flood"


def flood_from_border_reference(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the flood entry: (B, H, W) bool → int32, 1 where
    a background pixel is 4-connected to the border, 0 elsewhere.

    Port of ``_fill_holes_xla`` (``ops/label.py:239-252``): label the
    background with :func:`ccl.label_reference`, flag the labels that occur
    on the border and look every background pixel's label up."""
    b, h, w = masks.shape
    n = h * w
    if masks.numel() == 0:
        return torch.zeros(masks.shape, dtype=torch.int32, device=masks.device)
    bg = label_reference(~masks, 1).to(torch.int64).reshape(b, n)
    border = torch.zeros(h, w, dtype=torch.bool, device=masks.device)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    flags = torch.zeros(b, n + 1, dtype=torch.bool, device=masks.device)
    flags.scatter_(1, torch.where(border.reshape(n) & (bg >= 0), bg, n), True)
    reached = (bg >= 0) & flags.gather(1, bg.clamp(0, n))
    return reached.reshape(b, h, w).to(torch.int32)


def filled_centroid_reference(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the centroid entry: (B, H, W) bool → (B, 2)
    float32 (row, col) centre of mass of ``fg | (bg & ~reached)``.

    The mass and coordinate sums are int64, divided in float64 by the mass
    clamped to at least 1 and rounded to float32, as the kernel does. The
    JAX kernel sums in float32, which is exact while the sums stay below
    2**24."""
    b, h, w = masks.shape
    filled = masks | (flood_from_border_reference(masks) == 0)
    rows = torch.arange(h, dtype=torch.int64, device=masks.device)[:, None]
    cols = torch.arange(w, dtype=torch.int64, device=masks.device)[None, :]
    filled = filled.to(torch.int64)
    mass = filled.sum(dim=(1, 2)).clamp(min=1).to(torch.float64)
    sum_y = (filled * rows).sum(dim=(1, 2)).to(torch.float64)
    sum_x = (filled * cols).sum(dim=(1, 2)).to(torch.float64)
    return torch.stack([sum_y / mass, sum_x / mass], dim=1).to(torch.float32)


def _launch(masks: torch.Tensor, entry: str, out: torch.Tensor, counted) -> torch.Tensor | None:
    """Launch an entry of ``csrc/flood.cu`` into ``out`` and add one to
    ``counted.launches``; returns the kernel's state buffer (int64: the
    round stamp, then the centroid entry's 3 sums per image), or None for an
    empty batch, which launches nothing and counts nothing."""
    b, h, w = masks.shape
    if masks.numel() == 0:
        return None
    words = -(-w // 32)
    bg = torch.empty((b, h, words), dtype=torch.int32, device=masks.device)
    reached = torch.empty_like(bg)
    slots = 1 + (3 * b if entry == "filled_centroid_f32" else 0)
    state = torch.zeros(slots, dtype=torch.int64, device=masks.device)
    fn = _kernel(entry)
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), out.data_ptr(), bg.data_ptr(), reached.data_ptr(),
                 state.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"flood kernel launch failed: CUDA error {err}")
    _build.count_launch(counted)
    return state


def flood_from_border_batch(masks: torch.Tensor) -> torch.Tensor:
    """The border flood of each image of a contiguous (B, H, W) bool batch:
    int32, 1 where a background pixel is 4-connected to the image border,
    0 elsewhere (``_flood_kernel``'s output contract).

    A CUDA tensor launches ``csrc/flood.cu`` on the current stream; a CPU
    tensor takes :func:`flood_from_border_reference`. Raises on any other
    dtype, device, rank or layout. ``flood_from_border_batch.launches``
    counts kernel launches."""
    _check(masks, "flood_from_border_batch")
    if masks.device.type == "cpu":
        return flood_from_border_reference(masks)
    out = torch.empty(masks.shape, dtype=torch.int32, device=masks.device)
    _launch(masks, "flood_from_border_i32", out, flood_from_border_batch)
    return out


flood_from_border_batch.launches = 0


def filled_centroid_batch(masks: torch.Tensor) -> torch.Tensor:
    """(row, col) centre of mass of each hole-filled image of a contiguous
    (B, H, W) bool batch: float32 (B, 2), the mass clamped to at least 1.

    A CUDA tensor launches ``csrc/flood.cu``'s centroid entry on the current
    stream; a CPU tensor takes :func:`filled_centroid_reference`. Raises on
    any other dtype, device, rank or layout.
    ``filled_centroid_batch.launches`` counts kernel launches."""
    _check(masks, "filled_centroid_batch")
    if masks.device.type == "cpu":
        return filled_centroid_reference(masks)
    # zeros: an image with no pixels launches nothing and has centroid (0, 0)
    out = torch.zeros((masks.shape[0], 2), dtype=torch.float32, device=masks.device)
    _launch(masks, "filled_centroid_f32", out, filled_centroid_batch)
    return out


filled_centroid_batch.launches = 0


def flood_from_border(mask: torch.Tensor) -> torch.Tensor:
    """:func:`flood_from_border_batch` of one (H, W) image."""
    if mask.dim() != 2:
        raise ValueError(f"flood_from_border takes (H, W), got {tuple(mask.shape)}")
    return flood_from_border_batch(mask[None])[0]


def flood_rounds(masks: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The flood entry on a (B, H, W) bool CUDA batch, and the number of
    grid-wide rounds the kernel took, the closing round included. Counts a
    launch of :func:`flood_from_border_batch`; waits for the card."""
    _check(masks, "flood_rounds")
    if masks.device.type != "cuda":
        raise ValueError(f"flood_rounds measures the kernel and takes a CUDA tensor, got "
                         f"{masks.device}")
    out = torch.empty(masks.shape, dtype=torch.int32, device=masks.device)
    state = _launch(masks, "flood_from_border_i32", out, flood_from_border_batch)
    return out, 0 if state is None else int(state[0]) + 1


def _kernel(entry: str):
    fn = getattr(_build.load(KERNEL), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
