"""Connected-component labelling: the hand-written CUDA kernel and its twins.

Port of the Pallas TPU kernels of ``pylinac_tpu/ops/pallas_label.py``:
``_label_kernel_call`` (``:127``, kernel ``_label_kernel`` ``:69``),
``label_pallas_batch`` (``:148``), ``hole_roots`` (``:289``, kernel
``_hole_kernel`` ``:232``) and ``_batched_call`` (``:425``, kernel
``_batched_sweep_kernel`` ``:336``) in its ``label`` (``:451``) and
``holes`` (``:458``) modes. One CUDA source, ``csrc/ccl.cu``, serves all
four: a block-based union-find (row runs united in shared memory per tile,
then across tile borders) whose roots are the component minima, the
fixpoint the Pallas kernels reach by iterated min-propagation.

:func:`label_batch` and :func:`hole_roots_batch` launch the kernel for a
CUDA tensor and take the plain PyTorch twins :func:`label_reference` and
:func:`hole_roots_reference` only for a CPU tensor. :func:`label` and
:func:`hole_roots` take one image and call the same entries with B = 1.

Not ported: the VMEM budget guards (``label_pallas_supported`` ``:302``,
``label_batched_supported`` ``:464``) and the padding to (8, 128) tiles
(``:322-333``). The card has no VMEM limit and no tile shape to pad to; the
only size limit is B * H * W < 2**31: the kernel indexes the pixels of an
image with int32, and the wrapper keeps the whole batch under that bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "ccl"
_LABEL, _HOLES = 0, 1
_CROSS = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_DIAG = [(-1, -1), (-1, 1), (1, -1), (1, 1)]


def label_reference(masks: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of the label mode: (B, H, W) bool → int32, -1 for
    background, each component its minimum per-image linear index.

    The labels of ``_label_xla`` (``ops/label.py:81-153``) by root hooking:
    each pixel's label points to a pixel of its component with no larger
    index; a round takes the smallest label next to each pixel, lowers the
    pixel's root to it (``scatter_reduce`` of ``amin``, which no order
    changes) and jumps every pointer to its root. The fixpoint is reached in
    a few rounds where the neighbour-min propagation of ``_label_xla`` takes
    one round a pixel of a component's length, and its labels are the same:
    every component's minimum. There is no iteration cap."""
    b, h, w = masks.shape
    n = h * w
    shifts = _CROSS if connectivity == 1 else _CROSS + _DIAG
    lin = torch.arange(n, dtype=torch.int64, device=masks.device).reshape(h, w)
    lab = torch.where(masks, lin, n)
    sentinel = torch.full((b, 1), n, dtype=torch.int64, device=masks.device)
    while True:
        # neighbour min: shifted views of one sentinel-padded copy
        padded = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=n)
        best = lab
        for dy, dx in shifts:
            best = torch.minimum(best, padded[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w])
        best = torch.where(masks, best, n)
        flat = torch.cat([lab.reshape(b, n), sentinel], dim=1)  # sentinel maps to itself
        flat = flat.scatter_reduce(1, lab.reshape(b, n), best.reshape(b, n), "amin")
        while True:
            jumped = flat.gather(1, flat)
            if torch.equal(jumped, flat):
                break
            flat = jumped
        new = flat[:, :n].reshape(b, h, w)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(masks, lab, -1).to(torch.int32)


def hole_roots_reference(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the holes mode: (B, H, W) bool → int32, -1 for
    border-reachable background, the hole's minimum linear index for hole
    pixels, -2 for foreground.

    Port of ``_holes_xla`` (``ops/label.py:290-302``): label the background
    with 4-connectivity, then flag the labels that occur on the border."""
    b, h, w = masks.shape
    n = h * w
    bg = label_reference(~masks, 1).to(torch.int64)
    border = torch.zeros(h, w, dtype=torch.bool, device=masks.device)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    flags = torch.zeros(b, n + 1, dtype=torch.bool, device=masks.device)
    flags.scatter_(1, torch.where(border & (bg >= 0), bg, n).reshape(b, n), True)
    reached = flags.gather(1, bg.clamp(0, n).reshape(b, n)).reshape(b, h, w)
    out = torch.where(reached, -1, bg)
    return torch.where(masks, -2, out).to(torch.int32)


def _check(masks: torch.Tensor, name: str) -> None:
    if masks.dtype != torch.bool:
        raise TypeError(f"{name} takes a bool mask, got {masks.dtype}")
    if masks.dim() != 3:
        raise ValueError(f"{name} takes (B, H, W), got {tuple(masks.shape)}")
    if not masks.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if masks.numel() >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 pixels, got {masks.numel()}")
    if masks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {masks.device}")


def _launch(masks: torch.Tensor, mode: int, connectivity: int, counted) -> torch.Tensor:
    """Launch ``csrc/ccl.cu`` and add one to ``counted.launches``; an empty
    batch launches nothing and counts nothing."""
    b, h, w = masks.shape
    if b > 65535:
        raise ValueError(f"the CCL kernel takes at most 65535 images, got {b}")
    out = torch.empty(masks.shape, dtype=torch.int32, device=masks.device)
    if masks.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), out.data_ptr(), b, h, w, mode, connectivity, stream)
    if err != 0:
        raise RuntimeError(f"CCL kernel launch failed: CUDA error {err}")
    _build.count_launch(counted)
    return out


def label_batch(masks: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Label each image of a contiguous (B, H, W) bool batch: int32, -1 for
    background, each component its minimum per-image linear index.
    ``connectivity`` 1 is 4-connected, 2 is 8-connected.

    A CUDA tensor launches ``csrc/ccl.cu`` in label mode on the current
    stream; a CPU tensor takes :func:`label_reference`. Raises on any other
    dtype, device, rank or layout. ``label_batch.launches`` counts kernel
    launches."""
    _check(masks, "label_batch")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity is 1 or 2, got {connectivity}")
    if masks.device.type == "cpu":
        return label_reference(masks, connectivity)
    return _launch(masks, _LABEL, connectivity, label_batch)


label_batch.launches = 0


def hole_roots_batch(masks: torch.Tensor) -> torch.Tensor:
    """Hole roots of each image of a contiguous (B, H, W) bool batch: int32,
    -1 for background reachable from the border (4-connected), the hole's
    minimum per-image linear index for hole pixels, -2 for foreground.

    A CUDA tensor launches ``csrc/ccl.cu`` in holes mode on the current
    stream; a CPU tensor takes :func:`hole_roots_reference`. Raises on any
    other dtype, device, rank or layout. ``hole_roots_batch.launches``
    counts kernel launches."""
    _check(masks, "hole_roots_batch")
    if masks.device.type == "cpu":
        return hole_roots_reference(masks)
    return _launch(masks, _HOLES, 1, hole_roots_batch)


hole_roots_batch.launches = 0


def label(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """:func:`label_batch` of one (H, W) image."""
    if mask.dim() != 2:
        raise ValueError(f"label takes (H, W), got {tuple(mask.shape)}")
    return label_batch(mask[None], connectivity)[0]


def hole_roots(mask: torch.Tensor) -> torch.Tensor:
    """:func:`hole_roots_batch` of one (H, W) image."""
    if mask.dim() != 2:
        raise ValueError(f"hole_roots takes (H, W), got {tuple(mask.shape)}")
    return hole_roots_batch(mask[None])[0]


@functools.cache
def _kernel():
    """The C entry of ``csrc/ccl.cu``, built and typed once."""
    fn = _build.load(KERNEL).ccl_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
