"""3x3 median filter: the hand-written CUDA kernel and its plain twin.

Port of ``pylinac_tpu/ops/pallas_median.py`` (``median3x3`` ``:70``, kernel
``_median9_kernel`` ``:27``). The kernel is ``csrc/median3x3.cu``; it takes a
(B, H, W) float32 or int32 batch where the Pallas kernel took one (H, W)
image of any dtype.

:func:`median3x3` launches the kernel for a CUDA tensor and takes the plain
PyTorch twin :func:`median3x3_reference` only for a CPU tensor. Both compute
rank 4 of the 9 neighbours with scipy "reflect" edges, exactly.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "median3x3"
# the kernel's C entry for each dtype it takes
ENTRIES = {torch.float32: "median3x3_f32", torch.int32: "median3x3_i32"}


def median3x3_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch 3x3 median of an (H, W) or (B, H, W) tensor.

    scipy "reflect" with a pad of 1 is numpy "symmetric", which for one pixel
    repeats the edge: ``F.pad(mode="replicate")``. (``mode="reflect"`` is
    scipy's "mirror" and would be wrong here.) The 9 shifted views are
    stacked and sorted; index 4 is the median."""
    x3 = x if x.dim() == 3 else x[None]
    _, h, w = x3.shape
    padded = F.pad(x3[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    shifts = [padded[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    out = torch.stack(shifts).sort(dim=0).values[4]
    return out if x.dim() == 3 else out[0]


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median filter of a contiguous (H, W) or (B, H, W) float32 or int32
    tensor.

    A CUDA tensor launches ``csrc/median3x3.cu`` on the current stream; a CPU
    tensor takes :func:`median3x3_reference`. Raises on any other dtype,
    device, rank or layout. ``median3x3.launches`` counts kernel launches."""
    if x.dtype not in ENTRIES:
        raise TypeError(f"median3x3 takes float32 or int32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"median3x3 takes (H, W) or (B, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("median3x3 takes a contiguous tensor")
    if x.device.type == "cpu":
        return median3x3_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"median3x3 runs on cpu or cuda, got {x.device}")
    b, h, w = x.shape if x.dim() == 3 else (1, *x.shape)
    if b > 65535 or -(-h // 64) > 65535:
        raise ValueError(f"median3x3 takes at most 65535 images of 4194240 rows, "
                         f"got {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _kernel(ENTRIES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b, h, w, stream)
    _build.count_launch(median3x3)
    if err != 0:
        raise RuntimeError(f"median3x3 kernel launch failed: CUDA error {err}")
    return out


median3x3.launches = 0


def _kernel(entry: str):
    fn = getattr(_build.load(KERNEL), entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
