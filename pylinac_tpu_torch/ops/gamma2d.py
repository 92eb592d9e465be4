"""Low-2004 2D gamma over a disk of offsets: the hand-written CUDA kernel and
its plain twin.

Port of ``pylinac_tpu/ops/pallas_gamma.py`` (``gamma2d_pallas`` ``:56``,
kernel ``_gamma_kernel`` ``:27``) and of the offset loop of the XLA form of
``gamma_2d`` (``pylinac_tpu/ops/gamma.py:64-78``). The kernel is
``csrc/gamma2d.cu``; it takes a (B, H, W) batch where the Pallas kernel took
one (H, W) image.

:func:`gamma2d` launches the kernel for a CUDA tensor and takes the plain
PyTorch twin :func:`gamma2d_reference` only for a CPU tensor. The twin reads
the offset table (:func:`offset_table`): the disk's (dy, dx) in JAX's order
and dist2 = (dy² + dx²) / dta² computed in float64 and rounded to float32,
which is how JAX rounds that Python double. The kernel reads the same
values laid out by rows of the disk (:func:`row_table`). Not ported:
``gamma2d_pallas_supported`` (``:77``), the TPU's VMEM budget; the kernel
serves every shape and every dta >= 1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

KERNEL = "gamma2d"
# the kernel's pixels per thread along x, and so the width of the blocks of
# offsets in which it walks each row of the disk (csrc/gamma2d.cu:kP)
BLOCK = 4


def _disk_offsets(radius: int) -> list[tuple[int, int]]:
    """Offsets of skimage.draw.disk((0, 0), radius + 1), exclusive of the
    outer edge: the reference's search neighbourhood
    (``pylinac_tpu/ops/gamma.py:21``)."""
    offs = []
    r = radius + 1
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx < r * r:  # skimage disk is exclusive of radius
                offs.append((dy, dx))
    return offs


def _check_dta(dta) -> int:
    """``dta`` as an int; raises unless it is a whole number of pixels >= 1."""
    if isinstance(dta, bool) or not isinstance(dta, (int, np.integer)):
        raise TypeError(f"the distance to agreement is in whole pixels, got {dta!r}")
    if dta < 1:
        raise ValueError(f"the distance to agreement must be >= 1 px, got {dta}")
    return int(dta)


@functools.cache
def offset_table(dta: int) -> tuple[np.ndarray, np.ndarray]:
    """The disk offsets of ``dta`` as an (n, 2) int32 array of (dy, dx) and
    their float32 dist2 terms, (dy² + dx²) / dta² rounded from float64."""
    offs = _disk_offsets(dta)
    pairs = np.array(offs, np.int32).reshape(-1, 2)
    dist2 = np.array([(dy * dy + dx * dx) / (dta * dta) for dy, dx in offs]).astype(np.float32)
    pairs.flags.writeable = dist2.flags.writeable = False
    return pairs, dist2


@functools.cache
def row_table(dta: int) -> tuple[np.ndarray, np.ndarray]:
    """The disk of ``dta`` by rows, as the kernel walks it: an (n_rows, 4)
    int32 array of (dy, c0, nb, offset) and the float32 dist2 values.

    Row dy holds the offsets dx = c0 - dta + j for j in [0, nb * BLOCK):
    ``c0`` is the multiple of BLOCK at or below dta - hw, where hw is the
    row's half-width, and the nb blocks reach dta + hw. Its values start at
    ``offset`` (a multiple of BLOCK) and are :func:`offset_table`'s dist2 for
    the disk's offsets, +inf for the padding beyond the disk."""
    pairs, dist2 = offset_table(dta)
    rows, values = [], []
    for dy in range(-dta, dta + 1):
        in_row = pairs[:, 0] == dy
        dxs, d2 = pairs[in_row, 1], dist2[in_row]
        hw = int(dxs.max())
        c0 = (dta - hw) // BLOCK * BLOCK
        nb = (dta + hw) // BLOCK - (dta - hw) // BLOCK + 1
        row = np.full(nb * BLOCK, np.inf, np.float32)
        row[dxs - (c0 - dta)] = d2
        rows.append((dy, c0, nb, sum(len(v) for v in values)))
        values.append(row)
    table, values = np.array(rows, np.int32), np.concatenate(values)
    table.flags.writeable = values.flags.writeable = False
    return table, values


@functools.cache
def _device_table(dta: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rows, dist2 = row_table(dta)
    return (torch.from_numpy(rows.copy()).to(device), torch.from_numpy(dist2.copy()).to(device))


def gamma2d_reference(ref_n: torch.Tensor, eval_p: torch.Tensor, dta: int, cap: float,
                      threshold_n: float, fill: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the offset loop of
    ``pylinac_tpu/ops/gamma.py:64-78`` on a (B, H, W) batch. Every operation
    rounds to float32 on its own; ``cap``, ``threshold_n`` and ``fill`` are
    rounded to float32 first."""
    _, h, w = ref_n.shape
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=ref_n.device)
    cap_t = f32(np.float32(cap))
    min_g2 = (cap_t * cap_t).expand(ref_n.shape).clone()
    inf = f32(float("inf"))
    for (dy, dx), d2 in zip(*offset_table(dta)):
        shifted = eval_p[:, dta + dy: dta + dy + h, dta + dx: dta + dx + w]
        dd = shifted - ref_n
        cand = float(d2) + dd * dd
        min_g2 = torch.minimum(min_g2, torch.where(torch.isnan(cand), inf, cand))
    # PyTorch's float32 sqrt on an AVX-512 CPU is off by an ulp for about
    # 0.6 % of inputs; the float64 root of a float32, rounded, is the
    # correctly rounded float32 root, as the kernel's __fsqrt_rn
    gamma = torch.minimum(torch.sqrt(min_g2.double()).float(), cap_t)
    skip = torch.isnan(ref_n) | (ref_n < f32(np.float32(threshold_n)))
    return torch.where(skip, f32(np.float32(fill)), gamma)


def gamma2d(ref_n: torch.Tensor, eval_p: torch.Tensor, dta: int, cap: float,
            threshold_n: float, fill: float) -> torch.Tensor:
    """Gamma map of a contiguous (B, H, W) float32 normalised reference and
    its contiguous (B, H + 2 dta, W + 2 dta) float32 edge-padded evaluation.

    ``cap``, ``threshold_n`` and ``fill`` are scalars, rounded to float32.
    A CUDA tensor launches ``csrc/gamma2d.cu`` on the current stream; a CPU
    tensor takes :func:`gamma2d_reference`. Raises on any other dtype,
    device, rank, shape or layout. ``gamma2d.launches`` counts kernel
    launches."""
    dta = _check_dta(dta)
    for name, x in (("ref_n", ref_n), ("eval_p", eval_p)):
        if x.dtype != torch.float32:
            raise TypeError(f"gamma2d takes float32, got {name} {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"gamma2d takes (B, H, W) tensors, got {name} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"gamma2d takes contiguous tensors, got a strided {name}")
    b, h, w = ref_n.shape
    if tuple(eval_p.shape) != (b, h + 2 * dta, w + 2 * dta):
        raise ValueError(f"eval_p must be (B, H + 2 dta, W + 2 dta) = "
                         f"{(b, h + 2 * dta, w + 2 * dta)}, got {tuple(eval_p.shape)}")
    if ref_n.device != eval_p.device:
        raise ValueError(f"ref_n on {ref_n.device}, eval_p on {eval_p.device}")
    if ref_n.device.type == "cpu":
        return gamma2d_reference(ref_n, eval_p, dta, cap, threshold_n, fill)
    if ref_n.device.type != "cuda":
        raise ValueError(f"gamma2d runs on cpu or cuda, got {ref_n.device}")
    if b > 65535 or -(-h // 8) > 65535:
        raise ValueError(f"the gamma kernel takes at most 65535 images and 524280 rows, "
                         f"got {tuple(ref_n.shape)}")
    out = torch.empty_like(ref_n)
    if ref_n.numel() == 0:
        return out
    rows, dist2 = _device_table(dta, ref_n.device)
    fn = _kernel()
    with torch.cuda.device(ref_n.device):
        stream = torch.cuda.current_stream(ref_n.device).cuda_stream
        err = fn(ref_n.data_ptr(), eval_p.data_ptr(), rows.data_ptr(), dist2.data_ptr(),
                 out.data_ptr(), len(rows), len(dist2), b, h, w, dta, float(np.float32(cap)),
                 float(np.float32(threshold_n)), float(np.float32(fill)), stream)
    if err != 0:
        raise RuntimeError(f"gamma2d kernel launch failed: CUDA error {err}")
    _build.count_launch(gamma2d)
    return out


gamma2d.launches = 0


def _kernel():
    fn = _build.load(KERNEL).gamma2d_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
