"""Exact order statistics and percentiles, batched over a leading dim; the
noise power spectrum.

Port of ``pylinac_tpu/ops/stats.py:101-160`` (``order_statistics`` ``:114``,
``percentile_exact`` ``:144``). The JAX package searched float32 bit space
to avoid a TPU sort; on the card a per-image sort is the plain form. Both
give the exact k-th smallest values. ``torch.quantile`` is not used: it
refuses inputs of more than 2**24 elements, and ``percentile_exact`` mixes
its two order statistics in float32, as the JAX function does (``:158``).

The NPS chain (``noise_power_spectrum_2d`` ``:50``, ``radial_average``
``:61``, ``average_power`` ``:79``, ``max_frequency`` ``:85``,
``nps_bundle`` ``:90``) goes through ``torch.fft.fft2``; its float32 FFT
differs from XLA's in the last bits.

:func:`slot_sums` is the port's own: the float sums by slot of the region
properties (``ops/label.py``) and of :func:`radial_average`, added in one
fixed order on each device (no atomics), so that every run of the same
input gives the same bits. So is :func:`wide_sum`, the float32 sums of the
field-analysis fits (``ops/field_pipeline.py``, ``ops/optimize.py``).

:func:`percentile_f32` and :func:`linspace_f32` are ``jnp.percentile`` and
``jnp.linspace`` (with float32 ends) step for step in float32, where the
starshot pipeline (``pylinac_tpu/ops/star_pipeline.py:77``, ``:96``,
``:109``) calls them: their ranks, weights and sums round where JAX's do,
so they give JAX's bits, which numpy's float64 formula does not.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def order_statistics(values: torch.Tensor, ranks: Sequence[int]) -> torch.Tensor:
    """The exact k-th smallest elements (0-based ``ranks``) of each item of a
    (B, ...) batch, as float32 of shape (B, len(ranks))."""
    flat = values.reshape(values.shape[0], -1).to(torch.float32)
    index = torch.as_tensor(list(ranks), dtype=torch.long, device=values.device)
    return flat.sort(dim=1).values.index_select(1, index)


def percentile_exact(values: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``np.percentile(item, qs)`` (linear interpolation) for each item of a
    (B, ...) batch, as float32 of shape (B, len(qs))."""
    n = int(np.prod(values.shape[1:]))
    ranks, mix = [], []
    for q in qs:
        r = q / 100.0 * (n - 1)
        f = int(np.floor(r))
        ranks.extend((f, min(f + 1, n - 1)))
        mix.append(r - f)
    stats = order_statistics(values, ranks)
    lo, hi = stats[:, 0::2], stats[:, 1::2]
    w = torch.tensor(mix, dtype=torch.float32, device=values.device)
    return lo + w * (hi - lo)


def percentile_f32(values: torch.Tensor, qs: Sequence[float],
                   fused: bool = False) -> torch.Tensor:
    """``jnp.percentile(item, qs)`` for each item of a (B, ...) batch, as
    float32 of shape (B, len(qs)): q / 100 and the rank q * (n - 1) in
    float32, then ``lo * (1 - w) + hi * w`` in float32
    (jax ``_src/numpy/reductions.py``, ``_quantile``), each op rounded, or
    with ``fused`` as one fused multiply-add, ``fma(lo, 1 - w, hi * w)``,
    as a jitted ``jnp.percentile`` gives it on the CPU."""
    n = int(np.prod(values.shape[1:]))
    q = np.asarray(qs, np.float32) / np.float32(100)
    rank = q * (np.float32(n) - np.float32(1))
    low, high = np.floor(rank), np.ceil(rank)
    hw = rank - low
    lw = np.float32(1) - hw
    ranks = np.stack([np.clip(low, 0, n - 1), np.clip(high, 0, n - 1)], axis=1).astype(np.int64)
    stats = order_statistics(values, ranks.reshape(-1).tolist())
    lo, hi = stats[:, 0::2], stats[:, 1::2]
    lw, hw = torch.from_numpy(lw).to(values.device), torch.from_numpy(hw).to(values.device)
    if fused:
        return fma_f32(lo, lw, hi * hw)
    return lo * lw + hi * hw


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once, as XLA's fused
    multiply-add gives it on the CPU: the product is exact in float64.
    (Rounding the float64 sum to float32 rounds twice, which can differ
    from one rounding only when the sum lies within 2**-53 of a float32
    rounding midpoint.)"""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 ``x``, as XLA's on the
    CPU and CUDA's ``__fsqrt_rn``. Torch's CPU ``sqrt`` is not always
    correctly rounded, in float32 or in float64 (on an AVX-512 host about
    1 % of float64 roots are off by an ulp, and a process's first call can
    differ from its later ones), so the float32 root is taken and then
    moved by at most one ulp by exact float64 tests against the midpoints
    to its neighbours (a midpoint has 25 bits, so its square is exact and
    never equals a float32)."""
    x = x.to(torch.float32)
    r = torch.sqrt(x)
    xd = x.to(torch.float64)
    up = torch.nextafter(r, r.new_tensor(float("inf")))
    mid = (r.to(torch.float64) + up.to(torch.float64)) * 0.5
    r = torch.where(xd > mid * mid, up, r)
    down = torch.nextafter(r, r.new_tensor(float("-inf")))
    mid = (r.to(torch.float64) + down.to(torch.float64)) * 0.5
    return torch.where((xd < mid * mid) & (r > 0), down, r)


# XLA unrolls linspace's loop up to this many points and then fuses its
# second point the other way (see linspace_f32)
_LINSPACE_UNROLLED = 33


def linspace_f32(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` of float32 ends of shape (...),
    as (..., num) float32, as XLA compiles it on the CPU: ``s = iota * c``
    with ``c`` the float32 reciprocal of ``num - 1``, ``stop * s`` as
    ``iota * (stop * c)``, added to ``start * (1 - s)`` in one fused
    multiply-add, and the last point ``stop`` exactly (jax
    ``_src/numpy/array_creation.py``, ``_linspace``). Where XLA unrolls the
    loop (up to 33 points) the multiply by 1 of the second point folds
    away, and the product ``start * (1 - s)`` fuses there instead."""
    start = start.to(torch.float32)[..., None]
    stop = stop.to(torch.float32)[..., None]
    if num == 1:
        return start
    div = num - 1
    c = np.float32(1) / np.float32(div)
    it = torch.arange(div, dtype=torch.float32, device=start.device)
    one_minus = 1 - it * c
    stop_c = stop * c
    out = fma_f32(it, stop_c, start * one_minus)
    if 1 < div <= _LINSPACE_UNROLLED:
        out[..., 1:2] = fma_f32(start, one_minus[1:2], stop_c)
    return torch.cat([out, stop], dim=-1)


def noise_power_spectrum_2d(rois: torch.Tensor, pixel_size: float) -> torch.Tensor:
    """2D NPS from a stack of square ROIs (N, L, L), ICRU 87 eq 11.1/11.2."""
    rois = rois.to(torch.float32)
    length = rois.shape[-1]
    demeaned = rois - rois.mean(dim=(-2, -1), keepdim=True)
    ffts = torch.fft.fft2(demeaned).abs() ** 2
    shifted = torch.fft.fftshift(ffts, dim=(-2, -1))
    return pixel_size ** 2 / length ** 2 * shifted.mean(dim=0)


# one-hot elements per product of the card's slot sums: 256 MB of float64
_ONEHOT_ELEMENTS = 2**25
# pixels per partial product: enough products in flight to fill the card
_SPLIT = 4096


def wide_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of float32 ``x`` along ``dim``, added in float64 and rounded to
    float32 once. The float64 sums that the CPU's and the card's reduction
    orders give differ by far less than a float32 ulp, so the two devices
    return the same float32 bits except where the sum falls within that gap
    of a rounding boundary. The JAX package added these in float32."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


def slot_sums(values: torch.Tensor, slot: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k, C) float32 sums of (B, N, C) float32 ``values`` over the
    pixels of each slot ``0 .. k - 1`` of the (B, N) int64 ``slot``; pixels
    of slot ``k`` or above add nowhere.

    The order of the adds is fixed on each device. On the CPU,
    ``scatter_add_`` adds in float32, one pixel after another. On the card
    it would add with atomics, in an order that changes from run to run;
    there the sums are :func:`_onehot_sums` instead."""
    b, n, c = values.shape
    if values.device.type == "cuda":
        return _onehot_sums(values, slot, k)
    out = torch.zeros(b, k + 1, c, dtype=torch.float32, device=values.device)
    index = slot.clamp(max=k)[..., None].expand(b, n, c)
    return out.scatter_add_(1, index, values.to(torch.float32))[:, :k]


def _onehot_sums(values: torch.Tensor, slot: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`slot_sums` as float64 products of a one-hot matrix with the
    values (``bmm``; on the card cuBLAS, whose order is fixed for one shape
    on one card), over pieces of ``_SPLIT`` pixels whose partial sums a
    float64 ``sum`` adds, rounded once to float32. Float32 values times the
    0/1 one-hot are exact in float64, so sums of integers below 2**53
    (counts, coordinates, their squares and products) come out exact. The
    CPU's float32 running sums of such integers are exact only below
    2**24: past it (the second moments of a region in a window of some
    hundreds of pixels) the two devices' sums differ by more than float32's
    last bit, and the CPU's, like JAX's, are the inexact ones. The other
    sums differ from float32 sums in pixel order in float32's last bits."""
    b, n, c = values.shape
    pad = -n % _SPLIT
    v = torch.nn.functional.pad(values.to(torch.float64), (0, 0, 0, pad))
    s = torch.nn.functional.pad(slot, (0, pad), value=k)
    parts = (n + pad) // _SPLIT
    v = v.reshape(b * parts, _SPLIT, c)
    s = s.reshape(b * parts, 1, _SPLIT)
    ks = torch.arange(k, device=values.device)[None, :, None]
    step = max(1, _ONEHOT_ELEMENTS // (k * _SPLIT))
    partial = torch.cat([torch.bmm((s[lo:lo + step] == ks).to(torch.float64), v[lo:lo + step])
                         for lo in range(0, b * parts, step)])
    return partial.reshape(b, parts, k, c).sum(dim=1).to(torch.float32)


def radial_average(arr: torch.Tensor) -> torch.Tensor:
    """Radial average of an (H, W) array about its centre pixel, in unit
    integer-radius bins. The bin sums are :func:`slot_sums`, in one fixed
    order; the counts are exact."""
    h, w = arr.shape
    cy, cx = float(np.floor(h / 2.0)), float(np.floor(w / 2.0))
    y = torch.arange(h, dtype=torch.float32, device=arr.device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=arr.device)[None, :]
    r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2).to(torch.int64).reshape(-1)
    nbins = int(np.ceil(np.sqrt(h * h + w * w))) + 1
    tbin = slot_sums(arr.reshape(1, -1, 1).to(torch.float32), r[None], nbins)[0, :, 0]
    nr = torch.zeros(nbins, dtype=torch.float32, device=arr.device)
    nr.scatter_add_(0, r, torch.ones_like(r, dtype=torch.float32))
    return torch.where(nr > 0, tbin / nr.clamp(min=1), 0.0)


def average_power(nps1d: torch.Tensor) -> torch.Tensor:
    x = torch.linspace(0.0, 1.0, nps1d.shape[0], device=nps1d.device)
    return (x * nps1d).sum() / nps1d.sum()


def max_frequency(nps1d: torch.Tensor) -> torch.Tensor:
    return nps1d.argmax() / nps1d.shape[0]


def nps_bundle(rois: torch.Tensor, pixel_size: float):
    """(ps2d, ps1d, avg_power, max_freq) of a stack of square ROIs; the
    CTP486 uniformity module reads all four."""
    ps2d = noise_power_spectrum_2d(rois, pixel_size)
    ps1d = radial_average(ps2d)
    return ps2d, ps1d, average_power(ps1d), max_frequency(ps1d)
