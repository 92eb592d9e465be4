"""The batched starshot pipeline: whole-batch wobble analysis on the device.

Port of ``pylinac_tpu/ops/star_pipeline.py:36-228``: ``K_PK``,
``StarParams``, ``_combo_table``, ``starshot_image`` and
``starshot_batch``, with the same output keys. Each stage runs over a
(B, ...) batch of images in plain PyTorch: the percentile inversion check,
the FW80M start point, the 20-ring nearest-pixel polar profile, the roll to
the deepest valley, the Gaussian, the FWXM spoke peaks, the opposite-peak
pairing and the minimax wobble by :func:`nelder_mead_batch`. None of it is
a TPU kernel of the JAX package.

The minimax fits run on CPU tensors (:func:`_fit_wobble`, ``FIT_DEVICE``), as the
Winston-Lutz fits do: 16 problems of at most 16 lines take about 100
iterations of some 50 tiny ops each, which the card ran in 110.8 ms of
host dispatch against 21.1 ms on CPU tensors, with the same bits
(``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W). The lines go to
the host once a combo and the wobble comes back; the image work stays on
the device.

The JAX retry ladder, a ``lax.while_loop`` under ``vmap``, is a host loop
over the combos here: each step evaluates only the images not yet found,
gathered into a sub-batch, and merges the new results back, so every image
ends with the first combo that suits it and its ``combos_tried``, as the
batched ``while_loop`` gives it. The bench's stars are found at the first
combo, so the loop is almost always one step.

Where the port's arithmetic follows XLA's rather than the Python source,
so as to give JAX's bits on the CPU, it says so: the percentiles and the
ring radii (:mod:`pylinac_tpu_torch.ops.stats`), the ring means (XLA
divides by 20 as a multiply by its float32 reciprocal), the line lengths
(``jnp.linalg.norm`` of a 2-vector), and the sample and spoke-end
coordinates ``cos * r + x`` and the cross products of the line
distances, which XLA fuses into multiply-adds
(:func:`pylinac_tpu_torch.ops.stats.fma_f32`). The angular tables ``cos`` and
``sin`` of the sample angles are computed once on the host in float64 and
rounded to float32, so that the card and the CPU gather the same pixels;
XLA's float32 ``cos`` may differ from them by an ulp (ROADMAP section 3
logs what that moves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .filters import gaussian_filter1d
from .optimize import nelder_mead_batch
from .peaks import main_peak, main_peak_ips, peak_analysis
from .stats import fma_f32, linspace_f32, percentile_f32

K_PK = 32      # spoke-peak slots (>= 2x max expected spokes)


@dataclasses.dataclass(frozen=True)
class StarParams:
    """Per-batch analysis parameters (the radius and height to start from
    are the first row of the combo table)."""

    max_wobble_mm: float        # sanity diameter (2.0)
    dpmm: float
    invert: bool = False        # explicit user inversion


def _combo_table(radius: float, min_peak_height: float) -> np.ndarray:
    """The reference's retry sequence: the initial pair, then the full
    (radius x height) product grid (``starshot.py:334-337``)."""
    heights = np.append(min_peak_height, np.linspace(0.05, 0.95, 10))
    radii = np.append(radius, np.linspace(0.95, 0.1, 10))
    grid = [(radius, min_peak_height)]
    for r in radii:
        for h in heights:
            grid.append((r, h))
    return np.asarray(grid, np.float32)


def n_angles(shape: tuple[int, int], radius: float) -> int:
    """The angular sample count of a batch of ``shape`` images: the image
    centre's ring at ``radius`` sampled 3 times a pixel, in multiples of
    256 from 1024 to 16384 (``pylinac_tpu/starshot.py:489-493``)."""
    h, w = shape
    r_est = min(h / 2, w / 2) * radius
    return int(np.clip(int(np.pi * 2 * r_est * 3) // 256 * 256, 1024, 16384))


def _angle_tables(n_ang: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the sample angles ``interval * (n_ang - 1 - k)`` (the
    float32 angles of the JAX pipeline), in float64 rounded to float32."""
    interval = np.float32(2 * np.pi / n_ang)
    rads = (interval * np.arange(n_ang - 1, -1, -1, dtype=np.float32)).astype(np.float64)
    return (torch.from_numpy(np.cos(rads).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(rads).astype(np.float32)).to(device))


def _norm2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of 2-vectors: sqrt(x * x + y * y) in float32."""
    return torch.sqrt(x * x + y * y)


def _cross(w0, w1, d0, d1) -> torch.Tensor:
    """|w x d| of 2-vectors, ``w0 * d1 - w1 * d0`` with its first product
    fused into the subtraction, as XLA compiles it on the CPU."""
    return torch.abs(fma_f32(w0, d1, -(w1 * d0)))


def _max_distance(p1, d, line_valid):
    """The minimax objective over (b, L) lines through ``p1`` along unit
    ``d``, ``line_valid`` masking the padding: maps (b, m, 2) points to the
    (b, m) largest distance from each point to its image's lines."""
    def f(pts):
        w = pts[:, :, None, :] - p1[:, None]                              # (b, m, L, 2)
        cross = _cross(w[..., 0], w[..., 1], d[:, None, :, 0], d[:, None, :, 1])
        return torch.where(line_valid[:, None], cross, 0.0).amax(dim=2)

    return f


# where the minimax fits run: CPU tensors (see the module docstring)
FIT_DEVICE = "cpu"


def _fit_wobble(p1, d, line_valid, focus, nm_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The minimax wobble of each image: the point whose largest distance
    to its valid lines is least, by :func:`nelder_mead_batch` from the
    focus point, on ``FIT_DEVICE``; returns the (b, 2) centres and (b,)
    radii on the lines' device."""
    p1, d, line_valid, x0 = (t.to(FIT_DEVICE) for t in (p1, d, line_valid, focus))
    xw, fw = nelder_mead_batch(_max_distance(p1, d, line_valid), x0, fatol=0.001,
                               xatol=1e-4, max_iter=nm_iters)
    return xw.to(focus.device), fw.to(focus.device)


def _prepare(images: torch.Tensor, invert: bool):
    """The inversion check, the ground and the FW80M start point of each
    image (``star_pipeline.py:76-97``). Returns the grounded float32 images
    and the (B,) ``fx``, ``fy``, ``local_max`` and ``dist_edge``."""
    B, H, W = images.shape
    img = images.to(torch.float32)
    p = percentile_f32(img, [4.0, 50.0, 96.0])
    do_inv = (torch.abs(p[:, 1] - p[:, 0]) > torch.abs(p[:, 1] - p[:, 2])) ^ bool(invert)
    flat = img.reshape(B, -1)
    vmin = flat.amin(dim=1)[:, None, None]
    vmax = flat.amax(dim=1)[:, None, None]
    img = torch.where(do_inv[:, None, None], -img + vmax + vmin, img)
    img = img - img.reshape(B, -1).amin(dim=1)[:, None, None]

    t3, l3 = H // 3, W // 3
    central = img[:, t3:2 * t3, l3:2 * l3]

    def fw80m_center(v):
        pk = main_peak(v)
        l_ip, r_ip = main_peak_ips(v, pk, 1 - 0.8)
        return torch.round((l_ip + r_ip) / 2)

    fx = fw80m_center(central.amax(dim=1)) + l3
    fy = fw80m_center(central.amax(dim=2)) + t3
    local_max = percentile_f32(central, [90.0])[:, 0]
    dist_edge = torch.minimum(torch.minimum(H - fy, W - fx), torch.minimum(fy, fx))
    return img, fx, fy, local_max, dist_edge


def _eval_combo(img, fx, fy, local_max, dist_edge, r_frac, h_frac, params: StarParams,
                tables, *, n_ang: int, n_rings: int, recursive: bool, fwhm: bool,
                nm_iters: int) -> tuple[torch.Tensor, dict]:
    """One (radius, height) combo on a (b, H, W) sub-batch
    (``star_pipeline.py:105-175``). Returns (ok, outputs)."""
    b, H, W = img.shape
    dev = img.device
    cos, sin = tables
    sigma = max(int(round(n_ang * 0.003)), 1)
    sep = 0.02 * n_ang
    radius_px = dist_edge * r_frac
    height_abs = h_frac * local_max

    # 20-ring nearest-pixel collapsed polar profile (profile.py:1174)
    ring_radii = linspace_f32(radius_px * 0.9, radius_px * 1.1, n_rings)   # (b, R)
    xx = torch.round(fma_f32(cos, ring_radii[:, :, None], fx[:, None, None])).to(torch.int64)
    yy = torch.round(fma_f32(sin, ring_radii[:, :, None], fy[:, None, None])).to(torch.int64)
    xx = xx.clamp(0, W - 1)
    yy = yy.clamp(0, H - 1)
    flat = (yy * W + xx).reshape(b, -1)
    samples = img.reshape(b, -1).gather(1, flat).reshape(b, n_rings, n_ang)
    # the integer ring sums are exact; XLA divides by n_rings as a multiply
    prof = samples.sum(dim=1) * np.float32(1 / n_rings)
    # roll to the deepest valley so no spoke spans the wrap (:800)
    shift = torch.argmin(prof, dim=1)                                      # first minimum
    ar = torch.arange(n_ang, device=dev)
    rolled = (ar[None, :] + shift[:, None]) % n_ang
    prof = prof.gather(1, rolled)
    prof = gaussian_filter1d(prof, float(sigma))
    prof = prof - prof.amin(dim=1, keepdim=True)
    res = peak_analysis(prof, K=K_PK, rel_height=0.5, height=height_abs, distance=sep)
    if fwhm:
        centers = res.left_ips + (res.right_ips - res.left_ips) / 2
    else:
        centers = res.positions.to(torch.float32)
    valid = res.valid
    n_pk = valid.sum(dim=1)
    ok_count = (n_pk >= 6) & (n_pk % 2 == 0)
    # compact valid peaks to the front, order kept
    kk = torch.arange(K_PK, device=dev)
    order = torch.argsort(torch.where(valid, kk, K_PK + kk), dim=1, stable=True)
    centers = centers.gather(1, order)
    valid_sorted = valid.gather(1, order)
    # nearest-sample spoke ends (profile.py:1123: int truncation)
    idx = centers.to(torch.int32).clamp(0, n_ang - 1).to(torch.int64)
    angle = (idx + shift[:, None]) % n_ang
    px = fma_f32(cos[angle], radius_px[:, None], fx[:, None])
    py = fma_f32(sin[angle], radius_px[:, None], fy[:, None])
    # pair peak i with i + n/2 into lines
    half = n_pk // 2
    j = torch.arange(K_PK // 2, device=dev)
    mate = (j[None, :] + half[:, None]).clamp(0, K_PK - 1)
    line_valid = valid_sorted[:, :K_PK // 2] & (j[None, :] < half[:, None])
    p1 = torch.stack([px[:, :K_PK // 2], py[:, :K_PK // 2]], dim=2)      # (b, L, 2)
    p2 = torch.stack([px.gather(1, mate), py.gather(1, mate)], dim=2)
    d = p2 - p1
    norm = torch.clamp(_norm2(d[..., 0], d[..., 1]), min=1e-9)[..., None]
    d = d / norm
    # all lines must pass near the focus point (:82)
    focus = torch.stack([fx, fy], dim=1)                                   # (b, 2)
    wf = focus[:, None, :] - p1
    focus_dist = _cross(wf[..., 0], wf[..., 1], d[..., 0], d[..., 1])
    limit = 10 * np.float32(params.dpmm)
    ok_focus = torch.all(torch.where(line_valid, focus_dist, 0.0) <= limit, dim=1)

    xw, fw = _fit_wobble(p1, d, line_valid, focus, nm_iters)
    diam_mm = 2 * fw / torch.full_like(fw, params.dpmm)
    near = torch.sqrt((xw[:, 0] - fx) ** 2 + (xw[:, 1] - fy) ** 2) < limit
    if recursive:
        ok = ok_count & ok_focus & (diam_mm < np.float32(params.max_wobble_mm)) & near
    else:
        ok = ok_count & ok_focus
    return ok, {
        "wobble_center": xw, "wobble_radius_px": fw, "n_lines": half.to(torch.int32),
        "line_p1": p1, "line_p2": p2, "line_valid": line_valid,
        "n_peaks": n_pk.to(torch.int32),
    }


def starshot_batch(images: torch.Tensor, params: StarParams, combos: np.ndarray, *,
                   n_ang: int, n_rings: int = 20, recursive: bool = True,
                   fwhm: bool = True, nm_iters: int = 400, chunk: int | None = None) -> dict:
    """Analyse a (B, H, W) starshot batch on its device. Returns the JAX
    function's dict of (B, ...) tensors: ``wobble_center``,
    ``wobble_radius_px``, ``n_lines``, ``line_p1``, ``line_p2``,
    ``line_valid``, ``n_peaks``, ``found``, ``combos_tried`` and
    ``start_point``. ``chunk`` bounds the images a step evaluates at once
    (all of them when None); it changes no result."""
    B = images.shape[0]
    dev = images.device
    chunk = B if chunk is None else max(int(chunk), 1)
    tables = _angle_tables(n_ang, dev)
    combos = np.asarray(combos, np.float32)
    n_combos = combos.shape[0] if recursive else 1
    statics = dict(n_ang=n_ang, n_rings=n_rings, recursive=recursive, fwhm=fwhm,
                   nm_iters=nm_iters)
    out = {
        "wobble_center": torch.zeros(B, 2, dtype=torch.float32, device=dev),
        "wobble_radius_px": torch.full((B,), float("inf"), dtype=torch.float32, device=dev),
        "n_lines": torch.zeros(B, dtype=torch.int32, device=dev),
        "line_p1": torch.zeros(B, K_PK // 2, 2, dtype=torch.float32, device=dev),
        "line_p2": torch.zeros(B, K_PK // 2, 2, dtype=torch.float32, device=dev),
        "line_valid": torch.zeros(B, K_PK // 2, dtype=torch.bool, device=dev),
        "n_peaks": torch.zeros(B, dtype=torch.int32, device=dev),
    }
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    tried = torch.zeros(B, dtype=torch.int32, device=dev)
    start = torch.empty(B, 2, dtype=torch.float32, device=dev)
    prepared = []
    for lo in range(0, B, chunk):
        img, fx, fy, local_max, dist_edge = _prepare(images[lo:lo + chunk], params.invert)
        start[lo:lo + chunk] = torch.stack([fx, fy], dim=1)
        prepared.append((lo, img, fx, fy, local_max, dist_edge))

    active = [np.arange(img.shape[0]) for _, img, *_ in prepared]
    for i in range(n_combos):
        r_frac, h_frac = np.float32(combos[i, 0]), np.float32(combos[i, 1])
        for c, (lo, img, fx, fy, local_max, dist_edge) in enumerate(prepared):
            sel = active[c]
            if len(sel) == 0:
                continue
            rows = torch.from_numpy(sel).to(dev)
            ok, new = _eval_combo(img[rows], fx[rows], fy[rows], local_max[rows],
                                  dist_edge[rows], r_frac, h_frac, params, tables,
                                  **statics)
            dest = rows + lo
            tried[dest] = i + 1
            hit = dest[ok]
            for key, value in new.items():
                out[key][hit] = value[ok]
            found[hit] = True
            active[c] = sel[~ok.cpu().numpy()]
        if not any(len(a) for a in active):
            break
    out["found"] = found
    out["combos_tried"] = tried
    out["start_point"] = start
    return out
