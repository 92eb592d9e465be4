"""The port's batched BB scan and feature finder against the JAX package's.

Inputs are seeded Winston-Lutz BB windows, 134 x 134 (AS1200 at SID 1000,
2.976 px/mm) and 58 x 58 (AS500, 1.28 px/mm): a blurred 30 mm field with a
5 mm BB near the centre, inverted and stretched as the detection does.

Tolerances: ``found``, ``kept``, areas, bounding boxes, perimeters and the
convex areas are exact (integer counts, or float32 sums of integers and of
the same per-pixel perimeter weights). The weighted centroids are float32
sums of intensities in another order: within 1e-3 px.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import ndimage

from pylinac_tpu_torch.metrics import batch_find, features, utils
from pylinac_tpu_torch.ops import ccl, label

TOL_PX = 1e-3
BB_RADIUS_MM = 2.5
TOL_MM = float(np.interp(5, (1.5, 30), (2, 4)))
SIZES = {134: 2.976, 58: 1.28}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.metrics import batch_find as jbatch, features as jfeatures, utils as jutils
    from pylinac_tpu.ops import label as jlabel

    return SimpleNamespace(jnp=jnp, batch=jbatch, features=jfeatures, utils=jutils,
                           label=jlabel)


def _windows(size: int, dpmm: float, seed: int, n: int = 4) -> np.ndarray:
    """n stretched BB windows; the last has no BB, so nothing is found."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for i in range(n):
        c = size / 2 - 0.5 + rng.uniform(-2, 2, 2)
        half = 15 * dpmm
        field = (np.abs(yy - c[0]) < half) & (np.abs(xx - c[1]) < half)
        bb_c = c + rng.uniform(-1.5, 1.5, 2) * dpmm
        bb = (yy - bb_c[0]) ** 2 + (xx - bb_c[1]) ** 2 < (BB_RADIUS_MM * dpmm) ** 2
        img = field * 1.0 - (0.5 * (bb & field) if i < n - 1 else 0)
        img = ndimage.gaussian_filter(img, dpmm) + rng.normal(0, 0.001, img.shape)
        w = img.astype(np.float32)
        w = w.max() + w.min() - w  # the BB is dark: invert, then stretch
        out.append(((w - w.min()) / max(w.max() - w.min(), 1e-30)).astype(np.float32))
    return np.stack(out)


WINDOWS = {size: _windows(size, dpmm, seed=size) for size, dpmm in SIZES.items()}


@pytest.fixture(scope="module")
def jax_scans(jref):
    cut = jref.jnp.asarray(jref.batch.reference_cutoffs())
    return {size: np.asarray(jref.batch._batched_bb_scan(
        jref.jnp.asarray(WINDOWS[size]), cut, K=24, dpmm=dpmm, bb_radius_mm=BB_RADIUS_MM,
        tolerance_mm=TOL_MM)) for size, dpmm in SIZES.items()}


def test_reference_cutoffs_match_jax(jref):
    got = batch_find.reference_cutoffs()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jref.batch.reference_cutoffs())
    np.testing.assert_array_equal(batch_find.reference_cutoffs(0.1, 0.9),
                                  jref.batch.reference_cutoffs(0.1, 0.9))


@pytest.mark.parametrize("size", list(SIZES))
def test_bb_scan_matches_jax(jax_scans, size):
    dpmm = SIZES[size]
    got = batch_find.bb_scan_core(
        torch.from_numpy(WINDOWS[size]), torch.from_numpy(batch_find.reference_cutoffs()),
        K=24, dpmm=dpmm, bb_radius_mm=BB_RADIUS_MM, tolerance_mm=TOL_MM).numpy()
    want = jax_scans[size]
    assert got.shape == want.shape == (4, 1 + 3 * 24)
    np.testing.assert_array_equal(got[:, :25], want[:, :25])     # found, kept
    assert got[:3, 0].all() and not got[3, 0]                    # BB found but in the last
    kept = got[:, 1:25].astype(bool)
    np.testing.assert_allclose(got[:, 25:][np.tile(kept, 2)], want[:, 25:][np.tile(kept, 2)],
                               rtol=0, atol=TOL_PX)


@pytest.mark.parametrize("size", list(SIZES))
def test_region_properties_match_jax(jref, size):
    """The batched region properties of every threshold mask of the scan,
    with the convex hull on: counts, bboxes, perimeters and convex areas
    exact, weighted centroids within 1e-3 px."""
    w = WINDOWS[size][:2]
    cut = batch_find.reference_cutoffs()[:50:4]
    masks = (w[None] > cut[:, None, None, None]).reshape(-1, size, size)
    intens = np.broadcast_to(w[None], (len(cut),) + w.shape).reshape(-1, size, size)
    got = label.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(intens.copy()),
                                  K=24, connectivity=1, moments=False).to_numpy()
    want = jref.label.regionprops_batch(jref.jnp.asarray(masks), jref.jnp.asarray(intens),
                                        K=24, connectivity=1, moments=False)
    valid = got.valid
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    assert valid.sum() > 10
    for name in ("area", "area_filled", "bbox_rmin", "bbox_cmin", "bbox_rmax", "bbox_cmax",
                 "perimeter", "touches_border", "convex_area"):
        np.testing.assert_array_equal(getattr(got, name)[valid],
                                      np.asarray(getattr(want, name))[valid], err_msg=name)
    for name in ("weighted_centroid_r", "weighted_centroid_c", "centroid_r", "centroid_c"):
        np.testing.assert_allclose(getattr(got, name)[valid],
                                   np.asarray(getattr(want, name))[valid], rtol=0, atol=TOL_PX,
                                   err_msg=name)


def _hull_area_loop(in_mask, rr, cc, slot, K):
    """The per-image loop of the port's first CatPhan slice, kept as the
    reference of the batched form."""
    D = 32
    thetas = np.arange(D) * (2 * np.pi / D)
    nx = torch.as_tensor(np.cos(thetas), dtype=torch.float32)
    ny = torch.as_tensor(np.sin(thetas), dtype=torch.float32)
    out = []
    for i in range(in_mask.shape[0]):
        inside = torch.ones(rr.shape[0], K, dtype=torch.bool, device=rr.device)
        for d in range(D):
            proj = rr * float(ny[d]) + cc * float(nx[d])
            support = torch.full((K + 2,), float("-inf"), device=rr.device)
            support = support.scatter_reduce(
                0, slot[i], torch.where(in_mask[i] > 0, proj, float("-inf")),
                "amax", include_self=True)[:K]
            inside &= proj[:, None] <= support[None, :] + 1e-3
        out.append(inside.sum(dim=0).to(torch.float32))
    return torch.stack(out)


@pytest.mark.parametrize("chunk_elements", [2**27, 3 * 40 * 30 * 8])
def test_batched_hull_area_equals_the_loop(monkeypatch, chunk_elements):
    monkeypatch.setattr(label, "_HULL_CHUNK_ELEMENTS", chunk_elements)
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(rng.random((7, 30, 40)) > 0.6)
    K = 8
    b, h, w = masks.shape
    n = h * w
    lab = ccl.label_batch(masks, 1).reshape(b, n).to(torch.int64)
    ar = torch.arange(n)
    roots = torch.where(masks.reshape(b, n) & (lab == ar), ar, n)
    ids = torch.topk(roots, K + 1, dim=1, largest=False, sorted=True).values
    slot, _ = label._slots(ids, lab, K + 1)
    rr = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w).reshape(n)
    cc = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w).reshape(n)
    in_mask = masks.reshape(b, n).to(torch.float32)
    got = label._hull_area(in_mask, rr, cc, slot, K)
    assert torch.equal(got, _hull_area_loop(in_mask, rr, cc, slot, K))
    assert got.shape == (b, K) and got.sum() > 0


def test_batched_windows_match_jax(jref):
    """``batched_bb_windows`` groups windows by shape and prepares them
    (invert, stretch) on the host, as the JAX function does."""
    raw = [1000 - np.asarray(WINDOWS[134][1]) * 1000, 1000 - np.asarray(WINDOWS[58][0]) * 1000]
    got = batch_find.batched_bb_windows(raw, 2.976, BB_RADIUS_MM, TOL_MM, device="cpu")
    want = jref.batch.batched_bb_windows(raw, 2.976, BB_RADIUS_MM, TOL_MM)
    assert [len(g) for g in got] == [len(x) for x in want] == [1, 1]
    for g, x in zip(got, want):
        np.testing.assert_allclose(np.array(g).reshape(-1, 2), np.array(x).reshape(-1, 2),
                                   rtol=0, atol=TOL_PX)


@pytest.mark.parametrize("size", list(SIZES))
def test_find_features_matches_jax(jref, size):
    """The sequential finder on a window (BB bright), with each package's
    own default BB conditions."""
    dpmm = SIZES[size]
    sample = WINDOWS[size][0]
    kwargs = dict(top_offset=10, left_offset=20, min_number=1, max_number=1, dpmm=dpmm,
                  radius_mm=BB_RADIUS_MM, radius_tolerance_mm=TOL_MM, min_separation_mm=5)
    conds = ("is_right_size_bb", "is_round", "is_right_circumference", "is_symmetric",
             "is_solid")
    pts, bounds, regions = utils.find_features(
        sample, detection_conditions=[getattr(features, c) for c in conds], device="cpu",
        **kwargs)
    jpts, jbounds, jregions = jref.utils.find_features(
        sample, detection_conditions=[getattr(jref.features, c) for c in conds], **kwargs)
    assert len(pts) == len(jpts) == 1
    assert abs(pts[0].x - jpts[0].x) < TOL_PX and abs(pts[0].y - jpts[0].y) < TOL_PX
    np.testing.assert_array_equal(bounds[0], jbounds[0])
    for attr in ("bbox", "area", "area_filled", "perimeter", "solidity"):
        assert getattr(regions[0], attr) == getattr(jregions[0], attr), attr
    with pytest.raises(ValueError, match="minimum number"):
        utils.find_features(np.zeros((size, size)) + 0.5 * (np.arange(size) > size // 2),
                            detection_conditions=[features.is_solid], device="cpu", **kwargs)


def test_window_scans_default_to_cuda(monkeypatch):
    """``device=None`` means CUDA in both window scans, as in every entry of
    the port: without a card they raise and name the CPU route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    window = np.asarray(WINDOWS[58][0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_find.batched_bb_windows([window], 2.976, BB_RADIUS_MM, TOL_MM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utils.find_features(window, top_offset=0, left_offset=0, min_number=1, max_number=1,
                            dpmm=2.976, detection_conditions=[features.is_solid],
                            radius_mm=BB_RADIUS_MM, radius_tolerance_mm=TOL_MM,
                            min_separation_mm=5)


def test_wl_predicates_match_jax(jref):
    from pylinac_tpu.winston_lutz import (is_modest_size, is_near_center,
                                          is_right_square_size, is_square)

    masks = torch.from_numpy(WINDOWS[134][:1] > 0.5)
    regions = label.regionprops_batch(masks, K=8).to_numpy()
    views = utils.valid_region_views(label.Regions(*[f[0] for f in regions]))
    assert views
    kw = dict(dpmm=2.976, bb_size=5, rad_size=20, shape=(134, 134), tolerance=TOL_MM)
    for port, ref in ((features.is_near_center, is_near_center),
                      (features.is_modest_size, is_modest_size),
                      (features.is_square, is_square),
                      (features.is_right_square_size, is_right_square_size)):
        for v in views:
            assert port(v, **kw) == ref(v, **kw), port.__name__
    assert math.isclose(views[0].area_filled, views[0].filled_area)
