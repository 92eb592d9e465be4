"""The port's CT mask-stage and module-stage ops against the JAX package's.

Tolerances, each with its reason:

- ``scharr`` and ``gaussian_filter``: 1e-6 relative to the image's peak.
  Both forms sum the same weighted shifted slices in float32; jitted XLA
  contracts some steps into fused multiply-adds, so single pixels differ in
  the last bit.
- ``otsu_threshold``: equal, or one bin apart. The histograms are equal
  (0/1 weights); the cumulative sums of ``hist * centre`` may round in
  another order and move a near-tie of the between-class variance by one
  bin.
- ``nps_bundle``: 1e-5 relative; the float32 FFTs differ in their last bits.
  The same bar holds with the card's order of the radial bin sums (float64
  one-hot products, ``ops/stats.py:_onehot_sums``) run on the CPU.
- ``find_peaks_rows``: equal to looping ``find_peaks`` (the same arithmetic
  per row), and to JAX's ``find_peaks_rows`` exactly in indices, 1e-6 in
  heights.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import filters as tfilters
from pylinac_tpu_torch.ops import peaks as tpeaks
from pylinac_tpu_torch.ops import stats as tstats
from pylinac_tpu_torch.ops import threshold as tthreshold


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

    from pylinac_tpu.ops import filters, peaks, stats, threshold

    return SimpleNamespace(jnp=jnp, filters=filters, peaks=peaks, stats=stats,
                           threshold=threshold)


def _ct_like(seed: int, shape=(96, 112)) -> np.ndarray:
    """Integer HU-like slice: a disk of water with plugs, plus noise."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    img = np.full(shape, -1000.0)
    img[np.hypot(yy - h / 2, xx - w / 2) < 0.4 * min(h, w)] = 0.0
    for k in range(5):
        cy, cx = h / 2 + 20 * np.sin(k * 1.3), w / 2 + 20 * np.cos(k * 1.3)
        img[np.hypot(yy - cy, xx - cx) < 4] = rng.integers(-900, 900)
    return (img + rng.normal(0, 5, shape)).round().astype(np.float32)


SHAPES = [(1, 1), (3, 2), (17, 9), (96, 112)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_scharr_matches_jax(jref, shape, seed):
    x = _ct_like(seed, shape) if min(shape) > 8 else \
        np.random.default_rng(seed).normal(0, 100, shape).astype(np.float32)
    got = tfilters.scharr(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.filters.scharr(jref.jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_filter_matches_jax(jref, shape, sigma):
    x = np.random.default_rng(3).normal(0, 100, shape).astype(np.float32)
    got = tfilters.gaussian_filter(torch.from_numpy(x), sigma).numpy()
    want = np.asarray(jref.filters.gaussian_filter(jref.jnp.asarray(x), sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_batched_filters_are_per_image(jref):
    x = np.stack([_ct_like(s) for s in range(3)])
    got = tfilters.gaussian_filter(tfilters.scharr(torch.from_numpy(x)), 1.0, dims=(-2, -1))
    for i in range(3):
        one = tfilters.gaussian_filter(tfilters.scharr(torch.from_numpy(x[i])), 1.0)
        assert torch.equal(got[i], one)


def _bin_width(values: np.ndarray, nbins: int = 256) -> float:
    return float(values.max() - values.min()) / nbins


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_otsu_matches_jax(jref, seed, masked):
    img = _ct_like(seed)
    edges = np.array(jref.filters.gaussian_filter(jref.filters.scharr(jref.jnp.asarray(img)), 1.0))
    h, w = img.shape
    yy, xx = np.mgrid[:h, :w]
    disk = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < 30 ** 2
    kw = {"mask": disk} if masked else {}
    want = float(jref.threshold.otsu_threshold(
        jref.jnp.asarray(edges), host=True,
        **{k: jref.jnp.asarray(v) for k, v in kw.items()}))
    got = float(tthreshold.otsu_threshold(
        torch.from_numpy(edges), **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert abs(got - want) <= _bin_width(edges[disk] if masked else edges) * 1.0001


def test_otsu_batch_is_per_image():
    x = np.stack([_ct_like(s) for s in range(4)])
    got = tthreshold.otsu_threshold_batch(torch.from_numpy(x))
    for i in range(4):
        assert float(got[i]) == float(tthreshold.otsu_threshold(torch.from_numpy(x[i])))


@pytest.mark.parametrize("length", [20, 41])
def test_nps_bundle_matches_jax(jref, length):
    rois = np.random.default_rng(length).normal(0, 3, (5, length, length)).astype(np.float32)
    got = tstats.nps_bundle(torch.from_numpy(rois), pixel_size=0.5)
    want = jref.stats.nps_bundle(jref.jnp.asarray(rois), pixel_size=0.5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def _profiles(b: int = 4, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(9)
    t = np.arange(n)
    base = np.sin(t / 7.0) ** 2 * np.exp(-t / 300)
    return np.stack([base * (1 + 0.1 * i) + rng.normal(0, 0.01, n) for i in range(b)]
                    ).astype(np.float32)


SETTINGS = [dict(threshold=0.3, peak_separation=0.021, max_number=2, search_region=(0, 0.107)),
            dict(threshold=0.3, peak_separation=0.00398, max_number=5, search_region=(0.335, 0.387)),
            dict(threshold=0.3, peak_separation=0.01, max_number=None, search_region=(0.0, 1.0)),
            dict(threshold=-np.inf, peak_separation=3, max_number=4, search_region=(10, 200))]


@pytest.mark.parametrize("kw", SETTINGS)
def test_find_peaks_rows_equals_looping_find_peaks(jref, kw):
    rows = _profiles()
    got = tpeaks.find_peaks_rows(rows, **kw)
    want = jref.peaks.find_peaks_rows(rows, **kw)
    for r, (idx, props) in enumerate(got):
        loop_idx, loop_props = tpeaks.find_peaks(rows[r], **kw)
        np.testing.assert_array_equal(idx, loop_idx)
        for key in props:
            np.testing.assert_array_equal(props[key], loop_props[key], err_msg=key)
        np.testing.assert_array_equal(idx, want[r][0])
        np.testing.assert_allclose(props["peak_heights"], want[r][1]["peak_heights"], rtol=1e-6)


@pytest.mark.parametrize("kw", SETTINGS[:2])
def test_find_valleys_matches_jax(jref, kw):
    row = _profiles()[1]
    idx, props = tpeaks.find_valleys(row, **kw)
    jidx, jprops = jref.peaks.find_valleys(row, **kw)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(props["peak_heights"], jprops["peak_heights"], rtol=1e-6)


@pytest.mark.parametrize("length", [20, 41])
def test_nps_bundle_card_order_matches_jax(jref, monkeypatch, length):
    monkeypatch.setattr(tstats, "slot_sums", tstats._onehot_sums)
    test_nps_bundle_matches_jax(jref, length)
