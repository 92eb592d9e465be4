"""The port's 1D, geometric and Bakai gammas, its Sobel filter and
``BaseImage.gamma`` against the JAX package's.

Tolerance: rtol 1e-5, atol 1e-6, NaN masks equal. Both sides compute in
float32 with the same steps; jitted JAX (``jnp.interp``, ``jnp.hypot``) may
fuse a multiply and an add into one rounding, and ``torch.hypot`` rounds
differently from ``jnp.hypot``'s formula, each by an ulp or so. The 1D
windows are chosen with dyadic steps (``2 * DTA * rf`` a power of two), so
that ``jnp.linspace``'s float32 points equal the port's rounded float64
points; elsewhere they can differ in the last bit. The Sobel filter's taps
are small integers, so it is bit-equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.ops import filters as tfilters
from pylinac_tpu_torch.ops import gamma as tg

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jnp, ``ops.gamma``, ``ops.filters`` and
    ``core.image``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.core import image
    from pylinac_tpu.ops import filters, gamma

    return SimpleNamespace(jnp=jnp, gamma=gamma, filters=filters, image=image)


def _close(got, want, what: str) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN masks differ"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=what)


def _profiles():
    """Two shifted Gaussian profiles on 200 float32 points over [0, 10]
    (``tests/ops/test_gamma_stats.py:107-110``) with a NaN in the
    evaluation."""
    x = np.linspace(0, 10, 200).astype(np.float32)
    ref = np.exp(-((x - 5) ** 2)).astype(np.float32)
    ev = np.exp(-((x - 5.05) ** 2)).astype(np.float32)
    ev[150] = np.nan
    return x, ref, ev


@pytest.mark.parametrize("coords", [True, False], ids=["coords", "indices"])
@pytest.mark.parametrize("kw", [
    dict(distance_to_agreement=1, dose_to_agreement=2, resolution_factor=4),
    dict(distance_to_agreement=1, dose_to_agreement=2, resolution_factor=4, global_dose=False),
    dict(distance_to_agreement=0.5, dose_to_agreement=1, resolution_factor=8),
    dict(distance_to_agreement=2, dose_to_agreement=3, resolution_factor=2, dose_threshold=20,
         gamma_cap_value=1.0, fill_value=-1.0),
], ids=["dta1", "dta1-local", "dta0.5", "dta2-thr20-cap1"])
def test_gamma_1d_matches_jax(jref, kw, coords):
    x, ref, ev = _profiles()
    c = dict(reference_coordinates=x, evaluation_coordinates=x) if coords else {}
    want = jref.gamma.gamma_1d(jref.jnp.asarray(ref), jref.jnp.asarray(ev),
                               **{k: jref.jnp.asarray(v) for k, v in c.items()}, **kw)
    got = tg.gamma_1d(ref, ev, device="cpu", **c, **kw)
    for name, g, w in zip(("gamma", "eval values", "eval x"), got, want):
        _close(g, w, f"gamma_1d {name}")
    assert np.isfinite(got[0].numpy()).sum() > 20


def _geometric_profiles(n: int = 100):
    v = (np.sin(np.linspace(0, 3, n)) + 1.5).astype(np.float32)
    w = (np.sin(np.linspace(0.05, 3.05, n)) * 1.02 + 1.5).astype(np.float32)
    x = np.linspace(0, 50, n).astype(np.float32)
    return x, v, w


@pytest.mark.parametrize("coords", ["indices", "ascending", "descending"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(distance_to_agreement=2.0, dose_to_agreement=2.0),
    dict(dose_threshold=60.0, gamma_cap_value=0.5, fill_value=-1.0),
], ids=["defaults", "dta2-dose2", "thr60-cap0.5"])
def test_gamma_geometric_matches_jax(jref, kw, coords):
    x, v, w = _geometric_profiles()
    c = {}
    if coords != "indices":
        xs = x if coords == "ascending" else x[::-1].copy()
        c = dict(reference_coordinates=xs, evaluation_coordinates=xs)
    want = jref.gamma.gamma_geometric(jref.jnp.asarray(v), jref.jnp.asarray(w), **c, **kw)
    got = tg.gamma_geometric(v, w, device="cpu", **c, **kw)
    _close(got, want, f"gamma_geometric {coords} {kw}")


def _dose_images(shape=(40, 50), seed: int = 3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    img = (1000 * np.exp(-((yy - shape[0] / 2) ** 2 + (xx - shape[1] / 2) ** 2) / 200)
           + rng.normal(0, 5, shape)).astype(np.float32)
    img2 = (img * 1.02 + rng.normal(0, 5, shape)).astype(np.float32)
    return img, img2


@pytest.mark.parametrize("kw", [
    dict(),
    dict(doseTA=2, distTA=2, threshold=0.2),
    dict(ground=False, normalize=False),
], ids=["defaults", "dose2-dist2-thr0.2", "raw"])
def test_gamma_bakai_matches_jax(jref, kw):
    img, img2 = _dose_images()
    want = jref.gamma.gamma_bakai(jref.jnp.asarray(img), jref.jnp.asarray(img2), dpmm=1.5, **kw)
    got = tg.gamma_bakai(img, img2, dpmm=1.5, device="cpu", **kw)
    _close(got, want, f"gamma_bakai {kw}")
    assert np.isfinite(got.numpy()).sum() > 100


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_sobel_matches_jax(jref, dim):
    img, _ = _dose_images((17, 23), seed=4)
    img[5, 7] = np.nan
    want = np.asarray(jref.filters.sobel(jref.jnp.asarray(img), axis=dim))
    got = tfilters.sobel(torch.from_numpy(img), dim=dim).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dpi, sid", [(50.0, None), (72.0, 1500.0)])
def test_array_image_dpi_matches_jax(jref, dpi, sid):
    arr = np.zeros((4, 5), np.float32)
    want = jref.image.ArrayImage(arr, dpi=dpi, sid=sid)
    got = timage.load(arr, dpi=dpi, sid=sid)
    assert isinstance(got, timage.ArrayImage)
    assert (got.dpi, got.dpmm, got.sid) == (want.dpi, want.dpmm, want.sid)
    assert timage.ArrayImage(arr).dpmm is None


@pytest.mark.parametrize("kw", [dict(), dict(doseTA=2, distTA=2, threshold=0.2, ground=False)],
                         ids=["defaults", "dose2-dist2-thr0.2-raw"])
@pytest.mark.parametrize("invert", [False, True], ids=["upright", "inverted"])
def test_image_gamma_matches_jax(jref, kw, invert):
    img, img2 = _dose_images()
    if invert:  # the histogram check inverts the copy, not the image
        img2 = (img2.max() - img2).astype(np.float32)
    want = jref.image.load(img, dpi=50).gamma(jref.image.load(img2, dpi=50.05), **kw)
    ref = timage.load(img, dpi=50)
    got = ref.gamma(timage.load(img2, dpi=50.05), device="cpu", **kw)
    assert isinstance(got, np.ndarray)
    _close(got, want, f"BaseImage.gamma {kw}")
    np.testing.assert_array_equal(ref.array, img)


@pytest.mark.parametrize("other, match", [
    (lambda img: (img, 60.0), "DPIs"),
    (lambda img: (img[:-2], 50.0), "same size"),
    (lambda img: (img[:, :-2], 50.0), "same size"),
], ids=["dpi", "rows", "cols"])
def test_image_gamma_checks_match_jax(jref, other, match):
    img, _ = _dose_images()
    arr, dpi = other(img)
    with pytest.raises(AttributeError, match=match):
        jref.image.load(img, dpi=50).gamma(jref.image.load(arr, dpi=dpi))
    with pytest.raises(AttributeError, match=match):
        timage.load(img, dpi=50).gamma(timage.load(arr, dpi=dpi), device="cpu")


def test_dicom_image_dpi_matches_jax(jref, tmp_path):
    from pylinac_tpu_torch.imggen.simulators import AS500Image

    path = str(tmp_path / "epid.dcm")
    AS500Image(sid=1500).generate_dicom(path)
    got, want = timage.load(path), jref.image.load(path)
    assert got.dpi is not None
    assert (got.dpi, got.dpmm) == (want.dpi, want.dpmm)
