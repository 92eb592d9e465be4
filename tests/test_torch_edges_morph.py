"""The port's Canny edges, binary morphology, Frangi vesselness and Hough
lines against the JAX package's, on the CPU.

``canny`` runs on two seeded images (120 x 150 and 257 x 300) at sigma 2,
4 and 9, and on the planar tests' frames at the sigma of their phantom
finders (the QC-3 of ``tests/models/test_planar_imaging.py`` at 768 x 1024,
sigma 2; the mammography phantom of ``tests/models/test_acr_mammo.py`` at
1024 x 768, sigma 9), with the quantile thresholds the finder uses: the
edge masks are equal bit for bit. The detection's ``regionprops`` (K =
128) of a ``keep_largest`` mask equals JAX's. ``keep_largest`` itself does
not: JAX labels there with ``max_iter=64`` and on the QC-3 edges that label
stops before its fixpoint (ROADMAP section 3), splitting components, so
JAX keeps other small components than the fixpoint labelling of
``scipy.ndimage.label``, which the port's keeps (the phantom outline is
kept by both, and the analyses agree). The morphology is exact (masks equal); ``frangi``
takes ``exp`` in float64 where XLA has its own float32 polynomial, so its
values agree within 2 ulp of 1 (2.4e-7) and the Yen masks of the fibre
test images are equal. The Hough transform and its peaks are host numpy
in both packages and equal. The ``cuda`` test holds the binary
morphology on the card against the CPU at the fibre ROIs' footprint and
window shapes: ``python -m pytest --noconftest -m cuda
tests/test_torch_edges_morph.py``.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import edges as tedges
from pylinac_tpu_torch.ops import label as tlabel
from pylinac_tpu_torch.ops import morphology as tmorph
from pylinac_tpu_torch.ops import vesselness as tvessel
from pylinac_tpu_torch.ops.threshold import threshold_yen
from pylinac_tpu_torch.planar_imaging import hough_line, hough_line_peaks

QUANTILES = dict(low_threshold=0.001, high_threshold=0.01, use_quantiles=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _seeded(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    a = np.zeros((h, w))
    a[(abs(yy - h / 2) < h / 4) & (abs(xx - w / 2) < w / 3)] = 500
    a[((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (h / 8) ** 2] = 800
    return (a + rng.normal(0, 20, a.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Float32 frames as the phantom classes see them after load."""
    from tests.models.test_acr_mammo import make_mammo_image
    from tests.models.test_planar_imaging import _make_qc3_image

    from pylinac_tpu_torch.core import image

    d = tmp_path_factory.mktemp("edges")
    out = {}
    for name, make in (("qc3", _make_qc3_image), ("mammo", make_mammo_image)):
        path = str(d / f"{name}.dcm")
        make(path)
        img = image.load(path)
        img.ground()
        img.normalize()
        out[name] = np.asarray(img.array, np.float32)
    out["small"] = _seeded(120, 150, 120)
    out["odd"] = _seeded(257, 300, 257)
    return out


CANNY_CASES = ([(name, sigma) for name in ("small", "odd") for sigma in (2, 4, 9)]
               + [("qc3", 2), ("mammo", 9)])


@pytest.mark.parametrize("name,sigma", CANNY_CASES)
def test_canny_equals_jax(jax_cpu, frames, name, sigma):
    import jax.numpy as jnp

    from pylinac_tpu.ops.edges import canny

    x = frames[name]
    j = np.asarray(canny(jnp.asarray(x), sigma=float(sigma), **QUANTILES))
    t = tedges.canny(torch.from_numpy(x), sigma=sigma, **QUANTILES).numpy()
    assert j.any()
    np.testing.assert_array_equal(t, j)


def test_canny_fixed_thresholds_equal_jax(jax_cpu, frames):
    import jax.numpy as jnp

    from pylinac_tpu.ops.edges import canny

    x = frames["odd"] / 800
    j = np.asarray(canny(jnp.asarray(x), sigma=1.0, low_threshold=0.05, high_threshold=0.2))
    t = tedges.canny(torch.from_numpy(x), sigma=1.0, low_threshold=0.05, high_threshold=0.2)
    np.testing.assert_array_equal(t.numpy(), j)


def test_hypot_equals_jnp_hypot(jax_cpu):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    a = (rng.normal(0, 1, 50000) * 10 ** rng.uniform(-20, 20, 50000)).astype(np.float32)
    b = (rng.normal(0, 1, 50000) * 10 ** rng.uniform(-20, 20, 50000)).astype(np.float32)
    a[:4] = [0, np.inf, -3, 0]
    b[:4] = [0, 1, np.inf, 5]
    j = np.asarray(jax_cpu.jit(jnp.hypot)(a, b))
    t = tedges.hypot_f32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(t, j)


def test_fused_percentile_equals_jitted_jnp_percentile(jax_cpu):
    """Canny's quantile thresholds: ``fma(lo, 1 - w, hi * w)`` as the jitted
    ``jnp.percentile`` mixes its order statistics (the unfused mix differs
    on about a quarter of these)."""
    import jax.numpy as jnp

    from pylinac_tpu_torch.ops.stats import percentile_f32

    rng = np.random.default_rng(0)
    jitted = jax_cpu.jit(lambda m: jnp.percentile(m, jnp.asarray([0.1, 1.0])))
    unfused_differs = 0
    for _ in range(60):
        m = (rng.random(int(rng.integers(1000, 50000))) ** 3
             * 10 ** rng.uniform(-3, 3)).astype(np.float32)
        want = np.asarray(jitted(m))
        t = torch.from_numpy(m)[None]
        np.testing.assert_array_equal(percentile_f32(t, [0.1, 1.0], fused=True)[0].numpy(), want)
        unfused_differs += int((percentile_f32(t, [0.1, 1.0])[0].numpy() != want).any())
    assert unfused_differs > 0


@pytest.fixture(scope="module")
def qc3_edges(jax_cpu, frames):
    import jax.numpy as jnp

    from pylinac_tpu.ops.edges import canny

    return np.asarray(canny(jnp.asarray(frames["qc3"]), sigma=2.0, **QUANTILES))


def _fixpoint_keep_largest(mask, K, min_area):
    """``keep_largest`` on scipy's 8-connected labels."""
    from scipy import ndimage

    lab, n = ndimage.label(mask, structure=np.ones((3, 3)))
    counts = np.bincount(lab.ravel(), minlength=n + 1).astype(np.float32)
    counts[0] = 0
    padded = np.zeros(mask.size + 1, np.float32)
    padded[:n + 1] = counts
    kth = np.sort(padded)[-K]
    keep = (counts >= max(kth, min_area)) & (counts > 0)
    return mask & keep[lab]


def test_keep_largest_is_the_fixpoint(frames, qc3_edges):
    t = tlabel.keep_largest(torch.from_numpy(qc3_edges.copy()), K=96, min_area=20, connectivity=2)
    np.testing.assert_array_equal(t.numpy(), _fixpoint_keep_largest(qc3_edges, 96, 20))


def test_jax_capped_label_splits_components(jax_cpu, qc3_edges):
    """A reference fault, pinned and not copied: JAX's ``keep_largest``
    labels with ``max_iter=64``, which on the QC-3's sigma-2 edges stops
    before the fixpoint; some of scipy's components get two or more ids, and
    JAX keeps another set of small components."""
    import jax.numpy as jnp
    from scipy import ndimage

    from pylinac_tpu.ops import label as jlabel

    capped = np.asarray(jlabel.label(jnp.asarray(qc3_edges), connectivity=2, max_iter=64))
    full = np.asarray(jlabel.label(jnp.asarray(qc3_edges), connectivity=2, max_iter=512))
    ref, n = ndimage.label(qc3_edges, structure=np.ones((3, 3)))
    fg = ref > 0
    assert len(np.unique(full[fg])) == n
    assert len(np.unique(capped[fg])) > n
    j_big = np.asarray(jlabel.keep_largest(jnp.asarray(qc3_edges), K=96, min_area=20,
                                           connectivity=2))
    assert (j_big != _fixpoint_keep_largest(qc3_edges, 96, 20)).any()


def test_detection_regions_equal_jax(jax_cpu, frames, qc3_edges):
    """The phantom finder's ``regionprops`` (K = 128, 8-connected, no hull)
    on the kept components, with the frame as intensity."""
    import jax.numpy as jnp

    from pylinac_tpu.metrics.utils import valid_region_views
    from pylinac_tpu.ops import label as jlabel
    from pylinac_tpu_torch.metrics.utils import valid_region_views as t_valid

    x = frames["qc3"]
    big = _fixpoint_keep_largest(qc3_edges, 96, 20)
    j_views = valid_region_views(jlabel.regionprops(jnp.asarray(big), jnp.asarray(x), K=128,
                                                    connectivity=2, hull=False))
    t_views = t_valid(tlabel.regionprops(torch.from_numpy(big), torch.from_numpy(x), K=128,
                                         connectivity=2, hull=False))
    assert len(t_views) == len(j_views) > 0
    for tv, jv in zip(t_views, j_views):
        assert tv.bbox == jv.bbox
        assert tv.area == jv.area and tv.bbox_area == jv.bbox_area
        assert tv.orientation == pytest.approx(jv.orientation, abs=1e-6)
        np.testing.assert_allclose(tv.centroid, jv.centroid, atol=1e-3)


@pytest.fixture(scope="module")
def mask():
    rng = np.random.default_rng(3)
    return rng.random((60, 70)) > 0.6


@pytest.mark.parametrize("radius", [1.5, 3])
def test_isotropic_erosion(jax_cpu, mask, radius):
    import jax.numpy as jnp

    from pylinac_tpu.ops import morphology as jm

    j = np.asarray(jm.isotropic_erosion(jnp.asarray(mask), radius))
    np.testing.assert_array_equal(tmorph.isotropic_erosion(torch.from_numpy(mask), radius), j)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_boundaries_and_small_objects(jax_cpu, mask, connectivity):
    import jax.numpy as jnp

    from pylinac_tpu.ops import morphology as jm

    m, jmask = torch.from_numpy(mask), jnp.asarray(mask)
    for name, kw in (("find_boundaries", {}), ("remove_small_objects", {"min_size": 5}),
                     ("remove_small_holes", {"area_threshold": 5})):
        j = np.asarray(getattr(jm, name)(jmask, connectivity=connectivity, **kw))
        t = getattr(tmorph, name)(m, connectivity=connectivity, **kw).numpy()
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("angle", [45, -45, 30, 0])
def test_rotated_footprint_closing(jax_cpu, mask, angle):
    import jax.numpy as jnp

    from pylinac_tpu.ops import morphology as jm

    fp = jm.rotate_footprint(np.ones((5, 8)), angle)
    np.testing.assert_array_equal(tmorph.rotate_footprint(np.ones((5, 8)), angle), fp)
    for name in ("binary_dilation", "binary_erosion", "binary_closing"):
        j = np.asarray(getattr(jm, name)(jnp.asarray(mask), fp))
        t = getattr(tmorph, name)(torch.from_numpy(mask), fp).numpy()
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [45, -45])
def test_card_morphology_equals_cpu(angle):
    """The binary counts on the card (cuDNN picks the convolution's
    algorithm) against the CPU's, with the fibre ROIs' footprint at 0.07 mm
    (``rotate_footprint(ones((5, 29)), -angle)``, ``max_gap`` 4 mm) at the
    fibre windows' shapes, on sparse ridge-like and dense masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fp = tmorph.rotate_footprint(np.ones((5, int(np.ceil(4.0 * 0.5 / 0.07)))), -angle)
    rng = np.random.default_rng(angle % 97)
    for shape in [(279, 279), (280, 281), (286, 286), (97, 103)]:
        for density in (0.02, 0.5):
            m = torch.from_numpy(rng.random(shape) < density)
            for name in ("binary_dilation", "binary_erosion", "binary_closing"):
                got = getattr(tmorph, name)(m.cuda(), fp).cpu()
                np.testing.assert_array_equal(got, getattr(tmorph, name)(m, fp),
                                              err_msg=f"{name} {shape} {density}")
            for radius in (1.5, 3, 7.5):
                np.testing.assert_array_equal(tmorph.isotropic_erosion(m.cuda(), radius).cpu(),
                                              tmorph.isotropic_erosion(m, radius))


def test_block_reduce(mask):
    from pylinac_tpu.ops import morphology as jm

    a = np.arange(7 * 9, dtype=float).reshape(7, 9)
    for func in (np.sum, np.mean, np.max):
        np.testing.assert_array_equal(tmorph.block_reduce(a, (2, 4), func),
                                      jm.block_reduce(a, (2, 4), func))


@pytest.mark.parametrize("sigmas,black", [((1.5, 2.0), False), ((3.0,), False), ((2.0,), True)])
def test_frangi(jax_cpu, sigmas, black):
    import jax.numpy as jnp

    from pylinac_tpu.ops.threshold import threshold_yen as jyen
    from pylinac_tpu.ops.vesselness import frangi

    rng = np.random.default_rng(int(sigmas[0] * 10))
    yy, xx = np.mgrid[:80, :90]
    img = (np.exp(-((yy - 0.8 * xx - 5) ** 2) / 8.0) * (-100 if black else 100)
           + rng.normal(0, 3, (80, 90))).astype(np.float32)
    j = np.asarray(frangi(jnp.asarray(img), sigmas=sigmas, black_ridges=black))
    t = tvessel.frangi(torch.from_numpy(img), sigmas, black_ridges=black).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(t > threshold_yen(t), j > jyen(j))


def test_hough_line_and_peaks():
    from pylinac_tpu.planar_imaging import hough_line as jline, hough_line_peaks as jpeaks

    img = np.zeros((200, 200), bool)
    img[20:180, 50] = True
    img[20:180, 150] = True
    img[100, 10:190] = True
    for theta in (np.deg2rad(np.linspace(-5, 5, 201)), np.deg2rad(np.linspace(40, 50, 1001)),
                  np.deg2rad(np.linspace(-90, 90, 181))):
        acc, angles, dists = hough_line(img, theta)
        jacc, jangles, jdists = jline(img, theta)
        np.testing.assert_array_equal(acc, jacc)
        np.testing.assert_array_equal(dists, jdists)
        for kw in ({"num_peaks": 1}, {"min_distance": 30, "num_peaks": 2},
                   {"min_distance": 5, "min_angle": 3, "num_peaks": 6}):
            for t, j in zip(hough_line_peaks(acc, angles, dists, **kw),
                            jpeaks(jacc, jangles, jdists, **kw)):
                np.testing.assert_array_equal(t, j)
