"""The port's 3x3 median against the JAX package's.

Tolerance: none. Every form computes one exact order statistic (rank 4 of
9) of the same float32 values, so results are bit-equal, ties included.
Inputs are finite, as on the main path (frames widened from uint16).

The JAX package is imported in a fixture, so that the card tests (marker
``cuda``) also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_median.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pylinac_tpu_torch.ops import filters as tfilters
from pylinac_tpu_torch.ops.median import median3x3, median3x3_reference

SHAPES = [(1, 1), (1, 2), (2, 3), (3, 1), (5, 7), (37, 129), (64, 65)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jnp, ``ops.pallas_median`` and ``ops.filters``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.ops import filters, pallas_median

    return SimpleNamespace(jnp=jnp, pallas_median=pallas_median, filters=filters)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 4, size=shape).astype(np.float32)
    return rng.normal(100.0, 20.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "ties"])
@pytest.mark.parametrize("shape", SHAPES)
def test_median3x3_matches_jax(jref, shape, kind):
    x = _image(shape, kind, seed=len(shape) * 1000 + shape[0] * 31 + shape[1])
    got = median3x3(torch.from_numpy(x)).numpy()
    pallas = np.asarray(jref.pallas_median.median3x3(jref.jnp.asarray(x)))  # interpret mode
    general = np.asarray(jref.filters._median_general(jref.jnp.asarray(x), 3))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, general)
    np.testing.assert_array_equal(got, ndi.median_filter(x, size=3, mode="reflect"))


@pytest.mark.parametrize("kind", ["noise", "ties"])
def test_median3x3_batch_is_per_image(jref, kind):
    x = _image((3, 37, 129), kind, seed=7)
    got = median3x3(torch.from_numpy(x)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jref.filters._median_general(jref.jnp.asarray(x[i]), 3)))


@pytest.mark.parametrize("size", [3, 5])
def test_median_filter_routes_by_size(jref, size):
    x = _image((23, 31), "ties", seed=size)
    got = tfilters.median_filter(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.filters._median_general(jref.jnp.asarray(x), size)))


def test_median_general_matches_jax_in_3d(jref):
    x = _image((4, 9, 11), "ties", seed=3)
    got = tfilters._median_general(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.filters._median_general(jref.jnp.asarray(x), 3)))


def test_median3x3_rejects_float64():
    with pytest.raises(TypeError):
        median3x3(torch.zeros(4, 4, dtype=torch.float64))


def test_median3x3_rejects_non_contiguous():
    with pytest.raises(ValueError):
        median3x3(torch.zeros(4, 6)[:, ::2])


@pytest.mark.parametrize("shape", [(5,), (1, 2, 3, 4)])
def test_median3x3_rejects_rank(shape):
    with pytest.raises(ValueError):
        median3x3(torch.zeros(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (3, 37, 129), (2, 1280, 1280)])
def test_kernel_matches_twin_on_card(cuda, shape):
    x = torch.from_numpy(_image(shape, "ties", seed=11))
    before = median3x3.launches
    got = median3x3(x.to(cuda))
    torch.cuda.synchronize()
    assert median3x3.launches == before + 1
    assert torch.equal(got.cpu(), median3x3_reference(x))
