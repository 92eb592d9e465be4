"""The port's 3x3 median against the JAX package's.

Tolerance: none. Every form computes one exact order statistic (rank 4 of
9) of the same float32 values, so results are bit-equal, ties included.
Inputs are finite, as on the main path (frames widened from uint16). The
CUDA kernel's network (sort each 3-pixel column, then med3 of the largest
low, the middle middle and the smallest high) is modelled here in numpy,
min/max for min/max as ``csrc/median3x3.cu`` writes it, and held to rank 4
on every input over {0, 1, 2}.

The JAX package is imported in a fixture, so that the card tests (marker
``cuda``) also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_median.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pylinac_tpu_torch.core import array_utils as tau
from pylinac_tpu_torch.ops import filters as tfilters
from pylinac_tpu_torch.ops.median import median3x3, median3x3_reference

SHAPES = [(1, 1), (1, 2), (2, 3), (3, 1), (5, 7), (37, 129), (64, 65)]
# the kernel checks of chip_smoke.py: W = 1, H = 1, W = 1, 2, 3 (mod 4),
# widths below one thread's 4 columns, odd pitches (no float2 loads), and
# heights around one thread's 16 rows and one block's 64
CARD_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 37, 129), (2, 1280, 1280), (2, 1, 9), (2, 9, 1),
               (1, 70, 129), (1, 70, 130), (1, 70, 131), (2, 65, 3), (2, 64, 2), (1, 17, 6)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jnp, ``ops.pallas_median``, ``ops.filters`` and
    ``core.array_utils``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.core import array_utils
    from pylinac_tpu.ops import filters, pallas_median

    return SimpleNamespace(jnp=jnp, pallas_median=pallas_median, filters=filters,
                           array_utils=array_utils)


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


# image dtypes and the dtype the kernel computes them in
FILTER_DTYPES = [(np.uint8, torch.float32), (np.int16, torch.float32),
                 (np.uint16, torch.float32), (np.float32, torch.float32),
                 (np.float64, torch.float32), (np.int32, torch.int32),
                 (np.uint32, torch.int32)]


def _typed_image(shape, dtype, seed):
    """Integers over the dtype's whole range, or floats around 100."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)
    return rng.normal(100.0, 20.0, size=shape).astype(dtype)


@pytest.fixture
def kernel_calls(monkeypatch):
    """The dtype of every tensor ``ops.filters`` hands to ``median3x3``."""
    calls = []

    def spy(x):
        calls.append(x.dtype)
        return median3x3(x)

    monkeypatch.setattr(tfilters, "median3x3", spy)
    return calls


@pytest.mark.parametrize("dtype, work", FILTER_DTYPES)
def test_filter_median_matches_jax_in_every_dtype(jref, kernel_calls, dtype, work):
    x = _typed_image((37, 45), dtype, seed=5)
    got = tau.filter(x, 3, device="cpu")
    assert got.dtype == x.dtype
    assert kernel_calls == [work]
    np.testing.assert_array_equal(got, jref.array_utils.filter(x, 3))
    if dtype is not np.float64:
        np.testing.assert_array_equal(got, ndi.median_filter(x, size=3, mode="reflect"))


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.uint32, np.int64])
def test_median3x3_array_stack_is_per_image(kernel_calls, dtype):
    x = _typed_image((3, 19, 23), dtype, seed=9)
    got = tau.median3x3_array(x, device="cpu")
    assert got.dtype == x.dtype
    assert len(kernel_calls) == (0 if dtype is np.int64 else 1)
    # rank 4 of each edge-replicated window, sorted in the dtype itself
    # (scipy goes through float64 for int64)
    windows = np.lib.stride_tricks.sliding_window_view(
        np.pad(x, [(0, 0), (1, 1), (1, 1)], mode="edge"), (3, 3), axis=(1, 2))
    np.testing.assert_array_equal(got, np.sort(windows.reshape(*x.shape, 9), axis=-1)[..., 4])


def test_image_median_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _typed_image((8, 9), np.uint16, seed=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tau.median3x3_array(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tau.filter(x, 3)


def test_median3x3_array_rejects_wide_dtypes_off_the_cpu():
    with pytest.raises(TypeError, match="float32 or int32"):
        tau.median3x3_array(np.zeros((4, 4), np.int64), device="meta")


def _kernel_median9(p: np.ndarray) -> np.ndarray:
    """Median of (..., 3, 3) windows (rows, columns) by the kernel's network,
    min/max for min/max: sort each column (6), then med3(max of the lows,
    med3 of the middles, min of the highs)."""
    above, here, below = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    l1, h1 = np.minimum(above, here), np.maximum(above, here)
    t = np.maximum(l1, below)
    lo, mid, hi = np.minimum(l1, below), np.minimum(h1, t), np.maximum(h1, t)

    def med3(a, b, c):
        return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))

    low = np.maximum(np.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    high = np.minimum(np.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return med3(low, med3(mid[..., 0], mid[..., 1], mid[..., 2]), high)


def test_kernel_network_is_rank_4_on_every_ternary_window():
    windows = np.array(np.meshgrid(*[np.arange(3)] * 9, indexing="ij")).reshape(9, -1).T
    got = _kernel_median9(windows.reshape(-1, 3, 3).astype(np.float32))
    np.testing.assert_array_equal(got, np.sort(windows, axis=1)[:, 4])
    assert len(windows) == 3**9


@pytest.mark.parametrize("kind", ["noise", "ties"])
def test_kernel_network_matches_twin(kind):
    """The network on every 3x3 window of seeded images (edges replicated)
    equals the twin."""
    x = _image((3, 41, 67), kind, seed=13)
    padded = np.pad(x, [(0, 0), (1, 1), (1, 1)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (3, 3), axis=(1, 2))
    np.testing.assert_array_equal(_kernel_median9(windows),
                                  median3x3_reference(torch.from_numpy(x)).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_twin_on_card(cuda, shape):
    x = torch.from_numpy(_image(shape, "ties", seed=11))
    before = median3x3.launches
    got = median3x3(x.to(cuda))
    torch.cuda.synchronize()
    assert median3x3.launches == before + 1
    assert torch.equal(got.cpu(), median3x3_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.uint16, np.float64])
def test_filter_median_launches_kernel_in_every_dtype(cuda, dtype):
    x = _typed_image((3, 70, 131), dtype, seed=17)
    before = median3x3.launches
    got = tau.median3x3_array(x, cuda)
    assert median3x3.launches == before + 1
    np.testing.assert_array_equal(got, tau.median3x3_array(x, "cpu"))
    image = tau.filter(x[0], 3, device=cuda)
    assert median3x3.launches == before + 2
    np.testing.assert_array_equal(image, got[0])
