"""The port's border flood and filled centroids against the JAX package's.

Tolerances: the flood is exact. Every form reaches the same fixpoint, the
background 4-connected to the border: the port's twin against the Pallas
``_flood_kernel`` run in interpret mode (as ``tests/ops/test_pallas_label.py``
runs it) and against ``_fill_holes_xla``. The filled centroids are within
1e-3 px of ``filled_centroid_packed`` in interpret mode, the bar of
``tests/ops/test_label_batch.py``: JAX sums in float32, the twin in int64.

The JAX package is imported in a fixture, so that the card tests (marker
``cuda``) also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flood.py
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import flood, label


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jax, jnp, pallas, ``ops.label`` and
    ``ops.pallas_label``."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from pylinac_tpu.ops import label as jlabel, pallas_label

    return SimpleNamespace(jax=jax, jnp=jnp, pl=pl, label=jlabel, plab=pallas_label)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spiral(h: int, w: int, turns: float = 3.0) -> np.ndarray:
    t = np.linspace(0, 2 * turns * np.pi, int(4000 * max(min(h, w) / 64, 1)))
    sr = 2 + t * 1.4 * min(h, w) / 64
    sy = (h / 2 + sr * np.sin(t)).astype(int)
    sx = (w / 2 + sr * np.cos(t)).astype(int)
    keep = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    out = np.zeros((h, w), bool)
    out[sy[keep], sx[keep]] = True
    return out


def _masks() -> dict[str, np.ndarray]:
    """The masks of ``tests/ops/test_pallas_label.py:33-51`` plus a field
    with a BB-like hole."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :128]
    ring = np.abs(np.sqrt((yy - 32) ** 2 + (xx - 64) ** 2) - 25) < 1.5
    field = np.zeros((64, 128), bool)
    field[10:50, 30:100] = True
    field[28:33, 60:66] = False
    return {
        "speckle": rng.random((64, 128)) > 0.7,
        "sparse": rng.random((64, 128)) > 0.97,
        "ring+noise": ring | (rng.random((64, 128)) > 0.95),
        "spiral": _spiral(64, 128),
        "field with hole": field,
        "empty": np.zeros((64, 128), bool),
        "full": np.ones((64, 128), bool),
    }


MASKS = _masks()


def _pallas_flood(jref, mask: np.ndarray) -> np.ndarray:
    h, w = mask.shape
    kern = functools.partial(jref.plab._flood_kernel, h=h, w=w)
    return np.asarray(jref.pl.pallas_call(
        kern, out_shape=jref.jax.ShapeDtypeStruct((h, w), jref.jnp.int32),
        interpret=True)(jref.jnp.asarray(mask, jref.jnp.int32)))


@pytest.mark.parametrize("name", list(MASKS))
def test_flood_twin_matches_pallas_kernel(jref, name):
    mask = MASKS[name]
    got = flood.flood_from_border_batch(torch.from_numpy(mask[None]))[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _pallas_flood(jref, mask))


@pytest.mark.parametrize("turns", [3.0, 8.0])
def test_spiral_fill_matches_fill_holes_xla(jref, turns):
    """A long spiral takes many sweeps; the twin has no cap and reaches the
    fixpoint of the XLA fill."""
    mask = _spiral(200, 256, turns)
    got = label.fill_holes(torch.from_numpy(mask)).numpy()
    want = np.asarray(jref.label._fill_holes_xla(jref.jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MASKS))
def test_fill_holes_matches_jax(jref, name):
    mask = MASKS[name]
    got = label.fill_holes(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.label.fill_holes(jref.jnp.asarray(mask))))


def _centroid_cases() -> np.ndarray:
    """``tests/ops/test_label_batch.py:105-124``: a field with a hole across
    a 32-column word edge, a border-touching field, noise and a blob."""
    rng = np.random.default_rng(5)
    cases = []
    m = np.zeros((60, 200), bool)
    m[10:50, 30:170] = True
    m[28:33, 60:66] = False
    cases.append(m)
    m = np.zeros((40, 96), bool)
    m[0:35, 0:96] = True
    m[5:8, 40:44] = False
    cases.append(m)
    m = rng.random((50, 130)) < 0.3
    m[20:40, 50:100] = True
    m[25:30, 70:75] = False
    cases.append(m)
    masks = np.zeros((3, 60, 200), bool)
    for i, c in enumerate(cases):
        masks[i, :c.shape[0], :c.shape[1]] = c
    return masks


def test_filled_centroid_twin_matches_packed_kernel(jref):
    masks = _centroid_cases()
    got = flood.filled_centroid_batch(torch.from_numpy(masks)).numpy()
    want = np.asarray(jref.plab.filled_centroid_packed(jref.jnp.asarray(masks), interpret=True))
    assert got.dtype == np.float32 and got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", list(MASKS))
def test_filled_centroid_twin_is_the_exact_centre_of_mass(name):
    """int64 sums divided in float64, rounded to float32."""
    mask = MASKS[name]
    filled = mask | (flood.flood_from_border_reference(torch.from_numpy(mask[None]))[0].numpy() == 0)
    yy, xx = np.mgrid[:64, :128]
    mass = max(int(filled.sum()), 1)
    want = np.array([int((filled * yy).sum()) / mass, int((filled * xx).sum()) / mass], np.float32)
    got = flood.filled_centroid_batch(torch.from_numpy(mask[None]))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_batch_is_per_image():
    stack = np.stack([MASKS[n] for n in ("speckle", "ring+noise", "spiral", "field with hole")])
    out = flood.flood_from_border_batch(torch.from_numpy(stack))
    cents = flood.filled_centroid_batch(torch.from_numpy(stack))
    for i in range(len(stack)):
        one = torch.from_numpy(stack[i])
        assert torch.equal(out[i], flood.flood_from_border(one))
        assert torch.equal(cents[i], flood.filled_centroid_batch(one[None])[0])


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (2, 1, 7), (3, 5, 1), (2, 0, 4)])
def test_tiny_shapes(shape):
    rng = np.random.default_rng(1)
    masks = rng.random(shape) > 0.5
    got = flood.flood_from_border_batch(torch.from_numpy(masks)).numpy()
    for i in range(shape[0]):
        if masks[i].size:
            # a pixel of a frame of height or width <= 2 is on the border
            np.testing.assert_array_equal(got[i], (~masks[i]).astype(np.int32))
    cents = flood.filled_centroid_batch(torch.from_numpy(masks)).numpy()
    assert cents.shape == (shape[0], 2) and np.isfinite(cents).all()


@pytest.mark.parametrize("fn", [flood.flood_from_border_batch, flood.filled_centroid_batch])
def test_rejects_bad_inputs(fn):
    with pytest.raises(TypeError):
        fn(torch.zeros(1, 4, 4))
    with pytest.raises(ValueError):
        fn(torch.zeros(1, 4, 6, dtype=torch.bool)[:, :, ::2])
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        flood.flood_from_border(torch.zeros(1, 4, 4, dtype=torch.bool))


def test_cpu_takes_the_twin_and_counts_no_launch():
    before = (flood.flood_from_border_batch.launches, flood.filled_centroid_batch.launches)
    masks = torch.from_numpy(MASKS["ring+noise"][None])
    assert torch.equal(flood.flood_from_border_batch(masks),
                       flood.flood_from_border_reference(masks))
    assert torch.equal(flood.filled_centroid_batch(masks),
                       flood.filled_centroid_reference(masks))
    assert (flood.flood_from_border_batch.launches,
            flood.filled_centroid_batch.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (3, 37, 129), (2, 64, 128),
                                   (1, 1280, 1280), (2, 134, 134)])
def test_kernel_matches_twin_on_card(cuda, shape):
    rng = np.random.default_rng(2)
    b, h, w = shape
    kinds = [rng.random(shape) > 0.7, rng.random(shape) > 0.97,
             np.broadcast_to(_spiral(h, w), shape).copy(), np.zeros(shape, bool),
             np.ones(shape, bool)]
    for masks in kinds:
        masks = torch.from_numpy(masks).to(cuda)
        before = flood.flood_from_border_batch.launches
        got = flood.flood_from_border_batch(masks)
        torch.cuda.synchronize()
        assert flood.flood_from_border_batch.launches == before + 1
        assert torch.equal(got, flood.flood_from_border_reference(masks))
        got = flood.filled_centroid_batch(masks)
        torch.cuda.synchronize()
        assert torch.equal(got, flood.filled_centroid_reference(masks))


@pytest.mark.cuda
def test_empty_batch_on_card_counts_no_launch(cuda):
    before = flood.flood_from_border_batch.launches
    out = flood.flood_from_border_batch(torch.zeros(0, 4, 4, dtype=torch.bool, device=cuda))
    assert out.shape == (0, 4, 4) and flood.flood_from_border_batch.launches == before
