"""The port's connected-component labelling against the JAX package's.

Tolerance: none. Every form computes the same fixpoint, the minimum linear
index of each component (and -1 / -2 for reached background and
foreground in hole mode), so labels are equal integer for integer: the
port's plain twins against JAX's XLA formulation (``label.label``,
``label._holes_xla``) and against the batched Pallas kernels run in
interpret mode, as ``tests/ops/test_label_batch.py`` runs them.

The JAX package is imported in a fixture, so that the card test (marker
``cuda``) also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ccl.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import ccl


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jnp, ``ops.label`` and ``ops.pallas_label``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.ops import label, pallas_label

    return SimpleNamespace(jnp=jnp, label=label, pallas_label=pallas_label)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masks() -> dict[str, np.ndarray]:
    """The masks of ``tests/ops/test_pallas_label.py:33-51``: rings, speckle,
    a spiral (the worst case for sweep convergence), empty and full."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :128]
    ring = np.abs(np.sqrt((yy - 32) ** 2 + (xx - 64) ** 2) - 25) < 1.5
    spiral_t = np.linspace(0, 6 * np.pi, 4000)
    sr = 2 + spiral_t * 1.4
    sy = (32 + sr * np.sin(spiral_t)).astype(int)
    sx = (64 + sr * np.cos(spiral_t)).astype(int)
    keep = (sy >= 0) & (sy < 64) & (sx >= 0) & (sx < 128)
    spiral = np.zeros((64, 128), bool)
    spiral[sy[keep], sx[keep]] = True
    return {
        "speckle": rng.random((64, 128)) > 0.7,
        "sparse": rng.random((64, 128)) > 0.97,
        "ring+noise": ring | (rng.random((64, 128)) > 0.95),
        "spiral": spiral,
        "empty": np.zeros((64, 128), bool),
        "full": np.ones((64, 128), bool),
    }


MASKS = _masks()
STACK = np.stack(list(MASKS.values()))


def _jax_holes(jref, mask: np.ndarray) -> np.ndarray:
    """Hole roots from JAX's XLA form: -2 foreground, -1 reached background,
    else the background label."""
    holes, bg = jref.label._holes_xla(jref.jnp.asarray(mask))
    return np.where(mask, -2, np.where(np.asarray(holes), np.asarray(bg), -1))


@pytest.fixture(scope="module")
def pallas_out(jref):
    """The batched Pallas kernel in interpret mode over all masks at once:
    labels for connectivity 1 and 2, and hole roots."""
    stack = jref.jnp.asarray(STACK)
    pl = jref.pallas_label
    return {
        1: np.asarray(pl.label_batched_pallas(stack, connectivity=1, interpret=True)),
        2: np.asarray(pl.label_batched_pallas(stack, connectivity=2, interpret=True)),
        "holes": np.asarray(pl.hole_roots_batched(stack, interpret=True)),
    }


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", list(MASKS))
def test_label_matches_jax(jref, pallas_out, name, connectivity):
    mask = MASKS[name]
    got = ccl.label(torch.from_numpy(mask), connectivity).numpy()
    assert got.dtype == np.int32
    ref = np.asarray(jref.label.label(jref.jnp.asarray(mask), connectivity=connectivity))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas_out[connectivity][list(MASKS).index(name)])


@pytest.mark.parametrize("name", list(MASKS))
def test_hole_roots_match_jax(jref, pallas_out, name):
    mask = MASKS[name]
    got = ccl.hole_roots(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _jax_holes(jref, mask))
    np.testing.assert_array_equal(got, pallas_out["holes"][list(MASKS).index(name)])


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_batch_is_per_image(connectivity):
    got = ccl.label_batch(torch.from_numpy(STACK), connectivity)
    for i, mask in enumerate(STACK):
        assert torch.equal(got[i], ccl.label_reference(torch.from_numpy(mask[None]), connectivity)[0])


def test_hole_roots_batch_is_per_image():
    got = ccl.hole_roots_batch(torch.from_numpy(STACK))
    for i, mask in enumerate(STACK):
        assert torch.equal(got[i], ccl.hole_roots_reference(torch.from_numpy(mask[None]))[0])


def test_holes_of_a_ring_are_its_inside():
    yy, xx = np.mgrid[:40, :50]
    ring = np.abs(np.hypot(yy - 20, xx - 25) - 12) < 2
    got = ccl.hole_roots(torch.from_numpy(ring)).numpy()
    inside = (np.hypot(yy - 20, xx - 25) < 12) & ~ring
    assert (got[inside] == np.flatnonzero(inside)[0]).all()
    assert (got[ring] == -2).all()
    assert (got[~ring & ~inside] == -1).all()


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (2, 1, 7), (3, 5, 1)])
def test_tiny_shapes(jref, shape):
    masks = np.random.default_rng(sum(shape)).random(shape) > 0.4
    got = ccl.label_batch(torch.from_numpy(masks), 2).numpy()
    holes = ccl.hole_roots_batch(torch.from_numpy(masks)).numpy()
    for i in range(shape[0]):
        ref = np.asarray(jref.label.label(jref.jnp.asarray(masks[i]), connectivity=2))
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(holes[i], _jax_holes(jref, masks[i]))


def test_rejects_float():
    with pytest.raises(TypeError):
        ccl.label_batch(torch.zeros(1, 4, 4))
    with pytest.raises(TypeError):
        ccl.hole_roots_batch(torch.zeros(1, 4, 4, dtype=torch.uint8))


def test_rejects_non_contiguous():
    with pytest.raises(ValueError):
        ccl.label_batch(torch.zeros(1, 4, 6, dtype=torch.bool)[:, :, ::2])
    with pytest.raises(ValueError):
        ccl.hole_roots(torch.zeros(4, 6, dtype=torch.bool)[:, ::2])


@pytest.mark.parametrize("shape", [(4,), (4, 4), (1, 1, 4, 4)])
def test_rejects_rank(shape):
    with pytest.raises(ValueError):
        ccl.label_batch(torch.zeros(shape, dtype=torch.bool))


def test_rejects_connectivity():
    with pytest.raises(ValueError):
        ccl.label_batch(torch.zeros(1, 4, 4, dtype=torch.bool), 3)


def test_rejects_int32_overflow():
    # B * H * W = 2**31: global indices would not fit int32 (meta: no memory)
    masks = torch.empty((2, 2**15, 2**15), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ccl.label_batch(masks)


def test_cpu_takes_the_twin_and_counts_no_launch():
    before = (ccl.label_batch.launches, ccl.hole_roots_batch.launches)
    ccl.label_batch(torch.from_numpy(STACK[:2]), 2)
    ccl.hole_roots_batch(torch.from_numpy(STACK[:2]))
    assert (ccl.label_batch.launches, ccl.hole_roots_batch.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 512, 512), (6, 64, 128)])
def test_kernel_matches_twin_on_card(cuda, shape):
    rng = np.random.default_rng(11)
    masks = torch.from_numpy(STACK if shape == (6, 64, 128) else rng.random(shape) > 0.6)
    for connectivity in (1, 2):
        before = ccl.label_batch.launches
        got = ccl.label_batch(masks.to(cuda), connectivity)
        torch.cuda.synchronize()
        assert ccl.label_batch.launches == before + 1
        assert torch.equal(got.cpu(), ccl.label_reference(masks, connectivity))
    before = ccl.hole_roots_batch.launches
    got = ccl.hole_roots_batch(masks.to(cuda))
    torch.cuda.synchronize()
    assert ccl.hole_roots_batch.launches == before + 1
    assert torch.equal(got.cpu(), ccl.hole_roots_reference(masks))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 4, 4), (2, 0, 5)])
def test_empty_batch_on_card_counts_no_launch(cuda, shape):
    masks = torch.zeros(shape, dtype=torch.bool, device=cuda)
    before = (ccl.label_batch.launches, ccl.hole_roots_batch.launches)
    assert ccl.label_batch(masks, 2).shape == shape
    assert ccl.hole_roots_batch(masks).shape == shape
    assert (ccl.label_batch.launches, ccl.hole_roots_batch.launches) == before
