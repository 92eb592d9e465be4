"""The port's batched region properties against the JAX package's.

The same seeded masks and intensities go through JAX's
``label.regionprops_batch`` (XLA on the CPU) and the port's.

Tolerances: ``valid``, ``label_id``, ``area``, ``area_filled``,
``touches_border`` and the bbox are exact (integer counts, exact in float32
in any order). Centroids, weighted centroids, perimeter and the
second-moment features within 1e-4 px: the coordinate sums of these 48 x 40
images are integers below 2**24 and exact, and the port rounds the
central-moment subtraction once as XLA's fused multiply-add does, so only
the float32 intensity sums can differ, in their last bits. Intensities and
their min/max within 1e-6. The card's order of the sums (float64 one-hot
products, ``ops/stats.py:_onehot_sums``) runs here on the CPU too and is
held to JAX at the same bars; on the card, repeated calls must give the
same bits (marker ``cuda``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_regionprops.py
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pylinac_tpu_torch.ops import label as tlabel
from pylinac_tpu_torch.ops import stats as tstats

EXACT = ("valid", "area", "area_filled", "touches_border", "bbox_rmin",
         "bbox_cmin", "bbox_rmax", "bbox_cmax")
PX = ("centroid_r", "centroid_c", "weighted_centroid_r", "weighted_centroid_c",
      "perimeter", "major_axis_length", "minor_axis_length", "eccentricity",
      "orientation", "convex_area")
INTENSITY = ("mean_intensity", "max_intensity", "min_intensity")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference; ``props(**kw)`` is ``label.regionprops_batch``
    jitted once per keyword set."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from pylinac_tpu.ops import label

    @functools.cache
    def _jitted(kw):
        return jax.jit(functools.partial(label.regionprops_batch, **dict(kw)))

    def props(masks, inten, **kw):
        return _jitted(tuple(sorted(kw.items())))(jnp.asarray(masks), jnp.asarray(inten))

    return SimpleNamespace(jax=jax, jnp=jnp, label=label, props=props)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed: int, b: int = 5, h: int = 48, w: int = 40):
    rng = np.random.default_rng(seed)
    masks = rng.random((b, h, w)) > 0.55
    yy, xx = np.mgrid[:h, :w]
    masks[1] = np.abs(np.hypot(yy - h / 2, xx - w / 2) - 12) < 3   # ring with a hole
    masks[2] = np.zeros((h, w), bool)                               # empty
    masks[3] = ndi.binary_opening(masks[3], iterations=1)           # fewer, larger blobs
    return masks, rng.random((b, h, w)).astype(np.float32)


def _compare(jr, tr, hull: bool = True):
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(np.asarray(jr.label_id), tr.label_id)
    for name in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(jr, name))[valid],
                                      getattr(tr, name)[valid], err_msg=name)
    np.testing.assert_array_equal(np.asarray(jr.valid), tr.valid)
    for name in PX if hull else PX[:-1]:
        np.testing.assert_allclose(getattr(tr, name)[valid], np.asarray(getattr(jr, name))[valid],
                                   rtol=0, atol=1e-4, err_msg=name)
    for name in INTENSITY:
        np.testing.assert_allclose(getattr(tr, name)[valid], np.asarray(getattr(jr, name))[valid],
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("K", [8, 32])
def test_regionprops_batch_matches_jax(jref, seed, connectivity, K):
    masks, inten = _inputs(seed)
    jr = jref.props(masks, inten, K=K, connectivity=connectivity, hull=False)
    tr = tlabel.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(inten),
                                  K=K, connectivity=connectivity, hull=False).to_numpy()
    _compare(jr, tr, hull=False)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("moments", [False, True])
def test_flags_match_jax(jref, minmax, moments):
    masks, inten = _inputs(5)
    kw = dict(K=16, connectivity=2, hull=False, minmax=minmax, moments=moments)
    jr = jref.props(masks, inten, **kw)
    tr = tlabel.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(inten), **kw).to_numpy()
    _compare(jr, tr, hull=False)


def test_hull_matches_jax(jref):
    masks, inten = _inputs(7, b=4)
    jr = jref.props(masks, inten, K=8, connectivity=1, hull=True)
    tr = tlabel.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(inten),
                                  K=8, connectivity=1, hull=True).to_numpy()
    _compare(jr, tr)
    np.testing.assert_allclose(tr.solidity[tr.valid], np.asarray(jr.solidity)[tr.valid],
                               rtol=1e-6)


def test_single_image_matches_batch(jref):
    masks, inten = _inputs(3)
    batch = tlabel.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(inten),
                                     K=16, connectivity=2).to_numpy()
    for i in range(len(masks)):
        one = tlabel.regionprops(torch.from_numpy(masks[i]), torch.from_numpy(inten[i]),
                                 K=16, connectivity=2).to_numpy()
        for name, field in zip(one._fields, one):
            # a batch of one runs the same ops; vectorised tails may round
            # transcendental functions differently in the last bit
            np.testing.assert_allclose(field, getattr(batch, name)[i], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        _compare(jref.props(masks[i:i + 1], inten[i:i + 1], K=16, connectivity=2),
                 tlabel.Regions(*[f[None] for f in one]))


def _many_holes(n_holes: int = 40) -> np.ndarray:
    """One 48 x 48 block holding ``n_holes`` one-pixel holes, plus four
    small separate blobs."""
    mask = np.zeros((60, 60), bool)
    mask[4:52, 4:52] = True
    for k in range(n_holes):
        mask[7 + 5 * (k // 8), 7 + 5 * (k % 8)] = False
    mask[55:57, 5:7] = mask[55:57, 20:22] = mask[55:57, 35:37] = mask[55:57, 50:52] = True
    return mask


def test_counts_every_hole_beyond_k_plus_one(jref, monkeypatch):
    """40 holes against K = 4 slots: the port fills all of them, as the JAX
    CPU branch does. The JAX TPU branch (the one-hot matmul form,
    ``label.py:420-451``) keeps only the K + 1 smallest-root holes."""
    mask = _many_holes()
    got = tlabel.regionprops(torch.from_numpy(mask), K=4, connectivity=1, hull=False).to_numpy()
    block = got.area == 48 * 48 - 40
    assert block.sum() == 1
    assert got.area_filled[block][0] == 48 * 48
    assert got.area_filled[block][0] == ndi.binary_fill_holes(mask[:53]).sum()
    cpu = jref.label.regionprops(jref.jnp.asarray(mask), K=4, connectivity=1, hull=False)
    np.testing.assert_array_equal(np.asarray(cpu.area_filled), got.area_filled)
    # the env knob is read while tracing: trace a fresh function under it
    monkeypatch.setenv("PYLINAC_TPU_HOLES", "matmul")
    lab = jref.label.label(jref.jnp.asarray(mask))
    holes, bg = jref.label._holes_xla(jref.jnp.asarray(mask))
    truncated = jref.jax.jit(lambda m, l, h, g: jref.label._props_from_label(
        m, l, None, h, g, K=4, hull=False))(jref.jnp.asarray(mask), lab, holes, bg)
    assert float(np.asarray(truncated.area_filled)[block][0]) == 48 * 48 - 40 + 5


def test_clear_border_invalidates_touching_regions():
    mask = np.zeros((20, 20), bool)
    mask[0:3, 0:3] = True
    mask[8:12, 8:12] = True
    got = tlabel.clear_border(tlabel.regionprops(torch.from_numpy(mask), K=4)).to_numpy()
    assert got.valid.tolist() == [False, True, False, False]


def test_overflow_shows_k_valid_slots():
    """K or more regions show exactly K valid slots: the callers' overflow
    test (``valid.sum() >= K``) is JAX's."""
    mask = np.zeros((30, 30), bool)
    mask[::3, ::3] = True  # 100 isolated pixels
    got = tlabel.regionprops(torch.from_numpy(mask), K=8, connectivity=2).to_numpy()
    assert got.valid.sum() == 8
    assert got.label_id.tolist() == [0, 3, 6, 9, 12, 15, 18, 21, 24]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_card_order_of_sums_matches_jax(jref, monkeypatch, seed, connectivity):
    """The card's one-hot sums, run on the CPU, against JAX: the counts,
    bboxes and integer coordinate sums exact, the rest within 1e-5
    relative. JAX's float32 pixel-order sums, which the CPU's equal to the
    bit, carry about n * 2**-24 of rounding over n terms (3.4e-6 of a
    700-pixel perimeter here); the one-hot sums round once."""
    monkeypatch.setattr(tlabel, "slot_sums", tstats._onehot_sums)
    masks, inten = _inputs(seed)
    jr = jref.props(masks, inten, K=16, connectivity=connectivity, hull=False)
    tr = tlabel.regionprops_batch(torch.from_numpy(masks), torch.from_numpy(inten),
                                  K=16, connectivity=connectivity, hull=False).to_numpy()
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(np.asarray(jr.label_id), tr.label_id)
    np.testing.assert_array_equal(valid, tr.valid)
    for name in EXACT + ("centroid_r", "centroid_c"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, name))[valid],
                                      getattr(tr, name)[valid], err_msg=name)
    for name in PX[:-1] + INTENSITY:
        np.testing.assert_allclose(getattr(tr, name)[valid], np.asarray(getattr(jr, name))[valid],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096])
def test_onehot_sums_of_integers_are_exact(n):
    """Coordinate-like integer columns whose sums pass 2**24 come out exact
    (the float32 pixel-order sum does not); slots at or past k add nowhere;
    the pieces of 4096 pixels join at their edges."""
    rng = np.random.default_rng(n)
    slot = torch.from_numpy(rng.integers(0, 6, (2, n)))
    rows = torch.from_numpy(rng.integers(0, 3000, (2, n, 2))).to(torch.float32)
    values = torch.cat([rows, rows[..., :1] * rows[..., 1:]], dim=-1)  # products to 9e6
    got = tstats._onehot_sums(values, slot, 4)
    want = torch.zeros(2, 4, 3, dtype=torch.float64)
    for k in range(4):
        want[:, k] = (values.double() * (slot == k)[..., None]).sum(dim=1)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 3)
    assert torch.equal(got, want.to(torch.float32))


def test_onehot_sums_match_pixel_order():
    """Float sums of both orders agree to float32's last bits."""
    rng = np.random.default_rng(3)
    slot = torch.from_numpy(rng.integers(0, 9, (3, 5000)))
    values = torch.from_numpy(rng.random((3, 5000, 4)).astype(np.float32))
    torch.testing.assert_close(tstats._onehot_sums(values, slot, 8),
                               tstats.slot_sums(values, slot, 8), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_card_sums_repeat_bit_for_bit(cuda):
    """Ten calls on the same masks give the same bits in every field, and
    so do ten radial averages (the card's atomics would not)."""
    masks, inten = _inputs(11, b=64, h=134, w=134)
    m, i = torch.from_numpy(masks).to(cuda), torch.from_numpy(inten).to(cuda)
    first = tlabel.regionprops_batch(m, i, K=24, connectivity=1)
    for _ in range(10):
        again = tlabel.regionprops_batch(m, i, K=24, connectivity=1)
        for name, a, b in zip(first._fields, first, again):
            assert torch.equal(a, b), name
    nps = torch.from_numpy(np.random.default_rng(4).random((101, 101)).astype(np.float32)).to(cuda)
    ps1d = tstats.radial_average(nps)
    assert all(torch.equal(tstats.radial_average(nps), ps1d) for _ in range(10))
    torch.testing.assert_close(ps1d.cpu(), tstats.radial_average(nps.cpu()), rtol=1e-6, atol=0)
