"""The port's 2D gamma against the JAX package's.

Tolerances:
- the port's plain twin ``gamma2d_reference`` against the Pallas
  ``_gamma_kernel`` run in interpret mode (as ``tests/ops/test_gamma_stats.py``
  runs it), on the same normalised inputs: NaN masks equal, |diff| <= 2e-6.
  XLA on the CPU may contract ``dist2 + dd * dd`` into one fused
  multiply-add; the twin rounds the product first.
- ``gamma_2d`` and ``gamma_2d_batch`` on the CPU against JAX's: NaN masks
  equal, |diff| <= 1e-5 (the prologue's divisions may round differently
  under XLA's rewrites; the measured largest difference is in each message).
- the CUDA kernel against its twin on the card: NaN masks equal and every
  other value equal to the bit.
- the kernel's row table (``row_table``) against ``offset_table``: the same
  (dy, dx, dist2) entries bit for bit; the twin walked in the kernel's
  order (rows, blocks of 4 offsets, +inf padding read against whatever lies
  past the disk) equal to the twin to the bit.

The JAX package is imported in a fixture, so that the card tests (marker
``cuda``) also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gamma.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import gamma as tg
from pylinac_tpu_torch.ops.gamma2d import (
    BLOCK, _disk_offsets, gamma2d, gamma2d_reference, offset_table, row_table)

NAN = float("nan")
SCALARS = [(2.0, 0.05, NAN), (1.5, 0.3, -1.0), (NAN, 0.05, 7.0)]  # cap, threshold_n, fill
# the shapes and dta values chip_smoke.py holds the kernel to its twin at:
# widths on every side of the kernel's 4 pixels a thread and 128 a block,
# and dta on each side of its shared-memory limits (23 | 24: the 48 KB a
# launch gets without opting in; 70 | 71: the H100's 227 KB opt-in, past
# which the kernel reads device memory)
CARD_CASES = [((1, 8, 8), 1), ((3, 40, 130), 3), ((3, 40, 130), 5), ((2, 97, 131), 9),
              ((1, 16, 16), 20), ((1, 24, 40), 47), ((16, 768, 1024), 9),
              ((1, 2, 3), 1), ((2, 9, 129), 2), ((1, 13, 131), 9), ((1, 7, 257), 4),
              ((1, 20, 30), 23), ((1, 20, 30), 24), ((1, 6, 9), 70), ((1, 6, 9), 71)]
# a cap too large to hide any candidate: every offset of the disk can win
CARD_SCALARS = SCALARS + [(40.0, 0.0, -1.0)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: jnp, ``ops.gamma`` and ``ops.pallas_gamma``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu.ops import gamma, pallas_gamma

    return SimpleNamespace(jnp=jnp, gamma=gamma, pallas=pallas_gamma)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(shape, seed: int, zeros: bool = False,
          ref_nan: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """A seeded float32 reference/evaluation pair in the manner of
    ``tests/ops/test_gamma_stats.py:58-78``: a noisy dose with NaN in the
    evaluation and (with ``ref_nan``) in the reference, values on both sides
    of a 5 % and a 30 % threshold, negative values and, with ``zeros``, zeros
    in the reference (local dose then divides by 0: NaN reference, +-inf
    evaluation). A NaN in the reference makes the global maximum, and so a
    global-dose map, all NaN."""
    rng = np.random.default_rng(seed)
    ref = (rng.random(shape) * 100 + 10).astype(np.float32)
    ev = (ref + rng.normal(0, 2, shape)).astype(np.float32)
    flat_r, flat_e = ref.reshape(-1), ev.reshape(-1)
    n = flat_r.size
    pick = rng.choice(n, size=max(6, n // 20), replace=False)
    k = len(pick) // 6
    if ref_nan:
        flat_r[pick[:k]] = np.nan
    flat_e[pick[k:2 * k]] = np.nan
    flat_r[pick[2 * k:3 * k]] = rng.random(k).astype(np.float32) * 8   # near the threshold
    flat_e[pick[3 * k:4 * k]] = -rng.random(k).astype(np.float32) * 20
    flat_r[pick[4 * k:5 * k]] = -3.0
    if zeros:
        flat_r[pick[5 * k:]] = 0.0
    return ref, ev


def _normalised(shape, dta: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``ref_n`` and the edge-padded ``eval_p`` of a pair under local dose
    with zeros, so that ``eval_p`` holds NaN and +-inf."""
    ref, ev = _pair(shape, seed, zeros=True)
    dose_ta = np.float32(0.03) * ref
    with np.errstate(divide="ignore", invalid="ignore"):
        ref_n, ev_n = ref / dose_ta, ev / dose_ta
    pad = [(0, 0)] * (len(shape) - 2) + [(dta, dta), (dta, dta)]
    return ref_n, np.pad(ev_n, pad, mode="edge")


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal NaN masks and every other value equal to the bit."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(got)
    return (torch.equal(nan, torch.isnan(want))
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _assert_close(got, want, tol: float, what: str) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaN masks differ"
    err = float(np.abs(got[~nan] - want[~nan]).max()) if (~nan).any() else 0.0
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"
    return err


def test_offset_table_is_the_reference_disk(jref):
    assert _disk_offsets(9) == jref.gamma._disk_offsets(9)
    pairs, dist2 = offset_table(9)
    assert pairs.shape == (305, 2) and dist2.dtype == np.float32
    assert [tuple(p) for p in pairs] == _disk_offsets(9)
    np.testing.assert_array_equal(
        dist2, np.float32([(dy * dy + dx * dx) / 81 for dy, dx in _disk_offsets(9)]))


@pytest.mark.parametrize("scalars", SCALARS, ids=["cap2-nan", "cap1.5-fill-1", "cap-nan"])
@pytest.mark.parametrize("dta", [1, 2, 3, 5, 9])
def test_twin_matches_pallas_interpret(jref, dta, scalars):
    cap, threshold_n, fill = scalars
    ref_n, eval_p = _normalised((29, 43), dta, seed=dta)
    want = jref.pallas.gamma2d_pallas(
        jref.jnp.asarray(ref_n), jref.jnp.asarray(eval_p), dta=dta, cap=cap,
        threshold_n=threshold_n, fill=fill, interpret=True)
    got = gamma2d_reference(torch.from_numpy(ref_n)[None], torch.from_numpy(eval_p)[None],
                            dta, cap, threshold_n, fill)[0]
    _assert_close(got.numpy(), want, 2e-6, f"twin vs Pallas at dta {dta}")


@pytest.mark.parametrize("dta", range(1, 48))
def test_row_table_is_the_offset_table(dta):
    rows, d2 = row_table(dta)
    pairs, dist2 = offset_table(dta)
    assert rows.dtype == np.int32 and d2.dtype == np.float32
    assert rows[:, 0].tolist() == list(range(-dta, dta + 1))
    entries = []
    for dy, c0, nb, off in rows.tolist():
        assert c0 % BLOCK == 0 and off % BLOCK == 0 and c0 >= 0
        for j in range(nb * BLOCK):
            if np.isfinite(d2[off + j]):
                entries.append((dy, c0 - dta + j, d2[off + j].view(np.int32).item()))
            else:
                assert d2[off + j] == np.inf
        assert off + nb * BLOCK <= len(d2)
    assert sum(nb for *_, nb, _ in rows.tolist()) * BLOCK == len(d2)
    want = [(int(dy), int(dx), v.item()) for (dy, dx), v in zip(pairs, dist2.view(np.int32))]
    assert sorted(entries) == sorted(want)


def _twin_in_kernel_order(ref_n, eval_p, dta, cap, threshold_n, fill):
    """The twin with the candidates taken as the kernel takes them: by rows
    of :func:`row_table`, blocks of BLOCK offsets, the +inf padding read
    against the values past the disk (here NaN, +-inf and finite junk past
    the padded image), a NaN-dropping running minimum from +inf."""
    b, h, w = ref_n.shape
    wide = torch.cat([eval_p, torch.tensor([np.nan, np.inf, -np.inf, 3.0] * (2 * BLOCK),
                                           dtype=torch.float32).expand(b, eval_p.shape[1], -1)],
                     dim=2)
    rows, d2 = row_table(dta)
    least = torch.full_like(ref_n, float("inf"))
    for dy, c0, nb, off in rows.tolist():
        for j in range(nb * BLOCK):
            dx = c0 - dta + j
            shifted = wide[:, dta + dy: dta + dy + h, dta + dx: dta + dx + w]
            dd = shifted - ref_n
            least = torch.fmin(least, float(d2[off + j]) + dd * dd)
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    cap_t = f32(cap)
    gamma = torch.minimum(torch.sqrt(torch.minimum(cap_t * cap_t, least).double()).float(), cap_t)
    skip = torch.isnan(ref_n) | (ref_n < f32(threshold_n))
    return torch.where(skip, f32(fill), gamma)


@pytest.mark.parametrize("dta", [1, 2, 3, 5, 9])
def test_twin_in_kernel_order_equals_twin(dta):
    ref_n, eval_p = _normalised((2, 13, 19), dta, seed=30 + dta)
    # global dose too: then the least candidate may sit anywhere in the disk
    ref, ev = _pair((2, 13, 19), seed=40 + dta, ref_nan=False)
    dose = np.float32(0.03) * np.nanmax(ref)
    glob = (ref / dose, np.pad(ev / dose, [(0, 0), (dta, dta), (dta, dta)], mode="edge"))
    for r, e in ((ref_n, eval_p), glob):
        assert np.isnan(e).any() and (np.isinf(e).any() or r is glob[0])
        r, e = torch.from_numpy(r), torch.from_numpy(e)
        for cap, threshold_n, fill in SCALARS + [(40.0, 0.0, -1.0)]:
            assert _same(_twin_in_kernel_order(r, e, dta, cap, threshold_n, fill),
                         gamma2d_reference(r, e, dta, cap, threshold_n, fill))


def test_twin_is_the_cpu_wrapper():
    ref_n, eval_p = _normalised((2, 13, 17), 2, seed=5)
    args = (torch.from_numpy(ref_n), torch.from_numpy(eval_p), 2, 2.0, 0.05, NAN)
    before = gamma2d.launches
    assert _same(gamma2d(*args), gamma2d_reference(*args))
    assert gamma2d.launches == before  # the CPU never launches the kernel


@pytest.mark.parametrize("global_dose", [True, False], ids=["global", "local"])
@pytest.mark.parametrize("dta", range(1, 10))
def test_gamma_2d_matches_jax(jref, dta, global_dose):
    ref, ev = _pair((23, 37), seed=100 + dta, zeros=not global_dose, ref_nan=not global_dose)
    kw = dict(dose_to_agreement=3.0, distance_to_agreement=dta, global_dose=global_dose)
    want = np.asarray(jref.gamma.gamma_2d(jref.jnp.asarray(ref), jref.jnp.asarray(ev), **kw))
    got = tg.gamma_2d(ref, ev, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.isfinite(want).mean() > 0.5
    _assert_close(got.numpy(), want, 1e-5, f"gamma_2d dta {dta} global {global_dose}")


@pytest.mark.parametrize("kw", [
    dict(gamma_cap_value=1.0, dose_threshold=30.0, fill_value=-1.0),
    dict(dose_to_agreement=2.0, fill_value=0.0, global_dose=False),
    dict(gamma_cap_value=NAN),
], ids=["cap1-thr30-fill-1", "local-fill0", "cap-nan"])
def test_gamma_2d_scalars_match_jax(jref, kw):
    ref, ev = _pair((19, 31), seed=7, zeros=True, ref_nan=False)
    want = jref.gamma.gamma_2d(jref.jnp.asarray(ref), jref.jnp.asarray(ev),
                               distance_to_agreement=2, **kw)
    got = tg.gamma_2d(ref, ev, distance_to_agreement=2, device="cpu", **kw)
    _assert_close(got.numpy(), want, 1e-5, f"gamma_2d {kw}")


def test_gamma_2d_nan_reference_global_dose(jref):
    ref, ev = _pair((11, 13), seed=9)
    want = np.asarray(jref.gamma.gamma_2d(jref.jnp.asarray(ref), jref.jnp.asarray(ev)))
    got = tg.gamma_2d(ref, ev, device="cpu")
    assert np.isnan(want).all()
    _assert_close(got.numpy(), want, 0.0, "gamma_2d with NaN in the reference")


def test_gamma_2d_dta_beyond_the_image(jref):
    ref, ev = _pair((5, 6), seed=3, ref_nan=False)
    want = jref.gamma.gamma_2d(jref.jnp.asarray(ref), jref.jnp.asarray(ev),
                               distance_to_agreement=7)
    got = tg.gamma_2d(ref, ev, distance_to_agreement=7, device="cpu")
    _assert_close(got.numpy(), want, 1e-5, "gamma_2d at dta 7 on 5x6")


def _uint16_pairs(n: int, h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Square fields like ``bench.py``'s Gamma2D pairs, small."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    refs = np.empty((n, h, w), np.uint16)
    evals = np.empty((n, h, w), np.uint16)
    for i in range(n):
        field = ((np.abs(yy - h / 2) < h / 4 + i) & (np.abs(xx - w / 2) < w / 4)) * 40000.0
        refs[i] = np.clip(field + rng.normal(0, 60, (h, w)), 0, 65535)
        evals[i] = np.clip(np.roll(field, i - 1, axis=1) * (1 + 0.01 * i)
                           + rng.normal(0, 60, (h, w)), 0, 65535)
    return refs, evals


@pytest.mark.parametrize("global_dose", [True, False], ids=["global", "local"])
def test_gamma_2d_batch_uint16_matches_jax(jref, global_dose):
    refs, evals = _uint16_pairs(3, 24, 40, seed=1)
    kw = dict(dose_to_agreement=3.0, distance_to_agreement=4, gamma_cap_value=2.0,
              global_dose=global_dose, dose_threshold=5.0)
    want = np.asarray(jref.gamma.gamma_2d_batch(refs, evals, **kw))
    got = tg.gamma_2d_batch(refs, evals, device="cpu", **kw)
    assert got.shape == (3, 24, 40)
    _assert_close(got.numpy(), want, 1e-5, "gamma_2d_batch uint16")
    for i in range(3):  # each pair as the single-pair entry
        assert _same(got[i], tg.gamma_2d(refs[i], evals[i], device="cpu", **kw))


def test_gamma_2d_batch_takes_tensors():
    refs, evals = _uint16_pairs(2, 16, 20, seed=2)
    want = tg.gamma_2d_batch(refs, evals, distance_to_agreement=2, device="cpu")
    got = tg.gamma_2d_batch(torch.from_numpy(refs), torch.from_numpy(evals),
                            distance_to_agreement=2, device="cpu")
    assert _same(got, want)


@pytest.mark.parametrize("call, error", [
    (lambda r, e: tg.gamma_2d(r[0], e[0], distance_to_agreement=0, device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d(r[0], e[0], distance_to_agreement=1.5, device="cpu"), TypeError),
    (lambda r, e: tg.gamma_2d(r, e, device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d(r[0], e[0, :-1], device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d_batch(r[0], e[0], device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d_batch(r, e[:1], device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d_batch(r, e, distance_to_agreement=-2, device="cpu"), ValueError),
    (lambda r, e: tg.gamma_2d_batch(r, e, mesh=object(), device="cpu"), TypeError),
], ids=["dta0", "dta-float", "rank3-single", "shape", "rank2-batch", "batch-size",
        "dta-negative", "mesh"])
def test_bad_inputs_raise(call, error):
    refs, evals = _uint16_pairs(2, 8, 9, seed=0)
    with pytest.raises(error):
        call(refs, evals)


@pytest.mark.parametrize("bad, error", [
    (lambda r, e: (r.double(), e), TypeError),
    (lambda r, e: (r, e[:, :, :-1]), ValueError),
    (lambda r, e: (r[0], e[0]), ValueError),
    (lambda r, e: (r.transpose(1, 2), e), ValueError),
], ids=["float64", "eval_p-shape", "rank2", "strided"])
def test_wrapper_rejects(bad, error):
    ref_n, eval_p = _normalised((1, 6, 6), 1, seed=0)
    r, e = bad(torch.from_numpy(ref_n), torch.from_numpy(eval_p))
    with pytest.raises(error):
        gamma2d(r, e, 1, 2.0, 0.05, NAN)


def test_wrapper_rejects_dta_below_one():
    ref_n, eval_p = _normalised((1, 6, 6), 1, seed=0)
    with pytest.raises(ValueError):
        gamma2d(torch.from_numpy(ref_n), torch.from_numpy(eval_p), 0, 2.0, 0.05, NAN)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.gamma_2d(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dta", CARD_CASES)
def test_kernel_matches_twin_on_card(cuda, shape, dta):
    ref_n, eval_p = _normalised(shape, dta, seed=sum(shape) + dta)
    r, e = torch.from_numpy(ref_n).to(cuda), torch.from_numpy(eval_p).to(cuda)
    for cap, threshold_n, fill in CARD_SCALARS:
        before = gamma2d.launches
        got = gamma2d(r, e, dta, cap, threshold_n, fill)
        torch.cuda.synchronize()
        assert gamma2d.launches == before + 1
        assert _same(got, gamma2d_reference(r, e, dta, cap, threshold_n, fill))


@pytest.mark.cuda
def test_gamma_2d_batch_card_matches_cpu(cuda):
    refs, evals = _uint16_pairs(3, 64, 96, seed=4)
    kw = dict(dose_to_agreement=3.0, distance_to_agreement=9)
    before = gamma2d.launches
    got = tg.gamma_2d_batch(refs, evals, device=cuda, **kw)
    torch.cuda.synchronize()
    assert gamma2d.launches == before + 1
    want = tg.gamma_2d_batch(refs, evals, device="cpu", **kw)
    _assert_close(got.cpu().numpy(), want.numpy(), 1e-6, "card vs CPU")
