"""The port's peak analysis and exact percentiles against the JAX package's.

Tolerances: order statistics, percentiles, peak positions, bases, validity
and overflow flags are exact: they are selections or comparisons of the
same float32 values, and the percentile mixes its two order statistics
with the same float32 arithmetic. Heights and prominences are exact too
(gathers and one subtraction). Interpolated crossings (ips), widths and
width heights are held to 1e-5 px: each is a few float32 operations that
either framework may contract into a fused multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylinac_tpu.ops import peaks as jpk
from pylinac_tpu.ops import stats as jstats
from pylinac_tpu_torch.ops import peaks as tpk
from pylinac_tpu_torch.ops import stats as tstats

IPS_TOL = 1e-5
EXACT = ("positions", "values", "prominences", "left_bases", "right_bases",
         "valid", "overflowed")
CLOSE = ("widths", "width_heights", "left_ips", "right_ips")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _profiles(seed, b=6, n=200, flat_top=None):
    """Seeded noisy multi-peak profiles, rounded to 2 decimals so they hold
    plateaus and ties."""
    rng = np.random.default_rng(seed)
    x = np.arange(n)
    out = []
    for _ in range(b):
        prof = np.zeros(n)
        for c in rng.uniform(10, n - 10, size=rng.integers(3, 9)):
            prof += rng.uniform(0.3, 1.0) * np.exp(-0.5 * ((x - c) / rng.uniform(2, 8)) ** 2)
        prof += rng.normal(0, 0.02, n)
        if flat_top is not None:
            prof = np.minimum(prof, flat_top * prof.max())
        out.append(np.round(prof, 2))
    return np.asarray(out, np.float32)


def _assert_peaks_equal(t: tpk.PeakResult, j: jpk.PeakResult):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    for name in CLOSE:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=IPS_TOL, err_msg=name)


# (K, height ratio, distance, min_width, required_prominence)
CASES = [
    (32, 0.0, 1.0, 0.0, None),
    (8, 0.2, 5.0, 2.0, 0.1),      # K=8 overflows on these profiles
    (64, 0.1, 12.5, 0.0, 0.05),
]


def _run_both(v, K, ratio, distance, min_width, prominence):
    heights = (v.min(axis=1) + ratio * (v.max(axis=1) - v.min(axis=1))).astype(np.float32)
    t = tpk.peak_analysis(torch.from_numpy(v), K=K, rel_height=0.5,
                          height=torch.from_numpy(heights), distance=distance,
                          min_width=min_width, required_prominence=prominence)
    j = jax.vmap(lambda s, h: jpk.peak_analysis(
        s, K=K, rel_height=0.5, height=h, distance=distance, min_width=min_width,
        required_prominence=prominence))(jnp.asarray(v), jnp.asarray(heights))
    return t, j


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_peak_analysis_matches_jax(seed, case):
    v = _profiles(seed)
    t, j = _run_both(v, *case)
    _assert_peaks_equal(t, j)
    if case[0] == 8:
        assert bool(t.overflowed.any())


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("sort_key", ["prominences", "widths"])
@pytest.mark.parametrize("max_number", [1, 3])
def test_select_top_and_compact_match_jax(seed, sort_key, max_number):
    v = _profiles(seed)
    t, j = _run_both(v, *CASES[0])
    t = tpk.compact_slots(tpk.select_top(t, max_number, sort_key), 5)
    j = jax.vmap(lambda r: jpk.compact_slots(jpk.select_top(r, max_number, sort_key), 5))(j)
    _assert_peaks_equal(t, j)
    assert (t.valid.sum(dim=1) <= max_number).all()


def test_select_top_sorts_peak_heights_on_values():
    v = _profiles(5)
    t, _ = _run_both(v, *CASES[0])
    np.testing.assert_array_equal(tpk.select_top(t, 2, "peak_heights").valid.numpy(),
                                  tpk.select_top(t, 2, "values").valid.numpy())


def _select_by_distance(pos, val, valid, distance):
    """scipy's ``_select_by_peak_distance`` on one row's valid slots, in
    plain Python: visit by descending height (ties by slot, last first),
    dropping the kept peak's neighbours closer than ``distance``."""
    keep = list(valid)
    order = sorted(range(len(pos)), key=lambda i: (val[i] if valid[i] else -np.inf, i))
    for j in reversed(order):
        if valid[j] and keep[j]:
            for i in range(len(pos)):
                if i != j and abs(pos[i] - pos[j]) < distance:
                    keep[i] = False
    return [v and k for v, k in zip(valid, keep)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distance_filter_matches_a_plain_loop(seed):
    """Slots with tied heights, invalid slots and every spacing against
    distances of 1-29: the batched filter equals the plain loop row by row."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(40):
        b, k = 5, int(torch.randint(1, 40, (1,), generator=g))
        valid = torch.rand(b, k, generator=g) > 0.3
        pos = torch.where(valid, torch.sort(torch.randint(0, 200, (b, k), generator=g), 1).values,
                          -1)
        val = torch.randint(0, 5, (b, k), generator=g).to(torch.float32)
        distance = float(torch.randint(1, 30, (1,), generator=g))
        got = tpk._distance_filter(pos, val, valid, torch.tensor(distance), k)
        want = [_select_by_distance(p, v, m, distance)
                for p, v, m in zip(pos.tolist(), val.tolist(), valid.tolist())]
        assert got.tolist() == want


@pytest.mark.parametrize("flat_top", [None, 0.8])
@pytest.mark.parametrize("seed", [6, 7])
def test_main_peak_and_ips_match_jax(seed, flat_top):
    v = _profiles(seed, b=8, n=128, flat_top=flat_top)
    tv = torch.from_numpy(v)
    tp = tpk.main_peak(tv)
    jp = jax.vmap(jpk.main_peak)(jnp.asarray(v))
    for name in ("pos", "val", "prom", "lb", "rb"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    rel = torch.tensor(0.5)
    tl, tr = tpk.main_peak_ips(tv, tp, rel)
    jl, jr = jax.vmap(jpk.main_peak_ips, in_axes=(0, 0, None))(
        jnp.asarray(v), jp, jnp.float32(0.5))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=IPS_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=IPS_TOL)


FIND_CASES = [
    dict(threshold=0.3, peak_separation=0.02, required_prominence=0.1),
    dict(threshold=0.2, max_number=3, peak_sort="prominences", search_region=(0.1, 0.9)),
    dict(K=4),                    # the slots overflow and K escalates
]


@pytest.mark.parametrize("seed", [8, 9])
@pytest.mark.parametrize("kwargs", FIND_CASES)
def test_find_peaks_matches_jax(seed, kwargs):
    v = _profiles(seed, b=1, n=300)[0]
    t_idx, t_props = tpk.find_peaks(v, **kwargs)
    j_idx, j_props = jpk.find_peaks(v, **kwargs)
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_idx.dtype == j_idx.dtype
    assert list(t_props) == list(j_props)
    for name in ("left_bases", "right_bases", "prominences", "peak_heights"):
        np.testing.assert_array_equal(t_props[name], j_props[name], err_msg=name)
    for name in ("widths", "width_heights", "left_ips", "right_ips"):
        np.testing.assert_allclose(t_props[name], j_props[name], rtol=0,
                                   atol=IPS_TOL, err_msg=name)


QS = [(0.5, 99.5), (0.0, 25.0, 50.0, 100.0), (33.3, 66.6)]


@pytest.mark.parametrize("kind", ["noise", "ties"])
@pytest.mark.parametrize("qs", QS)
def test_percentile_exact_matches_jax(qs, kind):
    rng = np.random.default_rng(len(qs))
    if kind == "ties":
        x = rng.integers(0, 7, size=(3, 37, 53)).astype(np.float32)
    else:
        x = rng.normal(1000.0, 50.0, size=(3, 37, 53)).astype(np.float32)
    got = tstats.percentile_exact(torch.from_numpy(x), qs).numpy()
    for i in range(3):
        want = np.asarray(jstats.percentile_exact(jnp.asarray(x[i]), qs))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_allclose(got[i], np.percentile(x[i], qs), rtol=1e-6)


def test_order_statistics_match_jax():
    x = np.random.default_rng(11).normal(size=(2, 41, 43)).astype(np.float32)
    ranks = [0, 5, 900, 41 * 43 - 1]
    got = tstats.order_statistics(torch.from_numpy(x), ranks).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(jstats.order_statistics(jnp.asarray(x[i]), ranks)))
