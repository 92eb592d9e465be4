"""The port's new-style profiles against the JAX package's, on the CPU.

Three seeded profiles: a flat field with Gaussian penumbrae, an FFF
(cone-topped) field and a noisy field, each as float values over pixel
indices and over descending physical x values. Every ``ProfileBase``
method of ``FWXMProfile``, ``InflectionDerivativeProfile``,
``HillProfile`` and their ``*Physical`` forms is held to JAX's: the FWXM
edges, widths, centres and field values exactly (host numpy and the same
float32 peak finder in both); the inflection edges, which refine a float32
cubic spline of a float32 Gaussian derivative, within 1e-3 px; the Hill
edges, a float32 Levenberg-Marquardt fit, within 0.01 px; the resampled
profiles (scipy ``zoom`` in float32) within 1e-5 of the profile's range;
the profile gamma within 1e-5. The mixin's manipulations (``invert``,
``bit_invert``, ``stretch``, ``convert_to_dtype``, ``ground``,
``normalize``, indexing) are exact.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.core import profile as tprof

N = 401


def _profiles() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    x = np.arange(N, dtype=float)
    edges = 1 / (1 + np.exp(-(x - 100) / 4)) * 1 / (1 + np.exp((x - 290) / 4))
    cone = 1 - 0.35 * ((x - 195) / 120) ** 2
    return {
        "field": 0.02 + edges,
        "fff": 0.02 + edges * cone,
        "noisy": 0.02 + edges + rng.normal(0, 0.004, N),
    }


PROFILES = _profiles()
KINDS = ("field", "fff", "noisy")
CLASSES = ("FWXMProfile", "InflectionDerivativeProfile", "HillProfile")
EDGE_TOL = {"FWXMProfile": 1e-9, "InflectionDerivativeProfile": 1e-3, "HillProfile": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jprof():
    from pylinac_tpu.core import profile as jprof

    return jprof


def _make(jprof, cls, kind, physical=False, **kwargs):
    values = PROFILES[kind]
    name = cls + ("Physical" if physical else "")
    if physical:
        kwargs.setdefault("dpmm", 2.5)
    return getattr(tprof, name)(values, **kwargs), getattr(jprof, name)(values, **kwargs)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("physical", [False, True])
def test_edges_and_centres_match_jax(jprof, cls, kind, physical):
    t, j = _make(jprof, cls, kind, physical)
    tol = EDGE_TOL[cls]
    # JAX's edges once each (its Hill fit is eager and slow); its centre and
    # widths are these formulas of them
    left, right = j.field_edge_idx("left"), j.field_edge_idx("right")
    assert t.field_edge_idx("left") == pytest.approx(left, abs=tol)
    assert t.field_edge_idx("right") == pytest.approx(right, abs=tol)
    assert t.center_idx == pytest.approx(abs(right - left) / 2 + left, abs=tol)
    assert t.field_width_px == pytest.approx(right - left, abs=2 * tol)
    assert t.geometric_center_idx == j.geometric_center_idx
    assert t.cax_index == j.cax_index
    if physical:
        np.testing.assert_array_equal(t.physical_x_values, j.physical_x_values)
        assert t.implicit_dpmm == j.implicit_dpmm
        assert t.field_width_mm == pytest.approx((right - left) / j.implicit_dpmm, abs=2 * tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ratio", [0.8, 0.5])
def test_field_values_match_jax(jprof, kind, ratio):
    t, j = _make(jprof, "FWXMProfile", kind)
    np.testing.assert_array_equal(t.field_x_values(ratio), j.field_x_values(ratio))
    np.testing.assert_array_equal(t.field_values(ratio), j.field_values(ratio))
    assert t.field_indices(ratio) == j.field_indices(ratio)


@pytest.mark.parametrize("kind", KINDS)
def test_interpolation_helpers_match_jax(jprof, kind):
    t, j = _make(jprof, "FWXMProfile", kind)
    for x in (0.0, 57.3, 200.5, 399.9):
        assert t.x_idx_at_x(x) == j.x_idx_at_x(x)
        assert t.y_at_x(x) == j.y_at_x(x)
        assert t.x_at_x_idx(x) == j.x_at_x_idx(x)
    np.testing.assert_array_equal(t.y_at_x(np.array([3.5, 150.25])),
                                  j.y_at_x(np.array([3.5, 150.25])))
    for y in (0.3, 0.5, 0.9):
        for side in ("left", "right"):
            assert t.x_at_y(y, side) == j.x_at_y(y, side)


@pytest.mark.parametrize("kind", KINDS)
def test_cubic_interpolation_order_matches_jax(jprof, kind):
    values = PROFILES[kind]
    t = tprof.ProfileBase(values, interpolation_order=3)
    j = jprof.ProfileBase(values, interpolation_order=3)
    for x in (10.25, 150.5, 333.75):
        assert t.y_at_x(x) == pytest.approx(j.y_at_x(x), abs=1e-6)
        assert t.x_at_x_idx(x) == pytest.approx(j.x_at_x_idx(x), abs=1e-4)


@pytest.mark.parametrize("normalization", ["Max", "Geometric center", "Beam center",
                                           tprof.Normalization.NONE])
@pytest.mark.parametrize("ground", [False, True])
def test_normalisation_and_ground_match_jax(jprof, normalization, ground):
    jnorm = (normalization if isinstance(normalization, str)
             else jprof.Normalization.NONE)
    t = tprof.FWXMProfile(PROFILES["fff"], ground=ground, normalization=normalization)
    j = jprof.FWXMProfile(PROFILES["fff"], ground=ground, normalization=jnorm)
    np.testing.assert_array_equal(t.values, j.values)


def test_descending_x_values_match_jax(jprof):
    x = np.linspace(50.0, -50.0, N)
    for cls in CLASSES:
        t, j = _make(jprof, cls, "field", x_values=x)
        np.testing.assert_array_equal(t.x_values, j.x_values)
        np.testing.assert_array_equal(t.values, j.values)
        assert t.center_idx == pytest.approx(j.center_idx, abs=EDGE_TOL[cls])
    with pytest.raises(ValueError, match="monotonically"):
        tprof.FWXMProfile(PROFILES["field"], x_values=np.r_[x[:200], x[200:][::-1]])


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("kind", ["field", "noisy"])
def test_as_resampled_matches_jax(jprof, cls, kind):
    t, j = _make(jprof, cls, kind)
    tr, jr = t.as_resampled(interpolation_factor=5), j.as_resampled(interpolation_factor=5)
    assert type(tr) is type(t)
    np.testing.assert_array_equal(tr.x_values, jr.x_values)
    np.testing.assert_allclose(tr.values, jr.values, rtol=0, atol=1e-5)
    if cls != "HillProfile":  # the Hill edges are held above; JAX's fit is slow
        assert tr.center_idx == pytest.approx(jr.center_idx, abs=EDGE_TOL[cls] + 1e-3)


@pytest.mark.parametrize("cls", CLASSES)
def test_physical_as_resampled_matches_jax(jprof, cls):
    t, j = _make(jprof, cls, "field", physical=True)
    tr, jr = t.as_resampled(0.1), j.as_resampled(0.1)
    assert type(tr) is type(t) and tr.dpmm == jr.dpmm == 10
    np.testing.assert_allclose(tr.x_values, jr.x_values, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.values, jr.values, rtol=0, atol=1e-5)
    if cls != "HillProfile":
        assert tr.field_width_mm == pytest.approx(jr.field_width_mm, abs=1e-2)


def test_resample_to_matches_jax(jprof):
    t, j = _make(jprof, "FWXMProfile", "fff", physical=True, dpmm=2.0)
    t_target, j_target = _make(jprof, "FWXMProfile", "field", physical=True, dpmm=4.0,
                               x_values=np.arange(N) / 2 + 50)
    tr, jr = t.resample_to(t_target), j.resample_to(j_target)
    assert type(tr).__name__ == type(jr).__name__ == "FWXMProfile"
    np.testing.assert_array_equal(tr.values, jr.values)
    np.testing.assert_array_equal(tr.x_values, jr.x_values)
    plain_t, plain_j = _make(jprof, "FWXMProfile", "noisy")
    np.testing.assert_array_equal(plain_t.resample_to(plain_t).values,
                                  plain_j.resample_to(plain_j).values)
    wide = tprof.FWXMProfile(PROFILES["field"], x_values=np.arange(N) * 3.0)
    with pytest.raises(ValueError, match="outside"):
        plain_t.resample_to(wide)


@pytest.mark.parametrize("kwargs", [{}, {"dose_to_agreement": 2, "distance_to_agreement": 1,
                                         "gamma_cap_value": 1.5, "dose_threshold": 20,
                                         "fill_value": -1.0}])
def test_gamma_matches_jax(jprof, kwargs):
    t_ref, j_ref = _make(jprof, "FWXMProfile", "field", physical=True)
    t_ev, j_ev = _make(jprof, "FWXMProfile", "noisy", physical=True)
    tg, tr, te = t_ref.gamma(t_ev, return_profiles=True, **kwargs)
    jg, jr, je = j_ref.gamma(j_ev, return_profiles=True, **kwargs)
    np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    np.testing.assert_allclose(tg[~np.isnan(tg)], jg[~np.isnan(jg)], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tr.x_values, jr.x_values)
    np.testing.assert_array_equal(te.x_values, je.x_values)
    with pytest.raises(ValueError, match="physical"):
        t_ref.gamma(tprof.FWXMProfile(PROFILES["noisy"]))


def test_fwxm_height_and_hill_window_match_jax(jprof):
    for height in (20, 80):
        t, j = _make(jprof, "FWXMProfile", "fff", fwxm_height=height)
        assert t.field_width_px == j.field_width_px
    t, j = _make(jprof, "HillProfile", "noisy", hill_window_ratio=0.2, edge_smoothing_ratio=0.01)
    assert t.center_idx == pytest.approx(j.center_idx, abs=EDGE_TOL["HillProfile"])
    t, j = _make(jprof, "InflectionDerivativeProfile", "noisy", edge_smoothing_ratio=0.01)
    assert t.field_width_px == pytest.approx(j.field_width_px, abs=2e-3)


def test_mixin_manipulations_match_jax(jprof):
    ints = (PROFILES["field"] * 4000).astype(np.uint16)
    t, j = tprof.FWXMProfile(ints), jprof.FWXMProfile(ints)
    assert len(t) == len(j) and t[10] == j[10]
    np.testing.assert_array_equal(t[5:9], j[5:9])
    for method, args in (("bit_invert", ()), ("invert", ()), ("convert_to_dtype", (np.int32,)),
                         ("ground", ()), ("stretch", (0, 100)), ("normalize", ("max",)),
                         ("convert_to_dtype", (np.float32,)), ("stretch", ())):
        assert getattr(t, method)(*args) == getattr(j, method)(*args)
        assert t.values.dtype == j.values.dtype
        np.testing.assert_array_equal(t.values, j.values)


def test_existing_callers_are_unchanged():
    """Starshot's FW80M centre and the CatPhan wire ramps use the FWXM
    profile with its defaults: no normalisation, no ground."""
    values = PROFILES["fff"]
    p = tprof.FWXMProfile(values=values, fwxm_height=80)
    np.testing.assert_array_equal(p.values, values)
    np.testing.assert_array_equal(p.x_values, np.arange(N, dtype=float))
