"""The port's profile metric plugins, ``ProfileBase.compute``,
``SingleProfile.resample`` and ``.gamma``, and ``FieldProfileAnalysis``
against the JAX package's, on the CPU.

Both packages read the same AS500 frames from the port's image generator
(an open 100 x 100 mm field, an FFF field, an asymmetric field offset and
sloped). Every metric of ``metrics/profile.py`` runs on the same profiles;
``FieldProfileAnalysis`` runs under every ``Edge``, ``Normalization`` and
``Centering``, with a manual position and widths and a custom metric list.
The results are compared field by field: strings, keys and counts exactly,
mm within 0.01, % within 0.1, the profile values within 1e-6 of their
scale. FWHM edges give JAX's bits; the inflection edges (a float32 spline
of a float32 derivative) move the derivative-edge metrics by up to
about 2e-4 mm, and the Hill fits by less.
"""

import math

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import field_profile_analysis as tfpa
from pylinac_tpu_torch.core import profile as tprof
from pylinac_tpu_torch.imggen.layers import (FilteredFieldLayer, FilterFreeFieldLayer,
                                             GaussianFilterLayer, SlopeLayer)
from pylinac_tpu_torch.imggen.simulators import AS500Image
from pylinac_tpu_torch.metrics import profile as tmetrics

MM, PCT, PX = 0.01, 0.1, 1e-3


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


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    d = tmp_path_factory.mktemp("fpa")
    out = {}
    for name, layers in (
            ("open", [FilteredFieldLayer(field_size_mm=(100, 100)), GaussianFilterLayer(sigma_mm=1)]),
            ("fff", [FilterFreeFieldLayer(field_size_mm=(120, 120)), GaussianFilterLayer(sigma_mm=1)]),
            ("asym", [FilteredFieldLayer(field_size_mm=(110, 90), cax_offset_mm=(3, -2)),
                      SlopeLayer(0.05, -0.03), GaussianFilterLayer(sigma_mm=1)])):
        sim = AS500Image(sid=1000)
        for layer in layers:
            sim.add_layer(layer)
        out[name] = str(d / f"{name}.dcm")
        sim.generate_dicom(out[name])
    return out


def _close(t, j, path=""):
    """Compare two results trees: exact for non-floats; floats within the
    bar of their unit (mm 0.01, % 0.1, otherwise 1e-6 relative)."""
    assert type(t) is type(j) or (isinstance(t, float) and isinstance(j, float)), path
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for k in j:
            _close(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        if j and isinstance(j[0], float) and len(j) > 8:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * max(1.0, np.abs(j).max()),
                                       err_msg=path)
        else:
            for i, (a, b) in enumerate(zip(t, j)):
                _close(a, b, f"{path}[{i}]")
    elif isinstance(j, float):
        tol = MM if "(mm)" in path or "mm" in path.rsplit("/", 1)[-1] else (
            PCT if "%" in path else 1e-6 * max(1.0, abs(j)))
        if math.isnan(j):
            assert math.isnan(t), path
        else:
            assert t == pytest.approx(j, abs=tol), path
    else:
        assert t == j, path


def _fpa(pkg_fpa, path, **analyze):
    fa = pkg_fpa.FieldProfileAnalysis(path)
    fa.analyze(**analyze)
    d = fa.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return fa, d


CASES = [
    ("open", {"edge_type": "FWHM"}),
    ("open", {}),
    ("fff", {"edge_type": "Inflection Hill", "normalization": "Beam center"}),
    ("asym", {"edge_type": "FWHM", "normalization": "Max"}),
    ("asym", {"edge_type": "FWHM", "normalization": "Geometric center",
              "centering": "Geometric center"}),
    ("asym", {"edge_type": "FWHM", "centering": "Manual", "position": (0.4, 0.55),
              "x_width": 0.05, "y_width": 0.1}),
    ("open", {"edge_type": "FWHM", "invert": True}),
    ("open", {"edge_type": "FWHM", "ground": False, "normalization": "None"}),
]


@pytest.mark.parametrize("field,analyze", CASES)
def test_field_profile_analysis_matches_jax(jax_cpu, fields, field, analyze):
    import pylinac_tpu.field_profile_analysis as jfpa

    _, jd = _fpa(jfpa, fields[field], **analyze)
    t, td = _fpa(tfpa, fields[field], **analyze)
    _close(td, jd)
    assert type(t.results_data()).__name__ == "FieldProfileResult"
    assert "Field Width (mm)" in t.results()


def _all_metrics(pkg):
    m = pkg
    return [m.FlatnessDifferenceMetric(), m.FlatnessRatioMetric(in_field_ratio=0.7),
            m.SymmetryPointDifferenceMetric(), m.SymmetryPointDifferenceQuotientMetric(),
            m.SymmetryAreaMetric(), m.PenumbraLeftMetric(lower=10, upper=90),
            m.PenumbraRightMetric(), m.CAXToLeftEdgeMetric(), m.CAXToRightEdgeMetric(),
            m.TopDistanceMetric(), m.SlopeMetric(ratio_edges=(0.3, 0.7)),
            m.FlatnessDifferenceMetric()]


@pytest.mark.parametrize("field", ["fff", "asym"])
def test_custom_metric_list_matches_jax(jax_cpu, fields, field):
    """Every beam metric, one twice (the suffix rule names it again with
    ``2``), on FWHM profiles."""
    import pylinac_tpu.field_profile_analysis as jfpa
    import pylinac_tpu.metrics.profile as jmetrics

    _, jd = _fpa(jfpa, fields[field], edge_type="FWHM", metrics=_all_metrics(jmetrics))
    _, td = _fpa(tfpa, fields[field], edge_type="FWHM", metrics=_all_metrics(tmetrics))
    assert "Flatness (Difference) (%)2" in td["x_metrics"]
    _close(td, jd)


def _pdd_values():
    x = np.arange(0.0, 301.0)
    v = (1 - np.exp(-x / 6.0)) * np.exp(-x / 180.0) * 100
    return x, v


@pytest.mark.parametrize("kind", ["dmax", "pdd_fit", "pdd_max"])
def test_depth_dose_metrics_match_jax(kind):
    import pylinac_tpu.core.profile as jprof
    import pylinac_tpu.metrics.profile as jmetrics

    x, v = _pdd_values()

    def metric(m):
        if kind == "dmax":
            return m.Dmax()
        return m.PDD(depth_mm=100, normalize_to="fit" if kind == "pdd_fit" else "max")

    jp = jprof.FWXMProfile(values=v, x_values=x)
    tp = tprof.FWXMProfile(values=v, x_values=x)
    j, t = jp.compute(metric(jmetrics)), tp.compute(metric(tmetrics))
    assert t == j
    assert list(tp.metric_values) == list(jp.metric_values)


def test_metric_edge_errors_match_jax():
    import pylinac_tpu.core.profile as jprof
    import pylinac_tpu.metrics.profile as jmetrics

    x, v = _pdd_values()
    for pkg, prof in ((jmetrics, jprof), (tmetrics, tprof)):
        with pytest.raises(ValueError, match="window at or past an edge"):
            prof.FWXMProfile(values=v, x_values=x).compute(pkg.PDD(depth_mm=300))
        with pytest.raises(ValueError, match="less than the second"):
            pkg.SlopeMetric(ratio_edges=(0.8, 0.2))
        with pytest.raises(ValueError, match="normalize_to"):
            prof.FWXMProfile(values=v, x_values=x).compute(
                pkg.PDD(depth_mm=100, normalize_to="mean"))


def test_compute_suffix_rule_and_single_value():
    x, v = _pdd_values()
    p = tprof.FWXMProfile(values=v, x_values=x)
    first = p.compute(tmetrics.Dmax())
    again = p.compute([tmetrics.Dmax(), tmetrics.Dmax()])
    assert first == p.metric_values["Dmax (mm)"]
    assert list(again) == ["Dmax (mm)2", "Dmax (mm)3"]
    assert len(p.metrics) == 3


def _single(pkg_prof, values, **kw):
    return pkg_prof.SingleProfile(values, dpmm=1.5, **kw)


@pytest.mark.parametrize("interp", ["Linear", "Spline"])
@pytest.mark.parametrize("factor,res", [(10, 0.1), (4, 0.25)])
def test_single_profile_resample_matches_jax(jax_cpu, interp, factor, res):
    import pylinac_tpu.core.profile as jprof

    rng = np.random.default_rng(3)
    x = np.arange(200)
    values = 1 / (1 + np.exp(-(x - 50) / 3)) - 1 / (1 + np.exp(-(x - 150) / 3))
    values = values + rng.normal(0, 0.005, x.size)
    kw = dict(interpolation=interp, interpolation_resolution_mm=0.2)
    j = _single(jprof, values, **kw).resample(interpolation_factor=factor,
                                               interpolation_resolution_mm=res)
    t = _single(tprof, values, **kw).resample(interpolation_factor=factor,
                                               interpolation_resolution_mm=res)
    np.testing.assert_allclose(t.values, j.values, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.x_indices, j.x_indices, rtol=0, atol=1e-9)
    assert t.dpmm == j.dpmm
    assert t.fwxm_data()["width (exact) mm"] == pytest.approx(
        j.fwxm_data()["width (exact) mm"], abs=MM)


@pytest.mark.parametrize("dta,dd,global_dose", [(1, 1, True), (2, 3, True), (1, 2, False)])
def test_single_profile_gamma_matches_jax(jax_cpu, dta, dd, global_dose):
    import pylinac_tpu.core.profile as jprof

    x = np.arange(150)
    ref = 1 / (1 + np.exp(-(x - 40) / 3)) - 1 / (1 + np.exp(-(x - 110) / 3))
    ev = 1.02 / (1 + np.exp(-(x - 41) / 3)) - 1.02 / (1 + np.exp(-(x - 111) / 3))
    kw = dict(distance_to_agreement=dta, dose_to_agreement=dd, global_dose=global_dose)
    j = _single(jprof, ref).gamma(_single(jprof, ev), **kw)
    t = _single(tprof, ref).gamma(_single(tprof, ev), **kw)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, equal_nan=True)
    with pytest.raises(ValueError, match="dpmm"):
        tprof.SingleProfile(ref).gamma(_single(tprof, ev))


def test_errors_match_jax(jax_cpu, fields):
    import pylinac_tpu.field_profile_analysis as jfpa
    from pylinac_tpu.core.exceptions import NotAnalyzed as JNotAnalyzed

    from pylinac_tpu_torch.core.exceptions import NotAnalyzed

    for pkg, not_analyzed in ((jfpa, JNotAnalyzed), (tfpa, NotAnalyzed)):
        fa = pkg.FieldProfileAnalysis(fields["open"])
        with pytest.raises(not_analyzed):
            fa.results_data()
        with pytest.raises(ValueError, match="Width must be between 0 and 1"):
            fa.analyze(edge_type="FWHM", x_width=1.5)
        with pytest.raises(ValueError, match="between 0 and 1"):
            fa.analyze(edge_type="FWHM", centering="Manual", position=(1.5, 0.5))
        with pytest.raises(ValueError, match="two values"):
            fa.analyze(edge_type="FWHM", centering="Manual", position=(0.5, 0.5, 0.5))
    with pytest.raises(NotAnalyzed):
        tfpa.FieldProfileAnalysis(fields["open"]).publish_pdf("x.pdf")


def test_default_metrics_are_copied_value_for_value():
    import pylinac_tpu.field_profile_analysis as jfpa

    assert [type(m).__name__ for m in tfpa.DEFAULT_METRICS] == \
        [type(m).__name__ for m in jfpa.DEFAULT_METRICS]
    for t, j in zip(tfpa.DEFAULT_METRICS, jfpa.DEFAULT_METRICS):
        assert {k: v for k, v in vars(t).items() if k != "profile"} == \
            {k: v for k, v in vars(j).items() if k != "profile"}
    assert [e.value for e in tfpa.PROFILES] == [e.value for e in jfpa.PROFILES]
