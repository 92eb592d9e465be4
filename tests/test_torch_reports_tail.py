"""The port's last reports against the JAX package's, on the CPU:
``FieldProfileAnalysis``, the nuclear-medicine classes, the machine-log
analyzer (axes, fluence and gamma maps, MLC statistics, summaries and
PDFs), ``JawOrthogonality`` and the plan generator's ``plot_fluences``;
then the surface they complete: every report method of those modules
exists in the port with JAX's signature.

The inputs are ones that each class's own ``tests/test_torch_<x>.py`` holds
equal to JAX, at their cheapest: the AS500 open field of
``test_torch_field_profile.py``, the nuclear inputs of
``test_torch_nuclear.py`` (every class with its non-default arguments),
the JAX tests' dynalog pair and trajectory log with the port's seeded VMAT
arc, the AS1000 square field of ``test_torch_contrib.py`` and a TrueBeam
plan from the JAX tests' template. Each package analyses each input once a
module.

The checks are those of ``tests/test_torch_reports.py``: PDF bytes equal
with both clocks frozen (and the result's date, which the field profile
PDF prints), QuAAC texts equal or, where a value comes from a fit that the
port solves in float64 and JAX in float32, the QuAAC and plotly trees at
the parity bar, and each matplotlib figure's signature. The log analyzer
draws on pyplot's current figure, so each package draws on a fresh one
(``_same_drawing``).
Where the JAX method raises, the port raises the same exception type.
"""

import datetime
import functools
import inspect
import io
import json
from types import SimpleNamespace

import pytest

from pylinac_tpu_torch import field_profile_analysis as tfpa
from pylinac_tpu_torch import log_analyzer as tl
from pylinac_tpu_torch import nuclear as tn
from pylinac_tpu_torch.contrib.orthogonality import JawOrthogonality
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.imggen import layers as tlayers
from pylinac_tpu_torch.imggen.logs import write_vmat_tlog
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1000Image
from pylinac_tpu_torch.metrics import profile as tmetrics
from pylinac_tpu_torch.plan_generator import dicom as tdicom
from pylinac_tpu_torch.plan_generator import fluence as tfluence
from tests.test_torch_contrib import draw_orthogonality
from tests.test_torch_nuclear import CASES, write_inputs
from tests.test_torch_reports import (_assert_close_tree, _assert_same_figure, _few_threads,
                                      _figs_json, frozen, jax_mods, plt)
from tests.test_torch_reports_beams import _pdfs_equal, _quaac_equal, _same_drawing, _same_error

# the fixtures above are imported to be used here
__all__ = ["_few_threads", "frozen", "jax_mods", "plt"]

DATE = datetime.datetime(2024, 5, 6, 7, 8, 9)


def _pair(port, jax) -> SimpleNamespace:
    return SimpleNamespace(port=port, jax=jax)


# the drawings of fits that the port solves in float64 and JAX in float32:
# every number at the parity bar (0.01 absolute or 0.1 % relative)
_at_the_bar = functools.partial(_assert_same_figure, rtol=1e-3, atol=0.01, image_atol=0.01)


def _saved_png(pair, save, tmp_path) -> None:
    """``save(obj, file)`` in both packages: the same PNG bytes."""
    import matplotlib.pyplot as plt

    for name, obj in (("port", pair.port), ("jax", pair.jax)):
        plt.figure()
        save(obj, tmp_path / f"{name}.png")
        plt.close("all")
    got, want = (tmp_path / "port.png").read_bytes(), (tmp_path / "jax.png").read_bytes()
    assert got.startswith(b"\x89PNG") and got == want


def _quaac_close(pair, tmp_path) -> None:
    """The QuAAC JSON documents at the parity bar."""
    for name, obj in (("port", pair.port), ("jax", pair.jax)):
        obj.to_quaac(tmp_path / name, performer={"name": "QA"}, format="json")
    _assert_close_tree(json.loads((tmp_path / "port").read_text()),
                       json.loads((tmp_path / "jax").read_text()))


# ---------------------------------------------------------------------------
# FieldProfileAnalysis
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fpa(tmp_path_factory, jax_mods):
    from pylinac_tpu import field_profile_analysis as jfpa

    sim = AS500Image(sid=1000)
    sim.add_layer(tlayers.FilteredFieldLayer(field_size_mm=(100, 100)))
    sim.add_layer(tlayers.GaussianFilterLayer(sigma_mm=1))
    path = str(tmp_path_factory.mktemp("reports_fpa") / "open.dcm")
    sim.generate_dicom(path)
    out = {}
    for edge in ("FWHM", "Inflection Derivative"):
        pair = _pair(tfpa.FieldProfileAnalysis(path), jfpa.FieldProfileAnalysis(path))
        pair.port.analyze(edge_type=edge)
        pair.jax.analyze(edge_type=edge)
        out[edge] = pair
    return out


@pytest.fixture
def dated(fpa, monkeypatch):
    """The results' date of analysis fixed in both packages."""
    for pair in fpa.values():
        for obj in (pair.port, pair.jax):
            def generate(obj=obj, make=type(obj)._generate_results_data):
                data = make(obj)
                data.date_of_analysis = DATE
                return data

            monkeypatch.setattr(obj, "_generate_results_data", generate)


@pytest.mark.parametrize("edge", ["FWHM", "Inflection Derivative"])
def test_fpa_pdf_bytes_equal(fpa, frozen, dated, tmp_path, edge):
    _pdfs_equal(fpa[edge], tmp_path, notes="open field", metadata={"Unit": "TB1"})
    _pdfs_equal(fpa[edge], tmp_path, plot_kwargs={"grid": False})


@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
def test_fpa_plotly_equal(fpa, kwargs):
    pair = fpa["Inflection Derivative"]
    got = _figs_json(pair.port.plotly_analyzed_images(show=False, **kwargs))
    want = _figs_json(pair.jax.plotly_analyzed_images(show=False, **kwargs))
    assert list(got) == ["X Profile", "Y Profile", "Image"]
    _assert_close_tree(got, want)


@pytest.mark.parametrize("kwargs", [{}, {"grid": False}])
def test_fpa_matplotlib_figures_match(fpa, plt, kwargs):
    _same_drawing(plt, fpa["FWHM"], lambda f: f.plot_analyzed_images(show=False, **kwargs))


def test_fpa_reports_before_analysis_raise_as_in_jax(fpa, plt, tmp_path):
    from pylinac_tpu import field_profile_analysis as jfpa

    path = fpa["FWHM"].port.image.path
    pair = _pair(tfpa.FieldProfileAnalysis(path), jfpa.FieldProfileAnalysis(path))
    for call in (lambda f: f.plotly_analyzed_images(show=False),
                 lambda f: f.plot_analyzed_images(show=False),
                 lambda f: f.publish_pdf(tmp_path / "x.pdf")):
        assert type(_same_error(pair, call)).__name__ == "NotAnalyzed"
    plt.close("all")


def test_profile_metric_plot_draws_nothing_as_in_jax(fpa, plt):
    """``ProfileMetric.plot`` draws nothing in either package, for every
    metric the analysis computed."""
    from pylinac_tpu.metrics import profile as jmetrics

    assert inspect.signature(tmetrics.ProfileMetric.plot) == \
        inspect.signature(jmetrics.ProfileMetric.plot)
    pair = fpa["FWHM"]
    for prof_p, prof_j in ((pair.port.x_profile, pair.jax.x_profile),
                           (pair.port.y_profile, pair.jax.y_profile)):
        for mp, mj in zip(prof_p.metrics, prof_j.metrics):
            assert type(mp).__name__ == type(mj).__name__
            for m in (mp, mj):
                fig, ax = plt.subplots()
                assert m.plot(ax) is None and not ax.has_data()
    plt.close("all")


# ---------------------------------------------------------------------------
# nuclear medicine
# ---------------------------------------------------------------------------
NM = ["MaxCountRate", "PlanarUniformity", "CenterOfRotation", "TomographicResolution",
      "FourBarResolution", "QuadrantResolution", "TomographicUniformity",
      "TomographicContrast", "SimpleSensitivity"]


@pytest.fixture(scope="module")
def nm(tmp_path_factory, jax_mods):
    """Each nuclear class analysed once by each package, with its
    non-default arguments of ``tests/test_torch_nuclear.py``."""
    import pylinac_tpu.nuclear as jn

    files = write_inputs(tmp_path_factory.mktemp("reports_nm"))
    out = {}
    for name in NM[:-1]:
        key, kwargs = CASES[name]
        pair = _pair(getattr(tn, name)(files[key]), getattr(jn, name)(files[key]))
        pair.port.analyze(device="cpu", **kwargs)
        pair.jax.analyze(**kwargs)
        out[name] = pair
    pair = _pair(tn.SimpleSensitivity(files["sens"], background_path=files["sens_bg"]),
                 jn.SimpleSensitivity(files["sens"], background_path=files["sens_bg"]))
    pair.port.analyze(activity_mbq=50, nuclide=tn.Nuclide.I131, device="cpu")
    pair.jax.analyze(activity_mbq=50, nuclide=jn.Nuclide.I131)
    out["SimpleSensitivity"] = pair
    return out


@pytest.mark.parametrize("name", NM)
def test_nm_quaac_matches(nm, frozen, tmp_path, name):
    _quaac_close(nm[name], tmp_path)
    if name in ("MaxCountRate", "PlanarUniformity", "TomographicUniformity"):
        (tmp_path / "port").unlink()
        (tmp_path / "jax").unlink()
        _quaac_equal(nm[name], tmp_path, "yaml")


# the classes whose drawings show fits, held at the parity bar
NM_FITS = ("CenterOfRotation", "TomographicResolution", "FourBarResolution")


@pytest.mark.parametrize("name", [n for n in NM if n != "SimpleSensitivity"])
def test_nm_plots_match(nm, plt, name):
    kwargs = {} if name == "TomographicResolution" else {"show": False}
    _same_drawing(plt, nm[name], lambda o: o.plot(**kwargs),
              _at_the_bar if name in NM_FITS else _assert_same_figure)


def test_nm_part_plots_match(nm, plt):
    """The parts' own drawing: a FOV's and a sphere's ``plot_to``, an axis
    profile's and a bar profile's ``plot``."""
    pu = nm["PlanarUniformity"]
    for fov, color in (("ufov", "y"), ("cfov", "r")):
        _same_drawing(plt, _pair(pu.port.frame_results["1"][fov], pu.jax.frame_results["1"][fov]),
                  lambda f: f.plot_to(plt.gca(), color))
    tc = nm["TomographicContrast"]
    _same_drawing(plt, _pair(tc.port.rois["1"], tc.jax.rois["1"]), lambda r: r.plot_to(plt.gca()))
    res, bars = nm["TomographicResolution"], nm["FourBarResolution"]
    for pair in (_pair(res.port.z_axis, res.jax.z_axis), _pair(bars.port.y_axis, bars.jax.y_axis)):
        _same_drawing(plt, pair, lambda a: a.plot(), _at_the_bar)


def test_nm_have_no_pdf_as_in_jax(nm):
    for name, pair in nm.items():
        assert not hasattr(pair.jax, "publish_pdf") and not hasattr(pair.port, "publish_pdf")


# ---------------------------------------------------------------------------
# the machine-log analyzer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def logs(tmp_path_factory, jax_mods):
    """A dynalog pair, a trajectory log and a VMAT arc read by both
    packages, their gamma maps made at the PDF's defaults."""
    import pylinac_tpu.log_analyzer as jl
    from tests.models import test_log_analyzer as jtests

    d = tmp_path_factory.mktemp("reports_logs")
    paths = {"dynalog": jtests.write_dynalog_pair(d)["A"],
             "tlog": jtests.write_tlog(d / "T1_log.bin"),
             "vmat tlog": write_vmat_tlog(d / "V1_arc.bin", n_snap=200, seed=1)}
    out = {}
    for name, path in paths.items():
        pair = _pair(tl.load_log(path, device="cpu"), jl.load_log(path))
        for log in (pair.port, pair.jax):
            log.fluence.gamma.calc_map()
        out[name] = pair
    return out


@pytest.mark.parametrize("name", ["dynalog", "tlog", "vmat tlog"])
def test_log_pdf_bytes_equal(logs, frozen, tmp_path, name):
    _pdfs_equal(logs[name], tmp_path, notes="weekly", metadata={"Author": "QA"})


LOG_DRAWS = {
    "summary": lambda g: g.plot_summary(show=False),
    "actual": lambda g: g.plot_subfluence("actual", show=False),
    "gamma": lambda g: g.plot_subfluence("gamma", show=False, fontsize=14),
    "rms": lambda g: g.plot_subgraph("rms", show=False),
    "histogram": lambda g: g.plot_subgraph("histogram", show=False, labelsize=10),
    "expected_map": lambda g: g.fluence.expected.plot_map(show=False),
    "gamma_map": lambda g: g.fluence.gamma.plot_map(show=False),
    "gamma_hist": lambda g: g.fluence.gamma.plot_histogram(show=False),
    "gamma_hist_linear": lambda g: g.fluence.gamma.plot_histogram(
        "linear", bins=[0, 0.5, 1, 2], show=False),
    "passfail": lambda g: g.fluence.gamma.plot_passfail_map(),
    "mlc_hist": lambda g: g.axis_data.mlc.plot_mlc_error_hist(show=False),
    "rms_by_leaf": lambda g: g.axis_data.mlc.plot_rms_by_leaf(show=False),
    "gantry": lambda g: g.axis_data.gantry.plot_actual(),
    "mu": lambda g: g.axis_data.mu.plot_expected(),
    "leaf": lambda g: g.axis_data.mlc.leaf_axes[5].plot_difference(),
}
# the drawings of a gamma map: the VMAT arc's is within 1e-6 of JAX's
# (tests/test_torch_log_analyzer.py), the others' equal
GAMMA_MAPS = ("summary", "gamma", "gamma_map")


@pytest.mark.parametrize("draw", list(LOG_DRAWS))
@pytest.mark.parametrize("name", ["dynalog", "vmat tlog"])
def test_log_plots_match(logs, plt, name, draw):
    at_bar = name == "vmat tlog" and draw in GAMMA_MAPS
    _same_drawing(plt, logs[name], LOG_DRAWS[draw], _at_the_bar if at_bar else _assert_same_figure)


@pytest.mark.parametrize("save", [
    lambda g, f: g.save_summary(f),
    lambda g, f: g.save_subimage(f, "expected", fontsize=12),
    lambda g, f: g.save_subgraph(f, "gamma"),
    lambda g, f: g.fluence.actual.save_map(f),
    lambda g, f: g.fluence.gamma.save_histogram(f, scale="linear"),
    lambda g, f: g.axis_data.mlc.save_mlc_error_hist(f),
    lambda g, f: g.axis_data.mlc.save_rms_by_leaf(f),
    lambda g, f: g.axis_data.gantry.save_plot_actual(f),
    lambda g, f: g.axis_data.mu.save_plot_expected(f),
    lambda g, f: g.axis_data.mlc.leaf_axes[5].save_plot_difference(f),
], ids=["summary", "subimage", "subgraph", "map", "histogram", "mlc_hist", "rms_by_leaf",
        "gantry", "mu", "leaf"])
def test_log_saved_images_match(logs, tmp_path, save):
    _saved_png(logs["tlog"], save, tmp_path)


def test_log_reports_raise_as_in_jax(logs, plt, tmp_path):
    """An unknown histogram scale and a map not yet calculated raise the
    same types in both packages."""
    pair = logs["tlog"]
    assert isinstance(_same_error(
        pair, lambda g: g.fluence.gamma.plot_histogram("cubic", show=False)), ValueError)
    assert isinstance(_same_error(
        pair, lambda g: g.axis_data.gantry._plot("speed", show=False)), ValueError)
    fresh = _pair(tl.load_log(pair.port.filename, device="cpu"),
                  type(pair.jax)(pair.jax.filename))
    for call in (lambda g: g.plot_summary(show=False),
                 lambda g: g.fluence.actual.plot_map(show=False),
                 lambda g: g.fluence.gamma.plot_passfail_map()):
        assert isinstance(_same_error(fresh, call), ValueError)
    plt.close("all")


# ---------------------------------------------------------------------------
# JawOrthogonality and the plan generator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jaw(tmp_path_factory, jax_mods):
    from pylinac_tpu.contrib.orthogonality import JawOrthogonality as JJaw

    path = draw_orthogonality(tlayers, AS1000Image, tmp_path_factory.mktemp("reports_jaw")
                              / "square.dcm")
    pair = _pair(JawOrthogonality(path), JJaw(path))
    pair.port.analyze(device="cpu")
    pair.jax.analyze()
    return pair


def test_jaw_plot_matches(jaw, plt):
    assert jaw.port.results() == jaw.jax.results()
    _same_drawing(plt, jaw, lambda j: j.plot_analyzed_image(show=False))


def test_jaw_plot_before_analysis_raises_as_in_jax(jaw, plt):
    from pylinac_tpu.contrib.orthogonality import JawOrthogonality as JJaw

    path = jaw.port.image.path
    err = _same_error(_pair(JawOrthogonality(path), JJaw(path)),
                      lambda j: j.plot_analyzed_image(show=False))
    assert isinstance(err, AttributeError)
    plt.close("all")


@pytest.fixture(scope="module")
def plans(jax_mods):
    """A TrueBeam plan of an open field and a picket fence, made by both
    packages from the same template."""
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.plan_generator import dicom as jdicom
    from tests.models.test_plan_generator import make_template_plan

    buf = io.BytesIO()
    jdcm.dcmwrite(buf, make_template_plan("truebeam"))
    raw = buf.getvalue()
    kw = {"plan_label": "QA", "plan_name": "QA Plan"}
    pair = _pair(tdicom.TrueBeamPlanGenerator(tdcm.dcmread(io.BytesIO(raw)), **kw),
                 jdicom.TrueBeamPlanGenerator(jdcm.dcmread(io.BytesIO(raw)), **kw))
    for gen in (pair.port, pair.jax):
        gen.add_open_field_beam(x1=-20, x2=20, y1=-30, y2=30)
        gen.add_picketfence_beam(strip_width_mm=3, strip_positions_mm=(-30, 0, 30))
    return pair


def test_plot_fluences_match(plans, plt):
    from pylinac_tpu.plan_generator import fluence as jfluence

    plans_pair = _pair(plans.port.as_dicom(), plans.jax.as_dicom())
    _same_drawing(plt, _pair(*plans_pair.__dict__.values()), lambda p: (
        tfluence.plot_fluences(p, 200, 1, show=False, device="cpu") if p is plans_pair.port
        else jfluence.plot_fluences(p, 200, 1, show=False)))
    _same_drawing(plt, plans, lambda g: (
        g.plot_fluences(width_mm=200, resolution_mm=1, device="cpu") if g is plans.port
        else g.plot_fluences(width_mm=200, resolution_mm=1)))


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------
REPORT_MODULES = ["planar_imaging", "field_profile_analysis", "nuclear", "log_analyzer",
                  "contrib.orthogonality", "plan_generator.dicom", "plan_generator.fluence"]


def _is_report(name: str) -> bool:
    return name.startswith(("plot", "save", "publish", "to_quaac", "_quaac",
                            "report_basic"))


def _params(fn) -> list[tuple]:
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module", REPORT_MODULES)
def test_report_methods_keep_jax_signatures(jax_mods, module):
    """Every report method and function of the JAX module (plots, saves,
    PDFs, QuAAC, printed reports), public and inherited, exists in the
    port's with the same parameters, names, kinds and defaults; the port
    may add ``device`` last, where it makes its device work."""
    import importlib

    jmod = importlib.import_module(f"pylinac_tpu.{module}")
    tmod = importlib.import_module(f"pylinac_tpu_torch.{module}")
    checked = 0
    for name, obj in vars(jmod).items():
        if getattr(obj, "__module__", None) != jmod.__name__:
            continue
        pairs = []
        if inspect.isclass(obj):
            for attr in dir(obj):
                if _is_report(attr) and callable(getattr(obj, attr)):
                    port_cls = getattr(tmod, name)
                    assert hasattr(port_cls, attr), f"{name}.{attr}"
                    pairs.append((f"{name}.{attr}", getattr(port_cls, attr),
                                  getattr(obj, attr)))
        elif inspect.isfunction(obj) and _is_report(name):
            pairs.append((name, getattr(tmod, name), obj))
        for what, got, want in pairs:
            got, want = _params(got), _params(want)
            if got and got[-1][0] == "device" and (not want or want[-1][0] != "device"):
                got = got[:-1]
            assert got == want, what
            checked += 1
    assert checked > 0
