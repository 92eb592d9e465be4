"""The port's reports of the beam analyses against the JAX package's, on the
CPU: ``WinstonLutz`` and its images (``WinstonLutz2D``), the multi-target
Winston-Lutz, ``FieldAnalysis`` and ``DeviceFieldAnalysis``, ``Starshot``,
the VMAT tests (DRGS, DRMLC, DRCS), ``DLG``, and the image metrics' drawing.

The inputs are ones that each class's own ``tests/test_torch_<x>.py`` holds
equal to JAX, the cheapest of them: the 4-frame AS500 Winston-Lutz session
of ``test_torch_winstonlutz.py``, the 5-frame open-field multi-target
session of ``test_torch_wl_multitarget.py``, the noisy 100 mm AS1000 field
and the Profiler export of ``test_torch_field_analysis.py``, the five-spoke
500 x 520 star of ``test_torch_starshot.py``, the VMAT pairs of
``test_torch_vmat.py`` and the AS1000 sweeping gap of ``test_torch_dlg.py``.
Each package analyses each input once a module.

The checks are those of ``tests/test_torch_reports.py``, whose helpers this
file imports: PDF bytes equal with both clocks frozen, QuAAC JSON and YAML
texts equal, plotly JSON with keys and strings exact and numbers at the
parity bar, and each matplotlib figure's signature. Where the JAX method
raises, the port raises the same exception type.
"""

import dataclasses
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pylinac_tpu_torch import (DLG, DRCS, DRGS, DRMLC, MLC, FieldAnalysis, MachineScale, Starshot,
                               WinstonLutz)
from pylinac_tpu_torch import WinstonLutzMultiTargetMultiField as PortMTMF
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import profile as tprofile
from pylinac_tpu_torch.core.geometry import Point
from pylinac_tpu_torch.core.image import ArrayImage
from pylinac_tpu_torch.field_analysis import Device, DeviceFieldAnalysis
from pylinac_tpu_torch.imggen import layers
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1000Image
from pylinac_tpu_torch.imggen.utils import (_generate_dlg, _generate_vmat_pair,
                                            generate_winstonlutz_multi_bb_single_field,
                                            make_starshot)
from pylinac_tpu_torch.metrics import image as tmi
from tests.test_torch_dlg import GAPS
from tests.test_torch_field_analysis import _write, _write_prs
from tests.test_torch_reports import (_assert_close_tree, _assert_same_figure, _few_threads,
                                      _figs_json, frozen, jax_mods, plt)
from tests.test_torch_starshot import SMALL
from tests.test_torch_vmat import SmallDetector
from tests.test_torch_winstonlutz import AXES_4, _generate
from tests.test_torch_wl_multitarget import _arrangement_of, _bb_array, _fields_array

# the fixtures above are imported to be used here
__all__ = ["_few_threads", "frozen", "jax_mods", "plt"]


def _pair(port, jax) -> SimpleNamespace:
    return SimpleNamespace(port=port, jax=jax)


@pytest.fixture(scope="module")
def jx(jax_mods):
    """The JAX modules of this file's classes."""
    from pylinac_tpu import dlg, field_analysis, picketfence, starshot, vmat, winston_lutz
    from pylinac_tpu.core import image
    from pylinac_tpu.core.geometry import Point as JPoint
    from pylinac_tpu.metrics import image as metrics

    return SimpleNamespace(wl=winston_lutz, fa=field_analysis, star=starshot, vmat=vmat,
                           dlg=dlg, pf=picketfence, image=image, metrics=metrics, Point=JPoint)


@pytest.fixture(scope="module")
def wl(tmp_path_factory, jx):
    d = _generate(str(tmp_path_factory.mktemp("reports_wl") / "wl"), AS500Image,
                  image_axes=AXES_4, offset_mm_left=0.5, offset_mm_up=0.3)
    port = WinstonLutz(d)
    port.analyze(device="cpu")
    ref = jx.wl.WinstonLutz(d)
    ref.analyze()
    return _pair(port, ref)


@pytest.fixture(scope="module")
def mtmf(tmp_path_factory, jx):
    d = str(tmp_path_factory.mktemp("reports_mtmf") / "open")
    generate_winstonlutz_multi_bb_single_field(
        AS500Image(sid=1000), layers.PerfectFieldLayer, d, offsets=[(0, 0, 0), (6, 6, -10)],
        field_size_mm=(40, 40), final_layers=[layers.GaussianFilterLayer(sigma_mm=1)],
        image_axes=((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0), (0, 0, 45)))
    arrangement = _arrangement_of([
        {"offset_left_mm": 0, "offset_up_mm": 0, "offset_in_mm": 0},
        {"offset_left_mm": 6, "offset_up_mm": 6, "offset_in_mm": -10}])
    kwargs = {"is_open_field": True, "snap_tolerance": 5}
    port = PortMTMF(d)
    port.analyze(arrangement, device="cpu", machine_scale=MachineScale.VARIAN_IEC, **kwargs)
    ref = jx.wl.WinstonLutzMultiTargetMultiField(d)
    ref.analyze(tuple(jx.wl.BBConfig(**dataclasses.asdict(b)) for b in arrangement),
                machine_scale=jx.wl.MachineScale.VARIAN_IEC, **kwargs)
    return _pair(port, ref)


@pytest.fixture(scope="module")
def fa(tmp_path_factory, jx):
    tmp = tmp_path_factory.mktemp("reports_fa")
    path = _write(tmp / "field0.dcm", [
        layers.FilteredFieldLayer(field_size_mm=(100, 100)), layers.GaussianFilterLayer(sigma_mm=1),
        layers.RandomNoiseLayer(sigma=0.002, seed=1234)])
    port = FieldAnalysis(path, device="cpu")
    port.analyze()
    ref = jx.fa.FieldAnalysis(path)
    ref.analyze()
    prs = _write_prs(tmp / "profiler.prs")
    devices = {}
    for edge in ("Inflection Derivative", "Inflection Hill"):
        dport = DeviceFieldAnalysis(prs, device=Device.PROFILER)
        dport.analyze(edge_detection_method=edge)
        dref = jx.fa.DeviceFieldAnalysis(prs, device=jx.fa.Device.PROFILER)
        dref.analyze(edge_detection_method=edge)
        devices[edge] = _pair(dport, dref)
    return SimpleNamespace(port=port, jax=ref, device=devices["Inflection Derivative"],
                           device_hill=devices["Inflection Hill"])


@pytest.fixture(scope="module")
def star(tmp_path_factory, jx):
    path = make_starshot(tmp_path_factory.mktemp("reports_star"), name="five.dcm", **SMALL,
                         n_spokes=5, angles_offset=10.0)
    port = Starshot(path)
    port.analyze()
    ref = jx.star.Starshot(path)
    ref.analyze()
    return _pair(port, ref)


@pytest.fixture(scope="module")
def vmats(tmp_path_factory, jx):
    out = {}
    for name, cls, sim in (("DRGS", DRGS, AS1000Image(sid=1500)),
                           ("DRMLC", DRMLC, AS1000Image(sid=1500)),
                           ("DRCS", DRCS, SmallDetector(sid=1000))):
        paths = _generate_vmat_pair(name.lower(), sim, str(tmp_path_factory.mktemp(name)))
        port = cls(image_paths=paths, device="cpu")
        port.analyze()
        ref = getattr(jx.vmat, name)(image_paths=paths)
        ref.analyze()
        out[name] = _pair(port, ref)
    return out


@pytest.fixture(scope="module")
def dlg(tmp_path_factory, jx):
    path = str(tmp_path_factory.mktemp("reports_dlg") / "dlg1000.dcm")
    _generate_dlg(AS1000Image(sid=1000), path, GAPS)
    port = DLG(path)
    port.analyze(gaps=GAPS, mlc=MLC.MILLENNIUM)
    ref = jx.dlg.DLG(path)
    ref.analyze(gaps=GAPS, mlc=jx.pf.MLC.MILLENNIUM)
    return _pair(port, ref)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _pdfs_equal(pair, tmp_path, **kwargs) -> None:
    pair.port.publish_pdf(tmp_path / "port.pdf", **kwargs)
    pair.jax.publish_pdf(tmp_path / "jax.pdf", **kwargs)
    got, want = (tmp_path / "port.pdf").read_bytes(), (tmp_path / "jax.pdf").read_bytes()
    assert got.startswith(b"%PDF") and got == want


def _quaac_equal(pair, tmp_path, fmt) -> None:
    kw = dict(performer={"name": "QA"}, primary_equipment={"name": "TB1"}, format=fmt)
    pair.port.to_quaac(tmp_path / "port", **kw)
    pair.jax.to_quaac(tmp_path / "jax", **kw)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()


def _plotly_equal(pair, names, **kwargs) -> None:
    got = _figs_json(pair.port.plotly_analyzed_images(show=False, **kwargs))
    want = _figs_json(pair.jax.plotly_analyzed_images(show=False, **kwargs))
    assert list(got) == names
    _assert_close_tree(got, want)


def _same_drawing(plt, pair, draw, compare=_assert_same_figure) -> None:
    """``draw(obj)`` in both packages, each on a fresh current figure (a
    drawing may open its own figures or draw on pyplot's current one): the
    same figures with axes, each compared by ``compare``."""
    figs = []
    for obj in (pair.port, pair.jax):
        fresh = plt.figure()
        before = set(plt.get_fignums()) - {fresh.number}
        draw(obj)
        figs.append([f for f in map(plt.figure, plt.get_fignums())
                     if f.number not in before and f.axes])
    assert len(figs[0]) == len(figs[1]) > 0
    for got, want in zip(*figs):
        compare(got, want)
    plt.close("all")


def _same_error(pair, call):
    """``call(obj)`` raises in JAX; the port raises the same type (by name:
    each package has its own ``NotAnalyzed``)."""
    with pytest.raises(Exception) as want:
        call(pair.jax)
    with pytest.raises(Exception) as got:
        call(pair.port)
    assert type(got.value).__name__ == type(want.value).__name__
    return want.value


# ---------------------------------------------------------------------------
# Winston-Lutz
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("notes", [None, ["Linac 1", "monthly"]])
def test_wl_pdf_bytes_equal(wl, frozen, tmp_path, notes):
    _pdfs_equal(wl, tmp_path, notes=notes, metadata={"Author": "QA"})


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_wl_quaac_text_equal(wl, frozen, tmp_path, fmt):
    _quaac_equal(wl, tmp_path, fmt)


@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
def test_wl_plotly_equal(wl, kwargs):
    names = [f"{i} - {img.to_axes()}" for i, img in enumerate(wl.jax.images)]
    _plotly_equal(wl, names + ["Isocenter Visualization"], **kwargs)


@pytest.mark.parametrize("draw", [
    lambda w: w.plot_images(show=False),
    lambda w: w.plot_summary(show=False),
    lambda w: w.plot_axis_images(show=False),
    lambda w: w.plot_axis_images("Collimator", show=False),
    lambda w: w.plot_location(show=False),
    lambda w: w.plot_location(show=False, viewbox_mm=5, plot_bb=False, show_legend=False),
    lambda w: w.images[0].plot(show=False),
], ids=["images", "summary", "gantry", "collimator", "location", "location_viewbox", "image"])
def test_wl_matplotlib_figures_match(wl, plt, draw):
    _same_drawing(plt, wl, draw)


def test_wl_saved_images_match(wl, plt, tmp_path):
    for pkg, obj in (("port", wl.port), ("jax", wl.jax)):
        (tmp_path / pkg).mkdir()
        names = obj.save_images(prefix=f"{tmp_path / pkg}/")
        assert len(names) == len(obj.images)
        obj.save_summary(tmp_path / pkg / "summary.png")
    got = {p.name: p.read_bytes() for p in (tmp_path / "port").iterdir()}
    want = {p.name: p.read_bytes() for p in (tmp_path / "jax").iterdir()}
    assert got == want and len(got) == 5
    got = {k: v.getvalue() for k, v in wl.port.save_images_to_stream().items()}
    want = {k: v.getvalue() for k, v in wl.jax.save_images_to_stream().items()}
    assert got == want
    plt.close("all")


def test_wl_saved_images_without_base_path(wl, plt, tmp_path):
    """Without a file name the images are named by ``id()``: the same count
    and the same PNGs, whatever the names."""
    contents = []
    for pkg, obj in (("port", wl.port), ("jax", wl.jax)):
        kept = [img.__dict__.pop("base_path") for img in obj.images]
        try:
            (tmp_path / pkg).mkdir()
            obj.save_images(prefix=f"{tmp_path / pkg}/")
        finally:
            for img, name in zip(obj.images, kept):
                img.base_path = name
        contents.append(sorted(p.read_bytes() for p in (tmp_path / pkg).iterdir()))
    assert len(contents[0]) == len(wl.port.images) and contents[0] == contents[1]
    plt.close("all")


def test_image_base_path_and_source(wl, jx):
    img, ref = wl.port.images[0], wl.jax.images[0]
    assert (img.base_path, img.source) == (ref.base_path, ref.source) == (
        Path(img.path).name, "file")
    data = Path(img.path).read_bytes()
    port, want = timage.load(io.BytesIO(data)), jx.image.load(io.BytesIO(data))
    assert port.source == want.source == "stream"
    assert not hasattr(port, "base_path") and not hasattr(want, "base_path")
    assert ArrayImage(np.zeros((4, 4))).source == "stream"


# ---------------------------------------------------------------------------
# the multi-target Winston-Lutz
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_mtmf_quaac_text_equal(mtmf, frozen, tmp_path, fmt):
    _quaac_equal(mtmf, tmp_path, fmt)


def test_mtmf_pdf_bytes_equal(mtmf, frozen, tmp_path):
    _pdfs_equal(mtmf, tmp_path, notes="MultiMet")


@pytest.mark.parametrize("draw", [
    lambda w: w.plot_images(show=False),
    lambda w: w.plot_axis_images(show=False),
    lambda w: w.images[4].plot(show=False),
], ids=["images", "gantry", "image"])
def test_mtmf_matplotlib_figures_match(mtmf, plt, draw):
    _same_drawing(plt, mtmf, draw)


@pytest.mark.parametrize("call", [
    lambda w: w.plot_location(show=False, viewbox_mm=20),
    lambda w: w.plotly_analyzed_images(show=False, show_colorbar=False),
], ids=["location", "plotly"])
def test_mtmf_3d_reports_raise_as_in_jax(mtmf, plt, call):
    """JAX reads ``BB3D.measured_position``, which ``BB3D`` has not."""
    err = _same_error(mtmf, call)
    assert isinstance(err, AttributeError) and "measured_position" in str(err)
    plt.close("all")


# ---------------------------------------------------------------------------
# the image metrics
# ---------------------------------------------------------------------------
def _metric_images(jx):
    """Each metric of ``metrics/image.py`` computed on a small image of both
    packages: [(port image, JAX image)]."""
    from pylinac_tpu.core.image import ArrayImage as JArrayImage

    def both(arr, make):
        port = ArrayImage(arr.copy(), dpi=2.0 * 25.4)
        port.compute(make(tmi, Point, {"device": "cpu"}))
        ref = JArrayImage(arr.copy(), dpi=2.0 * 25.4)
        ref.compute(make(jx.metrics, jx.Point, {}))
        return port, ref

    bbs = _bb_array(bbs=((60, 60), (60, 240), (230, 150)))
    return [
        both(bbs, lambda m, P, dev: [
            m.DiskROIMetric(radius=10, center=P(150, 150)),
            m.DiskROIMetric.from_physical(radius_mm=6, center_mm=P(30, 100), edgecolor="g"),
            m.RectangleROIMetric(width=20, height=12, center=P(200, 60)),
            m.GlobalSizedDiskLocator(radius_mm=4, radius_tolerance_mm=2, min_number=3,
                                     max_number=3, **dev)]),
        both(bbs, lambda m, P, dev: [
            m.SizedDiskLocator(expected_position=P(60, 60), search_window=(40, 40),
                               radius=8, radius_tolerance=4, **dev),
            m.SizedDiskRegion(expected_position=P(240, 60), search_window=(40, 40),
                              radius=8, radius_tolerance=4, **dev)]),
        both(_fields_array(), lambda m, P, dev: [m.GlobalFieldLocator(max_number=3, **dev)]),
    ]


def test_metric_plots_match(jx, plt):
    for port, ref in _metric_images(jx):
        _assert_same_figure(port.plot(show=False).figure, ref.plot(show=False).figure)
        for pm, jm in zip(port.metrics, ref.metrics):
            figs = []
            for metric in (pm, jm):
                fig, ax = plt.subplots()
                metric.plot(ax)
                figs.append(fig)
            if figs[1].axes[0].has_data():
                _assert_same_figure(*figs)
            else:
                assert not figs[0].axes[0].has_data()
        plt.close("all")


# ---------------------------------------------------------------------------
# FieldAnalysis and DeviceFieldAnalysis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("notes", [None, "6 MV"])
def test_fa_pdf_bytes_equal(fa, frozen, tmp_path, notes):
    _pdfs_equal(fa, tmp_path, notes=notes, metadata={"Unit": "TB1"})
    _pdfs_equal(fa.device, tmp_path, notes=notes)


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_fa_quaac_text_equal(fa, frozen, tmp_path, fmt):
    _quaac_equal(fa, tmp_path, fmt)
    (tmp_path / "port").unlink()
    (tmp_path / "jax").unlink()
    _quaac_equal(fa.device, tmp_path, fmt)


def test_device_fa_hill_quaac_at_the_bar(fa, frozen, tmp_path):
    """The Profiler's Hill fits differ from JAX's by about 1e-6 relative
    (``tests/test_torch_field_analysis.py`` holds them at the parity bar),
    so their QuAAC documents agree at the bar, not to the last digit."""
    import json

    kw = dict(performer={"name": "QA"}, format="json")
    fa.device_hill.port.to_quaac(tmp_path / "port", **kw)
    fa.device_hill.jax.to_quaac(tmp_path / "jax", **kw)
    _assert_close_tree(json.loads((tmp_path / "port").read_text()),
                       json.loads((tmp_path / "jax").read_text()))


@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
def test_fa_plotly_equal(fa, kwargs):
    _plotly_equal(fa, ["Image", "Vertical Profile", "Horizontal Profile"], **kwargs)
    _plotly_equal(fa.device, ["Vertical Profile", "Horizontal Profile"], **kwargs)
    _plotly_equal(fa.device_hill, ["Vertical Profile", "Horizontal Profile"], **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"grid": False, "split_plots": True}])
def test_fa_matplotlib_figures_match(fa, plt, kwargs):
    _same_drawing(plt, fa, lambda f: f.plot_analyzed_image(show=False, **kwargs))


def test_fa_profile_plots_match(fa, jx, plt):
    from pylinac_tpu.core import profile as jprofile

    _same_drawing(plt, fa, lambda f: f.vert_profile.plot(show=False))
    values = fa.jax.vert_profile.values
    for kwargs in ({}, {"show_field_edges": False, "show_grid": False, "show_center": False,
                        "data_label": "Vertical"}):
        _same_drawing(plt, _pair(tprofile.FWXMProfile(values), jprofile.FWXMProfile(values)),
                      lambda p: p.plot(show=False, **kwargs))
    for name in ("flatness", "symmetry"):
        figs = []
        for obj in (fa.port, fa.jax):
            fig, ax = plt.subplots()
            obj._protocol.value[name]["plot"](obj, obj.vert_profile, ax)
            figs.append(fig)
        assert len(figs[0].axes[0].lines) == len(figs[1].axes[0].lines)
        if figs[1].axes[0].lines:
            _assert_same_figure(*figs)
        plt.close("all")


def test_device_fa_plot_raises_as_in_jax(fa, plt):
    """``DeviceFieldAnalysis`` never sets ``image``, which the plot reads."""
    _same_error(fa.device, lambda f: f.plot_analyzed_image(show=False))
    plt.close("all")


def test_fa_reports_before_analysis_raise(jx, tmp_path):
    pair = _pair(DeviceFieldAnalysis(_write_prs(tmp_path / "p.prs"), device=Device.PROFILER),
                 jx.fa.DeviceFieldAnalysis(str(tmp_path / "p.prs"), device=jx.fa.Device.PROFILER))
    for call in (lambda f: f.plotly_analyzed_images(show=False),
                 lambda f: f.publish_pdf(tmp_path / "x.pdf")):
        _same_error(pair, call)


# ---------------------------------------------------------------------------
# Starshot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("notes", [None, ["collimator", "star"]])
def test_star_pdf_bytes_equal(star, frozen, tmp_path, notes):
    _pdfs_equal(star, tmp_path, notes=notes)


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_star_quaac_text_equal(star, frozen, tmp_path, fmt):
    _quaac_equal(star, tmp_path, fmt)


@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
def test_star_plotly_equal(star, kwargs):
    _plotly_equal(star, ["Image", "Wobble"], **kwargs)


@pytest.mark.parametrize("draw", [
    lambda s: s.plot_analyzed_image(show=False),
    lambda s: s.plot_analyzed_subimage(show=False),
    lambda s: s.circle_profile.plot(),
], ids=["image", "subimage", "profile"])
def test_star_matplotlib_figures_match(star, plt, draw):
    _same_drawing(plt, star, draw)


# ---------------------------------------------------------------------------
# VMAT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["DRGS", "DRMLC", "DRCS"])
def test_vmat_pdf_bytes_equal(vmats, frozen, tmp_path, name):
    _pdfs_equal(vmats[name], tmp_path, notes="arc", metadata={"Author": "QA"})


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("name", ["DRGS", "DRMLC", "DRCS"])
def test_vmat_quaac_text_equal(vmats, frozen, tmp_path, name, fmt):
    _quaac_equal(vmats[name], tmp_path, fmt)


@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
@pytest.mark.parametrize("name", ["DRGS", "DRMLC", "DRCS"])
def test_vmat_plotly_equal(vmats, name, kwargs):
    _plotly_equal(vmats[name], ["Open", "DMLC", "Median Profiles"], **kwargs)


@pytest.mark.parametrize("name", ["DRGS", "DRMLC", "DRCS"])
def test_vmat_matplotlib_figures_match(vmats, plt, name):
    _same_drawing(plt, vmats[name], lambda v: v.plot_analyzed_image(show=False))


# ---------------------------------------------------------------------------
# DLG
# ---------------------------------------------------------------------------
def test_dlg_plot_matches(dlg, plt):
    for obj in (dlg.port, dlg.jax):
        plt.figure()
        obj.plot_dlg(show=False)
    fig_j = plt.gcf()
    _assert_same_figure(plt.figure(plt.get_fignums()[-2]), fig_j)
    plt.close("all")


def test_dlg_plot_before_analysis_raises(jx, dlg):
    pair = _pair(DLG(dlg.port.image.path), jx.dlg.DLG(dlg.jax.image.path))
    err = _same_error(pair, lambda d: d.plot_dlg(show=False))
    assert isinstance(err, ValueError)


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------
def test_no_report_stub_is_left():
    """No ``not_ported`` stub is left in the port and the helper is gone:
    every report method of every class is ported."""
    import pylinac_tpu_torch as pkg
    from pylinac_tpu_torch.core import utilities

    root = Path(pkg.__file__).parent
    stubbed = [path.relative_to(root).as_posix() for path in root.rglob("*.py")
               if "not_ported" in path.read_text() or "ROADMAP item 11" in path.read_text()]
    assert stubbed == []
    assert not hasattr(utilities, "not_ported")
