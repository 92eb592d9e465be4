"""The port's reports of the main path against the JAX package's, on the CPU:
``PicketFence`` and ``CatPhan504`` (whose report methods are
``CatPhanBase``'s, shared by the CatPhan 503, 600, 604 and 700).

The inputs are the analyses that ``tests/test_torch_picketfence_single.py``
and ``tests/test_torch_catphan.py`` hold equal to JAX: an AS1200 fence of 10
pickets with one 0.4 mm off (made by the JAX image generator), and the
60-slice CatPhan 504 scan (JAX with ``PYLINAC_TPU_CCL=xla``, the port on the
CPU). Each package analyses each input once a module.

- ``publish_pdf``: the bytes equal JAX's, with the clock frozen in both
  ``core/pdf.py``;
- ``to_quaac``: the JSON and YAML texts equal, with the clock frozen in both
  ``core/utilities.py``;
- ``plotly_analyzed_images``: the figures' JSON schema equal, keys and
  strings exact, numbers at the parity bar (0.01 absolute or 0.1 %
  relative, whichever is larger), image arrays exact;
- each matplotlib method (Agg, ``show=False``): a signature of its figure,
  per axes the title and labels, the image arrays (equal) and colour
  limits, the lines' data and the patches' extents (within 1e-6 px), their
  colours, and the texts.

The settings module, the plotly helpers and the QuAAC emitter are copies;
they are checked against JAX's directly.
"""

import datetime
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch import picketfence as tpf
from pylinac_tpu_torch import settings as tsettings
from pylinac_tpu_torch.core import pdf as tpdf
from pylinac_tpu_torch.core import plotly_utils as tpu
from pylinac_tpu_torch.core import utilities as tutil

PX_TOL = 1e-6


class _FrozenClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 6, 7, 8, 9)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    from pylinac_tpu import settings
    from pylinac_tpu.core import pdf, plotly_utils, utilities

    return SimpleNamespace(pdf=pdf, pu=plotly_utils, util=utilities, settings=settings)


@pytest.fixture
def frozen(jax_mods, monkeypatch):
    for mod in (tpdf, tutil, jax_mods.pdf, jax_mods.util):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)


@pytest.fixture(scope="module")
def pf(tmp_path_factory, jax_mods):
    """The single-image PicketFence of both packages on one fence."""
    from pylinac_tpu.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu.imggen.simulators import AS1200Image
    from pylinac_tpu.imggen.utils import generate_picketfence
    from pylinac_tpu.picketfence import PicketFence as JPicketFence

    path = str(tmp_path_factory.mktemp("reports_pf") / "offset.dcm")
    generate_picketfence(simulator=AS1200Image(sid=1500), field_layer=PerfectFieldLayer,
                         file_out=path, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                         picket_width_mm=3, pickets=10, picket_spacing_mm=20,
                         picket_offset_error=[0, 0, 0.4, 0, 0, 0, 0, 0, 0, 0])
    jax_pf = JPicketFence(path)
    jax_pf.analyze(tolerance=0.2, action_tolerance=0.1)
    port = tpf.PicketFence(path, device="cpu")
    port.analyze(tolerance=0.2, action_tolerance=0.1)
    return SimpleNamespace(jax=jax_pf, port=port)


@pytest.fixture(scope="module")
def cp(tmp_path_factory, jax_mods):
    """CatPhan504 of both packages on the scan of tests/test_torch_catphan.py."""
    from pylinac_tpu_torch.imggen.ct import generate_catphan504

    d = tmp_path_factory.mktemp("reports_catphan")
    generate_catphan504(d, num_slices=60, slice_thickness_mm=2.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYLINAC_TPU_CCL", "xla")
        from pylinac_tpu.ct import CatPhan504 as JCatPhan504

        jax_ct = JCatPhan504(str(d))
        jax_ct.analyze()
    port = tct.CatPhan504(str(d))
    port.analyze(device="cpu")
    return SimpleNamespace(jax=jax_ct, port=port)


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------
def _assert_close_tree(a, b, path=""):
    """Keys and strings exact; arrays of numbers equal in shape, numbers at
    the parity bar."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_close_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and a and not isinstance(a[0], (int, float)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, (list, tuple)) or isinstance(a, float):
        x, y = np.asarray(a, float), np.asarray(b, float)
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=path)
        ok = ~np.isnan(x)
        tol = np.maximum(0.01, 1e-3 * np.abs(y[ok]))
        assert np.all(np.abs(x[ok] - y[ok]) <= tol), path
    else:
        assert a == b, path


def _figs_json(figs) -> dict:
    return {name: json.loads(fig.to_json()) for name, fig in figs.items()}


def _color(c):
    from matplotlib.colors import to_rgba

    try:
        return tuple(np.round(to_rgba(c), 6))
    except ValueError:
        return tuple(np.round(np.asarray(c, float).ravel(), 6))


def _signature(fig) -> list[dict]:
    out = []
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "images": [np.asarray(im.get_array()) for im in ax.get_images()],
            "clims": [im.get_clim() for im in ax.get_images()],
            "lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float),
                       _color(ln.get_color()), ln.get_linestyle(), ln.get_marker(),
                       ln.get_label()) for ln in ax.get_lines()],
            "patches": [(type(p).__name__,
                         np.asarray(p.get_path().get_extents(p.get_patch_transform()).bounds),
                         _color(p.get_edgecolor()), p.get_fill()) for p in ax.patches],
            "offsets": [np.asarray(c.get_offsets(), float) for c in ax.collections],
            "texts": [t.get_text() for t in ax.texts],
            "axis_on": ax.axison,
        })
    return out


def _assert_same_figure(got, want, rtol=0.0, atol=PX_TOL, image_atol=0.0):
    """The figures' signatures: texts, labels and colours exact, the image
    arrays equal (or within ``image_atol``) and every other number within
    ``atol`` (and ``rtol``)."""
    sg, sw = _signature(got), _signature(want)
    assert len(sg) == len(sw) > 0
    for g, w in zip(sg, sw):
        for key in ("title", "xlabel", "ylabel", "texts", "axis_on"):
            assert g[key] == w[key], key
        assert len(g["images"]) == len(w["images"])
        for a, b in zip(g["images"], w["images"]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=image_atol)
        np.testing.assert_allclose(np.asarray(g["clims"], float), np.asarray(w["clims"], float),
                                   rtol=rtol, atol=atol)
        assert len(g["lines"]) == len(w["lines"])
        for a, b in zip(g["lines"], w["lines"]):
            np.testing.assert_allclose(a[0], b[0], rtol=rtol, atol=atol)
            np.testing.assert_allclose(a[1], b[1], rtol=rtol, atol=atol)
            assert a[2:] == b[2:]
        assert len(g["patches"]) == len(w["patches"])
        for a, b in zip(g["patches"], w["patches"]):
            assert a[0] == b[0] and a[2:] == b[2:]
            np.testing.assert_allclose(a[1], b[1], rtol=rtol, atol=atol)
        assert len(g["offsets"]) == len(w["offsets"])
        for a, b in zip(g["offsets"], w["offsets"]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the shared layer
# ---------------------------------------------------------------------------
def test_settings_copy(jax_mods):
    for name in ("DICOM_COLORMAP", "ARRAY_COLORMAP", "PATH_TRUNCATION_LENGTH"):
        assert getattr(tsettings, name) == getattr(jax_mods.settings, name)
    assert tsettings.get_dicom_cmap() == jax_mods.settings.get_dicom_cmap()
    assert tsettings.get_array_cmap() == jax_mods.settings.get_array_cmap()


def test_plotly_helpers_match_jax(jax_mods, tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    figs = []
    for pu in (tpu, jax_mods.pu):
        fig = pu.image_figure(arr, title="T", show_colorbar=False)
        fig.add_trace(pu.scatter_trace([1, 2], [3, 4], name="s", mode="lines+markers"))
        fig.add_trace(pu.marker_trace([1.5], [2.5], name="m", symbol="cross", color="red"))
        fig.add_trace(pu.histogram_trace(np.array([0.1, 0.2]), name="h", nbins=4))
        pu.add_vertical_line(fig, 1.0, color="red", width=3)
        pu.add_horizontal_line(fig, 2.0, name="h")
        pu.set_axis_range(fig, [0, 4], [0, 3])
        fig.update_layout(xaxis_title="x", showlegend=False, legend_x=0.1)
        fig.update_xaxes(showgrid=False)
        fig.write_html(tmp_path / f"{len(figs)}.html")
        figs.append(fig)
    assert figs[0].to_json() == figs[1].to_json()
    assert (tmp_path / "0.html").read_text() == (tmp_path / "1.html").read_text()


def test_quaac_yaml_emitter_matches_jax(jax_mods):
    doc = {"version": "1.0", "performer": {}, "primary_equipment": {"name": "TB1", "id": 3},
           "datapoints": [{"name": "a", "value": 1.5, "tags": [1, "x", {"k": None}]},
                          {"name": "b", "value": None, "tags": []}]}
    assert tutil._to_yaml(doc) == jax_mods.util._to_yaml(doc)
    assert (tutil.QuaacDatum(1.0, "mm").__dict__
            == jax_mods.util.QuaacDatum(1.0, "mm").__dict__)


# ---------------------------------------------------------------------------
# PicketFence
# ---------------------------------------------------------------------------
def test_pf_pdf_bytes_equal(pf, frozen, tmp_path):
    kw = dict(notes=["Linac 1", "weekly"], metadata={"Author": "QA", "Unit": "TB1"})
    pf.port.publish_pdf(tmp_path / "port.pdf", **kw)
    pf.jax.publish_pdf(tmp_path / "jax.pdf", **kw)
    got, want = (tmp_path / "port.pdf").read_bytes(), (tmp_path / "jax.pdf").read_bytes()
    assert got.startswith(b"%PDF") and got == want


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_pf_quaac_text_equal(pf, frozen, tmp_path, fmt):
    kw = dict(performer={"name": "QA"}, primary_equipment={"name": "TB1"}, format=fmt)
    pf.port.to_quaac(tmp_path / "port", **kw)
    pf.jax.to_quaac(tmp_path / "jax", **kw)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    with pytest.raises(FileExistsError):
        pf.port.to_quaac(tmp_path / "port", **kw)
    pf.port.to_quaac(tmp_path / "port", overwrite=True, **kw)


def test_pf_plotly_equal(pf):
    got = _figs_json(pf.port.plotly_analyzed_images(show=False))
    want = _figs_json(pf.jax.plotly_analyzed_images(show=False))
    assert list(got) == ["Picket Fence", "Histogram"]
    _assert_close_tree(got, want)


def test_pf_matplotlib_figures_match(pf, plt):
    fig_g, _ = pf.port.plot_analyzed_image(show=False)
    fig_w, _ = pf.jax.plot_analyzed_image(show=False)
    _assert_same_figure(fig_g, fig_w)
    plt.close("all")

    leaf = pf.port.mlc_meas[40].full_leaf_nums[0]
    _assert_same_figure(pf.port.plot_leaf_profile(leaf, 2, show=False).figure,
                        pf.jax.plot_leaf_profile(leaf, 2, show=False).figure)
    plt.close("all")

    pf.port.plot_histogram(show=False)
    fig_g = plt.gcf()
    pf.jax.plot_histogram(show=False)
    _assert_same_figure(fig_g, plt.gcf())
    plt.close("all")

    _assert_same_figure(pf.port.image.plot(show=False).figure,
                        pf.jax.image.plot(show=False).figure)
    plt.close("all")


# ---------------------------------------------------------------------------
# CatPhan504
# ---------------------------------------------------------------------------
def test_catphan_pdf_bytes_equal(cp, frozen, tmp_path):
    cp.port.publish_pdf(tmp_path / "port.pdf", notes="CT sim", metadata={"Author": "QA"})
    cp.jax.publish_pdf(tmp_path / "jax.pdf", notes="CT sim", metadata={"Author": "QA"})
    got, want = (tmp_path / "port.pdf").read_bytes(), (tmp_path / "jax.pdf").read_bytes()
    assert got.startswith(b"%PDF") and got == want


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_catphan_quaac_text_equal(cp, frozen, tmp_path, fmt):
    cp.port.to_quaac(tmp_path / "port", format=fmt)
    cp.jax.to_quaac(tmp_path / "jax", format=fmt)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()


def test_catphan_plotly_equal(cp):
    got = _figs_json(cp.port.plotly_analyzed_images(show=False))
    want = _figs_json(cp.jax.plotly_analyzed_images(show=False))
    assert list(got) == ["CTP404", "HU Linearity", "CTP486", "CTP528", "MTF", "CTP515"]
    _assert_close_tree(got, want)


def test_catphan_matplotlib_figures_match(cp, plt):
    cp.port.plot_analyzed_image(show=False)
    fig_g = plt.gcf()
    cp.jax.plot_analyzed_image(show=False)
    _assert_same_figure(fig_g, plt.gcf())
    plt.close("all")

    for draw in (lambda c, ax: c.plot_side_view(ax),
                 lambda c, ax: c.ctp404.plot_linearity(ax, plot_delta=False),
                 lambda c, ax: c.ctp486.plot_profiles(ax),
                 lambda c, ax: c.ctp528.plot(ax)):
        figs = []
        for c in (cp.port, cp.jax):
            fig, ax = plt.subplots()
            draw(c, ax)
            figs.append(fig)
        _assert_same_figure(*figs)
        plt.close("all")


def test_sibling_reports_wait(cp):
    """The CT siblings inherit CatPhanBase; their reports no longer wait: as
    in JAX, each class publishes and draws its own modules rather than the
    CatPhan family's (``tests/test_torch_reports_ct.py`` holds them to
    JAX's)."""
    from pylinac_tpu import acr, cheese, helios, quart
    from pylinac_tpu import ct as jct
    from pylinac_tpu_torch import ACRCT, GEHeliosCTDaily, QuartDVT, TomoCheese

    for cls, ref in ((ACRCT, acr.ACRCT), (GEHeliosCTDaily, helios.GEHeliosCTDaily),
                     (QuartDVT, quart.QuartDVT), (TomoCheese, cheese.TomoCheese)):
        for name in ("publish_pdf", "plot_analyzed_image"):
            assert getattr(ref, name) is not getattr(jct.CatPhanBase, name)
            assert getattr(cls, name) is not getattr(tct.CatPhanBase, name)
        assert cls.to_quaac is tct.CatPhanBase.to_quaac
