"""The port's reports of the planar phantoms against the JAX package's, on
the CPU: ``ImagePhantomBase``'s (the SI QC-3 with automatic detection), the
FC-2 family's (its BB, EPID and field lines) and ``ACRDigitalMammography``'s
(its masses', speck groups' and fibres' drawing). The long-tail classes'
reports (Las Vegas's own contrast graph, the Leeds TOR's circle outline)
are checked in ``tests/test_torch_planar_longtail.py`` on its analyses
with automatic detection.

The inputs are the recipes of ``tests/test_torch_planar.py`` and
``tests/test_torch_planar_mammo.py`` at their cheapest: the QC-3 on an
AS500 frame (384 x 512), the 100 mm FC-2 field on AS1000, the mammography
phantom at 3 px/mm (560 x 420). Each package analyses each input once a
module, and every analysis equals JAX's.

The checks are those of ``tests/test_torch_reports.py``: PDF bytes equal
with both clocks frozen (the PDFs embed matplotlib's PNGs of the plots),
QuAAC JSON and YAML texts equal, plotly JSON with keys and strings exact
and numbers at the parity bar, and each matplotlib figure's signature.
Where the JAX method raises, the port raises the same exception type.
"""

import io
import json
import warnings
from types import SimpleNamespace

import pytest

import pylinac_tpu_torch.planar_imaging as tp
from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1000Image
from pylinac_tpu_torch.imggen.utils import generate_lightrad
from tests.test_torch_planar import _data, draw_qc3
from tests.test_torch_planar_mammo import BASE as MAMMO_ARGS
from tests.test_torch_planar_mammo import draw_mammo
from tests.test_torch_reports import _few_threads, frozen, jax_mods, plt
from tests.test_torch_reports_beams import (_pdfs_equal, _plotly_equal, _quaac_equal,
                                            _same_drawing, _same_error)

# the fixtures above are imported to be used here
__all__ = ["_few_threads", "frozen", "jax_mods", "plt"]

NAMES = ["QC3", "FC2", "Mammo"]


@pytest.fixture(scope="module")
def planar(tmp_path_factory, jax_mods):
    """{name: SimpleNamespace(port=, jax=)}, each analysed once."""
    import pylinac_tpu.planar_imaging as jp

    d = tmp_path_factory.mktemp("reports_planar")
    qc3 = draw_qc3(str(d / "qc3.dcm"), sim=AS500Image(sid=1000))
    fc2 = str(d / "fc2.dcm")
    generate_lightrad(AS1000Image(sid=1000), file_out=fc2, field_size_mm=(100, 100),
                      bb_size_mm=4, bb_positions=((-40, -40), (-40, 40), (40, -40), (40, 40)),
                      final_layers=[GaussianFilterLayer(sigma_mm=1)])
    mammo = draw_mammo(str(d / "mammo.dcm"), dpmm=3.0, shape=(560, 420))
    out = {}
    for key, name, path, analyze in (("QC3", "StandardImagingQC3", qc3, {}),
                                     ("FC2", "StandardImagingFC2", fc2, {}),
                                     ("Mammo", "ACRDigitalMammography", mammo, MAMMO_ARGS)):
        pair = SimpleNamespace(port=getattr(tp, name)(path), jax=getattr(jp, name)(path))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pair.port.analyze(device="cpu", **analyze)
            pair.jax.analyze(**analyze)
        assert json.dumps(_data(pair.port)) == json.dumps(_data(pair.jax))
        out[key] = pair
    return out


def _plotly_names(obj):
    names = ["Image"]
    if obj.low_contrast_rois:
        names.append("Low Contrast")
    if obj.high_contrast_rois:
        names.append("High Contrast")
    return names


@pytest.mark.parametrize("name", NAMES)
def test_pdf_bytes_equal(planar, frozen, tmp_path, name):
    _pdfs_equal(planar[name], tmp_path, notes="monthly", metadata={"Author": "QA"})


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("name", NAMES)
def test_quaac_text_equal(planar, frozen, tmp_path, name, fmt):
    _quaac_equal(planar[name], tmp_path, fmt)


@pytest.mark.parametrize("name,kwargs", [
    ("QC3", {}), ("QC3", {"show_colorbar": False, "show_legend": False}),
    ("Mammo", {"show_legend": False})])
def test_plotly_equal(planar, name, kwargs):
    _plotly_equal(planar[name], _plotly_names(planar[name].jax), **kwargs)


@pytest.mark.parametrize("kwargs", [
    {}, {"split_plots": True}, {"low_contrast": False, "high_contrast": False},
    {"image": False, "show_roi_labels": True},
], ids=["all", "split", "image", "graphs"])
def test_matplotlib_figures_match(planar, plt, kwargs):
    _same_drawing(plt, planar["QC3"], lambda o: o.plot_analyzed_image(show=False, **kwargs))


@pytest.mark.parametrize("name", ["FC2", "Mammo"])
def test_family_figures_match(planar, plt, name):
    _same_drawing(plt, planar[name], lambda o: o.plot_analyzed_image(show=False))


def test_fc2_plotly_raises_as_in_jax(planar):
    """The FC-2 family inherits the base class's plotly figure, whose centre
    marker (``planar_imaging.py:660``) searches for the phantom by a size,
    ``phantom_bbox_size_mm2`` (``:292``), that the family has not."""
    err = _same_error(planar["FC2"], lambda o: o.plotly_analyzed_images(show=False))
    assert isinstance(err, AttributeError) and "phantom_bbox_size_mm2" in str(err)


@pytest.mark.parametrize("name", ["QC3", "FC2"])
def test_saved_images_match(planar, plt, tmp_path, name):
    """The split plots to streams and to files, and the whole figure to one
    file: the same names and the same PNGs."""
    pair = planar[name]
    split = {} if name == "FC2" else {"split_plots": True}
    got = {k: v.getvalue() for k, v in
           pair.port.save_analyzed_image(to_streams=True, **split).items()}
    want = {k: v.getvalue() for k, v in
            pair.jax.save_analyzed_image(to_streams=True, **split).items()}
    assert got == want and got
    for pkg, obj in (("port", pair.port), ("jax", pair.jax)):
        obj.save_analyzed_image(str(tmp_path / f"{pkg}.png"))
        if split:
            names = obj.save_analyzed_image(str(tmp_path / f"{pkg}_s.png"), **split)
            assert [n.rsplit("/", 1)[-1] for n in names] == [
                f"{pkg}_s_{k}.png" for k in want]
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    plt.close("all")


def test_save_without_a_target_raises_as_in_jax(planar, plt):
    for name in ("QC3", "FC2"):
        err = _same_error(planar[name], lambda o: o.save_analyzed_image())
        assert isinstance(err, ValueError)
    plt.close("all")


@pytest.mark.parametrize("call", [
    lambda o: o._quaac_datapoints(),
    lambda o: o.to_quaac(io.StringIO()),
], ids=["datapoints", "quaac"])
def test_reports_before_analysis_raise_as_in_jax(planar, plt, call):
    """The QuAAC of an unanalysed phantom. (Its plots and PDF search for the
    phantom first, which the port does on the default device, CUDA, where
    JAX fails on the missing SSD.)"""
    import pylinac_tpu.planar_imaging as jp

    path = planar["QC3"].port.image.path
    pair = SimpleNamespace(port=tp.StandardImagingQC3(path), jax=jp.StandardImagingQC3(path))
    _same_error(pair, call)
    plt.close("all")
