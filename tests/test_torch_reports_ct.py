"""The port's reports of the CatPhan engine's siblings against the JAX
package's, on the CPU: ``QuartDVT``, ``ACRCT``, ``ACRMRILarge``,
``TomoCheese``, ``CIRS062M`` and ``GEHeliosCTDaily``.

The inputs are ones that each class's own ``tests/test_torch_<x>.py`` holds
equal to JAX, the cheapest of them: the 60-slice Quart scan, the 32-slice
ACR CT, the 11 ACR MRI slices with the sagittal localiser, the 12-slice
TomoCheese rolled 2 degrees, the 20-slice CIRS 062M of
``test_torch_cheese.draw_cirs062m`` and the 40-slice Helios scan. JAX runs
with ``PYLINAC_TPU_CCL=xla``, as ``tests/test_torch_reports.py``; each
package analyses each series once a module, and the cheese phantoms with
their densities (``roi_config``), which the density curve draws.

The checks are those of ``tests/test_torch_reports.py``, whose helpers this
file imports. The PDFs of these classes embed matplotlib's PNGs of the
modules, so their bytes equal JAX's only where the figures render alike.
Where the JAX method raises, the port raises the same exception type.
"""

from types import SimpleNamespace

import pytest

from pylinac_tpu_torch import ACRCT, CIRS062M, ACRMRILarge, GEHeliosCTDaily, QuartDVT, TomoCheese
from pylinac_tpu_torch.imggen.ct import generate_acr_ct, generate_helios, generate_quart
from pylinac_tpu_torch.imggen.ct import generate_tomocheese
from pylinac_tpu_torch.imggen.mri import generate_acr_mri
from tests.test_torch_cheese import DENSITIES, draw_cirs062m
from tests.test_torch_reports import (_assert_close_tree, _assert_same_figure, _few_threads,
                                      _figs_json, frozen, jax_mods, plt)
from tests.test_torch_reports_beams import _same_drawing, _same_error

# the fixtures above are imported to be used here
__all__ = ["_few_threads", "frozen", "jax_mods", "plt"]

NAMES = ["Quart", "ACRCT", "ACRMRI", "TomoCheese", "CIRS062M", "Helios"]
CIRS_DENSITIES = {"1": {"density": 1.0}, "9": {"density": 1.9}}


@pytest.fixture(scope="module")
def ct(tmp_path_factory, jax_mods):
    """{name: (port, JAX)} of each class, analysed once."""
    from pylinac_tpu import acr, cheese, helios, quart

    specs = {
        "Quart": (QuartDVT, quart.QuartDVT, generate_quart, {}),
        "ACRCT": (ACRCT, acr.ACRCT, generate_acr_ct, {}),
        "ACRMRI": (ACRMRILarge, acr.ACRMRILarge, generate_acr_mri, {}),
        "TomoCheese": (TomoCheese, cheese.TomoCheese,
                       lambda d: generate_tomocheese(d, roll_deg=2.0, num_slices=12),
                       {"roi_config": DENSITIES}),
        "CIRS062M": (CIRS062M, cheese.CIRS062M, draw_cirs062m, {"roi_config": CIRS_DENSITIES}),
        "Helios": (GEHeliosCTDaily, helios.GEHeliosCTDaily, generate_helios, {}),
    }
    out = {}
    for name, (port_cls, jax_cls, make, analyze) in specs.items():
        d = tmp_path_factory.mktemp(f"reports_{name}")
        make(d)
        port = port_cls(str(d))
        port.analyze(device="cpu", **analyze)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PYLINAC_TPU_CCL", "xla")
            ref = jax_cls(str(d))
            ref.analyze(**analyze)
        out[name] = SimpleNamespace(port=port, jax=ref)
    return out


# ---------------------------------------------------------------------------
# PDF and QuAAC
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_pdf_bytes_equal(ct, frozen, plt, tmp_path, name):
    """With notes, which move no page of module images."""
    pair = ct[name]
    kw = dict(notes="CT sim, weekly", metadata={"Author": "QA"})
    pair.port.publish_pdf(tmp_path / "port.pdf", **kw)
    pair.jax.publish_pdf(tmp_path / "jax.pdf", **kw)
    got, want = (tmp_path / "port.pdf").read_bytes(), (tmp_path / "jax.pdf").read_bytes()
    assert got.startswith(b"%PDF") and got == want
    plt.close("all")


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("name", ["ACRCT", "TomoCheese", "CIRS062M", "Helios"])
def test_quaac_text_equal(ct, frozen, tmp_path, name, fmt):
    pair = ct[name]
    kw = dict(performer={"name": "QA"}, primary_equipment={"name": "CT1"}, format=fmt)
    pair.port.to_quaac(tmp_path / "port", **kw)
    pair.jax.to_quaac(tmp_path / "jax", **kw)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()


@pytest.mark.parametrize("name", ["Quart", "ACRMRI"])
def test_quaac_raises_as_in_jax(ct, tmp_path, name):
    """Neither class has datapoints of its own: ``CatPhanBase``'s read a
    ``ctp404``, which they have not."""
    err = _same_error(ct[name], lambda c: c.to_quaac(tmp_path / f"{id(c)}.json"))
    assert isinstance(err, AttributeError) and "ctp404" in str(err)


# ---------------------------------------------------------------------------
# plotly: CatPhanBase's figures of the analysed modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [{}, {"show_colorbar": False, "show_legend": False}])
@pytest.mark.parametrize("name", NAMES)
def test_plotly_equal(ct, name, kwargs):
    got = _figs_json(ct[name].port.plotly_analyzed_images(show=False, **kwargs))
    want = _figs_json(ct[name].jax.plotly_analyzed_images(show=False, **kwargs))
    assert list(got) == list(want) and got
    _assert_close_tree(got, want)


# ---------------------------------------------------------------------------
# matplotlib
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_analyzed_image_matches(ct, plt, name):
    _same_drawing(plt, ct[name], lambda c: c.plot_analyzed_image(show=False))


@pytest.mark.parametrize("name", ["Quart", "ACRCT", "ACRMRI", "Helios"])
def test_module_images_match(ct, plt, name):
    figs = [ct[name].port.plot_images(show=False), ct[name].jax.plot_images(show=False)]
    assert list(figs[0]) == list(figs[1])
    for key in figs[1]:
        _assert_same_figure(figs[0][key], figs[1][key])
    plt.close("all")


@pytest.mark.parametrize("name", NAMES)
def test_side_view_matches(ct, plt, name):
    def draw(c):
        _, ax = plt.subplots()
        c.plot_side_view(ax)

    _same_drawing(plt, ct[name], draw)


@pytest.mark.parametrize("name", ["Quart", "ACRCT", "ACRMRI", "Helios"])
def test_saved_images_match(ct, plt, tmp_path, name):
    pair = ct[name]
    for pkg, obj in (("port", pair.port), ("jax", pair.jax)):
        (tmp_path / pkg).mkdir()
        paths = obj.save_images(directory=tmp_path / pkg)
        assert all(p.is_absolute() for p in paths)
    got = {p.name: p.read_bytes() for p in (tmp_path / "port").iterdir()}
    want = {p.name: p.read_bytes() for p in (tmp_path / "jax").iterdir()}
    assert got == want and got
    streams = [pair.port.save_images(to_stream=True), pair.jax.save_images(to_stream=True)]
    if name == "Quart":  # a dict by name
        assert list(streams[0]) == list(streams[1])
        streams = [list(s.values()) for s in streams]
    assert [s.getvalue() for s in streams[0]] == [s.getvalue() for s in streams[1]]
    plt.close("all")


@pytest.mark.parametrize("name", ["ACRCT", "TomoCheese"])
def test_saved_analyzed_image_matches(ct, plt, tmp_path, name):
    ct[name].port.save_analyzed_image(tmp_path / "port.png")
    ct[name].jax.save_analyzed_image(tmp_path / "jax.png")
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    plt.close("all")


@pytest.mark.parametrize("name", ["TomoCheese", "CIRS062M"])
def test_density_curve_matches(ct, plt, name):
    _same_drawing(plt, ct[name], lambda c: c.plot_density_curve(show=False))


def test_density_curve_without_densities_raises(ct, plt):
    pair = ct["TomoCheese"]
    kept = pair.port.roi_config, pair.jax.roi_config
    pair.port.roi_config = pair.jax.roi_config = None
    try:
        err = _same_error(pair, lambda c: c.plot_density_curve(show=False))
    finally:
        pair.port.roi_config, pair.jax.roi_config = kept
    assert isinstance(err, ValueError)
    plt.close("all")


@pytest.mark.parametrize("name", NAMES)
def test_subimage_raises_as_in_jax(ct, name):
    err = _same_error(ct[name], lambda c: c.plot_analyzed_subimage())
    assert isinstance(err, NotImplementedError)
    if name not in ("Quart",):
        _same_error(ct[name], lambda c: c.save_analyzed_subimage())
