"""The port's long tail of planar phantom classes against the JAX
package's, on the CPU: the 13 phantoms of
``tests/models/test_planar_longtail.py`` by that file's recipe (each
class's own ROI tables drawn on an AS1000 frame, analysed with its
overrides and its texture heuristics patched out as there), and the four
FC-2 variants (IMT L-Rad, Doselab RLf, PTW Iso-Align, SNC FSQA) on
generated light/rad frames with automatic detection. Both packages read
the same DICOM files; ``results_data()`` without date and version, the
results text and the warnings are equal (every float to the bit, where
the bar is mm 0.01, % 0.1, contrast and rMTF 0.1 %). The drawings come
from the JAX test file's own drawing function, imported; the ``cuda`` test draws
its frame with the port's generator.

Ten of the long-tail classes are also analysed as a user would, with no
override and nothing patched: each class's own ``_phantom_center_calc``,
``_phantom_angle_calc`` and ``_phantom_radius_calc`` (Las Vegas's
preprocessing and direction check, PTW's, IBA's and Leeds's inversion
checks, Leeds's rotation from its circle profile) on the same drawings,
held to JAX at the bar (mm 0.01, % 0.1, contrast and rMTF 0.1 %, px 1e-3,
integers and strings exact) or to JAX's exception, type and message.
Doselab MC2 is held in ``tests/test_torch_planar_mc2.py``: its
``phantom_angle`` runs its Hough angle search 14 times an analysis, so
JAX's results are frozen there.
The reports of two of those analyses (Las Vegas's own contrast graph, the
Leeds TOR's circle outline) are held to JAX's as
``tests/test_torch_reports_planar.py`` holds the others'."""

import json
import warnings
from types import SimpleNamespace

import pytest
import torch

import pylinac_tpu_torch.planar_imaging as tp
from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer
from pylinac_tpu_torch.imggen.simulators import AS1000Image
from pylinac_tpu_torch.imggen.utils import generate_lightrad

from tests.test_torch_planar import _data, card_agrees
from tests.test_torch_reports import frozen, jax_mods, plt
from tests.test_torch_reports_beams import (_pdfs_equal, _plotly_equal, _quaac_equal,
                                            _same_drawing)

# the fixtures above are imported to be used here
__all__ = ["frozen", "jax_mods", "plt"]

# the classes analysed with automatic detection (Doselab MC2 in its own file)
AUTO = ["LasVegas", "ElektaLasVegas", "PTWEPIDQC", "SNCMV", "SNCMV12510", "LeedsTOR",
        "LeedsTORBlue", "IBAPrimusA", "StandardImagingQCkV", "SNCkV"]
_AUTO = {}

FC2_VARIANTS = [
    ("IMTLRad", ((0, 0),), 3),
    ("DoselabRLf", ((-45, -17), (17, -45), (-17, 45), (45, 17)), 4),
    ("IsoAlign", ((0, 0), (-25, 0), (25, 0), (0, -25), (0, 25)), 4),
    ("SNCFSQA", ((-40, 40),), 4),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lt():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tests.models.test_planar_longtail as lt

    return lt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _analyse(cls, path, patch, device, **analyze):
    saved = {a: cls.__dict__.get(a) for a in patch}
    for a in patch:
        setattr(cls, a, lambda self: None)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            obj = cls(path)
            h, w = obj.image.shape
            kw = {k: (v(w, h) if callable(v) else v) for k, v in analyze.items()}
            obj.analyze(**kw, **({} if device is None else {"device": device}))
            data, text = _data(obj), obj.results()
    finally:
        for a in patch:
            if saved[a] is None:
                delattr(cls, a)
            else:
                setattr(cls, a, saved[a])
    return obj, data, text, [(str(w.message), w.category.__name__) for w in caught]


@pytest.mark.parametrize("index", range(13))
def test_longtail_class_matches_jax(lt, tmp_path, index):
    spec = lt.SPECS[index]
    name = spec.cls.__name__
    path = str(tmp_path / f"{name}.dcm")
    expected, amps, R = lt._build_phantom_image(spec, path)
    analyze = dict(ssd=1000, angle_override=spec.angle,
                   center_override=lambda w, h: (w / 2, h / 2), size_override=R)
    j, jd, jtext, jwarn = _analyse(spec.cls, path, spec.patch, None, **analyze)
    t, td, ttext, twarn = _analyse(getattr(tp, name), path, spec.patch, "cpu", **analyze)
    assert json.dumps(td) == json.dumps(jd)
    assert ttext == jtext and twarn == jwarn
    assert td["analysis_type"] == spec.cls.common_name
    assert len(t.low_contrast_rois) == len(expected)
    if amps:
        assert list(t.mtf.norm_mtfs.values()) == list(j.mtf.norm_mtfs.values())


@pytest.mark.parametrize("name,bbs,bb_size", FC2_VARIANTS)
def test_fc2_variant_matches_jax(lt, tmp_path, name, bbs, bb_size):
    import pylinac_tpu.planar_imaging as jp

    path = str(tmp_path / "lr.dcm")
    generate_lightrad(AS1000Image(sid=1000), file_out=path, field_size_mm=(100, 100),
                      bb_size_mm=bb_size, bb_positions=bbs,
                      final_layers=[GaussianFilterLayer(sigma_mm=1)])
    j, jd, jtext, jwarn = _analyse(getattr(jp, name), path, (), None)
    t, td, ttext, twarn = _analyse(getattr(tp, name), path, (), "cpu")
    assert json.dumps(td) == json.dumps(jd)
    assert ttext == jtext and twarn == jwarn
    assert td["field_size_x_mm"] == pytest.approx(100, abs=1.5)
    assert abs(td["field_bb_offset_x_mm"]) < 1.0 and abs(td["field_bb_offset_y_mm"]) < 1.0
    assert len(t.bb_centers) >= len(bbs)
    assert {k: (p.x, p.y) for k, p in t.bb_centers.items()} == \
        {k: (p.x, p.y) for k, p in j.bb_centers.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,bbs,bb_size", FC2_VARIANTS[1:3])
def test_fc2_variant_card_matches_cpu(cuda, tmp_path, name, bbs, bb_size):
    path = str(tmp_path / "lr.dcm")
    generate_lightrad(AS1000Image(sid=1000), file_out=path, field_size_mm=(100, 100),
                      bb_size_mm=bb_size, bb_positions=bbs,
                      final_layers=[GaussianFilterLayer(sigma_mm=1)])
    _, cd, ctext, cwarn = _analyse(getattr(tp, name), path, (), "cuda")
    _, hd, htext, hwarn = _analyse(getattr(tp, name), path, (), "cpu")
    card_agrees(cd, hd)
    assert cwarn == hwarn


def _auto(lt, tmp_path_factory, name):
    """(JAX, port) of ``name`` on its long-tail drawing, analysed with no
    override and nothing patched, once a module: each the ``_analyse``
    tuple or the exception raised."""
    if name not in _AUTO:
        spec = next(s for s in lt.SPECS if s.cls.__name__ == name)
        path = str(tmp_path_factory.mktemp("auto") / f"{name}.dcm")
        lt._build_phantom_image(spec, path)
        out = []
        for cls, device in ((spec.cls, None), (getattr(tp, name), "cpu")):
            try:
                out.append(_analyse(cls, path, (), device))
            except Exception as e:  # held to JAX's type and message below
                out.append(e)
        _AUTO[name] = out
    return _AUTO[name]


@pytest.mark.parametrize("name", AUTO)
def test_longtail_automatic_detection_matches_jax(lt, tmp_path_factory, name):
    """The phantom found as a user's analysis finds it: the centre, angle
    and radius searches, then every ROI, at the bar; the text and the
    warnings equal. Where JAX raises, the port raises the same type with the
    same message."""
    ref, got = _auto(lt, tmp_path_factory, name)
    if isinstance(ref, Exception):
        assert type(got).__name__ == type(ref).__name__, (got, ref)
        assert str(got) == str(ref)
        return
    assert not isinstance(got, Exception), got
    (j, jd, jtext, jwarn), (t, td, ttext, twarn) = ref, got
    card_agrees(td, jd)
    assert ttext == jtext and twarn == jwarn
    for attr in ("phantom_angle", "phantom_radius"):
        assert getattr(t, attr) == pytest.approx(getattr(j, attr), abs=1e-3), attr
    assert (t.phantom_center.x, t.phantom_center.y) == pytest.approx(
        (j.phantom_center.x, j.phantom_center.y), abs=1e-3)
    assert td["analysis_type"] == j.common_name


def _reported(lt, tmp_path_factory, name) -> SimpleNamespace:
    ref, got = _auto(lt, tmp_path_factory, name)
    return SimpleNamespace(port=got[0], jax=ref[0])


@pytest.mark.parametrize("report", ["pdf", "quaac", "plotly", "plot"])
@pytest.mark.parametrize("name", ["LasVegas", "LeedsTOR"])
def test_longtail_reports_match_jax(lt, tmp_path_factory, frozen, plt, tmp_path, name, report):
    """The reports of the analyses above: the PDF's bytes, the QuAAC text,
    the plotly JSON and the figures' signatures (the contrast graphs, and
    the outline: Las Vegas's rectangle, the Leeds TOR's circle)."""
    pair = _reported(lt, tmp_path_factory, name)
    if report == "pdf":
        _pdfs_equal(pair, tmp_path, notes="long tail")
    elif report == "quaac":
        _quaac_equal(pair, tmp_path, "yaml")
    elif report == "plotly":
        names = ["Image", "Low Contrast"] + (["High Contrast"] if pair.jax.high_contrast_rois
                                             else [])
        _plotly_equal(pair, names, show_colorbar=False)
    else:
        _same_drawing(plt, pair, lambda o: o.plot_analyzed_image(show=False))
