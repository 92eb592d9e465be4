"""The port's FieldAnalysis classes against the JAX package's, on the CPU.

Inputs: the AS1000 files of ``tests/models/test_field_analysis_batch.py``
(100 x 100 and 120 x 80 mm flattened fields, seeded noise), an FFF field
and an asymmetric one (offset CAX and a slope, so that no symmetry is a
mirror tie), written once by the port's image generator and read by both
packages. Tolerances (the repo's parity bar, BASELINE.json):

- every mm field within 0.01 mm, every percentage (protocol results,
  slopes, penumbra gradients) within 0.1, every index within 1e-3 px; the
  sign of every symmetry equal; strings, keys and key order equal;
- the FFF "top" within 0.01 mm of the JAX batch and within 0.15 mm of the
  JAX single-image path (ROADMAP section 3), where the JAX package's own
  test holds flat fields at 2.0 mm and symmetry by magnitude only
  (``tests/models/test_field_analysis_batch.py:68-91``). On these files
  the flat fields' "tops" also agree within 1e-3 px: the port rounds its
  grid and interpolations as XLA's fused multiply-adds do;
- the central-ROI statistics: host numpy in both packages, equal.

The card test (marker ``cuda``) holds the batch on the card to the CPU run
at the same bars and counts the filter's ``median3x3`` launch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_field_analysis.py
"""

import json

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.core.exceptions import NotAnalyzed
from pylinac_tpu_torch.field_analysis import (Device, DeviceFieldAnalysis, FieldAnalysis,
                                              FieldAnalysisBatch, Protocol, analyze_field_batch)
from pylinac_tpu_torch.imggen import layers as tlayers
from pylinac_tpu_torch.imggen.simulators import AS1000Image
from pylinac_tpu_torch.ops import median

MM, PCT, PX = 0.01, 0.1, 1e-3
FFF_SINGLE_TOP_MM = 0.15


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jfa():
    import pylinac_tpu.field_analysis as jfa

    return jfa


def _write(path, layers):
    sim = AS1000Image(sid=1000)
    for layer in layers:
        sim.add_layer(layer)
    sim.generate_dicom(str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path}: two seeded flattened fields, an FFF field and an
    asymmetric field."""
    tmp = tmp_path_factory.mktemp("torch_fa")
    out = {}
    for i, size in enumerate(((100, 100), (120, 80))):
        out[f"field{i}"] = _write(tmp / f"field{i}.dcm", [
            tlayers.FilteredFieldLayer(field_size_mm=size), tlayers.GaussianFilterLayer(sigma_mm=1),
            tlayers.RandomNoiseLayer(sigma=0.002, seed=1234 + i)])
    out["fff"] = _write(tmp / "fff.dcm", [tlayers.FilterFreeFieldLayer(field_size_mm=(100, 100)),
                                          tlayers.GaussianFilterLayer(sigma_mm=1)])
    out["asymmetric"] = _write(tmp / "asym.dcm", [
        tlayers.FilteredFieldLayer(field_size_mm=(110, 90), cax_offset_mm=(3, -2)),
        tlayers.GaussianFilterLayer(sigma_mm=1), tlayers.SlopeLayer(0.05, -0.03)])
    return out


def _tol(path: str) -> float:
    if "protocol_results" in path or "percent" in path:
        return PCT
    if "index" in path:
        return PX
    if "central_roi" in path:
        return 0.0
    return MM


def _compare(got: dict, want: dict, path: str = "") -> float:
    """Two JSON-loaded results: keys in order, strings exact, numbers
    within their bar, symmetry signs equal. Returns the largest mm gap."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        return max([_compare(got[k], want[k], f"{path}/{k}") for k in want
                    if k not in ("date_of_analysis", "pylinac_version")], default=0.0)
    if isinstance(want, list):
        assert len(got) == len(want), path
        return max([_compare(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want))],
                   default=0.0)
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        assert abs(got - want) <= _tol(path), f"{path}: {got} vs {want}"
        if "symmetry" in path:
            assert np.sign(got) == np.sign(want), f"{path}: {got} vs {want}"
        return abs(got - want) if path.endswith("_mm") else 0.0
    assert got == want, path
    return 0.0


def _loaded(result) -> dict:
    return json.loads(result.model_dump_json())


@pytest.mark.parametrize("name,make", [
    ("filtered", lambda L: [L.FilteredFieldLayer(field_size_mm=(110, 90), cax_offset_mm=(3, -2))]),
    ("fff", lambda L: [L.FilterFreeFieldLayer(field_size_mm=(150, 150))]),
    ("slope", lambda L: [L.FilteredFieldLayer(field_size_mm=(100, 100)), L.SlopeLayer(0.05, -0.03)]),
    ("noise", lambda L: [L.FilteredFieldLayer(field_size_mm=(100, 100)),
                         L.RandomNoiseLayer(sigma=0.002, seed=7)]),
])
def test_layers_match_jax(name, make):
    from pylinac_tpu.imggen import layers as jlayers
    from pylinac_tpu.imggen.simulators import AS1000Image as JAS1000Image

    images = []
    for sim, L in ((AS1000Image(sid=1000), tlayers), (JAS1000Image(sid=1000), jlayers)):
        for layer in make(L):
            sim.add_layer(layer)
        images.append(sim.image)
    assert images[0].dtype == images[1].dtype == np.uint16
    np.testing.assert_array_equal(images[0], images[1])


# each edge once, each protocol once (every edge x protocol pair is held to
# JAX profile by profile in test_torch_field_pipeline.py), and the filter
BATCH_CASES = [("FWHM", "VARIAN", None), ("Inflection Derivative", "ELEKTA", None),
               ("Inflection Hill", "SIEMENS", None), ("Inflection Derivative", "VARIAN", 3)]
@pytest.fixture(scope="module")
def batches(jfa, files):
    """(edge, protocol, filter) -> (the port's analysed batch, JAX's
    results) of the four files, each computed once."""
    done = {}

    def get(edge, protocol, filt):
        if (edge, protocol, filt) not in done:
            paths = list(files.values())
            want = jfa.analyze_field_batch(paths, filter=filt, edge_detection_method=edge,
                                           protocol=getattr(jfa.Protocol, protocol))
            batch = FieldAnalysisBatch(paths, filter=filt, device="cpu")
            batch.analyze(protocol=getattr(Protocol, protocol), edge_detection_method=edge)
            done[edge, protocol, filt] = batch, want
        return done[edge, protocol, filt]

    return get


@pytest.mark.parametrize("edge,protocol,filt", BATCH_CASES)
def test_batch_matches_jax(batches, edge, protocol, filt):
    batch, want = batches(edge, protocol, filt)
    got = batch.results_data()
    for g, w in zip(got, want):
        _compare(_loaded(g), json.loads(w.model_dump_json()))
    assert [list(d) for d in batch.results_data(as_dict=True)] == [list(r.model_dump())
                                                                    for r in got]
    # the asymmetric file's symmetries are far above a mirror tie's
    # magnitude (about 6e-4 on a symmetric field), so their signs are tested
    assert min(abs(v) for k, v in got[3].protocol_results.items() if "symmetry" in k) > 0.01


@pytest.mark.parametrize("edge,protocol", [("Inflection Derivative", "ELEKTA"),
                                           ("Inflection Hill", "SIEMENS")])
def test_fff_top_against_both_jax_paths(jfa, files, batches, edge, protocol):
    batch, want = batches(edge, protocol, None)
    fff = list(files).index("fff")
    got, want_batch = batch.results_data()[fff], want[fff]
    single = jfa.FieldAnalysis(files["fff"])
    single.analyze(is_FFF=True, edge_detection_method=edge)
    want_single = single.results_data()
    for name in ("top_vertical_distance_from_cax_mm", "top_horizontal_distance_from_cax_mm",
                 "top_vertical_distance_from_beam_center_mm",
                 "top_horizontal_distance_from_beam_center_mm"):
        assert abs(getattr(got, name) - getattr(want_batch, name)) <= MM, name
        assert abs(getattr(got, name) - getattr(want_single, name)) <= FFF_SINGLE_TOP_MM, name
    for g, w in zip(got.top_position_index_x_y, want_batch.top_position_index_x_y):
        assert abs(g - w) <= PX
    assert abs(got.top_vertical_distance_from_cax_mm) < 1.0  # a centred FFF field
    (again,) = analyze_field_batch([files["fff"]], device="cpu", is_FFF=True,
                                   edge_detection_method=edge)
    assert again.top_position_index_x_y == got.top_position_index_x_y


@pytest.mark.parametrize("interpolation,filt", [("Linear", None), ("Spline", None),
                                                ("Linear", 3), ("Spline", 3)])
def test_single_matches_jax(jfa, files, interpolation, filt):
    kw = dict(edge_detection_method="Inflection Derivative", interpolation=interpolation)
    want = jfa.FieldAnalysis(files["field0"], filter=filt)
    want.analyze(**kw)
    got = FieldAnalysis(files["field0"], filter=filt, device="cpu")
    got.analyze(**kw)
    _compare(got.results_data(as_dict=True), want.results_data(as_dict=True))
    assert got.results() == want.results()


@pytest.mark.parametrize("edge", ["FWHM", "Inflection Hill"])
def test_single_matches_jax_asymmetric(jfa, files, edge):
    want = jfa.FieldAnalysis(files["asymmetric"])
    want.analyze(protocol=jfa.Protocol.ELEKTA, edge_detection_method=edge)
    got = FieldAnalysis(files["asymmetric"])
    got.analyze(protocol=Protocol.ELEKTA, edge_detection_method=edge)
    _compare(got.results_data(as_dict=True), want.results_data(as_dict=True))


def _write_prs(path) -> str:
    """A minimal SNC Profiler export, as ``tests/core/test_primitives.py``
    writes one: 109 tab-separated rows, field-shaped detector banks."""
    lines = [f"row{i}\tfiller" for i in range(109)]
    lines[20] = "Gain\t2.0"
    pad = ["x"] * 5
    lines[106] = "\t".join(pad + [f"det{i}" for i in range(254)])
    lines[107] = "\t".join(pad + ["1.0"] * 254)
    lines[108] = "\t".join(pad + ["2.0"] * 254)

    def bank(n):
        x = np.arange(n)
        prof = (3.0 + 100.0 / (1 + np.exp(-(x - n * 0.25))) - 100.0 / (1 + np.exp(-(x - n * 0.75)))
                + 2.0 * np.exp(-((x - n / 2) / (n / 5)) ** 2))
        return [f"{v:.3f}" for v in prof]

    lines.append("\t".join(["d", "e", "3.0", "f", "g"] + bank(63) + bank(65) + bank(63) + bank(63)))
    path.write_text("\n".join(lines), encoding="cp437")
    return str(path)


@pytest.mark.parametrize("edge", ["Inflection Hill", "Inflection Derivative", "FWHM"])
def test_device_field_analysis_matches_jax(jfa, tmp_path, edge):
    prs = _write_prs(tmp_path / "profiler.prs")
    want = jfa.DeviceFieldAnalysis(prs, device=jfa.Device.PROFILER)
    want.analyze(edge_detection_method=edge)
    got = DeviceFieldAnalysis(prs, device=Device.PROFILER)
    got.analyze(edge_detection_method=edge)
    _compare(got.results_data(as_dict=True), want.results_data(as_dict=True))
    assert got.results() == want.results()


def test_result_fields_match_the_jax_models(jfa, files):
    """The dataclasses have the pydantic models' fields, in order."""
    from pylinac_tpu_torch.field_analysis import DeviceResult, FieldResult

    for ours, theirs in ((FieldResult, jfa.FieldResult), (DeviceResult, jfa.DeviceResult)):
        assert [f.name for f in __import__("dataclasses").fields(ours)] == list(
            theirs.model_fields)
    batch = FieldAnalysisBatch([files["field0"]], device="cpu")
    batch.analyze()
    assert list(batch.results_data(as_dict=True)[0]) == list(jfa.FieldResult.model_fields)
    assert json.loads(batch.results_data(as_json=True)[0])["protocol"] == "VARIAN"


def test_errors(files):
    single = FieldAnalysis(files["field0"])
    with pytest.raises(NotAnalyzed):
        single.results()
    with pytest.raises(NotAnalyzed):
        single.results_data()
    batch = FieldAnalysisBatch([files["field0"]], device="cpu")
    with pytest.raises(NotAnalyzed):
        batch.results_data()
    with pytest.raises(ValueError, match="LINEAR"):
        batch.analyze(interpolation="Spline")
    with pytest.raises(TypeError, match="mesh"):
        batch.analyze(mesh=object())
    with pytest.raises(ValueError, match="No images"):
        FieldAnalysisBatch([])
    small = np.zeros((64, 64), np.uint16)
    small[16:48, 16:48] = 1000
    mixed = FieldAnalysisBatch([files["field0"], small], device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        mixed.analyze()
    from pylinac_tpu_torch.core.image import ArrayImage

    two = [ArrayImage(small, dpi=50.8), ArrayImage(small, dpi=25.4)]
    with pytest.raises(ValueError, match="dpmm"):
        FieldAnalysisBatch(two, device="cpu").analyze()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FieldAnalysisBatch([files["field0"]]).analyze()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FieldAnalysis(files["field0"], filter=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FieldAnalysisBatch([files["field0"]], filter=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["Inflection Derivative", "FWHM", "Inflection Hill"])
def test_batch_on_card_matches_cpu(cuda, files, edge):
    paths = list(files.values())
    before = median.median3x3.launches
    card = FieldAnalysisBatch(paths, filter=3, device=cuda)
    assert median.median3x3.launches == before + 1   # one launch on the stacked images
    card.analyze(edge_detection_method=edge)
    cpu = FieldAnalysisBatch(paths, filter=3, device="cpu")
    cpu.analyze(edge_detection_method=edge)
    for g, w in zip(card.results_data(), cpu.results_data()):
        _compare(_loaded(g), _loaded(w))
