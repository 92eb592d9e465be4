"""The port's Quart DVT analysis against the JAX package's, on the CPU.

Both packages read the same series, drawn by the port's
``imggen.ct.generate_quart`` (bit-equal to the JAX generator's, which
``test_generator_matches_jax`` checks): the 60-slice scan of
``tests/models/test_quart_dlg.py`` and its 40-slice copy rolled 2 degrees.
``results_data()`` is compared as the JSON-compatible dict without its
date and version: strings, booleans, keys and warnings (message, category)
exactly, and every float to the bit. On the CPU the port's localisation,
regions and 3x3 median are the plain twins and every float comes out
bit-equal to JAX's (the parity bar is 0.01 mm and 0.1 %). Every argument of
``analyze`` gets a non-default case. The ``cuda`` tests run the same scans
on a card, where the localisation and the roll slice launch ``ccl.cu`` and
the geometry module ``median3x3.cu``, against the CPU run:
``python -m pytest --noconftest -m cuda tests/test_torch_quart.py``.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import HypersightQuartDVT, QuartDVT
from pylinac_tpu_torch.imggen.ct import generate_quart
from pylinac_tpu_torch.ops import ccl, median


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jquart():
    import pylinac_tpu.quart as jquart

    return jquart


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    plain = tmp_path_factory.mktemp("torch_quart")
    rolled = tmp_path_factory.mktemp("torch_quart_rolled")
    generate_quart(plain)
    generate_quart(rolled, roll_deg=2.0, num_slices=40)
    return {"plain": str(plain), "rolled": str(rolled)}


def _data(obj) -> dict:
    d = obj.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return d


def _run(cls, folder, device=None, **analyze):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = cls(folderpath=folder)
        if device is None:
            obj.analyze(**analyze)
        else:
            obj.analyze(device=device, **analyze)
    return obj, [(str(w.message), w.category.__name__) for w in caught]


def _assert_same(jquart, name, folder, **analyze):
    j, j_raised = _run(getattr(jquart, name), folder, **analyze)
    t, t_raised = _run(globals()[name], folder, device="cpu", **analyze)
    jd, td = _data(j), _data(t)
    assert json.dumps(td) == json.dumps(jd)
    assert t_raised == j_raised
    assert t.results() == j.results()
    return t, td


def test_generator_matches_jax(scans, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.ct import generate_quart as jgenerate

    from pylinac_tpu_torch.core import dcm as tdcm

    jpaths = jgenerate(tmp_path, roll_deg=2.0, num_slices=40)
    tpaths = sorted(str(p) for p in Path(scans["rolled"]).glob("*.dcm"))
    assert len(jpaths) == len(tpaths) == 40
    for jp, tp in zip(jpaths, tpaths):
        np.testing.assert_array_equal(tdcm.dcmread(tp).pixel_array,
                                      jdcm.dcmread(jp).pixel_array)


CASES = [
    ("plain", {}),
    ("rolled", {}),
    ("plain", {"hu_tolerance": 0.5}),
    ("plain", {"scaling_tolerance": 0.5}),
    ("plain", {"thickness_tolerance": 0.05}),
    ("plain", {"cnr_threshold": 60}),
    ("plain", {"x_adjustment": 1.5}),
    ("plain", {"y_adjustment": -1.0}),
    ("rolled", {"angle_adjustment": 1.5}),
    ("plain", {"roi_size_factor": 0.8}),
    ("plain", {"scaling_factor": 1.02}),
    ("plain", {"origin_slice": 29}),
    ("rolled", {"roll_slice_offset": -3}),
    # a roll slice outside the HU module finds no inserts: both warn, set
    # the roll to 0 and capture the warning
    ("plain", {"roll_slice_offset": 40}),
]


@pytest.mark.parametrize("scan,analyze", CASES)
def test_results_match_jax(jquart, scans, scan, analyze):
    _assert_same(jquart, "QuartDVT", scans[scan], **analyze)


def test_results_meet_the_drawn_phantom(jquart, scans):
    """The generator's geometry and HU (``test_quart_dlg.py``'s bars)."""
    t, td = _assert_same(jquart, "QuartDVT", scans["plain"])
    hu = td["hu_module"]["rois"]
    for name, value in (("Air", -1000), ("Poly", -35), ("Acrylic", 120), ("Teflon", 990),
                        ("Water", 0)):
        assert hu[name]["value"] == pytest.approx(value, abs=15)
    for roi in td["uniformity_module"]["rois"].values():
        assert roi["value"] == pytest.approx(120, abs=15)
    assert td["uniformity_module"]["passed"]
    for key in ("horizontal mm", "vertical mm"):
        assert td["geometric_module"]["distances"][key] == pytest.approx(160, abs=2)
    assert 0 < td["geometric_module"]["mean_high_contrast_distance"] < 3
    assert td["hu_module"]["signal_to_noise"] > 50
    assert td["hu_module"]["contrast_to_noise"] > 10
    assert td["hu_module"]["measured_slice_thickness_mm"] == pytest.approx(2.5, abs=0.8)
    assert td["phantom_roll_deg"] == pytest.approx(0, abs=1)
    assert td["warnings"] == []
    _, rolled = _assert_same(jquart, "QuartDVT", scans["rolled"])
    assert rolled["phantom_roll_deg"] == pytest.approx(2.0, abs=0.7)


def test_roll_warning_is_captured(jquart, scans):
    _, td = _assert_same(jquart, "QuartDVT", scans["plain"], roll_slice_offset=40)
    assert td["warnings"] == [("Could not reliably determine Quart phantom roll. "
                               "Setting roll to 0.", "UserWarning")]
    assert td["phantom_roll_deg"] == 0.0


def test_hypersight_matches_jax(jquart, scans):
    """The deprecated class warns in ``__init__``, which is not captured;
    it keeps the water vial."""
    t, td = _assert_same(jquart, "HypersightQuartDVT", scans["plain"])
    assert td["phantom_model"] == "Hypersight Quart DVT"
    assert td["warnings"] == [] and "Water" in td["hu_module"]["rois"]
    with pytest.warns(DeprecationWarning, match="deprecated"):
        HypersightQuartDVT(folderpath=scans["plain"])


def test_results_data_forms(scans):
    t, _ = _run(QuartDVT, scans["plain"], device="cpu")
    data = t.results_data()
    assert type(data).__name__ == "QuartDVTResult"
    assert list(data.model_dump())[:5] == ["pylinac_version", "date_of_analysis", "warnings",
                                           "phantom_model", "phantom_roll_deg"]
    assert type(data.hu_module).__name__ == "QuartHUModuleOutput"
    assert json.loads(t.results_data(as_json=True))["num_images"] == 60


def test_without_device_needs_cuda(scans):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        QuartDVT(scans["plain"]).analyze()


def _close(a, b, path=""):
    """Card against CPU: integers, strings, booleans and keys exact; floats
    within 1e-3 (HU, mm and degrees; the card's region sums add in another
    order, so centroids may move in the last bits)."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=1e-3), path
    else:
        assert a == b, path


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["plain", "rolled"])
def test_on_card_matches_cpu(cuda, scans, scan):
    median.median3x3.launches = 0
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    c, _ = _run(QuartDVT, scans[scan], device=cuda)
    torch.cuda.synchronize()
    assert median.median3x3.launches >= 1
    assert ccl.label_batch.launches >= 2 and ccl.hole_roots_batch.launches >= 2
    h, _ = _run(QuartDVT, scans[scan], device="cpu")
    _close(_data(c), _data(h))
