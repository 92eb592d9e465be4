"""The port's GE Helios daily QA analysis against the JAX package's, on the
CPU.

Both packages read the same series, drawn by the port's
``imggen.ct.generate_helios`` (pixel-equal to the JAX generator's, which
``test_generator_matches_jax`` checks): 40 slices of 512 x 512 at 2.5 mm.
``results_data()`` is compared as the JSON-compatible dict without its
date and version: strings, booleans, keys and warnings (message, category)
exactly, and every float to the bit; ``results()`` and the warnings each
call raises too (the 4-bar gauge's 10 % rMTF is an extrapolation, which
both packages warn of). Every argument of ``analyze`` gets a non-default
case. The ``cuda`` tests run the series on a card, where the localisation
and the origin-slice search (one ``Slice`` an image) launch ``ccl.cu``,
against the CPU run:
``python -m pytest --noconftest -m cuda tests/test_torch_helios.py``.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import GEHeliosCTDaily
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.imggen.ct import generate_helios
from pylinac_tpu_torch.ops import ccl


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jhelios():
    import pylinac_tpu.helios as jhelios

    return jhelios


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_helios")
    generate_helios(d)
    return str(d)


def _caught(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [(str(w.message), w.category.__name__) for w in caught]


def _run(cls, folder, device=None, **analyze):
    obj = cls(folder)
    _, raised = _caught(lambda: obj.analyze(**analyze) if device is None
                        else obj.analyze(device=device, **analyze))
    data, data_raised = _caught(lambda: obj.results_data(as_dict=True))
    data.pop("date_of_analysis")
    data.pop("pylinac_version")
    data["warnings"] = [(w["message"], w["category"]) for w in data["warnings"]]
    text, text_raised = _caught(obj.results)
    return obj, data, (text, raised, data_raised, text_raised)


_SAME = {}


def _assert_same(jhelios, folder, **analyze):
    key = (folder, repr(sorted(analyze.items())))
    if key not in _SAME:
        _, jd, jrest = _run(jhelios.GEHeliosCTDaily, folder, **analyze)
        t, td, trest = _run(GEHeliosCTDaily, folder, device="cpu", **analyze)
        assert json.dumps(td) == json.dumps(jd)
        assert trest == jrest
        _SAME[key] = t, td, trest
    return _SAME[key]


def test_generator_matches_jax(scan, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.ct import generate_helios as jgenerate

    jpaths = jgenerate(tmp_path)
    tpaths = sorted(str(p) for p in Path(scan).glob("*.dcm"))
    assert len(jpaths) == len(tpaths) == 40
    for jp, tp in zip(jpaths, tpaths):
        np.testing.assert_array_equal(tdcm.dcmread(tp).pixel_array,
                                      jdcm.dcmread(jp).pixel_array)


CASES = [
    {},
    {"x_adjustment": 1.5},
    {"y_adjustment": -1.0},
    {"angle_adjustment": 2.0},
    {"roi_size_factor": 0.8},
    {"scaling_factor": 1.02},
    {"origin_slice": 9},
]


@pytest.mark.parametrize("analyze", CASES)
def test_results_match_jax(jhelios, scan, analyze):
    _assert_same(jhelios, scan, **analyze)


def test_results_meet_the_drawn_phantom(jhelios, scan):
    """``tests/models/test_helios.py``'s bars."""
    t, td, (text, raised, data_raised, text_raised) = _assert_same(jhelios, scan)
    cs = td["contrast_scale"]
    assert cs["mean_hu_plastic"] == pytest.approx(120, abs=10)
    assert cs["mean_hu_water"] == pytest.approx(0, abs=10)
    assert cs["hu_difference"] == pytest.approx(120, abs=12)
    mtfs = list(t.high_contrast_module.mtf.norm_mtfs.values())
    assert mtfs[0] == pytest.approx(1.0) and mtfs[-1] < mtfs[0]
    assert len(td["high_contrast"]["mtf_lp_mm"]) == 9
    nu = td["noise_uniformity"]
    assert nu["center_mean_hu"] == pytest.approx(0, abs=10)
    assert abs(nu["means_diff"]) < 10 and 0 < nu["noise_center_std"] < 10
    lc = td["low_contrast"]
    assert len(lc["slices"]) == 3 and lc["mean"] == pytest.approx(0, abs=10)
    assert 0 < lc["std"] < 10
    assert td["phantom_roll_deg"] == 0.0 and td["origin_slice"] == 8
    # the only warnings: the 10 % rMTF extrapolated, in results_data and results
    assert raised == [] and td["warnings"] == []
    assert data_raised and all("extrapolation" in m for m, _ in data_raised)
    assert text_raised and all("extrapolation" in m for m, _ in text_raised)
    assert "GE Helios" in text and "Contrast Difference" in text


def test_results_data_forms(scan):
    t, _, _ = _run(GEHeliosCTDaily, scan, device="cpu", origin_slice=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        data = t.results_data()
        assert json.loads(t.results_data(as_json=True))["num_images"] == 40
    assert type(data).__name__ == "GEHeliosResult"
    assert type(data.low_contrast.slices["slice_1"]).__name__ == \
        "HeliosLowContrastModuleOutput"
    assert list(data.model_dump())[3:7] == ["phantom_model", "phantom_roll_deg",
                                            "origin_slice", "num_images"]


def test_without_device_needs_cuda(scan):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GEHeliosCTDaily(scan).analyze()


@pytest.mark.cuda
def test_on_card_matches_cpu(cuda, scan):
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    _, c, _ = _run(GEHeliosCTDaily, scan, device=cuda)
    torch.cuda.synchronize()
    # the stack, then one B = 1 label and holes for each of the 40 images
    assert ccl.label_batch.launches >= 41 and ccl.hole_roots_batch.launches >= 41
    _, h, _ = _run(GEHeliosCTDaily, scan, device="cpu")

    def close(a, b, path=""):
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, float):
            assert a == pytest.approx(b, abs=1e-3), path
        else:
            assert a == b, path

    close(c, h)
