"""The port's TomoCheese and CIRS 062M analyses against the JAX package's,
on the CPU.

Both packages read the same series: TomoCheese from the port's
``imggen.ct.generate_tomocheese`` (pixel-equal to the JAX generator's,
which ``test_generator_matches_jax`` checks), 24 slices and 12-slice
copies rolled 2 and 15 degrees as ``tests/models/test_cheese.py`` draws
them; the CIRS 062M, which neither package can generate, drawn here with
numpy (:func:`draw_cirs062m`: a 330 x 290 mm elliptical body and the 17
inserts of ``CIRSHUModule.roi_settings`` through a 50 mm slab), plain and
rolled 2 and 7 degrees. ``results_data()`` is compared as the
JSON-compatible dict without its date and version: strings, booleans,
keys and warnings (message, category) exactly, and every float to the bit;
so are ``results()`` and what the roll finder prints. Every argument of
``analyze`` gets a non-default case. The ``cuda`` tests run the series on
a card, where the localisation and CIRS's origin-slice search launch
``ccl.cu``, against the CPU run:
``python -m pytest --noconftest -m cuda tests/test_torch_cheese.py``.
"""

import contextlib
import io
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import CIRS062M, TomoCheese
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.imggen.ct import generate_tomocheese
from pylinac_tpu_torch.ops import ccl

# the CIRS 062M's inserts by the names of ``CIRSHUModule.roi_settings``:
# HU of tissue equivalents (lung inhale and exhale, adipose, breast,
# muscle, liver, trabecular and dense bone)
CIRS_HU = {"1": 0, "2": -800, "3": -500, "4": 40, "5": -40, "6": -90, "7": 240,
           "8": 60, "9": 1250, "10": 900, "11": -800, "12": 200, "13": -500,
           "14": 60, "15": 40, "16": -90, "17": 800}


def draw_cirs062m(dir_out, num_slices: int = 20, slice_thickness_mm: float = 2.5,
                  mm_per_pixel: float = 0.7, image_size: int = 512,
                  roll_deg: float = 0.0, noise_hu: float = 3.0, seed: int = 62,
                  body_mm: tuple[float, float] = (330.0, 290.0),
                  insert_mm: float = 24.0) -> list[str]:
    """A CIRS 062M series: a ``body_mm`` (width, height) elliptical water
    body, 50 mm thick, with ``insert_mm`` inserts at
    ``CIRSHUModule.roi_settings``' places, in air; uint16 with intercept
    -1000."""
    from pylinac_tpu_torch.cheese import CIRSHUModule

    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    yy, xx = np.mgrid[:image_size, :image_size]
    body = (((xx - center) * mm_per_pixel / (body_mm[0] / 2)) ** 2
            + ((yy - center) * mm_per_pixel / (body_mm[1] / 2)) ** 2) < 1
    uids = [tdcm.generate_uid() for _ in range(3)]
    roll = np.deg2rad(roll_deg)
    paths = []
    for i, z in enumerate((np.arange(num_slices) - num_slices / 2) * slice_thickness_mm):
        hu = np.full((image_size, image_size), -1000.0)
        if abs(z) <= 25:
            hu[body] = 0.0
            for name, s in CIRSHUModule.roi_settings.items():
                a = np.deg2rad(s["angle"]) + roll
                px = center + np.cos(a) * s["distance"] / mm_per_pixel
                py = center + np.sin(a) * s["distance"] / mm_per_pixel
                hu[(yy - py) ** 2 + (xx - px) ** 2 < (insert_mm / 2 / mm_per_pixel) ** 2] = CIRS_HU[name]
        hu += rng.standard_normal((image_size, image_size)) * noise_hu
        ds = tdcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = tdcm.generate_uid()
        ds.StudyInstanceUID, ds.SeriesInstanceUID, ds.FrameOfReferenceUID = uids
        ds.Modality = "CT"
        ds.PatientName = "CIRS^Synthetic"
        ds.PatientID = "CIRS062M"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(np.clip(hu + 1000, 0, 65535).astype(np.uint16))
        path = str(Path(dir_out) / f"cirs_{i:03d}.dcm")
        tdcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcheese():
    import pylinac_tpu.cheese as jcheese

    return jcheese


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    out = {}
    for name, kw in (("tomo", {}), ("tomo_rolled", {"roll_deg": 2.0, "num_slices": 12}),
                     ("tomo_rolled_15", {"roll_deg": 15.0, "num_slices": 12})):
        d = tmp_path_factory.mktemp(f"torch_{name}")
        generate_tomocheese(d, **kw)
        out[name] = str(d)
    for name, roll in (("cirs", 0.0), ("cirs_rolled", 2.0), ("cirs_rolled_7", 7.0)):
        d = tmp_path_factory.mktemp(f"torch_{name}")
        draw_cirs062m(d, roll_deg=roll)
        out[name] = str(d)
    return out


def _data(obj) -> dict:
    d = obj.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return d


def _run(cls, folder, device=None, **analyze):
    printed = io.StringIO()
    with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(printed):
        warnings.simplefilter("always")
        obj = cls(folder)
        if device is None:
            obj.analyze(**analyze)
        else:
            obj.analyze(device=device, **analyze)
    raised = [(str(w.message), w.category.__name__) for w in caught]
    return obj, _data(obj), obj.results(), raised, printed.getvalue()


_SAME = {}


def _assert_same(jcheese, name, folder, **analyze):
    """Both packages on one series, results, texts, warnings and prints
    equal; each (class, series, arguments) is analysed once here."""
    key = (name, folder, repr(sorted(analyze.items())))
    if key not in _SAME:
        j = _run(getattr(jcheese, name), folder, **analyze)
        t = _run(globals()[name], folder, device="cpu", **analyze)
        assert json.dumps(t[1]) == json.dumps(j[1])
        assert t[2:] == j[2:]
        _SAME[key] = t
    return _SAME[key]


def test_generator_matches_jax(scans, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.ct import generate_tomocheese as jgenerate

    jpaths = jgenerate(tmp_path, roll_deg=2.0, num_slices=12)
    tpaths = sorted(str(p) for p in Path(scans["tomo_rolled"]).glob("*.dcm"))
    assert len(jpaths) == len(tpaths) == 12
    for jp, tp in zip(jpaths, tpaths):
        np.testing.assert_array_equal(tdcm.dcmread(tp).pixel_array,
                                      jdcm.dcmread(jp).pixel_array)


DENSITIES = {"1": {"density": 0.2}, "6": {"density": 1.8}}

TOMO_CASES = [
    ("tomo", {}),
    ("tomo_rolled", {}),
    ("tomo_rolled_15", {}),  # 7.5 degrees off a nominal insert: both print, roll 0
    ("tomo", {"roi_config": DENSITIES}),
    ("tomo", {"x_adjustment": 1.5}),
    ("tomo", {"y_adjustment": -1.0}),
    ("tomo_rolled", {"angle_adjustment": 1.5}),
    ("tomo", {"roi_size_factor": 0.8}),
    ("tomo", {"scaling_factor": 1.02}),
    ("tomo", {"origin_slice": 10}),
]


@pytest.mark.parametrize("scan,analyze", TOMO_CASES)
def test_tomocheese_matches_jax(jcheese, scans, scan, analyze):
    _assert_same(jcheese, "TomoCheese", scans[scan], **analyze)


CIRS_CASES = [
    ("cirs", {}),
    ("cirs_rolled", {}),
    ("cirs_rolled_7", {}),
    ("cirs", {"roi_config": {"1": {"density": 1.0}, "9": {"density": 1.9}}}),
    ("cirs", {"x_adjustment": -2.0}),
    ("cirs", {"y_adjustment": 1.0}),
    ("cirs_rolled", {"angle_adjustment": -1.0}),
    ("cirs", {"roi_size_factor": 1.2}),
    ("cirs", {"scaling_factor": 0.98}),
    ("cirs", {"origin_slice": 8}),
]


@pytest.mark.parametrize("scan,analyze", CIRS_CASES)
def test_cirs062m_matches_jax(jcheese, scans, scan, analyze):
    _assert_same(jcheese, "CIRS062M", scans[scan], **analyze)


def test_tomocheese_meets_the_drawn_phantom(jcheese, scans):
    """``tests/models/test_cheese.py``'s bars."""
    t, td, text, _, printed = _assert_same(jcheese, "TomoCheese", scans["tomo"])
    for name, hu in (("1", -800), ("6", 800), ("8", 300), ("13", -300), ("3", 0)):
        assert td["rois"][name]["median"] == pytest.approx(hu, abs=15)
    assert td["roi_6"]["median"] == pytest.approx(800, abs=15) and len(td["rois"]) == 20
    assert td["phantom_roll"] == pytest.approx(0, abs=1) and printed == ""
    assert "Tomotherapy Cheese" in text and "ROI 20" in text
    assert type(t.results_data()).__name__ == "TomoCheeseResult"
    _, rolled, _, _, _ = _assert_same(jcheese, "TomoCheese", scans["tomo_rolled"])
    assert rolled["phantom_roll"] == pytest.approx(2.0, abs=0.7)
    _, rolled15, _, _, printed = _assert_same(jcheese, "TomoCheese", scans["tomo_rolled_15"])
    assert rolled15["phantom_roll"] == 0 and "was >5 degrees" in printed


def test_cirs062m_meets_the_drawn_phantom(jcheese, scans):
    """Every insert within 15 HU of its drawn value, the phantom's centre
    found, the roll within 0.7 degrees."""
    t, td, _, raised, printed = _assert_same(jcheese, "CIRS062M", scans["cirs"])
    assert len(td["rois"]) == 17 and td["warnings"] == [] and raised == [] and printed == ""
    for name, hu in CIRS_HU.items():
        assert td["rois"][name]["median"] == pytest.approx(hu, abs=15), name
    centre = t.module.phan_center
    assert abs(centre.x - 255.5) < 0.5 and abs(centre.y - 255.5) < 0.5
    assert td["phantom_roll"] == pytest.approx(0, abs=0.7)
    assert 7 <= td["origin_slice"] <= 12
    _, rolled, _, _, _ = _assert_same(jcheese, "CIRS062M", scans["cirs_rolled"])
    assert rolled["phantom_roll"] == pytest.approx(2.0, abs=0.7)
    _, rolled7, _, _, printed = _assert_same(jcheese, "CIRS062M", scans["cirs_rolled_7"])
    assert rolled7["phantom_roll"] == 0 and "was >5 degrees" in printed
    assert type(t.results_data()).__name__ == "CheeseResult"


def test_roi_config_is_kept(scans):
    t, _, _, _, _ = _run(TomoCheese, scans["tomo_rolled"], device="cpu", roi_config=DENSITIES)
    assert t.roi_config == DENSITIES


def test_without_device_needs_cuda(scans):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TomoCheese(scans["tomo_rolled"]).analyze()


def _close(a, b, path=""):
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
@pytest.mark.parametrize("cls,scan", [(TomoCheese, "tomo"), (TomoCheese, "tomo_rolled"),
                                      (CIRS062M, "cirs"), (CIRS062M, "cirs_rolled")])
def test_on_card_matches_cpu(cuda, scans, cls, scan):
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    c = _run(cls, scans[scan], device=cuda)
    torch.cuda.synchronize()
    assert ccl.label_batch.launches >= 1 and ccl.hole_roots_batch.launches >= 1
    if cls is CIRS062M:  # one Slice a second image of the origin search
        assert ccl.label_batch.launches >= 1 + 10
    h = _run(cls, scans[scan], device="cpu")
    _close(c[1], h[1])
