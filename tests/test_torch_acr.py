"""The port's ACR CT 464 and ACR MRI Large analyses against the JAX
package's, on the CPU.

Both packages read the same series, drawn by the port's generators
(``imggen.ct.generate_acr_ct`` and ``imggen.mri.generate_acr_mri``,
pixel-equal to the JAX generators', which ``test_generators_match_jax``
checks): the 32-slice ACR CT at 5 mm and a copy rolled 2 degrees; the 11
axial MR slices with the sagittal localiser, a copy shifted by (3, 7)
pixels (its diagonal profiles run into the mirrored border of
``map_coordinates``), and a two-echo copy. ``results_data()`` is compared
as the JSON-compatible dict without its date and version: strings,
booleans, keys and warnings (message, category) exactly, and every float
to the bit (the parity bar is 0.01 mm and 0.1 %). On the CPU the port's
localisation, regions, flood fill and filters are the plain twins. Every
argument of ``analyze`` gets a non-default case. The ``cuda`` tests run
the same series on a card, where the localisation, the roll slice and
the MR low-contrast regions launch ``ccl.cu`` and the MR fills
``flood.cu``, against the CPU run:
``python -m pytest --noconftest -m cuda tests/test_torch_acr.py``.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ACRCT, ACRMRILarge
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.core.contrast import Contrast
from pylinac_tpu_torch.imggen.ct import generate_acr_ct
from pylinac_tpu_torch.imggen.mri import generate_acr_mri
from pylinac_tpu_torch.ops import ccl, flood


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jacr():
    import pylinac_tpu.acr as jacr

    return jacr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rewrite(src: str, dst: Path, change) -> None:
    """Copy a series, passing each dataset through ``change(ds, i)``."""
    dst.mkdir(parents=True, exist_ok=True)
    for i, path in enumerate(sorted(Path(src).glob("*.dcm"))):
        ds = tdcm.dcmread(str(path))
        change(ds, i)
        tdcm.dcmwrite(str(dst / path.name), ds)


def _shift(ds, i, dy=3, dx=7):
    ds.set_pixel_data(np.roll(ds.pixel_array, (dy, dx), axis=(0, 1)))


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    ct = tmp_path_factory.mktemp("torch_acr_ct")
    ct_rolled = tmp_path_factory.mktemp("torch_acr_ct_rolled")
    generate_acr_ct(ct)
    generate_acr_ct(ct_rolled, roll_deg=2.0)
    mr = tmp_path_factory.mktemp("torch_acr_mr")
    generate_acr_mri(mr)
    mr_shifted = tmp_path_factory.mktemp("torch_acr_mr_shifted")
    _rewrite(str(mr), mr_shifted, _shift)
    # a second echo of every axial slice: the same series, 0.9 x the signal
    two_echo = tmp_path_factory.mktemp("torch_acr_mr_two_echo")
    _rewrite(str(mr), two_echo, lambda ds, i: None)

    def echo2(ds, i):
        ds.EchoNumbers = 2
        ds.SOPInstanceUID = tdcm.generate_uid()
        ds.set_pixel_data((ds.pixel_array * 0.9).astype(np.uint16))

    _rewrite(str(mr), two_echo / "echo2", echo2)
    (two_echo / "echo2" / "mr_sag.dcm").unlink()
    # echo 2 alone (the sagittal localiser is echo 1: choosing echo 2 drops it)
    echo2_only = tmp_path_factory.mktemp("torch_acr_mr_echo2")
    _rewrite(str(two_echo / "echo2"), echo2_only, lambda ds, i: None)
    return {"ct": str(ct), "ct_rolled": str(ct_rolled), "mr": str(mr),
            "mr_shifted": str(mr_shifted), "mr_two_echo": str(two_echo),
            "mr_echo2_only": str(echo2_only)}


def _data(obj) -> dict:
    d = obj.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return d


def _run(cls, folder, device=None, **analyze):
    """Analyse and take the results at once: the modules' class-level
    settings dicts are shared, as in JAX, so a later analysis would change
    them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = cls(folder)
        if device is None:
            obj.analyze(**analyze)
        else:
            obj.analyze(device=device, **analyze)
        data, text = _data(obj), obj.results()
    return obj, data, text, [(str(w.message), w.category.__name__) for w in caught]


_SAME = {}


def _assert_same(jacr, name, folder, **analyze):
    """Both packages on one series, results equal; each (class, series,
    arguments) is analysed once in this module."""
    key = (name, folder, repr(sorted(analyze.items())))
    if key not in _SAME:
        _, jd, jtext, j_raised = _run(getattr(jacr, name), folder, **analyze)
        t, td, ttext, t_raised = _run(globals()[name], folder, device="cpu", **analyze)
        assert json.dumps(td) == json.dumps(jd)
        assert t_raised == j_raised
        assert ttext == jtext
        _SAME[key] = t, td
    return _SAME[key]


def test_generators_match_jax(scans, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.ct import generate_acr_ct as jct
    from pylinac_tpu.imggen.mri import generate_acr_mri as jmri

    for generate, folder, kw in ((jct, scans["ct_rolled"], {"roll_deg": 2.0}),
                                 (jmri, scans["mr"], {})):
        jpaths = sorted(generate(tmp_path / folder[-12:], **kw))
        tpaths = sorted(str(p) for p in Path(folder).glob("*.dcm"))
        assert len(jpaths) == len(tpaths)
        for jp, tp in zip(jpaths, tpaths):
            np.testing.assert_array_equal(tdcm.dcmread(tp).pixel_array,
                                          jdcm.dcmread(jp).pixel_array)


CT_CASES = [
    ("ct", {}),
    ("ct_rolled", {}),
    ("ct", {"x_adjustment": 1.5}),
    ("ct", {"y_adjustment": -1.0}),
    ("ct_rolled", {"angle_adjustment": 1.5}),
    ("ct", {"roi_size_factor": 0.8}),
    ("ct", {"scaling_factor": 1.02}),
    ("ct", {"origin_slice": 5}),
]


@pytest.mark.parametrize("scan,analyze", CT_CASES)
def test_acr_ct_matches_jax(jacr, scans, scan, analyze):
    _assert_same(jacr, "ACRCT", scans[scan], **analyze)


def test_acr_ct_meets_the_drawn_phantom(jacr, scans):
    """The generator's HU, uniformity, CNR, MTF and roll
    (``tests/models/test_acr.py``'s bars)."""
    _, td = _assert_same(jacr, "ACRCT", scans["ct"])
    for name, hu in (("Air", -1000), ("Poly", -95), ("Acrylic", 120), ("Bone", 955),
                     ("Water", 0)):
        assert td["ct_module"]["rois"][name] == pytest.approx(hu, abs=15)
    for value in td["uniformity_module"]["rois"].values():
        assert value == pytest.approx(0, abs=10)
    assert td["low_contrast_module"]["cnr"] > 5
    rmtf = list(td["spatial_resolution_module"]["lpmm_to_rmtf"].values())
    assert rmtf[0] == pytest.approx(1.0) and rmtf[-1] < 0.5 and len(rmtf) == 8
    assert td["phantom_roll_deg"] == pytest.approx(0, abs=1)
    _, rolled = _assert_same(jacr, "ACRCT", scans["ct_rolled"])
    assert rolled["phantom_roll_deg"] == pytest.approx(2.0, abs=1)


MR_CASES = [
    ("mr", {}),
    ("mr_shifted", {}),
    ("mr_two_echo", {}),
    ("mr_two_echo", {"echo_number": 1}),
    ("mr", {"x_adjustment": 1.5}),
    ("mr", {"y_adjustment": -1.0}),
    ("mr", {"angle_adjustment": 1.5}),
    ("mr", {"roi_size_factor": 0.9}),
    ("mr", {"scaling_factor": 1.02}),
    ("mr", {"low_contrast_method": Contrast.MICHELSON}),
    ("mr", {"low_contrast_visibility_threshold": 0.5}),
    ("mr", {"low_contrast_visibility_sanity_multiplier": 1.5}),
]


@pytest.mark.parametrize("scan,analyze", MR_CASES)
def test_acr_mri_matches_jax(jacr, scans, scan, analyze):
    _assert_same(jacr, "ACRMRILarge", scans[scan], **analyze)


def test_acr_mri_meets_the_drawn_phantom(jacr, scans):
    """The generator's geometry (``tests/models/test_acr.py``'s bars): 200
    mm across in four directions, 148 mm on the sagittal localiser, PIU
    over 95, no ghosting, a 5 mm slice, no shift, 16 spokes."""
    t, td = _assert_same(jacr, "ACRMRILarge", scans["mr"])
    for name, p in td["geometric_distortion_module"]["profiles"].items():
        assert p["width (mm)"] == pytest.approx(200, abs=4), name
    widths = [p["width (mm)"] for p in td["sagittal_localizer_module"]["profiles"].values()]
    assert len(widths) == 4 and all(w == pytest.approx(148, abs=3) for w in widths)
    assert td["uniformity_module"]["piu"] > 95 and td["uniformity_module"]["piu_passed"]
    assert td["uniformity_module"]["psg"] < 3
    assert td["slice1"]["measured_slice_thickness_mm"] == pytest.approx(5, abs=1)
    assert td["slice1"]["slice_shift_mm"] == pytest.approx(0, abs=1)
    assert td["slice11"]["slice_shift_mm"] == pytest.approx(0, abs=1)
    assert td["low_contrast_multi_slice_module"]["score"] == pytest.approx(16, abs=4)
    assert td["phantom_roll_deg"] == pytest.approx(0, abs=1.5)
    assert t.has_sagittal_module and td["num_images"] == 11


def test_shifted_diagonals_reach_the_mirror(jacr, scans):
    """On the shifted copy the diagonal lines leave the image, so mirrored
    samples decide the profile's ends; the widths still match JAX's to the
    bit and the drawn 200 mm."""
    t, td = _assert_same(jacr, "ACRMRILarge", scans["mr_shifted"])
    centre = t.geometric_distortion.phan_center
    assert abs(centre.y - centre.x - (3 - 7)) < 0.5  # the +-45 degree lines leave the image
    for name, p in td["geometric_distortion_module"]["profiles"].items():
        assert p["width (mm)"] == pytest.approx(200, abs=4), name


def test_two_echoes(jacr, scans):
    """The lowest echo by default, with the warning captured into
    ``results_data``; echo 2 on request; each removed once; the
    localisation's cached volume holds the 11 axial slices of one echo and
    no sagittal image."""
    t, td = _assert_same(jacr, "ACRMRILarge", scans["mr_two_echo"])
    assert td["warnings"] == [("Multiple echoes found ({1, 2}) and no echo number was "
                               "passed. Using echo # 1", "UserWarning")]
    assert len(t.dicom_stack) == len(t.dicom_stack.metadatas) == 11
    assert t._host_vol.shape[0] == 11 and t.has_sagittal_module
    assert {int(m.EchoNumbers) for m in t.dicom_stack.metadatas} == {1}
    _, one = _assert_same(jacr, "ACRMRILarge", scans["mr"])
    assert json.dumps({k: v for k, v in td.items() if k != "warnings"}) == \
        json.dumps({k: v for k, v in one.items() if k != "warnings"})

def test_second_echo(jacr, scans):
    """Echo 2 of the two-echo series equals JAX's analysis of echo 2 alone.
    JAX itself raises here: its second ``del`` on the stack's fresh
    ``metadatas`` list runs past the end once the last image is one it
    drops (a fault of the reference, ROADMAP section 3)."""
    with pytest.raises(IndexError):
        jacr.ACRMRILarge(scans["mr_two_echo"]).analyze(echo_number=2)
    _, jd, jtext, _ = _run(jacr.ACRMRILarge, scans["mr_echo2_only"])
    t, td, ttext, raised = _run(ACRMRILarge, scans["mr_two_echo"], device="cpu",
                                echo_number=2)
    assert json.dumps(td) == json.dumps(jd) and ttext == jtext and raised == []
    assert {int(m.EchoNumbers) for m in t.dicom_stack.metadatas} == {2}
    assert len(t.dicom_stack) == 11 and t._host_vol.shape[0] == 11
    assert not t.has_sagittal_module and td["sagittal_localizer_module"]["profiles"] == {}


def test_two_echoes_lazy_stack(scans):
    """A memory-efficient (lazy) stack drops each echo image and its
    metadata once, as the eager one does."""
    eager, ed, _, _ = _run(ACRMRILarge, scans["mr_two_echo"], device="cpu")
    lazy = ACRMRILarge(scans["mr_two_echo"], memory_efficient_mode=True)
    lazy.analyze(device="cpu")
    assert type(lazy.dicom_stack).__name__ == "LazyDicomImageStack"
    assert len(lazy.dicom_stack) == len(lazy.dicom_stack.metadatas) == 11
    assert json.dumps(_data(lazy)) == json.dumps(ed)


def test_echo_and_sagittal_errors(jacr, scans, tmp_path):
    with pytest.raises(ValueError, match="Echo number"):
        ACRMRILarge(scans["mr"]).analyze(echo_number=99, device="cpu")
    _rewrite(scans["mr"], tmp_path / "two_sag", lambda ds, i: None)
    ds = tdcm.dcmread(str(tmp_path / "two_sag" / "mr_sag.dcm"))
    ds.SOPInstanceUID = tdcm.generate_uid()
    tdcm.dcmwrite(str(tmp_path / "two_sag" / "mr_sag2.dcm"), ds)
    for cls in (ACRMRILarge, jacr.ACRMRILarge):
        with pytest.raises(ValueError, match="too many sagittal"):
            obj = cls(str(tmp_path / "two_sag"))
            obj.analyze() if cls is jacr.ACRMRILarge else obj.analyze(device="cpu")


def test_results_data_forms(scans):
    t, _, _, _ = _run(ACRMRILarge, scans["mr"], device="cpu")
    data = t.results_data()
    assert type(data).__name__ == "ACRMRIResult"
    assert list(data.model_dump())[:7] == ["pylinac_version", "date_of_analysis", "warnings",
                                           "phantom_model", "phantom_roll_deg", "origin_slice",
                                           "num_images"]
    assert type(data.slice1).__name__ == "MRSlice1ModuleOutput"
    assert json.loads(t.results_data(as_json=True))["num_images"] == 11
    c, _, _, _ = _run(ACRCT, scans["ct"], device="cpu")
    assert type(c.results_data().spatial_resolution_module).__name__ == \
        "SpatialResolutionModuleOutput"


def test_without_device_needs_cuda(scans):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ACRCT(scans["ct"]).analyze()
    with pytest.raises(RuntimeError, match="CUDA"):
        ACRMRILarge(scans["mr"]).analyze()


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
@pytest.mark.parametrize("scan", ["ct", "ct_rolled"])
def test_acr_ct_on_card_matches_cpu(cuda, scans, scan):
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    _, c, _, _ = _run(ACRCT, scans[scan], device=cuda)
    torch.cuda.synchronize()
    assert ccl.label_batch.launches >= 2 and ccl.hole_roots_batch.launches >= 2
    _, h, _, _ = _run(ACRCT, scans[scan], device="cpu")
    _close(c, h)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["mr", "mr_shifted", "mr_two_echo"])
def test_acr_mri_on_card_matches_cpu(cuda, scans, scan):
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    flood.flood_from_border_batch.launches = 0
    _, c, _, _ = _run(ACRMRILarge, scans[scan], device=cuda)
    torch.cuda.synchronize()
    # the stack, the roll slice and four low-contrast slices (two each)
    assert ccl.label_batch.launches >= 10 and ccl.hole_roots_batch.launches >= 6
    assert flood.flood_from_border_batch.launches == 2  # distortion and sagittal fills
    _, h, _, _ = _run(ACRMRILarge, scans[scan], device="cpu")
    _close(c, h)
