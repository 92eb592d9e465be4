"""The port's CatPhan 700 against the JAX package's single-scan ``CatPhan700``,
on one synthetic 80-slice scan at the smoke's geometry (512 x 512 int16 at
0.5 mm pixels, 2.5 mm slices, CTP404 at +70 mm so that every module down to
CTP486 at -160 mm lies in the scan).

JAX runs with ``PYLINAC_TPU_CCL=xla`` (the device route the port takes).
Its ``CatPhanBatch`` cannot run a CatPhan 700 (it treats every CTP528 as
the circle-profile kind; ROADMAP section 3), so the port's batch is held to
JAX's single scan. Tolerances: the CatPhan bar of
``tests/test_torch_catphan.py`` (integers, booleans, strings and keys exact;
floats within 0.01 or 0.1 %; the roll within 0.01 degree), with the
``ctp528`` ROI settings exact and ``mtf_lp_mm`` within 1e-3 lp/mm.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch.core.geometry import Point
from pylinac_tpu_torch.imggen.ct import _generate_catphan700
from tests.test_torch_catphan import _assert_agree

NON_DEFAULT = dict(hu_tolerance=10, contrast_method="Weber", roi_size_factor=1.2,
                   origin_slice=67)
CASES = {"default": {}, "non_default": NON_DEFAULT}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("catphan700")
    _generate_catphan700(d)
    return str(d)


@pytest.fixture(scope="module")
def jax_results(scan):
    """JAX's single-scan ``CatPhan700`` of each case, as dicts."""
    pytest.importorskip("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYLINAC_TPU_CCL", "xla")
        from pylinac_tpu.ct import CatPhan700

        out = {}
        for name, kwargs in CASES.items():
            ct = CatPhan700(scan)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ct.analyze(**kwargs)
                out[name] = ct.results_data(as_dict=True)
        return out


@pytest.fixture(scope="module")
def port(scan):
    """The port's single scan of each case and a two-scan batch (the scan
    twice) of each, on the CPU, as dicts; and the warnings the default
    single scan raised."""
    single, batch = {}, {}
    for name, kwargs in CASES.items():
        ct = tct.CatPhan700(scan)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ct.analyze(device="cpu", **kwargs)
            single[name] = ct.results_data(as_dict=True)
        if name == "default":
            default_warnings, default_ct = caught, ct
        b = tct.CatPhanBatch([scan, scan], model=tct.CatPhan700)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b.analyze(device="cpu", **kwargs)
            batch[name] = b.results_data(as_dict=True)
    return SimpleNamespace(single=single, batch=batch, warnings=default_warnings,
                           ct=default_ct)


def _assert_ctp528_exact(want: dict, got: dict) -> None:
    assert got["ctp528"]["roi_settings"] == want["ctp528"]["roi_settings"]
    assert got["ctp528"]["start_angle_radians"] is want["ctp528"]["start_angle_radians"] is None
    assert list(got["ctp528"]["mtf_lp_mm"]) == list(want["ctp528"]["mtf_lp_mm"])
    for p, v in want["ctp528"]["mtf_lp_mm"].items():
        assert abs(got["ctp528"]["mtf_lp_mm"][p] - v) <= 1e-3, p


@pytest.mark.parametrize("case", CASES)
def test_single_scan_matches_jax(jax_results, port, case):
    assert _assert_agree(jax_results[case], port.single[case]) > 100
    _assert_ctp528_exact(jax_results[case], port.single[case])


@pytest.mark.parametrize("case", CASES)
def test_batch_matches_jax_single_scan(jax_results, port, case):
    for result in port.batch[case]:
        assert _assert_agree(jax_results[case], result) > 100
        _assert_ctp528_exact(jax_results[case], result)


def test_non_default_arguments_take_effect(port):
    default, other = port.single["default"], port.single["non_default"]
    assert other["origin_slice"] == 67 and default["origin_slice"] == 68
    assert other["ctp404"]["hu_tolerance"] == 10
    assert other["ctp528"]["roi_settings"]["region 1"]["height_pixels"] == pytest.approx(
        1.2 * default["ctp528"]["roi_settings"]["region 1"]["height_pixels"])
    assert (other["ctp515"]["roi_results"]["15"]["contrast method"] == "Weber"
            and default["ctp515"]["roi_results"]["15"]["contrast method"] == "Michelson")


def test_results_within_the_phantom_bars(port):
    """The smoke's gates on the drawn phantom: plugs within 40 HU of
    nominal, geometry within 1 mm, slice thickness within 0.2 mm, the roll
    near 0, the MTF falling over the eight bar groups with its 50 % point
    measured inside 0.1-0.8 lp/mm."""
    r = port.single["default"]
    c404 = r["ctp404"]
    assert r["catphan_model"] == "700" and r["num_images"] == 80
    assert len(c404["hu_rois"]) == 11
    assert all(abs(roi["value"] - roi["nominal_value"]) < 40 for roi in c404["hu_rois"].values())
    assert c404["hu_linearity_passed"]
    assert abs(c404["avg_line_distance_mm"] - 50) < 1 and c404["geometry_passed"]
    assert abs(c404["measured_slice_thickness_mm"] - 2.5) < 0.2 and c404["thickness_passed"]
    assert abs(r["catphan_roll_deg"]) < 0.1
    norm = list(port.ct.ctp528.mtf.norm_mtfs.values())
    assert len(norm) == 8 and all(a > b for a, b in zip(norm, norm[1:]))
    assert 0.1 < r["ctp528"]["mtf_lp_mm"]["50"] < 0.8
    messages = [str(w.message) for w in port.warnings]
    assert not any("monotonically" in m for m in messages)
    assert not any("50%" in m for m in messages)
    assert r["ctp486"]["passed"] and r["ctp515"]["num_rois_seen"] >= 1
    assert r["warnings"] == []


def test_bar_rois_take_jax_pixels(scan):
    """Each rotated bar ROI takes the pixels JAX's takes."""
    pytest.importorskip("jax")
    from pylinac_tpu.core.geometry import Point as JaxPoint
    from pylinac_tpu.ct import SpatialResolutionROI as JaxROI

    rng = np.random.default_rng(5)
    arr = rng.normal(0, 100, (200, 200))
    for rotation in (-90, -45, 0, 45, 12.5):
        for w, h in ((6, 22), (6, 8), (7.3, 13.1)):
            center = (100.3, 97.8)
            got = tct.SpatialResolutionROI(arr, w, h, Point(*center), rotation=rotation)
            want = JaxROI(arr, w, h, JaxPoint(*center), rotation=rotation)
            np.testing.assert_array_equal(got.pixels_flat, want.pixels_flat)
            assert (got.max, got.min) == (want.max, want.min)

