"""The port's CatPhan 503, 600 and 604 against the JAX package's, on one
synthetic scan of each (``imggen.ct._generate_catphan``: 512 x 512 int16 at
0.5 mm pixels, 2.5 mm slices, 60 slices for the 503 and 604 and 80 for the
600, every module inside the scan), and a 600 without its water vial
(default arguments only).

JAX runs with ``PYLINAC_TPU_CCL=xla`` (the device route the port takes);
the port runs on the CPU. Each model's single-scan class is held to JAX's
in a default case and a case with other arguments, and the port's
``CatPhanBatch(model=...)`` to JAX's ``CatPhanBatch(model=...)`` scan by
scan (the 600's batch holds the scan and its vial-less copy). Tolerances:
the CatPhan bar of ``tests/test_torch_catphan.py`` (integers, booleans,
strings and keys exact; floats within 0.01 or 0.1 %; the roll within 0.01
degree); the ``results()`` text exact. The results_data arguments
``exclude`` and ``by_alias`` are held to JAX's on the 503.
"""

import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch.imggen import ct as tgen
from tests.test_torch_catphan import _assert_agree

# scan name: (model, generator arguments)
SCANS = {"503": ("503", {}), "604": ("604", {}), "600": ("600", {}),
         "600 no vial": ("600", {"vial": False})}
DEFAULT_ORIGIN = {"503": 50, "604": 38, "600": 70, "600 no vial": 70}
# the batches: model, scans
BATCHES = {"503": ("503", ["503", "503"]), "604": ("604", ["604", "604"]),
           "600": ("600", ["600", "600 no vial"])}


def _cases(name: str) -> dict:
    return {"default": {},
            "non_default": dict(hu_tolerance=10, contrast_method="Weber", roi_size_factor=1.2,
                                origin_slice=DEFAULT_ORIGIN[name] - 1)}


# the vial-less 600 in the default case only
RUNS = [(name, case) for name in SCANS for case in _cases(name)
        if (name, case) != ("600 no vial", "non_default")]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans(tmp_path_factory) -> dict:
    out = {}
    for name, (model, kwargs) in SCANS.items():
        d = tmp_path_factory.mktemp("catphan" + model)
        tgen._generate_catphan(d, model, **kwargs)
        out[name] = str(d)
    return out


def _analyze_all(ct_module, scans: dict, **device) -> SimpleNamespace:
    """Each run's single-scan result dict and text, each batch's result
    dicts, and the 503's default analysis, by one package."""
    single, text, batch = {}, {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, case in RUNS:
            ct = getattr(ct_module, "CatPhan" + SCANS[name][0])(scans[name])
            ct.analyze(**device, **_cases(name)[case])
            single[name, case] = ct.results_data(as_dict=True)
            text[name, case] = ct.results()
            if (name, case) == ("503", "default"):
                ct503 = ct
        for key, (model, names) in BATCHES.items():
            b = ct_module.CatPhanBatch([scans[n] for n in names],
                                       model=getattr(ct_module, "CatPhan" + model))
            b.analyze(**device)
            batch[key] = b.results_data(as_dict=True)
    return SimpleNamespace(single=single, text=text, batch=batch, ct503=ct503)


@pytest.fixture(scope="module")
def jax_runs(scans):
    pytest.importorskip("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYLINAC_TPU_CCL", "xla")
        from pylinac_tpu import ct as jct

        return _analyze_all(jct, scans)


@pytest.fixture(scope="module")
def port(scans):
    return _analyze_all(tct, scans, device="cpu")


@pytest.mark.parametrize("name,case", RUNS)
def test_single_scan_matches_jax(jax_runs, port, name, case):
    assert _assert_agree(jax_runs.single[name, case], port.single[name, case]) > 100


@pytest.mark.parametrize("name,case", RUNS)
def test_results_text_matches_jax(jax_runs, port, name, case):
    assert port.text[name, case] == jax_runs.text[name, case]


@pytest.mark.parametrize("key", BATCHES)
def test_batch_matches_jax_batch(jax_runs, port, key):
    want, got = jax_runs.batch[key], port.batch[key]
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert _assert_agree(w, g) > 100


@pytest.mark.parametrize("key", BATCHES)
def test_batch_equals_single_scans(port, key):
    for name, result in zip(BATCHES[key][1], port.batch[key]):
        assert _assert_agree(port.single[name, "default"], result) > 100


def test_503_has_no_low_contrast_module(jax_runs, port):
    for runs in (jax_runs, port):
        assert runs.single["503", "default"]["ctp515"] is None
        assert "CTP515" not in runs.text["503", "default"]
        assert "CTP 404" in runs.text["503", "default"]


def test_600_without_its_vial(jax_runs, port):
    for runs in (jax_runs, port):
        with_vial = runs.single["600", "default"]["ctp404"]["hu_rois"]
        without = runs.single["600 no vial", "default"]["ctp404"]["hu_rois"]
        assert "Vial" in with_vial and "Vial" not in without
        assert list(without) == [k for k in with_vial if k != "Vial"]
        assert "Vial" not in runs.text["600 no vial", "default"]


@pytest.mark.parametrize("name", ["503", "604", "600"])
def test_non_default_arguments_take_effect(port, name):
    default, other = port.single[name, "default"], port.single[name, "non_default"]
    assert default["origin_slice"] == DEFAULT_ORIGIN[name]
    assert other["origin_slice"] == DEFAULT_ORIGIN[name] - 1
    assert other["ctp404"]["hu_tolerance"] == 10
    assert (other["ctp404"]["hu_rois"]["Air"]["stdev"]
            != default["ctp404"]["hu_rois"]["Air"]["stdev"])
    if name != "503":
        assert other["ctp515"]["roi_results"]["15"]["contrast method"] == "Weber"
        assert default["ctp515"]["roi_results"]["15"]["contrast method"] == "Michelson"


@pytest.mark.parametrize("name", SCANS)
def test_results_within_the_phantom_bars(port, name):
    """The drawn phantom's truths: plugs within 12 HU of nominal, geometry
    within 0.5 mm, slice thickness within 0.2 mm, the roll near 0, a
    uniform CTP486, the MTF's 50 % point inside the gauge's range and every
    low-contrast module seeing its largest disks."""
    r = port.single[name, "default"]
    c404 = r["ctp404"]
    assert r["catphan_model"] == SCANS[name][0]
    assert all(abs(roi["value"] - roi["nominal_value"]) < 12 for roi in c404["hu_rois"].values())
    assert c404["hu_linearity_passed"]
    assert abs(c404["avg_line_distance_mm"] - 50) < 0.5 and c404["geometry_passed"]
    assert abs(c404["measured_slice_thickness_mm"] - 2.5) < 0.2 and c404["thickness_passed"]
    assert abs(r["catphan_roll_deg"]) < 0.1
    assert r["ctp486"]["passed"]
    assert all(abs(roi["value"]) < 10 for roi in r["ctp486"]["rois"].values())
    mtf = [r["ctp528"]["mtf_lp_mm"][str(p)] for p in range(10, 100, 10)]
    assert all(a > b for a, b in zip(mtf, mtf[1:]))
    assert 0.1 < r["ctp528"]["mtf_lp_mm"]["50"] < 0.8
    if name != "503":
        assert r["ctp515"]["num_rois_seen"] >= 2


@pytest.mark.parametrize("model", ["503", "600", "604"])
def test_generator_takes_jax_geometry(model):
    """The generator's table against the JAX classes: module offsets, body
    radius, plugs (angle and HU), the 604's background ROIs, the
    resolution gauge's profile and the low-contrast disks."""
    pytest.importorskip("jax")
    from pylinac_tpu import ct as jct

    spec = tgen.CATPHAN_MODELS[model]
    cls = getattr(jct, "CatPhan" + model)
    offsets = {m.attr_name: cfg["offset"] for m, cfg in cls.modules.items()}
    assert offsets["ctp528"] == spec["ctp528"] and offsets["ctp486"] == spec["ctp486"]
    assert offsets.get("ctp515") == spec["ctp515"] and offsets["ctp404"] == 0
    assert cls.catphan_radius_mm == spec["radius"]
    c404 = next(m for m in cls.modules if m.attr_name == "ctp404")
    assert {k: (v["angle"], v["value"]) for k, v in c404.roi_settings.items()} == spec["plugs"]
    if spec["water"]:
        assert tuple(v["angle"] for v in c404.background_roi_settings.values()) == spec["water"]
    c528 = next(m for m in cls.modules if m.attr_name == "ctp528")
    assert (c528.start_angle, c528.ccw, tuple(c528.boundaries)) == spec["gauge"]
    if spec["ctp515"] is not None:
        c515 = next(m for m in cls.modules if m.attr_name == "ctp515")
        angles = [v["angle"] for v in c515.roi_settings.values()]
        np.testing.assert_allclose(angles, spec["low_contrast"], atol=1e-9)
        assert [v["radius"] for v in c515.roi_settings.values()] == list(
            tgen.LOW_CONTRAST_RADII_MM)


def test_results_data_exclude_and_by_alias_match_jax(jax_runs, port):
    """``results_data(by_alias=, exclude=)`` on the 503: the excluded
    top-level fields are gone from the dict and the JSON, the rest agrees
    with JAX at the bar, ``by_alias`` changes nothing, and asking for both
    a dict and JSON raises JAX's ValueError."""
    drop = {"pylinac_version", "date_of_analysis"}
    for ct in (jax_runs.ct503, port.ct503):
        as_dict = ct.results_data(as_dict=True, exclude=drop)
        assert not drop & set(as_dict) and "warnings" in as_dict
        assert json.loads(ct.results_data(as_json=True, exclude=drop)) == as_dict
        assert ct.results_data(as_dict=True, by_alias=True, exclude=drop) == as_dict
        with pytest.raises(ValueError, match="both dict and JSON"):
            ct.results_data(as_dict=True, as_json=True, by_alias=True, exclude=drop)
    want = jax_runs.ct503.results_data(as_dict=True, exclude=drop)
    got = port.ct503.results_data(as_dict=True, exclude=drop)
    assert list(got) == list(want)
    assert _assert_agree(want, got) > 100
    want_json = json.loads(jax_runs.ct503.results_data(as_json=True, by_alias=True,
                                                        exclude={"date_of_analysis"}))
    got_json = json.loads(port.ct503.results_data(as_json=True, by_alias=True,
                                                  exclude={"date_of_analysis"}))
    assert got_json["pylinac_version"] == want_json["pylinac_version"]
    assert _assert_agree(want_json, got_json) > 100
