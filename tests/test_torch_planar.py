"""The port's planar imaging phantoms against the JAX package's, on the CPU:
the SI QC-3 with automatic detection (Canny, ``keep_largest``,
``regionprops`` and the SID search of ``_find_ssd``) and the light/rad
FC-2 (the frame's 3x3 medians, the strip profiles, the high-pass of the
BBs near the field edge and the BB windows), each with non-default
``analyze`` arguments; the override conflicts' errors; the ROI tables of
all 19 classes; the hysteresis inputs a CUDA run hands ``ccl.cu``.

Both packages read the same DICOM files, drawn by the JAX tests' recipes
(``tests/models/test_planar_imaging.py``) with the port's generators
(:func:`draw_qc3` is that file's ``_make_qc3_image``, pixel-equal to it;
the port's ``GaussianFilterLayer`` blurs in float64 where JAX's ran in
float32, so a light/rad frame may differ from JAX's generator by one
count at some pixels). ``results_data()`` is compared
as the JSON-compatible dict without its date and version: strings, keys,
integers and warnings (message, category) exactly, and every float to
the bit (the bar is mm 0.01, % 0.1, contrast and rMTF 0.1 %, px 1e-3; the
port meets them exactly on these images). The classes' ROI lists are
class attributes shared between instances, as in JAX, so each (class,
image, arguments) is analysed once in this module and its results taken
at once. The ``cuda`` tests run the QC-3 and the FC-2 on a card against
the CPU at the bars (:func:`card_agrees`): ``python -m pytest --noconftest -m cuda tests/test_torch_planar.py``.
The long-tail classes and the FC-2 variants are in
``test_torch_planar_longtail.py``, the mammography phantom in
``test_torch_planar_mammo.py``.
"""

import inspect
import json
import warnings

import numpy as np
import pytest
import torch

import pylinac_tpu_torch.planar_imaging as tp
from pylinac_tpu_torch.imggen.layers import ArrayLayer, GaussianFilterLayer
from pylinac_tpu_torch.imggen.simulators import AS1000Image
from pylinac_tpu_torch.imggen.utils import generate_lightrad


def _draw_disk(arr, cy, cx, radius, value):
    h, w = arr.shape
    yy, xx = np.mgrid[:h, :w]
    arr[(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = value


def draw_qc3(path, angle_sign=1, sim=None):
    """A QC-3-like phantom on an AS1000 frame (or ``sim``'s): a rectangle
    rotated 45 degrees whose bbox matches the class's size, contrast disks
    and high-contrast stripes at the class's own ROI positions."""
    sim = AS1000Image(sid=1000) if sim is None else sim
    h, w = sim.shape
    dpmm = 1 / sim.pixel_size
    arr = np.zeros((h, w), np.float64)
    cy, cx = h / 2, w / 2
    target_bbox_side = 168 * dpmm
    b = target_bbox_side * np.sqrt(2) / 2.25
    a = 1.25 * b
    theta = np.deg2rad(45 * angle_sign)
    yy, xx = np.mgrid[:h, :w]
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    arr[(np.abs(u) <= a / 2) & (np.abs(v) <= b / 2)] = 500.0
    radius = target_bbox_side * 0.0896
    phantom_angle = 45 * angle_sign
    for stng in tp.StandardImagingQC3.low_contrast_roi_settings.values():
        ang = np.deg2rad(phantom_angle + stng["angle"])
        dist = radius * stng["distance from center"]
        _draw_disk(arr, cy + np.sin(ang) * dist, cx + np.cos(ang) * dist,
                   radius * stng["roi radius"], 560.0)
    for amp, stng in zip([200, 150, 100, 60, 30],
                         tp.StandardImagingQC3.high_contrast_roi_settings.values()):
        ang = np.deg2rad(phantom_angle + stng["angle"])
        dist = radius * stng["distance from center"]
        dcy, dcx = cy + np.sin(ang) * dist, cx + np.cos(ang) * dist
        mask = (yy - dcy) ** 2 + (xx - dcx) ** 2 <= (radius * stng["roi radius"]) ** 2
        stripes = np.where((xx // 3) % 2 == 0, 500 + amp, 500 - amp)
        arr[mask] = stripes[mask]
    rng = np.random.default_rng(42)
    arr += rng.normal(0, 2, arr.shape)
    sim.add_layer(ArrayLayer((arr.clip(0) * 40).astype(np.uint16)))
    sim.generate_dicom(path)
    return path


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jp():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pylinac_tpu.planar_imaging as jp

    return jp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("planar")
    out = {"qc3": draw_qc3(str(d / "qc3.dcm")),
           "qc3_neg": draw_qc3(str(d / "qc3_neg.dcm"), angle_sign=-1)}
    for name, field, bb in (("fc2", (100, 100), ((-40, -40), (-40, 40), (40, -40), (40, 40))),
                            ("fc2_15", (150, 150), ((-65, -65), (-65, 65), (65, -65), (65, 65)))):
        out[name] = str(d / f"{name}.dcm")
        generate_lightrad(AS1000Image(sid=1000), file_out=out[name], field_size_mm=field,
                          bb_size_mm=4, bb_positions=bb,
                          final_layers=[GaussianFilterLayer(sigma_mm=1)])
    return out


def _data(obj) -> dict:
    d = obj.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return d


def _run(cls, path, device=None, **analyze):
    """Analyse and take the results at once (the ROI lists are shared)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = cls(path)
        if device is None:
            obj.analyze(**analyze)
        else:
            obj.analyze(device=device, **analyze)
        data, text = _data(obj), obj.results()
    return obj, data, text, [(str(w.message), w.category.__name__) for w in caught]


def card_agrees(card, cpu, path=""):
    """Card against CPU at the bars: integers, strings and scores exact; mm
    within 0.01, % within 0.1, contrast, CNR and rMTF within 0.1 %, px
    (and degrees) within 1e-3. The region sums add in another order on
    each device (float64 one-hot products on the card), so sub-pixel
    centroids may differ in their last bits."""
    if isinstance(cpu, dict):
        assert list(card) == list(cpu), path
        for k in cpu:
            card_agrees(card[k], cpu[k], f"{path}/{k}")
    elif isinstance(cpu, (list, tuple)):
        assert len(card) == len(cpu), path
        for i, (a, b) in enumerate(zip(card, cpu)):
            card_agrees(a, b, f"{path}[{i}]")
    elif isinstance(cpu, float):
        key = path.rsplit("/", 1)[-1].lower()
        tol = (0.01 if "mm" in key else 0.1 if "percent" in key or "%" in key
               else 1e-3 * abs(cpu) if "contrast" in key or "cnr" in key or "mtf" in path
               else 1e-3)
        assert card == pytest.approx(cpu, abs=tol), path
    else:
        assert card == cpu, path


_SAME = {}


def _assert_same(jp, name, path, **analyze):
    key = (name, path, repr(sorted(analyze.items())))
    if key not in _SAME:
        _, jd, jtext, jwarn = _run(getattr(jp, name), path, **analyze)
        t, td, ttext, twarn = _run(getattr(tp, name), path, device="cpu", **analyze)
        assert json.dumps(td) == json.dumps(jd)
        assert ttext == jtext
        assert twarn == jwarn
        _SAME[key] = (t, td)
    return _SAME[key]


QC3_CASES = [
    ("qc3", {}),
    ("qc3_neg", {}),
    ("qc3", {"low_contrast_method": "Weber", "visibility_threshold": 50,
             "low_contrast_threshold": 0.1, "high_contrast_threshold": 0.3}),
    ("qc3", {"ssd": 1000, "x_adjustment": 1.5, "y_adjustment": -1.0, "angle_adjustment": 1.0}),
    ("qc3", {"roi_size_factor": 0.8, "scaling_factor": 1.03, "invert": True}),
    ("qc3", {"angle_override": 44.0, "center_override": (512.0, 384.0), "size_override": 14.0}),
]


@pytest.mark.parametrize("image,analyze", QC3_CASES)
def test_qc3_matches_jax(jp, images, image, analyze):
    t, td = _assert_same(jp, "StandardImagingQC3", images[image], **analyze)
    assert td["analysis_type"] == "SI QC-3" and len(td["low_contrast_rois"]) == 5
    assert type(t.results_data()).__name__ == "PlanarResult"


def test_qc3_meets_the_drawn_phantom(jp, images):
    """``tests/models/test_planar_imaging.py``'s bars: the angle, the
    centre, five disks seen, a declining MTF."""
    t, td = _assert_same(jp, "StandardImagingQC3", images["qc3"])
    assert t.phantom_angle == pytest.approx(45, abs=0.1)
    assert t.phantom_center.x == pytest.approx(t.image.shape[1] / 2, abs=5)
    assert t.phantom_center.y == pytest.approx(t.image.shape[0] / 2, abs=5)
    assert td["num_contrast_rois_seen"] == 5 and td["median_contrast"] > 0.01
    mtfs = list(t.mtf.norm_mtfs.values())
    assert mtfs[0] == pytest.approx(1.0) and mtfs[-1] < mtfs[0]
    neg, _ = _assert_same(jp, "StandardImagingQC3", images["qc3_neg"])
    assert neg.phantom_angle == pytest.approx(-45, abs=0.1)


FC2_CASES = [
    ("fc2", {}),
    ("fc2_15", {"fwxm": 60}),
    ("fc2", {"bb_edge_threshold_mm": 15}),
    ("fc2", {"bb_edge_threshold_mm": 15, "kernel_size_multiplier": 3.0, "fwxm": 40}),
]


@pytest.mark.parametrize("image,analyze", FC2_CASES)
def test_fc2_matches_jax(jp, images, image, analyze):
    t, td = _assert_same(jp, "StandardImagingFC2", images[image], **analyze)
    assert type(t.results_data()).__name__ == "LightRadResult"
    assert td["field_size_x_mm"] == pytest.approx(image == "fc2" and 100 or 150, abs=1.5)
    assert abs(td["field_epid_offset_x_mm"]) < 0.5 and abs(td["field_epid_offset_y_mm"]) < 0.5
    assert abs(td["field_bb_offset_x_mm"]) < 1.0 and abs(td["field_bb_offset_y_mm"]) < 1.0


def test_fc2_high_pass_path_is_taken(jp, images):
    """At a 15 mm edge threshold every BB of the 100 mm field is near the
    edge, so each goes through the high-pass and a second median."""
    t, _ = _assert_same(jp, "StandardImagingFC2", images["fc2"], bb_edge_threshold_mm=15)
    assert all(t._is_bb_near_edge(p) for p in t.bb_positions_10x10.values())


def test_override_conflicts_raise_as_in_jax(jp, images):
    for pkg, kw in ((jp, {}), (tp, {"device": "cpu"})):
        obj = pkg.StandardImagingQC3(images["qc3"])
        for bad, match in (({"center_override": (10, 10), "x_adjustment": 1}, "overrides and adjustments"),
                           ({"angle_override": 45, "angle_adjustment": 2}, "angle override"),
                           ({"size_override": 100, "scaling_factor": 1.2}, "size override"),
                           ({"roi_size_factor": 0}, "must be positive"),
                           ({"scaling_factor": -1}, "must be positive")):
            with pytest.raises(ValueError, match=match):
                obj.analyze(**bad, **kw)


def test_not_found_raises_as_in_jax(jp, tmp_path):
    from pylinac_tpu_torch.imggen.layers import ArrayLayer

    sim = AS1000Image(sid=1000)
    rng = np.random.default_rng(0)
    sim.add_layer(ArrayLayer(rng.normal(1000, 5, sim.shape).astype(np.uint16)))
    path = str(tmp_path / "empty.dcm")
    sim.generate_dicom(path)
    for pkg, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Unable to find the phantom"):
            pkg.StandardImagingQC3(path).analyze(**kw)


def test_not_analyzed_and_reports(jp, images):
    from pylinac_tpu_torch.core.exceptions import NotAnalyzed

    obj = tp.StandardImagingQC3(images["qc3"])
    with pytest.raises(NotAnalyzed):
        obj.results_data()
    with pytest.raises(NotAnalyzed):
        tp.StandardImagingFC2(images["fc2"]).results_data()
    # the reports of an unanalysed phantom raise as JAX's do; the plots
    # search for the phantom first, on the default device (CUDA)
    with pytest.raises(NotAnalyzed):
        obj._quaac_datapoints()
    with pytest.raises(ValueError, match="filename"):
        obj.save_analyzed_image()
    with pytest.raises(TypeError):
        obj.publish_pdf()
    if not torch.cuda.is_available():
        for name in ("plot_analyzed_image", "plotly_analyzed_images"):
            with pytest.raises(RuntimeError, match="CUDA"):
                getattr(obj, name)(show=False)


def _settings(cls):
    names = ("high_contrast_roi_settings", "low_contrast_roi_settings",
             "low_contrast_background_roi_settings", "phantom_outline_object",
             "detection_canny_settings", "roi_match_condition", "common_name",
             "phantom_bbox_size_mm2", "low_contrast_background_value",
             "speck_group_roi_settings", "speck_roi_settings", "fibers_roi_settings",
             "bb_positions_10x10", "bb_positions_15x15", "bb_positions", "center_only_bb",
             "bb_sampling_box_size_mm", "field_strip_width_mm", "bb_size_mm", "_demo_filename")
    out = {n: getattr(cls, n) for n in names if hasattr(cls, n)}
    out["detection_conditions"] = [f.__name__ for f in getattr(cls, "detection_conditions", [])]
    return out


def test_roi_tables_of_all_19_classes_equal_jax(jp):
    def public(pkg):
        base = pkg.ImagePhantomBase
        return sorted(n for n, c in inspect.getmembers(pkg, inspect.isclass)
                      if issubclass(c, base) and c is not base and c.__module__ == pkg.__name__)

    names = public(jp)
    assert names == public(tp) and len(names) == 19
    for name in names:
        assert _settings(getattr(tp, name)) == _settings(getattr(jp, name)), name
        tw = getattr(tp, name).__dict__.get("analyze")
        jw = getattr(jp, name).__dict__.get("analyze")
        assert (tw is None) == (jw is None), name
        if jw is not None:
            assert getattr(tw, "__wrapped_for_warnings__", False) == \
                getattr(jw, "__wrapped_for_warnings__", False), name
    import pylinac_tpu_torch as pkg

    assert all(hasattr(pkg, n) for n in names)


def test_drawings_match_jax(jp, images, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.layers import GaussianFilterLayer as JGauss
    from pylinac_tpu.imggen.simulators import AS1000Image as JAS1000
    from pylinac_tpu.imggen.utils import generate_lightrad as jlightrad
    from tests.models.test_planar_imaging import _make_qc3_image

    from pylinac_tpu_torch.core import dcm as tdcm

    _make_qc3_image(str(tmp_path / "qc3.dcm"))
    jlightrad(JAS1000(sid=1000), file_out=str(tmp_path / "fc2.dcm"), field_size_mm=(100, 100),
              bb_size_mm=4, bb_positions=((-40, -40), (-40, 40), (40, -40), (40, 40)),
              final_layers=[JGauss(sigma_mm=1)])
    np.testing.assert_array_equal(tdcm.dcmread(images["qc3"]).pixel_array,
                                  jdcm.dcmread(str(tmp_path / "qc3.dcm")).pixel_array)
    t = tdcm.dcmread(images["fc2"]).pixel_array.astype(int)
    j = jdcm.dcmread(str(tmp_path / "fc2.dcm")).pixel_array.astype(int)
    assert np.abs(t - j).max() <= 1 and (t != j).mean() < 1e-3


def test_helpers_match_jax(jp):
    for mx, mn in ((100, 100), (110, 90), (0, 0)):
        assert tp.percent_integral_uniformity(mx, mn) == jp.percent_integral_uniformity(mx, mn)


def test_hysteresis_inputs_of_a_run(jp, images, monkeypatch):
    """Every mask the QC-3 run hands the CCL entries is held to the twins
    (on the CPU the wrapper takes the twin, so this records the shapes and
    connectivities a card run launches: the Canny hysteresis and
    ``keep_largest`` 8-connected at (1, 768, 1024), ``regionprops`` label
    and holes)."""
    from pylinac_tpu_torch.ops import ccl

    seen = []
    label, holes = ccl.label_batch, ccl.hole_roots_batch

    def rec_label(masks, connectivity=1):
        seen.append(("label", tuple(masks.shape), connectivity))
        return label(masks, connectivity)

    def rec_holes(masks):
        seen.append(("holes", tuple(masks.shape), None))
        return holes(masks)

    import pylinac_tpu_torch.ops.edges as edges
    import pylinac_tpu_torch.ops.label as tlabel

    monkeypatch.setattr(edges, "label_batch", rec_label)
    monkeypatch.setattr(tlabel, "label_batch", rec_label)
    monkeypatch.setattr(tlabel, "hole_roots_batch", rec_holes)
    obj = tp.StandardImagingQC3(images["qc3"])
    obj.analyze(device="cpu")
    assert ("label", (1, 768, 1024), 2) in seen and ("holes", (1, 768, 1024), None) in seen
    assert sum(k == "label" for k, _, _ in seen) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name,image,analyze", [
    ("StandardImagingQC3", "qc3", {}),
    ("StandardImagingFC2", "fc2", {"bb_edge_threshold_mm": 15})])
def test_card_matches_cpu(cuda, images, name, image, analyze):
    from pylinac_tpu_torch.ops import ccl, median

    l0, m0 = ccl.label_batch.launches, median.median3x3.launches
    _, cd, ctext, cwarn = _run(getattr(tp, name), images[image], device="cuda", **analyze)
    _, hd, htext, hwarn = _run(getattr(tp, name), images[image], device="cpu", **analyze)
    card_agrees(cd, hd)
    assert cwarn == hwarn
    if name == "StandardImagingQC3":  # the FC-2 text rounds offsets of +-1e-6 mm to +-0.0
        assert ctext == htext
    assert ccl.label_batch.launches > l0
    if name == "StandardImagingFC2":
        assert median.median3x3.launches > m0
