"""The port's multi-target Winston-Lutz and image plugins against the JAX
package's.

Both packages analyse the same DICOM files, written by the port's
generators; the port runs on the CPU. Sessions (SID 1000, 1 mm blur):

- set C of the SNC MultiMet arrangement (6 BBs of 5 mm, 20 mm fields) on
  AS500 frames: gantry 0, 45, 135, 180, 225, 315 at couch 0 and gantry 0
  at couch 45 and 315 (at gantry 90 two of its fields merge and the JAX
  package cannot analyse the set);
- ``tests/models/test_winstonlutz.py::TestMultiTargetMultiField``'s 2-BB
  AS1200 session and its 1 mm offset copy;
- a 2-BB single open field AS500 session under non-default arguments
  (``is_open_field``, ``machine_scale``, ``snap_tolerance``). No generator
  draws a low-density BB, so ``is_low_density`` is not exercised.

Tolerance: every float of ``results_data()`` within 0.01 (mm and
degrees), integers, strings, keys and the matched BB names of each image
exact, ``results()`` equal; the field locator's points within 1e-3 px.
The generators write the same pixels and angle tags as JAX's, exactly,
without a blur layer (``GaussianFilterLayer`` computes in float64 where the
JAX layer runs in float32: a pixel may differ by one count).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy import ndimage

from pylinac_tpu_torch import BBArrangement, BBConfig, MachineScale
from pylinac_tpu_torch import WinstonLutzMultiTargetMultiField as PortMTMF
from pylinac_tpu_torch.core import dcm
from pylinac_tpu_torch.core.geometry import Point
from pylinac_tpu_torch.core.image import ArrayImage
from pylinac_tpu_torch.imggen import layers, utils
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1200Image
from pylinac_tpu_torch.metrics import image as tmi
from pylinac_tpu_torch.winston_lutz import align_points

TOL = 0.01
SET_C = ((0, 0, 0), (45, 0, 0), (135, 0, 0), (180, 0, 0), (225, 0, 0), (315, 0, 0),
         (0, 0, 45), (0, 0, 315))
TWO_BBS = ({"offset_left_mm": 0, "offset_up_mm": 0, "offset_in_mm": 0},
           {"offset_left_mm": -20, "offset_up_mm": 0, "offset_in_mm": 30})


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jwl():
    pytest.importorskip("jax")
    from pylinac_tpu import winston_lutz

    return winston_lutz


def _blur():
    return [layers.GaussianFilterLayer(sigma_mm=1)]


def _arrangement_of(offsets, names=None):
    return tuple(BBConfig(name=names[i] if names else str(i), bb_size_mm=5, rad_size_mm=20, **o)
                 for i, o in enumerate(offsets))


def _session_specs(root):
    """(directory, arrangement, analyze kwargs) of each session, written
    on first use."""
    multimet = BBArrangement.SNC_MULTIMET

    def set_c(d):
        utils.generate_winstonlutz_multi_bb_multi_field(
            AS500Image(sid=1000), layers.PerfectFieldLayer, d,
            field_offsets=[(b.offset_left_mm, b.offset_up_mm, b.offset_in_mm) for b in multimet],
            bb_offsets=[dataclasses.asdict(b) for b in multimet], image_axes=SET_C,
            final_layers=_blur())

    def two_bb(bb_offsets):
        def make(d):
            utils.generate_winstonlutz_multi_bb_multi_field(
                AS1200Image(sid=1000), layers.PerfectFieldLayer, d,
                field_offsets=[(0, 0, 0), (-20, 0, 30)], bb_offsets=bb_offsets,
                final_layers=_blur())
        return make

    def open_field(d):
        utils.generate_winstonlutz_multi_bb_single_field(
            AS500Image(sid=1000), layers.PerfectFieldLayer, d,
            offsets=[(0, 0, 0), (6, 6, -10)], field_size_mm=(40, 40), final_layers=_blur(),
            image_axes=((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0), (0, 0, 45)))

    return {
        "set_c": (set_c, multimet, {}),
        "two_bb": (two_bb(TWO_BBS), _arrangement_of(TWO_BBS), {}),
        "two_bb_offset": (two_bb([(1, 0, 0), (-19, 0, 30)]),
                          _arrangement_of(TWO_BBS, ["Iso", "1"]), {}),
        "open_field": (open_field,
                       _arrangement_of([{"offset_left_mm": 0, "offset_up_mm": 0, "offset_in_mm": 0},
                                        {"offset_left_mm": 6, "offset_up_mm": 6,
                                         "offset_in_mm": -10}]),
                       {"is_open_field": True, "machine_scale": "VARIAN_IEC",
                        "snap_tolerance": 5}),
    }


@pytest.fixture(scope="module")
def analysed(tmp_path_factory, jwl):
    """(port, JAX) analyses of a session, computed once."""
    root = tmp_path_factory.mktemp("mtmf")
    specs = _session_specs(root)
    cache = {}

    def get(name):
        if name not in cache:
            make, arrangement, kwargs = specs[name]
            d = str(root / name)
            make(d)
            scale = kwargs.get("machine_scale", "IEC61217")
            args = {**kwargs, "machine_scale": MachineScale[scale]}
            port = PortMTMF(d)
            port.analyze(arrangement, device="cpu", **args)
            ref = jwl.WinstonLutzMultiTargetMultiField(d)
            ref.analyze(tuple(jwl.BBConfig(**dataclasses.asdict(b)) for b in arrangement),
                        **{**args, "machine_scale": jwl.MachineScale[scale]})
            cache[name] = (port, ref)
        return cache[name]

    return get


def assert_same(port, ref, path: str = "") -> None:
    """Keys, types, integers and strings exact; floats within TOL."""
    if isinstance(ref, dict):
        assert list(port) == list(ref), path
        for key in ref:
            if key != "date_of_analysis":
                assert_same(port[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert type(port) is type(ref), (path, port, ref)
        if isinstance(ref, float):
            assert abs(port - ref) <= TOL, (path, port, ref)
        else:
            assert port == ref, (path, port, ref)


@pytest.mark.parametrize("name", ["set_c", "two_bb", "two_bb_offset", "open_field"])
def test_session_matches_jax(analysed, name):
    port, ref = analysed(name)
    assert_same(port.results_data(as_dict=True), ref.results_data(as_dict=True))
    assert port.results() == ref.results()
    assert port.bb_shift_instructions() == ref.bb_shift_instructions()
    for a, b in zip(port.images, ref.images):
        assert list(a.arrangement_matches) == list(b.arrangement_matches)
    assert [bb.bb_config.name for bb in port.bbs] == [bb.bb_config.name for bb in ref.bbs]


def test_set_c_locator_points_match_jax(analysed):
    """Every frame's ``GlobalSizedFieldLocator`` fields, in their order."""
    port, ref = analysed("set_c")
    for a, b in zip(port.images, ref.images):
        pa, pb = a.metrics[0].fields, b.metrics[0].fields
        assert len(pa) == len(pb) == 6
        for p, q in zip(pa, pb):
            assert abs(p.x - q.x) <= 1e-3 and abs(p.y - q.y) <= 1e-3


def test_set_c_inside_the_bars(analysed):
    """All 6 BBs matched in all 8 frames; ``test_perfect_set_zero_error``'s
    bar of 0.3 mm at AS1200 (0.9 px at 2.976 px/mm) taken as 0.9 px at
    AS500's 1.28 px/mm; the phantom needs no shift or rotation."""
    port, _ = analysed("set_c")
    assert all(len(img.arrangement_matches) == 6 for img in port.images)
    data = port.results_data()
    assert data.max_2d_field_to_bb_mm < 0.9 / 1.28
    assert data.bb_arrangement == BBArrangement.SNC_MULTIMET
    assert all(abs(v) < 0.1 for v in data.bb_shift_vector.values())
    assert all(abs(a) < 0.1 for a in (data.bb_shift_yaw, data.bb_shift_pitch,
                                      data.bb_shift_roll))
    dumped = data.model_dump()
    assert dumped["bb_arrangement"][2]["name"] == "2"
    assert list(dumped["bb_maxes"]) == ["Iso", "1", "2", "3", "4", "5"]


def test_offset_session_bars(analysed):
    """``test_offset_bb_detected``: every BB 1 mm left of its field."""
    port, _ = analysed("two_bb_offset")
    data = port.results_data()
    assert abs(data.max_2d_field_to_bb_mm - 1.0) < 0.3
    assert abs(abs(data.bb_shift_vector["x"]) - 1.0) < 0.3


# --- the generators ----------------------------------------------------------
def _files(d):
    return {f: dcm.dcmread(os.path.join(d, f)) for f in sorted(os.listdir(d))}


GENERATORS = {
    "multi_field": ("generate_winstonlutz_multi_bb_multi_field", "PerfectFieldLayer",
                    dict(field_offsets=[(0, 0, 0), (-20, 0, 30)],
                         bb_offsets=[(0, 0, 0), {"offset_left_mm": -19, "offset_up_mm": 1,
                                                 "offset_in_mm": 30}],
                         jitter_mm=0.5, gantry_tilt=0.5, gantry_sag=1)),
    "single_field": ("generate_winstonlutz_multi_bb_single_field", "FilterFreeFieldLayer",
                     dict(offsets=[(0, 0, 0), {"offset_left_mm": 5, "offset_up_mm": 0,
                                               "offset_in_mm": -5}],
                          jitter_mm=1, gantry_tilt=1, gantry_sag=2)),
    "cone": ("generate_winstonlutz_cone", "FilterFreeConeLayer",
             dict(offset_mm_left=1, offset_mm_in=-0.5, gantry_sag=1)),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_matches_jax(tmp_path, name):
    pytest.importorskip("jax")
    from pylinac_tpu.imggen import layers as jlayers
    from pylinac_tpu.imggen import simulators as jsims
    from pylinac_tpu.imggen import utils as jutils

    func, layer, kwargs = GENERATORS[name]
    axes = ((0, 0, 0), (45, 0, 315), (270, 0, 45))
    getattr(utils, func)(AS500Image(sid=1000), getattr(layers, layer), str(tmp_path / "t"),
                         image_axes=axes, **kwargs)
    getattr(jutils, func)(jsims.AS500Image(sid=1000), getattr(jlayers, layer),
                          str(tmp_path / "j"), image_axes=axes, **kwargs)
    port, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert list(port) == list(ref) and len(port) == 3
    for f in port:
        np.testing.assert_array_equal(port[f].pixel_array, ref[f].pixel_array)
        for tag in ("GantryAngle", "BeamLimitingDeviceAngle", "PatientSupportAngle"):
            assert getattr(port[f], tag) == getattr(ref[f], tag)


def test_pixel_align_and_offsets_match_jax():
    import random

    from pylinac_tpu.imggen import utils as jutils

    for size, length in ((0.392, 12.3), (0.336, -7.77), (0.784, 0.1)):
        assert utils.pixel_align(size, length) == jutils.pixel_align(size, length)
    a, b = random.Random(7), random.Random(7)
    for offset in ([1, 2, 3], {"offset_left_mm": -4, "offset_up_mm": 0, "offset_in_mm": 2}):
        assert utils._bb_offset_lui(offset, a, 0.7) == jutils._bb_offset_lui(offset, b, 0.7)


# --- geometry ----------------------------------------------------------------
def test_align_points_matches_jax(jwl):
    from pylinac_tpu.core.geometry import Point as JPoint

    rng = np.random.default_rng(5)
    ideal = rng.uniform(-50, 50, (6, 3))
    angle = np.deg2rad(1.5)
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1]])
    measured = ideal @ rot.T + [0.4, -0.2, 0.7] + rng.normal(0, 0.05, (6, 3))
    v, yaw, pitch, roll = align_points([Point(*p) for p in measured],
                                       [Point(*p) for p in ideal])
    jv, jyaw, jpitch, jroll = jwl.align_points([JPoint(*p) for p in measured],
                                               [JPoint(*p) for p in ideal])
    assert (v.x, v.y, v.z, yaw, pitch, roll) == (jv.x, jv.y, jv.z, jyaw, jpitch, jroll)
    assert abs(yaw + 1.5) < 0.2
    from pylinac_tpu_torch import winston_lutz as twl

    assert twl.conventional_to_euler_notation("roll,pitch,yaw") == "yxz"
    with pytest.raises(ValueError, match="Unsupported"):
        twl._euler_extrinsic_decompose(np.eye(3), "xyz")
    lines = [twl.straight_ray(twl.Vector(0.5, -0.2), g) for g in (0, 90, 180)]
    jlines = [jwl.straight_ray(jwl.Vector(0.5, -0.2), g) for g in (0, 90, 180)]
    assert (twl.max_distance_to_lines((0.1, 0.2, -0.3), lines)
            == jwl.max_distance_to_lines((0.1, 0.2, -0.3), jlines))
    arrangement = dataclasses.asdict(BBArrangement.SNC_MULTIMET[4])
    assert BBArrangement.to_human(arrangement) == jwl.BBArrangement.to_human(arrangement)


# --- the other plugins on small images ---------------------------------------
def _bb_array(h=300, w=300, bbs=((150, 150),), bb_radius_px=8):
    """``tests/core/test_metrics.py``'s field with attenuating BBs."""
    yy, xx = np.mgrid[:h, :w]
    img = np.full((h, w), 1000.0)
    for (cy, cx) in bbs:
        img -= 400 * (((yy - cy) ** 2 + (xx - cx) ** 2) < bb_radius_px ** 2)
    return img + np.random.default_rng(0).normal(0, 5, (h, w))


def _fields_array(centres=((80, 80), (80, 210), (200, 150)), half=30):
    """Fields of 2 * ``half`` px, blurred (sigma 1.5 px)."""
    img = np.zeros((300, 300))
    for cy, cx in centres:
        img[cy - half:cy + half, cx - half:cx + half] = 1000.0
    return ndimage.gaussian_filter(img, 1.5).astype(np.float32)


def _both(arr, dpmm, make_metric):
    from pylinac_tpu.core.image import ArrayImage as JArrayImage
    from pylinac_tpu.metrics import image as jmi

    port = ArrayImage(arr.copy(), dpi=dpmm * 25.4).compute(make_metric(tmi, cpu=True))
    ref = JArrayImage(arr.copy(), dpi=dpmm * 25.4).compute(make_metric(jmi, cpu=False))
    return port, ref


def _assert_points(port, ref, tol=1e-3):
    assert len(port) == len(ref)
    for p, q in zip(port, ref):
        assert abs(p.x - q.x) <= tol and abs(p.y - q.y) <= tol


def _device(cpu):
    return {"device": "cpu"} if cpu else {}


@pytest.mark.parametrize("case", ["one", "three"])
def test_global_field_locators_match_jax(case):
    pytest.importorskip("jax")
    if case == "one":
        arr = _fields_array(centres=((150, 150),))
        port, ref = _both(arr, 2.0, lambda m, cpu: m.GlobalSizedFieldLocator.from_physical(
            field_width_mm=30, field_height_mm=30, field_tolerance_mm=5, max_number=1,
            **_device(cpu)))
        assert len(port) == 1 and abs(port[0].x - 149.5) < 1.5
    else:
        arr = _fields_array()
        port, ref = _both(arr, 2.0, lambda m, cpu: m.GlobalFieldLocator(
            max_number=3, **_device(cpu)))
        assert len(port) == 3
    _assert_points(port, ref)
    with pytest.raises(NotImplementedError):
        tmi.GlobalFieldLocator.from_physical()


def test_field_locator_raises_below_min_number():
    img = ArrayImage(_fields_array(centres=((30, 30),), half=10)[:60, :60], dpi=2.0 * 25.4)
    with pytest.raises(ValueError, match="minimum number of fields"):
        img.compute(tmi.GlobalSizedFieldLocator.from_physical(
            field_width_mm=10, field_height_mm=10, field_tolerance_mm=2, min_number=2,
            device="cpu"))


@pytest.mark.parametrize("bbs", [((150, 150),), ((60, 60), (60, 240), (230, 150))])
def test_global_disk_locator_matches_jax(bbs):
    pytest.importorskip("jax")
    port, ref = _both(_bb_array(bbs=bbs), 2.0, lambda m, cpu: m.GlobalSizedDiskLocator(
        radius_mm=4, radius_tolerance_mm=2, min_number=len(bbs), max_number=len(bbs),
        **_device(cpu)))
    _assert_points(port, ref)
    assert sorted((round(p.y), round(p.x)) for p in port) == sorted(bbs)


def test_roi_metrics_and_weighted_centroid_match_jax():
    pytest.importorskip("jax")
    from pylinac_tpu.core.geometry import Point as JPoint

    arr = _bb_array(bbs=((150, 150), (60, 200)))

    def point(m, x, y):
        return Point(x, y) if m is tmi else JPoint(x, y)

    for make in (lambda m, cpu: m.DiskROIMetric(radius=10, center=point(m, 150, 150)),
                 lambda m, cpu: m.DiskROIMetric.from_physical(radius_mm=6,
                                                              center_mm=point(m, 30, 100)),
                 lambda m, cpu: m.RectangleROIMetric(width=20, height=12,
                                                     center=point(m, 200, 60)),
                 lambda m, cpu: m.RectangleROIMetric.from_physical(
                     width_mm=10, height_mm=8, center_mm=point(m, 75, 75))):
        port, ref = _both(arr, 2.0, make)
        assert port.mean == ref.mean and port.std == ref.std
    port, ref = _both(arr, 2.0, lambda m, cpu: m.WeightedCentroid())
    assert (port.x, port.y) == (ref.x, ref.y)
    blank = ArrayImage(np.zeros((20, 20)))
    with pytest.raises(ValueError, match="blank"):
        blank.compute(tmi.WeightedCentroid())
