"""The port's QA plan generation against the JAX package's, on the CPU.

Both packages start from one template plan, the JAX tests' own
(``tests/models/test_plan_generator.py::make_template_plan``), written once
and read by each package's ``dcmread``. With the UID source and the clock
frozen to the same values in both, every beam recipe gives byte-equal plan
files; the MLC shapes give equal control points and metersets; the same
misuse raises the same error with the same message. The fluence maps are
bit-equal in float32 and uint16 (TrueBeam, HD and Halcyon). JAX's HD120
boundary list is a fault (53 pairs against the beam's 60, ROADMAP section
3): the HD cases give JAX the port's corrected list, and one test pins
JAX's own list and its HD fluence's error. A plan
rendered by ``to_dicom_images`` gives an equal frame, and the port's
``PicketFence`` on that frame equals JAX's. The ``cuda`` test holds the
card's maps equal to the CPU's:
``python -m pytest --noconftest -m cuda tests/test_torch_plan_generator.py``.
"""

import datetime
import io
import itertools

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import plan_generator as tpg
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.core import utilities as tutil
from pylinac_tpu_torch.plan_generator import dicom as tdicom
from pylinac_tpu_torch.plan_generator import mlc as tmlc


class _FrozenClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 6, 7, 8, 9)


class _FrozenDatetimeModule:
    datetime = _FrozenClock


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pylinac_tpu import plan_generator as jpg
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.core import utilities as jutil
    from pylinac_tpu.plan_generator import dicom as jdicom
    from pylinac_tpu.plan_generator import mlc as jmlc
    from tests.models.test_plan_generator import make_template_plan

    return {"pg": jpg, "dcm": jdcm, "dicom": jdicom, "mlc": jmlc, "util": jutil,
            "template": make_template_plan}


@pytest.fixture(autouse=True)
def hd_fixed(jax_side, monkeypatch):
    """JAX's HD120 boundaries with the port's correction (60 pairs; ROADMAP
    section 3), so that both packages' HD plans can be compared."""
    monkeypatch.setattr(jax_side["dicom"], "MLC_120HDMIL_BOUNDARIES",
                        tdicom.MLC_120HDMIL_BOUNDARIES)


@pytest.fixture
def frozen(jax_side, monkeypatch):
    """Both packages' plan UIDs and clock at the same fixed values."""
    for mod in (tdicom, jax_side["dicom"]):
        counter = itertools.count()
        monkeypatch.setattr(mod, "generate_uid", lambda c=counter: f"1.2.826.0.1.{next(c)}")
        monkeypatch.setattr(mod, "datetime", _FrozenDatetimeModule)


def _template_bytes(jax_side, machine="truebeam", hd=False) -> bytes:
    ds = jax_side["template"](machine)
    if hd:
        ds.BeamSequence[0].BeamLimitingDeviceSequence[0].LeafPositionBoundaries = \
            tdicom.MLC_120HDMIL_BOUNDARIES
    buf = io.BytesIO()
    jax_side["dcm"].dcmwrite(buf, ds)
    return buf.getvalue()


def _generators(jax_side, machine="truebeam", hd=False, **kwargs):
    """(port generator, JAX generator) on the same template bytes."""
    raw = _template_bytes(jax_side, machine, hd)
    cls = "TrueBeamPlanGenerator" if machine == "truebeam" else "HalcyonPlanGenerator"
    kwargs = {"plan_label": "QA", "plan_name": "QA Plan", **kwargs}
    return (getattr(tpg, cls)(tdcm.dcmread(raw), **kwargs),
            getattr(jax_side["pg"], cls)(jax_side["dcm"].dcmread(raw), **kwargs))


def _plan_bytes(gen) -> bytes:
    buf = io.BytesIO()
    gen.to_file(buf)
    return buf.getvalue()


def _outcome(fn):
    """The value of ``fn()``, or the name and message of what it raised."""
    try:
        return fn()
    except (ValueError, NotImplementedError, KeyError, TypeError) as e:
        return ("raised", type(e).__name__, str(e))


# every beam factory with arguments other than its defaults; each recipe
# takes the package's plan_generator module (its own enums)
BEAM_CASES = {
    "defaults": ("truebeam", lambda g, m: (
        g.add_picketfence_beam(), g.add_mlc_transmission(bank="A"),
        g.add_mlc_transmission(bank="B"), g.add_dose_rate_beams(), g.add_mlc_speed_beams(),
        g.add_winston_lutz_beams(), g.add_gantry_speed_beams(),
        g.add_open_field_beam(x1=-50, x2=50, y1=-50, y2=50))),
    "picket_fence": ("truebeam", lambda g, m: g.add_picketfence_beam(
        strip_width_mm=2, strip_positions_mm=(-60, -30, 0, 30, 60), y1=-80, y2=90,
        fluence_mode=m.FluenceMode.FFF, dose_rate=1400, energy=10, gantry_angle=90,
        coll_angle=45, couch_vrt=-5, couch_lng=900, couch_lat=3, couch_rot=10, mu=150,
        jaw_padding_mm=8, beam_name="PF2", max_sacrificial_move_mm=40)),
    "mlc_transmission": ("truebeam", lambda g, m: g.add_mlc_transmission(
        bank="B", mu=40, overreach=5, beam_name="Tx", energy=15, dose_rate=400, x1=-40,
        x2=60, y1=-90, y2=80, gantry_angle=180, coll_angle=90, couch_vrt=2, couch_lat=-1,
        couch_lng=950, couch_rot=5, fluence_mode=m.FluenceMode.SRS)),
    "dose_rate": ("truebeam", lambda g, m: g.add_dose_rate_beams(
        dose_rates=(200, 400, 600), default_dose_rate=500, gantry_angle=270, desired_mu=60,
        energy=10, fluence_mode=m.FluenceMode.SRS, coll_angle=10, couch_vrt=1, couch_lat=2,
        couch_lng=990, couch_rot=3, jaw_padding_mm=3, roi_size_mm=30, y1=-70, y2=70,
        max_sacrificial_move_mm=30)),
    "mlc_speed": ("truebeam", lambda g, m: g.add_mlc_speed_beams(
        speeds=(4, 8, 12, 16, 24), roi_size_mm=15, mu=80, default_dose_rate=400,
        gantry_angle=45, energy=6, coll_angle=5, couch_vrt=0.5, couch_lat=0.5, couch_lng=980,
        couch_rot=1, fluence_mode=m.FluenceMode.FFF, jaw_padding_mm=4, y1=-60, y2=60,
        beam_name="MLCS", max_sacrificial_move_mm=35)),
    "winston_lutz": ("truebeam", lambda g, m: g.add_winston_lutz_beams(
        x1=-15, x2=12, y1=-14, y2=16, defined_by_mlcs=False, energy=10,
        fluence_mode=m.FluenceMode.FFF, dose_rate=800,
        axes_positions=({"gantry": 0, "collimator": 0, "couch": 0},
                        {"gantry": 270, "collimator": 30, "couch": 45},
                        {"gantry": 90.5, "collimator": 0, "couch": 315, "name": "Custom"}),
        couch_vrt=-2, couch_lng=1010, couch_lat=1, mu=12, padding_mm=4)),
    "gantry_speed": ("truebeam", lambda g, m: g.add_gantry_speed_beams(
        speeds=(1, 2, 3), max_dose_rate=480, start_gantry_angle=170, energy=10,
        fluence_mode=m.FluenceMode.FFF, coll_angle=15, couch_vrt=1, couch_lat=1,
        couch_lng=990, couch_rot=2, beam_name="GSX",
        gantry_rot_dir=m.GantryDirection.COUNTER_CLOCKWISE, jaw_padding_mm=6,
        roi_size_mm=25, y1=-50, y2=50, mu=100)),
    "open_field": ("truebeam", lambda g, m: g.add_open_field_beam(
        x1=-60, x2=40, y1=-30, y2=70, defined_by_mlcs=False, energy=15,
        fluence_mode=m.FluenceMode.SRS, dose_rate=300, gantry_angle=10, coll_angle=20,
        couch_vrt=3, couch_lng=970, couch_lat=-2, couch_rot=350, mu=120, padding_mm=7,
        beam_name="Open2", outside_strip_width_mm=3)),
    "hd_picket_fence": ("hd", lambda g, m: (
        g.add_picketfence_beam(strip_positions_mm=(-20, 0, 20), mu=90),
        g.add_open_field_beam(x1=-20, x2=20, y1=-20, y2=20))),
    "halcyon_both": ("halcyon", lambda g, m: g.add_picketfence_beam(
        stack=m.Stack.BOTH, strip_width_mm=4, strip_positions_mm=(-40, -10, 20, 50),
        gantry_angle=30, coll_angle=90, couch_vrt=1, couch_lng=990, couch_lat=2, mu=150,
        beam_name="HPF")),
    "halcyon_distal": ("halcyon", lambda g, m: g.add_picketfence_beam(stack=m.Stack.DISTAL)),
    "halcyon_proximal": ("halcyon", lambda g, m: g.add_picketfence_beam(
        stack=m.Stack.PROXIMAL, mu=80)),
}


def _planned(jax_side, case):
    machine, recipe = BEAM_CASES[case]
    t, j = _generators(jax_side, "truebeam" if machine == "hd" else machine,
                       hd=machine == "hd")
    recipe(t, tpg)
    recipe(j, jax_side["pg"])
    return t, j


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_plan_files_byte_equal(jax_side, frozen, case):
    t, j = _planned(jax_side, case)
    port, ref = _plan_bytes(t), _plan_bytes(j)
    assert port == ref
    # the port's file reads back in JAX's codec as the JAX plan
    back = jax_side["dcm"].dcmread(port)
    assert [str(b.BeamName) for b in back.BeamSequence] == \
           [str(b.BeamName) for b in j.as_dicom().BeamSequence]


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_fluences_bit_equal(jax_side, case):
    t, j = _planned(jax_side, case)
    for dtype in (np.float32, np.uint16):
        port = tpg.generate_fluences(t.as_dicom(), width_mm=200, resolution_mm=1,
                                     dtype=dtype, device="cpu")
        ref = jax_side["pg"].generate_fluences(j.as_dicom(), width_mm=200, resolution_mm=1,
                                               dtype=dtype)
        assert port.dtype == ref.dtype and port.shape == ref.shape
        assert np.array_equal(port.view(np.uint8), ref.view(np.uint8))
        assert port.any()


def test_fluence_at_the_default_resolution(jax_side):
    """JAX's default grid: 0.1 mm over 400 mm, the uint16 cast included."""
    t, j = _generators(jax_side)
    for g in (t, j):
        g.add_picketfence_beam(strip_positions_mm=(-30, 0, 30), mu=60)
    port = tpg.generate_fluences(t.as_dicom(), width_mm=400, device="cpu")
    ref = jax_side["pg"].generate_fluences(j.as_dicom(), width_mm=400)
    assert port.shape == ref.shape == (1, 4001, 4001) and port.dtype == np.uint16
    assert np.array_equal(port, ref)


def test_from_rt_plan_file_round_trip(jax_side, frozen, tmp_path):
    tmpl = tmp_path / "template.dcm"
    tmpl.write_bytes(_template_bytes(jax_side))
    gens = [mod.TrueBeamPlanGenerator.from_rt_plan_file(
        tmpl, plan_label="RT", plan_name="Round", patient_name="Other^Name",
        patient_id="ID9", max_mlc_speed=20, max_overtravel_mm=120)
        for mod in (tpg, jax_side["pg"])]
    outs = []
    for g, name in zip(gens, ("port", "jax")):
        g.add_mlc_speed_beams(speeds=(5, 10, 20), roi_size_mm=20)
        g.to_file(tmp_path / f"{name}.dcm")
        outs.append((tmp_path / f"{name}.dcm").read_bytes())
    assert outs[0] == outs[1]
    back = jax_side["dcm"].dcmread(str(tmp_path / "port.dcm"))
    assert str(back.PatientName) == "Other^Name" and str(back.RTPlanName) == "Round"
    assert tdcm.dcmread(str(tmp_path / "port.dcm")).BeamSequence[1].BeamName == "MLC Speed"


def _drop(name):
    def edit(ds):
        delattr(ds, name)
    return edit


# (template edit or None, machine, what the generator then does)
ERROR_CASES = {
    "not_rtplan": (lambda ds: setattr(ds, "Modality", "CT"), "truebeam", None),
    "no_patient_name": (_drop("PatientName"), "truebeam", None),
    "no_patient_id": (_drop("PatientID"), "truebeam", None),
    "no_tolerance_table": (_drop("ToleranceTableSequence"), "truebeam", None),
    "no_beams": (_drop("BeamSequence"), "truebeam", None),
    "no_mlc": (lambda ds: setattr(ds.BeamSequence[0].BeamLimitingDeviceSequence[0],
                                  "RTBeamLimitingDeviceType", "ASYMX"), "truebeam", None),
    "halcyon_as_truebeam": ("halcyon", "truebeam", None),
    "truebeam_as_halcyon": ("truebeam", "halcyon", None),
    "pf_overtravel": (None, "truebeam", lambda g, m: g.add_picketfence_beam(
        strip_positions_mm=(-100, 100))),
    "bank": (None, "truebeam", lambda g, m: g.add_mlc_transmission(bank="C")),
    "transmission_overtravel": (None, "truebeam", lambda g, m: g.add_mlc_transmission(
        bank="A", x1=-100, x2=100, overreach=50)),
    "dose_rate_width": (None, "truebeam", lambda g, m: g.add_dose_rate_beams(
        roi_size_mm=40)),
    "mlc_speed_max": (None, "truebeam", lambda g, m: g.add_mlc_speed_beams(speeds=(5, 50))),
    "mlc_speed_zero": (None, "truebeam", lambda g, m: g.add_mlc_speed_beams(speeds=(0, 5))),
    "mlc_speed_width": (None, "truebeam", lambda g, m: g.add_mlc_speed_beams(
        roi_size_mm=40)),
    "gantry_speed_max": (None, "truebeam", lambda g, m: g.add_gantry_speed_beams(
        speeds=(10,))),
    "gantry_travel": (None, "truebeam", lambda g, m: g.add_gantry_speed_beams(
        speeds=(4.8, 4.8), mu=400)),
    "gantry_width": (None, "truebeam", lambda g, m: g.add_gantry_speed_beams(
        roi_size_mm=40)),
    "beam_name": (None, "truebeam", lambda g, m: g.add_open_field_beam(
        x1=-10, x2=10, y1=-10, y2=10, beam_name="a" * 17)),
    "meterset": (None, "truebeam", lambda g, m: g.add_picketfence_beam(
        strip_positions_mm=())),
    "halcyon_open": (None, "halcyon", lambda g, m: g.add_open_field_beam()),
    "halcyon_dose_rate": (None, "halcyon", lambda g, m: g.add_dose_rate_beams()),
    "halcyon_mlc_speed": (None, "halcyon", lambda g, m: g.add_mlc_speed_beams()),
    "halcyon_gantry_speed": (None, "halcyon", lambda g, m: g.add_gantry_speed_beams()),
    "halcyon_winston_lutz": (None, "halcyon", lambda g, m: g.add_winston_lutz_beams()),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_errors_match_jax(jax_side, case):
    edit, machine, action = ERROR_CASES[case]
    template = edit if isinstance(edit, str) else machine
    raw = _template_bytes(jax_side, template)
    cls = "TrueBeamPlanGenerator" if machine == "truebeam" else "HalcyonPlanGenerator"
    outcomes = []
    for mod, codec in ((tpg, tdcm), (jax_side["pg"], jax_side["dcm"])):
        def run():
            ds = codec.dcmread(raw)
            if callable(edit):
                edit(ds)
            g = getattr(mod, cls)(ds, plan_label="QA", plan_name="QA")
            return action(g, mod) if action else "built"
        outcomes.append(_outcome(run))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == "raised"


def _shapers(jax_side, *args, **kwargs):
    return tmlc.MLCShaper(*args, **kwargs), jax_side["mlc"].MLCShaper(*args, **kwargs)


BOUNDS = tdicom.MLC_MILLENNIUM_BOUNDARIES

# (shaper keyword arguments, calls); a call that raises ends the case
SHAPER_CASES = {
    "strips": ({}, [("add_strip", dict(position_mm=-20, strip_width_mm=2,
                                       meterset_at_target=0.2)),
                    ("add_strip", dict(position_mm=15, strip_width_mm=4.5,
                                       meterset_at_target=0.3, meterset_transition=0.1))]),
    "rectangle": ({}, [("add_rectangle", dict(
        left_position=-30, right_position=25, x_outfield_position=-180, top_position=42,
        bottom_position=-37, outer_strip_width=3, meterset_at_target=0.5)),
        ("park", dict(meterset=0.2))]),
    "sacrifice": ({"sacrifice_max_move_mm": 35}, [
        ("add_strip", dict(position_mm=-40, strip_width_mm=0, meterset_at_target=0,
                           initial_sacrificial_gap_mm=6)),
        ("add_rectangle", dict(left_position=-40, right_position=-10,
                               x_outfield_position=-200, top_position=200,
                               bottom_position=-200, outer_strip_width=5,
                               meterset_at_target=0, meterset_transition=0.2,
                               sacrificial_distance=97.5)),
        ("add_strip", dict(position_mm=-10, strip_width_mm=0, meterset_at_target=0,
                           meterset_transition=0.25, sacrificial_distance_mm=12))]),
    "meterset_over_one": ({}, [("add_strip", dict(position_mm=0, strip_width_mm=2,
                                                  meterset_at_target=0.7)),
                               ("add_strip", dict(position_mm=10, strip_width_mm=2,
                                                  meterset_at_target=0.7))]),
    "sacrifice_without_transition": ({"sacrifice_max_move_mm": 50}, [
        ("add_strip", dict(position_mm=0, strip_width_mm=2, meterset_at_target=0.1)),
        ("add_strip", dict(position_mm=10, strip_width_mm=2, meterset_at_target=0.1,
                           sacrificial_distance_mm=20))]),
    "sacrifice_and_gap": ({"sacrifice_max_move_mm": 50}, [
        ("add_strip", dict(position_mm=0, strip_width_mm=2, meterset_at_target=0.1,
                           meterset_transition=0.1, sacrificial_distance_mm=20,
                           initial_sacrificial_gap_mm=5))]),
    "gap_after_points": ({}, [
        ("add_strip", dict(position_mm=0, strip_width_mm=2, meterset_at_target=0.1)),
        ("add_strip", dict(position_mm=5, strip_width_mm=2, meterset_at_target=0.1,
                           initial_sacrificial_gap_mm=5))]),
    "gap_and_transition": ({}, [
        ("add_strip", dict(position_mm=0, strip_width_mm=2, meterset_at_target=0.1,
                           meterset_transition=0.1, initial_sacrificial_gap_mm=5))]),
    "transition_first": ({}, [
        ("add_strip", dict(position_mm=0, strip_width_mm=2, meterset_at_target=0.1,
                           meterset_transition=0.1))]),
}


@pytest.mark.parametrize("case", list(SHAPER_CASES))
def test_mlc_shaper_matches_jax(jax_side, case):
    kwargs, calls = SHAPER_CASES[case]
    results = []
    for shaper in _shapers(jax_side, BOUNDS, max_mlc_position=200, max_overtravel_mm=140,
                           **kwargs):
        outs = [_outcome(lambda: getattr(shaper, name)(**kw)) for name, kw in calls]
        results.append((outs, shaper.as_control_points(), shaper.as_metersets(),
                        shaper.centers, shaper.num_leaves, shaper.num_pairs))
    assert results[0] == results[1]


def test_mlc_helpers_match_jax(jax_side):
    jm = jax_side["mlc"]
    rng = np.random.default_rng(7)
    for _ in range(60):
        kw = dict(current_position_mm=float(rng.uniform(-210, 210)),
                  travel_mm=float(rng.uniform(0, 200)), x_width_mm=float(rng.choice([100, 400])),
                  other_mlc_position=float(rng.uniform(-200, 200)),
                  max_overtravel_mm=float(rng.choice([50, 140, 150])))
        assert _outcome(lambda: tmlc.next_sacrifice_shift(**kw)) == \
               _outcome(lambda: jm.next_sacrifice_shift(**kw))
    for distance, max_travel in ((66, 50), (100, 50), (0, 10), (7.25, 2.5), (-1, 5), (5, -1)):
        assert _outcome(lambda: tmlc.split_sacrifice_travel(distance, max_travel)) == \
               _outcome(lambda: jm.split_sacrifice_travel(distance, max_travel))
    start = list(rng.uniform(-50, 0, 8))
    end = list(rng.uniform(0, 50, 8))
    for args in ((start, end, [0.25, 0.5, 1.0], [30, 30, 10], 140),
                 (start, end, [0.4, 1.0], [60, 60], 20),
                 (start, end, [], [], 140),
                 (start, end[:6], [1], [10], 140),
                 (start, end, [0.5, 1.2], [10, 10], 140),
                 (start, end, [0.5], [10, 10], 140)):
        assert _outcome(lambda: tmlc.interpolate_control_points(*args)) == \
               _outcome(lambda: jm.interpolate_control_points(*args))


def test_to_dicom_images_and_picket_fence_match_jax(jax_side, frozen, tmp_path):
    from pylinac_tpu.imggen.simulators import AS1000Image as JSim
    from pylinac_tpu.picketfence import PicketFence as JPF

    from pylinac_tpu_torch.imggen.simulators import AS1000Image as TSim
    from pylinac_tpu_torch.picketfence import PicketFence as TPF

    t, j = _generators(jax_side)
    for g in (t, j):
        g.add_picketfence_beam(mu=100, gantry_angle=10, coll_angle=5)
    port = t.to_dicom_images(TSim, invert=True, device="cpu")
    ref = j.to_dicom_images(JSim, invert=True)
    assert len(port) == len(ref) == 1
    assert np.array_equal(port[0].pixel_array, ref[0].pixel_array)
    assert port[0].pixel_array.dtype == ref[0].pixel_array.dtype == np.uint16
    assert float(port[0].GantryAngle) == 10 and float(port[0].BeamLimitingDeviceAngle) == 5
    tdcm.dcmwrite(tmp_path / "t.dcm", port[0])
    jax_side["dcm"].dcmwrite(tmp_path / "j.dcm", ref[0])
    tpf, jpf = TPF(str(tmp_path / "t.dcm"), device="cpu"), JPF(str(tmp_path / "j.dcm"))
    tpf.analyze(tolerance=0.3)
    jpf.analyze(tolerance=0.3)
    a, b = tpf.results_data(as_dict=True), jpf.results_data(as_dict=True)
    a.pop("date_of_analysis"), b.pop("date_of_analysis")
    assert list(a) == list(b)
    for key in b:
        if isinstance(b[key], float):
            assert a[key] == pytest.approx(b[key], abs=0.01), key
        else:
            assert a[key] == b[key], key
    assert a["number_of_pickets"] == 7 and a["max_error_mm"] < 0.5


def test_assign2machine_matches_jax(jax_side, frozen, tmp_path):
    t, j = _generators(jax_side)
    for g in (t, j):
        g.add_open_field_beam(x1=-20, x2=20, y1=-20, y2=20)
        g.add_winston_lutz_beams()
    machine = jax_side["template"]()
    machine.BeamSequence[0].TreatmentMachineName = "TB99"
    jax_side["dcm"].dcmwrite(tmp_path / "machine.dcm", machine)
    outs = []
    for g, util, name in ((t, tutil, "port"), (j, jax_side["util"], "jax")):
        path = tmp_path / f"{name}.dcm"
        g.to_file(path)
        util.assign2machine(str(path), str(tmp_path / "machine.dcm"))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert {str(b.TreatmentMachineName)
            for b in tdcm.dcmread(str(tmp_path / "port.dcm")).BeamSequence} == {"TB99"}


def test_boundaries_and_reports(jax_side):
    for name in ("MLC_MILLENNIUM_BOUNDARIES", "MLC_DISTAL_BOUNDARIES",
                 "MLC_PROXIMAL_BOUNDARIES"):
        assert getattr(tdicom, name) == getattr(jax_side["dicom"], name)
    hd = tdicom.MLC_120HDMIL_BOUNDARIES
    assert len(hd) == 61 and hd[0] == -110 and hd[-1] == 110
    assert np.array_equal(np.diff(hd), [5] * 14 + [2.5] * 32 + [5] * 14)
    t, _ = _generators(jax_side)
    t.add_open_field_beam(x1=-20, x2=20, y1=-20, y2=20)
    figs = tpg.plot_fluences(t.as_dicom(), 400, 1, show=False, device="cpu")
    assert [f.axes[0].get_title() for f in figs] == \
        [str(b.BeamName) for b in t.as_dicom().BeamSequence]
    assert tpg.generate_fluences(tdcm.Dataset(), 100, device="cpu").size == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpg.generate_fluences(t.as_dicom(), 100)
        with pytest.raises(RuntimeError, match="CUDA"):
            t.plot_fluences()


def test_jax_hd_boundaries_leave_hd_plans_without_fluence(jax_side, monkeypatch):
    """JAX's own HD120 list: 53 pairs against the beam's 60, so its HD
    fluence raises; the port's HD plan has its fluence."""
    monkeypatch.undo()
    jd = jax_side["dicom"]
    assert len(jd.MLC_120HDMIL_BOUNDARIES) == 54
    raw = _template_bytes(jax_side, hd=True)
    j = jax_side["pg"].TrueBeamPlanGenerator(jax_side["dcm"].dcmread(raw), plan_label="QA",
                                             plan_name="QA")
    j.add_open_field_beam(x1=-20, x2=20, y1=-20, y2=20)
    with pytest.raises(ValueError, match="broadcast"):
        jax_side["pg"].generate_fluences(j.as_dicom(), 200, 1)
    t = tpg.TrueBeamPlanGenerator(tdcm.dcmread(raw), plan_label="QA", plan_name="QA")
    t.add_open_field_beam(x1=-20, x2=20, y1=-20, y2=20)
    fl = tpg.generate_fluences(t.as_dicom(), 200, 1, dtype=np.float32, device="cpu")
    assert fl[0, 110, 100] == 1000 and fl[0, 110, 60] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("machine", ["truebeam", "halcyon"])
def test_card_fluences_equal_cpu(cuda, machine):
    """A plan built from a template of the port's own (no JAX on the card)."""
    ds = tdcm.Dataset()
    ds.Modality = "RTPLAN"
    ds.PatientName = "QA^Physics"
    ds.PatientID = "QA1"
    tol = tdcm.Dataset()
    tol.ToleranceTableNumber = 1
    ds.ToleranceTableSequence = [tol]
    beam = tdcm.Dataset()
    beam.TreatmentMachineName = "M1"
    stacks = ([("MLCX", 60, tdicom.MLC_MILLENNIUM_BOUNDARIES)] if machine == "truebeam" else
              [("MLCX1", 28, tdicom.MLC_DISTAL_BOUNDARIES),
               ("MLCX2", 29, tdicom.MLC_PROXIMAL_BOUNDARIES)])
    beam.BeamLimitingDeviceSequence = []
    for kind, n, bounds in stacks:
        mlc = tdcm.Dataset()
        mlc.RTBeamLimitingDeviceType = kind
        mlc.NumberOfLeafJawPairs = n
        mlc.LeafPositionBoundaries = bounds
        beam.BeamLimitingDeviceSequence.append(mlc)
    ds.BeamSequence = [beam]
    if machine == "truebeam":
        g = tpg.TrueBeamPlanGenerator(ds, plan_label="QA", plan_name="QA")
        g.add_picketfence_beam()
        g.add_dose_rate_beams()
        g.add_gantry_speed_beams()
    else:
        g = tpg.HalcyonPlanGenerator(ds, plan_label="QA", plan_name="QA")
        g.add_picketfence_beam(stack=tpg.Stack.BOTH)
    for dtype in (np.float32, np.uint16):
        card = tpg.generate_fluences(g.as_dicom(), 400, dtype=dtype, device=cuda)
        cpu = tpg.generate_fluences(g.as_dicom(), 400, dtype=dtype, device="cpu")
        assert np.array_equal(card.view(np.uint8), cpu.view(np.uint8))
