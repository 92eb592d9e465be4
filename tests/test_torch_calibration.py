"""The port's TG-51 and TRS-398 calibration against the JAX package's, on the CPU.

Every function of both protocols runs on a seeded grid that crosses its
tables' ranges and bounds: the same values, the same errors with the same
messages, the same warnings. Each worksheet class gives the same
properties, and with the clock frozen in both packages its
``publish_pdf`` writes the same bytes. The core helpers carried over in the
same slice (``core/decorators.py``, ``core/mask.py``,
``core/validators.py``, ``core/pdf.py``) are held to JAX's here too.
"""

import datetime
import gc
import io
import warnings
import weakref

import numpy as np
import pytest

from pylinac_tpu_torch.calibration import tg51 as ttg51
from pylinac_tpu_torch.calibration import trs398 as ttrs398
from pylinac_tpu_torch.core import decorators as tdecorators
from pylinac_tpu_torch.core import mask as tmask
from pylinac_tpu_torch.core import pdf as tpdf
from pylinac_tpu_torch.core import validators as tvalidators


class _FrozenClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 6, 7, 8, 9)


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pylinac_tpu.calibration import tg51, trs398
    from pylinac_tpu.core import decorators, mask, pdf, validators

    return {"tg51": tg51, "trs398": trs398, "decorators": decorators, "mask": mask,
            "pdf": pdf, "validators": validators}


@pytest.fixture
def frozen(jax_side, monkeypatch):
    for mod in (ttg51, tpdf, jax_side["tg51"], jax_side["pdf"]):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)


def _outcome(fn, *args, **kwargs):
    """(value or raised error, warnings) of one call; a value keeps its type."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = fn(*args, **kwargs)
            value = (type(value).__name__, value)
        except (ValueError, KeyError, TypeError, ZeroDivisionError) as e:
            value = ("raised", type(e).__name__, str(e))
    return value, [(str(w.message), w.category.__name__) for w in caught]


def _u(rng, lo, hi):
    return float(rng.uniform(lo, hi))


def _readings(rng, n, lo=19.5, hi=20.5):
    return tuple(rng.uniform(lo, hi, n).round(4))


def _chamber(rng, table):
    return str(rng.choice(list(table) + ["no such chamber"]))


# (module, function, keyword-argument maker); each maker draws across the
# function's table range and past its bounds
def _grid_cases():
    from pylinac_tpu_torch.calibration import _tg51_tables as t51, _trs398_tables as t398

    return {
        "mmHg2kPa": ("tg51", lambda r: {"mmHg": _u(r, 600, 800)}),
        "mbar2kPa": ("tg51", lambda r: {"mbar": _u(r, 900, 1100)}),
        "fahrenheit2celsius": ("tg51", lambda r: {"f": _u(r, 50, 100)}),
        "tpr2010_from_pdd2010": ("tg51", lambda r: {"pdd2010": _u(r, 0.4, 1.1)}),
        "p_tp": ("tg51", lambda r: {"temp": _u(r, 10, 40), "press": _u(r, 85, 120)}),
        "p_pol": ("tg51", lambda r: {"m_reference": _readings(r, 3),
                                     "m_opposite": _readings(r, 3, -21, -19)}),
        "p_ion": ("tg51", lambda r: {"voltage_reference": 300, "voltage_reduced": 150,
                                     "m_reference": _readings(r, 2, 20, 20.6),
                                     "m_reduced": _readings(r, 2, 19.8, 20.2)}),
        "d_ref": ("tg51", lambda r: {"i_50": _u(r, -1, 15)}),
        "r_50": ("tg51", lambda r: {"i_50": _u(r, -1, 15)}),
        "kp_r50": ("tg51", lambda r: {"r_50": _u(r, 1, 10)}),
        "pq_gr": ("tg51", lambda r: {"m_dref_plus": _readings(r, 2),
                                     "m_dref": _readings(r, 2)}),
        "m_corrected": ("tg51", lambda r: {
            "p_ion": _u(r, 0.99, 1.06), "p_tp": _u(r, 0.88, 1.12),
            "p_elec": _u(r, 0.97, 1.03), "p_pol": _u(r, 0.97, 1.03),
            "m_reference": _readings(r, 2)}),
        "pddx": ("tg51", lambda r: {
            "pdd": _u(r, 60, 92), "energy": int(r.choice([6, 10, 15, 18])),
            "lead_foil": r.choice([None, "30cm", "50cm", "2cm"])}),
        "kq_photon_pddx": ("tg51", lambda r: {"chamber": _chamber(r, t51.KQ_PHOTONS),
                                              "pddx": _u(r, 60, 88)}),
        "kq_photon_tpr": ("tg51", lambda r: {"chamber": _chamber(r, t51.KQ_PHOTONS),
                                             "tpr": _u(r, 0.6, 0.82)}),
        "kq_electron": ("tg51", lambda r: {"chamber": _chamber(r, t51.KQ_ELECTRONS),
                                           "r_50": _u(r, 1.5, 10)}),
        "k_tp": ("trs398", lambda r: {"temp": _u(r, 10, 40), "press": _u(r, 85, 120),
                                      "ref_temp": float(r.choice([20, 22]))}),
        "k_s": ("trs398", lambda r: {
            "voltage_reference": 300, "voltage_reduced": int(r.choice([60, 75, 100, 110, 150])),
            "m_reference": _readings(r, 2, 20, 20.8), "m_reduced": _readings(r, 2, 19.8, 20.2)}),
        "kq_photon": ("trs398", lambda r: {"chamber": _chamber(r, t398.KQ_PHOTON_CHAMBERS),
                                           "tpr": _u(r, 0.48, 0.86)}),
        "trs398_kq_electron": ("trs398", lambda r: {
            "chamber": _chamber(r, t398.KQ_ELECTRON_CHAMBERS), "r_50": _u(r, 3.5, 21)}),
        "trs398_m_corrected": ("trs398", lambda r: {
            "k_tp": _u(r, 0.88, 1.12), "k_elec": _u(r, 0.97, 1.03),
            "k_pol": _u(r, 0.97, 1.03), "k_s": _u(r, 0.99, 1.06),
            "m_reference": _readings(r, 3)}),
        "trs398_shared": ("trs398", lambda r: {"i_50": _u(r, -1, 12)}),
    }


GRID = _grid_cases()
_UNBOUNDED = ("mmHg2kPa", "mbar2kPa", "fahrenheit2celsius", "pq_gr")
_NAMES = {"trs398_kq_electron": "kq_electron", "trs398_m_corrected": "m_corrected",
          "trs398_shared": "z_ref"}


@pytest.mark.parametrize("case", list(GRID))
def test_functions_match_jax_on_a_grid(jax_side, case):
    module, make = GRID[case]
    name = _NAMES.get(case, case)
    port = getattr({"tg51": ttg51, "trs398": ttrs398}[module], name)
    ref = getattr(jax_side[module], name)
    rng = np.random.default_rng(list(GRID).index(case))
    positional = name in _UNBOUNDED[:3]
    kinds = set()
    for _ in range(40):
        kw = make(rng)
        args = (list(kw.values()), {}) if positional else ((), kw)
        got, want = _outcome(port, *args[0], **args[1]), _outcome(ref, *args[0], **args[1])
        assert got == want, kw
        kinds.add(got[0][0] == "raised")
    if name not in _UNBOUNDED:
        assert kinds == {True, False}, "the grid must reach both values and errors"


def test_shared_names(jax_side):
    for name in ("MIN_TEMP", "MAX_TEMP", "MIN_PRESSURE", "MAX_PRESSURE", "MIN_PION",
                 "MAX_PION", "MIN_PTP", "MAX_PTP", "MIN_PELEC", "MAX_PELEC", "MIN_PPOL",
                 "MAX_PPOL"):
        assert getattr(ttrs398, name) == getattr(jax_side["trs398"], name)
        assert getattr(ttg51, name) == getattr(jax_side["tg51"], name)
    assert ttg51.LEAD_OPTIONS == jax_side["tg51"].LEAD_OPTIONS
    for name in ("k_pol", "z_ref", "r_50", "mmHg2kPa", "mbar2kPa", "fahrenheit2celsius"):
        assert getattr(ttrs398, name).__name__ == getattr(jax_side["trs398"], name).__name__


_COMMON = dict(temp=22.5, press=100.8, n_dw=5.443, voltage_reference=-300,
               voltage_reduced=-150, m_reference=(25.65, 25.66), m_opposite=(-25.71, -25.70),
               m_reduced=(25.59, 25.60), mu=200, tissue_correction=0.995)

# (module, class, keyword arguments, properties)
WORKSHEETS = {
    "tg51_photon": ("tg51", "TG51Photon", dict(
        _COMMON, institution="Clinic", physicist="Phys", unit="TrueBeam1",
        measurement_date="2024-05-01", chamber="30013", p_elec=1.001, electrometer="Max4000",
        measured_pdd10=77.4, lead_foil="50cm", clinical_pdd10=77.1, energy=15, fff=True,
        m_reference_adjusted=(25.43, 25.44)),
        ["p_tp", "p_ion", "p_pol", "m_corrected", "m_corrected_adjustment",
         "output_was_adjusted", "pddx", "kq", "dose_mu_10", "dose_mu_dmax",
         "dose_mu_10_adjusted", "dose_mu_dmax_adjusted"]),
    "tg51_photon_plain": ("tg51", "TG51Photon", dict(
        _COMMON, unit="TB2", chamber="A12", p_elec=1.0, measured_pdd10=66.4,
        clinical_pdd10=66.5, energy=6), ["pddx", "kq", "dose_mu_10", "dose_mu_dmax",
                                         "output_was_adjusted", "m_corrected_adjustment"]),
    "tg51_electron_legacy": ("tg51", "TG51ElectronLegacy", dict(
        _COMMON, institution="Clinic", physicist="Phys", unit="TrueBeam1", energy=12,
        chamber="30013", k_ecal=0.906, p_elec=0.999, clinical_pdd=99.5,
        m_gradient=(25.7, 25.71), i_50=4.8, m_reference_adjusted=(25.5,)),
        ["r_50", "dref", "pq_gr", "kq", "dose_mu_dref", "dose_mu_dmax",
         "dose_mu_dref_adjusted", "dose_mu_dmax_adjusted", "m_corrected"]),
    "tg51_electron_modern": ("tg51", "TG51ElectronModern", dict(
        _COMMON, unit="TrueBeam1", energy=9, chamber="A12", p_elec=1.0, clinical_pdd=100.0,
        i_50=3.6, m_reference_adjusted=(25.5,)),
        ["r_50", "dref", "kq", "dose_mu_dref", "dose_mu_dmax", "dose_mu_dref_adjusted",
         "dose_mu_dmax_adjusted"]),
    "trs398_photon_ssd": ("trs398", "TRS398Photon", dict(
        _COMMON, institution="Clinic", physicist="Phys", unit="TrueBeam1",
        measurement_date="2024-05-01", electrometer="Max4000", setup="SSD", chamber="30013",
        tpr2010=0.671, energy=6, fff=False, k_elec=1.002, clinical_pdd_zref=66.7,
        m_reference_adjusted=(25.5,)),
        ["k_tp", "k_pol", "k_s", "m_corrected", "kq", "dose_mu_zref", "dose_mu_zmax",
         "m_corrected_adjusted", "dose_mu_zref_adjusted", "dose_mu_zmax_adjusted",
         "output_was_adjusted"]),
    "trs398_photon_sad": ("trs398", "TRS398Photon", dict(
        _COMMON, unit="TrueBeam2", setup="SAD", chamber="A12", tpr2010=0.762, energy=15,
        fff=True, k_elec=1.0, clinical_tmr_zref=0.81),
        ["kq", "dose_mu_zref", "dose_mu_zmax", "output_was_adjusted"]),
    "trs398_electron": ("trs398", "TRS398Electron", dict(
        _COMMON, institution="Clinic", unit="TrueBeam1", energy=12, cone="15x15",
        chamber="30013", i_50=4.8, k_elec=1.0, clinical_pdd_zref=99.0,
        m_reference_adjusted=(25.5,)),
        ["r_50", "zref", "kq", "k_s", "dose_mu_zref", "dose_mu_zmax",
         "dose_mu_zref_adjusted", "dose_mu_zmax_adjusted"]),
}


def _sheets(jax_side, case):
    module, cls, kwargs, props = WORKSHEETS[case]
    port = getattr({"tg51": ttg51, "trs398": ttrs398}[module], cls)
    ref = getattr(jax_side[module], cls)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return port(**kwargs), ref(**kwargs), props


@pytest.mark.parametrize("case", list(WORKSHEETS))
def test_worksheet_properties_match_jax(jax_side, case):
    port, ref, props = _sheets(jax_side, case)
    for prop in props:
        got, want = _outcome(getattr, port, prop), _outcome(getattr, ref, prop)
        assert got == want, prop
        assert got[0][0] != "raised", prop


@pytest.mark.parametrize("case", list(WORKSHEETS))
def test_publish_pdf_byte_equal(jax_side, frozen, case, tmp_path):
    port, ref, _ = _sheets(jax_side, case)
    outs = []
    for sheet, name in ((port, "port"), (ref, "jax")):
        path = tmp_path / f"{name}.pdf"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sheet.publish_pdf(str(path), notes=["checked", "by (two) people"],
                              metadata={"Site": "Main", "Unit": "TB1"})
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert outs[0].startswith(b"%PDF-1.4") and b"/Count 1 " in outs[0]


def test_bad_setup_and_bounds(jax_side):
    kwargs = dict(WORKSHEETS["trs398_photon_ssd"][2])
    for over in ({"setup": "nonsense"}, {"tpr2010": 0.9}):
        got = _outcome(ttrs398.TRS398Photon, **{**kwargs, **over})
        want = _outcome(jax_side["trs398"].TRS398Photon, **{**kwargs, **over})
        assert got[0] == want[0] and got[0][0] == "raised"


def test_pdf_canvas_with_image_and_pages(jax_side, frozen, tmp_path):
    """Two pages, metadata, multi-line text and an embedded PNG."""
    from PIL import Image

    png = io.BytesIO()
    Image.fromarray((np.arange(48 * 64).reshape(48, 64) % 251).astype(np.uint8)).save(
        png, format="PNG")
    outs = []
    for mod in (tpdf, jax_side["pdf"]):
        buf = io.BytesIO()
        canvas = mod.PylinacCanvas(buf, page_title="Report (test)", metadata={"A": 1})
        canvas.add_text("line one\nline \\ two", location=(2, 20), font_size=12)
        canvas.add_image(io.BytesIO(png.getvalue()), location=(2, 5), dimensions=(8, 6))
        canvas.add_new_page()
        canvas.add_text(["x", "y"], location=(3, 10))
        canvas.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert b"/Count 2 " in outs[0] and b"/Subtype /Image" in outs[0]


def test_lru_cache_frees_instances_and_caches(jax_side):
    for mod in (tdecorators, jax_side["decorators"]):
        calls = []

        class Thing:
            @mod.lru_cache(maxsize=8)
            def square(self, x):
                calls.append(x)
                return x * x

        a = Thing()
        assert a.square(3) == 9 and a.square(3) == 9 and calls == [3]
        ref = weakref.ref(a)
        del a
        gc.collect()
        assert ref() is None
        Thing.square.cache_clear()


def test_validate_and_validators_match_jax(jax_side):
    jv = jax_side["validators"]
    for name, arg in (("array_not_empty", np.array([])), ("array_not_empty", np.ones(2)),
                      ("single_dimension", np.ones((2, 2))), ("single_dimension", np.ones(3)),
                      ("double_dimension", np.ones(3)), ("double_dimension", np.ones((2, 2))),
                      ("is_positive", -0.5), ("is_positive", 0)):
        assert _outcome(getattr(tvalidators, name), arg) == _outcome(getattr(jv, name), arg)
    for mod, vmod in ((tdecorators, tvalidators), (jax_side["decorators"], jv)):
        @mod.validate(values=(vmod.array_not_empty, vmod.single_dimension), n=vmod.is_positive)
        def total(values, n=1):
            return float(np.sum(values)) * n

        assert total(np.ones(3), n=2) == 6.0
        assert _outcome(total, np.ones((2, 2)))[0][0] == "raised"
        assert _outcome(total, np.ones(2), n=-1)[0][2] == "Value must be positive"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounding_box_matches_jax(jax_side, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((30, 40), bool)
    r0, c0 = rng.integers(0, 20, 2)
    mask[r0:r0 + rng.integers(1, 10), c0:c0 + rng.integers(1, 20)] = True
    mask |= rng.random(mask.shape) < 0.01 * seed
    got, want = tmask.bounding_box(mask), jax_side["mask"].bounding_box(mask)
    assert tuple(map(int, got)) == tuple(map(int, want))
