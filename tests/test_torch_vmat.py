"""The port's VMAT tests (DRGS, DRMLC, DRCS) against the JAX package's.

Both packages read the same DICOM pairs, drawn by the port's
``imggen.utils._generate_vmat_pair``: the DRGS and DRMLC pairs of
``tests/models/test_vmat.py`` and a DRCS pair (five segments at 50 mm
between six collimator spokes, which the JAX suite does not draw), each
also with one segment drawn 3 % hot. ``results_data()`` is compared as the
JSON-compatible dict without its date and version: strings, booleans, keys,
segment centres and warnings (message, category) exactly, and every float
to the bit, since the ratio image, the segments and the profiles are the
same host numpy in both packages (the parity bar is 0.1 % and 0.01 mm;
these come out bit-equal). DRCS's size-10 median, the only device work,
runs here on CPU tensors (the general sort, as JAX's); its card run is the
``cuda``-marked test below. The DRCS frames are a 256 x 320 detector of
0.78125 mm pixels, to keep JAX's size-10 median quick on the CPU.

The ``cuda`` tests import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_vmat.py`` runs them on a card.
"""

import json
import warnings
import zipfile

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import DRCS, DRGS, DRMLC
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1000Image
from pylinac_tpu_torch.imggen.utils import _generate_vmat_pair
from pylinac_tpu_torch.ops import filters as tfilters


class SmallDetector(AS500Image):
    """A 256 x 320 detector of AS500 pixels (200 x 250 mm)."""

    shape = (256, 320)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jvmat():
    import pylinac_tpu.vmat as jvmat

    return jvmat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for name, test, sim, errors in (
            ("drgs", "drgs", AS1000Image(sid=1500), None),
            ("drgs_hot", "drgs", AS1000Image(sid=1500), [0, 0, 3, 0, 0, 0, 0]),
            ("drmlc", "drmlc", AS1000Image(sid=1500), None),
            ("drmlc_hot", "drmlc", AS1000Image(sid=1500), [0, 0, 0, 3]),
            ("drcs", "drcs", SmallDetector(sid=1000), None),
            ("drcs_hot", "drcs", SmallDetector(sid=1000), [0, 3, 0, 0, 0])):
        d = tmp_path_factory.mktemp(name)
        out[name] = _generate_vmat_pair(test, sim, str(d), errors)
    d = tmp_path_factory.mktemp("drcs_turned")
    out["drcs_turned"] = _generate_vmat_pair("drcs", SmallDetector(sid=1000), str(d),
                                             spoke_offset_deg=2.0)
    return out


def _data(obj) -> dict:
    d = obj.results_data(as_dict=True)
    d.pop("date_of_analysis")
    d.pop("pylinac_version")
    d["warnings"] = [(w["message"], w["category"]) for w in d["warnings"]]
    return d


def _run(cls, paths, init=None, **analyze):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = cls(image_paths=paths, **(init or {}))
        obj.analyze(**analyze)
    return obj, [(str(w.message), w.category.__name__) for w in caught
                 if not issubclass(w.category, DeprecationWarning)]


def _assert_same(jvmat, name, paths, init=None, **analyze):
    """The port on the CPU against JAX: the same results, to the bit, and
    the same warnings raised to the caller and captured; or the same
    error."""
    try:
        j, j_raised = _run(getattr(jvmat, name), paths, init, **analyze)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _run(globals()[name], paths, {**(init or {}), "device": "cpu"}, **analyze)
        assert str(got.value) == str(e)
        return None, None
    t, t_raised = _run(globals()[name], paths, {**(init or {}), "device": "cpu"}, **analyze)
    jd, td = _data(j), _data(t)
    assert json.dumps(td) == json.dumps(jd)
    assert t_raised == j_raised
    assert t.results() == j.results()
    return t, td


LINEAR_CASES = [
    ("DRGS", "drgs", {}, {}),
    ("DRGS", "drgs_hot", {}, {}),
    ("DRGS", "drgs_hot", {}, {"tolerance": 3.0}),
    ("DRGS", "drgs", {}, {"segment_size_mm": (8, 80)}),
    ("DRGS", "drgs", {}, {"roi_config": {"left": {"offset_mm": -30}, "mid": {"offset_mm": 0},
                                         "right": {"offset_mm": 30}}}),
    ("DRGS", "drgs", {}, {"invert_image_order": True}),
    ("DRGS", "drgs", {"ground": False}, {}),
    ("DRGS", "drgs", {"check_inversion": False}, {}),
    ("DRMLC", "drmlc", {}, {}),
    ("DRMLC", "drmlc_hot", {}, {"tolerance": 1.0}),
    ("DRMLC", "drmlc", {"ground": False, "check_inversion": False}, {"segment_size_mm": (10, 60)}),
]


@pytest.mark.parametrize("name,pair,init,analyze", LINEAR_CASES)
def test_linear_results_match_jax(jvmat, pairs, name, pair, init, analyze):
    _assert_same(jvmat, name, pairs[pair], init, **analyze)


def test_swapped_pair_is_identified(jvmat, pairs):
    open_path, dmlc_path = pairs["drgs"]
    t, td = _assert_same(jvmat, "DRGS", [dmlc_path, open_path])
    assert td["passed"] and t.open_image.path == open_path


def test_hot_segment_is_the_one_that_fails(jvmat, pairs):
    for name, pair, hot in (("DRGS", "drgs_hot", 2), ("DRMLC", "drmlc_hot", 3),
                            ("DRCS", "drcs_hot", 1)):
        _, td = _assert_same(jvmat, name, pairs[pair])
        devs = [s["r_dev"] for s in td["segment_data"]]
        assert not td["passed"]
        assert [s["passed"] for s in td["segment_data"]] == [i != hot for i in range(len(devs))]
        assert int(np.argmax(devs)) == hot and 1.5 < devs[hot] < 3.5


def test_perfect_pairs_pass(jvmat, pairs):
    for name, pair in (("DRGS", "drgs"), ("DRMLC", "drmlc"), ("DRCS", "drcs")):
        _, td = _assert_same(jvmat, name, pairs[pair])
        assert td["passed"] and td["max_deviation_percent"] < 0.3


DRCS_CASES = [
    ({}, {}),
    ({}, {"tolerance": 0.5}),
    ({}, {"segment_size_mm": (30, 8)}),
    ({}, {"roi_config": {"up": {"radial_distance": 45, "angle": 0},
                         "down": {"radial_distance": 45, "angle": 180}}}),
    ({}, {"collimator_radial_distances": (25, 60)}),
    ({}, {"collimator_config": {"A": 150, "C": 30, "E": 270}}),
    # the pair swapped: the spokes are valleys of the ratio image, and both
    # packages fail to find six
    ({}, {"invert_image_order": True}),
    ({"ground": False, "check_inversion": False}, {}),
]


@pytest.mark.parametrize("init,analyze", DRCS_CASES)
def test_drcs_results_match_jax(jvmat, pairs, init, analyze):
    _assert_same(jvmat, "DRCS", pairs["drcs"], init, **analyze)


def test_drcs_turned_spokes(jvmat, pairs):
    """Spokes drawn 2 degrees past their nominal angles show a rotation
    offset of about +2 (about 1.5 degrees of arc a pixel at 30 mm)."""
    _, td = _assert_same(jvmat, "DRCS", pairs["drcs_turned"])
    assert td["rotation_offset_deg"] == pytest.approx(2.0, abs=1.0)
    assert set(td["collimator_data"]) == set("ABCDEF")


def test_drcs_median_is_the_general_sort(pairs):
    """The identification's size-10 median takes the stack-and-sort route
    on every device (the 3x3 kernel serves size 3 only)."""
    t = DRCS(image_paths=pairs["drcs"], device="cpu")
    arr = torch.from_numpy(np.asarray(t.open_image.array, np.float32))
    np.testing.assert_array_equal(tfilters.median_filter(arr, 10).numpy(),
                                  tfilters._median_general(arr, 10).numpy())


def test_off_centre_field_warns_and_captures_nothing(jvmat, tmp_path):
    """A field right of the centre third warns; DRGS inherits ``analyze``,
    so the warning reaches the caller and ``results_data()`` keeps none,
    as in JAX."""
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer

    paths = []
    for name, layers in (("open", [PerfectFieldLayer(field_size_mm=(150, 60),
                                                     cax_offset_mm=(0, 75))]),
                         ("dmlc", [PerfectFieldLayer(field_size_mm=(150, 15),
                                                     cax_offset_mm=(0, 75 + off), alpha=0.5)
                                   for off in (-20, 0, 20)])):
        sim = AS1000Image(sid=1500)
        for layer in layers:
            sim.add_layer(layer)
        sim.add_layer(GaussianFilterLayer(sigma_mm=1))
        sim.generate_dicom(str(tmp_path / f"{name}.dcm"))
        paths.append(str(tmp_path / f"{name}.dcm"))
    cfg = {"roi_config": {f"ROI {i}": {"offset_mm": o} for i, o in enumerate((-20, 0, 20))}}
    t, td = _assert_same(jvmat, "DRGS", paths, **cfg)
    _, raised = _run(DRGS, paths, {"device": "cpu"}, **cfg)
    assert any("center third" in m for m, _ in raised)
    assert td["warnings"] == []


def test_from_zip_matches_jax(jvmat, pairs, tmp_path):
    path = tmp_path / "drgs.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for p in pairs["drgs"]:
            zf.write(p, arcname=p.split("/")[-1])
    j = jvmat.DRGS.from_zip(str(path))
    j.analyze()
    t = DRGS.from_zip(str(path), device="cpu")
    t.analyze()
    assert json.dumps(_data(t)) == json.dumps(_data(j))


def test_results_data_forms(pairs):
    t = DRCS(image_paths=pairs["drcs"], device="cpu")
    t.analyze()
    data = t.results_data()
    assert type(data).__name__ == "DRCSResult"
    assert list(data.model_dump())[:3] == ["pylinac_version", "date_of_analysis", "warnings"]
    assert json.loads(t.results_data(as_json=True))["test_type"] == "Dose Rate & Collimator Speed"
    with pytest.raises(ValueError):
        t.results_data(as_dict=True, as_json=True)


def test_needs_two_images(pairs):
    with pytest.raises(ValueError, match="Exactly 2 images"):
        DRGS(image_paths=pairs["drgs"][:1], device="cpu")


def test_without_device_needs_cuda(pairs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls, pair in ((DRGS, "drgs"), (DRMLC, "drmlc"), (DRCS, "drcs")):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(image_paths=pairs[pair])


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["drcs", "drcs_hot"])
def test_drcs_on_card_matches_cpu(cuda, pairs, pair):
    """The card's size-10 median gives the CPU's bits, so every result is
    the same."""
    c = DRCS(image_paths=pairs[pair], device=cuda)
    c.analyze()
    h = DRCS(image_paths=pairs[pair], device="cpu")
    h.analyze()
    assert json.dumps(_data(c)) == json.dumps(_data(h))
    arr = torch.from_numpy(np.asarray(h.open_image.array, np.float32))
    torch.testing.assert_close(tfilters.median_filter(arr.to(cuda), 10).cpu(),
                               tfilters.median_filter(arr, 10), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,pair", [("DRGS", "drgs_hot"), ("DRMLC", "drmlc")])
def test_linear_on_card_matches_cpu(cuda, pairs, name, pair):
    cls = globals()[name]
    c = cls(image_paths=pairs[pair], device=cuda)
    c.analyze()
    h = cls(image_paths=pairs[pair], device="cpu")
    h.analyze()
    assert json.dumps(_data(c)) == json.dumps(_data(h))


def test_wrap180_matches_jax():
    """The collimator deviations wrap through ``core.scale.wrap180``."""
    from pylinac_tpu.core.scale import wrap180 as jwrap180

    from pylinac_tpu_torch.core.scale import wrap180

    angles = np.array([-540.0, -181.0, -180.0, -0.5, 0.0, 179.999, 180.0, 359.0, 725.25])
    np.testing.assert_array_equal(wrap180(angles), jwrap180(angles))
    assert [wrap180(a) for a in (190, -190, 180)] == [jwrap180(a) for a in (190, -190, 180)]
