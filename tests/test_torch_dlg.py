"""The port's DLG against the JAX package's, on the CPU.

Both read the same sweeping-gap images, drawn by the port's
``imggen.utils._generate_dlg`` as ``tests/models/test_quart_dlg.py:104-131``
draws them (an AS1000 frame, five bands of gaps -0.4 to -1.2 mm), and one
of an AS1200 frame with other gaps. DLG is host numpy in both packages, the
peak finder on the CPU in both, so the per-leaf lists (planned gaps exactly,
measured prominences to the bit) and ``measured_dlg`` are held equal; the
parity bar would be 0.01 mm.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import DLG, MLC
from pylinac_tpu_torch.imggen.simulators import AS1000Image, AS1200Image
from pylinac_tpu_torch.imggen.utils import _generate_dlg

GAPS = (-0.4, -0.6, -0.8, -1.0, -1.2)
GAPS_1200 = (-0.3, -0.5, -0.8, -1.1, -1.4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdlg():
    import pylinac_tpu.dlg as jdlg
    import pylinac_tpu.picketfence as jpf

    return jdlg, jpf


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dlg")
    out = {"as1000": str(d / "dlg1000.dcm"), "as1200": str(d / "dlg1200.dcm")}
    _generate_dlg(AS1000Image(sid=1000), out["as1000"], GAPS)
    _generate_dlg(AS1200Image(sid=1000), out["as1200"], GAPS_1200)
    return out


def _both(jdlg, path, gaps, mlc_name="MILLENNIUM", **kwargs):
    jmod, jpf = jdlg
    j = jmod.DLG(path)
    j.analyze(gaps=gaps, mlc=getattr(jpf.MLC, mlc_name), **kwargs)
    t = DLG(path)
    t.analyze(gaps=gaps, mlc=getattr(MLC, mlc_name), **kwargs)
    return j, t


CASES = [
    ("as1000", GAPS, "MILLENNIUM", {}),
    ("as1000", GAPS, "MILLENNIUM", {"y_field_size": 80}),
    ("as1000", GAPS, "MILLENNIUM", {"profile_width": 6}),
    ("as1000", GAPS, "HD_MILLENNIUM", {}),
    ("as1000", list(reversed(GAPS)), "MILLENNIUM", {"y_field_size": 100, "profile_width": 15}),
    ("as1200", GAPS_1200, "MILLENNIUM", {}),
    ("as1200", GAPS_1200, "HD_MILLENNIUM", {"y_field_size": 90, "profile_width": 8}),
]


@pytest.mark.parametrize("image,gaps,mlc,kwargs", CASES)
def test_dlg_matches_jax(jdlg, images, image, gaps, mlc, kwargs):
    j, t = _both(jdlg, images[image], gaps, mlc, **kwargs)
    assert t.planned_dlg_per_leaf == j.planned_dlg_per_leaf
    assert len(t.measured_dlg_per_leaf) == len(j.measured_dlg_per_leaf) > 10
    np.testing.assert_array_equal(t.measured_dlg_per_leaf, j.measured_dlg_per_leaf)
    assert t.measured_dlg == j.measured_dlg
    assert t._lin_fit == pytest.approx(j._lin_fit, rel=0, abs=0)


def test_dlg_recovers_the_drawn_gap(jdlg, images):
    """The drawn depth is 300 |gap|, so the line crosses 0 at gap 0."""
    for image, gaps in (("as1000", GAPS), ("as1200", GAPS_1200)):
        _, t = _both(jdlg, images[image], gaps)
        assert t.measured_dlg == pytest.approx(0.0, abs=0.15)


def test_measured_gap_of_a_peak_and_a_dip():
    """A bump counts positive, a dip negative, as in JAX."""
    x = np.linspace(-1, 1, 101)
    bump = 10 + 5 * np.exp(-x ** 2 / 0.01)
    assert DLG._determine_measured_gap(bump) == pytest.approx(5, abs=0.01)
    assert DLG._determine_measured_gap(20 - bump) == pytest.approx(-5, abs=0.01)


def test_unanalyzed_dlg_has_no_value(images):
    t = DLG(images["as1000"])
    assert t.measured_dlg == -np.inf and t.measured_dlg_per_leaf == []


def test_array_layer_matches_jax():
    """``ArrayLayer`` adds a prepared array at the image centre, cropped to
    the smaller of the two and clipped to the image's dtype, as JAX's."""
    from pylinac_tpu.imggen.layers import ArrayLayer as JArrayLayer

    from pylinac_tpu_torch.imggen.layers import ArrayLayer

    rng = np.random.default_rng(5)
    base = rng.integers(0, 60000, (40, 50)).astype(np.uint16)
    for other in (rng.integers(0, 9000, (30, 64)).astype(np.uint16),
                  rng.integers(0, 70000, (41, 20)).astype(np.int64)):
        np.testing.assert_array_equal(ArrayLayer(other).apply(base, 0.4, 1.0),
                                      JArrayLayer(other).apply(base, 0.4, 1.0))
