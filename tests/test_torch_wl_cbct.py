"""Winston-Lutz from a CBCT scan and from zips, the port against the JAX
package on the CPU.

The CBCT is ``tests/models/test_winstonlutz.py:124-157``'s fixture (80
slices of 256 x 256 at 0.5 mm pixels and 1 mm slices, a 5 mm BB at 8000 HU
offset (2, -1, 3) mm in -1000 HU air, sigma 5 HU noise), written by the
port's ``_generate_cbct_bb``. Both packages make their four projections from the same
files; the port's must equal JAX's bit for bit, and its ``results_data()``
JAX's at the WL bar of ``tests/test_torch_winstonlutz.py`` (floats within
0.01, the rest exact). ``from_zip`` of a 4-frame AS500 session equals the
folder run exactly, but the date.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import WinstonLutz
from pylinac_tpu_torch.core import dcm
from pylinac_tpu_torch.imggen.ct import _generate_cbct_bb
from pylinac_tpu_torch.imggen.simulators import AS500Image
from tests.test_torch_ct_loaders import _zip
from tests.test_torch_winstonlutz import AXES_4, _generate, assert_same


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _undated(x):
    """A result dict without its ``date_of_analysis`` fields, nested ones too."""
    if isinstance(x, dict):
        return {k: _undated(v) for k, v in x.items() if k != "date_of_analysis"}
    return [_undated(v) for v in x] if isinstance(x, list) else x


@pytest.fixture(scope="module")
def cbct(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cbct")
    _generate_cbct_bb(tmp / "scan")
    return tmp / "scan", _zip(tmp / "scan", tmp / "scan.zip")


@pytest.fixture(scope="module")
def jax_wl(cbct):
    pytest.importorskip("jax")
    from pylinac_tpu.winston_lutz import WinstonLutz as JaxWinstonLutz

    wl = JaxWinstonLutz.from_cbct(cbct[0])
    wl.projections = [im.array.copy() for im in wl.images]  # analyze preprocesses them
    wl.analyze(bb_size_mm=5)
    return wl


@pytest.mark.parametrize("route", ["from_cbct", "from_cbct_zip"])
def test_cbct_matches_jax(cbct, jax_wl, route):
    wl = (WinstonLutz.from_cbct(cbct[0]) if route == "from_cbct"
          else WinstonLutz.from_cbct_zip(cbct[1]))
    assert wl.is_from_cbct and not WinstonLutz.is_from_cbct
    assert [im.gantry_angle for im in wl.images] == [im.gantry_angle for im in jax_wl.images]
    for got, want in zip(wl.images, jax_wl.projections):
        assert got.array.dtype == want.dtype
        np.testing.assert_array_equal(got.array, want)
    wl.analyze(bb_size_mm=5, device="cpu")
    data = wl.results_data()
    assert_same(data.model_dump(), jax_wl.results_data().model_dump())
    # tests/models/test_winstonlutz.py:159-170: the planted offset
    assert data.max_2d_cax_to_bb_mm == pytest.approx(3.61, abs=0.2)
    sv = wl.bb_shift_vector
    assert (sv.x, sv.y, sv.z) == pytest.approx((1.0, -3.0, -2.0), abs=0.2)


def test_cbct_forces_a_low_density_bb_in_an_open_field(cbct, jax_wl):
    """The arguments ``analyze`` is given do not change a CBCT analysis."""
    wl = WinstonLutz.from_cbct(cbct[0])
    wl.analyze(bb_size_mm=5, low_density_bb=False, open_field=False, device="cpu")
    assert_same(wl.results_data().model_dump(), jax_wl.results_data().model_dump())


def test_cbct_generator_is_the_jax_fixture(cbct):
    """The generator's pixels are the JAX test fixture's recipe."""
    nz, ny, nx = 80, 256, 256
    cy, cx, cz = (ny - 1) / 2, (nx - 1) / 2, (nz - 1) / 2
    vol = np.full((nz, ny, nx), -1000.0)
    yy, xx = np.mgrid[:ny, :nx]
    for z in range(nz):
        r2_mm = 2.5**2 - ((z - cz) * 1.0 - 3.0) ** 2
        if r2_mm > 0:
            vol[z][((yy - cy + 1.0 / 0.5) ** 2 + (xx - cx - 2.0 / 0.5) ** 2) * 0.25 <= r2_mm] = 8000.0
    vol += np.random.default_rng(0).normal(0, 5, vol.shape)
    want = np.clip(vol + 1024, 0, 65535).astype(np.uint16)
    got = np.stack([dcm.dcmread(str(p)).pixel_array for p in sorted(cbct[0].iterdir())])
    np.testing.assert_array_equal(got, want)


def test_too_few_cbct_slices_raise(tmp_path):
    with pytest.raises((ValueError, FileNotFoundError)):
        WinstonLutz.from_cbct(tmp_path)


def test_from_zip_equals_the_folder_run(tmp_path):
    folder = tmp_path / "wl"
    _generate(str(folder), AS500Image, image_axes=AXES_4, offset_mm_left=0.5, offset_mm_up=0.3)
    ref = WinstonLutz(str(folder))
    ref.analyze(device="cpu")
    wl = WinstonLutz.from_zip(_zip(folder, tmp_path / "wl.zip"))
    wl.analyze(device="cpu")
    assert _undated(wl.results_data(as_dict=True)) == _undated(ref.results_data(as_dict=True))
    assert len(wl.images) == 4
