"""The port's single-image PicketFence against the JAX package's, on the CPU.

Both load the same DICOM files, made by the JAX image generator as its own
tests make them (``tests/models/test_picketfence.py``): a perfect AS1200
fence of 10 pickets, the same with a 0.4 mm offset picket, the perfect
fence under the HD Millennium MLC and with separated leaves, a left-right
fence, and an EPID-like frame (the batch test's recipe: raw x 0.5 plus a
dark offset, noise and hot pixels) that trips the de-spike, whose 3x3
medians must equal JAX's ``filter(size=3)`` bit for bit. Every
``PFResult`` field is compared at the parity bar of
``tests/test_torch_picketfence.py``: integers, flags, leaf keys and lists
exact; mm fields and the skew within 0.01; percentages within 0.1.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
from pylinac_tpu.imggen.simulators import AS1200Image
from pylinac_tpu.imggen.utils import generate_picketfence
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.ops import filters as tfilters
from pylinac_tpu_torch.ops.median import median3x3_reference
from pylinac_tpu_torch.picketfence import MLC, PFDicomImage, PicketFence, PicketFenceBatch
from tests.test_torch_picketfence import _assert_results_match, _spiked


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpf():
    import pylinac_tpu.picketfence as jpf

    return jpf


def _generate(path, **kwargs):
    generate_picketfence(
        simulator=AS1200Image(sid=1500), field_layer=PerfectFieldLayer, file_out=str(path),
        final_layers=[GaussianFilterLayer(sigma_mm=1)], picket_width_mm=3, **kwargs)
    return str(path)


@pytest.fixture(scope="module")
def pf_files(tmp_path_factory, jpf):
    tmp = tmp_path_factory.mktemp("torch_pf_single")
    files = {
        "perfect": _generate(tmp / "perfect.dcm", pickets=10, picket_spacing_mm=20),
        "offset": _generate(tmp / "offset.dcm", pickets=10, picket_spacing_mm=20,
                            picket_offset_error=[0, 0, 0.4, 0, 0, 0, 0, 0, 0, 0]),
        "left_right": _generate(tmp / "lr.dcm", pickets=5, picket_spacing_mm=30,
                                orientation=jpf.Orientation.LEFT_RIGHT),
    }
    img = timage.DicomImage(files["perfect"])
    img.array = _spiked([img.array])[0]
    files["spiked"] = img.save(str(tmp / "spiked.dcm"))
    # chip_smoke.py's two spiked frames: its recipe is _spiked's, from seed
    # 11, over the perfect frame and then the 0.4 mm offset one
    imgs = [timage.DicomImage(files[k]) for k in ("perfect", "offset")]
    for k, im, a in zip(("smoke0", "smoke1"), imgs, _spiked([im.array for im in imgs], seed=11)):
        im.array = a
        files[k] = im.save(str(tmp / f"{k}.dcm"))
    return files


def _both(jpf, path, init=None, **analyze):
    """(port, JAX) ``PicketFence`` of ``path``, analysed alike; an ``mlc``
    in ``init`` is the name of an ``MLC`` member."""
    init = dict(init or {})
    mlc = init.pop("mlc", "MILLENNIUM")
    j = jpf.PicketFence(path, mlc=getattr(jpf.MLC, mlc), **init)
    j.analyze(**analyze)
    t = PicketFence(path, mlc=getattr(MLC, mlc), device="cpu", **init)
    t.analyze(**analyze)
    return t, j


@pytest.mark.parametrize("case, init, analyze", [
    ("perfect", {}, {}),
    ("offset", {}, {}),
    ("perfect", {}, dict(separate_leaves=True, nominal_gap_mm=3)),
    ("perfect", {"mlc": "HD_MILLENNIUM"}, {}),
    ("left_right", {}, {}),
    ("perfect", {"filter": 3}, dict(action_tolerance=0.25)),
], ids=["perfect", "offset", "separate_leaves", "hd_mlc", "left_right", "filter"])
def test_picketfence_matches_jax(jpf, pf_files, case, init, analyze):
    t, j = _both(jpf, pf_files[case], init, tolerance=0.5, **analyze)
    _assert_results_match(t.results_data(), j.results_data())
    assert t.results() == j.results()
    assert t.orientation.value == j.orientation.value
    assert t.results_data().number_of_pickets == (5 if case == "left_right" else 10)


def test_offset_picket_shows_in_its_distance(jpf, pf_files):
    perfect, _ = _both(jpf, pf_files["perfect"], tolerance=0.5)
    offset, _ = _both(jpf, pf_files["offset"], tolerance=0.5)
    shift = (offset.results_data().offsets_from_cax_mm[2]
             - perfect.results_data().offsets_from_cax_mm[2])
    assert abs(shift) == pytest.approx(0.4, abs=0.05)


def test_spiked_frame_despikes_as_jax(jpf, pf_files, monkeypatch):
    calls = []

    def spy(x):
        calls.append(tuple(x.shape))
        return median3x3_reference(x)

    monkeypatch.setattr(tfilters, "median3x3", spy)
    j = jpf.PFDicomImage(pf_files["spiked"])
    t = PFDicomImage(pf_files["spiked"], device="cpu")
    assert len(calls) >= 1
    assert t.array.dtype == j.array.dtype
    np.testing.assert_array_equal(t.array, j.array)
    t_pf, j_pf = _both(jpf, pf_files["spiked"], tolerance=0.5)
    _assert_results_match(t_pf.results_data(), j_pf.results_data())


def test_from_multiple_images_matches_jax(jpf, pf_files):
    paths = [pf_files["perfect"], pf_files["perfect"]]
    j = jpf.PicketFence.from_multiple_images(paths)
    j.analyze(tolerance=0.5)
    t = PicketFence.from_multiple_images(paths, device="cpu")
    t.analyze(tolerance=0.5)
    _assert_results_match(t.results_data(), j.results_data())


def test_log_is_not_ported(pf_files):
    """``log=`` reaches the log analyzer's loader: a path that is no log
    raises its ``NotALogError``. The name is kept from the stub this test
    once held; ``log=`` is ported, and tests/test_torch_log_analyzer.py
    holds it to JAX."""
    from pylinac_tpu_torch.log_analyzer import NotALogError

    with pytest.raises(NotALogError, match="machine.bin"):
        PicketFence(pf_files["perfect"], log="machine.bin", device="cpu")


def test_without_device_needs_cuda(pf_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PicketFence(pf_files["perfect"])


def test_from_bb_setup_matches_jax(jpf, pf_files, tmp_path):
    """A BB 1 mm off the image centre moves the CAX the offsets are taken
    from; the BB search runs on the CPU."""
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer as TGauss
    from pylinac_tpu_torch.imggen.layers import PerfectBBLayer, PerfectFieldLayer as TField
    from pylinac_tpu_torch.imggen.simulators import AS1200Image as TAS1200

    bb = str(tmp_path / "bb.dcm")
    sim = TAS1200(sid=1500)
    sim.add_layer(TField(field_size_mm=(50, 50)))
    sim.add_layer(PerfectBBLayer(bb_size_mm=5, cax_offset_mm=(1, 0)))
    sim.add_layer(TGauss(sigma_mm=1))
    sim.generate_dicom(bb)
    j = jpf.PicketFence.from_bb_setup(pf_files["perfect"], bb_image=bb, bb_diameter=5)
    j.analyze(tolerance=0.5)
    t = PicketFence.from_bb_setup(pf_files["perfect"], bb_image=bb, bb_diameter=5,
                                  device="cpu")
    t.analyze(tolerance=0.5)
    _assert_results_match(t.results_data(), j.results_data())
    plain, _ = _both(jpf, pf_files["perfect"], tolerance=0.5)
    assert t.results_data().cax != plain.results_data().cax


def _window_shift_mm(pf) -> np.ndarray:
    """Each picket's offset from the CAX less the batch's, as the single
    class's kiss windows predict it: they start at ``int(v)`` for
    ``v = idx - spacing / 2`` (clamped at 0) but add ``v`` to the
    crossings, so the picket sits ``frac(v)`` px further from the image's
    start and its ``dist2cax`` (centre minus picket) ``frac(v) / dpmm``
    lower."""
    out = []
    for pk in pf.pickets:
        v = max(pk.mlc_meas[0]._approximate_idx - pk.mlc_meas[0]._spacing / 2, 0)
        out.append(-(v - int(v)) / pf.image.dpmm)
    return np.asarray(out)


@pytest.mark.parametrize("frame", ["smoke0", "smoke1"])
def test_single_offsets_sit_half_a_pixel_from_the_batch(jpf, pf_files, frame):
    """The reference quirk that chip_smoke.py's single-against-batch check
    allows for, pinned in the JAX package and the port alike on the smoke's
    own spiked frames: the picket spacing is odd (89 px), so every single
    offset is half a pixel (0.112 mm) below the batch's, and the rest of
    the gap is within the batch bar of 2e-3 mm."""
    path = pf_files[frame]
    t, j = _both(jpf, path, tolerance=0.5)
    jb = jpf.PicketFenceBatch([path])
    jb.analyze(tolerance=0.5)
    tb = PicketFenceBatch([path])
    tb.analyze(tolerance=0.5, device="cpu")
    for single, batch in ((j, jb), (t, tb)):
        spacing = {m._spacing for pk in single.pickets for m in pk.mlc_meas}
        assert spacing == {89.0}
        shift = _window_shift_mm(single)
        np.testing.assert_allclose(shift, -0.5 / single.image.dpmm, rtol=0, atol=1e-12)
        gap = np.subtract(single.results_data().offsets_from_cax_mm,
                          batch.results_data()[0].offsets_from_cax_mm)
        np.testing.assert_allclose(gap, shift, rtol=0, atol=2e-3)
        assert np.abs(gap).min() > 0.11
