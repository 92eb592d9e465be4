"""The port's ACR digital mammography phantom against the JAX package's, on
the CPU: detection (Canny at sigma 9, ``keep_largest``, ``regionprops``),
the masses, the speck groups and the fibres (Frangi vesselness, Yen's
threshold, a closing with a rotated footprint and ``regionprops`` on the
device), with the default and non-default ``analyze`` arguments.

Both packages read the same DICOM file, drawn by
``tests/models/test_acr_mammo.py``'s recipe with the port's
``array_to_dicom`` (:func:`draw_mammo`, pixel-equal to that file's
``make_mammo_image``). ``results_data()`` without date and version, the
results text and the warnings are compared: equal, every float to the bit
but the fibres' orientations, which come from float32 second-moment sums
that the port adds in another order (held at 1e-3 degrees; measured up to
3.5e-6 with the three-scale fibre arguments). The fibre lengths sit on
the Frangi masks, where the port's float64 ``exp`` and XLA's float32
polynomial differ in the last bits of the vesselness
(``test_torch_edges_morph.py``); on these images the Yen masks, and so
the fibre lengths, are equal. The ``cuda`` test runs the phantom on
a card against the CPU:
``python -m pytest --noconftest -m cuda tests/test_torch_planar_mammo.py``.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import pylinac_tpu_torch.planar_imaging as tp
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.core.array_utils import array_to_dicom

from tests.test_torch_planar import _data, card_agrees

ACR = tp.ACRDigitalMammography
BASE = dict(invert=False, low_contrast_visibility_threshold=400,
            speck_group_visibility_threshold=400)


def draw_mammo(path, dpmm: float = 5.0, shape=(1024, 768), noise: float = 1.0):
    """A bright 70 x 130 mm phantom block with masses, speck groups and
    fibres at the class's own geometry tables (4 strong masses, 3 groups
    of bright specks, 4 long fibres and 2 short ones)."""
    rng = np.random.default_rng(3)
    h, w = shape
    cy, cx = h / 2, w / 2
    arr = np.full((h, w), 100.0)
    half_w, half_h = 35 * dpmm, 65 * dpmm
    arr[int(cy - half_h):int(cy + half_h), int(cx - half_w):int(cx + half_w)] = 500.0
    yy, xx = np.mgrid[:h, :w]
    for idx, stng in enumerate(ACR.low_contrast_roi_settings.values()):
        a = np.deg2rad(stng["angle"])
        px = cx + np.cos(a) * stng["distance from center"] * dpmm
        py = cy + np.sin(a) * stng["distance from center"] * dpmm
        r = stng["roi radius"] * dpmm
        arr[(yy - py) ** 2 + (xx - px) ** 2 <= (r * 1.8) ** 2] = 500 + (400 if idx < 4 else 0)
    for g_idx, grp in enumerate(ACR.speck_group_roi_settings.values()):
        if g_idx >= 3:
            continue
        gx, gy = cx + grp["x offset"] * dpmm, cy + grp["y offset"] * dpmm
        for stng in ACR.speck_roi_settings.values():
            a = np.deg2rad(stng["angle"])
            sx = gx + np.cos(a) * stng["distance from center"] * dpmm
            sy = gy + np.sin(a) * stng["distance from center"] * dpmm
            arr[(yy - sy) ** 2 + (xx - sx) ** 2 <= 2.0 ** 2] = 30000
    for f_idx, stng in enumerate(ACR.fibers_roi_settings.values()):
        fx, fy = cx + stng["x offset"] * dpmm, cy + stng["y offset"] * dpmm
        length = 10 if f_idx < 4 else 3
        a = np.deg2rad(stng["fiber_orientation"])
        ts = np.linspace(-length / 2 * dpmm, length / 2 * dpmm, 200)
        lx = fx + ts * np.sin(a)
        ly = fy - ts * np.cos(a) * -1
        width = max(stng["fiber_diameter"] * dpmm / 2, 1.0)
        for t_i in range(len(ts)):
            arr[(yy - ly[t_i]) ** 2 + (xx - lx[t_i]) ** 2 <= width ** 2] = 1200
    arr += rng.normal(0, noise, arr.shape)
    ds = array_to_dicom(arr.clip(0).astype(np.uint16), sid=1000, gantry=0, coll=0, couch=0,
                        dpi=25.4 * dpmm)
    tdcm.dcmwrite(path, ds)
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
def mammo(tmp_path_factory):
    return draw_mammo(str(tmp_path_factory.mktemp("mammo") / "mammo.dcm"))


def _run(cls, path, device=None, **analyze):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = cls(path)
        obj.analyze(**analyze, **({} if device is None else {"device": device}))
        data, text = _data(obj), obj.results()
    return obj, data, text, [(str(w.message), w.category.__name__) for w in caught]


CASES = [
    {},
    {"speck_group_contrast_method": "Michelson", "speck_group_half_thresh": 3,
     "speck_group_full_thresh": 5, "low_contrast_method": "Weber"},
    {"fiber_sigmas_ratio": (0.5, 1.0, 1.5), "fiber_max_gap": 3.0, "fiber_len_half_thresh": 4,
     "fiber_len_full_thresh": 9, "fiber_orientation_tolerance": 8},
]


def _assert_agree(td, jd):
    """Equal but the fibre orientations, within 1e-3 degrees."""
    for t_roi, j_roi in zip(td["fiber_rois"], jd["fiber_rois"]):
        assert t_roi.pop("fiber_orientation") == pytest.approx(
            j_roi.pop("fiber_orientation"), abs=1e-3)
    assert json.dumps(td) == json.dumps(jd)


@pytest.mark.parametrize("analyze", CASES)
def test_mammo_matches_jax(jp, mammo, analyze):
    _, jd, jtext, jwarn = _run(jp.ACRDigitalMammography, mammo, **BASE, **analyze)
    t, td, ttext, twarn = _run(ACR, mammo, device="cpu", **BASE, **analyze)
    _assert_agree(td, jd)
    assert ttext == jtext and twarn == jwarn
    assert type(t.results_data()).__name__ == "ACRDigitalMammographyResult"
    if not analyze:
        # ``tests/models/test_acr_mammo.py``'s bars
        assert td["mass_score"] == 4 and len(td["mass_rois"]) == 6
        assert td["speck_group_score"] == pytest.approx(3.0)
        assert td["fiber_score"] == pytest.approx(4.0)
        for roi in td["fiber_rois"][:4]:
            assert roi["fiber_length"] == pytest.approx(12, abs=4)
        assert t.phantom_center.x == pytest.approx(768 / 2, abs=12)
        assert t.phantom_center.y == pytest.approx(1024 / 2, abs=12)


def test_speck_centres_are_the_full_frame_argmax(mammo):
    """Each speck's centre, taken over its disk's window, is the pixel the
    JAX code takes: ``nanargmax`` of the full-frame masked array of the
    search disk."""
    from pylinac_tpu_torch.core.roi import DiskROI

    t, *_ = _run(ACR, mammo, device="cpu", **BASE)
    n = 0
    for group in t.speck_groups:
        for stng, speck in zip(ACR.speck_roi_settings.values(), group.specks):
            center = DiskROI._get_shifted_center(stng["angle"],
                                                 t.dpmm * stng["distance from center"],
                                                 group.center)
            disk = DiskROI(t.image.array, t.dpmm * stng["search_radius"], center)
            yy, xx = np.mgrid[:t.image.array.shape[0], :t.image.array.shape[1]]
            inside = ((yy - center.y) / disk.radius) ** 2 + ((xx - center.x) / disk.radius) ** 2 < 1
            full = np.where(inside, t.image.array, np.nan)
            row, col = np.unravel_index(np.nanargmax(full), full.shape)
            assert (speck.center.x, speck.center.y) == (int(col), int(row))
            assert disk.masked_argmax() == speck.center
            n += 1
    assert n == 36


def test_drawing_matches_jax(mammo, tmp_path):
    from pylinac_tpu.core import dcm as jdcm
    from tests.models.test_acr_mammo import make_mammo_image

    make_mammo_image(str(tmp_path / "j.dcm"))
    np.testing.assert_array_equal(tdcm.dcmread(mammo).pixel_array,
                                  jdcm.dcmread(str(tmp_path / "j.dcm")).pixel_array)


def test_fiber_masks_equal_jax(jp, mammo):
    """The fibre ROIs' vesselness thresholds and closed masks, ROI by ROI."""
    import jax.numpy as jnp

    from pylinac_tpu.ops import morphology as jmorph
    from pylinac_tpu.ops.threshold import threshold_yen as jyen
    from pylinac_tpu.ops.vesselness import frangi as jfrangi

    from pylinac_tpu_torch.ops import morphology as tmorph
    from pylinac_tpu_torch.ops.threshold import threshold_yen
    from pylinac_tpu_torch.ops.vesselness import frangi

    t, *_ = _run(ACR, mammo, device="cpu", **BASE)
    dpmm = t.dpmm
    for stng, fiber in zip(ACR.fibers_roi_settings.values(), t.fibers):
        arr = fiber.pixel_array.astype(np.float32)
        sig = tuple(float(s * dpmm * stng["fiber_diameter"]) for s in (0.75, 1))
        jv = np.asarray(jfrangi(jnp.asarray(arr), sigmas=sig))
        tv = frangi(torch.from_numpy(arr), sig).numpy()
        np.testing.assert_allclose(tv, jv, rtol=0, atol=2.4e-7)
        jb, tb = jv > jyen(jv), tv > threshold_yen(tv)
        np.testing.assert_array_equal(tb, jb)
        fp = jmorph.rotate_footprint(np.ones((5, int(np.ceil(dpmm * 2)))),
                                     -stng["fiber_orientation"])
        np.testing.assert_array_equal(tmorph.binary_closing(torch.from_numpy(tb), fp).numpy(),
                                      np.asarray(jmorph.binary_closing(jnp.asarray(jb), fp)))


@pytest.mark.cuda
def test_card_matches_cpu(cuda, mammo):
    from pylinac_tpu_torch.ops import ccl

    l0 = ccl.label_batch.launches
    _, cd, ctext, cwarn = _run(ACR, mammo, device="cuda", **BASE)
    _, hd, htext, hwarn = _run(ACR, mammo, device="cpu", **BASE)
    card_agrees(cd, hd)
    assert ctext == htext and cwarn == hwarn
    # Canny and keep_largest, regionprops, one regionprops a fibre
    assert ccl.label_batch.launches - l0 >= 3 + len(ACR.fibers_roi_settings)
