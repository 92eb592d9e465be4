"""The rest of the port's ``core/`` and the ops that ACR, the cheese
phantoms and GE Helios need, against the JAX package on the CPU.

``FileImage`` on TIFF (with and without a DPI tag), PNG and 8-bit JPEG
files written here with Pillow, ``load``'s routing to it, ``tiff_to_dicom``
and the raw loaders; ``NMImageStack`` on a multi-frame NM file written
here; the eager and the lazy stack's ``__delitem__``; ``MomentMTF`` and
``EdgeSpreadFunctionMTF`` on the cases of ``tests/core/test_primitives.py``
and more; ``HighContrastDiskROI`` and ``bbox_center``; ``find_nearest_idx``,
``fill_middle_zeros``, ``threshold_li``, ``threshold_yen``,
``map_coordinates`` in mode "mirror" (float32 coordinates, several periods
out) and ``keep_largest``, whose labels are held to JAX's on the edge masks
of the generated ACR MRI low-contrast slices. Floats are compared to the
bit, arrays and masks exactly.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import mtf as tmtf
from pylinac_tpu_torch.core import roi as troi
from pylinac_tpu_torch.core.array_utils import fill_middle_zeros, find_nearest_idx
from pylinac_tpu_torch.ops import label as tlabel
from pylinac_tpu_torch.ops.interp import map_coordinates
from pylinac_tpu_torch.ops.threshold import threshold_li, threshold_yen


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jimage():
    import pylinac_tpu.core.image as jimage

    return jimage


# --------------------------------------------------------------------------
# FileImage and the raw loaders
# --------------------------------------------------------------------------
def _write_image(path, array, mode, **save):
    from PIL import Image

    Image.fromarray(array, mode=mode).save(path, **save)
    return str(path)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("file_images")
    rng = np.random.default_rng(14)
    u16 = rng.integers(0, 60000, (40, 56)).astype(np.uint16)
    u8 = rng.integers(0, 255, (40, 56)).astype(np.uint8)
    rgb = rng.integers(0, 255, (30, 20, 3)).astype(np.uint8)
    return {
        "tiff_dpi": _write_image(d / "dpi.tif", u16, "I;16", dpi=(150, 150)),
        "tiff": _write_image(d / "plain.tif", u16, "I;16"),
        "png": _write_image(d / "img.png", u8, "L"),
        "png_rgb": _write_image(d / "rgb.png", rgb, "RGB"),
        "jpeg": _write_image(d / "img.jpg", u8, "L", quality=90),
        "jpeg_dpi": _write_image(d / "dpi.jpg", u8, "L", dpi=(72, 72)),
    }


FILE_CASES = [("tiff_dpi", {}), ("tiff", {}), ("tiff", {"dpi": 100}),
              ("tiff_dpi", {"sid": 1500}), ("tiff", {"dpi": 100, "sid": 500}),
              ("png", {}), ("png_rgb", {}), ("jpeg", {}), ("jpeg_dpi", {}),
              ("jpeg", {"dtype": np.float32}), ("png", {"dpi": 2})]


@pytest.mark.parametrize("name,kwargs", FILE_CASES)
def test_file_image_matches_jax(jimage, image_files, name, kwargs):
    path = image_files[name]
    t = timage.load(path, **kwargs)
    j = jimage.load(path, **kwargs)
    assert type(t).__name__ == type(j).__name__ == "FileImage"
    assert t.array.dtype == j.array.dtype
    np.testing.assert_array_equal(t.array, j.array)
    assert t.dpi == j.dpi and t.dpmm == j.dpmm
    assert t.path == j.path and t.center == j.center


def test_file_image_dpi_tag(image_files):
    assert timage.FileImage(image_files["tiff_dpi"]).dpi == pytest.approx(150)
    assert timage.FileImage(image_files["tiff"]).dpi is None
    assert timage.FileImage(image_files["tiff"]).dpmm is None
    assert timage.FileImage(image_files["tiff_dpi"], sid=1500).dpmm == \
        pytest.approx(150 * 1.5 / 25.4)


def test_load_rejects_what_is_no_image(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(TypeError, match="Image file"):
        timage.load(str(junk))


def test_tiff_to_dicom_matches_jax(jimage, image_files):
    t = timage.tiff_to_dicom(image_files["tiff_dpi"], sid=1000, gantry=90, coll=10, couch=5)
    j = jimage.tiff_to_dicom(image_files["tiff_dpi"], sid=1000, gantry=90, coll=10, couch=5)
    np.testing.assert_array_equal(t.pixel_array, j.pixel_array)
    for tag in ("GantryAngle", "BeamLimitingDeviceAngle", "PatientSupportAngle", "RTImageSID"):
        assert float(getattr(t, tag)) == float(getattr(j, tag))
    assert [float(v) for v in t.ImagePlanePixelSpacing] == \
        [float(v) for v in j.ImagePlanePixelSpacing]
    with pytest.raises(ValueError, match="DPI"):
        timage.tiff_to_dicom(image_files["tiff"], sid=1000, gantry=0, coll=0, couch=0)
    d = timage.tiff_to_dicom(image_files["tiff"], sid=1000, gantry=0, coll=0, couch=0, dpi=50)
    assert float(d.ImagePlanePixelSpacing[0]) == pytest.approx(25.4 / 50)


def test_raw_loaders_match_jax(jimage, tmp_path):
    rng = np.random.default_rng(3)
    f32 = rng.random((6, 9)).astype("<f4")
    u16 = rng.integers(0, 65535, (5, 7)).astype("<u2")
    f32.tofile(tmp_path / "vrt.raw")
    u16.tofile(tmp_path / "ck.raw")
    t = timage.load_raw_visionrt(tmp_path / "vrt.raw", shape=(6, 9))
    j = jimage.load_raw_visionrt(tmp_path / "vrt.raw", shape=(6, 9))
    np.testing.assert_array_equal(t.array, j.array)
    assert t.array.dtype == j.array.dtype
    t = timage.load_raw_cyberknife(tmp_path / "ck.raw", shape=(5, 7))
    j = jimage.load_raw_cyberknife(tmp_path / "ck.raw", shape=(5, 7))
    np.testing.assert_array_equal(t.array, j.array)
    assert t.array.dtype == j.array.dtype


# --------------------------------------------------------------------------
# NMImageStack and the stacks' deletion
# --------------------------------------------------------------------------
def _nm_file(path, frames: np.ndarray, modality: str = "NM") -> str:
    ds = tdcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.20"
    ds.SOPInstanceUID = tdcm.generate_uid()
    ds.Modality = modality
    ds.PatientName = "NM^Synthetic"
    ds.PixelSpacing = [2.0, 2.0]
    ds.set_pixel_data(frames)
    tdcm.dcmwrite(str(path), ds)
    return str(path)


@pytest.mark.parametrize("n_frames", [1, 4])
def test_nm_stack_matches_jax(jimage, tmp_path, n_frames):
    frames = np.random.default_rng(n_frames).integers(0, 4000, (n_frames, 24, 32))
    path = _nm_file(tmp_path / "nm.dcm", frames.astype(np.uint16).squeeze())
    t, j = timage.NMImageStack(path), jimage.NMImageStack(path)
    assert len(t) == len(j) == n_frames
    assert len(t.images) == n_frames and t.images is t.frames
    for tf, jf in zip(t.frames, j.frames):
        assert tf.array.dtype == jf.array.dtype == np.float64
        np.testing.assert_array_equal(tf.array, jf.array)
        assert tf.metadata is t.metadata
    np.testing.assert_array_equal(t.as_3d_array(), j.as_3d_array())
    assert t.as_3d_array().dtype == np.float32


def test_nm_stack_rejects_other_modalities(tmp_path):
    path = _nm_file(tmp_path / "ct.dcm", np.zeros((8, 8), np.uint16), modality="CT")
    with pytest.raises(ValueError, match="NM"):
        timage.NMImageStack(path)


@pytest.fixture(scope="module")
def ct_folder(tmp_path_factory):
    from pylinac_tpu_torch.imggen.ct import generate_acr_ct

    d = tmp_path_factory.mktemp("del_stack")
    generate_acr_ct(d, num_slices=6, image_size=64, mm_per_pixel=4.0)
    return str(d)


@pytest.mark.parametrize("stack_cls", ["DicomImageStack", "LazyDicomImageStack"])
def test_stack_delitem_drops_image_and_metadata_once(jimage, ct_folder, stack_cls):
    """Deleting a slice drops it and its metadata; ``metadatas`` is a new
    list, so deleting from it changes nothing (JAX's eager semantics)."""
    t = getattr(timage, stack_cls)(ct_folder, min_number=4)
    j = jimage.DicomImageStack(ct_folder, min_number=4)
    for stack in (t, j):
        del stack[4]
        del stack.metadatas[1]
        del stack[0]
    assert len(t) == len(j) == 4 and len(t.metadatas) == 4
    assert [m.InstanceNumber for m in t.metadatas] == [m.InstanceNumber for m in j.metadatas]
    assert [t[i].z_position for i in range(4)] == [j[i].z_position for i in range(4)]
    np.testing.assert_array_equal(t[3].array, j[3].array)
    assert t.slice_spacing == j.slice_spacing


# --------------------------------------------------------------------------
# MTFs and ROIs
# --------------------------------------------------------------------------
def _esf(sigma: float, n: int = 200) -> np.ndarray:
    from scipy.special import erf

    x = np.arange(n) - n / 2
    return 0.5 * (1 + erf(x / (sigma * np.sqrt(2))))


MOMENT_CASES = [([0.2, 0.4, 0.8], [1000, 1000, 1000], [500, 300, 100]),
                ([0.1, 0.5], [2000.0, 1500.0], [900.0, 300.0])]


@pytest.mark.parametrize("lpmms,means,stds", MOMENT_CASES)
def test_moment_mtf_matches_jax(lpmms, means, stds):
    from pylinac_tpu.core import mtf as jmtf

    t, j = tmtf.MomentMTF(lpmms, means, stds), jmtf.MomentMTF(lpmms, means, stds)
    assert t.mtfs == j.mtfs and t.fwhms == j.fwhms
    vals = list(t.mtfs.values())
    assert vals == sorted(vals, reverse=True)
    assert tmtf.moments_mtf(1000, 500) == jmtf.moments_mtf(1000, 500)
    assert tmtf.moments_fwhm(2.5, 1000, 500) == jmtf.moments_fwhm(2.5, 1000, 500)


def test_moment_mtf_from_diskset_matches_jax():
    from pylinac_tpu.core import mtf as jmtf
    from pylinac_tpu.core import roi as jroi
    from pylinac_tpu.core.geometry import Point as JPoint

    from pylinac_tpu_torch.core.geometry import Point

    arr = np.random.default_rng(5).normal(1000, 300, (64, 64))
    centres = [(20, 20), (40, 30), (30, 45)]
    tdisks = [troi.DiskROI(arr, 6, Point(x, y)) for x, y in centres]
    jdisks = [jroi.DiskROI(arr, 6, JPoint(x, y)) for x, y in centres]
    t = tmtf.MomentMTF.from_high_contrast_diskset([0.2, 0.4, 0.6], tdisks)
    j = jmtf.MomentMTF.from_high_contrast_diskset([0.2, 0.4, 0.6], jdisks)
    assert t.mtfs == j.mtfs and t.fwhms == j.fwhms


ESF_CASES = [
    ({"sigmas": [1.0]}, {"sample_spacing": 0.5}),
    ({"sigmas": [4.0]}, {"sample_spacing": 0.5}),
    ({"sigmas": [1.0, 2.0], "n": [200, 300]}, {}),
    ({"sigmas": [2.0, 3.0]}, {"padding_mode": "none"}),
    ({"sigmas": [2.0]}, {"padding_mode": "fixed", "num_samples": 512}),
    ({"sigmas": [1.5]}, {"windowing": None}),
    ({"sigmas": [1.5], "n": [1500]}, {"sample_spacing": 0.2}),
]


@pytest.mark.parametrize("esfs,kwargs", ESF_CASES)
def test_esf_mtf_matches_jax(esfs, kwargs):
    from pylinac_tpu.core import mtf as jmtf

    ns = esfs.get("n", [200] * len(esfs["sigmas"]))
    data = [_esf(s, n) for s, n in zip(esfs["sigmas"], ns)]
    t = tmtf.EdgeSpreadFunctionMTF(data, **kwargs)
    j = jmtf.EdgeSpreadFunctionMTF(data, **kwargs)
    np.testing.assert_array_equal(t.mtf, j.mtf)
    np.testing.assert_array_equal(t.freq, j.freq)
    for x in (10, 30, 50, 80):
        assert t.relative_resolution(x) == j.relative_resolution(x)


def test_esf_mtf_sharper_edge_resolves_more():
    sharp = tmtf.EdgeSpreadFunctionMTF([_esf(1.0)], sample_spacing=0.5)
    blurry = tmtf.EdgeSpreadFunctionMTF([_esf(4.0)], sample_spacing=0.5)
    assert sharp.relative_resolution(50) > blurry.relative_resolution(50)
    with pytest.raises(ValueError):
        tmtf.EdgeSpreadFunctionMTF([np.ones(10), np.ones(12)], padding_mode="none")
    with pytest.raises(ValueError):
        tmtf.EdgeSpreadFunctionMTF([np.ones(600)], padding_mode="fixed", num_samples=512)
    np.testing.assert_array_equal(tmtf._hann_window(1), np.ones(1))


def test_peak_valley_mtf_is_mtf():
    m = tmtf.PeakValleyMTF([0.1, 0.2, 0.3], [100, 90, 80], [0, 20, 40])
    assert isinstance(m, tmtf.MTF) and m.norm_mtfs[0.1] == 1.0


def test_high_contrast_disk_roi_matches_jax():
    from pylinac_tpu.core import roi as jroi
    from pylinac_tpu.core.geometry import Point as JPoint

    from pylinac_tpu_torch.core.geometry import Point

    arr = np.random.default_rng(9).normal(0, 100, (80, 90))
    t = troi.HighContrastDiskROI.from_phantom_center(arr, 33.0, 7.5, 20.0, Point(45, 40), 1.0)
    j = jroi.HighContrastDiskROI.from_phantom_center(arr, 33.0, 7.5, 20.0, JPoint(45, 40), 1.0)
    assert (t.max, t.min, t.mean, t.std, t.pixel_value) == (j.max, j.min, j.mean, j.std,
                                                            j.pixel_value)
    assert t.contrast_threshold == 1.0 and repr(t) == repr(j)
    assert t.as_dict() == j.as_dict()


def test_bbox_center_matches_jax():
    from types import SimpleNamespace

    from pylinac_tpu.core.roi import bbox_center as jbbox

    for bbox in [(2, 3, 10, 21), (10, 21, 2, 3), (0, 0, 1, 1)]:
        region = SimpleNamespace(bbox=bbox)
        t, j = troi.bbox_center(region), jbbox(region)
        assert (t.x, t.y) == (j.x, j.y)


# --------------------------------------------------------------------------
# array utilities, thresholds, interpolation
# --------------------------------------------------------------------------
def test_find_nearest_idx_and_fill_middle_zeros_match_jax():
    from pylinac_tpu.core import array_utils as jau

    rng = np.random.default_rng(2)
    values = rng.random(50)
    for v in (0.0, 0.5, 0.99, 2.0):
        assert find_nearest_idx(values, v) == jau.find_nearest_idx(values, v)
    profile = np.zeros(60)
    profile[10:50] = 1
    profile[[20, 21, 33]] = 0
    for cutoff in (0, 3, 12):
        np.testing.assert_array_equal(fill_middle_zeros(profile, cutoff_px=cutoff),
                                      jau.fill_middle_zeros(profile, cutoff_px=cutoff))
    with pytest.raises(ValueError):
        fill_middle_zeros(profile * 2)


THRESHOLD_IMAGES = {
    "bimodal": lambda rng: np.concatenate([rng.normal(100, 10, 3000),
                                           rng.normal(900, 50, 1000)]).reshape(40, 100),
    "uint16": lambda rng: rng.integers(0, 4096, (64, 64)).astype(np.uint16),
    "negative": lambda rng: rng.normal(-500, 200, (32, 48)),
    "nan": lambda rng: np.where(rng.random((30, 30)) < 0.1, np.nan, rng.random((30, 30))),
}


@pytest.mark.parametrize("kind", list(THRESHOLD_IMAGES))
def test_thresholds_match_jax(kind):
    from pylinac_tpu.ops.threshold import threshold_li as jli
    from pylinac_tpu.ops.threshold import threshold_yen as jyen

    img = THRESHOLD_IMAGES[kind](np.random.default_rng(len(kind)))
    assert threshold_li(img) == jli(img)
    assert threshold_li(img, tolerance=0.5) == jli(img, tolerance=0.5)
    assert threshold_yen(img) == jyen(img)
    assert threshold_yen(img, nbins=64) == jyen(img, nbins=64)


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_map_coordinates_mirror_matches_jax(kind):
    """Order 1, mode "mirror", at float32 coordinates up to four periods
    out on each side, and the ACR diagonal's lines."""
    import jax.numpy as jnp

    from pylinac_tpu.ops.interp import map_coordinates as jmap

    rng = np.random.default_rng(11)
    img = rng.random((37, 41)).astype(np.float32)
    if kind == "binary":
        img = (img > 0.5).astype(np.float32)
    coords = np.stack([rng.uniform(-150, 150, 4000), rng.uniform(-160, 160, 4000)])
    xs = np.arange(41)
    lines = [np.stack([slope * xs + 18.3 - slope * 20.1, xs]) for slope in (1, -1)]
    for c in [coords] + lines:
        want = np.asarray(jmap(jnp.asarray(img), jnp.asarray(c), order=1, mode="mirror"))
        got = map_coordinates(torch.from_numpy(img), torch.from_numpy(c.astype(np.float32)),
                              mode="mirror").numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        map_coordinates(torch.from_numpy(img), torch.zeros(2, 3), mode="wrap")


@pytest.mark.parametrize("p,K", [(0.3, 5), (0.5, 5), (0.45, 64), (0.2, 1)])
def test_keep_largest_matches_jax_on_random_masks(p, K):
    import jax.numpy as jnp

    from pylinac_tpu.ops import label as jlabel

    mask = np.random.default_rng(int(p * 100) + K).random((64, 80)) < p
    want = np.asarray(jlabel.keep_largest(jnp.asarray(mask), K=K))
    got = tlabel.keep_largest(torch.from_numpy(mask), K=K).numpy()
    np.testing.assert_array_equal(got, want)
    kept = tlabel.regionprops(torch.from_numpy(got), K=K + 16, connectivity=1, hull=False)
    assert 0 < int(kept.valid.sum()) < K + 16  # ties may keep a few more than K


def test_keep_largest_min_area():
    mask = np.zeros((20, 20), bool)
    mask[1:3, 1:3] = True   # 4 px
    mask[6:9, 6:9] = True   # 9 px
    mask[12, 12] = True     # 1 px
    got = tlabel.keep_largest(torch.from_numpy(mask), K=3, min_area=4).numpy()
    np.testing.assert_array_equal(got, mask & ~(np.arange(400).reshape(20, 20) == 252))


@pytest.fixture(scope="module")
def mr_series(tmp_path_factory):
    from pylinac_tpu_torch.imggen.mri import generate_acr_mri

    d = tmp_path_factory.mktemp("mr_edges")
    return sorted(generate_acr_mri(d, include_sagittal=False))


def test_mr_edge_masks_and_keep_largest_match_jax(mr_series):
    """The MR low-contrast search on slices 8-11: the Scharr, Gaussian and
    Otsu x 0.8 edge mask equal to JAX's pixel for pixel, ``keep_largest``'s
    kept regions equal (JAX's label, capped at 64 rounds, reaches the
    fixpoint here), and the region properties the module reads (valid
    slots, area, centroid) equal."""
    import jax.numpy as jnp

    from pylinac_tpu.ops import label as jlabel
    from pylinac_tpu.ops.filters import gaussian_filter as jgauss
    from pylinac_tpu.ops.filters import scharr as jscharr
    from pylinac_tpu.ops.threshold import otsu_threshold as jotsu

    from pylinac_tpu_torch.ops.filters import gaussian_filter, scharr
    from pylinac_tpu_torch.ops.threshold import otsu_threshold

    for path in mr_series[7:11]:
        arr = tdcm.dcmread(path).pixel_array.astype(np.float32)
        jedges = jgauss(jscharr(jnp.asarray(arr)), 1.0)
        jmask = np.asarray(jedges > float(jotsu(jedges)) * 0.8)
        tedges = gaussian_filter(scharr(torch.from_numpy(arr)), 1.0)
        tmask = (tedges > otsu_threshold(tedges) * 0.8).numpy()
        np.testing.assert_array_equal(tmask, jmask)
        jkept = jlabel.keep_largest(jnp.asarray(~jmask), K=64)
        tkept = tlabel.keep_largest(torch.from_numpy(~tmask), K=64)
        np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept))
        jr = jlabel.regions_to_host(jlabel.regionprops(jkept, K=80, connectivity=1, hull=False))
        tr = tlabel.regionprops(tkept, K=80, connectivity=1, hull=False).to_numpy()
        np.testing.assert_array_equal(tr.valid, jr.valid)
        for field in ("area", "centroid_r", "centroid_c"):
            np.testing.assert_array_equal(getattr(tr, field)[tr.valid],
                                          getattr(jr, field)[jr.valid])
