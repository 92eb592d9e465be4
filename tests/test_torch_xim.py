"""The port's Varian .xim reader and writer and the rest of ``BaseImage``
against the JAX package's, on the CPU.

``write_xim`` must write JAX's bytes; the decoded arrays, their dtypes, the
histogram and every property must equal JAX's exactly; the native decoder
(``native/xim_decode.cpp``, built with g++ at first use) must equal its
numpy twin; a truncated file must give what JAX gives: the same error, or,
where the header's sizes agree with a short payload (the decoder's return
codes -1 and -2), JAX's numpy decode. A build fault raises. The image
methods (flips, ``bit_invert``, ``rot90``, ``threshold``, ``as_binary``,
``as_type``, the shape properties, ``sum``, ``__sub__``,
``truncated_path``, ``physical_shape``, ``date_created``) are held equal
exactly; ``rotate``, a bilinear float32 interpolation, within 1e-4 of the
image's range (XLA fuses its sum of four weighted corners).
"""

import struct

import numpy as np
import pytest

from pylinac_tpu_torch import XIM
from pylinac_tpu_torch import native as tnative
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import xim as txim

PROPS = {"PixelWidth": 0.0336, "PixelHeight": 0.0336, "GantryRtn": 180.0,
         "MVCollimatorRtn": 180.0, "CouchRtn": 180.0, "Energy": 6000, "Name": "open field",
         "Offsets": [0.5, -1.25, 3.0]}


@pytest.fixture(scope="module")
def jax_xim(tmp_path_factory):
    """JAX's XIM modules, with JAX's native decoder built into a private
    folder: its loader compiles in place, which races between workers."""
    import pylinac_tpu.native as jnative
    from pylinac_tpu.core import image as jimage
    from pylinac_tpu.core import xim as jxim

    build = tmp_path_factory.mktemp("jax_native_build")
    old = jnative._BUILD_DIR
    jnative._BUILD_DIR = build
    jnative._lib_cache.pop("xim_decode", None)
    yield jxim, jimage
    jnative._lib_cache.pop("xim_decode", None)
    jnative._BUILD_DIR = old


def _arrays():
    rng = np.random.default_rng(11)
    return {
        "small": rng.integers(0, 5000, (40, 50)).astype(np.int32),
        "bytes": rng.integers(-100, 100, (17, 23)).astype(np.int32),
        "large_diffs": (rng.integers(0, 2, (30, 30)) * 40000
                        + rng.integers(0, 200, (30, 30))).astype(np.int32),
        "wide_range": rng.integers(-5000, 60000, (97, 131)).astype(np.int32),
        "epid": (rng.normal(12000, 300, (64, 80))).astype(np.uint16),
        "one_row_more": rng.integers(0, 1000, (2, 9)).astype(np.int32),
    }


ARRAYS = _arrays()


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_write_xim_writes_jax_bytes(jax_xim, tmp_path, name):
    jxim, _ = jax_xim
    jxim.write_xim(tmp_path / "j.xim", ARRAYS[name], PROPS)
    txim.write_xim(tmp_path / "t.xim", ARRAYS[name], PROPS)
    assert (tmp_path / "t.xim").read_bytes() == (tmp_path / "j.xim").read_bytes()


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_decode_matches_jax(jax_xim, tmp_path, name):
    jxim, _ = jax_xim
    path = tmp_path / "x.xim"
    txim.write_xim(path, ARRAYS[name], PROPS)
    j, t = jxim.XimImage(path), txim.XimImage(path)
    assert t.array.dtype == j.array.dtype
    np.testing.assert_array_equal(t.array, j.array)
    np.testing.assert_array_equal(t.array, ARRAYS[name])
    assert t.histogram == j.histogram
    assert list(t.properties) == list(j.properties)
    for key, value in j.properties.items():
        np.testing.assert_array_equal(t.properties[key], value)
        assert type(t.properties[key]) is type(value)
    assert (t.format_id, t.format_version, t.bits_per_pixel, t.bytes_per_pixel,
            t.compression) == (j.format_id, j.format_version, j.bits_per_pixel,
                               j.bytes_per_pixel, j.compression)
    assert t.dpmm == j.dpmm


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_native_decode_equals_numpy_twin(tmp_path, name):
    arr = ARRAYS[name]
    path = tmp_path / "x.xim"
    txim.write_xim(path, arr, PROPS)
    with open(path, "rb") as f:
        f.seek(8 + 6 * 4)
        lut = np.frombuffer(f.read(struct.unpack("<i", f.read(4))[0]), np.uint8)
        buf = np.frombuffer(f.read(struct.unpack("<i", f.read(4))[0]), np.uint8)
    h, w = arr.shape
    rc, native = tnative.xim_decode_native()(buf, lut, w, h)
    assert rc == 0
    np.testing.assert_array_equal(native, txim._decode_numpy(buf, lut, w, h))
    np.testing.assert_array_equal(native, arr)


def _rewrite(path, out, buf_keep=None, lut_keep=None):
    """The file at ``path`` with its diff buffer or lookup table cut, the
    sizes in the header made to agree."""
    data = path.read_bytes()
    off = 8 + 6 * 4
    lut_len = struct.unpack("<i", data[off:off + 4])[0]
    lut = data[off + 4:off + 4 + lut_len]
    p = off + 4 + lut_len
    buf_len = struct.unpack("<i", data[p:p + 4])[0]
    buf = data[p + 4:p + 4 + buf_len]
    rest = data[p + 4 + buf_len:]
    lut = lut if lut_keep is None else lut[:lut_keep]
    buf = buf if buf_keep is None else buf[:buf_keep]
    out.write_bytes(data[:off] + struct.pack("<i", len(lut)) + lut
                    + struct.pack("<i", len(buf)) + buf + rest)
    return out


def _outcome(fn):
    try:
        return "array", fn().array
    except Exception as e:  # the outcome to compare: which error, or the array
        return type(e).__name__, str(e)


@pytest.mark.parametrize("cut", ["file", "buffer", "lut", "seeds"])
def test_truncated_file_gives_what_jax_gives(jax_xim, tmp_path, cut):
    jxim, _ = jax_xim
    path = tmp_path / "x.xim"
    arr = ARRAYS["wide_range"]
    txim.write_xim(path, arr, PROPS)
    if cut == "file":
        bad = tmp_path / "cut.xim"
        bad.write_bytes(path.read_bytes()[:5000])
    elif cut == "buffer":  # the decoder's -1: diffs run out
        bad = _rewrite(path, tmp_path / "cut.xim", buf_keep=9000)
    elif cut == "lut":  # the decoder's -2: the lookup table runs out
        bad = _rewrite(path, tmp_path / "cut.xim", lut_keep=100)
    else:  # -1 before any diff: not even the W + 1 raw seeds
        bad = _rewrite(path, tmp_path / "cut.xim", buf_keep=100)
    j_kind, j_out = _outcome(lambda: jxim.XimImage(bad))
    t_kind, t_out = _outcome(lambda: txim.XimImage(bad))
    assert t_kind == j_kind
    if j_kind == "array":
        assert t_out.dtype == j_out.dtype
        np.testing.assert_array_equal(t_out, j_out)
    else:
        assert t_out == j_out


def test_truncated_buffer_takes_the_numpy_decode(tmp_path):
    """Return code -1 is the file's fault: the numpy decode, whose missing
    diffs read as 0, gives the image, as in JAX."""
    path = tmp_path / "x.xim"
    txim.write_xim(path, ARRAYS["wide_range"], PROPS)
    bad = _rewrite(path, tmp_path / "cut.xim", buf_keep=9000)
    img = txim.XimImage(bad)
    np.testing.assert_array_equal(img.array.ravel()[:1000],
                                  ARRAYS["wide_range"].ravel()[:1000])


def test_build_fault_raises(tmp_path, monkeypatch):
    """No quiet fallback: a decoder that cannot be built raises."""
    def no_compiler():
        raise RuntimeError("g++ not found on PATH; the host codec xim_decode.cpp needs it")

    path = tmp_path / "x.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    monkeypatch.setattr(tnative, "xim_decode_native", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        txim.XimImage(path)


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build("xim_decode")


def test_is_xim(tmp_path):
    path = tmp_path / "x.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    (tmp_path / "other.bin").write_bytes(b"not an xim at all")
    assert txim.is_xim(path)
    assert not txim.is_xim(tmp_path / "other.bin")
    assert not txim.is_xim(tmp_path / "missing.xim")


def test_load_dispatch_matches_jax(jax_xim, tmp_path):
    _, jimage = jax_xim
    path = tmp_path / "img.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    t, j = timage.load(path), jimage.load(path)
    assert isinstance(t, XIM) and isinstance(j, jimage.XIM)
    np.testing.assert_array_equal(t.array, j.array)
    assert t.dpmm == j.dpmm and t.dpi == j.dpi
    assert abs(t.dpmm - 1 / 0.336) < 1e-6
    assert list(t.properties) == list(j.properties)
    (tmp_path / "nothing.bin").write_bytes(b"neither DICOM nor XIM")
    with pytest.raises(TypeError):
        timage.load(tmp_path / "nothing.bin")


def test_header_only_read(jax_xim, tmp_path):
    jxim, _ = jax_xim
    path = tmp_path / "img.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    t = txim.XimImage(path, read_pixels=False)
    assert t.array is None and t.properties["Name"] == jxim.XimImage(path, False).properties["Name"]
    with open(path, "rb") as f:
        assert txim.XimImage(f).properties["CouchRtn"] == 180.0


def test_as_dicom_matches_jax(jax_xim, tmp_path):
    _, jimage = jax_xim
    path = tmp_path / "img.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    t, j = timage.load(path).as_dicom(), jimage.load(path).as_dicom()
    for tag in ("GantryAngle", "BeamLimitingDeviceAngle", "PatientSupportAngle", "RTImageSID",
                "ImagePlanePixelSpacing", "RTImagePosition", "Modality"):
        assert t.get(tag) == j.get(tag), tag
    np.testing.assert_array_equal(t.pixel_array, j.pixel_array)


def test_save_as_png_matches_jax(jax_xim, tmp_path):
    from PIL import Image

    _, jimage = jax_xim
    path = tmp_path / "img.xim"
    txim.write_xim(path, ARRAYS["small"], PROPS)
    timage.load(path).save_as(tmp_path / "t.png")
    jimage.load(path).save_as(tmp_path / "j.png")
    with Image.open(tmp_path / "t.png") as t, Image.open(tmp_path / "j.png") as j:
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
        assert t.text == j.text


# ---------------------------------------------------------------------------
# the rest of BaseImage
# ---------------------------------------------------------------------------
def _pair(jax_xim, arr, dpi=None):
    _, jimage = jax_xim
    return timage.ArrayImage(arr.copy(), dpi=dpi), jimage.ArrayImage(arr.copy(), dpi=dpi)


@pytest.mark.parametrize("method,args", [
    ("flipud", ()), ("fliplr", ()), ("bit_invert", ()), ("rot90", ()), ("rot90", (3,)),
    ("threshold", (2000,)), ("threshold", (2000, "low")), ("invert", ()), ("roll", ("y", 3)),
    ("crop", (3, ("top", "left"))), ("ground", ()), ("normalize", ()),
])
def test_image_methods_match_jax(jax_xim, method, args):
    t, j = _pair(jax_xim, ARRAYS["small"])
    assert getattr(t, method)(*args) == getattr(j, method)(*args)
    assert t.array.dtype == j.array.dtype
    np.testing.assert_array_equal(t.array, j.array)


@pytest.mark.parametrize("angle", [0.0, 7.5, -30.0, 90.0])
def test_rotate_matches_jax(jax_xim, angle):
    arr = np.random.default_rng(3).normal(1000, 100, (41, 57)).astype(np.float32)
    t, j = _pair(jax_xim, arr)
    t.rotate(angle)
    j.rotate(angle)
    assert t.array.dtype == j.array.dtype == np.float32
    np.testing.assert_allclose(t.array, j.array, rtol=0, atol=1e-4 * np.ptp(arr))


def test_image_properties_match_jax(jax_xim):
    arr = ARRAYS["epid"]
    t, j = _pair(jax_xim, arr, dpi=65.0)
    assert (t.size, t.ndim, t.dtype, t.shape) == (j.size, j.ndim, j.dtype, j.shape)
    assert t.sum() == j.sum()
    assert t.physical_shape == j.physical_shape
    np.testing.assert_array_equal(t.as_type(np.float32), j.as_type(np.float32))
    np.testing.assert_array_equal(t.as_binary(12000).array, j.as_binary(12000).array)
    diff_t, diff_j = t - t.as_binary(12000), j - j.as_binary(12000)
    np.testing.assert_array_equal(diff_t.array, diff_j.array)
    assert type(diff_t).__name__ == "ArrayImage"
    with pytest.raises(NotImplementedError):
        t.as_dicom()


def test_paths_and_dates_match_jax(jax_xim, tmp_path):
    _, jimage = jax_xim
    from pylinac_tpu_torch.imggen.layers import PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image

    deep = tmp_path / ("a" * 40) / "field.dcm"
    deep.parent.mkdir()
    sim = AS500Image(sid=1000)
    sim.add_layer(PerfectFieldLayer(field_size_mm=(50, 50)))
    sim.generate_dicom(str(deep))
    t, j = timage.load(str(deep)), jimage.load(str(deep))
    assert t.truncated_path == j.truncated_path and t.truncated_path.startswith("...")
    assert t.date_created() == j.date_created()
    assert t.date_created("%Y") == j.date_created("%Y")
    assert t.as_dicom() is t.metadata
    xim = tmp_path / "short.xim"
    txim.write_xim(xim, ARRAYS["small"], PROPS)
    assert timage.load(xim).truncated_path == jimage.load(xim).truncated_path


def test_bit_invert_of_floats_raises_as_jax(jax_xim):
    t, j = _pair(jax_xim, np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4))
    for img in (t, j):
        with pytest.raises(ValueError, match="could not be safely inverted"):
            img.bit_invert()


@pytest.mark.parametrize("height,width", [(1, 50), (0, 5), (4, 0)])
def test_native_decoder_refuses_too_small_images(height, width):
    """The decoder copies W + 1 raw pixels first: fewer than 2 rows would
    write past its output, so the wrapper refuses them."""
    with pytest.raises(ValueError, match="at least 2 rows"):
        tnative.xim_decode_native()(np.zeros(1000, np.uint8), np.zeros(100, np.uint8),
                                    width, height)
