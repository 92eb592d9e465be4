"""The port's compressed DICOM codecs against the JAX package's, on the CPU.

RLE Lossless, JPEG Lossless (process 14 and SV1), JPEG-LS Lossless and JPEG
2000 (lossless and .91): each round-trips through the port's ``dcmwrite``
and ``dcmread``; the port's bytes decode in the JAX package and the JAX
package's in the port; each host C++ decoder equals its Python twin, value
for value (JPEG 2000 has no Python decoder in either package, so it is held
by the round trip and against the JAX package's C++ decoder); a multi-frame
RLE file, frames split over fragments, lossy and near-lossless streams and
an unsupported transfer syntax behave as in the JAX package. Frames are
small (64 x 80) so the Python twins stay fast. Equality is exact.

The JAX package's own C++ codecs are built into a private folder here: its
loader compiles in place, which can race with its own tests under xdist.
"""

import io
import struct

import numpy as np
import pytest

import pylinac_tpu.native as jnative
from pylinac_tpu.core import compressed_px as jcpx
from pylinac_tpu.core import dcm as jdcm
from pylinac_tpu.core import jpegls as jjls
from pylinac_tpu_torch import native as tnative
from pylinac_tpu_torch.core import compressed_px as cpx
from pylinac_tpu_torch.core import dcm
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import jpegls as tjls
from pylinac_tpu_torch.core.array_utils import array_to_dicom

RNG = np.random.default_rng(12)
SYNTAXES = {
    "rle": dcm.RLE_LOSSLESS, "jpeg_lossless_sv1": dcm.JPEG_LOSSLESS_SV1,
    "jpeg_lossless_p14": dcm.JPEG_LOSSLESS_P14, "jpegls": dcm.JPEG_LS_LOSSLESS,
    "j2k_lossless": dcm.J2K_LOSSLESS, "j2k": dcm.J2K,
}
FRAMES = {
    "ct12": RNG.normal(1200, 300, (64, 80)).clip(0, 4095).astype(np.uint16),
    "full16": RNG.integers(0, 65536, (64, 80)).astype(np.uint16),
    "int16": RNG.integers(-1024, 3000, (64, 80)).astype(np.int16),
    "uint8": RNG.integers(0, 256, (64, 80)).astype(np.uint8),
}
# JPEG-LS takes unsigned frames only, in both packages
CASES = [(s, f) for s in SYNTAXES for f in FRAMES
         if not (s == "jpegls" and FRAMES[f].dtype.kind == "i")]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's codecs, built into a private folder."""
    old = jnative._BUILD_DIR
    jnative._BUILD_DIR = tmp_path_factory.mktemp("jax_native")
    jnative._lib_cache.clear()
    yield jnative
    jnative._BUILD_DIR = old
    jnative._lib_cache.clear()


def _dataset(arr: np.ndarray) -> dcm.Dataset:
    ds = dcm.Dataset()
    ds.Modality = "CT"
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.set_pixel_data(arr)
    return ds


def _jax_dataset(arr: np.ndarray) -> jdcm.Dataset:
    ds = jdcm.Dataset()
    ds.Modality = "CT"
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
    ds.SOPInstanceUID = jdcm.generate_uid()
    ds.set_pixel_data(arr)
    return ds


def _write(module, ds, ts: str) -> bytes:
    buf = io.BytesIO()
    module.dcmwrite(buf, ds, transfer_syntax=ts)
    return buf.getvalue()


@pytest.mark.parametrize("syntax, frame", CASES)
def test_roundtrip_and_both_directions(jax_native, syntax, frame):
    arr, ts = FRAMES[frame], SYNTAXES[syntax]
    port_bytes = _write(dcm, _dataset(arr), ts)
    back = dcm.dcmread(port_bytes)
    assert str(back.file_meta.TransferSyntaxUID) == ts
    got = back.pixel_array
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)
    # the port's bytes in the JAX package, the JAX package's in the port
    np.testing.assert_array_equal(jdcm.dcmread(port_bytes).pixel_array, arr)
    jax_bytes = _write(jdcm, _jax_dataset(arr), ts)
    np.testing.assert_array_equal(dcm.dcmread(jax_bytes).pixel_array, arr)


@pytest.mark.parametrize("syntax", [s for s in SYNTAXES if s != "j2k"])
def test_image_load_reads_compressed_files(tmp_path, syntax):
    arr = FRAMES["ct12"]
    ds = array_to_dicom(arr, sid=1000.0, gantry=0, coll=0, couch=0, dpi=100.0)
    path = tmp_path / "img.dcm"
    dcm.dcmwrite(path, ds, transfer_syntax=SYNTAXES[syntax])
    img = timage.load(str(path))
    np.testing.assert_array_equal(img.array, arr)


@pytest.mark.parametrize("psv", range(1, 8))
def test_jpeg_lossless_native_equals_python(jax_native, psv):
    for arr in (FRAMES["ct12"], FRAMES["full16"], FRAMES["uint8"]):
        stream = cpx.jpeg_lossless_encode(arr, psv=psv)
        assert stream == jcpx.jpeg_lossless_encode(arr, psv=psv)
        python = cpx.jpeg_lossless_decode(stream)
        native = tnative.jpeg_lossless_native()(stream)
        assert native.dtype == python.dtype == arr.dtype
        np.testing.assert_array_equal(native, python)
        np.testing.assert_array_equal(python, arr)
        np.testing.assert_array_equal(jcpx.jpeg_lossless_decode(stream), python)


@pytest.mark.parametrize("frame", ["ct12", "full16", "uint8"])
def test_jpegls_native_equals_python(jax_native, frame):
    arr = FRAMES[frame]
    prec = tjls.default_precision(arr)
    stream = tjls.jpegls_encode(arr)
    decode, encode = tnative.jpegls_native()
    assert encode(arr, prec) == stream == jjls.jpegls_encode(arr)
    assert cpx.jpegls_encode_fast(arr) == stream
    np.testing.assert_array_equal(decode(stream), tjls.jpegls_decode(stream))
    np.testing.assert_array_equal(tjls.jpegls_decode(stream), arr)
    np.testing.assert_array_equal(jjls.jpegls_decode(stream), arr)


@pytest.mark.parametrize("frame", ["ct12", "full16", "int16"])
def test_j2k_equals_the_jax_native_codec(jax_native, frame):
    arr = FRAMES[frame]
    stream = cpx.j2k_encode(arr)
    assert stream == jcpx.j2k_encode(arr)
    np.testing.assert_array_equal(cpx.j2k_decode(stream), arr)
    np.testing.assert_array_equal(cpx.j2k_decode(stream), jcpx.j2k_decode(stream))


def test_multiframe_rle(jax_native):
    arr = np.random.default_rng(2).integers(0, 3000, (4, 64, 64)).astype(np.uint16)
    data = _write(dcm, _dataset(arr), dcm.RLE_LOSSLESS)
    np.testing.assert_array_equal(dcm.dcmread(data).pixel_array, arr)
    np.testing.assert_array_equal(jdcm.dcmread(data).pixel_array, arr)


@pytest.mark.parametrize("syntax", ["jpeg_lossless_sv1", "jpegls", "j2k_lossless"])
def test_frames_split_over_fragments(jax_native, monkeypatch, syntax):
    """Two frames, each split over two fragments, behind a filled Basic
    Offset Table."""
    arr = np.stack([FRAMES["ct12"], FRAMES["ct12"][::-1]])
    ts = SYNTAXES[syntax]
    encode = {"jpeg_lossless_sv1": cpx.jpeg_lossless_encode,
              "jpegls": cpx.jpegls_encode_fast, "j2k_lossless": cpx.j2k_encode}[syntax]
    streams = [encode(f) for f in arr]
    frags = []
    for s in streams:
        s = s + b"\x00" * (len(s) % 2)
        cut = (len(s) // 3) & ~1
        frags += [s[:cut], s[cut:]]
    # each frame's offset from the first fragment's item tag
    bot = struct.pack("<II", 0, 16 + len(frags[0]) + len(frags[1]))

    def encapsulated(ds, transfer_syntax):
        out = io.BytesIO()
        out.write(struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
                  + struct.pack("<I", 0xFFFFFFFF))
        out.write(struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot)
        for f in frags:
            out.write(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f)
        out.write(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        return out.getvalue()

    monkeypatch.setattr(dcm, "_encapsulate_pixels", encapsulated)
    data = _write(dcm, _dataset(arr), ts)
    np.testing.assert_array_equal(dcm.dcmread(data).pixel_array, arr)
    np.testing.assert_array_equal(jdcm.dcmread(data).pixel_array, arr)


def test_lossy_jpeg_raises():
    bogus = b"\xff\xd8\xff\xc0\x00\x08\x08\x00\x10\x00\x10\x01\xff\xd9"  # SOF0, baseline
    for decode in (cpx.jpeg_lossless_decode, jcpx.jpeg_lossless_decode,
                   tnative.jpeg_lossless_native()):
        with pytest.raises(ValueError):
            decode(bogus)


def test_near_lossless_jpegls_raises(jax_native):
    stream = bytearray(tjls.jpegls_encode(FRAMES["ct12"]))
    sos = stream.find(b"\xff\xda")
    stream[sos + 7] = 2  # NEAR = 2
    for decode in (tjls.jpegls_decode, jjls.jpegls_decode):
        with pytest.raises(ValueError, match="NEAR"):
            decode(bytes(stream))
    for decode in (tnative.jpegls_native()[0], jax_native.jpegls_native()[0]):
        with pytest.raises(ValueError):
            decode(bytes(stream))


def test_unsupported_syntax_raises():
    data = _write(dcm, _dataset(FRAMES["ct12"]), dcm.JPEG_LOSSLESS_SV1)
    baseline = data.replace(dcm.JPEG_LOSSLESS_SV1.encode(), b"1.2.840.10008.1.2.4.50")
    for module in (dcm, jdcm):
        with pytest.raises(module.InvalidDicomError):
            module.dcmread(baseline)
    with pytest.raises(ValueError, match="cannot encode"):
        _write(dcm, _dataset(FRAMES["ct12"]), "1.2.840.10008.1.2.4.50")


def test_native_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """A library is built once under a name keyed by its source's hash, by
    way of a temporary file renamed into place; a failed build raises."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    path = tnative.build("jpegls")
    assert path.parent == tmp_path and path.name.startswith("libjpegls_")
    assert path == tnative.library_path("jpegls")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert tnative.build("jpegls") == path  # no rebuild
    monkeypatch.setattr(tnative, "SOURCE_DIR", tmp_path)
    (tmp_path / "broken.cpp").write_text("this is not C++")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build("broken")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([path.name, "broken.cpp"])
