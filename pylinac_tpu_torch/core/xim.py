"""Varian .xim images: reader, writer and conversion to DICOM.

Port of ``pylinac_tpu/core/xim.py`` (``:1-312``): ``is_xim`` (``:39``),
``XimImage`` (``:127``: the header, the compressed or raw pixels, the
histogram, the properties, ``dpmm`` ``:202``, ``as_dicom`` ``:208``,
``save_as`` ``:225``, through Pillow) and ``write_xim`` (``:241``), numpy
only.

A compressed image stores its first W + 1 pixels raw and every later pixel
as a 1-, 2- or 4-byte diff with ``a[k] = diff[k] + a[k-1] + a[k-W] -
a[k-W-1]``. The host C++ decoder (``native/xim_decode.cpp``, built with g++
at first use) decodes the stream in one pass; the numpy decode
(``_decode_diffs`` and ``_reconstruct``, two cumulative sums) is its twin.
The decoder's return codes -1 (diff buffer short) and -2 (lookup table
short) are a truncated file's: the image then takes the numpy decode, as
the JAX package's does, and gets what JAX gets. A missing g++ or a failed
build raises.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

XIM_PROP_INT = 0
XIM_PROP_DOUBLE = 1
XIM_PROP_STRING = 2
XIM_PROP_DOUBLE_ARRAY = 4
XIM_PROP_INT_ARRAY = 5


def _read_int(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _read_double(f: BinaryIO) -> float:
    return struct.unpack("<d", f.read(8))[0]


def _read_str(f: BinaryIO, n: int) -> str:
    return f.read(n).decode("latin-1")


def is_xim(path: str | Path) -> bool:
    """Whether the file at ``path`` starts with the XIM format id."""
    try:
        with open(path, "rb") as f:
            return f.read(8).decode("latin-1", "replace").startswith("VMS.XI")
    except Exception:  # any unreadable path is not an XIM file, as in JAX
        return False


def _expand_lookup_table(lut_bytes: np.ndarray, n_diffs: int) -> np.ndarray:
    """The 2-bit size code of each diff from the packed lookup table."""
    bit_shift = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = ((lut_bytes[:, None] >> bit_shift[None, :]) & 0b11).ravel()
    return codes[:n_diffs]


def _decode_diffs(buf: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Little-endian signed diffs of 1, 2 or 4 bytes (codes 0, 1, 2); bytes
    past the buffer's end read as 0."""
    sizes = np.left_shift(1, codes.astype(np.int64))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    b = buf.astype(np.int64)
    n_total = len(buf)

    def byte(i):
        idx = offsets + i
        return np.where(idx < n_total, b[np.minimum(idx, n_total - 1)], 0)

    b0, b1, b2, b3 = byte(0), byte(1), byte(2), byte(3)
    v1 = (b0 ^ 0x80) - 0x80
    v2 = ((b0 | (b1 << 8)) ^ 0x8000) - 0x8000
    v4 = ((b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)) ^ 0x80000000) - 0x80000000
    return np.where(codes == 0, v1, np.where(codes == 1, v2, v4))


def _reconstruct(first_vals: np.ndarray, diffs: np.ndarray, width: int,
                 height: int) -> np.ndarray:
    """Undo the 2D differencing with two cumulative sums: a flat one of the
    diffs gives each pixel minus the one above, a column one the pixels.
    ``first_vals`` are the W + 1 raw pixels, ``diffs`` the H W - W - 1
    others."""
    n = width * height
    a = np.zeros(n, dtype=np.int64)
    a[: width + 1] = first_vals
    b = np.zeros(n - width, dtype=np.int64)
    b[0] = a[width] - a[0]
    b[1:] = diffs
    b = np.cumsum(b)
    return np.cumsum(np.vstack([a[:width][None, :], b.reshape(height - 1, width)]), axis=0)


def _decode_numpy(buf: np.ndarray, lut: np.ndarray, width: int, height: int) -> np.ndarray:
    """The numpy decode of a compressed payload: the native decoder's twin."""
    codes = _expand_lookup_table(lut, height * width - width - 1)
    first_vals = buf[: (width + 1) * 4].view("<i4").astype(np.int64)
    diffs = _decode_diffs(buf[(width + 1) * 4:], codes)
    return _reconstruct(first_vals, diffs, width, height)


def _decode(buf: np.ndarray, lut: np.ndarray, width: int, height: int) -> np.ndarray:
    """The native decode; a truncated payload (return code -1 or -2) takes
    the numpy decode, as in the JAX package."""
    from ..native import xim_decode_native

    rc, pixels = xim_decode_native()(buf, lut, width, height)
    if rc == 0:
        return pixels
    if rc in (-1, -2):
        return _decode_numpy(buf, lut, width, height)
    raise RuntimeError(f"xim_decode returned {rc}")


class XimImage:
    """A parsed .xim file: ``array`` (2D integer pixels) and ``properties``."""

    def __init__(self, path: str | Path | BinaryIO, read_pixels: bool = True):
        if hasattr(path, "read"):
            self.path = getattr(path, "name", "")
            self._parse(path, read_pixels)
        else:
            self.path = str(path)
            with open(path, "rb") as f:
                self._parse(f, read_pixels)

    def _parse(self, f: BinaryIO, read_pixels: bool) -> None:
        self.format_id = _read_str(f, 8)
        if not self.format_id.startswith("VMS.XI"):
            raise ValueError(f"Not a XIM file: format id {self.format_id!r}")
        self.format_version = _read_int(f)
        self.img_width_px = _read_int(f)
        self.img_height_px = _read_int(f)
        self.bits_per_pixel = _read_int(f)
        self.bytes_per_pixel = _read_int(f)
        self.compression = _read_int(f)
        self.array = None
        w, h = self.img_width_px, self.img_height_px
        if not self.compression:
            buf_size = _read_int(f)
            raw = np.frombuffer(f.read(buf_size), dtype=f"<i{self.bytes_per_pixel}")
            if read_pixels:
                self.array = raw.reshape(h, w).copy()
        else:
            lut_size = _read_int(f)
            lut = np.frombuffer(f.read(lut_size), dtype=np.uint8)
            buf_size = _read_int(f)
            buf = np.frombuffer(f.read(buf_size), dtype=np.uint8)
            _ = _read_int(f)  # the uncompressed buffer size, unused
            if read_pixels:
                dtype = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[self.bytes_per_pixel]
                self.array = _decode(buf, lut, w, h).astype(dtype)
        self.num_hist_bins = _read_int(f)
        self.histogram = list(
            struct.unpack(f"<{self.num_hist_bins}i", f.read(4 * self.num_hist_bins)))
        self.num_properties = _read_int(f)
        self.properties: dict[str, Any] = {}
        for _ in range(self.num_properties):
            name = _read_str(f, _read_int(f))
            ptype = _read_int(f)
            if ptype == XIM_PROP_INT:
                value = _read_int(f)
            elif ptype == XIM_PROP_DOUBLE:
                value = _read_double(f)
            elif ptype == XIM_PROP_STRING:
                value = _read_str(f, _read_int(f))
            elif ptype == XIM_PROP_DOUBLE_ARRAY:
                value = np.frombuffer(f.read(_read_int(f)), dtype="<f8")
            elif ptype == XIM_PROP_INT_ARRAY:
                value = np.frombuffer(f.read(_read_int(f)), dtype="<i4")
            else:
                raise ValueError(f"Unknown XIM property type {ptype}")
            self.properties[name] = value

    @property
    def dpmm(self) -> float:
        """Dots per mm; the PixelWidth and PixelHeight properties are in cm."""
        if self.properties["PixelWidth"] != self.properties["PixelHeight"]:
            raise ValueError("XIM pixel height and width differ")
        return 1 / (10 * self.properties["PixelHeight"])

    def as_dicom(self):
        """An RT Image DICOM dataset, the angles converted from Varian
        Standard to IEC 61217."""
        from .array_utils import array_to_dicom
        from .scale import MachineScale, convert

        iec_g, iec_c, iec_p = convert(
            input_scale=MachineScale.VARIAN_STANDARD,
            output_scale=MachineScale.IEC61217,
            gantry=self.properties["GantryRtn"],
            collimator=self.properties["MVCollimatorRtn"],
            rotation=self.properties["CouchRtn"])
        return array_to_dicom(array=self.array, dpi=25.4 * self.dpmm,
                              gantry=iec_g, coll=iec_c, couch=iec_p, sid=1000)

    def save_as(self, file: str | Path, format: str | None = None) -> None:
        """Save to a standard image format through Pillow (a PNG keeps the
        properties as text tags)."""
        from PIL import Image
        from PIL.PngImagePlugin import PngInfo

        img = Image.fromarray(self.array)
        metadata = PngInfo()
        for prop, value in self.properties.items():
            if isinstance(value, np.ndarray):
                value = value.tolist()
            if not isinstance(value, str):
                value = json.dumps(value)
            metadata.add_text(prop, value)
        img.save(file, format=format, pnginfo=metadata)


def write_xim(path: str | Path, array: np.ndarray, properties: dict | None = None) -> None:
    """Write ``array`` as a compressed .xim file with ``properties`` (int,
    float, str or a float array each)."""
    array = np.asarray(array)
    h, w = array.shape
    flat = array.astype(np.int64).ravel()
    k = np.arange(w + 1, h * w)
    diffs = flat[k] - flat[k - 1] - flat[k - w] + flat[k - w - 1]
    codes = np.where((diffs >= -128) & (diffs <= 127), 0,
                     np.where((diffs >= -32768) & (diffs <= 32767), 1, 2)).astype(np.uint8)
    pad = (-len(codes)) % 4
    codes_p = np.concatenate([codes, np.zeros(pad, np.uint8)])
    lut = codes_p[0::4] | (codes_p[1::4] << 2) | (codes_p[2::4] << 4) | (codes_p[3::4] << 6)
    # the diffs, each at its own width: one little-endian int32 array cut to
    # the code's bytes
    if len(diffs) and (diffs.min() < -2**31 or diffs.max() > 2**31 - 1):
        raise struct.error("'i' format requires -2147483648 <= number <= 2147483647")
    sizes = np.left_shift(1, codes.astype(np.int64))
    wide = diffs.astype("<i4").view(np.uint8).reshape(-1, 4)
    keep = np.arange(4)[None, :] < sizes[:, None]
    buf = flat[: w + 1].astype("<i4").tobytes() + wide[keep].tobytes()

    props = properties or {}
    lo, hi = int(flat.min()), int(flat.max())
    if -128 <= lo and hi <= 127:
        bpp = 1
    elif -32768 <= lo and hi <= 32767:
        bpp = 2
    else:
        bpp = 4
    with open(path, "wb") as f:
        f.write(b"VMS.XI\x00\x00")
        for value in (3, w, h, bpp * 8, bpp, 1):  # version, size, bits, bytes, compressed
            f.write(struct.pack("<i", value))
        f.write(struct.pack("<i", len(lut)))
        f.write(lut.tobytes())
        f.write(struct.pack("<i", len(buf)))
        f.write(buf)
        f.write(struct.pack("<i", h * w * 2))
        hist = np.zeros(8, dtype=np.int32)
        f.write(struct.pack("<i", len(hist)))
        f.write(hist.tobytes())
        f.write(struct.pack("<i", len(props)))
        for name, value in props.items():
            f.write(struct.pack("<i", len(name)))
            f.write(name.encode("latin-1"))
            if isinstance(value, int):
                f.write(struct.pack("<i", XIM_PROP_INT))
                f.write(struct.pack("<i", value))
            elif isinstance(value, float):
                f.write(struct.pack("<i", XIM_PROP_DOUBLE))
                f.write(struct.pack("<d", value))
            elif isinstance(value, str):
                f.write(struct.pack("<i", XIM_PROP_STRING))
                f.write(struct.pack("<i", len(value)))
                f.write(value.encode("latin-1"))
            else:
                arr = np.asarray(value, dtype="<f8")
                f.write(struct.pack("<i", XIM_PROP_DOUBLE_ARRAY))
                f.write(struct.pack("<i", arr.nbytes))
                f.write(arr.tobytes())
