"""Host C++ codecs for compressed DICOM pixel data and Varian .xim images,
bound with ctypes.

Copies of ``pylinac_tpu/native/jpeg_lossless.cpp``, ``jpegls.cpp``,
``jpeg2000.cpp`` and ``xim_decode.cpp``, with the wrappers of
``pylinac_tpu/native/__init__.py`` (``jpegls_native`` ``:62``, ``j2k_native``
``:117``, ``jpeg_lossless_native`` ``:180``) and of
``pylinac_tpu/core/xim.py:_decode_native`` (``:77``). Bitstream decoding is
sequential, so it stays on the host.

Each source is compiled by ``g++ -O3 -shared -fPIC`` at first use into
``pylinac_tpu_torch/_build/``, named by a hash of the source and flags: to a
temporary name first, then renamed, so that processes building at once
never load a half-written library. A failed build raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` goes, keyed by its content."""
    src = (SOURCE_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; its path."""
    out = library_path(name)
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH; the host codec {name}.cpp needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE_DIR / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built first if needed."""
    return ctypes.CDLL(str(build(name)))


def _sof_capacity(data: bytes, marker: bytes) -> int:
    """Rows x columns from a start-of-frame segment, else a 8192 x 8192
    bound, to size the output buffer."""
    idx = data.find(marker)
    if 0 <= idx and idx + 9 < len(data):
        rows = int.from_bytes(data[idx + 5:idx + 7], "big")
        cols = int.from_bytes(data[idx + 7:idx + 9], "big")
        if rows and cols:
            return rows * cols
    return 8192 * 8192


@functools.cache
def xim_decode_native():
    """The XIM diff decoder: ``decode(buf, lut, width, height) -> (rc,
    pixels)``, ``pixels`` (height, width) int32. ``rc`` is 0, or -1 when the
    diff buffer runs short and -2 when the lookup table does (a truncated
    file): those are the data's faults, which the caller handles as the JAX
    package does; a build fault raises here."""
    fn = load_library("xim_decode").xim_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]

    def decode(buf: np.ndarray, lut: np.ndarray, width: int, height: int):
        # the decoder copies W + 1 raw pixels into the H x W output first
        if width < 1 or height < 2:
            raise ValueError(f"a compressed XIM image needs at least 2 rows of 1 pixel, "
                             f"got {height} x {width}")
        buf = np.ascontiguousarray(buf, np.uint8)
        lut = np.ascontiguousarray(lut, np.uint8)
        out = np.empty(height * width, np.int32)
        rc = fn(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.nbytes,
                lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), lut.nbytes,
                width, height, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return rc, out.reshape(height, width)

    return decode


@functools.cache
def jpeg_lossless_native():
    """The JPEG Lossless decoder: ``bytes -> np.ndarray`` (uint16, or uint8
    when the codestream's precision is 8)."""
    fn = load_library("jpeg_lossless").jpegll_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]

    def decode(data: bytes) -> np.ndarray:
        cap = _sof_capacity(data, b"\xff\xc3")
        out = np.empty(cap, np.uint16)
        rows, cols, prec = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = fn(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), cap,
                ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(prec))
        if rc != 0:
            raise ValueError(f"native JPEG-lossless decode failed (code {rc})")
        arr = out[:rows.value * cols.value].reshape(rows.value, cols.value).copy()
        return arr.astype(np.uint8) if prec.value <= 8 else arr

    return decode


@functools.cache
def jpegls_native():
    """The JPEG-LS codec: (decode, encode); ``decode(bytes) -> np.ndarray``
    (uint8 or uint16 by the codestream's precision) and ``encode(frame,
    prec) -> bytes``."""
    lib = load_library("jpegls")
    dec = lib.jls_decode
    dec.restype = ctypes.c_int
    dec.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)]
    enc = lib.jls_encode
    enc.restype = ctypes.c_int
    enc.argtypes = [ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]

    def decode(data: bytes) -> np.ndarray:
        cap = _sof_capacity(data, b"\xff\xf7")
        out = np.empty(cap, np.uint16)
        rows, cols, prec = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = dec(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), cap,
                 ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(prec))
        if rc != 0:
            raise ValueError(f"native JPEG-LS decode failed (code {rc})")
        arr = out[:rows.value * cols.value].reshape(rows.value, cols.value).copy()
        return arr.astype(np.uint8) if prec.value <= 8 else arr

    def encode(frame: np.ndarray, prec: int) -> bytes:
        img = np.ascontiguousarray(frame, np.uint16)
        h, w = img.shape
        cap = h * w * 2 + 1024
        out = np.empty(cap, np.uint8)
        out_len = ctypes.c_int64()
        rc = enc(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), h, w, prec,
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                 ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"native JPEG-LS encode failed (code {rc})")
        return out[:out_len.value].tobytes()

    return decode, encode


_J2K_ERRORS = {1: "malformed codestream", 2: "unsupported codestream feature",
               3: "corrupt entropy data", 4: "output capacity",
               5: "irreversible (9/7) wavelets are not supported — lossless only"}


@functools.cache
def j2k_native():
    """The JPEG 2000 codec: (decode, encode); ``decode(bytes) ->
    (np.ndarray int32, precision, signed)`` and ``encode(frame, prec, sgnd)
    -> bytes`` (lossless 5/3)."""
    lib = load_library("jpeg2000")
    dec = lib.j2k_decode
    dec.restype = ctypes.c_int
    dec.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    enc = lib.j2k_encode
    enc.restype = ctypes.c_int
    enc.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]

    def decode(data: bytes):
        cap = 4096 * 4096
        out = np.empty(cap, np.int32)
        rows, cols = ctypes.c_int(), ctypes.c_int()
        prec, sgnd = ctypes.c_int(), ctypes.c_int()
        rc = dec(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
                 ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(prec),
                 ctypes.byref(sgnd))
        if rc != 0:
            raise ValueError(f"JPEG 2000 decode failed: {_J2K_ERRORS.get(rc, rc)}")
        arr = out[:rows.value * cols.value].reshape(rows.value, cols.value)
        return arr.copy(), prec.value, bool(sgnd.value)

    def encode(frame: np.ndarray, prec: int, sgnd: bool) -> bytes:
        img = np.ascontiguousarray(frame, np.int32)
        h, w = img.shape
        cap = h * w * 4 + 65536
        out = np.empty(cap, np.uint8)
        out_len = ctypes.c_int64()
        rc = enc(img.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w, prec, int(sgnd),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                 ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"JPEG 2000 encode failed: {_J2K_ERRORS.get(rc, rc)}")
        return out[:out_len.value].tobytes()

    return decode, encode
