"""Compressed DICOM pixel-data codecs: RLE Lossless, JPEG Lossless, and the
dispatch to JPEG-LS and JPEG 2000.

A copy of ``pylinac_tpu/core/compressed_px.py``, whose native paths here
are the port's own host codecs (:mod:`pylinac_tpu_torch.native`); a failed
build raises instead of falling back. It gives the self-contained DICOM
codec (``core/dcm.py``) the transfer syntaxes that dominate clinical
CT/CBCT exports:

* RLE Lossless (1.2.840.10008.1.2.5) — PackBits byte planes (DICOM PS3.5
  Annex G). Decoded with a numpy-vectorized PackBits walker.
* JPEG Lossless, Non-Hierarchical, First-Order Prediction
  (1.2.840.10008.1.2.4.70, ISO 10918-1 process 14 selection value 1) — the
  dominant CT archive syntax. Decoded by a native C++ bitstream decoder
  (``native/jpeg_lossless.cpp``); the pure-Python decoder is its twin. All
  seven JPEG predictors are handled, not just SV1.
* JPEG-LS Lossless (1.2.840.10008.1.2.4.80): ``native/jpegls.cpp``, whose
  twin is :mod:`pylinac_tpu_torch.core.jpegls`.
* JPEG 2000 (1.2.840.10008.1.2.4.90/.91): ``native/jpeg2000.cpp`` only.

Encoders for every syntax are included — they make round-trip tests
self-contained and let :func:`pylinac_tpu_torch.core.dcm.dcmwrite` export
compressed series.
"""

from __future__ import annotations

import struct

import numpy as np

RLE_TS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS_SV1_TS = "1.2.840.10008.1.2.4.70"
JPEG_LOSSLESS_TS = "1.2.840.10008.1.2.4.57"


# ===========================================================================
# RLE Lossless (DICOM PS3.5 Annex G: PackBits segments, one per byte plane)
# ===========================================================================
def _packbits_decode(data: bytes, expected: int) -> np.ndarray:
    """PackBits decode to exactly ``expected`` bytes (vectorized walker:
    control bytes are chased in a Python loop but copies are numpy slices)."""
    out = np.empty(expected, np.uint8)
    src = np.frombuffer(data, np.uint8)
    i = 0
    o = 0
    n = len(src)
    while o < expected and i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 128:  # literal run of ctrl+1 bytes
            cnt = int(ctrl) + 1
            if i + cnt > n or o + cnt > expected:
                raise ValueError(
                    f"RLE segment truncated: got {o} of {expected} bytes")
            out[o:o + cnt] = src[i:i + cnt]
            i += cnt
            o += cnt
        elif ctrl > 128:  # replicate next byte 257-ctrl times
            cnt = 257 - int(ctrl)
            if i >= n or o + cnt > expected:
                raise ValueError(
                    f"RLE segment truncated: got {o} of {expected} bytes")
            out[o:o + cnt] = src[i]
            i += 1
            o += cnt
        # ctrl == 128: no-op
    if o < expected:
        raise ValueError(f"RLE segment truncated: got {o} of {expected} bytes")
    return out


def _packbits_encode(data: np.ndarray) -> bytes:
    """PackBits encode one byte plane (run-length + literal packing)."""
    data = np.asarray(data, np.uint8)
    n = len(data)
    out = bytearray()
    # find run boundaries
    if n == 0:
        return b""
    change = np.nonzero(np.diff(data))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    i = 0
    lit_start = None
    runs = list(zip(starts.tolist(), ends.tolist()))

    def flush_literal(upto):
        nonlocal lit_start
        if lit_start is None:
            return
        s = lit_start
        while s < upto:
            cnt = min(128, upto - s)
            out.append(cnt - 1)
            out.extend(data[s:s + cnt].tobytes())
            s += cnt
        lit_start = None

    for s, e in runs:
        ln = e - s
        if ln >= 3:  # encode as replicate run(s)
            flush_literal(s)
            p = s
            while ln >= 2:
                cnt = min(128, ln)
                out.append(257 - cnt)
                out.append(int(data[p]))
                ln -= cnt
                p += cnt
            if ln:  # a single leftover byte becomes a literal
                lit_start = p
        else:
            if lit_start is None:
                lit_start = s
    flush_literal(n)
    if len(out) % 2:
        out.append(0)  # even padding
    return bytes(out)


def rle_decode_frame(fragment: bytes, rows: int, cols: int,
                     bits_allocated: int, samples: int = 1) -> np.ndarray:
    """Decode one RLE-encapsulated frame fragment → (rows, cols[, samples])
    array in the pixel dtype."""
    nbytes = bits_allocated // 8
    header = struct.unpack("<16I", fragment[:64])
    nseg = header[0]
    if nseg != nbytes * samples:
        raise ValueError(
            f"RLE header declares {nseg} segments; expected {nbytes * samples}")
    offsets = list(header[1:1 + nseg]) + [len(fragment)]
    npx = rows * cols
    planes = []
    for s in range(nseg):
        seg = fragment[offsets[s]:offsets[s + 1]]
        planes.append(_packbits_decode(seg, npx))
    out = np.empty((samples, npx), dtype=np.dtype(f"<u{nbytes}"))
    for smp in range(samples):
        # MSB-first byte planes (PS3.5 G.2)
        acc = np.zeros(npx, dtype=np.uint32 if nbytes > 2 else np.uint16
                       if nbytes == 2 else np.uint8)
        for b in range(nbytes):
            acc = (acc.astype(np.uint32) << 8) | planes[smp * nbytes + b]
        out[smp] = acc.astype(out.dtype)
    arr = out.reshape(samples, rows, cols)
    return arr[0] if samples == 1 else np.moveaxis(arr, 0, -1)


def rle_encode_frame(frame: np.ndarray) -> bytes:
    """Encode a 2D integer frame into one RLE fragment (header + segments)."""
    frame = np.ascontiguousarray(frame)
    nbytes = frame.dtype.itemsize
    if nbytes > 4 or frame.dtype.kind not in "iu":
        raise ValueError(f"Unsupported dtype for RLE: {frame.dtype}")
    flat = frame.astype(np.dtype(f"<u{nbytes}"), copy=False).ravel()
    segs = []
    for b in range(nbytes):  # MSB first
        shift = 8 * (nbytes - 1 - b)
        plane = ((flat.astype(np.uint32) >> shift) & 0xFF).astype(np.uint8)
        segs.append(_packbits_encode(plane))
    header = np.zeros(16, np.uint32)
    header[0] = len(segs)
    off = 64
    for i, s in enumerate(segs):
        header[1 + i] = off
        off += len(s)
    return header.astype("<u4").tobytes() + b"".join(segs)


# ===========================================================================
# JPEG Lossless (ISO 10918-1 process 14) — the Python twin of the native
# decoder (native/jpeg_lossless.cpp) that the DICOM reader uses.
# ===========================================================================
def _predict(ra, rb, rc, psv):
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    if psv == 7:
        return (ra + rb) >> 1
    raise ValueError(f"Unsupported predictor {psv}")


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.acc = (self.acc << 8) | 0
                self.nbits += 8
                continue
            byte = self.data[self.pos]
            self.pos += 1
            if byte == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 1  # stuffed byte
                else:
                    # marker: treat as end of stream (pad zeros)
                    self.pos = len(self.data)
                    byte = 0
            self.acc = (self.acc << 8) | byte
            self.nbits += 8

    def peek16(self) -> int:
        self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int):
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.skip(n)
        return v


def _build_huffman(bits: list[int], values: list[int]):
    """(code→(length, value)) fast LUT of 16-bit prefixes."""
    lut = np.full(1 << 16, -1, np.int32)  # packs (length<<8 | value)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            prefix = code << (16 - length)
            span = 1 << (16 - length)
            lut[prefix:prefix + span] = (length << 8) | values[k]
            code += 1
            k += 1
        code <<= 1
    return lut


def _extend(v: int, ssss: int) -> int:
    if ssss == 0:
        return 0
    if v < (1 << (ssss - 1)):
        return v - (1 << ssss) + 1
    return v


def jpeg_lossless_decode(data: bytes) -> np.ndarray:
    """Decode a JPEG Lossless (SOF3) codestream → 2D array (1 component).

    The pure-Python twin of :func:`jpeg_lossless_decode_fast`."""
    pos = 0
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG codestream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    ncomp = 1
    huff: dict[int, np.ndarray] = {}
    psv = 1
    pt = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC3:  # SOF3: lossless
            precision, rows, cols, ncomp = struct.unpack(">BHHB", seg[:6])
        elif marker in (0xC0, 0xC1, 0xC2):
            raise ValueError("Not a lossless JPEG (SOF0/1/2)")
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1:p + 17])
                nvals = sum(bits)
                values = list(seg[p + 17:p + 17 + nvals])
                huff[tc_th & 0x0F] = _build_huffman(bits, values)
                p += 17 + nvals
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            tables = []
            for c in range(ns):
                tables.append(huff[seg[2 + 2 * c] >> 4])
            psv = seg[1 + 2 * ns]
            pt = seg[3 + 2 * ns] & 0x0F
            scan = data[pos + seglen:]
            return _decode_scan(scan, rows, cols, ns, precision, psv, pt,
                                tables)
        pos += seglen
    raise ValueError("No SOS marker found")


def _decode_scan(scan, rows, cols, ncomp, precision, psv, pt, tables):
    if ncomp != 1:
        raise ValueError("Only single-component (grayscale) JPEG supported")
    br = _BitReader(scan)
    lut = tables[0]
    out = np.empty((rows, cols), np.int32)
    default = 1 << (precision - pt - 1)
    for r in range(rows):
        for c in range(cols):
            packed = int(lut[br.peek16()])
            if packed < 0:
                raise ValueError("Invalid Huffman code in scan")
            br.skip(packed >> 8)
            ssss = packed & 0xFF
            if ssss == 16:
                diff = 32768
            else:
                diff = _extend(br.read(ssss), ssss)
            if r == 0 and c == 0:
                pred = default
            elif r == 0:
                pred = int(out[0, c - 1])
            elif c == 0:
                pred = int(out[r - 1, 0])
            else:
                ra = int(out[r, c - 1])
                rb = int(out[r - 1, c])
                rc = int(out[r - 1, c - 1])
                pred = _predict(ra, rb, rc, psv if r > 0 and c > 0 else 1)
            out[r, c] = (pred + diff) & 0xFFFF
    return (out << pt).astype(np.uint16 if precision > 8 else np.uint8)


# -- encoder (tests + compressed export) ------------------------------------
def _category(diff: np.ndarray) -> np.ndarray:
    mag = np.abs(diff)
    return np.where(mag == 0, 0, np.floor(np.log2(np.maximum(mag, 1))).astype(int) + 1)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.nbits -= 8
            self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)


def jpeg_lossless_encode(frame: np.ndarray, psv: int = 1) -> bytes:
    """Encode a 2D unsigned array as JPEG Lossless SV1 (process 14).

    Uses per-image optimal-ish Huffman (one table, canonical)."""
    frame = np.asarray(frame)
    precision = 16 if frame.dtype.itemsize == 2 else 8
    rows, cols = frame.shape
    img = frame.astype(np.int64)
    # diffs with predictor psv (encoder mirrors the decoder's edge rules)
    pred = np.empty_like(img)
    pred[0, 0] = 1 << (precision - 1)
    pred[0, 1:] = img[0, :-1]
    pred[1:, 0] = img[:-1, 0]
    ra = img[1:, :-1]
    rb = img[:-1, 1:]
    rc = img[:-1, :-1]
    pred[1:, 1:] = _predict(ra, rb, rc, psv)
    diff = ((img - pred + 32768) % 65536) - 32768  # 16-bit modular diff
    cats = _category(diff)
    # true Huffman over the category histogram (<=17 symbols, so depth
    # never approaches the 16-bit JPEG limit in practice)
    import heapq
    import itertools

    hist = np.bincount(cats.ravel(), minlength=17)
    present = [int(s) for s in np.nonzero(hist)[0]]
    if len(present) == 1:
        lengths = {present[0]: 1}
    else:
        tie = itertools.count()
        heap = [(int(hist[s]), next(tie), (int(s),)) for s in present]
        heapq.heapify(heap)
        depth = {int(s): 0 for s in present}
        while len(heap) > 1:
            f1, _, g1 = heapq.heappop(heap)
            f2, _, g2 = heapq.heappop(heap)
            for s in g1 + g2:
                depth[s] += 1
            heapq.heappush(heap, (f1 + f2, next(tie), g1 + g2))
        lengths = {s: max(d, 1) for s, d in depth.items()}
    # canonicalize: sort by (length, symbol)
    syms = sorted(lengths, key=lambda s: (lengths[s], s))
    bits = [0] * 16
    for s in syms:
        bits[lengths[s] - 1] += 1
    # assign canonical codes
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    bw = _BitWriter()
    flat_diff = diff.ravel()
    flat_cat = cats.ravel()
    for d, s in zip(flat_diff.tolist(), flat_cat.tolist()):
        c, ln2 = codes[s]
        bw.write(c, ln2)
        if s and s != 16:  # ssss=16 means diff=32768: code only, no bits
            if d < 0:
                d = d + (1 << s) - 1
            bw.write(d, s)
    bw.flush()
    # assemble the codestream
    out = bytearray(b"\xff\xd8")  # SOI
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    dht_vals = bytes(syms)
    dht = bytes([0x00]) + bytes(bits) + dht_vals
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sos = bytes([1, 1, 0x00, psv, 0, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += bytes(bw.out)
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# ===========================================================================
# native codecs
# ===========================================================================
def jpeg_lossless_decode_fast(data: bytes) -> np.ndarray:
    """Decode with the C++ decoder."""
    from ..native import jpeg_lossless_native

    return jpeg_lossless_native()(data)


# ===========================================================================
# JPEG-LS Lossless (1.2.840.10008.1.2.4.80, ITU-T T.87) — see core/jpegls.py
# ===========================================================================
JPEG_LS_LOSSLESS_TS = "1.2.840.10008.1.2.4.80"


def jpegls_decode_fast(data: bytes) -> np.ndarray:
    """Decode with the C++ JPEG-LS decoder."""
    from ..native import jpegls_native

    return jpegls_native()[0](data)


def jpegls_encode_fast(frame: np.ndarray, prec: int | None = None) -> bytes:
    """Encode with the C++ JPEG-LS encoder."""
    from ..native import jpegls_native
    from .jpegls import default_precision

    return jpegls_native()[1](frame, prec or default_precision(frame))


# ===========================================================================
# JPEG 2000 (1.2.840.10008.1.2.4.90/.91, ITU-T T.800) — native/jpeg2000.cpp
# ===========================================================================
J2K_LOSSLESS_TS = "1.2.840.10008.1.2.4.90"
J2K_TS = "1.2.840.10008.1.2.4.91"


def j2k_decode(data: bytes) -> np.ndarray:
    """Decode a JPEG 2000 codestream (raw or JP2-wrapped) via the C++
    codec. Lossless (5/3 reversible) only; no pure-Python fallback — the
    EBCOT bit-plane coder is far too slow in Python for clinical frames."""
    from ..native import j2k_native

    arr, prec, sgnd = j2k_native()[0](data)
    if sgnd:
        return arr.astype(np.int16 if prec <= 16 else np.int32)
    if prec <= 8:
        return arr.astype(np.uint8)
    return arr.astype(np.uint16)


def j2k_encode(frame: np.ndarray, prec: int | None = None) -> bytes:
    """Encode a 2-D frame as a lossless (5/3) JPEG 2000 codestream."""
    from ..native import j2k_native

    sgnd = frame.dtype.kind == "i"
    if prec is None:
        mx = int(np.abs(frame).max()) if frame.size else 1
        prec = max(2, mx.bit_length() + (1 if sgnd else 0))
    return j2k_native()[1](frame, prec, sgnd)
