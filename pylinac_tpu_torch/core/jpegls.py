"""JPEG-LS lossless codec (ITU-T T.87 / ISO 14495-1), single component.

A copy of ``pylinac_tpu/core/jpegls.py``. DICOM transfer syntax
1.2.840.10008.1.2.4.80 (JPEG-LS Lossless) appears in clinical CT exports;
pylinac reads it through pydicom's pyjpegls handler. This is a
self-contained implementation of the LOCO-I algorithm: gradient-context
modeling (365 regular contexts), MED prediction with per-context bias
correction, limited-length Golomb coding, and run mode with interruption
contexts — lossless only (NEAR=0), 2-16 bit grayscale, non-interleaved.

This module is the Python twin (a few hundred samples/ms — fine for tests
and small ROIs); ``native/jpegls.cpp`` carries
the byte-for-byte-equivalent C++ hot path used by ``core/dcm.py`` for full
frames (see ``jpegls_decode_fast`` / ``jpegls_encode_fast`` in
``core/compressed_px.py``).
"""

from __future__ import annotations

import numpy as np

JPEG_LS_LOSSLESS_TS = "1.2.840.10008.1.2.4.80"

# standard run-length code order table (T.87 A.2.1)
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7,
      7, 8, 9, 10, 11, 12, 13, 14, 15)

_MIN_C, _MAX_C = -128, 127


class _Params:
    def __init__(self, maxval: int, near: int = 0,
                 t1: int | None = None, t2: int | None = None,
                 t3: int | None = None, reset: int = 64):
        self.maxval = maxval
        self.near = near
        self.range = maxval + 1  # near == 0
        self.qbpp = int(self.range - 1).bit_length()
        self.bpp = max(2, int(maxval).bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))
        d1, d2, d3 = self._default_thresholds(maxval)
        self.t1 = t1 if t1 is not None else d1
        self.t2 = t2 if t2 is not None else d2
        self.t3 = t3 if t3 is not None else d3
        self.reset = reset

    @staticmethod
    def _default_thresholds(maxval: int) -> tuple[int, int, int]:
        """T.87 C.2.4.1.1.1 default T1/T2/T3 for NEAR=0."""
        def clamp(i, j):
            return j if (i > maxval or i < j) else i

        if maxval >= 128:
            factor = (min(maxval, 4095) + 128) // 256
            t1 = clamp(factor * (3 - 2) + 2, 2)
            t2 = clamp(factor * (7 - 3) + 3, t1)
            t3 = clamp(factor * (21 - 4) + 4, t2)
        else:
            factor = 256 // (maxval + 1)
            t1 = clamp(max(2, 3 // factor), 2)
            t2 = clamp(max(3, 7 // factor), t1)
            t3 = clamp(max(4, 21 // factor), t2)
        return t1, t2, t3


class _State:
    """Adaptive context state (regular contexts 0..364; run 365/366)."""

    def __init__(self, p: _Params):
        init_a = max(2, (p.range + 32) // 64)
        self.A = [init_a] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]         # run-interruption negative counts (365/366)
        self.run_index = 0
        self.p = p

    def quantize(self, d: int) -> int:
        p = self.p
        if d <= -p.t3:
            return -4
        if d <= -p.t2:
            return -3
        if d <= -p.t1:
            return -2
        if d < 0:
            return -1
        if d == 0:
            return 0
        if d < p.t1:
            return 1
        if d < p.t2:
            return 2
        if d < p.t3:
            return 3
        return 4

    def golomb_k(self, q: int) -> int:
        k = 0
        a, n = self.A[q], self.N[q]
        while (n << k) < a:
            k += 1
        return k

    def update_regular(self, q: int, errval: int) -> None:
        p = self.p
        self.B[q] += errval
        self.A[q] += abs(errval)
        if self.N[q] == p.reset:
            self.A[q] >>= 1
            self.B[q] >>= 1   # arithmetic shift: floor division for negatives
            self.N[q] >>= 1
        self.N[q] += 1
        # bias computation (T.87 A.6.2)
        if self.B[q] <= -self.N[q]:
            self.B[q] += self.N[q]
            if self.C[q] > _MIN_C:
                self.C[q] -= 1
            if self.B[q] <= -self.N[q]:
                self.B[q] = -self.N[q] + 1
        elif self.B[q] > 0:
            self.B[q] -= self.N[q]
            if self.C[q] < _MAX_C:
                self.C[q] += 1
            if self.B[q] > 0:
                self.B[q] = 0


def _predict(ra: int, rb: int, rc: int) -> int:
    if rc >= max(ra, rb):
        return min(ra, rb)
    if rc <= min(ra, rb):
        return max(ra, rb)
    return ra + rb - rc


# ---------------------------------------------------------------------------
# bit IO with JPEG-LS marker stuffing (a 0 bit is inserted after every 0xFF)
# ---------------------------------------------------------------------------
class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._nfree = 8          # free bit slots in current byte

    def _flush_byte(self):
        self.out.append(self._acc)
        self._nfree = 7 if self._acc == 0xFF else 8
        self._acc = 0

    def write(self, value: int, nbits: int) -> None:
        while nbits > 0:
            take = min(nbits, self._nfree)
            chunk = (value >> (nbits - take)) & ((1 << take) - 1)
            self._acc |= chunk << (self._nfree - take)
            self._nfree -= take
            nbits -= take
            if self._nfree == 0:
                self._flush_byte()

    def finish(self) -> bytes:
        if self._nfree != 8:
            # zero-pad the final partial byte (zero fill bits never emulate
            # a marker)
            self._flush_byte()
        return bytes(self.out)


class _BitReaderLS:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._acc = 0
        self._navail = 0
        self._prev_ff = False

    def _pull(self) -> None:
        if self.pos >= len(self.data):
            # past the end: feed zeros (robustness against truncated pad)
            self._acc = (self._acc << 8) & ((1 << 64) - 1)
            self._navail += 8
            return
        b = self.data[self.pos]
        self.pos += 1
        if self._prev_ff:
            # byte after 0xFF carries 7 data bits (MSB is the stuffed 0)
            nbits = 7
            b &= 0x7F
            self._prev_ff = False
        else:
            nbits = 8
            self._prev_ff = b == 0xFF
        self._acc = ((self._acc << nbits) | b) & ((1 << 64) - 1)
        self._navail += nbits

    def read(self, nbits: int) -> int:
        while self._navail < nbits:
            self._pull()
        self._navail -= nbits
        return (self._acc >> self._navail) & ((1 << nbits) - 1)

    def read_unary(self) -> int:
        """Count 0 bits until a 1 (consumes the 1)."""
        n = 0
        while self.read(1) == 0:
            n += 1
            if n > 1 << 20:
                raise ValueError("JPEG-LS bitstream corrupt (runaway unary)")
        return n


def _golomb_encode(w: _BitWriter, val: int, k: int, limit: int, qbpp: int) -> None:
    hi = val >> k
    if hi < limit - qbpp - 1:
        w.write(1, hi + 1)                     # hi zeros then a 1
        if k:
            w.write(val & ((1 << k) - 1), k)
    else:
        w.write(1, limit - qbpp)               # limit-qbpp-1 zeros then a 1
        w.write(val - 1, qbpp)


def _golomb_decode(r: _BitReaderLS, k: int, limit: int, qbpp: int) -> int:
    hi = r.read_unary()
    if hi < limit - qbpp - 1:
        return (hi << k) | (r.read(k) if k else 0)
    return r.read(qbpp) + 1


# ---------------------------------------------------------------------------
# scan codec
# ---------------------------------------------------------------------------
def _encode_scan(img: np.ndarray, p: _Params) -> bytes:
    h, w = img.shape
    st = _State(p)
    out = _BitWriter()
    prev = [0] * w               # reconstructed previous line
    cur = [0] * w
    prev_ra0 = 0                 # Rb used at j=0 of the previous line
    rows = img.tolist()
    for i in range(h):
        line = rows[i]
        rc0 = prev_ra0
        prev_ra0 = prev[0]
        j = 0
        while j < w:
            ix = line[j]
            ra = cur[j - 1] if j else prev[0]
            rb = prev[j]
            rc = (prev[j - 1] if j else rc0)
            rd = prev[j + 1] if j + 1 < w else prev[j]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            if d1 == 0 and d2 == 0 and d3 == 0:
                # ---- run mode ----
                run_cnt = 0
                while j < w and line[j] == ra:
                    cur[j] = ra
                    run_cnt += 1
                    j += 1
                # run-length coding
                while run_cnt >= (1 << _J[st.run_index]):
                    out.write(1, 1)
                    run_cnt -= 1 << _J[st.run_index]
                    if st.run_index < 31:
                        st.run_index += 1
                if j < w:        # interrupted by a mismatching sample
                    out.write(0, 1)
                    if _J[st.run_index]:
                        out.write(run_cnt, _J[st.run_index])
                    jr = _J[st.run_index]
                    if st.run_index > 0:
                        st.run_index -= 1
                    # ---- run interruption sample ----
                    ix = line[j]
                    rb = prev[j]
                    ritype = 1 if rb == ra else 0
                    px = ra if ritype else rb
                    errval = ix - px
                    if ritype == 0 and ra > rb:
                        errval = -errval
                        sign = -1
                    else:
                        sign = 1
                    if errval < 0:
                        errval += p.range
                    if errval >= (p.range + 1) // 2:
                        errval -= p.range
                    q = 365 + ritype
                    temp = st.A[q] + ((st.N[q] >> 1) if ritype else 0)
                    k = 0
                    while (st.N[q] << k) < temp:
                        k += 1
                    if k == 0 and errval > 0 and 2 * st.Nn[ritype] < st.N[q]:
                        emap = 1
                    elif errval < 0 and 2 * st.Nn[ritype] >= st.N[q]:
                        emap = 1
                    elif errval < 0 and k != 0:
                        emap = 1
                    else:
                        emap = 0
                    emerr = 2 * abs(errval) - ritype - emap
                    _golomb_encode(out, emerr, k, p.limit - jr - 1, p.qbpp)
                    if errval < 0:
                        st.Nn[ritype] += 1
                    st.A[q] += (emerr + 1 - ritype) >> 1
                    if st.N[q] == p.reset:
                        st.A[q] >>= 1
                        st.N[q] >>= 1
                        st.Nn[ritype] >>= 1
                    st.N[q] += 1
                    cur[j] = ix          # lossless: reconstruction == input
                    j += 1
                else:
                    if run_cnt > 0:
                        out.write(1, 1)
                continue
            # ---- regular mode ----
            q1, q2, q3 = st.quantize(d1), st.quantize(d2), st.quantize(d3)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1
            px = _predict(ra, rb, rc) + sign * st.C[q]
            px = 0 if px < 0 else (p.maxval if px > p.maxval else px)
            errval = sign * (ix - px)
            if errval < 0:
                errval += p.range
            if errval >= (p.range + 1) // 2:
                errval -= p.range
            k = st.golomb_k(q)
            if k == 0 and 2 * st.B[q] <= -st.N[q]:
                merr = -2 * (errval + 1) if errval < 0 else 2 * errval + 1
            else:
                merr = -2 * errval - 1 if errval < 0 else 2 * errval
            _golomb_encode(out, merr, k, p.limit, p.qbpp)
            st.update_regular(q, errval)
            cur[j] = ix
            j += 1
        prev, cur = cur, prev
    return out.finish()


def _decode_scan(data: bytes, h: int, w: int, p: _Params) -> np.ndarray:
    st = _State(p)
    r = _BitReaderLS(data)
    out = np.empty((h, w), np.int64)
    prev = [0] * w
    cur = [0] * w
    prev_ra0 = 0
    for i in range(h):
        rc0 = prev_ra0
        prev_ra0 = prev[0]
        j = 0
        while j < w:
            ra = cur[j - 1] if j else prev[0]
            rb = prev[j]
            rc = (prev[j - 1] if j else rc0)
            rd = prev[j + 1] if j + 1 < w else prev[j]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            if d1 == 0 and d2 == 0 and d3 == 0:
                # ---- run mode ----
                while True:
                    if r.read(1) == 1:
                        n = 1 << _J[st.run_index]
                        take = min(n, w - j)
                        for _ in range(take):
                            cur[j] = ra
                            j += 1
                        if take == n and st.run_index < 31:
                            # a full segment: the encoder's while-loop
                            # branch, which also bumped its index
                            st.run_index += 1
                        if j >= w:
                            break
                    else:
                        jr = _J[st.run_index]
                        run_cnt = r.read(jr) if jr else 0
                        for _ in range(run_cnt):
                            cur[j] = ra
                            j += 1
                        if st.run_index > 0:
                            st.run_index -= 1
                        # ---- run interruption sample ----
                        rb = prev[j]
                        ritype = 1 if rb == ra else 0
                        q = 365 + ritype
                        temp = st.A[q] + ((st.N[q] >> 1) if ritype else 0)
                        k = 0
                        while (st.N[q] << k) < temp:
                            k += 1
                        emerr = _golomb_decode(r, k, p.limit - jr - 1, p.qbpp)
                        tval = emerr + ritype   # == 2*|errval| - map
                        # invert the encoder's 3-way map (evaluated on the
                        # pre-update Nn/N, exactly like the encoder)
                        if k == 0 and 2 * st.Nn[ritype] < st.N[q]:
                            # here map=1 iff errval>0
                            errval = (tval + 1) >> 1 if tval & 1 else -(tval >> 1)
                        else:
                            # here map=1 iff errval<0
                            errval = -((tval + 1) >> 1) if tval & 1 else tval >> 1
                        st.A[q] += (emerr + 1 - ritype) >> 1
                        if errval < 0:
                            st.Nn[ritype] += 1
                        if st.N[q] == p.reset:
                            st.A[q] >>= 1
                            st.N[q] >>= 1
                            st.Nn[ritype] >>= 1
                        st.N[q] += 1
                        if ritype:
                            px = ra
                            sgn = 1
                        else:
                            px = rb
                            sgn = -1 if ra > rb else 1
                        val = px + sgn * errval
                        if val < 0:
                            val += p.range
                        elif val > p.maxval:
                            val -= p.range
                        cur[j] = val
                        j += 1
                        break
                continue
            # ---- regular mode ----
            q1, q2, q3 = st.quantize(d1), st.quantize(d2), st.quantize(d3)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1
            px = _predict(ra, rb, rc) + sign * st.C[q]
            px = 0 if px < 0 else (p.maxval if px > p.maxval else px)
            k = st.golomb_k(q)
            merr = _golomb_decode(r, k, p.limit, p.qbpp)
            if k == 0 and 2 * st.B[q] <= -st.N[q]:
                # inverse of merr = 2*errval+1 (>=0) / -2*(errval+1) (<0)
                errval = (merr - 1) >> 1 if merr & 1 else -(merr >> 1) - 1
            else:
                # inverse of merr = 2*errval (>=0) / -2*errval-1 (<0)
                errval = -((merr + 1) >> 1) if merr & 1 else merr >> 1
            st.update_regular(q, errval)
            val = px + sign * errval
            # modulo into [0, maxval] (lossless)
            if val < 0:
                val += p.range
            elif val > p.maxval:
                val -= p.range
            out_val = val
            cur[j] = out_val
            j += 1
        out[i] = cur
        prev, cur = cur, prev
    return out


# ---------------------------------------------------------------------------
# codestream (SOI / SOF55 / SOS ... EOI)
# ---------------------------------------------------------------------------
def default_precision(frame: np.ndarray) -> int:
    """Codestream precision for a frame (its dtype's BitsStored analog)."""
    if frame.dtype == np.uint8:
        return 8
    if frame.dtype == np.uint16:
        return max(2, int(frame.max()).bit_length()) if frame.size else 16
    raise ValueError(f"JPEG-LS codec supports uint8/uint16, got {frame.dtype}")


def jpegls_encode(frame: np.ndarray, prec: int | None = None) -> bytes:
    """Encode a 2-D uint8/uint16 frame as a JPEG-LS lossless codestream."""
    frame = np.ascontiguousarray(frame)
    prec = prec or default_precision(frame)
    h, w = frame.shape
    p = _Params((1 << prec) - 1)
    scan = _encode_scan(frame.astype(np.int64), p)
    out = bytearray()
    out += b"\xff\xd8"                                   # SOI
    out += b"\xff\xf7"                                   # SOF55
    out += (11).to_bytes(2, "big")
    out += bytes([prec])
    out += h.to_bytes(2, "big") + w.to_bytes(2, "big")
    out += bytes([1, 1, 0x11, 0])                        # Nf=1; C1 H1V1 Tq0
    out += b"\xff\xda"                                   # SOS
    out += (8).to_bytes(2, "big")
    out += bytes([1, 1, 0, 0, 0, 0])                     # Ns=1, Cs=1 Td/Ta=0, NEAR=0, ILV=0, Al=0
    out += scan
    out += b"\xff\xd9"                                   # EOI
    return bytes(out)


def jpegls_decode(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS lossless codestream."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG-LS codestream (missing SOI)")
    pos = 2
    prec = h = w = None
    maxval = t1 = t2 = t3 = reset = None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG-LS marker expected at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        seg_len = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xF7:                               # SOF55
            prec = seg[0]
            h = int.from_bytes(seg[1:3], "big")
            w = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            if ncomp != 1:
                raise ValueError("Only single-component JPEG-LS is supported")
        elif marker == 0xF8:                             # LSE preset params
            if seg[0] == 1:
                maxval = int.from_bytes(seg[1:3], "big")
                t1 = int.from_bytes(seg[3:5], "big")
                t2 = int.from_bytes(seg[5:7], "big")
                t3 = int.from_bytes(seg[7:9], "big")
                reset = int.from_bytes(seg[9:11], "big")
        elif marker == 0xDA:                             # SOS
            near = seg[3 if seg[0] == 1 else 1 + 2 * seg[0]]
            ilv = seg[4 if seg[0] == 1 else 2 + 2 * seg[0]]
            if near != 0:
                raise ValueError("Only lossless (NEAR=0) JPEG-LS is supported")
            if ilv != 0:
                raise ValueError("Only non-interleaved JPEG-LS is supported")
            if prec is None:
                raise ValueError("SOS before SOF55")
            p = _Params(maxval if maxval else (1 << prec) - 1,
                        t1=t1 or None, t2=t2 or None, t3=t3 or None,
                        reset=reset or 64)
            arr = _decode_scan(data[pos + seg_len:], h, w, p)
            dt = np.uint8 if prec <= 8 else np.uint16
            return arr.astype(dt)
        pos += seg_len
    raise ValueError("JPEG-LS codestream has no scan")
