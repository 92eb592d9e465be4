// JPEG-LS lossless codec (ITU-T T.87), single component, NEAR=0.
// A copy of pylinac_tpu/native/jpegls.cpp for the PyTorch port.
// Byte-for-byte equivalent to the pure-Python implementation in
// pylinac_tpu_torch/core/jpegls.py (cross-checked by
// tests/test_torch_codecs.py): same default thresholds, context state,
// limited-length Golomb coding, run mode and marker-stuffed bit IO.
// Host-side hot loop — bitstream coding is sequential by nature, so it
// lives in C++ rather than on the card.
//
// Exports (C ABI, driven via ctypes from pylinac_tpu_torch/native/__init__.py):
//   jls_decode(data, len, out, cap, &rows, &cols, &prec) -> 0 on success
//   jls_encode(img, rows, cols, prec, out, cap, &outlen) -> 0 on success

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                   4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int MIN_C = -128, MAX_C = 127;

struct Params {
    int maxval, range, qbpp, bpp, limit, t1, t2, t3, reset;

    static int bitlen(int v) {
        int n = 0;
        while (v > 0) { v >>= 1; ++n; }
        return n;
    }

    void init(int maxval_, int t1_ = 0, int t2_ = 0, int t3_ = 0,
              int reset_ = 64) {
        maxval = maxval_;
        range = maxval + 1;
        qbpp = bitlen(range - 1);
        bpp = bitlen(maxval) < 2 ? 2 : bitlen(maxval);
        int m8 = bpp > 8 ? bpp : 8;
        limit = 2 * (bpp + m8);
        // default thresholds (T.87 C.2.4.1.1.1, NEAR=0)
        int d1, d2, d3;
        if (maxval >= 128) {
            int factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
            d1 = factor * (3 - 2) + 2;
            if (d1 > maxval || d1 < 1) d1 = 1;
            d2 = factor * (7 - 3) + 3;
            if (d2 > maxval || d2 < d1) d2 = d1;
            d3 = factor * (21 - 4) + 4;
            if (d3 > maxval || d3 < d2) d3 = d2;
        } else {
            int factor = 256 / (maxval + 1);
            d1 = 3 / factor; if (d1 < 2) d1 = 2;
            if (d1 > maxval || d1 < 1) d1 = 1;
            d2 = 7 / factor; if (d2 < 3) d2 = 3;
            if (d2 > maxval || d2 < d1) d2 = d1;
            d3 = 21 / factor; if (d3 < 4) d3 = 4;
            if (d3 > maxval || d3 < d2) d3 = d2;
        }
        t1 = t1_ ? t1_ : d1;
        t2 = t2_ ? t2_ : d2;
        t3 = t3_ ? t3_ : d3;
        reset = reset_;
    }
};

struct State {
    int A[367], B[365], C[365], N[367], Nn[2];
    int run_index;
    const Params *p;

    void init(const Params &prm) {
        p = &prm;
        int a0 = (prm.range + 32) / 64;
        if (a0 < 2) a0 = 2;
        for (int i = 0; i < 367; ++i) { A[i] = a0; N[i] = 1; }
        std::memset(B, 0, sizeof B);
        std::memset(C, 0, sizeof C);
        Nn[0] = Nn[1] = 0;
        run_index = 0;
    }

    inline int quantize(int d) const {
        if (d <= -p->t3) return -4;
        if (d <= -p->t2) return -3;
        if (d <= -p->t1) return -2;
        if (d < 0) return -1;
        if (d == 0) return 0;
        if (d < p->t1) return 1;
        if (d < p->t2) return 2;
        if (d < p->t3) return 3;
        return 4;
    }

    inline int golomb_k(int q) const {
        int k = 0;
        while ((N[q] << k) < A[q]) ++k;
        return k;
    }

    inline void update_regular(int q, int errval) {
        B[q] += errval;
        A[q] += errval < 0 ? -errval : errval;
        if (N[q] == p->reset) { A[q] >>= 1; B[q] >>= 1; N[q] >>= 1; }
        N[q] += 1;
        if (B[q] <= -N[q]) {
            B[q] += N[q];
            if (C[q] > MIN_C) --C[q];
            if (B[q] <= -N[q]) B[q] = -N[q] + 1;
        } else if (B[q] > 0) {
            B[q] -= N[q];
            if (C[q] < MAX_C) ++C[q];
            if (B[q] > 0) B[q] = 0;
        }
    }
};

inline int predict(int ra, int rb, int rc) {
    int mx = ra > rb ? ra : rb, mn = ra < rb ? ra : rb;
    if (rc >= mx) return mn;
    if (rc <= mn) return mx;
    return ra + rb - rc;
}

struct BitWriter {
    std::vector<uint8_t> out;
    uint32_t acc = 0;
    int nfree = 8;

    inline void flush_byte() {
        out.push_back((uint8_t)acc);
        nfree = (acc == 0xFF) ? 7 : 8;
        acc = 0;
    }
    inline void write(uint64_t value, int nbits) {
        // nbits can reach ~limit (≈48) for the unary prefix: 64-bit shifts
        while (nbits > 0) {
            int take = nbits < nfree ? nbits : nfree;
            uint32_t chunk =
                (uint32_t)((value >> (nbits - take)) & ((1ull << take) - 1));
            acc |= chunk << (nfree - take);
            nfree -= take;
            nbits -= take;
            if (nfree == 0) flush_byte();
        }
    }
    void finish() { if (nfree != 8) flush_byte(); }
};

struct BitReader {
    const uint8_t *data;
    int64_t len, pos = 0;
    uint64_t acc = 0;
    int navail = 0;
    bool prev_ff = false;
    bool corrupt = false;

    inline void pull() {
        if (pos >= len) { acc <<= 8; navail += 8; return; }
        uint32_t b = data[pos++];
        int nbits;
        if (prev_ff) { nbits = 7; b &= 0x7F; prev_ff = false; }
        else { nbits = 8; prev_ff = (b == 0xFF); }
        acc = (acc << nbits) | b;
        navail += nbits;
    }
    inline uint32_t read(int nbits) {
        while (navail < nbits) pull();
        navail -= nbits;
        return (uint32_t)((acc >> navail) & ((1ull << nbits) - 1));
    }
    inline int read_unary() {
        int n = 0;
        while (read(1) == 0) {
            if (++n > (1 << 20)) { corrupt = true; return 0; }
        }
        return n;
    }
};

inline void golomb_encode(BitWriter &w, int val, int k, int limit, int qbpp) {
    int hi = val >> k;
    if (hi < limit - qbpp - 1) {
        w.write(1u, hi + 1);
        if (k) w.write((uint32_t)val & ((1u << k) - 1), k);
    } else {
        w.write(1u, limit - qbpp);
        w.write((uint32_t)(val - 1), qbpp);
    }
}

inline int golomb_decode(BitReader &r, int k, int limit, int qbpp) {
    int hi = r.read_unary();
    if (hi < limit - qbpp - 1) return (hi << k) | (k ? (int)r.read(k) : 0);
    return (int)r.read(qbpp) + 1;
}

void encode_scan(const uint16_t *img, int h, int w, const Params &p,
                 BitWriter &out) {
    State st;
    st.init(p);
    std::vector<int> prevv(w, 0), curv(w, 0);
    int *prev = prevv.data(), *cur = curv.data();
    int prev_ra0 = 0;
    for (int i = 0; i < h; ++i) {
        const uint16_t *line = img + (int64_t)i * w;
        int rc0 = prev_ra0;
        prev_ra0 = prev[0];
        int j = 0;
        while (j < w) {
            int ix = line[j];
            int ra = j ? cur[j - 1] : prev[0];
            int rb = prev[j];
            int rc = j ? prev[j - 1] : rc0;
            int rd = (j + 1 < w) ? prev[j + 1] : prev[j];
            int d1 = rd - rb, d2 = rb - rc, d3 = rc - ra;
            if (d1 == 0 && d2 == 0 && d3 == 0) {
                // run mode
                int run_cnt = 0;
                while (j < w && line[j] == ra) { cur[j] = ra; ++run_cnt; ++j; }
                while (run_cnt >= (1 << J[st.run_index])) {
                    out.write(1, 1);
                    run_cnt -= 1 << J[st.run_index];
                    if (st.run_index < 31) ++st.run_index;
                }
                if (j < w) {
                    out.write(0, 1);
                    if (J[st.run_index]) out.write((uint32_t)run_cnt, J[st.run_index]);
                    int jr = J[st.run_index];
                    if (st.run_index > 0) --st.run_index;
                    // run interruption sample
                    ix = line[j];
                    rb = prev[j];
                    int ritype = (rb == ra) ? 1 : 0;
                    int px = ritype ? ra : rb;
                    int errval = ix - px;
                    if (!ritype && ra > rb) errval = -errval;
                    if (errval < 0) errval += p.range;
                    if (errval >= (p.range + 1) / 2) errval -= p.range;
                    int q = 365 + ritype;
                    int temp = st.A[q] + (ritype ? (st.N[q] >> 1) : 0);
                    int k = 0;
                    while ((st.N[q] << k) < temp) ++k;
                    int emap;
                    if (k == 0 && errval > 0 && 2 * st.Nn[ritype] < st.N[q]) emap = 1;
                    else if (errval < 0 && 2 * st.Nn[ritype] >= st.N[q]) emap = 1;
                    else if (errval < 0 && k != 0) emap = 1;
                    else emap = 0;
                    int aerr = errval < 0 ? -errval : errval;
                    int emerr = 2 * aerr - ritype - emap;
                    golomb_encode(out, emerr, k, p.limit - jr - 1, p.qbpp);
                    if (errval < 0) ++st.Nn[ritype];
                    st.A[q] += (emerr + 1 - ritype) >> 1;
                    if (st.N[q] == p.reset) {
                        st.A[q] >>= 1; st.N[q] >>= 1; st.Nn[ritype] >>= 1;
                    }
                    st.N[q] += 1;
                    cur[j] = ix;
                    ++j;
                } else if (run_cnt > 0) {
                    out.write(1, 1);
                }
                continue;
            }
            // regular mode
            int q1 = st.quantize(d1), q2 = st.quantize(d2), q3 = st.quantize(d3);
            int q = 81 * q1 + 9 * q2 + q3;
            int sign = 1;
            if (q < 0) { q = -q; sign = -1; }
            int px = predict(ra, rb, rc) + sign * st.C[q];
            if (px < 0) px = 0; else if (px > p.maxval) px = p.maxval;
            int errval = sign * (ix - px);
            if (errval < 0) errval += p.range;
            if (errval >= (p.range + 1) / 2) errval -= p.range;
            int k = st.golomb_k(q);
            int merr;
            if (k == 0 && 2 * st.B[q] <= -st.N[q])
                merr = errval < 0 ? -2 * (errval + 1) : 2 * errval + 1;
            else
                merr = errval < 0 ? -2 * errval - 1 : 2 * errval;
            golomb_encode(out, merr, k, p.limit, p.qbpp);
            st.update_regular(q, errval);
            cur[j] = ix;
            ++j;
        }
        int *t = prev; prev = cur; cur = t;
    }
}

int decode_scan(BitReader &r, int h, int w, const Params &p, uint16_t *out) {
    State st;
    st.init(p);
    std::vector<int> prevv(w, 0), curv(w, 0);
    int *prev = prevv.data(), *cur = curv.data();
    int prev_ra0 = 0;
    for (int i = 0; i < h; ++i) {
        int rc0 = prev_ra0;
        prev_ra0 = prev[0];
        int j = 0;
        while (j < w) {
            int ra = j ? cur[j - 1] : prev[0];
            int rb = prev[j];
            int rc = j ? prev[j - 1] : rc0;
            int rd = (j + 1 < w) ? prev[j + 1] : prev[j];
            int d1 = rd - rb, d2 = rb - rc, d3 = rc - ra;
            if (d1 == 0 && d2 == 0 && d3 == 0) {
                for (;;) {
                    if (r.read(1) == 1) {
                        int n = 1 << J[st.run_index];
                        int take = n < (w - j) ? n : (w - j);
                        for (int t = 0; t < take; ++t) cur[j++] = ra;
                        if (take == n && st.run_index < 31) ++st.run_index;
                        if (j >= w) break;
                    } else {
                        int jr = J[st.run_index];
                        int run_cnt = jr ? (int)r.read(jr) : 0;
                        for (int t = 0; t < run_cnt; ++t) cur[j++] = ra;
                        if (st.run_index > 0) --st.run_index;
                        rb = prev[j];
                        int ritype = (rb == ra) ? 1 : 0;
                        int q = 365 + ritype;
                        int temp = st.A[q] + (ritype ? (st.N[q] >> 1) : 0);
                        int k = 0;
                        while ((st.N[q] << k) < temp) ++k;
                        int emerr = golomb_decode(r, k, p.limit - jr - 1, p.qbpp);
                        int tval = emerr + ritype;
                        int errval;
                        if (k == 0 && 2 * st.Nn[ritype] < st.N[q])
                            errval = (tval & 1) ? (tval + 1) >> 1 : -(tval >> 1);
                        else
                            errval = (tval & 1) ? -((tval + 1) >> 1) : tval >> 1;
                        st.A[q] += (emerr + 1 - ritype) >> 1;
                        if (errval < 0) ++st.Nn[ritype];
                        if (st.N[q] == p.reset) {
                            st.A[q] >>= 1; st.N[q] >>= 1; st.Nn[ritype] >>= 1;
                        }
                        st.N[q] += 1;
                        int px, sgn;
                        if (ritype) { px = ra; sgn = 1; }
                        else { px = rb; sgn = (ra > rb) ? -1 : 1; }
                        int val = px + sgn * errval;
                        if (val < 0) val += p.range;
                        else if (val > p.maxval) val -= p.range;
                        cur[j++] = val;
                        break;
                    }
                    if (r.corrupt) return 3;
                }
                if (r.corrupt) return 3;
                continue;
            }
            int q1 = st.quantize(d1), q2 = st.quantize(d2), q3 = st.quantize(d3);
            int q = 81 * q1 + 9 * q2 + q3;
            int sign = 1;
            if (q < 0) { q = -q; sign = -1; }
            int px = predict(ra, rb, rc) + sign * st.C[q];
            if (px < 0) px = 0; else if (px > p.maxval) px = p.maxval;
            int k = st.golomb_k(q);
            int merr = golomb_decode(r, k, p.limit, p.qbpp);
            if (r.corrupt) return 3;
            int errval;
            if (k == 0 && 2 * st.B[q] <= -st.N[q])
                errval = (merr & 1) ? (merr - 1) >> 1 : -(merr >> 1) - 1;
            else
                errval = (merr & 1) ? -((merr + 1) >> 1) : merr >> 1;
            st.update_regular(q, errval);
            int val = px + sign * errval;
            if (val < 0) val += p.range;
            else if (val > p.maxval) val -= p.range;
            cur[j++] = val;
        }
        uint16_t *orow = out + (int64_t)i * w;
        for (int t = 0; t < w; ++t) orow[t] = (uint16_t)cur[t];
        int *tp = prev; prev = cur; cur = tp;
    }
    return 0;
}

inline int rd16(const uint8_t *d) { return (d[0] << 8) | d[1]; }

}  // namespace

extern "C" {

// Decode a single-component JPEG-LS lossless codestream.
// Returns 0 ok; 1 bad header; 2 unsupported; 3 corrupt; 4 capacity.
int jls_decode(const uint8_t *data, int64_t len, uint16_t *out, int64_t cap,
               int *rows, int *cols, int *prec_out) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return 1;
    int64_t pos = 2;
    int prec = 0, h = 0, w = 0;
    int maxval = 0, t1 = 0, t2 = 0, t3 = 0, reset = 64;
    while (pos + 4 <= len) {
        if (data[pos] != 0xFF) return 1;
        int marker = data[pos + 1];
        pos += 2;
        if (marker == 0xD9) break;
        if (pos + 2 > len) return 1;
        int seg_len = rd16(data + pos);
        if (pos + seg_len > len) return 1;
        const uint8_t *seg = data + pos + 2;
        if (marker == 0xF7) {                       // SOF55
            prec = seg[0];
            h = rd16(seg + 1);
            w = rd16(seg + 3);
            if (seg[5] != 1) return 2;              // multi-component
        } else if (marker == 0xF8) {                // LSE
            if (seg[0] == 1) {
                maxval = rd16(seg + 1);
                t1 = rd16(seg + 3);
                t2 = rd16(seg + 5);
                t3 = rd16(seg + 7);
                reset = rd16(seg + 9);
            }
        } else if (marker == 0xDA) {                // SOS
            int ns = seg[0];
            int near = seg[1 + 2 * ns];
            int ilv = seg[2 + 2 * ns];
            if (near != 0 || ilv != 0 || ns != 1) return 2;
            if (!prec || !h || !w) return 1;
            if ((int64_t)h * w > cap) return 4;
            Params p;
            p.init(maxval ? maxval : (1 << prec) - 1, t1, t2, t3,
                   reset ? reset : 64);
            BitReader r{data + pos + seg_len, len - pos - seg_len};
            int rc = decode_scan(r, h, w, p, out);
            if (rc) return rc;
            *rows = h;
            *cols = w;
            *prec_out = prec;
            return 0;
        }
        pos += seg_len;
    }
    return 1;
}

// Encode rows x cols samples (uint16 buffer, values < 2^prec) as a JPEG-LS
// lossless codestream. Returns 0 ok; 4 capacity too small.
int jls_encode(const uint16_t *img, int rows, int cols, int prec,
               uint8_t *out, int64_t cap, int64_t *out_len) {
    Params p;
    p.init((1 << prec) - 1);
    BitWriter w;
    w.out.reserve((size_t)rows * cols * 2 + 64);
    uint8_t hdr[] = {
        0xFF, 0xD8,
        0xFF, 0xF7, 0, 11, (uint8_t)prec,
        (uint8_t)(rows >> 8), (uint8_t)rows,
        (uint8_t)(cols >> 8), (uint8_t)cols,
        1, 1, 0x11, 0,
        0xFF, 0xDA, 0, 8, 1, 1, 0, 0, 0, 0,
    };
    for (uint8_t b : hdr) w.out.push_back(b);
    encode_scan(img, rows, cols, p, w);
    w.finish();
    w.out.push_back(0xFF);
    w.out.push_back(0xD9);
    if ((int64_t)w.out.size() > cap) return 4;
    std::memcpy(out, w.out.data(), w.out.size());
    *out_len = (int64_t)w.out.size();
    return 0;
}

}  // extern "C"
