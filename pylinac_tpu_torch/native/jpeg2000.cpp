// JPEG 2000 Part-1 codec (ITU-T T.800), grayscale, single tile.
//
// A copy of pylinac_tpu/native/jpeg2000.cpp for the PyTorch port.
// DICOM transfer syntaxes 1.2.840.10008.1.2.4.90 (lossless) and .91 appear
// in clinical CT/CBCT exports; pylinac reads them through pydicom's
// pylibjpeg/openjpeg handlers. This is a from-scratch implementation sized
// to that use case:
//
//   decode: 5/3 reversible AND 9/7 irreversible wavelets, MQ arithmetic
//           decoding, all three tier-1 passes, tag-tree packet headers,
//           LRCP/RLCP/RPCL/PCRL/CPRL progressions, one tile, one component,
//           multiple tile-parts, optional JP2 box wrapping.
//   encode: lossless 5/3, single tile/layer/LRCP, 64x64 code-blocks, no
//           mode switches — the shape openjpeg emits for lossless exports.
//
// Exports (C ABI, ctypes via pylinac_tpu_torch/native/__init__.py):
//   j2k_decode(data, len, out_i32, cap, &rows, &cols, &prec, &sgnd)
//   j2k_encode(img_i32, rows, cols, prec, sgnd, out_u8, cap, &outlen)
// Return 0 on success; small positive error codes otherwise.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ===========================================================================
// MQ arithmetic coder (T.800 Annex C; identical tables to JBIG2/JPEG MQ)
// ===========================================================================
struct MQState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

const MQState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},  {0x3401, 2, 6, 0},  {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0}, {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},  {0x5401, 8, 14, 0}, {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0},{0x3001, 11, 17, 0},{0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0},{0x1601, 29, 21, 0},{0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0},{0x5101, 17, 15, 0},{0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0},{0x3401, 20, 18, 0},{0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0},{0x2401, 23, 20, 0},{0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0},{0x1801, 26, 23, 0},{0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0},{0x1201, 29, 26, 0},{0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0},{0x09C1, 32, 29, 0},{0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0},{0x0441, 35, 32, 0},{0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0},{0x0141, 38, 35, 0},{0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0},{0x0049, 41, 38, 0},{0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0},{0x0009, 44, 41, 0},{0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0},{0x5601, 46, 46, 0},
};

struct MQContext {
    uint8_t i = 0;   // state index
    uint8_t mps = 0;
};

// T1 uses 19 contexts: 0..8 zero coding, 9..13 sign, 14..16 refinement,
// 17 UNI (cleanup run), 18 RL (run-length)
enum { CTX_UNI = 17, CTX_RL = 18, N_CTX = 19 };

static void init_t1_contexts(MQContext *cx) {
    for (int i = 0; i < N_CTX; ++i) { cx[i].i = 0; cx[i].mps = 0; }
    cx[0].i = 4;        // ZC context 0 starts in state 4
    cx[CTX_RL].i = 3;   // run-length starts in state 3
    cx[CTX_UNI].i = 46; // UNI starts in state 46
}

struct MQDecoder {
    const uint8_t *bp, *start, *end;
    uint32_t c;
    int ct;
    uint32_t a;

    void init(const uint8_t *data, size_t len) {
        start = bp = data;
        end = data + len;
        c = (uint32_t)(bp < end ? *bp : 0xFF) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }

    void bytein() {
        if (bp < end && *bp == 0xFF) {
            if (bp + 1 < end && bp[1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += (uint32_t)(bp < end ? *bp : 0xFF) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += (uint32_t)(bp < end ? *bp : 0xFF) << 8;
            ct = 8;
        }
    }

    int decode(MQContext &cx) {
        const MQState &s = MQ_TABLE[cx.i];
        int d;
        a -= s.qe;
        if (((c >> 16) & 0xFFFF) < s.qe) {
            // LPS exchange path
            if (a < s.qe) {
                d = cx.mps;
                cx.i = s.nmps;
            } else {
                d = 1 - cx.mps;
                if (s.sw) cx.mps = 1 - cx.mps;
                cx.i = s.nlps;
            }
            a = s.qe;
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) != 0) return cx.mps;
            if (a < s.qe) {
                d = 1 - cx.mps;
                if (s.sw) cx.mps = 1 - cx.mps;
                cx.i = s.nlps;
            } else {
                d = cx.mps;
                cx.i = s.nmps;
            }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while ((a & 0x8000) == 0);
        return d;
    }
};

struct MQEncoder {
    std::vector<uint8_t> out;
    uint32_t c = 0;
    uint32_t a = 0x8000;
    int ct = 12;
    int bp = -1;     // index into out of the byte being built ("B")

    void byteout() {
        if (bp >= 0 && out[bp] == 0xFF) {
            ++bp;
            out.push_back((uint8_t)(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else {
            if (c < 0x8000000) {
                ++bp;
                out.push_back((uint8_t)(c >> 19));
                c &= 0x7FFFF;
                ct = 8;
            } else {
                if (bp >= 0) {
                    out[bp] += 1;
                    if (out[bp] == 0xFF) {
                        c &= 0x7FFFFFF;
                        ++bp;
                        out.push_back((uint8_t)(c >> 20));
                        c &= 0xFFFFF;
                        ct = 7;
                        return;
                    }
                }
                ++bp;
                out.push_back((uint8_t)(c >> 19));
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }

    void encode(MQContext &cx, int d) {
        const MQState &s = MQ_TABLE[cx.i];
        if (d == cx.mps) {
            a -= s.qe;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) a = s.qe;
                else c += s.qe;
                cx.i = s.nmps;
                do {
                    a <<= 1;
                    c <<= 1;
                    if (--ct == 0) byteout();
                } while ((a & 0x8000) == 0);
            } else {
                c += s.qe;
            }
        } else {
            a -= s.qe;
            if (a < s.qe) c += s.qe;
            else a = s.qe;
            if (s.sw) cx.mps = 1 - cx.mps;
            cx.i = s.nlps;
            do {
                a <<= 1;
                c <<= 1;
                if (--ct == 0) byteout();
            } while ((a & 0x8000) == 0);
        }
    }

    void flush() {
        // SETBITS
        uint32_t temp = c + a;
        c |= 0xFFFF;
        if (c >= temp) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        // drop a trailing 0xFF (decoder re-synthesizes it)
        if (!out.empty() && out.back() == 0xFF) out.pop_back();
    }

    // first real byte is out[0]; bp==-1 start means out[0] valid from first byteout
    std::vector<uint8_t> take() {
        // out[0] may be a spurious 0x00 from the initial bp=-1 handling —
        // the standard's INITENC sets BP to BPST-1; our first byteout pushes
        // the first byte directly, so no adjustment is needed.
        return std::move(out);
    }
};

// ===========================================================================
// bit IO for packet headers (with 0xFF bit-stuffing)
// ===========================================================================
struct HdrReader {
    const uint8_t *d;
    size_t len, pos = 0;
    uint32_t buf = 0;
    int cnt = 0;
    uint8_t last = 0;

    int bit() {
        if (cnt == 0) {
            if (pos >= len) return -1;
            int nbits = (last == 0xFF) ? 7 : 8;
            last = d[pos++];
            buf = last & ((1u << nbits) - 1);
            cnt = nbits;
        }
        return (int)((buf >> --cnt) & 1);
    }
    long bits(int n) {
        long v = 0;
        while (n--) {
            int b = bit();
            if (b < 0) return -1;
            v = (v << 1) | b;
        }
        return v;
    }
    void align() {
        // end of packet header: drop to the byte boundary; a header whose
        // final byte is 0xFF is followed by a stuffing byte (< 0x80) that
        // belongs to the header — consume it (B.10.1)
        cnt = 0;
        if (last == 0xFF) {
            if (pos < len) ++pos;
        }
        last = 0;
    }
};

struct HdrWriter {
    std::vector<uint8_t> out;
    uint32_t acc = 0;
    int nfree = 8;

    void bit(int b) {
        acc |= (uint32_t)(b & 1) << (nfree - 1);
        if (--nfree == 0) {
            out.push_back((uint8_t)acc);
            nfree = (acc == 0xFF) ? 7 : 8;
            acc = 0;
        }
    }
    void bits(uint32_t v, int n) {
        while (n--) bit((v >> n) & 1);
    }
    void align() {
        while (nfree != 8) bit(0);
        if (!out.empty() && out.back() == 0xFF) out.push_back(0);
    }
};

// ===========================================================================
// tag trees (T.800 B.10.2)
//
// Per node: `value` is the communicated lower bound of the node's true
// value (exact once `known`). A query at threshold t asks "is w(leaf) < t?";
// each node on the root→leaf path emits 0-bits (w > current bound) until
// either a 1-bit pins the exact value or the bound reaches t (answer "no").
// Since w(child) >= w(parent), a child's starting bound is its parent's
// pinned value. Both sides run the identical walk, so the bit positions
// line up by construction.
// ===========================================================================
struct TagTree {
    int w = 0, h = 0, nodes = 0;
    std::vector<int> value, known, parent, wtrue;

    void init(int w_, int h_) {
        w = w_;
        h = h_;
        nodes = 0;
        std::vector<int> lvl_off;
        std::vector<std::pair<int, int>> dims;
        int lw = w, lh = h;
        while (true) {
            dims.push_back({lw, lh});
            lvl_off.push_back(nodes);
            nodes += lw * lh;
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        parent.assign(nodes, -1);
        for (size_t l = 0; l + 1 < dims.size(); ++l) {
            int cw = dims[l].first, ch = dims[l].second;
            int pw = dims[l + 1].first;
            for (int y = 0; y < ch; ++y)
                for (int x = 0; x < cw; ++x)
                    parent[lvl_off[l] + y * cw + x] =
                        lvl_off[l + 1] + (y / 2) * pw + (x / 2);
        }
        reset();
    }

    void reset() {
        value.assign(nodes, 0);
        known.assign(nodes, 0);
    }

    // encoder side: set the true leaf values; internal nodes = subtree min
    void set_leaf_values(const std::vector<int> &leaves) {
        wtrue.assign(nodes, INT32_MAX);
        for (int i = 0; i < w * h; ++i) wtrue[i] = leaves[i];
        for (int n = 0; n < nodes; ++n)
            if (parent[n] >= 0 && wtrue[n] < wtrue[parent[n]])
                wtrue[parent[n]] = wtrue[n];
    }

    void path(int leaf, int chain[32], int &n) const {
        n = 0;
        for (int node = leaf; node >= 0; node = parent[node]) chain[n++] = node;
    }

    // returns 1 iff w(leaf) < threshold, 0 otherwise, -1 on bitstream error
    int decode(HdrReader &r, int leaf, int threshold) {
        int chain[32], n;
        path(leaf, chain, n);
        int low = 0;
        for (int i = n - 1; i >= 0; --i) {
            int node = chain[i];
            if (value[node] < low) value[node] = low;
            while (!known[node] && value[node] < threshold) {
                int b = r.bit();
                if (b < 0) return -1;
                if (b) known[node] = 1;
                else ++value[node];
            }
            if (!known[node]) return 0;      // bound reached t: w >= t
            low = value[node];
        }
        return value[leaf] < threshold ? 1 : 0;
    }

    // emit the bits the decoder above will consume for this query
    void encode(HdrWriter &wr, int leaf, int threshold) {
        int chain[32], n;
        path(leaf, chain, n);
        int low = 0;
        for (int i = n - 1; i >= 0; --i) {
            int node = chain[i];
            if (value[node] < low) value[node] = low;
            while (!known[node] && value[node] < threshold) {
                if (value[node] == wtrue[node]) {
                    wr.bit(1);
                    known[node] = 1;
                } else {
                    wr.bit(0);
                    ++value[node];
                }
            }
            if (!known[node]) return;
            low = value[node];
        }
    }
};

}  // namespace

namespace {

// ===========================================================================
// EBCOT tier-1 (T.800 Annex D): three coding passes over bit-planes with
// MQ-coded zero/sign/refinement decisions. Flags per sample: significance,
// visited-in-this-bitplane, has-been-refined.
// ===========================================================================
enum : uint8_t { F_SIG = 1, F_VISIT = 2, F_REF = 4 };

struct T1Block {
    int w = 0, h = 0;
    int band = 0;                 // 0 LL, 1 HL, 2 LH, 3 HH
    std::vector<int32_t> mag;
    std::vector<int8_t> sgn;      // 0 positive, 1 negative
    std::vector<uint8_t> flags;

    void init(int w_, int h_, int band_) {
        w = w_;
        h = h_;
        band = band_;
        mag.assign((size_t)w * h, 0);
        sgn.assign((size_t)w * h, 0);
        flags.assign((size_t)w * h, 0);
    }

    inline bool sig(int x, int y) const {
        if (x < 0 || y < 0 || x >= w || y >= h) return false;
        return flags[(size_t)y * w + x] & F_SIG;
    }
    inline int signat(int x, int y) const {  // +1 / -1 / 0
        if (x < 0 || y < 0 || x >= w || y >= h) return 0;
        size_t i = (size_t)y * w + x;
        if (!(flags[i] & F_SIG)) return 0;
        return sgn[i] ? -1 : 1;
    }

    int zc_context(int x, int y) const {
        int hn = (int)sig(x - 1, y) + (int)sig(x + 1, y);
        int vn = (int)sig(x, y - 1) + (int)sig(x, y + 1);
        int dn = (int)sig(x - 1, y - 1) + (int)sig(x + 1, y - 1) +
                 (int)sig(x - 1, y + 1) + (int)sig(x + 1, y + 1);
        if (band == 1) {  // HL: swap h/v roles
            int t = hn;
            hn = vn;
            vn = t;
        }
        if (band != 3) {  // LL, LH, HL
            if (hn == 2) return 8;
            if (hn == 1) {
                if (vn >= 1) return 7;
                if (dn >= 1) return 6;
                return 5;
            }
            if (vn == 2) return 4;
            if (vn == 1) return 3;
            if (dn >= 2) return 2;
            if (dn == 1) return 1;
            return 0;
        }
        // HH
        int hv = hn + vn;
        if (dn >= 3) return 8;
        if (dn == 2) return hv >= 1 ? 7 : 6;
        if (dn == 1) {
            if (hv >= 2) return 5;
            if (hv == 1) return 4;
            return 3;
        }
        if (hv >= 2) return 2;
        if (hv == 1) return 1;
        return 0;
    }

    // sign context + xor bit (T.800 Table D.3)
    void sc_context(int x, int y, int &ctx, int &xorbit) const {
        int hc = signat(x - 1, y) + signat(x + 1, y);
        int vc = signat(x, y - 1) + signat(x, y + 1);
        if (hc > 1) hc = 1;
        if (hc < -1) hc = -1;
        if (vc > 1) vc = 1;
        if (vc < -1) vc = -1;
        if (hc == 1) {
            if (vc == 1) { ctx = 13; xorbit = 0; }
            else if (vc == 0) { ctx = 12; xorbit = 0; }
            else { ctx = 11; xorbit = 0; }
        } else if (hc == 0) {
            if (vc == 1) { ctx = 10; xorbit = 0; }
            else if (vc == 0) { ctx = 9; xorbit = 0; }
            else { ctx = 10; xorbit = 1; }
        } else {
            if (vc == 1) { ctx = 11; xorbit = 1; }
            else if (vc == 0) { ctx = 12; xorbit = 1; }
            else { ctx = 13; xorbit = 1; }
        }
    }

    int mr_context(int x, int y) const {
        size_t i = (size_t)y * w + x;
        if (flags[i] & F_REF) return 16;
        int any = (int)sig(x - 1, y) + (int)sig(x + 1, y) + (int)sig(x, y - 1) +
                  (int)sig(x, y + 1) + (int)sig(x - 1, y - 1) +
                  (int)sig(x + 1, y - 1) + (int)sig(x - 1, y + 1) +
                  (int)sig(x + 1, y + 1);
        return any ? 15 : 14;
    }

    inline bool any_sig_neighbor(int x, int y) const {
        return sig(x - 1, y) || sig(x + 1, y) || sig(x, y - 1) ||
               sig(x, y + 1) || sig(x - 1, y - 1) || sig(x + 1, y - 1) ||
               sig(x - 1, y + 1) || sig(x + 1, y + 1);
    }

    // ---------------- decode passes ----------------
    void dec_sigpass(MQDecoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    size_t i = (size_t)y * w + x;
                    if ((flags[i] & F_SIG) || !any_sig_neighbor(x, y)) continue;
                    if (mq.decode(cx[zc_context(x, y)])) {
                        int sctx, xb;
                        sc_context(x, y, sctx, xb);
                        int s = mq.decode(cx[sctx]) ^ xb;
                        flags[i] |= F_SIG;
                        sgn[i] = (int8_t)s;
                        mag[i] |= (int32_t)1 << plane;
                    }
                    flags[i] |= F_VISIT;
                }
    }

    void dec_refpass(MQDecoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    size_t i = (size_t)y * w + x;
                    if (!(flags[i] & F_SIG) || (flags[i] & F_VISIT)) continue;
                    int bit = mq.decode(cx[mr_context(x, y)]);
                    flags[i] |= F_REF;
                    if (bit) mag[i] |= (int32_t)1 << plane;
                }
    }

    void dec_clnpass(MQDecoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x) {
                int y = y0;
                int ylim = y0 + 4 < h ? y0 + 4 : h;
                // run-length shortcut: full 4-stripe, nothing visited,
                // no significant sample or neighbor anywhere in the column
                bool can_rl = (ylim - y0 == 4);
                if (can_rl)
                    for (int yy = y0; yy < ylim && can_rl; ++yy) {
                        size_t i = (size_t)yy * w + x;
                        if (flags[i] & (F_SIG | F_VISIT)) can_rl = false;
                        else if (any_sig_neighbor(x, yy)) can_rl = false;
                    }
                if (can_rl) {
                    if (!mq.decode(cx[CTX_RL])) {
                        // all four stay insignificant this plane
                        for (int yy = y0; yy < ylim; ++yy)
                            flags[(size_t)yy * w + x] &= ~F_VISIT;
                        continue;
                    }
                    int r = (mq.decode(cx[CTX_UNI]) << 1) | mq.decode(cx[CTX_UNI]);
                    y = y0 + r;
                    // the r-th sample becomes significant (no ZC bit coded)
                    size_t i = (size_t)y * w + x;
                    int sctx, xb;
                    sc_context(x, y, sctx, xb);
                    int s = mq.decode(cx[sctx]) ^ xb;
                    flags[i] |= F_SIG;
                    sgn[i] = (int8_t)s;
                    mag[i] |= (int32_t)1 << plane;
                    ++y;
                }
                for (; y < ylim; ++y) {
                    size_t i = (size_t)y * w + x;
                    if (flags[i] & (F_SIG | F_VISIT)) {
                        flags[i] &= ~F_VISIT;
                        continue;
                    }
                    if (mq.decode(cx[zc_context(x, y)])) {
                        int sctx, xb;
                        sc_context(x, y, sctx, xb);
                        int s = mq.decode(cx[sctx]) ^ xb;
                        flags[i] |= F_SIG;
                        sgn[i] = (int8_t)s;
                        mag[i] |= (int32_t)1 << plane;
                    }
                }
                // clear visit flags handled inline above for skipped ones
            }
        // clear all visit flags for the next bitplane
        for (auto &f : flags) f = (uint8_t)(f & ~F_VISIT);
    }

    // decode npasses starting at the MSB plane (numbps-1), all in one MQ
    // codeword segment (no mode switches)
    int decode_passes(const uint8_t *data, size_t len, int numbps, int npasses) {
        MQDecoder mq;
        MQContext cx[N_CTX];
        init_t1_contexts(cx);
        mq.init(data, len);
        int plane = numbps - 1;
        int pass = 0;  // 0 CUP (first plane), then SPP/MRP/CUP cycles
        for (int p = 0; p < npasses; ++p) {
            if (plane < 0) return 1;
            if (pass == 0) {
                dec_clnpass(mq, cx, plane);
                --plane;
                pass = 1;
            } else if (pass == 1) {
                dec_sigpass(mq, cx, plane);
                pass = 2;
            } else {
                dec_refpass(mq, cx, plane);
                pass = 0;  // cleanup follows, same plane
            }
        }
        return 0;
    }

    // ---------------- encode passes ----------------
    void enc_sigpass(MQEncoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    size_t i = (size_t)y * w + x;
                    if ((flags[i] & F_SIG) || !any_sig_neighbor(x, y)) continue;
                    int bit = (mag[i] >> plane) & 1;
                    mq.encode(cx[zc_context(x, y)], bit);
                    if (bit) {
                        int sctx, xb;
                        sc_context(x, y, sctx, xb);
                        mq.encode(cx[sctx], sgn[i] ^ xb);
                        flags[i] |= F_SIG;
                    }
                    flags[i] |= F_VISIT;
                }
    }

    void enc_refpass(MQEncoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    size_t i = (size_t)y * w + x;
                    if (!(flags[i] & F_SIG) || (flags[i] & F_VISIT)) continue;
                    mq.encode(cx[mr_context(x, y)], (mag[i] >> plane) & 1);
                    flags[i] |= F_REF;
                }
    }

    void enc_clnpass(MQEncoder &mq, MQContext *cx, int plane) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x) {
                int y = y0;
                int ylim = y0 + 4 < h ? y0 + 4 : h;
                bool can_rl = (ylim - y0 == 4);
                if (can_rl)
                    for (int yy = y0; yy < ylim && can_rl; ++yy) {
                        size_t i = (size_t)yy * w + x;
                        if (flags[i] & (F_SIG | F_VISIT)) can_rl = false;
                        else if (any_sig_neighbor(x, yy)) can_rl = false;
                    }
                if (can_rl) {
                    int first = -1;
                    for (int yy = y0; yy < ylim; ++yy)
                        if ((mag[(size_t)yy * w + x] >> plane) & 1) {
                            first = yy;
                            break;
                        }
                    if (first < 0) {
                        mq.encode(cx[CTX_RL], 0);
                        for (int yy = y0; yy < ylim; ++yy)
                            flags[(size_t)yy * w + x] &= ~F_VISIT;
                        continue;
                    }
                    mq.encode(cx[CTX_RL], 1);
                    int r = first - y0;
                    mq.encode(cx[CTX_UNI], (r >> 1) & 1);
                    mq.encode(cx[CTX_UNI], r & 1);
                    y = first;
                    size_t i = (size_t)y * w + x;
                    int sctx, xb;
                    sc_context(x, y, sctx, xb);
                    mq.encode(cx[sctx], sgn[i] ^ xb);
                    flags[i] |= F_SIG;
                    ++y;
                }
                for (; y < ylim; ++y) {
                    size_t i = (size_t)y * w + x;
                    if (flags[i] & (F_SIG | F_VISIT)) {
                        flags[i] &= ~F_VISIT;
                        continue;
                    }
                    int bit = (mag[i] >> plane) & 1;
                    mq.encode(cx[zc_context(x, y)], bit);
                    if (bit) {
                        int sctx, xb;
                        sc_context(x, y, sctx, xb);
                        mq.encode(cx[sctx], sgn[i] ^ xb);
                        flags[i] |= F_SIG;
                    }
                }
            }
        for (auto &f : flags) f = (uint8_t)(f & ~F_VISIT);
    }

    // encode ALL passes (lossless). Returns (bytes, npasses, numbps).
    void encode_all(std::vector<uint8_t> &bytes, int &npasses, int &numbps) {
        int32_t mx = 0;
        for (auto v : mag)
            if (v > mx) mx = v;
        numbps = 0;
        while ((1 << numbps) <= mx) ++numbps;
        if (numbps == 0) {
            npasses = 0;
            bytes.clear();
            return;
        }
        for (auto &f : flags) f = 0;
        MQEncoder mq;
        MQContext cx[N_CTX];
        init_t1_contexts(cx);
        npasses = 3 * numbps - 2;
        int plane = numbps - 1;
        enc_clnpass(mq, cx, plane);
        for (plane = numbps - 2; plane >= 0; --plane) {
            enc_sigpass(mq, cx, plane);
            enc_refpass(mq, cx, plane);
            enc_clnpass(mq, cx, plane);
        }
        mq.flush();
        bytes = mq.take();
    }
};

}  // namespace

namespace {

// ===========================================================================
// reversible 5/3 wavelet (T.800 Annex F), absolute-coordinate lifting with
// whole-sample symmetric extension. Inverse order per F.3.4: interleave,
// horizontal synthesis, vertical synthesis (forward mirrors it).
// ===========================================================================
inline int64_t ceil_div(int64_t a, int64_t b) {
    return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// symmetric reflection of index i into [i0, i1)
inline int reflect(int i, int i0, int i1) {
    int n = i1 - i0;
    if (n == 1) return i0;
    while (i < i0 || i >= i1) {
        if (i < i0) i = 2 * i0 - i;
        if (i >= i1) i = 2 * (i1 - 1) - i;
    }
    return i;
}

// in-place inverse on Y[i0..i1) (absolute indices; Y[0] is index i0)
void sr_1d_53(int32_t *Y, int i0, int i1) {
    int n = i1 - i0;
    if (n <= 0) return;
    if (n == 1) {
        if (i0 & 1) Y[0] /= 2;
        return;
    }
    auto at = [&](int i) -> int32_t & { return Y[reflect(i, i0, i1) - i0]; };
    // even samples first: X(2k) = Y(2k) - floor((Y(2k-1) + Y(2k+1) + 2)/4)
    int start = i0 + ((i0 & 1) ? 1 : 0);
    for (int i = start; i < i1; i += 2) {
        int32_t l = at(i - 1), r = at(i + 1);
        Y[i - i0] -= (int32_t)((l + r + 2) >> 2);
    }
    // odd samples: X(2k+1) = Y(2k+1) + floor((X(2k) + X(2k+2))/2)
    start = i0 + ((i0 & 1) ? 0 : 1);
    for (int i = start; i < i1; i += 2) {
        int32_t l = at(i - 1), r = at(i + 1);
        Y[i - i0] += (int32_t)((l + r) >> 1);
    }
}

// in-place forward on X[i0..i1): produces interleaved L/H at even/odd
void sd_1d_53(int32_t *Y, int i0, int i1) {
    int n = i1 - i0;
    if (n <= 0) return;
    if (n == 1) {
        if (i0 & 1) Y[0] *= 2;
        return;
    }
    auto at = [&](int i) -> int32_t & { return Y[reflect(i, i0, i1) - i0]; };
    // odd (highpass) first: H = X(2k+1) - floor((X(2k) + X(2k+2))/2)
    int start = i0 + ((i0 & 1) ? 0 : 1);
    for (int i = start; i < i1; i += 2) {
        int32_t l = at(i - 1), r = at(i + 1);
        Y[i - i0] -= (int32_t)((l + r) >> 1);
    }
    // even (lowpass): L = X(2k) + floor((H(2k-1) + H(2k+1) + 2)/4)
    start = i0 + ((i0 & 1) ? 1 : 0);
    for (int i = start; i < i1; i += 2) {
        int32_t l = at(i - 1), r = at(i + 1);
        Y[i - i0] += (int32_t)((l + r + 2) >> 2);
    }
}

// ===========================================================================
// codestream geometry (single tile, single component, origins possibly != 0)
// ===========================================================================
struct CodeBlock {
    int x0, y0, x1, y1;          // subband coordinates
    int zbp = 0;                 // missing bit-planes (from tag tree)
    int numbps = 0;
    int lblock = 3;
    int npasses = 0;             // total decoded passes
    bool seen = false;           // included in any previous layer
    std::vector<uint8_t> data;   // concatenated codeword segments
};

struct Precinct {
    int cbx0, cby0, cbx1, cby1;  // code-block index range (subband grid)
    TagTree incl, zbp;
};

struct Subband {
    int band = 0;                // 0 LL, 1 HL, 2 LH, 3 HH
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int cbxexp = 6, cbyexp = 6;  // effective code-block size exponents
    int ncbx = 0, ncby = 0;      // full code-block grid dims
    int cb0x = 0, cb0y = 0;      // first code-block grid index
    std::vector<CodeBlock> blocks;
    std::vector<Precinct> precincts;

    int width() const { return x1 - x0; }
    int height() const { return y1 - y0; }
};

struct Resolution {
    int r = 0;
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int ppx = 15, ppy = 15;      // precinct exponents at this resolution
    int npx = 0, npy = 0;        // precinct counts
    int nbands = 0;
    Subband bands[3];
};

struct CodingParams {
    int w = 0, h = 0, x0 = 0, y0 = 0;  // image grid
    int prec = 16;
    bool sgnd = false;
    int levels = 5;
    int layers = 1;
    int progression = 0;         // 0 LRCP 1 RLCP 2 RPCL 3 PCRL 4 CPRL
    int cbw_exp = 6, cbh_exp = 6;
    int transform = 1;           // 1 = 5/3 reversible, 0 = 9/7
    int mode = 0;                // code-block style (mode switches)
    bool sop = false, eph = false;
    std::vector<int> prec_exps;  // per-resolution (PPx | PPy<<4) if present
    // quantization: exponents per subband in order (for Mb); reversible
    std::vector<int> qcd_exps;
    int guard_bits = 2;
};

// subband gain for Mb computation (T.800 E.1: LL 0, HL/LH 1, HH 2)
inline int band_gain(int b) { return b == 0 ? 0 : (b == 3 ? 2 : 1); }

// build the resolution/subband/code-block geometry for one tile-component
void build_geometry(const CodingParams &cp, std::vector<Resolution> &res) {
    int NL = cp.levels;
    res.resize(NL + 1);
    int tcx0 = cp.x0, tcy0 = cp.y0, tcx1 = cp.x0 + cp.w, tcy1 = cp.y0 + cp.h;
    for (int r = 0; r <= NL; ++r) {
        Resolution &R = res[r];
        R.r = r;
        int s = NL - r;
        R.x0 = (int)ceil_div(tcx0, 1LL << s);
        R.y0 = (int)ceil_div(tcy0, 1LL << s);
        R.x1 = (int)ceil_div(tcx1, 1LL << s);
        R.y1 = (int)ceil_div(tcy1, 1LL << s);
        if ((int)cp.prec_exps.size() > r) {
            R.ppx = cp.prec_exps[r] & 0xF;
            R.ppy = (cp.prec_exps[r] >> 4) & 0xF;
        } else {
            R.ppx = R.ppy = 15;
        }
        // precinct grid over the resolution
        if (R.x1 > R.x0 && R.y1 > R.y0) {
            int px0 = (R.x0 >> R.ppx) << R.ppx;
            int py0 = (R.y0 >> R.ppy) << R.ppy;
            R.npx = (int)ceil_div(R.x1 - px0, 1LL << R.ppx);
            R.npy = (int)ceil_div(R.y1 - py0, 1LL << R.ppy);
        } else {
            R.npx = R.npy = 0;
        }
        R.nbands = (r == 0) ? 1 : 3;
        for (int bi = 0; bi < R.nbands; ++bi) {
            Subband &B = R.bands[bi];
            int lev = (r == 0) ? NL : NL - r + 1;  // decomposition level
            int xob, yob;
            if (r == 0) { B.band = 0; xob = yob = 0; }
            else if (bi == 0) { B.band = 1; xob = 1; yob = 0; }   // HL
            else if (bi == 1) { B.band = 2; xob = 0; yob = 1; }   // LH
            else { B.band = 3; xob = 1; yob = 1; }                // HH
            int64_t sh = 1LL << (lev - 1);
            B.x0 = (int)ceil_div(tcx0 - sh * xob, 1LL << lev);
            B.y0 = (int)ceil_div(tcy0 - sh * yob, 1LL << lev);
            B.x1 = (int)ceil_div(tcx1 - sh * xob, 1LL << lev);
            B.y1 = (int)ceil_div(tcy1 - sh * yob, 1LL << lev);
            // effective code-block exponents bounded by the precinct size
            int ppx_b = (r == 0) ? R.ppx : R.ppx - 1;
            int ppy_b = (r == 0) ? R.ppy : R.ppy - 1;
            B.cbxexp = cp.cbw_exp < ppx_b ? cp.cbw_exp : ppx_b;
            B.cbyexp = cp.cbh_exp < ppy_b ? cp.cbh_exp : ppy_b;
            if (B.x1 > B.x0 && B.y1 > B.y0) {
                B.cb0x = B.x0 >> B.cbxexp;
                B.cb0y = B.y0 >> B.cbyexp;
                B.ncbx = (int)ceil_div(B.x1, 1LL << B.cbxexp) - B.cb0x;
                B.ncby = (int)ceil_div(B.y1, 1LL << B.cbyexp) - B.cb0y;
            } else {
                B.ncbx = B.ncby = 0;
                B.cb0x = B.cb0y = 0;
            }
            B.blocks.resize((size_t)B.ncbx * B.ncby);
            for (int cy = 0; cy < B.ncby; ++cy)
                for (int cxi = 0; cxi < B.ncbx; ++cxi) {
                    CodeBlock &cb = B.blocks[(size_t)cy * B.ncbx + cxi];
                    int gx = B.cb0x + cxi, gy = B.cb0y + cy;
                    cb.x0 = gx << B.cbxexp;
                    cb.y0 = gy << B.cbyexp;
                    cb.x1 = cb.x0 + (1 << B.cbxexp);
                    cb.y1 = cb.y0 + (1 << B.cbyexp);
                    if (cb.x0 < B.x0) cb.x0 = B.x0;
                    if (cb.y0 < B.y0) cb.y0 = B.y0;
                    if (cb.x1 > B.x1) cb.x1 = B.x1;
                    if (cb.y1 > B.y1) cb.y1 = B.y1;
                }
            // precincts mapped onto this band: band precinct size is the
            // resolution precinct halved (r>0), i.e. ppx_b/ppy_b
            B.precincts.resize((size_t)R.npx * R.npy);
            for (int py = 0; py < R.npy; ++py)
                for (int px = 0; px < R.npx; ++px) {
                    Precinct &P = B.precincts[(size_t)py * R.npx + px];
                    // precinct (px,py) covers band coords
                    int bpx0 = ((R.x0 >> R.ppx) + px) << ppx_b;
                    int bpy0 = ((R.y0 >> R.ppy) + py) << ppy_b;
                    int bpx1 = bpx0 + (1 << ppx_b);
                    int bpy1 = bpy0 + (1 << ppy_b);
                    int cx0 = bpx0 >> B.cbxexp, cx1 = (int)ceil_div(bpx1, 1LL << B.cbxexp);
                    int cy0 = bpy0 >> B.cbyexp, cy1 = (int)ceil_div(bpy1, 1LL << B.cbyexp);
                    if (cx0 < B.cb0x) cx0 = B.cb0x;
                    if (cy0 < B.cb0y) cy0 = B.cb0y;
                    if (cx1 > B.cb0x + B.ncbx) cx1 = B.cb0x + B.ncbx;
                    if (cy1 > B.cb0y + B.ncby) cy1 = B.cb0y + B.ncby;
                    P.cbx0 = cx0;
                    P.cby0 = cy0;
                    P.cbx1 = cx1 > cx0 ? cx1 : cx0;
                    P.cby1 = cy1 > cy0 ? cy1 : cy0;
                    int pw = P.cbx1 - P.cbx0, ph = P.cby1 - P.cby0;
                    if (pw > 0 && ph > 0) {
                        P.incl.init(pw, ph);
                        P.zbp.init(pw, ph);
                    }
                }
        }
    }
}

}  // namespace

namespace {

// ===========================================================================
// packet decoding (T.800 B.9/B.10)
// ===========================================================================
inline int floor_log2(int v) {
    int n = 0;
    while (v > 1) { v >>= 1; ++n; }
    return n;
}

int decode_npasses(HdrReader &r) {
    if (!r.bit()) return 1;
    if (!r.bit()) return 2;
    long v = r.bits(2);
    if (v < 0) return -1;
    if (v < 3) return 3 + (int)v;
    v = r.bits(5);
    if (v < 0) return -1;
    if (v < 31) return 6 + (int)v;
    v = r.bits(7);
    if (v < 0) return -1;
    return 37 + (int)v;
}

struct BodyChunk {
    CodeBlock *cb;
    int len;
    int npasses;
};

// decode one packet at data[pos...]; advances pos. layer is 0-based.
int decode_packet(const uint8_t *data, size_t len, size_t &pos,
                  const CodingParams &cp, Resolution &R, int precinct,
                  int layer) {
    if (cp.sop) {
        // optional SOP marker segment (6 bytes)
        if (pos + 6 <= len && data[pos] == 0xFF && data[pos + 1] == 0x91)
            pos += 6;
    }
    HdrReader hr{data + pos, len - pos};
    std::vector<BodyChunk> chunks;
    int nonempty = hr.bit();
    if (nonempty < 0) return 3;
    if (nonempty) {
        for (int bi = 0; bi < R.nbands; ++bi) {
            Subband &B = R.bands[bi];
            if (B.ncbx == 0 || (int)B.precincts.size() <= precinct) continue;
            Precinct &P = B.precincts[precinct];
            int pw = P.cbx1 - P.cbx0, ph = P.cby1 - P.cby0;
            if (pw <= 0 || ph <= 0) continue;
            for (int cy = P.cby0; cy < P.cby1; ++cy)
                for (int cxi = P.cbx0; cxi < P.cbx1; ++cxi) {
                    CodeBlock &cb =
                        B.blocks[(size_t)(cy - B.cb0y) * B.ncbx + (cxi - B.cb0x)];
                    int leaf = (cy - P.cby0) * pw + (cxi - P.cbx0);
                    int included;
                    if (!cb.seen) {
                        included = P.incl.decode(hr, leaf, layer + 1);
                        if (included < 0) return 3;
                    } else {
                        included = hr.bit();
                        if (included < 0) return 3;
                    }
                    if (!included) continue;
                    if (!cb.seen) {
                        int t = 1;
                        while (true) {
                            int got = P.zbp.decode(hr, leaf, t);
                            if (got < 0) return 3;
                            if (got == 1) break;
                            ++t;
                        }
                        cb.zbp = t - 1;
                        cb.lblock = 3;
                        cb.seen = true;
                    }
                    int np = decode_npasses(hr);
                    if (np < 0) return 3;
                    // Lblock signalling: 1-bits increment, 0 terminates
                    while (true) {
                        int b = hr.bit();
                        if (b < 0) return 3;
                        if (!b) break;
                        ++cb.lblock;
                    }
                    int nlen = cb.lblock + floor_log2(np);
                    long seg = hr.bits(nlen);
                    if (seg < 0) return 3;
                    chunks.push_back({&cb, (int)seg, np});
                }
        }
    }
    hr.align();
    pos += hr.pos;
    if (cp.eph) {
        if (pos + 2 <= len && data[pos] == 0xFF && data[pos + 1] == 0x92)
            pos += 2;
    }
    for (auto &ch : chunks) {
        if (pos + (size_t)ch.len > len) return 3;
        ch.cb->data.insert(ch.cb->data.end(), data + pos, data + pos + ch.len);
        ch.cb->npasses += ch.npasses;
        pos += ch.len;
    }
    return 0;
}

// iterate all packets per the progression order (single component)
int decode_packets(const uint8_t *data, size_t len, const CodingParams &cp,
                   std::vector<Resolution> &res) {
    size_t pos = 0;
    int NL = cp.levels;
    auto one = [&](int l, int r, int p) -> int {
        if (res[r].npx * res[r].npy <= p) return 0;
        return decode_packet(data, len, pos, cp, res[r], p, l);
    };
    int rc = 0;
    int prog = cp.progression;
    bool single_precinct = true;
    for (int r = 0; r <= NL; ++r)
        if (res[r].npx * res[r].npy > 1) single_precinct = false;
    if ((prog == 3 || prog == 4) && single_precinct) prog = 2;  // ≡ RPCL
    if (prog == 0) {  // LRCP
        for (int l = 0; l < cp.layers; ++l)
            for (int r = 0; r <= NL; ++r)
                for (int p = 0; p < res[r].npx * res[r].npy; ++p)
                    if ((rc = one(l, r, p))) return rc;
    } else if (prog == 1) {  // RLCP
        for (int r = 0; r <= NL; ++r)
            for (int l = 0; l < cp.layers; ++l)
                for (int p = 0; p < res[r].npx * res[r].npy; ++p)
                    if ((rc = one(l, r, p))) return rc;
    } else if (prog == 2) {  // RPCL
        for (int r = 0; r <= NL; ++r)
            for (int p = 0; p < res[r].npx * res[r].npy; ++p)
                for (int l = 0; l < cp.layers; ++l)
                    if ((rc = one(l, r, p))) return rc;
    } else {
        return 2;  // PCRL/CPRL with real precinct grids: unsupported
    }
    return 0;
}

// ===========================================================================
// decode entry
// ===========================================================================
struct MarkerReader {
    const uint8_t *d;
    size_t len, pos = 0;
    int u8() { return pos < len ? d[pos++] : -1; }
    long u16() {
        if (pos + 2 > len) return -1;
        long v = ((long)d[pos] << 8) | d[pos + 1];
        pos += 2;
        return v;
    }
    long u32() {
        long hi = u16(), lo = u16();
        return hi < 0 || lo < 0 ? -1 : (hi << 16) | lo;
    }
};

int j2k_decode_impl(const uint8_t *data, size_t len, int32_t *out,
                    int64_t cap, int *rows, int *cols, int *prec, int *sgnd) {
    // JP2 container: scan boxes for the jp2c codestream
    if (len > 16 && data[0] == 0 && data[1] == 0 && data[2] == 0 &&
        data[3] == 0x0C && !std::memcmp(data + 4, "jP  ", 4)) {
        size_t p = 0;
        while (p + 8 <= len) {
            uint64_t blen = ((uint64_t)data[p] << 24) | (data[p + 1] << 16) |
                            (data[p + 2] << 8) | data[p + 3];
            const uint8_t *btype = data + p + 4;
            size_t hdr = 8;
            if (blen == 1 && p + 16 <= len) {
                blen = 0;
                for (int i = 0; i < 8; ++i) blen = (blen << 8) | data[p + 8 + i];
                hdr = 16;
            } else if (blen == 0) {
                blen = len - p;
            }
            if (!std::memcmp(btype, "jp2c", 4)) {
                data += p + hdr;
                len = blen >= hdr ? blen - hdr : len - (p + hdr);
                break;
            }
            if (blen < hdr) return 1;
            p += blen;
        }
    }
    MarkerReader mr{data, len};
    if (mr.u16() != 0xFF4F) return 1;  // SOC
    CodingParams cp;
    std::vector<uint8_t> tiledata;
    bool have_siz = false, have_cod = false, have_qcd = false;
    while (true) {
        long marker = mr.u16();
        if (marker < 0) break;
        if (marker == 0xFFD9) break;  // EOC
        if (marker == 0xFF93) return 1;  // SOD outside tile-part flow
        if (marker == 0xFF90) {  // SOT
            long lsot = mr.u16();
            long isot = mr.u16();
            long psot = mr.u32();
            mr.u8();  // TPsot
            mr.u8();  // TNsot
            (void)lsot;
            if (isot != 0) return 2;  // single-tile only
            size_t tp_start = mr.pos - 12;  // SOT marker start
            // skip tile-part header markers until SOD
            while (true) {
                long m2 = mr.u16();
                if (m2 < 0) return 1;
                if (m2 == 0xFF93) break;  // SOD
                long l2 = mr.u16();
                if (l2 < 2) return 1;
                mr.pos += l2 - 2;
            }
            size_t data_start = mr.pos;
            size_t data_end;
            if (psot > 0) data_end = tp_start + (size_t)psot;
            else {
                // till EOC
                data_end = len >= 2 ? len - 2 : len;
            }
            if (data_end > len || data_end < data_start) return 1;
            tiledata.insert(tiledata.end(), data + data_start, data + data_end);
            mr.pos = data_end;
            continue;
        }
        long seglen = mr.u16();
        if (seglen < 2 || mr.pos + seglen - 2 > len) return 1;
        size_t seg_end = mr.pos + seglen - 2;
        if (marker == 0xFF51) {  // SIZ
            mr.u16();  // Rsiz
            long xsiz = mr.u32(), ysiz = mr.u32();
            long xo = mr.u32(), yo = mr.u32();
            long xt = mr.u32(), yt = mr.u32();
            long xto = mr.u32(), yto = mr.u32();
            long csiz = mr.u16();
            if (csiz != 1) return 2;
            int ssiz = mr.u8();
            int xr = mr.u8(), yr = mr.u8();
            if (xr != 1 || yr != 1) return 2;
            cp.sgnd = (ssiz & 0x80) != 0;
            cp.prec = (ssiz & 0x7F) + 1;
            cp.x0 = (int)xo;
            cp.y0 = (int)yo;
            cp.w = (int)(xsiz - xo);
            cp.h = (int)(ysiz - yo);
            // single tile covering the image
            if (xto > xo || yto > yo) return 2;
            if ((long)xto + xt < xsiz || (long)yto + yt < ysiz) return 2;
            have_siz = true;
        } else if (marker == 0xFF52) {  // COD
            int scod = mr.u8();
            cp.sop = scod & 2;
            cp.eph = scod & 4;
            cp.progression = mr.u8();
            cp.layers = (int)mr.u16();
            int mct = mr.u8();
            (void)mct;
            cp.levels = mr.u8();
            cp.cbw_exp = mr.u8() + 2;
            cp.cbh_exp = mr.u8() + 2;
            cp.mode = mr.u8();
            cp.transform = mr.u8() == 1 ? 1 : 0;
            if (scod & 1) {
                cp.prec_exps.clear();
                while (mr.pos < seg_end) cp.prec_exps.push_back(mr.u8());
            }
            if (cp.mode != 0) return 2;       // mode switches unsupported
            if (cp.transform != 1) return 5;  // 9/7 irreversible unsupported
            have_cod = true;
        } else if (marker == 0xFF5C) {  // QCD
            int sqcd = mr.u8();
            cp.guard_bits = (sqcd >> 5) & 7;
            int style = sqcd & 0x1F;
            cp.qcd_exps.clear();
            if (style == 0) {
                while (mr.pos < seg_end) cp.qcd_exps.push_back(mr.u8() >> 3);
            } else if (style == 1) {
                long v = mr.u16();
                cp.qcd_exps.push_back((int)(v >> 11));  // derived
                cp.qcd_exps.resize(1);
            } else {
                while (mr.pos + 1 < seg_end)
                    cp.qcd_exps.push_back((int)(mr.u16() >> 11));
            }
            have_qcd = true;
        }
        // COC/QCC for a single component would override; rare — skipped
        mr.pos = seg_end;
    }
    if (!have_siz || !have_cod || !have_qcd) return 1;
    if ((int64_t)cp.w * cp.h > cap) return 4;

    std::vector<Resolution> res;
    build_geometry(cp, res);
    int rc = decode_packets(tiledata.data(), tiledata.size(), cp, res);
    if (rc) return rc;

    int NL = cp.levels;
    // Mb per subband: guard + eps - 1 (E.1); exponent list order: LL, then
    // (HL,LH,HH) per resolution coarse→fine
    auto mb_for = [&](int r, int bi) -> int {
        int idx;
        if (r == 0) idx = 0;
        else idx = 3 * (r - 1) + bi + 1;
        int eps;
        if ((int)cp.qcd_exps.size() > idx) eps = cp.qcd_exps[idx];
        else if (!cp.qcd_exps.empty()) {
            // derived: eps_b = eps_0 - NL + lev
            int lev = (r == 0) ? NL : NL - r + 1;
            eps = cp.qcd_exps[0] - NL + lev;
        } else {
            eps = cp.prec + band_gain(r == 0 ? 0 : bi + 1);
        }
        return cp.guard_bits + eps - 1;
    };

    // tier-1 decode every code-block into its subband plane
    std::vector<std::vector<int32_t>> planes(NL + 1);  // per res: band coeffs
    // allocate per-subband coefficient arrays
    std::vector<std::vector<int32_t>> sbvals;  // indexed res*3+bi
    sbvals.resize((size_t)(NL + 1) * 3);
    for (int r = 0; r <= NL; ++r)
        for (int bi = 0; bi < res[r].nbands; ++bi) {
            Subband &B = res[r].bands[bi];
            sbvals[(size_t)r * 3 + bi].assign((size_t)B.width() * B.height(), 0);
            int mb = mb_for(r, bi);
            T1Block t1;
            for (auto &cb : B.blocks) {
                int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
                if (cw <= 0 || ch <= 0 || cb.npasses == 0) continue;
                t1.init(cw, ch, B.band);
                int numbps = mb - cb.zbp;
                if (numbps < 0) return 3;
                if (numbps > 31) return 3;
                if (t1.decode_passes(cb.data.data(), cb.data.size(), numbps,
                                     cb.npasses))
                    return 3;
                auto &dst = sbvals[(size_t)r * 3 + bi];
                for (int y = 0; y < ch; ++y)
                    for (int x = 0; x < cw; ++x) {
                        int32_t m = t1.mag[(size_t)y * cw + x];
                        if (!m) continue;
                        int32_t v = t1.sgn[(size_t)y * cw + x] ? -m : m;
                        dst[(size_t)(cb.y0 - B.y0 + y) * B.width() +
                            (cb.x0 - B.x0 + x)] = v;
                    }
            }
        }

    // inverse DWT: LL(r=0) then combine up
    std::vector<int32_t> cur = sbvals[0];  // r=0 LL
    int cx0 = res[0].x0, cy0 = res[0].y0, cx1 = res[0].x1, cy1 = res[0].y1;
    for (int r = 1; r <= NL; ++r) {
        int u0 = res[r].x0, u1 = res[r].x1, v0 = res[r].y0, v1 = res[r].y1;
        int W = u1 - u0, H = v1 - v0;
        std::vector<int32_t> Y((size_t)W * H, 0);
        // interleave: sample (u,v): band from parities, sb coords (u>>1,v>>1)
        for (int v = v0; v < v1; ++v)
            for (int u = u0; u < u1; ++u) {
                int xe = u & 1, ye = v & 1;
                int sx = u >> 1, sy = v >> 1;
                int32_t val;
                if (!xe && !ye) {
                    val = cur[(size_t)(sy - cy0) * (cx1 - cx0) + (sx - cx0)];
                } else {
                    int bi = xe && !ye ? 0 : (!xe && ye ? 1 : 2);  // HL,LH,HH
                    Subband &B = res[r].bands[bi];
                    if (sx < B.x0 || sx >= B.x1 || sy < B.y0 || sy >= B.y1)
                        val = 0;
                    else
                        val = sbvals[(size_t)r * 3 + bi]
                                    [(size_t)(sy - B.y0) * B.width() + (sx - B.x0)];
                }
                Y[(size_t)(v - v0) * W + (u - u0)] = val;
            }
        // horizontal synthesis on each row, then vertical on each column
        for (int v = 0; v < H; ++v) sr_1d_53(&Y[(size_t)v * W], u0, u1);
        std::vector<int32_t> col(H);
        for (int u = 0; u < W; ++u) {
            for (int v = 0; v < H; ++v) col[v] = Y[(size_t)v * W + u];
            sr_1d_53(col.data(), v0, v1);
            for (int v = 0; v < H; ++v) Y[(size_t)v * W + u] = col[v];
        }
        cur.swap(Y);
        cx0 = u0;
        cx1 = u1;
        cy0 = v0;
        cy1 = v1;
    }

    // DC level shift for unsigned data
    int64_t off = cp.sgnd ? 0 : (1LL << (cp.prec - 1));
    for (int64_t i = 0; i < (int64_t)cp.w * cp.h; ++i)
        out[i] = (int32_t)(cur[i] + off);
    *rows = cp.h;
    *cols = cp.w;
    *prec = cp.prec;
    *sgnd = cp.sgnd ? 1 : 0;
    return 0;
}

}  // namespace

namespace {

// ===========================================================================
// encoder (lossless 5/3, single tile/layer, LRCP, full precincts)
// ===========================================================================
struct EncBlock {
    std::vector<uint8_t> bytes;
    int npasses = 0;
    int numbps = 0;
};

void push_u16(std::vector<uint8_t> &o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}
void push_u32(std::vector<uint8_t> &o, uint32_t v) {
    o.push_back((uint8_t)(v >> 24));
    o.push_back((uint8_t)(v >> 16));
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

int j2k_encode_impl(const int32_t *img, int rows, int cols, int prec,
                    int sgnd, uint8_t *out, int64_t cap, int64_t *out_len) {
    if (rows <= 0 || cols <= 0 || prec < 1 || prec > 16) return 1;
    CodingParams cp;
    cp.w = cols;
    cp.h = rows;
    cp.prec = prec;
    cp.sgnd = sgnd != 0;
    int mindim = rows < cols ? rows : cols;
    cp.levels = 0;
    while (cp.levels < 5 && (1 << (cp.levels + 1)) <= mindim) ++cp.levels;
    cp.layers = 1;
    cp.guard_bits = 2;

    // DC shift into signed range, forward DWT in place on a working copy
    std::vector<int32_t> cur((size_t)rows * cols);
    int64_t off = cp.sgnd ? 0 : (1LL << (prec - 1));
    for (int64_t i = 0; i < (int64_t)rows * cols; ++i)
        cur[i] = (int32_t)(img[i] - off);

    std::vector<Resolution> res;
    build_geometry(cp, res);
    int NL = cp.levels;
    std::vector<std::vector<int32_t>> sbvals((size_t)(NL + 1) * 3);

    // forward transform: at each level, columns then rows, then deinterleave
    int cw = cols, chh = rows;
    for (int r = NL; r >= 1; --r) {
        int u0 = res[r].x0, u1 = res[r].x1, v0 = res[r].y0, v1 = res[r].y1;
        int W = u1 - u0, H = v1 - v0;
        (void)cw;
        (void)chh;
        std::vector<int32_t> col(H);
        for (int u = 0; u < W; ++u) {
            for (int v = 0; v < H; ++v) col[v] = cur[(size_t)v * W + u];
            sd_1d_53(col.data(), v0, v1);
            for (int v = 0; v < H; ++v) cur[(size_t)v * W + u] = col[v];
        }
        for (int v = 0; v < H; ++v) sd_1d_53(&cur[(size_t)v * W], u0, u1);
        // deinterleave into next LL + this resolution's HL/LH/HH
        int nx0 = res[r - 1].x0, nx1 = res[r - 1].x1;
        int ny0 = res[r - 1].y0, ny1 = res[r - 1].y1;
        std::vector<int32_t> ll((size_t)(nx1 - nx0) * (ny1 - ny0), 0);
        for (int bi = 0; bi < 3; ++bi) {
            Subband &B = res[r].bands[bi];
            sbvals[(size_t)r * 3 + bi].assign((size_t)B.width() * B.height(), 0);
        }
        for (int v = v0; v < v1; ++v)
            for (int u = u0; u < u1; ++u) {
                int32_t val = cur[(size_t)(v - v0) * W + (u - u0)];
                int xe = u & 1, ye = v & 1;
                int sx = u >> 1, sy = v >> 1;
                if (!xe && !ye)
                    ll[(size_t)(sy - ny0) * (nx1 - nx0) + (sx - nx0)] = val;
                else {
                    int bi = xe && !ye ? 0 : (!xe && ye ? 1 : 2);
                    Subband &B = res[r].bands[bi];
                    sbvals[(size_t)r * 3 + bi]
                          [(size_t)(sy - B.y0) * B.width() + (sx - B.x0)] = val;
                }
            }
        cur.swap(ll);
    }
    sbvals[0] = cur;  // r=0 LL

    // tier-1 encode each code-block
    std::vector<std::vector<EncBlock>> enc((size_t)(NL + 1) * 3);
    T1Block t1;
    for (int r = 0; r <= NL; ++r)
        for (int bi = 0; bi < res[r].nbands; ++bi) {
            Subband &B = res[r].bands[bi];
            auto &src = sbvals[(size_t)r * 3 + bi];
            auto &eb = enc[(size_t)r * 3 + bi];
            eb.resize(B.blocks.size());
            for (size_t k = 0; k < B.blocks.size(); ++k) {
                CodeBlock &cb = B.blocks[k];
                int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
                if (w <= 0 || h <= 0) continue;
                t1.init(w, h, B.band);
                for (int y = 0; y < h; ++y)
                    for (int x = 0; x < w; ++x) {
                        int32_t v = src[(size_t)(cb.y0 - B.y0 + y) * B.width() +
                                        (cb.x0 - B.x0 + x)];
                        t1.mag[(size_t)y * w + x] = v < 0 ? -v : v;
                        t1.sgn[(size_t)y * w + x] = v < 0;
                    }
                t1.encode_all(eb[k].bytes, eb[k].npasses, eb[k].numbps);
            }
        }

    // assemble: main header
    std::vector<uint8_t> o;
    push_u16(o, 0xFF4F);  // SOC
    push_u16(o, 0xFF51);  // SIZ
    push_u16(o, 41);
    push_u16(o, 0);                      // Rsiz
    push_u32(o, (uint32_t)cols);         // Xsiz
    push_u32(o, (uint32_t)rows);
    push_u32(o, 0);                      // XOsiz
    push_u32(o, 0);
    push_u32(o, (uint32_t)cols);         // XTsiz
    push_u32(o, (uint32_t)rows);
    push_u32(o, 0);
    push_u32(o, 0);
    push_u16(o, 1);                      // Csiz
    o.push_back((uint8_t)((prec - 1) | (sgnd ? 0x80 : 0)));
    o.push_back(1);                      // XRsiz
    o.push_back(1);
    push_u16(o, 0xFF52);  // COD
    push_u16(o, 12);
    o.push_back(0);       // Scod: default precincts, no SOP/EPH
    o.push_back(0);       // LRCP
    push_u16(o, 1);       // layers
    o.push_back(0);       // no MCT
    o.push_back((uint8_t)NL);
    o.push_back(6 - 2);   // 64-wide code-blocks
    o.push_back(6 - 2);
    o.push_back(0);       // no mode switches
    o.push_back(1);       // 5/3 reversible
    push_u16(o, 0xFF5C);  // QCD
    int nsb = 3 * NL + 1;
    push_u16(o, 3 + nsb);
    o.push_back((uint8_t)(cp.guard_bits << 5));  // style 0 (reversible)
    std::vector<int> exps(nsb);
    exps[0] = prec + band_gain(0);
    for (int r = 1; r <= NL; ++r)
        for (int bi = 0; bi < 3; ++bi)
            exps[3 * (r - 1) + bi + 1] = prec + band_gain(bi + 1);
    for (int e : exps) o.push_back((uint8_t)(e << 3));
    cp.qcd_exps = exps;

    // tile body: one packet per resolution (single layer, full precincts)
    std::vector<uint8_t> body;
    for (int r = 0; r <= NL; ++r) {
        Resolution &R = res[r];
        HdrWriter hw;
        std::vector<const EncBlock *> order;
        bool any = false;
        for (int bi = 0; bi < R.nbands; ++bi) {
            auto &eb = enc[(size_t)r * 3 + bi];
            for (auto &b : eb)
                if (b.npasses > 0) any = true;
        }
        hw.bit(any ? 1 : 0);
        if (any) {
            for (int bi = 0; bi < R.nbands; ++bi) {
                Subband &B = res[r].bands[bi];
                if (B.ncbx == 0 || B.precincts.empty()) continue;
                Precinct &P = B.precincts[0];
                int pw = P.cbx1 - P.cbx0, ph = P.cby1 - P.cby0;
                if (pw <= 0 || ph <= 0) continue;
                auto &eb = enc[(size_t)r * 3 + bi];
                int mb = cp.guard_bits + cp.qcd_exps[r == 0 ? 0 : 3 * (r - 1) + bi + 1] - 1;
                // tag-tree leaf values
                std::vector<int> incl_v((size_t)pw * ph, 1);  // 1 = never
                std::vector<int> zbp_v((size_t)pw * ph, 0);
                for (int cy = P.cby0; cy < P.cby1; ++cy)
                    for (int cxi = P.cbx0; cxi < P.cbx1; ++cxi) {
                        size_t k = (size_t)(cy - B.cb0y) * B.ncbx + (cxi - B.cb0x);
                        size_t leaf = (size_t)(cy - P.cby0) * pw + (cxi - P.cbx0);
                        if (eb[k].npasses > 0) {
                            incl_v[leaf] = 0;
                            zbp_v[leaf] = mb - eb[k].numbps;
                        } else {
                            zbp_v[leaf] = 0;  // unused
                        }
                    }
                P.incl.reset();
                P.incl.set_leaf_values(incl_v);
                P.zbp.reset();
                P.zbp.set_leaf_values(zbp_v);
                for (int cy = P.cby0; cy < P.cby1; ++cy)
                    for (int cxi = P.cbx0; cxi < P.cbx1; ++cxi) {
                        size_t k = (size_t)(cy - B.cb0y) * B.ncbx + (cxi - B.cb0x);
                        int leaf = (cy - P.cby0) * pw + (cxi - P.cbx0);
                        P.incl.encode(hw, leaf, 1);
                        if (eb[k].npasses == 0) continue;
                        // zero bit-planes: thresholds until determined
                        int t = 1;
                        while (true) {
                            P.zbp.encode(hw, leaf, t);
                            if (P.zbp.known[leaf] && P.zbp.value[leaf] < t) break;
                            ++t;
                        }
                        // npasses (B.10.6)
                        int np = eb[k].npasses;
                        if (np == 1) hw.bit(0);
                        else if (np == 2) { hw.bit(1); hw.bit(0); }
                        else if (np <= 5) {
                            hw.bits(3, 2);
                            hw.bits((uint32_t)(np - 3), 2);
                        } else if (np <= 36) {
                            hw.bits(0xF, 4);
                            hw.bits((uint32_t)(np - 6), 5);
                        } else {
                            hw.bits(0x1FF, 9);
                            hw.bits((uint32_t)(np - 37), 7);
                        }
                        // length: raise lblock until it fits
                        int lblock = 3;
                        int lg = floor_log2(np);
                        int need = 1;
                        while ((size_t)(1u << (lblock + lg)) <= eb[k].bytes.size())
                            ++lblock, ++need;
                        for (int i = 1; i < need; ++i) hw.bit(1);
                        hw.bit(0);
                        hw.bits((uint32_t)eb[k].bytes.size(), lblock + lg);
                        order.push_back(&eb[k]);
                    }
            }
        }
        hw.align();
        body.insert(body.end(), hw.out.begin(), hw.out.end());
        for (auto *b : order)
            body.insert(body.end(), b->bytes.begin(), b->bytes.end());
    }

    // SOT + SOD + body + EOC
    push_u16(o, 0xFF90);
    push_u16(o, 10);
    push_u16(o, 0);                              // Isot
    push_u32(o, (uint32_t)(12 + 2 + body.size()));  // Psot
    o.push_back(0);                              // TPsot
    o.push_back(1);                              // TNsot
    push_u16(o, 0xFF93);                         // SOD
    o.insert(o.end(), body.begin(), body.end());
    push_u16(o, 0xFFD9);                         // EOC

    if ((int64_t)o.size() > cap) return 4;
    std::memcpy(out, o.data(), o.size());
    *out_len = (int64_t)o.size();
    return 0;
}

}  // namespace

extern "C" {

int j2k_decode(const uint8_t *data, int64_t len, int32_t *out, int64_t cap,
               int *rows, int *cols, int *prec, int *sgnd) {
    return j2k_decode_impl(data, (size_t)len, out, cap, rows, cols, prec, sgnd);
}

int j2k_encode(const int32_t *img, int rows, int cols, int prec, int sgnd,
               uint8_t *out, int64_t cap, int64_t *out_len) {
    return j2k_encode_impl(img, rows, cols, prec, sgnd, out, cap, out_len);
}

}  // extern "C"
