// JPEG Lossless (ISO 10918-1 process 14, SOF3) bitstream decoder.
//
// A copy of pylinac_tpu/native/jpeg_lossless.cpp for the PyTorch port.
// Host-side hot loop for compressed clinical DICOM exports (transfer
// syntaxes 1.2.840.10008.1.2.4.57/.70): sequential Huffman + predictor
// reconstruction is bit-serial by nature, so it lives in native code on the
// host. Mirrors the Python decoder in core/compressed_px.py
// (jpeg_lossless_decode) exactly; single grayscale component, predictors
// 1-7, point transform, 8/16-bit precision.
//
// Exported C ABI (ctypes):
//   int jpegll_decode(const uint8_t* data, int64_t n,
//                     uint16_t* out, int64_t out_cap,
//                     int* rows, int* cols, int* precision)
// Returns 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    int64_t n;
    int64_t pos = 0;
    uint32_t acc = 0;
    int nbits = 0;

    void fill() {
        while (nbits <= 24) {
            uint32_t byte = 0;
            if (pos < n) {
                byte = data[pos++];
                if (byte == 0xFF) {
                    uint8_t nxt = pos < n ? data[pos] : 0;
                    if (nxt == 0x00) {
                        pos++;  // stuffed byte
                    } else {
                        pos = n;  // marker: end of entropy data
                        byte = 0;
                    }
                }
            }
            acc = (acc << 8) | byte;
            nbits += 8;
        }
    }
    inline uint32_t peek16() {
        fill();
        return (acc >> (nbits - 16)) & 0xFFFF;
    }
    inline void skip(int k) {
        nbits -= k;
        acc &= (1u << nbits) - 1;
    }
    inline int32_t read(int k) {
        if (k == 0) return 0;
        fill();
        int32_t v = (acc >> (nbits - k)) & ((1u << k) - 1);
        skip(k);
        return v;
    }
};

inline int32_t extend(int32_t v, int ssss) {
    if (ssss == 0) return 0;
    if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
    return v;
}

inline int32_t predict(int32_t ra, int32_t rb, int32_t rc, int psv) {
    switch (psv) {
        case 1: return ra;
        case 2: return rb;
        case 3: return rc;
        case 4: return ra + rb - rc;
        case 5: return ra + ((rb - rc) >> 1);
        case 6: return rb + ((ra - rc) >> 1);
        case 7: return (ra + rb) >> 1;
        default: return ra;
    }
}

}  // namespace

extern "C" int jpegll_decode(const uint8_t* data, int64_t n, uint16_t* out,
                             int64_t out_cap, int* rows_out, int* cols_out,
                             int* prec_out) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
    int64_t pos = 2;
    int precision = 0, rows = 0, cols = 0, ncomp = 0;
    int psv = 1, pt = 0;
    // 16-bit prefix LUT: (length << 8) | value, -1 = invalid
    static thread_local int32_t lut[1 << 16];
    bool have_table = false;

    while (pos + 1 < n) {
        if (data[pos] != 0xFF) { pos++; continue; }
        uint8_t marker = data[pos + 1];
        pos += 2;
        if (marker == 0x01 || marker == 0xD8 ||
            (marker >= 0xD0 && marker <= 0xD7)) continue;
        if (pos + 2 > n) return -2;
        int seglen = (data[pos] << 8) | data[pos + 1];
        if (pos + seglen > n) return -2;
        const uint8_t* seg = data + pos + 2;
        int segn = seglen - 2;
        if (marker == 0xC3) {  // SOF3
            if (segn < 6) return -3;
            precision = seg[0];
            rows = (seg[1] << 8) | seg[2];
            cols = (seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (ncomp != 1) return -4;
        } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
            return -5;  // lossy JPEG
        } else if (marker == 0xC4) {  // DHT (last table wins; 1 component)
            int p = 0;
            while (p < segn) {
                int nvals = 0;
                int bits[17] = {0};
                for (int l = 1; l <= 16; l++) {
                    bits[l] = seg[p + l];
                    nvals += bits[l];
                }
                const uint8_t* values = seg + p + 17;
                for (int64_t i = 0; i < (1 << 16); i++) lut[i] = -1;
                uint32_t code = 0;
                int k = 0;
                for (int length = 1; length <= 16; length++) {
                    for (int c = 0; c < bits[length]; c++) {
                        uint32_t prefix = code << (16 - length);
                        uint32_t span = 1u << (16 - length);
                        int32_t packed = (length << 8) | values[k];
                        for (uint32_t i2 = 0; i2 < span; i2++)
                            lut[prefix + i2] = packed;
                        code++;
                        k++;
                    }
                    code <<= 1;
                }
                have_table = true;
                p += 17 + nvals;
            }
        } else if (marker == 0xDA) {  // SOS
            if (!have_table || rows == 0) return -6;
            int ns = seg[0];
            psv = seg[1 + 2 * ns];
            pt = seg[3 + 2 * ns] & 0x0F;
            if ((int64_t)rows * cols > out_cap) return -7;
            BitReader br{data + pos + seglen, n - pos - seglen};
            int32_t dflt = 1 << (precision - pt - 1);
            for (int r = 0; r < rows; r++) {
                for (int c = 0; c < cols; c++) {
                    int32_t packed = lut[br.peek16()];
                    if (packed < 0) return -8;
                    br.skip(packed >> 8);
                    int ssss = packed & 0xFF;
                    int32_t diff =
                        (ssss == 16) ? 32768 : extend(br.read(ssss), ssss);
                    int32_t pred;
                    if (r == 0 && c == 0) pred = dflt;
                    else if (r == 0) pred = out[c - 1];
                    else if (c == 0) pred = out[(int64_t)(r - 1) * cols];
                    else {
                        int32_t ra = out[(int64_t)r * cols + c - 1];
                        int32_t rb = out[(int64_t)(r - 1) * cols + c];
                        int32_t rc = out[(int64_t)(r - 1) * cols + c - 1];
                        pred = predict(ra, rb, rc, psv);
                    }
                    out[(int64_t)r * cols + c] =
                        (uint16_t)((pred + diff) & 0xFFFF);
                }
            }
            if (pt) {
                int64_t total = (int64_t)rows * cols;
                for (int64_t i = 0; i < total; i++)
                    out[i] = (uint16_t)(out[i] << pt);
            }
            *rows_out = rows;
            *cols_out = cols;
            *prec_out = precision;
            return 0;
        }
        pos += seglen;
    }
    return -9;  // no SOS
}
