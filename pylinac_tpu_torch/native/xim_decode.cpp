// Single-pass Varian .xim diff-decoder.
//
// The XIM compressed payload stores, after (W+1) raw int32 seed values, one
// variable-length signed diff per remaining pixel with the recurrence
//   a[k] = diff[k] + a[k-1] + a[k-W] - a[k-W-1]
// (reference behavior: pylinac core/image.py:1207-1267, re-implemented).
// The numpy path needs several full-array passes (LUT expansion, offset
// cumsum, gather, two cumsums); this decoder emits pixels in one stream pass,
// which matters on weak/1-core QA hosts.
//
// Build: g++ -O3 -shared -fPIC -o libximdecode.so xim_decode.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 on success, -1 if the diff buffer ran short, -2 if the packed
// lookup table is smaller than the diff count requires (truncated file).
// lut: packed 2-bit codes (4 per byte) for the n_diffs diffs.
// buf: (W+1)*4 seed bytes followed by the variable-length diffs.
// out: H*W int32 pixels.
int xim_decode(const uint8_t* buf, int64_t buf_len, const uint8_t* lut,
               int64_t lut_len, int64_t width, int64_t height, int32_t* out) {
    const int64_t n = width * height;
    const int64_t n_seed = width + 1;
    if (buf_len < n_seed * 4) return -1;
    if (lut_len * 4 < n - n_seed) return -2;
    std::memcpy(out, buf, n_seed * 4);  // little-endian int32 seeds

    const uint8_t* p = buf + n_seed * 4;
    const uint8_t* end = buf + buf_len;
    for (int64_t k = n_seed; k < n; ++k) {
        const int64_t d_idx = k - n_seed;
        const unsigned code = (lut[d_idx >> 2] >> ((d_idx & 3) * 2)) & 3u;
        int32_t diff;
        if (code == 0) {
            if (p + 1 > end) return -1;
            diff = static_cast<int8_t>(p[0]);
            p += 1;
        } else if (code == 1) {
            if (p + 2 > end) return -1;
            int16_t v;
            std::memcpy(&v, p, 2);
            diff = v;
            p += 2;
        } else {
            if (p + 4 > end) return -1;
            std::memcpy(&diff, p, 4);
            p += 4;
        }
        out[k] = diff + out[k - 1] + out[k - width] - out[k - width - 1];
    }
    return 0;
}

}  // extern "C"
