// Low-2004 2D gamma of a (B, H, W) float32 batch, for Hopper (sm_90a).
//
// Replaces pylinac_tpu/ops/pallas_gamma.py:_gamma_kernel (the Pallas TPU
// kernel). Same result, bit for bit against the plain twin
// (pylinac_tpu_torch/ops/gamma2d.py:gamma2d_reference): for each pixel the
// least dist2 + (eval - ref)^2 over the offsets of the skimage disk of radius
// dta + 1, a NaN candidate counting as +inf, that least value capped at
// cap^2 (a NaN cap gives NaN), its square root capped at cap, and `fill`
// where the reference is NaN or below the threshold.
//
// Bound: operations. Each candidate is four float32 instructions (sub, mul,
// add, min), none of which may fuse. At the bench's shape, (16, 768, 1024)
// with dta 9, 305 offsets a pixel make 15.3 G instructions: 0.46 ms at the
// H100's float32 issue rate (132 SMs x 128 lanes x 1.98 GHz), against
// 0.046 ms for the 153 MB of reference, padded evaluation and output at
// 3.35 TB/s.
//
// Design: the loads leave the inner loop. A thread computes kP = 4
// neighbouring pixels of one row; a block of 32 x 8 threads covers 128 x 8
// pixels and stages its padded evaluation tile, the dist2 table and the
// table's row index in shared memory. The disk is walked row by row (dy),
// each row in blocks of kP offsets (dx): for one block a thread loads four
// dist2 values (one float4, the same address in every lane: a broadcast)
// and four new evaluation values (one float4; the lanes read 512
// consecutive bytes, no bank conflict), which with the four of the block
// before form an 8-value register window; each of the 16 candidates of the
// block is then the four float32 instructions on registers alone. A row's
// blocks start at a multiple of kP columns, so that the float4 loads are
// aligned; the table pads each row to whole blocks with dist2 = +inf, whose
// candidates (+inf, or NaN, which fminf drops) never win. At dta 9 that is
// 348 candidates for the disk's 305.
//
// The table (pylinac_tpu_torch/ops/gamma2d.py:row_table) holds each row as
// (dy, first column c0, blocks nb, offset into dist2), and its dist2 values
// are offset_table(dta)'s bit for bit: the host computes them once in
// float64 and rounds to float32, as JAX rounds that Python double. The
// order of the candidates changes nothing: every candidate is >= +0 or
// NaN, and fminf drops NaN. There is no dta cap. The tile takes dynamic
// shared memory up to the card's opt-in limit (dta <= 70 on the H100);
// past it the same loop reads the padded evaluation and the table from
// device memory (through __ldg, the columns clamped into the row).
//
// Exactness: every operation rounds on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, __fsqrt_rn), so nvcc cannot contract dist2 + dd * dd into one
// fused multiply-add, which the twin would not do. fminf drops a NaN
// operand: over the candidates that is exactly "NaN counts as +inf", since
// the running minimum starts at +inf and is never NaN. The cap is applied
// after the loop with a minimum that propagates NaN, as jnp.minimum and
// torch.minimum do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kP = 4;                  // pixels per thread, along x
constexpr int kTileX = 32;             // threads along x
constexpr int kTileY = 8;              // threads (and pixel rows) along y
constexpr int kPixX = kTileX * kP;     // pixels of a block along x

__host__ __device__ inline int tile_width(int dta) {
  // the rightmost window of a row ends kP columns past the disk's edge
  return (kPixX + 2 * dta + kP + 3) / 4 * 4;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

// kP evaluation values of one row from column `col` on: an aligned float4
// from the shared tile, or clamped scalar loads from device memory
template <bool kShared>
__device__ __forceinline__ float4 window(const float* row, int col, int last) {
  if (kShared) return *reinterpret_cast<const float4*>(row + col);
  return make_float4(__ldg(row + min(col, last)), __ldg(row + min(col + 1, last)),
                     __ldg(row + min(col + 2, last)), __ldg(row + min(col + 3, last)));
}

template <bool kShared>
__global__ void __launch_bounds__(kTileX * kTileY)
gamma2d_kernel(const float* __restrict__ ref, const float* __restrict__ evalp,
               const int4* __restrict__ rows, const float* __restrict__ dist2,
               float* __restrict__ out, int n_rows, int n_dist2, int height, int width,
               int dta, float cap, float threshold, float fill) {
  extern __shared__ float4 smem[];

  const int hp = height + 2 * dta;
  const int wp = width + 2 * dta;
  const size_t b = blockIdx.z;
  const float* src = evalp + b * hp * wp;
  const int x_base = blockIdx.x * kPixX;  // padded column of tile column 0
  const int y0 = blockIdx.y * kTileY;     // padded row of tile row 0
  const int tw = tile_width(dta);

  const float* tile = reinterpret_cast<const float*>(smem);
  const float* table = dist2;
  const int4* index = rows;
  if (kShared) {
    const int th = kTileY + 2 * dta;
    float* t = reinterpret_cast<float*>(smem);
    float* d = t + th * tw;
    int4* r = reinterpret_cast<int4*>(d + n_dist2);
    const int tid = threadIdx.y * kTileX + threadIdx.x;
    for (int ty = threadIdx.y; ty < th; ty += kTileY) {
      const int gy = y0 + ty;
      for (int tx = threadIdx.x; tx < tw; tx += kTileX) {
        const int gx = x_base + tx;
        // columns past the padded image meet only dist2 = +inf
        t[ty * tw + tx] = gy < hp && gx < wp ? src[static_cast<size_t>(gy) * wp + gx] : 0.0f;
      }
    }
    for (int i = tid; i < n_dist2; i += kTileX * kTileY) d[i] = dist2[i];
    for (int i = tid; i < n_rows; i += kTileX * kTileY) r[i] = rows[i];
    __syncthreads();
    table = d;
    index = r;
  }

  const int x0 = x_base + threadIdx.x * kP;
  const int y = y0 + threadIdx.y;
  if (x0 >= width || y >= height) return;

  const size_t pixel0 = (b * height + y) * width + x0;
  float r[kP], least[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    r[p] = x0 + p < width ? ref[pixel0 + p] : 0.0f;
    least[p] = INFINITY;
  }
  // pixel p at offset (dy, dx) reads padded row y + dta + dy, column
  // x0 + p + dta + dx; `col` below counts columns from x0 (tile column
  // threadIdx.x * kP in the shared tile)
  const float* origin = kShared ? tile + threadIdx.x * kP
                                : src + static_cast<size_t>(y) * wp + x0;
  const int row_stride = kShared ? tw : wp;
  const int last = wp - 1 - x0;  // the last column of the padded row

  for (int k = 0; k < n_rows; ++k) {
    const int4 row = kShared ? index[k] : __ldg(&index[k]);
    const int dy = row.x, c0 = row.y, nb = row.z;
    const float* d2 = table + row.w;
    const int line_row = (kShared ? static_cast<int>(threadIdx.y) : 0) + dta + dy;
    const float* line = origin + static_cast<long long>(line_row) * row_stride;
    float4 lo = window<kShared>(line, c0, last);
#pragma unroll 2
    for (int blk = 0; blk < nb; ++blk) {
      const float4 hi = window<kShared>(line, c0 + (blk + 1) * kP, last);
      const float4 dv = kShared ? *reinterpret_cast<const float4*>(d2 + blk * kP)
                                : __ldg(reinterpret_cast<const float4*>(d2 + blk * kP));
      const float w[2 * kP] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float dd2[kP] = {dv.x, dv.y, dv.z, dv.w};
      // candidate j of the block is dx = c0 + blk * kP + j - dta: pixel p
      // reads window entry p + j
#pragma unroll
      for (int j = 0; j < kP; ++j) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const float dd = __fsub_rn(w[p + j], r[p]);
          least[p] = fminf(least[p], __fadd_rn(dd2[j], __fmul_rn(dd, dd)));
        }
      }
      lo = hi;
    }
  }

  const float cap2 = __fmul_rn(cap, cap);
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (x0 + p >= width) break;
    const float gamma = min_nan(__fsqrt_rn(min_nan(cap2, least[p])), cap);
    out[pixel0 + p] = (isnan(r[p]) || r[p] < threshold) ? fill : gamma;
  }
}

}  // namespace

// C entry point, loaded with ctypes. `ref` and `out` are contiguous
// (batch, height, width) float32 device buffers, `evalp` the contiguous
// (batch, height + 2 dta, width + 2 dta) edge-padded evaluation, `rows`
// n_rows int4 (dy, c0, nb, offset) and `dist2` n_dist2 float32 values, both
// from row_table(dta) (offsets and n_dist2 multiples of 4, 16-byte aligned);
// `stream` is a cudaStream_t. Launches on that stream without synchronising
// and returns the CUDA error as an int (0 on success).
extern "C" int gamma2d_f32(const void* ref, const void* evalp, const void* rows,
                           const void* dist2, void* out, int n_rows, int n_dist2, int batch,
                           int height, int width, int dta, float cap, float threshold,
                           float fill, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((width + kPixX - 1) / kPixX, (height + kTileY - 1) / kTileY, batch);
  const size_t shared = sizeof(float) * (static_cast<size_t>(kTileY + 2 * dta) * tile_width(dta)
                                         + n_dist2)
                        + sizeof(int4) * n_rows;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(ref);
  const auto* e = static_cast<const float*>(evalp);
  const auto* o = static_cast<const int4*>(rows);
  const auto* d = static_cast<const float*>(dist2);
  auto* g = static_cast<float*>(out);
  if (shared <= static_cast<size_t>(optin)) {
    if (shared > 48 * 1024) {
      err = cudaFuncSetAttribute(gamma2d_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gamma2d_kernel<true><<<grid, block, shared, s>>>(
        r, e, o, d, g, n_rows, n_dist2, height, width, dta, cap, threshold, fill);
  } else {
    gamma2d_kernel<false><<<grid, block, 0, s>>>(
        r, e, o, d, g, n_rows, n_dist2, height, width, dta, cap, threshold, fill);
  }
  return static_cast<int>(cudaGetLastError());
}
