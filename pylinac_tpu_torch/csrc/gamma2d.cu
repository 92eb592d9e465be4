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
// Bound: operations. At the bench's shape, (16, 768, 1024) with dta 9, each
// pixel tries 305 offsets at about 6 float32 operations each: 23 GFLOP, a
// floor of 0.344 ms at the H100's 67 TFLOP/s, against 0.046 ms for the
// 153 MB of reference, padded evaluation and output at 3.35 TB/s.
//
// Design: one thread per output pixel in a 32 x 8 block; blockIdx.z runs
// over the batch. The block stages its evaluation tile plus the 2 * dta halo
// in shared memory (at dta 9: 26 x 50 floats), so each padded input byte is
// read from device memory about once and every offset costs one shared
// load. The offsets and their dist2 = (dy^2 + dx^2) / dta^2 come from a
// table that the host computes once in float64 and rounds to float32, as
// JAX rounds that Python double; every thread of a warp reads the same entry,
// so the table loads are broadcasts from L1. There is no dta cap: when the
// tile would not fit in the 48 KB of shared memory a launch gets without
// opting in (dta > 45), the same loop reads the padded evaluation from
// device memory through __ldg.
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

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr size_t kMaxSharedBytes = 48 * 1024;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

template <bool kShared>
__global__ void __launch_bounds__(kTileX * kTileY)
gamma2d_kernel(const float* __restrict__ ref, const float* __restrict__ evalp,
               const int2* __restrict__ offsets, const float* __restrict__ dist2,
               float* __restrict__ out, int n_offsets, int height, int width,
               int dta, float cap, float threshold, float fill) {
  extern __shared__ float tile[];

  const int hp = height + 2 * dta;
  const int wp = width + 2 * dta;
  const size_t b = blockIdx.z;
  const float* src = evalp + b * hp * wp;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tw = kTileX + 2 * dta;

  if (kShared) {
    // padded rows y0 .. y0 + kTileY + 2 dta - 1 and columns x0 .. x0 + tw - 1;
    // entries past the padded image are never read by an in-range pixel
    const int th = kTileY + 2 * dta;
    for (int i = threadIdx.y * kTileX + threadIdx.x; i < th * tw; i += kTileX * kTileY) {
      const int gy = y0 + i / tw;
      const int gx = x0 + i % tw;
      if (gy < hp && gx < wp) tile[i] = src[static_cast<size_t>(gy) * wp + gx];
    }
    __syncthreads();
  }

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= width || y >= height) return;

  const size_t pixel = (b * height + y) * width + x;
  const float r = ref[pixel];
  // eval_p[y + dta + dy][x + dta + dx], in the tile or in device memory
  const float* centre = kShared
      ? tile + (threadIdx.y + dta) * tw + (threadIdx.x + dta)
      : src + static_cast<size_t>(y + dta) * wp + (x + dta);
  const int stride = kShared ? tw : wp;

  float least = INFINITY;
  for (int k = 0; k < n_offsets; ++k) {
    const int2 o = __ldg(&offsets[k]);
    const float* p = centre + static_cast<long long>(o.x) * stride + o.y;
    const float e = kShared ? *p : __ldg(p);
    const float dd = __fsub_rn(e, r);
    least = fminf(least, __fadd_rn(__ldg(&dist2[k]), __fmul_rn(dd, dd)));
  }

  const float g2 = min_nan(__fmul_rn(cap, cap), least);
  const float gamma = min_nan(__fsqrt_rn(g2), cap);
  out[pixel] = (isnan(r) || r < threshold) ? fill : gamma;
}

}  // namespace

// C entry point, loaded with ctypes. `ref` and `out` are contiguous
// (batch, height, width) float32 device buffers, `evalp` the contiguous
// (batch, height + 2 dta, width + 2 dta) edge-padded evaluation, `offsets`
// n_offsets (dy, dx) int pairs and `dist2` their n_offsets float32 distance
// terms; `stream` is a cudaStream_t. Launches on that stream without
// synchronising and returns cudaGetLastError() as an int (0 on success).
extern "C" int gamma2d_f32(const void* ref, const void* evalp, const void* offsets,
                           const void* dist2, void* out, int n_offsets, int batch,
                           int height, int width, int dta, float cap,
                           float threshold, float fill, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY, batch);
  const size_t shared = sizeof(float) * (kTileX + 2 * static_cast<size_t>(dta))
                        * (kTileY + 2 * static_cast<size_t>(dta));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(ref);
  const auto* e = static_cast<const float*>(evalp);
  const auto* o = static_cast<const int2*>(offsets);
  const auto* d = static_cast<const float*>(dist2);
  auto* g = static_cast<float*>(out);
  if (shared <= kMaxSharedBytes) {
    gamma2d_kernel<true><<<grid, block, shared, s>>>(
        r, e, o, d, g, n_offsets, height, width, dta, cap, threshold, fill);
  } else {
    gamma2d_kernel<false><<<grid, block, 0, s>>>(
        r, e, o, d, g, n_offsets, height, width, dta, cap, threshold, fill);
  }
  return static_cast<int>(cudaGetLastError());
}
