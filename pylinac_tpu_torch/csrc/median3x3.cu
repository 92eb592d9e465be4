// 3x3 median filter of a (B, H, W) float32 batch, for Hopper (sm_90a).
//
// Replaces pylinac_tpu/ops/pallas_median.py:_median9_kernel (the Pallas
// TPU kernel). Same result: rank 4 of the 9 neighbours, scipy "reflect"
// edges. For a pad of 1, scipy "reflect" (numpy "symmetric") repeats the
// edge pixel, so clamping the neighbour index is the same padding.
//
// Bound: device memory. Each pixel costs one 4-byte read and one 4-byte
// write (about 8 B per pixel) against 19 min/max pairs, far below the
// card's compute rate. For 64 x 1254 x 1254 that is about 0.8 GB, a floor
// of about 0.24 ms at the H100's 3.35 TB/s.
//
// Design: one thread per output pixel in a 32 x 8 block; blockIdx.z runs
// over the batch. The block first stages its 34 x 10 input tile (1-pixel
// halo, clamped indices) in shared memory, so each input byte is read from
// device memory about once: halo rows and columns shared with a
// neighbouring block come from L2. Every thread then runs the 19-exchange
// median-of-9 network (Paeth) on registers, as the Pallas kernel does.
//
// NaN: fminf/fmaxf return the other operand when one is NaN, so a NaN does
// not propagate as jnp.minimum would, and the sort-based plain version
// orders NaN last. The main path feeds frames widened from uint16, which
// are always finite.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(kTileX * kTileY)
median3x3_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int height, int width) {
  __shared__ float tile[kTileY + 2][kTileX + 2];

  const size_t plane = static_cast<size_t>(height) * width;
  const float* src = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;

  // cooperative halo load: (kTileY + 2) * (kTileX + 2) values, edge-clamped
  for (int i = threadIdx.y * kTileX + threadIdx.x;
       i < (kTileY + 2) * (kTileX + 2); i += kTileX * kTileY) {
    const int ty = i / (kTileX + 2);
    const int tx = i % (kTileX + 2);
    const int gy = min(max(y0 + ty - 1, 0), height - 1);
    const int gx = min(max(x0 + tx - 1, 0), width - 1);
    tile[ty][tx] = src[static_cast<size_t>(gy) * width + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= width || y >= height) return;

  const int r = threadIdx.y;
  const int c = threadIdx.x;
  float p0 = tile[r][c], p1 = tile[r][c + 1], p2 = tile[r][c + 2];
  float p3 = tile[r + 1][c], p4 = tile[r + 1][c + 1], p5 = tile[r + 1][c + 2];
  float p6 = tile[r + 2][c], p7 = tile[r + 2][c + 1], p8 = tile[r + 2][c + 2];

  // 19-exchange median-of-9 network; the median lands in p4
  exchange(p1, p2); exchange(p4, p5); exchange(p7, p8);
  exchange(p0, p1); exchange(p3, p4); exchange(p6, p7);
  exchange(p1, p2); exchange(p4, p5); exchange(p7, p8);
  exchange(p0, p3); exchange(p5, p8); exchange(p4, p7);
  exchange(p3, p6); exchange(p1, p4); exchange(p2, p5);
  exchange(p4, p7); exchange(p2, p4); exchange(p4, p6);
  exchange(p2, p4);

  dst[static_cast<size_t>(y) * width + x] = p4;
}

}  // namespace

// C entry point, loaded with ctypes. `in` and `out` are contiguous
// (batch, height, width) float32 device buffers; `stream` is a cudaStream_t.
// Launches on that stream without synchronising and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int median3x3_f32(const void* in, void* out, int batch, int height,
                             int width, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((width + kTileX - 1) / kTileX,
                  (height + kTileY - 1) / kTileY, batch);
  median3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}
