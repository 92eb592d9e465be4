// 3x3 median filter of a (B, H, W) float32 or int32 batch, for Hopper
// (sm_90a).
//
// Replaces pylinac_tpu/ops/pallas_median.py:_median9_kernel (the Pallas
// TPU kernel). Same result: rank 4 of the 9 neighbours, scipy "reflect"
// edges. For a pad of 1, scipy "reflect" (numpy "symmetric") repeats the
// edge pixel, so clamping the neighbour index is the same padding.
//
// Bound: device memory. Each pixel costs one 4-byte read and one 4-byte
// write (about 8 B per pixel) against 21 min/max instructions, far below
// the card's float32 issue rate. For 64 x 1254 x 1254 that is about 0.8 GB,
// a floor of about 0.24 ms at the H100's 3.35 TB/s.
//
// Design: no shared memory and no barrier. A thread owns kCols = 4
// neighbouring output columns and walks kRows = 16 rows down them with a
// 3-row register window; each step loads one new row of 6 values (the 4
// columns, as two 8-byte pairs where the row pitch is even, and the clamped halo
// column on each side, which its neighbours also read: an L1 hit). A block
// of 32 x 4 threads covers 128 columns x 64 rows. The fully unrolled walk
// lets the compiler issue the loads of later rows ahead of the arithmetic,
// so each thread keeps several rows of loads in flight.
//
// Fewer min/max per output: each of the 6 window columns is sorted once
// per step (6 min/max: low, middle, high) and shared by the up to 3
// outputs that read it. The median of the 9 is then med3(the largest of
// the 3 lows, med3 of the 3 middles, the smallest of the 3 highs): 2 + 4 +
// 2 + 4 more, 21 an output in all against the 38 of a 19-exchange network
// per pixel, and exact for any totally ordered values (ties included).
//
// Types: one template, instantiated for float (the frames widened from
// uint16 and every dtype float32 holds exactly) and int (int32 images, and
// uint32 ones with the top bit flipped, which keeps their order). min/max
// is exact on both, as the Pallas kernel's jnp.minimum/maximum was in the
// input's own dtype.
//
// NaN: fminf/fmaxf return the other operand when one is NaN, so a NaN does
// not propagate as jnp.minimum would, and the sort-based plain version
// orders NaN last. The main path feeds frames widened from uint16, which
// are always finite.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;        // output columns per thread
constexpr int kRows = 16;       // output rows per thread
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 4;
constexpr int kWin = kCols + 2; // window columns: the outputs and a halo each side

// two elements in one 8-byte load or store
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<int> { using type = int2; };

__device__ __forceinline__ float lo(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float hi(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int lo(int a, int b) { return min(a, b); }
__device__ __forceinline__ int hi(int a, int b) { return max(a, b); }

template <typename T>
struct Row {
  T v[kWin];  // columns x0 - 1 .. x0 + kCols, clamped
};

template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* __restrict__ line, int x0, int width,
                                           bool vec) {
  using P = typename Pair<T>::type;
  Row<T> r;
  r.v[0] = __ldg(line + max(x0 - 1, 0));
  r.v[kWin - 1] = __ldg(line + min(x0 + kCols, width - 1));
  if (vec) {
    const P a = __ldg(reinterpret_cast<const P*>(line + x0));
    const P b = __ldg(reinterpret_cast<const P*>(line + x0 + 2));
    r.v[1] = a.x; r.v[2] = a.y; r.v[3] = b.x; r.v[4] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) r.v[j + 1] = __ldg(line + min(x0 + j, width - 1));
  }
  return r;
}

// median of three: 4 min/max
template <typename T>
__device__ __forceinline__ T med3(T a, T b, T c) {
  return hi(lo(a, b), lo(hi(a, b), c));
}

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
median3x3_kernel(const T* __restrict__ in, T* __restrict__ out, int height, int width) {
  using P = typename Pair<T>::type;
  const int x0 = (blockIdx.x * kThreadsX + threadIdx.x) * kCols;
  const int y0 = (blockIdx.y * kThreadsY + threadIdx.y) * kRows;
  if (x0 >= width || y0 >= height) return;

  const size_t plane = static_cast<size_t>(height) * width;
  const T* src = in + blockIdx.z * plane;
  T* dst = out + blockIdx.z * plane;
  // 8-byte loads and stores need an even pitch (8-byte aligned rows) and
  // all kCols columns inside the image
  const bool vec = (width % 2 == 0) && (x0 + kCols <= width);
  auto line = [&](int y) {
    return src + static_cast<size_t>(min(max(y, 0), height - 1)) * width;
  };

  Row<T> above = load_row(line(y0 - 1), x0, width, vec);
  Row<T> here = load_row(line(y0), x0, width, vec);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + i;
    const Row<T> below = load_row(line(y + 1), x0, width, vec);

    // sort each window column of rows y - 1, y, y + 1: 6 min/max each
    T low[kWin], mid[kWin], high[kWin];
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const T l1 = lo(above.v[k], here.v[k]);
      const T h1 = hi(above.v[k], here.v[k]);
      const T t = hi(l1, below.v[k]);
      low[k] = lo(l1, below.v[k]);
      mid[k] = lo(h1, t);
      high[k] = hi(h1, t);
    }
    T m[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const T l = hi(hi(low[j], low[j + 1]), low[j + 2]);
      const T h = lo(lo(high[j], high[j + 1]), high[j + 2]);
      m[j] = med3(l, med3(mid[j], mid[j + 1], mid[j + 2]), h);
    }
    if (y < height) {
      T* o = dst + static_cast<size_t>(y) * width + x0;
      if (vec) {
        reinterpret_cast<P*>(o)[0] = P{m[0], m[1]};
        reinterpret_cast<P*>(o)[1] = P{m[2], m[3]};
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (x0 + j < width) o[j] = m[j];
      }
    }
    above = here;
    here = below;
  }
}

template <typename T>
int launch(const void* in, void* out, int batch, int height, int width, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((width + kThreadsX * kCols - 1) / (kThreadsX * kCols),
                  (height + kThreadsY * kRows - 1) / (kThreadsY * kRows), batch);
  median3x3_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes. `in` and `out` are contiguous
// (batch, height, width) float32 or int32 device buffers; `stream` is a
// cudaStream_t. Each launches on that stream without synchronising and
// returns cudaGetLastError() as an int (0 on success).
extern "C" int median3x3_f32(const void* in, void* out, int batch, int height,
                             int width, void* stream) {
  return launch<float>(in, out, batch, height, width, stream);
}

extern "C" int median3x3_i32(const void* in, void* out, int batch, int height,
                             int width, void* stream) {
  return launch<int>(in, out, batch, height, width, stream);
}
