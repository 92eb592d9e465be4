// Border flood of the background of a (B, H, W) bool batch, for Hopper
// (sm_90a), with two entries:
//
//   flood_from_border_i32  int32 (B, H, W): 1 where a background pixel is
//                          4-connected to the image border, 0 elsewhere;
//   filled_centroid_f32    float32 (B, 2): the centre of mass (row, col) of
//                          the hole-filled mask fg | (bg & ~reached), its
//                          mass clamped to at least 1.
//
// Replaces the Pallas TPU kernels of pylinac_tpu/ops/pallas_label.py:
// _flood_kernel (:165, entry flood_from_border :220) and
// _flood_packed_kernel (:510, entry filled_centroid_packed :634). It
// computes what they compute, not how. Both aim at one fixpoint, the set of
// background pixels 4-connected to the border: _flood_kernel by
// min-propagation with log-doubling run sweeps, checked every 8 sweeps and
// capped at MAX_ITERS = 256 (:35-41, :207-216); _flood_packed_kernel by
// Kogge-Stone fills over bit-packed words, capped at 64 rounds (:570-583).
// This kernel reaches the same fixpoint exactly and has no cap: it stops
// when a pass changes nothing.
//
//   pack      one warp per (image, row, 32 columns): __ballot_sync packs the
//             background bits into a word (bit b = column 32k + b); the
//             reached bits start as the background on the border;
//   flood     one block per image alternates a row pass and a column pass
//             over the packed words until a pass changes nothing, which
//             proves the state closed under both. The row pass gives each
//             row to a thread: an occluded fill (Kogge-Stone within the
//             word) runs east with the carry from word to word, then west.
//             The column pass fills 32 columns at once down, then up, as a
//             segmented scan: the rows are cut into segments, one thread
//             per (word column, segment), whose summaries (the fill from
//             no carry, the AND of the background) chain the carries;
//   expand    (flood entry) writes the int32 output, one thread per pixel;
//   epilogue  (centroid entry, in the flood block) sums the filled mask's
//             mass, sum of rows and sum of columns as 64-bit integers from
//             popcounts, then divides in float64 and rounds to float32.
//
// The integer sums make the centroids deterministic and bit-equal to the
// plain twin, which sums in int64 and divides the same way.
//
// Bound: bytes. The flood entry must read 1 byte and write 4 bytes per
// pixel: 65.5 MB at (8, 1280, 1280), about 20 us at 3.35 TB/s; the centroid
// entry reads 13.1 MB and writes 64 bytes, about 4 us. The design keeps the
// working state at 1/32 of an int32 image (two 205 KB bit planes per
// 1280 x 1280 frame) so that it stays in L2 across passes, and keeps the
// fixpoint inside one block per image, so it needs no grid-wide barrier and
// no host round trip. With B blocks only B SMs work on the flood; a convex
// field closes in two passes. Shared-memory bit tiles and more blocks per
// image are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerTile = 8;       // pack and expand tiles: 32 x 8 threads
constexpr int kFloodThreads = 1024;   // one block per image

// Occluded fill toward higher bits: every bit of `prop` reachable from a
// bit of `gen` through a run of `prop` bits (gen is a subset of prop).
__device__ __forceinline__ uint32_t fill_east(uint32_t gen, uint32_t prop) {
  gen |= prop & (gen << 1);
  prop &= prop << 1;
  gen |= prop & (gen << 2);
  prop &= prop << 2;
  gen |= prop & (gen << 4);
  prop &= prop << 4;
  gen |= prop & (gen << 8);
  prop &= prop << 8;
  gen |= prop & (gen << 16);
  return gen;
}

// The same toward lower bits.
__device__ __forceinline__ uint32_t fill_west(uint32_t gen, uint32_t prop) {
  gen |= prop & (gen >> 1);
  prop &= prop >> 1;
  gen |= prop & (gen >> 2);
  prop &= prop >> 2;
  gen |= prop & (gen >> 4);
  prop &= prop >> 4;
  gen |= prop & (gen >> 8);
  prop &= prop >> 8;
  gen |= prop & (gen >> 16);
  return gen;
}

__global__ void __launch_bounds__(32 * kRowsPerTile)
pack_kernel(const uint8_t* __restrict__ mask, uint32_t* __restrict__ bg,
            uint32_t* __restrict__ reached, int height, int width, int words) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * kRowsPerTile + threadIdx.y;
  const size_t row = static_cast<size_t>(blockIdx.z) * height + y;
  const bool is_bg = x < width && y < height && mask[row * width + x] == 0;
  // the whole warp shares y, so it reaches the ballot together
  const uint32_t bits = __ballot_sync(0xffffffffu, is_bg);
  if (threadIdx.x != 0 || y >= height) return;
  const int k = blockIdx.x;
  uint32_t seed = bits;
  if (y != 0 && y != height - 1) {
    seed = 0;
    if (k == 0) seed |= 1u;
    if (k == (width - 1) >> 5) seed |= 1u << ((width - 1) & 31);
    seed &= bits;
  }
  bg[row * words + k] = bits;
  reached[row * words + k] = seed;
}

// Row pass: each thread closes whole rows, east then west. Returns whether
// this thread changed a word.
__device__ bool row_pass(const uint32_t* __restrict__ bg, uint32_t* reached,
                         int height, int words) {
  bool changed = false;
  for (int y = threadIdx.x; y < height; y += blockDim.x) {
    const uint32_t* p = bg + static_cast<size_t>(y) * words;
    uint32_t* r = reached + static_cast<size_t>(y) * words;
    uint32_t carry = 0;  // bit 31 of the previous word, into bit 0
    for (int k = 0; k < words; ++k) {
      const uint32_t old = r[k];
      const uint32_t prop = p[k];
      const uint32_t gen = fill_east(old | (carry & prop), prop);
      if (gen != old) {
        r[k] = gen;
        changed = true;
      }
      carry = gen >> 31;
    }
    carry = 0;  // bit 0 of the next word, into bit 31
    for (int k = words - 1; k >= 0; --k) {
      const uint32_t old = r[k];
      const uint32_t prop = p[k];
      const uint32_t gen = fill_west(old | ((carry << 31) & prop), prop);
      if (gen != old) {
        r[k] = gen;
        changed = true;
      }
      carry = gen & 1u;
    }
  }
  return changed;
}

// Column pass: the vertical fill out_y = reached_y | (bg_y & out_{y-1}) of
// every word column, down then up, as a segmented scan. A segment's output
// for a carry c is G | (P & c), with G its output for no carry and P the AND
// of its background words. `seg_g` and `seg_p` hold one word per thread.
// Every thread of the block must call it. Returns whether this thread
// changed a word.
__device__ bool col_pass(const uint32_t* __restrict__ bg, uint32_t* reached,
                         int height, int words, uint32_t* seg_g, uint32_t* seg_p) {
  const int segs = max(1, min(static_cast<int>(blockDim.x) / words, height));
  const int len = (height + segs - 1) / segs;
  const int tasks = words * segs;
  bool changed = false;
  for (int down = 1; down >= 0; --down) {
    if (segs > 1) {  // then tasks <= blockDim.x: one task per thread
      const int t = threadIdx.x;
      if (t < tasks) {
        const int k = t % words;
        const int s = t / words;
        const int y0 = s * len;
        const int y1 = min(y0 + len, height);
        uint32_t g = 0;
        uint32_t p = 0xffffffffu;
        for (int j = 0; j < y1 - y0; ++j) {
          const int y = down ? y0 + j : y1 - 1 - j;
          const size_t i = static_cast<size_t>(y) * words + k;
          const uint32_t b = bg[i];
          g = reached[i] | (b & g);
          p &= b;
        }
        seg_g[t] = g;
        seg_p[t] = p;
      }
      __syncthreads();
      // chain the segments of each word column; seg_g becomes the carry in
      for (int k = threadIdx.x; k < words; k += blockDim.x) {
        uint32_t c = 0;
        for (int j = 0; j < segs; ++j) {
          const int i = (down ? j : segs - 1 - j) * words + k;
          const uint32_t g = seg_g[i];
          seg_g[i] = c;
          c = g | (seg_p[i] & c);
        }
      }
      __syncthreads();
    }
    for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
      const int k = t % words;
      const int s = t / words;
      const int y0 = s * len;
      const int y1 = min(y0 + len, height);
      uint32_t c = segs > 1 ? seg_g[t] : 0u;
      for (int j = 0; j < y1 - y0; ++j) {
        const int y = down ? y0 + j : y1 - 1 - j;
        const size_t i = static_cast<size_t>(y) * words + k;
        const uint32_t old = reached[i];
        const uint32_t gen = old | (bg[i] & c);
        if (gen != old) {
          reached[i] = gen;
          changed = true;
        }
        c = gen;
      }
    }
    __syncthreads();
  }
  return changed;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Mass, sum of rows and sum of columns of the filled mask, valid & ~reached
// (reached is a subset of the background), then the centroid.
__device__ void centroid_epilogue(const uint32_t* reached, float* centroid,
                                  int height, int width, int words) {
  __shared__ unsigned long long partial[3][kFloodThreads / 32];
  const uint32_t last_valid = (width & 31) ? ((1u << (width & 31)) - 1u) : 0xffffffffu;
  const size_t plane = static_cast<size_t>(height) * words;
  unsigned long long mass = 0, sum_y = 0, sum_x = 0;
  for (size_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const int y = static_cast<int>(i / words);
    const int k = static_cast<int>(i - static_cast<size_t>(y) * words);
    const uint32_t filled = (k == words - 1 ? last_valid : 0xffffffffu) & ~reached[i];
    const unsigned count = __popc(filled);
    // sum of the set bits' indices: bit index b = sum_j 2^j [bit j of b]
    const unsigned bit_sum = __popc(filled & 0xAAAAAAAAu) + 2u * __popc(filled & 0xCCCCCCCCu)
        + 4u * __popc(filled & 0xF0F0F0F0u) + 8u * __popc(filled & 0xFF00FF00u)
        + 16u * __popc(filled & 0xFFFF0000u);
    mass += count;
    sum_y += static_cast<unsigned long long>(y) * count;
    sum_x += 32ull * k * count + bit_sum;
  }
  mass = warp_sum(mass);
  sum_y = warp_sum(sum_y);
  sum_x = warp_sum(sum_x);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    partial[0][warp] = mass;
    partial[1][warp] = sum_y;
    partial[2][warp] = sum_x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0, sy = 0, sx = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x + 31) / 32; ++w) {
      m += partial[0][w];
      sy += partial[1][w];
      sx += partial[2][w];
    }
    const double denom = static_cast<double>(m > 0 ? m : 1);
    centroid[2 * blockIdx.x] = static_cast<float>(static_cast<double>(sy) / denom);
    centroid[2 * blockIdx.x + 1] = static_cast<float>(static_cast<double>(sx) / denom);
  }
}

__global__ void __launch_bounds__(kFloodThreads)
flood_kernel(const uint32_t* __restrict__ bg, uint32_t* reached, float* centroid,
             int height, int width, int words) {
  __shared__ int changed;
  __shared__ uint32_t seg_g[kFloodThreads];
  __shared__ uint32_t seg_p[kFloodThreads];
  const size_t plane = static_cast<size_t>(height) * words;
  const uint32_t* b = bg + blockIdx.x * plane;
  uint32_t* r = reached + blockIdx.x * plane;
  for (int pass = 0;; ++pass) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    const bool mine = (pass & 1) ? col_pass(b, r, height, words, seg_g, seg_p)
                                 : row_pass(b, r, height, words);
    if (mine) changed = 1;
    __syncthreads();
    const bool any = changed != 0;
    __syncthreads();  // every thread has read `changed` before it is reset
    // a pass that changes nothing leaves the state closed under both passes
    if (pass > 0 && !any) break;
  }
  if (centroid != nullptr) centroid_epilogue(r, centroid, height, width, words);
}

__global__ void __launch_bounds__(32 * kRowsPerTile)
expand_kernel(const uint32_t* __restrict__ reached, int* __restrict__ out,
              int height, int width, int words) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * kRowsPerTile + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * height + y;
  out[row * width + x] = (reached[row * words + (x >> 5)] >> (x & 31)) & 1u;
}

int launch(const void* mask, int* out, float* centroid, void* bg, void* reached,
           int batch, int height, int width, cudaStream_t s) {
  const int words = (width + 31) / 32;
  const dim3 tile(32, kRowsPerTile);
  const dim3 grid(words, (height + kRowsPerTile - 1) / kRowsPerTile, batch);
  uint32_t* bits = static_cast<uint32_t*>(bg);
  uint32_t* seen = static_cast<uint32_t*>(reached);
  pack_kernel<<<grid, tile, 0, s>>>(static_cast<const uint8_t*>(mask), bits, seen,
                                    height, width, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flood_kernel<<<batch, kFloodThreads, 0, s>>>(bits, seen, centroid, height, width, words);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  expand_kernel<<<grid, tile, 0, s>>>(seen, out, height, width, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes. `mask` is a contiguous (batch, height,
// width) bool (one byte, 0 or 1) device buffer; `bg` and `reached` are
// device scratch buffers of batch * height * ceil(width / 32) uint32 words.
// `out` is a contiguous int32 buffer of the mask's shape; `centroid` a
// float32 buffer of batch * 2. Both launch on `stream` (a cudaStream_t)
// without synchronising and return cudaGetLastError() as an int (0 on
// success). batch, height and width are at least 1; batch and
// ceil(height / 8) at most 65535.
extern "C" int flood_from_border_i32(const void* mask, void* out, void* bg, void* reached,
                                     int batch, int height, int width, void* stream) {
  return launch(mask, static_cast<int*>(out), nullptr, bg, reached, batch, height, width,
                static_cast<cudaStream_t>(stream));
}

extern "C" int filled_centroid_f32(const void* mask, void* centroid, void* bg, void* reached,
                                   int batch, int height, int width, void* stream) {
  return launch(mask, nullptr, static_cast<float*>(centroid), bg, reached, batch, height,
                width, static_cast<cudaStream_t>(stream));
}
