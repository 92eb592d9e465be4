// Connected-component labelling of a (B, H, W) bool batch, for Hopper
// (sm_90a), in two modes:
//
//   label  components of the mask, 4- or 8-connected. Background -1; every
//          component pixel carries the minimum per-image linear index
//          (y * W + x) of its component.
//   holes  components of the background, 4-connected. -1 for background
//          reachable from the image border, the hole's minimum per-image
//          linear index for hole pixels, -2 for foreground.
//
// Replaces the Pallas TPU kernels pylinac_tpu/ops/pallas_label.py:
// _batched_sweep_kernel (:336, both modes), _label_kernel (:69) and
// _hole_kernel (:232). It computes what they compute, not how: they iterate
// a min-propagation with log-doubling run sweeps to a fixpoint, capped at
// 256 sweeps; this is an exact union-find with no convergence loop and no
// host sync (Playne & Hawick, IEEE TPDS 2018):
//
//   init      each domain pixel points to itself or to a smaller-index
//             neighbour already in its domain;
//   merge     for each domain pixel and each smaller-index neighbour of the
//             connectivity, union the two roots: the larger root is linked
//             under the smaller one with atomicCAS, retrying if another
//             thread linked it first; finds halve their paths as they go;
//   compress  every domain pixel points straight at its root; in holes
//             mode, border background pixels also flag their root;
//   finalize  write the per-image output.
//
// Links always go from a larger index to a smaller one, so a component's
// root is its minimum index: the same fixpoint as the Pallas kernels, bit
// for bit. The atomics race, but the result is deterministic, because the
// minimum of a component is unique and the union is complete once merge
// ends. Indices are global (b * H * W + i) during the union, so B * H * W
// must stay below 2^31 (the wrapper checks), and per-image in the output.
//
// Bound: memory latency of the root chases in merge, not bandwidth. Each
// pixel costs a 1-byte mask read, about 2-4 neighbour reads and a few
// 4-byte parent reads and writes; a 240 x 256 x 256 batch is about 16 M
// pixels, 0.3-0.5 GB of traffic, under 0.2 ms at 3.35 TB/s if it streamed.
// On an H100 (700 W) the CT localisation masks at that shape take about
// 0.8 ms in label mode and 3.5 ms in holes mode, where each slice's
// background is one large component whose links contend for few roots.
// Design: one thread per pixel in 32 x 8 blocks, blockIdx.z over the
// batch; the parent array is the output buffer itself (no extra scratch in
// label mode; one byte per pixel of root flags in holes mode). init links
// each pixel to its left neighbour where it can, so rows start as chains;
// path halving in every find keeps the chases short. Block-local
// union-find in shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

// The root of x, halving the path on the way: each visited pixel is
// relinked to its grandparent, an ancestor in its own tree, so concurrent
// finds and links stay valid (Jaiganesh & Burtscher, ECL-CC, HPDC 2018).
// Loads go through L2 (ld.global.cg): other SMs relink while this runs.
__device__ __forceinline__ int find_root(int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    const int gp = __ldcg(parent + p);
    if (gp != p) __stcg(parent + x, gp);
    x = gp;
    p = __ldcg(parent + x);
  }
  return x;
}

// The root of x once merge has ended: the trees no longer change, and the
// chase only reads, so that compress can store each pixel's root without a
// concurrent halving store putting an intermediate back.
__device__ __forceinline__ int final_root(const int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Union of the trees holding a and b: the larger root is linked under the
// smaller with a compare-and-swap that succeeds only while it is still a
// root; otherwise another thread linked it first, and the union retries
// from the new roots.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(parent + b, b, a) == b) return;
  }
}

// Whether pixel (y, x) of image `img` (mask bytes) is in the domain:
// foreground in label mode, background in holes mode.
__device__ __forceinline__ bool in_domain(const uint8_t* img, int y, int x,
                                          int width, bool holes) {
  return (img[static_cast<size_t>(y) * width + x] != 0) != holes;
}

__global__ void __launch_bounds__(kTileX * kTileY)
init_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
            int height, int width, bool holes, bool diag) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = height * width;
  const uint8_t* img = mask + static_cast<size_t>(blockIdx.z) * plane;
  const int idx = blockIdx.z * plane + y * width + x;
  if (!in_domain(img, y, x, width, holes)) {
    parent[idx] = idx;
    return;
  }
  int p = idx;
  if (x > 0 && in_domain(img, y, x - 1, width, holes)) {
    p = idx - 1;
  } else if (y > 0 && in_domain(img, y - 1, x, width, holes)) {
    p = idx - width;
  } else if (diag && y > 0 && x > 0 && in_domain(img, y - 1, x - 1, width, holes)) {
    p = idx - width - 1;
  } else if (diag && y > 0 && x + 1 < width && in_domain(img, y - 1, x + 1, width, holes)) {
    p = idx - width + 1;
  }
  parent[idx] = p;
}

__global__ void __launch_bounds__(kTileX * kTileY)
merge_kernel(const uint8_t* __restrict__ mask, int* parent, int height,
             int width, bool holes, bool diag) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = height * width;
  const uint8_t* img = mask + static_cast<size_t>(blockIdx.z) * plane;
  if (!in_domain(img, y, x, width, holes)) return;
  const int idx = blockIdx.z * plane + y * width + x;
  // every edge once: from each pixel to its neighbours of smaller index
  if (x > 0 && in_domain(img, y, x - 1, width, holes)) unite(parent, idx, idx - 1);
  if (y > 0 && in_domain(img, y - 1, x, width, holes)) unite(parent, idx, idx - width);
  if (diag && y > 0) {
    if (x > 0 && in_domain(img, y - 1, x - 1, width, holes))
      unite(parent, idx, idx - width - 1);
    if (x + 1 < width && in_domain(img, y - 1, x + 1, width, holes))
      unite(parent, idx, idx - width + 1);
  }
}

__global__ void __launch_bounds__(kTileX * kTileY)
compress_kernel(const uint8_t* __restrict__ mask, int* parent,
                uint8_t* __restrict__ border_root, int height, int width,
                bool holes) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = height * width;
  const uint8_t* img = mask + static_cast<size_t>(blockIdx.z) * plane;
  if (!in_domain(img, y, x, width, holes)) return;
  const int idx = blockIdx.z * plane + y * width + x;
  const int root = final_root(parent, idx);
  parent[idx] = root;
  if (holes && (x == 0 || y == 0 || x == width - 1 || y == height - 1)) {
    border_root[root] = 1;
  }
}

__global__ void __launch_bounds__(kTileX * kTileY)
finalize_kernel(const uint8_t* __restrict__ mask, int* out,
                const uint8_t* __restrict__ border_root, int height, int width,
                bool holes) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = height * width;
  const uint8_t* img = mask + static_cast<size_t>(blockIdx.z) * plane;
  const int base = blockIdx.z * plane;
  const int idx = base + y * width + x;
  if (!in_domain(img, y, x, width, holes)) {
    out[idx] = holes ? -2 : -1;
    return;
  }
  const int root = out[idx];  // compressed: the parent is the root
  out[idx] = (holes && border_root[root]) ? -1 : root - base;
}

}  // namespace

// C entry point, loaded with ctypes. `mask` is a contiguous (batch, height,
// width) bool (one byte, 0 or 1) device buffer and `out` a contiguous int32
// buffer of the same shape; `mode` is 0 for label, 1 for holes;
// `connectivity` is 1 (4-neighbours) or 2 (8-neighbours) and is ignored in
// holes mode, which is always 4-connected. `border_root` is a device buffer
// of batch * height * width bytes, used in holes mode only (may be null in
// label mode). Launches on `stream` (a cudaStream_t) without synchronising
// and returns cudaGetLastError() as an int (0 on success).
extern "C" int ccl_i32(const void* mask, void* out, void* border_root,
                       int batch, int height, int width, int mode,
                       int connectivity, void* stream) {
  const bool holes = mode == 1;
  const bool diag = !holes && connectivity == 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* parent = static_cast<int*>(out);
  uint8_t* flags = static_cast<uint8_t*>(border_root);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((width + kTileX - 1) / kTileX,
                  (height + kTileY - 1) / kTileY, batch);
  if (holes) {
    const cudaError_t err = cudaMemsetAsync(
        flags, 0, static_cast<size_t>(batch) * height * width, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  init_kernel<<<grid, block, 0, s>>>(m, parent, height, width, holes, diag);
  merge_kernel<<<grid, block, 0, s>>>(m, parent, height, width, holes, diag);
  compress_kernel<<<grid, block, 0, s>>>(m, parent, flags, height, width, holes);
  finalize_kernel<<<grid, block, 0, s>>>(m, parent, flags, height, width, holes);
  return static_cast<int>(cudaGetLastError());
}
