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
// host sync. Links always go from a larger index to a smaller one, so a
// component's root is its minimum index: the same fixpoint as the Pallas
// kernels, bit for bit. The atomics race, but the result is deterministic,
// because the minimum of a component is unique and the union is complete
// once the border pass ends.
//
// Bound: 5 bytes a pixel, the mask byte in and the int32 label out, so
// 0.0235 ms at (240, 256, 256) and 0.0111 ms at (416, 134, 134) at
// 3.35 TB/s. Real traffic is about 10-13 bytes a pixel over three launches:
// the mask and the labels in and out of the local pass, the tile borders,
// and resolve's read of every label and write of those that change. The
// local pass takes most of the time: each block runs its loads, its unions
// and its chases one after the other, between barriers, so it waits on
// latency rather than bandwidth, most where one component fills a tile.
//
// Design: a block-based union-find (Allegretti, Bolelli and Grana, IEEE
// TPDS 2020) whose local phase works on row runs (Hennequin et al., HA4,
// DASIP 2018). The output buffer is the parent array, indexed per image,
// so no scratch is allocated.
//
//   local    one block per tile of 32 columns x kTileRows rows, in shared
//            memory; each of its 4 warps takes a band of kTileRows / 4
//            rows, in order (fewer warps a tile, more tiles in flight). A
//            warp ballots one 32-pixel row segment of the domain
//            (foreground in label mode, background in holes mode; lanes
//            outside the image are outside the domain); run starts are
//            d & ~(d << 1), and each pixel's parent is its run's head,
//            found with __clz, so rows never start as chains. Two rows
//            unite only where a pair of runs meets (pair_links), with
//            shared-memory atomicCAS on tile-local indices (int32 words:
//            shared atomics are native at 32 bits, and a tile's 4 KB does
//            not limit occupancy). Each run's head then finds its tile-local
//            root, the tile component's minimum, and hands it to the run's
//            pixels, which write its per-image index.
//   border   the tile's top row and left column unite with the pixels they
//            touch across the tile border, run by run again, plus the
//            diagonals across the tile corners; only these unions use
//            device-memory atomics (CAS on roots, path halving), and they
//            link tile roots that are mostly distinct, so the old
//            contention of one large background component on a few roots
//            is gone.
//   resolve  each pixel writes the root of its parent; codes below 0 are
//            already final. Four pixels a thread, one 16-byte load and at
//            most one store.
//
// Holes mode needs no flags: every image has a virtual root -1, "outside
// the image", smaller than every pixel index. Image-border background runs
// unite with it in the local pass, so every border-reachable component's
// root becomes -1, which is already its output; each hole's root stays its
// minimum index. Finds stop at a negative parent without reading it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 32;  // rows of a tile; a tile is 32 columns wide
constexpr int kWarps = 4;      // warps of a local block, each a band of the tile's rows
constexpr int kLocalThreads = 32 * kWarps;
constexpr int kResolveThreads = 256;

// Which pixels of the line before (bit 0: position i - 1, bit 1: i, bit 2:
// i + 1) pixel i of the current line unites with, inside a window [0, n)
// of both lines. `cur` and `other` hold one bit per window position; bit i
// of `cur` is set. One union per pair of runs that touch, at the first
// pixel of the current run where they touch: the current run's start (i == 0
// or the pixel before outside the domain), or, with 8-connectivity, the
// pixel just before a run of the other line starts.
__device__ __forceinline__ int pair_links(unsigned cur, unsigned other, int i, int n,
                                          bool diag) {
  const bool c_m = i > 0 && ((cur >> (i - 1)) & 1u);
  const bool o_m = i > 0 && ((other >> (i - 1)) & 1u);
  const bool o_0 = (other >> i) & 1u;
  const bool o_p = i + 1 < n && ((other >> (i + 1)) & 1u);
  if (!diag) return (o_0 && !(c_m && o_m)) ? 2 : 0;
  if (!c_m) return (o_m ? 1 : 0) | (o_0 && !o_m ? 2 : 0) | (o_p && !o_0 ? 4 : 0);
  return (o_p && !o_0) ? 4 : 0;
}

// --- shared memory, tile-local indices ly * 32 + lx, virtual root -1 ---

// The root of x (x >= 0), halving the path on the way: each visited entry
// is relinked to its grandparent, an ancestor in its own tree, so
// concurrent finds and links stay valid (Jaiganesh & Burtscher, ECL-CC,
// HPDC 2018). A negative parent is the virtual root.
__device__ __forceinline__ int find_local(volatile int* ps, int x) {
  while (true) {
    const int p = ps[x];
    if (p < 0) return -1;
    if (p == x) return x;
    const int gp = ps[p];
    if (gp < 0) return -1;
    if (gp != p) ps[x] = gp;
    x = gp;
  }
}

// Union of the trees holding a and b (either may be the virtual root -1):
// the larger root is linked under the smaller with a compare-and-swap that
// succeeds only while it is still a root; otherwise the union retries.
__device__ __forceinline__ void unite_local(volatile int* ps, int a, int b) {
  while (true) {
    a = a < 0 ? -1 : find_local(ps, a);
    b = b < 0 ? -1 : find_local(ps, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(const_cast<int*>(ps + b), b, a) == b) return;
  }
}

// --- device memory, per-image indices y * W + x, virtual root -1 ---

// As find_local (x >= 0); loads and stores go through L2 (ld.global.cg):
// other SMs relink while this runs.
__device__ __forceinline__ int find_root(int* parent, int x) {
  while (true) {
    const int p = __ldcg(parent + x);
    if (p < 0) return -1;
    if (p == x) return x;
    const int gp = __ldcg(parent + p);
    if (gp < 0) return -1;
    if (gp != p) __stcg(parent + x, gp);
    x = gp;
  }
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = a < 0 ? -1 : find_root(parent, a);
    b = b < 0 ? -1 : find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(parent + b, b, a) == b) return;
  }
}

// The root of x once the border pass has ended: the trees no longer change
// but for resolve's stores of roots, so the chase only reads, and through
// L1, since the pixels of a tile all chase the same few entries. An L1 copy
// is read during this launch (L1 holds nothing from the launches before);
// if another SM has since stored the root there, the stale copy is an
// ancestor that leads to the same root.
__device__ __forceinline__ int final_root(const int* parent, int x) {
  while (true) {
    const int p = parent[x];
    if (p < 0) return -1;
    if (p == x) return x;
    x = p;
  }
}

// Whether pixel (y, x) of image `img` is in the domain: inside the image,
// and foreground in label mode, background in holes mode.
__device__ __forceinline__ bool in_domain(const uint8_t* img, int y, int x, int height,
                                          int width, bool holes) {
  return x >= 0 && y >= 0 && x < width && y < height &&
         ((img[static_cast<size_t>(y) * width + x] != 0) != holes);
}

__global__ void __launch_bounds__(kLocalThreads)
local_kernel(const uint8_t* __restrict__ mask, int* __restrict__ out, int height,
             int width, bool holes, bool diag) {
  constexpr int kBand = kTileRows / kWarps;  // rows of each warp's band
  static_assert(kBand * kWarps == kTileRows, "a tile is kWarps bands");
  __shared__ int parent_s[32 * kTileRows];
  __shared__ unsigned rows[kTileRows];
  volatile int* ps = parent_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * 32;
  const int y0 = blockIdx.y * kTileRows;
  const int x = x0 + lane;
  const size_t plane = static_cast<size_t>(height) * width;
  const uint8_t* img = mask + blockIdx.z * plane;
  int* lab = out + blockIdx.z * plane;
  const unsigned upto = (2u << lane) - 1u;  // bits 0..lane

  // runs: each pixel's parent is its run's head; every row of the band is
  // loaded before the first ballot
  bool dom[kBand];
#pragma unroll
  for (int i = 0; i < kBand; ++i)
    dom[i] = in_domain(img, y0 + warp * kBand + i, x, height, width, holes);
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    const int ly = warp * kBand + i;
    const unsigned d = __ballot_sync(0xffffffffu, dom[i]);
    if (lane == 0) rows[ly] = d;
    const unsigned starts = d & ~(d << 1);
    ps[ly * 32 + lane] = ly * 32 + (dom[i] ? 31 - __clz(starts & upto) : lane);
  }
  __syncthreads();

  // unions between the rows of the tile, and with the virtual root: each
  // warp takes its band of rows in order, so that a row's finds meet the
  // rows above already linked
  for (int i = 0; i < kBand; ++i) {
    const int ly = warp * kBand + i;
    const unsigned d = rows[ly];
    if ((d >> lane) & 1u) {
      const int y = y0 + ly;
      const int self = ly * 32 + lane;
      const bool start = lane == 0 || !((d >> (lane - 1)) & 1u);
      if (holes && (x == 0 || x == width - 1 || (start && (y == 0 || y == height - 1))))
        unite_local(ps, self, -1);
      if (ly > 0) {
        const int links = pair_links(d, rows[ly - 1], lane, 32, diag);
        for (int k = 0; k < 3; ++k) {
          if (links & (1 << k)) unite_local(ps, self, self - 32 + k - 1);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // each pixel: the per-image index of its tile root, or its final code;
  // a run's head chases the root and hands it to the run's other lanes
  for (int i = 0; i < kBand; ++i) {
    const int ly = warp * kBand + i;
    const int y = y0 + ly;
    const unsigned d = rows[ly];
    const bool dom = (d >> lane) & 1u;
    const unsigned starts = d & ~(d << 1);
    int r = 0;
    if (dom && ((starts >> lane) & 1u)) {
      r = ly * 32 + lane;
      while (true) {
        const int p = ps[r];
        if (p < 0 || p == r) {
          r = p;
          break;
        }
        r = p;
      }
    }
    r = __shfl_sync(0xffffffffu, r, dom ? 31 - __clz(starts & upto) : lane);
    if (x < width && y < height)
      lab[static_cast<size_t>(y) * width + x] =
          !dom ? (holes ? -2 : -1) : r < 0 ? -1 : (y0 + r / 32) * width + x0 + r % 32;
  }
}

// Unions across the tile border. Warp 0 takes the tile's top row against
// the row above; warp 1 takes the tile's left column against the column to
// its left. Each is pair_links on a window of one line pair, plus, with
// 8-connectivity, the two diagonals that leave the window at its ends.
static_assert(kTileRows == 32, "the left column is one warp");

__global__ void __launch_bounds__(64)
border_kernel(const uint8_t* __restrict__ mask, int* out, int height, int width, bool holes,
              bool diag) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * 32;
  const int y0 = blockIdx.y * kTileRows;
  const size_t plane = static_cast<size_t>(height) * width;
  const uint8_t* img = mask + blockIdx.z * plane;
  int* parent = out + blockIdx.z * plane;
  if (warp == 0) {
    if (y0 == 0) return;
    const int n = min(32, width - x0);
    const int x = x0 + lane, y = y0;
    const bool c = lane < n && in_domain(img, y, x, height, width, holes);
    const unsigned cur = __ballot_sync(0xffffffffu, c);
    const unsigned other =
        __ballot_sync(0xffffffffu, lane < n && in_domain(img, y - 1, x, height, width, holes));
    if (!c) return;
    const int self = y * width + x;
    const int links = pair_links(cur, other, lane, n, diag);
    for (int k = 0; k < 3; ++k) {
      if (links & (1 << k)) unite(parent, self, self - width + k - 1);
    }
    if (diag && lane == 0 && in_domain(img, y - 1, x - 1, height, width, holes))
      unite(parent, self, self - width - 1);
    if (diag && lane == n - 1 && in_domain(img, y - 1, x + 1, height, width, holes))
      unite(parent, self, self - width + 1);
  } else {
    if (x0 == 0) return;
    const int n = min(32, height - y0);
    const int x = x0, y = y0 + lane;
    const bool c = lane < n && in_domain(img, y, x, height, width, holes);
    const unsigned cur = __ballot_sync(0xffffffffu, c);
    const unsigned other =
        __ballot_sync(0xffffffffu, lane < n && in_domain(img, y, x - 1, height, width, holes));
    if (!c) return;
    const int self = y * width + x;
    const int links = pair_links(cur, other, lane, n, diag);
    for (int k = 0; k < 3; ++k) {
      if (links & (1 << k)) unite(parent, self, self - 1 + (k - 1) * width);
    }
    if (diag && lane == 0 && in_domain(img, y - 1, x - 1, height, width, holes))
      unite(parent, self, self - width - 1);
    if (diag && lane == n - 1 && in_domain(img, y + 1, x - 1, height, width, holes))
      unite(parent, self, self + width - 1);
  }
}

__global__ void __launch_bounds__(kResolveThreads)
resolve_kernel(int* out, int plane, long long total) {
  const long long q = static_cast<long long>(blockIdx.x) * kResolveThreads + threadIdx.x;
  const long long i0 = 4 * q;
  if (i0 >= total) return;
  if (i0 + 4 <= total) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(out) + q);
    int r[4] = {v.x, v.y, v.z, v.w};
    bool changed = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (r[k] < 0) continue;
      const int root = final_root(out + ((i0 + k) / plane) * plane, r[k]);
      changed |= root != r[k];
      r[k] = root;
    }
    if (changed) __stcg(reinterpret_cast<int4*>(out) + q, make_int4(r[0], r[1], r[2], r[3]));
    return;
  }
  for (long long i = i0; i < total; ++i) {
    const int p = __ldcg(out + i);
    if (p < 0) continue;
    const int root = final_root(out + (i / plane) * plane, p);
    if (root != p) __stcg(out + i, root);
  }
}

int launch(const uint8_t* mask, int* out, int batch, int height, int width, bool holes,
           bool diag, cudaStream_t s) {
  const dim3 grid((width + 31) / 32, (height + kTileRows - 1) / kTileRows, batch);
  local_kernel<<<grid, kLocalThreads, 0, s>>>(mask, out, height, width, holes, diag);
  border_kernel<<<grid, 64, 0, s>>>(mask, out, height, width, holes, diag);
  const long long total = static_cast<long long>(batch) * height * width;
  const long long quads = (total + 3) / 4;
  resolve_kernel<<<static_cast<unsigned>((quads + kResolveThreads - 1) / kResolveThreads),
                   kResolveThreads, 0, s>>>(out, height * width, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes. `mask` is a contiguous (batch, height,
// width) bool (one byte, 0 or 1) device buffer and `out` a contiguous int32
// buffer of the same shape; `mode` is 0 for label, 1 for holes;
// `connectivity` is 1 (4-neighbours) or 2 (8-neighbours) and is ignored in
// holes mode, which is always 4-connected. Launches on `stream` (a
// cudaStream_t) without synchronising and returns cudaGetLastError() as an
// int (0 on success).
extern "C" int ccl_i32(const void* mask, void* out, int batch, int height, int width,
                       int mode, int connectivity, void* stream) {
  const bool holes = mode == 1;
  const bool diag = !holes && connectivity == 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* o = static_cast<int*>(out);
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  return launch(m, o, batch, height, width, holes, diag, s);
}
