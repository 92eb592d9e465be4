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
// This kernel reaches the same fixpoint exactly and has no cap.
//
// Each entry is one cooperative launch (cudaLaunchCooperativeKernel) of
// 128-thread blocks, as many as the card holds at once and no more than
// there are tiles. A tile is 128 rows x 4 words (128 x 128 px) of one
// image; block i takes tiles i, i + grid, ... so that every shape runs on
// the whole card, B = 1 included. The state is two bit planes in device
// memory, bg and reached (bit i of word k = column 32k + i), 1/32 of an
// int32 image, which stay in L2.
//
//   pack      each block packs its tiles' background into words and seeds
//             reached with the background on the image border;
//             a grid barrier follows;
//   rounds    each block loads each of its tiles into shared memory with
//             its halo (the reached word above and below each word column,
//             bit 31 of the word left and bit 0 of the word right of each
//             row), closes the tile by alternating a row pass (an occluded
//             Kogge-Stone fill east then west, one thread a row) and a
//             column pass (a warp scan down then up, one warp a word
//             column) until a pass changes nothing, and writes back the
//             words that changed. A block that owns one tile keeps it in
//             shared memory and skips it while its halo has not grown. A
//             grid barrier ends the round. The first round in which no
//             block changed a word ends the flood: no word was written in
//             it, so every halo read in it was final and every tile is
//             closed given its neighbours, which is the global fixpoint.
//             Halos read in an earlier round may be stale; that is
//             harmless, because reached only grows and every bit set is
//             reachable;
//   epilogue  the flood entry expands each tile's reached bits to the int32
//             output; the centroid entry adds each tile's mass, sum of rows
//             and sum of columns (64-bit popcount sums) into three integer
//             slots per image with atomicAdd, exact in any order, and after
//             one more grid barrier divides in float64 and rounds to
//             float32.
//
// The integer sums make the centroids deterministic and bit-equal to the
// plain twin, which sums in int64 and divides the same way.
//
// Coherence. L1 is not coherent across SMs, so every read of a reached word
// that another block may have written, and of the round stamp, goes to L2
// (__ldcg), and reached is written with __stcg. An aligned 32-bit word is
// read and written whole. The round stamp (state[0]) is one more than the
// last round in which a block changed a word: blocks that changed a word in
// round r raise it to r + 1 with atomicMax, and after the barrier every
// block stops if it is at most r. It only grows, so it needs no reset and a
// block that reads it late, after another has raised it in round r + 1,
// still sees it above r. The flood took state[0] + 1 rounds.
//
// grid.sync() of cooperative groups needs no relocatable device code
// (-rdc) since CUDA 11; ops/_build.py compiles this file like the others.
//
// Bound: bytes. The flood entry must read 1 byte and write 4 bytes per
// pixel: 65.5 MB at (8, 1280, 1280), about 20 us at 3.35 TB/s; the centroid
// entry reads 13.1 MB and writes 64 bytes, about 4 us. The rounds add what
// no byte count sees: a convex field closes in about one round per tile
// from the border to its centre, plus one, and each round costs a grid
// barrier and the slowest block's work on the fill's front
// (scripts/flood_phases.py times each phase).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 128;
constexpr int kTileWords = 4;
constexpr int kThreads = kTileRows;  // the row pass: one thread a row
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = kTileRows / 32;
constexpr uint32_t kFull = 0xffffffffu;
static_assert(kWarps == kTileWords, "the column pass gives each word column one warp");
static_assert(kTileWords * 32 == 32 * 4, "pack gives each lane 4 columns of a tile row");

// The tile in shared memory, word columns outermost: row y of word column k
// is [k][y], so a warp's rows fall in distinct banks in the row pass.
struct Tile {
  uint32_t bg[kTileWords][kTileRows];
  uint32_t reached[kTileWords][kTileRows];
};

struct Geometry {
  int batch, height, width, words;  // words = ceil(width / 32)
  int tiles_y, tiles_x, tiles;
};

// Where tile t lies: image b, first row y0, first word k0, and how many of
// its rows and words lie in the image.
struct Span {
  int b, y0, k0, rows, nw;
};

// The bits that flow into a tile from its neighbours in this round: west is
// bit 31 of the word left of this thread's row, east bit 0 of the word right
// of it; top and bottom are the words above and below this thread's warp's
// word column. 0 where the image ends.
struct Halo {
  uint32_t west, east, top, bottom;
};

__device__ __forceinline__ Span span_of(int t, const Geometry& g) {
  const int per_image = g.tiles_y * g.tiles_x;
  Span s;
  s.b = t / per_image;
  const int r = t - s.b * per_image;
  s.y0 = (r / g.tiles_x) * kTileRows;
  s.k0 = (r % g.tiles_x) * kTileWords;
  s.rows = min(kTileRows, g.height - s.y0);
  s.nw = min(kTileWords, g.words - s.k0);
  return s;
}

__device__ __forceinline__ size_t word_at(const Geometry& g, int b, int y, int k) {
  return (static_cast<size_t>(b) * g.height + y) * g.words + k;
}

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

// Prologue: packs the tile's background into bg words (bit i of word k =
// column 32k + i) and seeds reached with the background on the image
// border. Warp w takes rows y0 + w, y0 + w + kWarps, ...; lane l reads
// columns 4l .. 4l + 3 of the tile's row (one 4-byte load where the row
// allows it), makes their 4 background bits, and the 8 lanes of a word OR
// theirs together. A warp issues the loads of kPackRows rows before it
// uses any: the pass waits on device memory, one latency a batch.
constexpr int kPackRows = 8;

__device__ void pack_tile(const uint8_t* __restrict__ mask, uint32_t* bg, uint32_t* reached,
                          const Geometry& g, const Span& s) {
  const int lane = threadIdx.x & 31;
  const int x = s.k0 * 32 + 4 * lane;
  const int valid = min(max(g.width - x, 0), 4);  // this lane's columns in the image
  const bool aligned = valid == 4 && (g.width & 3) == 0;
  for (int i0 = threadIdx.x / 32; i0 < s.rows; i0 += kWarps * kPackRows) {
    uint32_t bytes[kPackRows];  // byte c = mask at column x + c; 1 outside the image
#pragma unroll
    for (int u = 0; u < kPackRows; ++u) {
      const int i = i0 + u * kWarps;
      bytes[u] = 0x01010101u;
      if (i >= s.rows) continue;
      const uint8_t* p = mask + (static_cast<size_t>(s.b) * g.height + s.y0 + i) * g.width + x;
      if (aligned) {
        bytes[u] = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int c = 0; c < valid; ++c)
          if (p[c] == 0) bytes[u] &= ~(1u << (8 * c));
      }
    }
#pragma unroll
    for (int u = 0; u < kPackRows; ++u) {
      const int i = i0 + u * kWarps;
      if (i >= s.rows) break;  // the same for the whole warp
      // the 4 bytes' low bits gathered into bits 24-27, then inverted
      const uint32_t fg = ((bytes[u] & 0x01010101u) * 0x01020408u) >> 24;
      uint32_t word = (~fg & 0xfu) << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      const int j = lane / 8;
      if ((lane & 7) == 0 && j < s.nw) {
        const int y = s.y0 + i;
        const int k = s.k0 + j;
        uint32_t seed = word;
        if (y != 0 && y != g.height - 1) {
          seed = (k == 0 ? 1u : 0u) | (k == g.words - 1 ? 1u << ((g.width - 1) & 31) : 0u);
          seed &= word;
        }
        const size_t at = word_at(g, s.b, y, k);
        bg[at] = word;
        __stcg(reached + at, seed);
      }
    }
  }
}

// Loads the tile into shared memory, 0 outside the image. Returns this
// thread's row of reached words as loaded in `loaded`.
__device__ void load_tile(Tile& tile, const uint32_t* bg, const uint32_t* reached,
                          const Geometry& g, const Span& s, uint32_t (&loaded)[kTileWords]) {
  const int i = threadIdx.x;
  const bool row_in = i < s.rows;
#pragma unroll
  for (int j = 0; j < kTileWords; ++j) {
    const bool in = row_in && j < s.nw;
    const size_t at = in ? word_at(g, s.b, s.y0 + i, s.k0 + j) : 0;
    // bg is written once, in the prologue, by this block
    tile.bg[j][i] = in ? bg[at] : 0u;
    loaded[j] = in ? __ldcg(reached + at) : 0u;
    tile.reached[j][i] = loaded[j];
  }
}

// This thread's part of the tile's halo, read from device memory now. A
// ragged tile lies at the image's edge, where its halo is 0.
__device__ Halo load_halo(const uint32_t* reached, const Geometry& g, const Span& s) {
  const int y = s.y0 + static_cast<int>(threadIdx.x);
  const bool row_in = static_cast<int>(threadIdx.x) < s.rows;
  const int k = s.k0 + static_cast<int>(threadIdx.x) / 32;
  Halo halo;
  halo.west = row_in && s.k0 > 0 ? __ldcg(reached + word_at(g, s.b, y, s.k0 - 1)) >> 31 : 0u;
  halo.east = row_in && s.k0 + kTileWords < g.words
                  ? __ldcg(reached + word_at(g, s.b, y, s.k0 + kTileWords)) & 1u : 0u;
  halo.top = k < g.words && s.y0 > 0 ? __ldcg(reached + word_at(g, s.b, s.y0 - 1, k)) : 0u;
  halo.bottom = k < g.words && s.y0 + kTileRows < g.height
                    ? __ldcg(reached + word_at(g, s.b, s.y0 + kTileRows, k)) : 0u;
  return halo;
}

// Row pass: each thread closes its row of the tile, east from the west
// halo bit, then west from the east halo bit. Returns whether this thread
// changed a word.
__device__ bool row_pass(Tile& tile, const Halo& halo) {
  const int y = threadIdx.x;
  bool changed = false;
  uint32_t carry = halo.west;  // into bit 0
#pragma unroll
  for (int k = 0; k < kTileWords; ++k) {
    const uint32_t old = tile.reached[k][y];
    const uint32_t prop = tile.bg[k][y];
    const uint32_t gen = fill_east(old | (carry & prop), prop);
    if (gen != old) {
      tile.reached[k][y] = gen;
      changed = true;
    }
    carry = gen >> 31;
  }
  carry = halo.east;  // into bit 31
#pragma unroll
  for (int k = kTileWords - 1; k >= 0; --k) {
    const uint32_t old = tile.reached[k][y];
    const uint32_t prop = tile.bg[k][y];
    const uint32_t gen = fill_west(old | ((carry << 31) & prop), prop);
    if (gen != old) {
      tile.reached[k][y] = gen;
      changed = true;
    }
    carry = gen & 1u;
  }
  return changed;
}

// Column pass: the vertical fill out_y = reached_y | (bg_y & out_{y-1}) of
// each word column, down from the top halo word, then up from the bottom
// one. Warp k takes word column k and lane l rows kRowsPerLane * l, ...: a
// lane's rows map a carry c to G | (P & c), G their output for no carry and
// P the AND of their bg words. A warp scan of these maps gives each lane
// its carry in. Each lane reads and writes only its own rows, so the two
// directions need no barrier between them. Returns whether this thread
// changed a word.
__device__ bool col_pass(Tile& tile, const Halo& halo) {
  const int lane = threadIdx.x & 31;
  uint32_t* r = tile.reached[threadIdx.x / 32];
  const uint32_t* b = tile.bg[threadIdx.x / 32];
  bool changed = false;
#pragma unroll
  for (int down = 1; down >= 0; --down) {
    uint32_t g = 0, p = kFull;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int y = kRowsPerLane * lane + (down ? j : kRowsPerLane - 1 - j);
      g = r[y] | (b[y] & g);
      p &= b[y];
    }
    // inclusive scan in the fill's direction: compose the earlier lanes' maps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t g_prev = down ? __shfl_up_sync(kFull, g, off) : __shfl_down_sync(kFull, g, off);
      const uint32_t p_prev = down ? __shfl_up_sync(kFull, p, off) : __shfl_down_sync(kFull, p, off);
      if (down ? lane >= off : lane + off < 32) {
        g |= p & g_prev;
        p &= p_prev;
      }
    }
    const uint32_t g_prev = down ? __shfl_up_sync(kFull, g, 1) : __shfl_down_sync(kFull, g, 1);
    const uint32_t p_prev = down ? __shfl_up_sync(kFull, p, 1) : __shfl_down_sync(kFull, p, 1);
    const uint32_t edge = down ? halo.top : halo.bottom;
    uint32_t c = (down ? lane == 0 : lane == 31) ? edge : g_prev | (p_prev & edge);
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int y = kRowsPerLane * lane + (down ? j : kRowsPerLane - 1 - j);
      const uint32_t old = r[y];
      const uint32_t gen = old | (b[y] & c);
      if (gen != old) {
        r[y] = gen;
        changed = true;
      }
      c = gen;
    }
  }
  return changed;
}

// What a thread keeps of its tile between rounds: its row as device memory
// holds it, and the halo the tile was last closed under.
struct Kept {
  uint32_t stored[kTileWords];
  Halo halo;
};

__device__ __forceinline__ bool same(const Halo& a, const Halo& b) {
  return a.west == b.west && a.east == b.east && a.top == b.top && a.bottom == b.bottom;
}

// One round's work on a tile: close it under both passes given its halo and
// write back the words that changed. A block that owns one tile (`resident`)
// loads it once and keeps it in shared memory and `kept`, since no other
// block writes it; in later rounds it skips the tile while the halo has not
// grown, because the tile is then still closed. A block that owns several
// loads each anew. Returns, to every thread of the block, whether a word
// changed.
__device__ bool close_tile(Tile& tile, const uint32_t* bg, uint32_t* reached, const Geometry& g,
                           const Span& s, bool resident, bool first, Kept& kept) {
  const Halo halo = load_halo(reached, g, s);
  if (resident && !first) {
    // reached only grows, so a halo word that differs has grown
    if (!__syncthreads_or(!same(halo, kept.halo))) return false;
  } else {
    load_tile(tile, bg, reached, g, s, kept.stored);
  }
  kept.halo = halo;
  __syncthreads();
  for (int pass = 0;; ++pass) {
    const bool mine = (pass & 1) ? col_pass(tile, halo) : row_pass(tile, halo);
    // a pass that changes nothing leaves the tile closed under both
    if (!__syncthreads_or(mine) && pass > 0) break;
  }
  bool wrote = false;
  if (static_cast<int>(threadIdx.x) < s.rows) {
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) {
      const uint32_t now = tile.reached[j][threadIdx.x];
      if (j < s.nw && now != kept.stored[j]) {
        __stcg(reached + word_at(g, s.b, s.y0 + threadIdx.x, s.k0 + j), now);
        kept.stored[j] = now;
        wrote = true;
      }
    }
  }
  return __syncthreads_or(wrote);
}

// Flood entry: the tile's reached bits as int32. The words go through
// shared memory, one load each, so that the stores wait on no load; warp w
// writes rows y0 + w, y0 + w + kWarps, ..., 32 consecutive pixels a store.
__device__ void expand_tile(Tile& tile, const uint32_t* bg, const uint32_t* reached,
                            int* __restrict__ out, const Geometry& g, const Span& s) {
  uint32_t loaded[kTileWords];
  load_tile(tile, bg, reached, g, s, loaded);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x / 32; i < s.rows; i += kWarps) {
    int* row = out + (static_cast<size_t>(s.b) * g.height + s.y0 + i) * g.width;
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) {
      const int x = (s.k0 + j) * 32 + lane;
      if (x < g.width) row[x] = (tile.reached[j][i] >> lane) & 1u;
    }
  }
  __syncthreads();  // the words are read before the next tile's load
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Centroid entry: adds the tile's filled mass, sum of rows and sum of
// columns, valid & ~reached (reached is a subset of the background), into
// sums[3b .. 3b + 2].
__device__ void sum_tile(const uint32_t* reached, unsigned long long* sums, const Geometry& g,
                         const Span& s) {
  __shared__ unsigned long long partial[3][kWarps];
  const uint32_t last_valid = (g.width & 31) ? ((1u << (g.width & 31)) - 1u) : kFull;
  unsigned long long mass = 0, sum_y = 0, sum_x = 0;
  if (threadIdx.x < s.rows) {
    const int y = s.y0 + threadIdx.x;
    for (int j = 0; j < s.nw; ++j) {
      const int k = s.k0 + j;
      const uint32_t filled =
          (k == g.words - 1 ? last_valid : kFull) & ~__ldcg(reached + word_at(g, s.b, y, k));
      const unsigned count = __popc(filled);
      // sum of the set bits' indices: bit index i = sum_j 2^j [bit j of i]
      const unsigned bit_sum = __popc(filled & 0xAAAAAAAAu) + 2u * __popc(filled & 0xCCCCCCCCu)
          + 4u * __popc(filled & 0xF0F0F0F0u) + 8u * __popc(filled & 0xFF00FF00u)
          + 16u * __popc(filled & 0xFFFF0000u);
      mass += count;
      sum_y += static_cast<unsigned long long>(y) * count;
      sum_x += 32ull * k * count + bit_sum;
    }
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
  if (threadIdx.x < 3) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += partial[threadIdx.x][w];
    if (total != 0) atomicAdd(sums + 3 * s.b + threadIdx.x, total);
  }
  __syncthreads();  // partial is read before the next tile writes it
}

// state[0] is the round stamp (see the note at the top); the centroid entry
// adds its sums into state[1 ..]. `out` is null for the centroid entry and
// `centroid` for the flood entry.
__global__ void __launch_bounds__(kThreads)
tiled_flood_kernel(const uint8_t* __restrict__ mask, uint32_t* bg, uint32_t* reached,
             unsigned long long* state, int* out, float* centroid, Geometry g) {
  __shared__ Tile tile;
  cg::grid_group grid = cg::this_grid();
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) pack_tile(mask, bg, reached, g, span_of(t, g));
  grid.sync();
  // the grid is at most the tile count, so `resident` holds for every block
  // or for none
  const bool resident = g.tiles <= static_cast<int>(gridDim.x);
  Kept kept;
  for (unsigned long long round = 0;; ++round) {
    bool changed = false;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x)
      changed |= close_tile(tile, bg, reached, g, span_of(t, g), resident, round == 0, kept);
    if (changed && threadIdx.x == 0) atomicMax(state, round + 1);
    grid.sync();
    if (__ldcg(state) <= round) break;
  }
  if (out != nullptr) {
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x)
      expand_tile(tile, bg, reached, out, g, span_of(t, g));
    return;
  }
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) sum_tile(reached, state + 1, g, span_of(t, g));
  grid.sync();
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < g.batch; b += gridDim.x * kThreads) {
    const unsigned long long m = __ldcg(state + 1 + 3 * b);
    const double denom = static_cast<double>(m > 0 ? m : 1);
    centroid[2 * b] = static_cast<float>(static_cast<double>(__ldcg(state + 2 + 3 * b)) / denom);
    centroid[2 * b + 1] = static_cast<float>(static_cast<double>(__ldcg(state + 3 + 3 * b)) / denom);
  }
}

// Blocks of tiled_flood_kernel the current device holds at once, cached per device.
cudaError_t co_resident_blocks(int* blocks) {
  static int cached[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_flood_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (device < 64) cached[device] = *blocks;
  return cudaSuccess;
}

int launch(const void* mask, int* out, float* centroid, void* bg, void* reached, void* state,
           int batch, int height, int width, cudaStream_t stream) {
  Geometry g;
  g.batch = batch;
  g.height = height;
  g.width = width;
  g.words = (width + 31) / 32;
  g.tiles_y = (height + kTileRows - 1) / kTileRows;
  g.tiles_x = (g.words + kTileWords - 1) / kTileWords;
  g.tiles = batch * g.tiles_y * g.tiles_x;
  int blocks = 0;
  cudaError_t err = co_resident_blocks(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const uint8_t* mask_p = static_cast<const uint8_t*>(mask);
  uint32_t* bg_p = static_cast<uint32_t*>(bg);
  uint32_t* reached_p = static_cast<uint32_t*>(reached);
  unsigned long long* state_p = static_cast<unsigned long long*>(state);
  void* args[] = {&mask_p, &bg_p, &reached_p, &state_p, &out, &centroid, &g};
  err = cudaLaunchCooperativeKernel(tiled_flood_kernel, dim3(g.tiles < blocks ? g.tiles : blocks),
                                    dim3(kThreads), args, 0, stream);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, loaded with ctypes. `mask` is a contiguous (batch, height,
// width) bool (one byte, 0 or 1) device buffer; `bg` and `reached` are
// device scratch buffers of batch * height * ceil(width / 32) uint32 words;
// `state` is a zeroed device buffer of uint64: 1 for the flood entry, 1 + 3
// * batch for the centroid entry. state[0] ends as the number of rounds the
// flood took, minus one. `out` is a contiguous int32 buffer of the mask's
// shape; `centroid` a float32 buffer of batch * 2. Each entry is one
// cooperative launch on `stream` (a cudaStream_t), without synchronising,
// and returns the launch's CUDA error as an int (0 on success). batch,
// height and width are at least 1 and batch * height * width < 2**31.
extern "C" int flood_from_border_i32(const void* mask, void* out, void* bg, void* reached,
                                     void* state, int batch, int height, int width,
                                     void* stream) {
  return launch(mask, static_cast<int*>(out), nullptr, bg, reached, state, batch, height, width,
                static_cast<cudaStream_t>(stream));
}

extern "C" int filled_centroid_f32(const void* mask, void* centroid, void* bg, void* reached,
                                   void* state, int batch, int height, int width, void* stream) {
  return launch(mask, nullptr, static_cast<float*>(centroid), bg, reached, state, batch, height,
                width, static_cast<cudaStream_t>(stream));
}
