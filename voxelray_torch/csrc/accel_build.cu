// accel_build: a voxel scene's brick accel tables and its AABB list, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds a grid's BrickAccel with
// XLA ops (voxelray_tpu/ops/traverse_fast.py build_accel,
// voxelray_tpu/ops/pallas/mega_trace.py build_fine_sb) and its AABBs with
// its aabbs_from_linear, and the port did so with ~60 PyTorch ops, a numpy
// index table and a host copy of it.  A scene whose mesh deforms every
// frame rebuilds all of it every frame, so the build became two kernels:
//
//   accel_words_kernel  one pass over the (Z, Y, X) occupancy: every word
//                       of `fine` (16, NB) and of the superbrick tiles' word
//                       rows, every word of `coarse`, and `l2` zeroed
//   accel_tiles_kernel  from `coarse`: each superbrick tile's
//                       brick-occupancy row (and its zero rows, and the
//                       words of its bricks past the grid's edge), and the
//                       bits of `l2`
//   aabb_boxes_kernel   the (N, 6) float32 boxes of N linear cell indices
//
// Every table equals the PyTorch build's (ops/traverse_fast.py: _bricks,
// _fine_words, _bitmask_rows, _l2, ops/kernels/mega_trace.build_fine_sb)
// bit for bit; words are the uint32 patterns the int32 tensors hold.  A
// cell is any nonzero byte.  Brick b = bx_i + bx * (by_i + by * bz_i); its
// cell bit x + 8 y + 64 z, x fastest, so word w of a brick is the four
// 8-cell x-rows (z0 + w / 2, y0 + 4 (w % 2) + k), k = 0..3, byte k the row.
//
// What bounds it on the H100: memory.  At the deforming cell's 491x245x512
// grid the occupancy is 61.6 MB, `fine` 7.9 MB and the tiles 9.4 MB, ~79 MB
// read or written once, ~24 us at 3.35 TB/s.  What the design does:
//  - a warp takes 32 consecutive bricks, a lane one brick (32 / warp width
//    bricks on the host build's one-lane warps), word by word, so a warp
//    reads 32 neighbouring 8-byte x-rows (256 contiguous bytes of a row)
//    at a time and writes 32 neighbouring words of `fine`, and runs of 8 of
//    a tile's;
//  - an 8-cell x-row is read as the one or two aligned 8-byte words that
//    hold it (rows are not 8-byte aligned: 491 cells) and becomes its
//    word's byte by arithmetic, a byte's "nonzero" flag gathered by one
//    multiply; cells past the row's end are masked off;
//  - the warp's 32 bricks are one word of `coarse`: each lane's bricks'
//    bits are or-ed over the warp by shuffles and lane 0 writes the word,
//    so `coarse` needs no zeroing and no atomics;
//  - the second pass reads only `coarse` (16 KB): a tile's 16
//    brick-occupancy words from 64 runs of 8 bits, `l2` by atomicOr of the
//    nonzero ones into the words the first pass zeroed.
// The boxes are one thread a box, the float32 expressions of
// ops/aabbs.aabbs_from_cells in its order: --fmad=false keeps each product
// and sum rounded on its own, so they are bit-equal.
#include <cuda_runtime.h>
#include <stdint.h>

// The argument blocks, which ops/kernels/accel_build.py mirrors as ctypes
// structures; each launcher takes one by pointer.  (At namespace scope: a
// launcher with C linkage must not take a type of internal linkage.)

// The brick accel of a (nz, ny, nx) occupancy: bricks bx * by * bz = nb,
// superbricks (8^3 bricks) sbx * sby * sbz; `coarse` coarse_words words,
// `l2` l2_words (each whole rows of 128, at least one); tiles null where
// the accel carries no superbrick tiles.
struct AccelArgs {
  const uint8_t* occ;
  int nx, ny, nz;
  int bx, by, bz;
  int sbx, sby, sbz;
  int nb, coarse_words, l2_words;
  uint32_t* fine;    // (16, nb), word-major
  uint32_t* coarse;  // (coarse_words,)
  uint32_t* l2;      // (l2_words,)
  uint32_t* tiles;   // (sbx * sby * sbz, 72, 128) or null
};

// The boxes of n linear cell indices of an (nx, ny, ...) grid at origin
// (ogx, ogy, ogz), cell vs, half = vs / 2 (both rounded to float32).
struct BoxArgs {
  const long long* lin;  // (n,)
  int n, nx, ny;
  float ogx, ogy, ogz, vs, half;
  float* boxes;  // (n, 6): min xyz, max xyz
};

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 256;
constexpr int kWordRows = 64 * 128;       // a tile's word rows, in words
constexpr int kTile = 72 * 128;           // a tile, in words
constexpr int kTileJobs = 1024 + 512;     // rows 64-71, then its bricks

// The 8 cells x0 .. x0 + 7 of the x-row at `row` as one byte, bit j the
// cell x0 + j; cells at or past nx are empty.  Reads the aligned 8-byte
// words that hold the row's bytes (a word holding a byte of the tensor
// lies in its allocation's pages).
__device__ __forceinline__ uint32_t row_byte(const uint8_t* row, int x0,
                                             int nx) {
  const int n = min(8, nx - x0);
  const uint8_t* p = row + x0;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 7);
  const unsigned long long* q =
      reinterpret_cast<const unsigned long long*>(p - a);
  unsigned long long v = __ldg(q) >> (8 * a);
  if (a + n > 8) v |= __ldg(q + 1) << (64 - 8 * a);
  if (n < 8) v &= (1ull << (8 * n)) - 1;
  // a byte's high bit set where the byte is nonzero
  const unsigned long long lo7 = 0x7F7F7F7F7F7F7F7Full;
  const unsigned long long f =
      (((v & lo7) + lo7) | v) & 0x8080808080808080ull;
  // flag j at bit 8j + 7 -> bit j of the top byte: the products of the
  // flags land on distinct bits, so nothing carries
  return static_cast<uint32_t>(((f >> 7) * 0x0102040810204080ull) >> 56);
}

// Word w of the brick whose first cell is (x0, y0, z0).
__device__ __forceinline__ uint32_t brick_word(const AccelArgs& a, int x0,
                                               int y0, int z0, int w) {
  const int z = z0 + (w >> 1);
  if (z >= a.nz) return 0;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = y0 + 4 * (w & 1) + k;
    if (y < a.ny)
      word |= row_byte(a.occ + (static_cast<long long>(z) * a.ny + y) * a.nx,
                       x0, a.nx)
              << (8 * k);
  }
  return word;
}

// Pass 1: warp g takes bricks 32g .. 32g + 31, `coarse` word g.  Launched
// with coarse_words whole warps (at least l2_words threads: n_sb <= nb).
__global__ void __launch_bounds__(kThreads)
    accel_words_kernel(const AccelArgs a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < a.l2_words) a.l2[t] = 0;
  const long long g = t / kWarp;
  const int lane = static_cast<int>(t % kWarp);
  if (g >= a.coarse_words) return;  // the whole warp
  uint32_t bits = 0;
  for (int i = lane; i < 32; i += kWarp) {
    const long long b = g * 32 + i;
    if (b >= a.nb) break;
    const int bxi = static_cast<int>(b % a.bx);
    const int byi = static_cast<int>((b / a.bx) % a.by);
    const int bzi = static_cast<int>(b / (static_cast<long long>(a.bx) * a.by));
    uint32_t* tile = nullptr;
    if (a.tiles) {
      const long long s =
          (bxi >> 3) + a.sbx * ((byi >> 3) + static_cast<long long>(a.sby) *
                                                 (bzi >> 3));
      tile = a.tiles + s * kTile + (bxi & 7) + 8 * (byi & 7) +
             64 * (bzi & 7);
    }
    uint32_t any = 0;
    for (int w = 0; w < 16; ++w) {
      const uint32_t word = brick_word(a, 8 * bxi, 8 * byi, 8 * bzi, w);
      a.fine[w * static_cast<long long>(a.nb) + b] = word;
      if (tile) tile[w * 512] = word;
      any |= word;
    }
    if (any) bits |= 1u << i;
  }
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1)
    bits |= __shfl_xor_sync(0xffffffffu, bits, off);
  if (lane == 0) a.coarse[g] = bits;
}

// Word j of superbrick s's brick-occupancy row: its bricks 32j .. 32j + 31
// (local x fastest: z 8 sz + j / 2, y 8 sy + 4 (j % 2) + k, x 8 sx ..
// 8 sx + 7), read from `coarse`; bricks past the grid's edge are empty.
__device__ __forceinline__ uint32_t occupancy_word(const AccelArgs& a, int s,
                                                   int j) {
  const int sx = s % a.sbx, sy = (s / a.sbx) % a.sby;
  const int sz = s / (a.sbx * a.sby);
  const int gz = 8 * sz + (j >> 1);
  if (gz >= a.bz) return 0;
  const int gx = 8 * sx;
  const int n = min(8, a.bx - gx);  // the row's bricks inside the grid
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int gy = 8 * sy + 4 * (j & 1) + k;
    if (gy >= a.by) continue;
    // bits b .. b + n - 1 of coarse
    const long long b =
        gx + a.bx * (gy + static_cast<long long>(a.by) * gz);
    const int sh = static_cast<int>(b & 31);
    unsigned long long v = a.coarse[b >> 5];
    if (sh + n > 32)
      v |= static_cast<unsigned long long>(a.coarse[(b >> 5) + 1]) << 32;
    word |= static_cast<uint32_t>((v >> sh) & ((1u << n) - 1)) << (8 * k);
  }
  return word;
}

// Pass 2, after pass 1.  With tiles: kTileJobs threads a superbrick, the
// first 1024 its rows 64-71 (row 64's lanes 0-15 the brick-occupancy
// words, the rest zero), the next 512 its local bricks, each writing the
// zero words of a brick past the grid's edge.  Without: 16 a superbrick,
// the occupancy words, for `l2` alone.
__global__ void __launch_bounds__(kThreads)
    accel_tiles_kernel(const AccelArgs a) {
  const int per = a.tiles ? kTileJobs : 16;
  const long long n_sb = static_cast<long long>(a.sbx) * a.sby * a.sbz;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_sb * per) return;
  const int s = static_cast<int>(t / per), k = static_cast<int>(t % per);
  uint32_t* tile = a.tiles ? a.tiles + static_cast<long long>(s) * kTile
                           : nullptr;
  if (k < 1024) {
    uint32_t word = 0;
    if (k < 16) {
      word = occupancy_word(a, s, k);
      if (word) atomicOr(a.l2 + (s >> 5), 1u << (s & 31));
    }
    if (tile) tile[kWordRows + k] = word;
    return;
  }
  const int bl = k - 1024;
  const int sx = s % a.sbx, sy = (s / a.sbx) % a.sby;
  const int sz = s / (a.sbx * a.sby);
  if (8 * sx + (bl & 7) < a.bx && 8 * sy + ((bl >> 3) & 7) < a.by &&
      8 * sz + (bl >> 6) < a.bz)
    return;  // pass 1 wrote its words
  for (int w = 0; w < 16; ++w) tile[w * 512 + bl] = 0;
}

__global__ void __launch_bounds__(kThreads)
    aabb_boxes_kernel(const BoxArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long lin = a.lin[i];
  const float x = static_cast<float>(lin % a.nx);
  const float y = static_cast<float>((lin / a.nx) % a.ny);
  const float z =
      static_cast<float>(lin / (static_cast<long long>(a.nx) * a.ny));
  const float cx = a.ogx + (x + 0.5f) * a.vs;
  const float cy = a.ogy + (y + 0.5f) * a.vs;
  const float cz = a.ogz + (z + 0.5f) * a.vs;
  float* out = a.boxes + 6 * i;
  out[0] = cx - a.half;
  out[1] = cy - a.half;
  out[2] = cz - a.half;
  out[3] = cx + a.half;
  out[4] = cy + a.half;
  out[5] = cz + a.half;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Both passes, in stream order; returns the first launch's error.
extern "C" int accel_build_launch(const AccelArgs* a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  accel_words_kernel<<<blocks_for(static_cast<long long>(a->coarse_words) *
                                  kWarp),
                       kThreads, 0, st>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_sb = static_cast<long long>(a->sbx) * a->sby * a->sbz;
  if (n_sb == 0) return 0;
  accel_tiles_kernel<<<blocks_for(n_sb * (a->tiles ? kTileJobs : 16)),
                       kThreads, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aabb_boxes_launch(const BoxArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  aabb_boxes_kernel<<<blocks_for(a->n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the two argument blocks, which the wrapper's ctypes structures
// must match.
extern "C" void accel_build_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(AccelArgs));
  out[1] = static_cast<int>(sizeof(BoxArgs));
}
