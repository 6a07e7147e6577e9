// tri_bin: the triangle accel's binning for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package bins a triangle accel's
// triangles with its voxelizer's bucket plan and hit mask
// (voxelray_tpu/ops/tri_accel.py:95-121), and the port did so with the
// plain PyTorch hit stream (ops/voxelize.tri_cell_pairs), ~200 ms of
// plain stream a build at 1M triangles.  A mesh that deforms every
// frame rebuilds its accel every frame, so the binning became a kernel.
//
// The contract is ops/voxelize.hit_stream's: every (triangle, cell) pair
// whose SAT passes inside the triangle's clamped window of the tri grid,
// in serial emission order (triangle order, then z, y, x within the
// window).  Two passes over the same windows with the same SAT:
//
//   tri_bin_count_kernel  each triangle's hit count, each cell's hit
//                         count (global atomics), and the triangles with a
//                         coordinate outside the caller's box (or not a
//                         number), one 64-bit word
//   tri_bin_emit_kernel   given the inclusive scan of the triangles' counts
//                         (the wrapper's), each triangle's pairs at its
//                         offset in window order: a ballot over the warp's
//                         hits and a running count a triangle in shared
//                         memory give each hit its serial rank
//
// Between them the wrapper reads the sizes (the pair total, and the
// cell counts' nonempty cells, widest cell and overflows) in one copy.
//
// What bounds it on the H100: the SAT arithmetic, as in K1: at the
// deforming knot's size (1.05M triangles, a 256-cell tri grid) ~12M
// window cells a pass of up to ~270 float operations each, many of which
// exit early; the pairs (~3M, 8 bytes each) and the triangle rows (38 MB)
// are small beside the card's bandwidth.  The design is K1's: a warp takes
// 32 consecutive triangles a round, one a lane, stages them in shared
// memory, and lays the round's window cells over its lanes with no lane
// idle inside a window (voxel_accum.cu's comment).  The window and the SAT
// are csrc/sat.cuh's, K1's own.
//
// Numerics: --fmad=false and no fast math, as every kernel of the port:
// the pairs are bit-equal to the plain version's (ops/kernels/tri_bin.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sat.cuh"

// Both passes' argument block (ops/kernels/tri_bin.py): BinArgs' fields,
// the other pass's outputs null.
struct TriBinArgs {
  const float* tri;
  int n_tri;
  float ogx, ogy, ogz, vs, half;
  int nx, ny, nz;
  float lox, loy, loz, hix, hiy, hiz;
  int* tri_count;
  int* cell_count;
  unsigned long long* outside;
  const long long* cum;
  int* pair_tri;
  int* pair_lin;
};

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;  // warps per block

struct BinArgs {
  const float* tri;          // (n_tri, 9) float32 rows v0 | v1 | v2
  int n_tri;
  float ogx, ogy, ogz, vs, half;
  int nx, ny, nz;
  float lox, loy, loz, hix, hiy, hiz;  // the caller's box
  int* tri_count;            // count: (n_tri,) int32
  int* cell_count;           // count: (nx * ny * nz,) int32, zeroed
  unsigned long long* outside;  // count: one zeroed word
  const long long* cum;      // emit: inclusive scan of tri_count
  int* pair_tri;             // emit: (pairs,) int32
  int* pair_lin;             // emit: (pairs,) int32
};

// A warp's round of kWarp triangles, staged in shared memory: triangle j's
// vertices, its window's first cell and x, y extents, its first slot in
// the round (first[kWarp] is the round's slot total), its hits so far
// and, in the emit pass, its first pair.
struct Round {
  float v[kWarp][9];
  int start[kWarp][3];
  int wx[kWarp], wy[kWarp];
  long long first[kWarp + 1];
  int hits[kWarp];
  long long out[kWarp];
};

__device__ __forceinline__ bool in_box(const BinArgs& a, const float* p) {
  bool in = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = p[3 * c], y = p[3 * c + 1], z = p[3 * c + 2];
    in = in && x >= a.lox && x <= a.hix && y >= a.loy && y <= a.hiy &&
         z >= a.loz && z <= a.hiz;
  }
  return in;
}

// Stage this lane's triangle t of the round (its window empty if none or
// if a vertex is not finite) and scan the round's window sizes: returns
// the round's slot total.  Counts the triangle in *outside when it leaves
// the caller's box.
template <bool kEmit>
__device__ __forceinline__ long long stage(const BinArgs& a, Round& rd,
                                           int lane, long long t,
                                           unsigned long long* outside) {
  long long cap = 0;
  rd.hits[lane] = 0;
  if (t < a.n_tri) {
    float* p = rd.v[lane];
#pragma unroll
    for (int i = 0; i < 9; ++i) p[i] = __ldg(a.tri + 9 * t + i);
    if (!kEmit && !in_box(a, p)) ++*outside;
    if (all_finite9(p)) {
      int w[3];
      cap = sat_window(p, a.ogx, a.ogy, a.ogz, a.vs, a.nx, a.ny, a.nz,
                       rd.start[lane], w);
      rd.wx[lane] = w[0];
      rd.wy[lane] = w[1];
    }
    if (kEmit) rd.out[lane] = t ? a.cum[t - 1] : 0;
  }
  // exclusive scan of the window sizes over the warp
  long long incl = cap;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  rd.first[lane] = incl - cap;
  if (lane == kWarp - 1) rd.first[kWarp] = incl;
  __syncwarp();
  return rd.first[kWarp];
}

// Slot k of the round, in triangle j's window: its cell and the SAT.
__device__ __forceinline__ bool slot_hit(const BinArgs& a, const Round& rd,
                                         int j, long long k, int* lin) {
  // a window holds fewer than 2^31 cells (the wrapper checks the grid)
  const unsigned q = static_cast<unsigned>(k - rd.first[j]);
  const unsigned wx = rd.wx[j], wy = rd.wy[j];
  const unsigned row = q / wx;
  const int cx = rd.start[j][0] + static_cast<int>(q - row * wx);
  const int cy = rd.start[j][1] + static_cast<int>(row % wy);
  const int cz = rd.start[j][2] + static_cast<int>(row / wy);
  const float ccx = a.ogx + (static_cast<float>(cx) + 0.5f) * a.vs;
  const float ccy = a.ogy + (static_cast<float>(cy) + 0.5f) * a.vs;
  const float ccz = a.ogz + (static_cast<float>(cz) + 0.5f) * a.vs;
  *lin = cx + a.nx * (cy + a.ny * cz);
  return tri_box_overlap(ccx, ccy, ccz, a.half, rd.v[j]);
}

__global__ void __launch_bounds__(kThreads)
    tri_bin_count_kernel(const BinArgs a) {
  __shared__ Round s_round[kWarps];
  const int lane = threadIdx.x % kWarp;
  Round& rd = s_round[threadIdx.x / kWarp];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const long long n_rounds = (a.n_tri + kWarp - 1) / kWarp;
  unsigned long long outside = 0;
  for (long long round = warp; round < n_rounds; round += n_warps) {
    const long long t = round * kWarp + lane;
    const long long total = stage<false>(a, rd, lane, t, &outside);
    // the round's slots, kWarp at a time; slot k's triangle j only moves
    // forward as the lane's k grows
    int j = 0;
    for (long long k = lane; k < total; k += kWarp) {
      while (k >= rd.first[j + 1]) ++j;
      int lin;
      if (slot_hit(a, rd, j, k, &lin)) {
        atomicAdd(&rd.hits[j], 1);
        atomicAdd(a.cell_count + lin, 1);
      }
    }
    __syncwarp();
    if (t < a.n_tri) a.tri_count[t] = rd.hits[lane];
    __syncwarp();  // the next round overwrites the staged triangles
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    outside += __shfl_down_sync(0xffffffffu, outside, off);
  if (lane == 0 && outside) atomicAdd(a.outside, outside);
}

__global__ void __launch_bounds__(kThreads)
    tri_bin_emit_kernel(const BinArgs a) {
  __shared__ Round s_round[kWarps];
  const int lane = threadIdx.x % kWarp;
  Round& rd = s_round[threadIdx.x / kWarp];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const long long n_rounds = (a.n_tri + kWarp - 1) / kWarp;
  // the lanes up to and including this one; below it
  const unsigned upto = static_cast<unsigned>((2ull << lane) - 1ull);
  const unsigned below = upto >> 1;
  for (long long round = warp; round < n_rounds; round += n_warps) {
    const long long total = stage<true>(a, rd, lane, round * kWarp + lane,
                                        nullptr);
    // the round's slots in passes of kWarp, every lane in every pass: a
    // pass's hits of triangle j take the ranks after its earlier passes'
    // (hits[j]), in lane order
    int j = 0;
    for (long long base = 0; base < total; base += kWarp) {
      const long long k = base + lane;
      const bool valid = k < total;
      bool hit = false;
      int lin = 0;
      if (valid) {
        while (k >= rd.first[j + 1]) ++j;
        hit = slot_hit(a, rd, j, k, &lin);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      // this pass's lanes in triangle j's window: from lo to the last
      const int lo = valid ? static_cast<int>(
                                 rd.first[j] > base ? rd.first[j] - base : 0)
                           : 0;
      const unsigned mine = ballot & ~((1u << lo) - 1u);
      if (hit) {
        const long long at = rd.out[j] + rd.hits[j] + __popc(mine & below);
        a.pair_tri[at] = static_cast<int>(round * kWarp + j);
        a.pair_lin[at] = lin;
      }
      const bool last =
          valid && (lane == kWarp - 1 || k + 1 >= rd.first[j + 1]);
      __syncwarp();
      if (last) rd.hits[j] += __popc(mine & upto);
      __syncwarp();
    }
    __syncwarp();  // the next round overwrites the staged triangles
  }
}

// The kernels' arguments from the entry points' block.
BinArgs bin_args(const TriBinArgs& b) {
  BinArgs a;
  a.tri = b.tri;
  a.n_tri = b.n_tri;
  a.ogx = b.ogx; a.ogy = b.ogy; a.ogz = b.ogz; a.vs = b.vs; a.half = b.half;
  a.nx = b.nx; a.ny = b.ny; a.nz = b.nz;
  a.lox = b.lox; a.loy = b.loy; a.loz = b.loz;
  a.hix = b.hix; a.hiy = b.hiy; a.hiz = b.hiz;
  a.tri_count = b.tri_count;
  a.cell_count = b.cell_count;
  a.outside = b.outside;
  a.cum = b.cum;
  a.pair_tri = b.pair_tri;
  a.pair_lin = b.pair_lin;
  return a;
}

unsigned blocks_of(int n_tri) {
  const long long rounds = (n_tri + kWarp - 1) / kWarp;
  long long blocks = (rounds + kWarps - 1) / kWarps;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

}  // namespace

// The count pass: tri_count (n_tri,) int32 written; cell_count (nx*ny*nz,)
// int32 and outside (one 64-bit word) zeroed by the caller, added to.
extern "C" int tri_bin_count_launch(const TriBinArgs* b, void* stream) {
  if (b->n_tri <= 0) return 0;
  tri_bin_count_kernel<<<blocks_of(b->n_tri), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(bin_args(*b));
  return static_cast<int>(cudaGetLastError());
}

// The emit pass: cum the inclusive scan of the count pass's tri_count
// (int64), pair_tri and pair_lin (cum[n_tri - 1],) int32 written.
extern "C" int tri_bin_emit_launch(const TriBinArgs* b, void* stream) {
  if (b->n_tri <= 0) return 0;
  tri_bin_emit_kernel<<<blocks_of(b->n_tri), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(bin_args(*b));
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void tri_bin_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(TriBinArgs));
}
