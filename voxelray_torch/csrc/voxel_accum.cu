// K1: SAT voxelizer for Hopper (sm_90a).
//
// Replaces the Pallas slab-accumulation kernel of
// voxelray_tpu/ops/pallas/voxel_accum.py (_make_kernel / _accum_call).
// The contract is the one of voxelize_mesh: for every triangle, every
// cell of its clamped reference window (VoxelBuilder.hpp:164-196) gets
// the 13-axis SAT; occupancy = any hit, set_calls = the exact hit total.
// The TPU kernel's scheme (host-planned lanes binned into z-slab images,
// a one-hot MXU matmul as the scatter-add, a scatter fallback for tall
// windows) exists because a TPU has no per-lane stores.  Hopper has them,
// so this kernel takes the vertices and faces themselves and stores
// straight into the occupancy volume.
//
// What bounds it on the H100: SAT arithmetic.  At the bench size (1.05M
// triangles, 512^3) a triangle's window holds ~36 cells on average (8 at
// the least), so ~38M SAT evaluations of up to ~350 float ops each, many
// of which exit early; the occupancy writes are scattered bytes into a
// 134 MB volume, and the triangle reads are ~25 MB.  Neither memory
// stream comes near the card's bandwidth.
//
// What the design does about it: the work is the flat list of (triangle,
// cell) slots, laid across the warp's lanes with no lane left idle inside
// a window.  A warp takes 32 consecutive triangles per round, one per
// lane: each lane loads its face (coalesced) and vertices, checks them
// and computes its window once, and stages them in shared memory; a
// shuffle scan of the window sizes gives each triangle's first slot.  The
// warp then walks the round's slots 32 at a time (64-bit running total:
// one window can hold 512^3 cells); each lane advances to the triangle
// that owns its slot and finds its cell with 32-bit index math (x
// fastest, the _chunk_hits unravel order).  A hit stores 1 to its
// occupancy byte: every writer stores the same value, so the race is
// benign.  Hits are counted per lane, reduced per warp with shuffles and
// added once per warp to a 64-bit counter; a face whose vertex index is
// out of range is skipped and counted in a second word, which the
// wrapper reads in the same sync as the hit total.  There is no
// window-size limit, so no fallback path.
//
// The window and the SAT are csrc/sat.cuh's, which the triangle accel's
// binning (tri_bin.cu) shares.
//
// Numerics: built with --fmad=false (see ops/kernels/_build.py) and
// without fast math, so every product and sum rounds separately, exactly
// like the plain PyTorch version (ops/voxelize.py + ops/sat.py, whose
// expression shapes this file follows term for term).  Occupancy and
// set_calls are then bit-equal to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sat.cuh"

// voxel_accum_launch's argument block (ops/kernels/voxel_accum.py).
// counts: two zeroed 64-bit words, the SAT hit total and the number of
// faces skipped for a vertex index outside [0, n_vert).
struct VoxelAccumArgs {
  const float* v;  // (n_vert, 3)
  const int* f;    // (n_tri, 3)
  int n_tri, n_vert;
  float ogx, ogy, ogz, vs, half;
  int nx, ny, nz;
  uint8_t* occ;  // (nz, ny, nx)
  unsigned long long* counts;
};

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;  // warps per block

// A warp's round of kWarp triangles, staged in shared memory: triangle j's
// vertices, its window's first cell and x, y extents, and its first slot
// in the round (first[kWarp] is the round's slot total).
struct Round {
  float v[kWarp][9];
  int start[kWarp][3];
  int wx[kWarp], wy[kWarp];
  long long first[kWarp + 1];
};

__global__ void __launch_bounds__(kThreads) voxel_accum_kernel(
    const float* __restrict__ v, const int* __restrict__ f, int n_tri,
    int n_vert, float ogx, float ogy, float ogz, float vs, float half, int nx,
    int ny, int nz, uint8_t* __restrict__ occ,
    unsigned long long* __restrict__ counts) {
  __shared__ Round s_round[kWarps];
  const int lane = threadIdx.x % kWarp;
  Round& rd = s_round[threadIdx.x / kWarp];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const long long n_rounds = (n_tri + kWarp - 1) / kWarp;
  unsigned long long hits = 0, bad = 0;

  for (long long round = warp; round < n_rounds; round += n_warps) {
    // this lane's triangle: face, vertices, window (size 0 if none)
    const long long t = round * kWarp + lane;
    long long cap = 0;
    if (t < n_tri) {
      const int i0 = __ldg(f + 3 * t), i1 = __ldg(f + 3 * t + 1),
                i2 = __ldg(f + 3 * t + 2);
      if (i0 < 0 || i0 >= n_vert || i1 < 0 || i1 >= n_vert || i2 < 0 ||
          i2 >= n_vert) {
        ++bad;
      } else {
        float* p = rd.v[lane];
        p[0] = __ldg(v + 3 * i0); p[1] = __ldg(v + 3 * i0 + 1);
        p[2] = __ldg(v + 3 * i0 + 2);
        p[3] = __ldg(v + 3 * i1); p[4] = __ldg(v + 3 * i1 + 1);
        p[5] = __ldg(v + 3 * i1 + 2);
        p[6] = __ldg(v + 3 * i2); p[7] = __ldg(v + 3 * i2 + 1);
        p[8] = __ldg(v + 3 * i2 + 2);
        // a triangle with a non-finite vertex gets an empty window
        if (all_finite9(p)) {
          int w[3];
          cap = sat_window(p, ogx, ogy, ogz, vs, nx, ny, nz, rd.start[lane],
                           w);
          rd.wx[lane] = w[0];
          rd.wy[lane] = w[1];
        }
      }
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
    // the round's slots, kWarp at a time: slot k of the round belongs to
    // the triangle j with first[j] <= k < first[j + 1], which only moves
    // forward as the lane's k grows
    const long long total = rd.first[kWarp];
    int j = 0;
    for (long long k = lane; k < total; k += kWarp) {
      while (k >= rd.first[j + 1]) ++j;
      // a window holds fewer than 2^31 cells (the wrapper checks the grid)
      const unsigned q = static_cast<unsigned>(k - rd.first[j]);
      const unsigned wx = rd.wx[j], wy = rd.wy[j];
      const unsigned row = q / wx;
      const int cx = rd.start[j][0] + static_cast<int>(q - row * wx);
      const int cy = rd.start[j][1] + static_cast<int>(row % wy);
      const int cz = rd.start[j][2] + static_cast<int>(row / wy);
      const float ccx = ogx + (static_cast<float>(cx) + 0.5f) * vs;
      const float ccy = ogy + (static_cast<float>(cy) + 0.5f) * vs;
      const float ccz = ogz + (static_cast<float>(cz) + 0.5f) * vs;
      if (tri_box_overlap(ccx, ccy, ccz, half, rd.v[j])) {
        occ[static_cast<long long>(cx) +
            static_cast<long long>(nx) *
                (cy + static_cast<long long>(ny) * cz)] = 1;
        ++hits;
      }
    }
    __syncwarp();  // the next round overwrites the staged triangles
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, off);
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  }
  if (lane == 0) {
    if (hits) atomicAdd(counts, hits);
    if (bad) atomicAdd(counts + 1, bad);
  }
}

}  // namespace

extern "C" int voxel_accum_launch(const VoxelAccumArgs* a, void* stream) {
  if (a->n_tri <= 0) return 0;
  const long long rounds = (a->n_tri + kWarp - 1) / kWarp;
  long long blocks = (rounds + kWarps - 1) / kWarps;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  voxel_accum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a->v, a->f, a->n_tri, a->n_vert, a->ogx, a->ogy, a->ogz, a->vs,
      a->half, a->nx, a->ny, a->nz, a->occ, a->counts);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void voxel_accum_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(VoxelAccumArgs));
}

extern "C" const char* voxelray_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
