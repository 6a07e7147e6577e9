// tri_march: the whole tri-grid march of one triangle trace in one launch,
// for Hopper.
//
// Replaces, on the triangle path, the TPU kernels the JAX march drives lap
// by lap: K3's brick walk (voxelray_tpu/ops/pallas/grid_walk.py,
// coarse_walk :496 and coarse_walk_init :569), K4's per-voxel walk
// (voxelray_tpu/ops/pallas/brick_fine.py, fine_walk_multi :296) and the
// lap glue between them (voxelray_tpu/ops/tri_accel.py:242-320: the
// staged trace per lap, the gather of each ray's cell row, Moller-Trumbore,
// the advance).  The port's plain march (ops/kernels/tri_march.py,
// tri_march_plain) runs the same laps as tensor ops launched from the
// host; this kernel gives its (t, id, u, v) bit for bit.
//
// One thread holds one ray through every lap, its state in registers:
//  1. round 0: the cell holding o + d * t_min, its triangle row tested with
//     t_lo = t_min and the cell's exit as the upper bound;
//  2. laps (at most nx + ny + nz + 4): the first accepted cell after t_cur
//     along the staged walk -- K3's fused init from t_cur, then groups of
//     K3 brick steps collecting k_first (later k_drain) occupied bricks,
//     K4 over each collected brick, a group ending with a candidate ending
//     the search (a K4 call of the staged trace) -- then Moller-Trumbore
//     over that cell's row in ascending id, accepting hits inside the
//     cell's t-span; without a hit t_cur moves to the span's midpoint (one
//     float up where that does not move it) and the ray marches on until
//     t_cur passes t_max.
// A ray still active after its lap bound adds one to `unresolved` (0 by
// construction).  The walks are brick_walk.cuh's (staged_first_cell, the
// staged trace of one ray), shared with K3, K4 and staged_march.
//
// What bounds it on the H100: the latency of the longest rays, not
// bandwidth or arithmetic.  Each lap is a dependent chain: brick words, a
// fine word per cell, the cell's row of cell_tris (<= l_width ids) and
// 36 bytes of tri9 per triangle; most rays stop within a few laps, a few
// run ~100 (on the bench frame the longest ray alone takes ~1 ms).  The
// design: no intermediate tensors and no host round trips between laps
// (the lap loop's ~150 launches and a host sync per lap); persistent
// warps whose lanes take a new ray after every lap once theirs is done,
// so lanes do not idle behind the longest ray of their warp or block (on
// the bench frame this beat one thread per ray and warps taking 32-ray
// batches, PERF.md); a row's triangles loaded kRowChunk at a time, their loads
// in flight together; the superbrick mask and, when it fits the 48 KB
// default shared memory together with it, the brick mask copied into
// shared memory once per block; fine, cell_slot, cell_tris and tri9 read
// through the read-only path (at res 256 cell_tris and tri9 are ~74 MB,
// more than the 50 MB L2, but rays come in render_image's 8x128 tile
// order, so neighbouring lanes walk the same bricks and read the same
// rows).
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py); every constant is a float literal, as the plain
// version's float32 tensors round Python scalars; sums are taken left to
// right as ops/intersect._dot, cross products as _cross, the direction's
// inverse is one IEEE reciprocal (as `1.0 / d`), and min/max propagate NaN.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

namespace {

constexpr int kThreads = 128;

// Moller-Trumbore of the ray against triangle v = (v0 | v1 | v2), with
// hit_triangles' expressions (ops/intersect.py:95-124): whether it hits
// with t_lo < t < r.t_hi and t <= span_hi, and (t, u, v).
__device__ __forceinline__ bool tri_hit(const Ray& r, const float* v,
                                        float t_lo, float span_hi, float& t,
                                        float& u, float& w) {
  const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
  const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = (e1x * px + e1y * py) + e1z * pz;
  const bool ok = fabsf(det) > 1e-8f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float sx = r.ox - v[0], sy = r.oy - v[1], sz = r.oz - v[2];
  u = ((sx * px + sy * py) + sz * pz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  w = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det;
  return ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > t_lo &&
         t < r.t_hi && t <= span_hi;
}

// A row's triangles are loaded kRowChunk at a time before any of them is
// tested, so that their loads are in flight together instead of one chain
// of id load, vertex loads and test per triangle
constexpr int kRowChunk = 4;

// Moller-Trumbore over row `slot` of cell_tris (ids ascending, -1 pads
// last): the nearest hit with t_lo < t < r.t_hi and t <= span_hi, ties to
// the lowest id.  Returns whether there is one, in (t, id, u, v).
__device__ __forceinline__ bool row_test(
    const Ray& r, const int* __restrict__ cell_tris,
    const float* __restrict__ tri9, int slot, int l_width, float t_lo,
    float span_hi, float& t_out, int& id_out, float& u_out, float& v_out) {
  float best = __int_as_float(0x7f800000);
  int best_id = -1;
  float best_u = 0.0f, best_v = 0.0f;
  const int* row = cell_tris + static_cast<size_t>(slot) * l_width;
  bool more = true;
  for (int j0 = 0; j0 < l_width && more; j0 += kRowChunk) {
    int ids[kRowChunk];
    float tv[kRowChunk][9];
#pragma unroll
    for (int k = 0; k < kRowChunk; ++k)
      ids[k] = j0 + k < l_width ? __ldg(row + j0 + k) : -1;
#pragma unroll
    for (int k = 0; k < kRowChunk; ++k)
#pragma unroll
      for (int c = 0; c < 9; ++c)
        tv[k][c] = ids[k] >= 0
                       ? __ldg(tri9 + static_cast<size_t>(ids[k]) * 9 + c)
                       : 0.0f;
#pragma unroll
    for (int k = 0; k < kRowChunk; ++k) {
      if (ids[k] < 0) {
        more = false;
        break;
      }
      float t, u, v;
      if (tri_hit(r, tv[k], t_lo, span_hi, t, u, v) && t < best) {
        best = t;
        best_id = ids[k];
        best_u = u;
        best_v = v;
      }
    }
  }
  if (best_id < 0) return false;
  t_out = best;
  id_out = best_id;
  u_out = best_u;
  v_out = best_v;
  return true;
}

// Everything one trace reads and writes.  o, d: (n, 3); t_min, t_max:
// (n,); coarse (coarse_words), l2 (l2_words, null for one level), fine
// (16, nb): the tri grid's brick accel; cell_slot (n_cells + 1), cell_tris
// (rows, l_width), tri9 (F + 1, 9), tri_origin (3): the tri accel.  tg is
// the tri grid, its origin read from tri_origin in the kernel.  Outputs t,
// id, u, v (n,) (+inf, -1, 0, 0 on a miss); *unresolved counts the rays
// left at the lap bound; next_ray is the zeroed counter from which the
// warps take their rays.
struct MarchArgs {
  const float *o, *d, *t_min, *t_max;
  const uint32_t *coarse, *l2, *fine;
  const int *cell_slot, *cell_tris;
  const float *tri9, *tri_origin;
  int coarse_words, coarse_smem, l2_words, n, nz, l_width, max_laps;
  WalkGrid wg;
  FineGrid fg, tg;
  Schedule sc;
  float* t_out;
  int* id_out;
  float *u_out, *v_out;
  unsigned long long* unresolved;
  int* next_ray;
};

// One ray's march between laps: the ray, t_cur and the laps run.
struct March {
  Ray r;
  float t_cur;
  int lap;
};

__device__ __forceinline__ void write_hit(const MarchArgs& a, int i, float t,
                                          int id, float u, float v) {
  a.t_out[i] = t;
  a.id_out[i] = id;
  a.u_out[i] = u;
  a.v_out[i] = v;
}

// Starts ray i: loads it and runs round 0, the cell holding the start
// point o + d * t_min.  Returns true when that ends the ray (a hit, written).
__device__ __forceinline__ bool march_start(const MarchArgs& a,
                                            const FineGrid& tg, int i,
                                            March& m) {
  const float tmin = a.t_min[i];
  m.r = load_ray(a.o, a.d, i, tmin, a.t_max[i]);
  set_tie_eps(m.r, a.fg);
  m.t_cur = tmin;
  m.lap = 0;
  const Ray& r = m.r;
  const int c0x = floor_cell(((r.ox + r.dx * tmin) - tg.ogx) / tg.vs);
  const int c0y = floor_cell(((r.oy + r.dy * tmin) - tg.ogy) / tg.vs);
  const int c0z = floor_cell(((r.oz + r.dz * tmin) - tg.ogz) / tg.vs);
  if (c0x < 0 || c0x >= tg.nx || c0y < 0 || c0y >= tg.ny || c0z < 0 ||
      c0z >= a.nz)
    return false;
  const int slot = __ldg(a.cell_slot + c0x + tg.nx * (c0y + tg.ny * c0z));
  if (slot < 0) return false;
  float t0, t1, t, u, v;
  int id;
  cell_slab(r, tg, c0x, c0y, c0z, t0, t1);
  if (!row_test(r, a.cell_tris, a.tri9, slot, a.l_width, tmin,
                t1 * 1.000001f + 1e-7f, t, id, u, v))
    return false;
  write_hit(a, i, t, id, u, v);
  return true;
}

// One lap of ray i: the next nonempty cell, its triangle row, the advance.
// Returns true when the ray is done (its outputs written): a hit, no next
// cell, t_cur past t_max, or the lap bound (counted as unresolved;
// max_laps >= 1).
__device__ __forceinline__ bool march_lap(const MarchArgs& a,
                                          const FineGrid& tg,
                                          const uint32_t* s_l2,
                                          const uint32_t* cmask, int i,
                                          March& m) {
  const float inf = __int_as_float(0x7f800000);
  m.r.t_lo = m.t_cur;
  Staged s;
  staged_first_cell<false>(m.r, a.wg, a.fg, s_l2, cmask, a.fine, a.sc, s);
  const int lin = s.lin;
  bool done = lin < 0;
  if (!done) {
    float t0, t1, t, u, v;
    int id;
    cell_slab(m.r, tg, lin % tg.nx, (lin / tg.nx) % tg.ny,
              lin / (tg.nx * tg.ny), t0, t1);
    const int slot = max(__ldg(a.cell_slot + lin), 0);
    if (row_test(m.r, a.cell_tris, a.tri9, slot, a.l_width,
                 jmax(m.t_cur, t0 * 0.999999f - 1e-7f),
                 t1 * 1.000001f + 1e-7f, t, id, u, v)) {
      write_hit(a, i, t, id, u, v);
      return true;
    }
    // advance to the tested cell's midpoint, never backward (one float up
    // where a span of length 0 does not move it)
    const float mid = 0.5f * (t0 + t1);
    m.t_cur = mid > m.t_cur ? mid : nextafterf(m.t_cur, inf);
    done = !(m.t_cur <= m.r.t_hi);
    if (!done && ++m.lap == a.max_laps) {
      atomicAdd(a.unresolved, 1ull);
      done = true;
    }
  }
  if (done) write_hit(a, i, inf, -1, 0.0f, 0.0f);
  return done;
}

// Persistent warps, launched as many as fit on the card at once.  After
// every lap the lanes whose ray is done take the next rays (in tile order)
// from a global counter, one add for all of them, so no lane waits for the
// longest ray of its warp or block.
__global__ void __launch_bounds__(kThreads) tri_march_kernel(MarchArgs a) {
  extern __shared__ uint32_t s_tab[];
  for (int w = threadIdx.x; w < a.l2_words; w += blockDim.x)
    s_tab[w] = a.l2[w];
  if (a.coarse_smem)
    for (int w = threadIdx.x; w < a.coarse_words; w += blockDim.x)
      s_tab[a.l2_words + w] = a.coarse[w];
  __syncthreads();
  const uint32_t* s_l2 = a.l2 != nullptr ? s_tab : nullptr;
  const uint32_t* cmask = a.coarse_smem ? s_tab + a.l2_words : a.coarse;
  FineGrid tg = a.tg;
  tg.ogx = __ldg(a.tri_origin);
  tg.ogy = __ldg(a.tri_origin + 1);
  tg.ogz = __ldg(a.tri_origin + 2);
  const int lane = threadIdx.x & 31;
  March m;
  int i = -1;                       // this lane's ray; -1 none, n retired
  for (;;) {
    const bool need = i < 0;
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (want != 0u) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(a.next_ray, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) {
        i = min(base + __popc(want & ((1u << lane) - 1u)), a.n);
        if (i < a.n && march_start(a, tg, i, m)) i = -1;
      }
    }
    if (__all_sync(0xffffffffu, i >= a.n)) break;
    if (i >= 0 && i < a.n && march_lap(a, tg, s_l2, cmask, i, m)) i = -1;
  }
}

// The kernel's arguments from the C entry point's (shared with the
// host build's launcher in tests/test_torch_kernels_host.py).
MarchArgs march_args(
    const void* o, const void* d, const void* t_min, const void* t_max,
    const void* coarse, int coarse_words, const void* l2, int l2_words,
    const void* fine, int nb, const void* cell_slot, const void* cell_tris,
    const void* tri9, const void* tri_origin, int n, int nx, int ny, int nz,
    int bx, int by, int bz, float ogx, float ogy, float ogz, float vs,
    float half, float bwf, float scale, float tri_vs, float tri_half,
    int l_width, int k_first, int k_drain, int max_groups, int max_laps,
    int smem_words, void* t_out, void* id_out, void* u_out, void* v_out,
    void* unresolved, void* next_ray) {
  MarchArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.t_min = static_cast<const float*>(t_min);
  a.t_max = static_cast<const float*>(t_max);
  a.coarse = static_cast<const uint32_t*>(coarse);
  a.l2 = static_cast<const uint32_t*>(l2);
  a.fine = static_cast<const uint32_t*>(fine);
  a.cell_slot = static_cast<const int*>(cell_slot);
  a.cell_tris = static_cast<const int*>(cell_tris);
  a.tri9 = static_cast<const float*>(tri9);
  a.tri_origin = static_cast<const float*>(tri_origin);
  a.coarse_words = coarse_words;
  a.l2_words = l2 != nullptr ? l2_words : 0;
  a.coarse_smem = a.l2_words + coarse_words <= smem_words;
  a.n = n;
  a.nz = nz;
  a.l_width = l_width;
  a.wg.bx = bx; a.wg.by = by; a.wg.bz = bz;
  a.wg.sbx = (bx + 7) / 8;
  a.wg.sby = (by + 7) / 8;
  a.wg.ogx = ogx; a.wg.ogy = ogy; a.wg.ogz = ogz; a.wg.bw = bwf;
  a.fg.nx = nx; a.fg.ny = ny; a.fg.bx = bx; a.fg.by = by; a.fg.bz = bz;
  a.fg.nb = nb;
  a.fg.off = 0;
  a.fg.ogx = ogx; a.fg.ogy = ogy; a.fg.ogz = ogz;
  a.fg.vs = vs; a.fg.half = half; a.fg.bwf = bwf; a.fg.scale = scale;
  a.tg = a.fg;
  a.tg.vs = tri_vs;
  a.tg.half = tri_half;
  a.sc.k_first = k_first; a.sc.k_drain = k_drain;
  a.sc.max_groups = max_groups;
  a.max_laps = max_laps;
  a.t_out = static_cast<float*>(t_out);
  a.id_out = static_cast<int*>(id_out);
  a.u_out = static_cast<float*>(u_out);
  a.v_out = static_cast<float*>(v_out);
  a.unresolved = static_cast<unsigned long long*>(unresolved);
  a.next_ray = static_cast<int*>(next_ray);
  return a;
}

}  // namespace

// next_ray: a zeroed int counter on the device.  Launches as many blocks as
// fit on the card at once (no more than the rays need).
extern "C" int tri_march_launch(
    const void* o, const void* d, const void* t_min, const void* t_max,
    const void* coarse, int coarse_words, const void* l2, int l2_words,
    const void* fine, int nb, const void* cell_slot, const void* cell_tris,
    const void* tri9, const void* tri_origin, int n, int nx, int ny, int nz,
    int bx, int by, int bz, float ogx, float ogy, float ogz, float vs,
    float half, float bwf, float scale, float tri_vs, float tri_half,
    int l_width, int k_first, int k_drain, int max_groups, int max_laps,
    int smem_words, void* t_out, void* id_out, void* u_out, void* v_out,
    void* unresolved, void* next_ray, void* stream) {
  if (n <= 0) return 0;
  const MarchArgs a = march_args(
      o, d, t_min, t_max, coarse, coarse_words, l2, l2_words, fine, nb,
      cell_slot, cell_tris, tri9, tri_origin, n, nx, ny, nz, bx, by, bz, ogx,
      ogy, ogz, vs, half, bwf, scale, tri_vs, tri_half, l_width, k_first,
      k_drain, max_groups, max_laps, smem_words, t_out, id_out, u_out, v_out,
      unresolved, next_ray);
  const size_t smem =
      sizeof(uint32_t) * (a.l2_words + (a.coarse_smem ? coarse_words : 0));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tri_march_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min((n + kThreads - 1) / kThreads, sms * per_sm);
  tri_march_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
