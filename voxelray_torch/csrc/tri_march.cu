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
// A lane holds a ray through its laps, its state in registers (a deferred
// ray moves to another lane, below):
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
// run ~100.  Neighbouring rays graze the same surfaces, so the long rays
// come in clusters, and in one warp their walks diverge and take turns:
// on the bench frame the 39 rays with >= 64 laps take 3x as long in two
// warps as one to a warp (PERF.md).  The design:
//  - no intermediate tensors and no host round trips between laps (the
//    lap loop's ~150 launches and a host sync per lap);
//  - persistent warps whose lanes take a new ray (in tile order, one
//    counter add per warp) after every lap once theirs is done;
//  - when rays outnumber lanes, a ray still marching after kLapBudget
//    laps is deferred (its index, t_cur and laps to a slot; a lap
//    restarts the walk from t_cur, so any lane can take it on) and its
//    lane takes a new ray; once the counter is spent, warps take the
//    deferred rays back by ticket, at most max(kShareLanes, 1) and their
//    share of those waiting each, so the long rays spread over the card;
//  - a lane's own row loaded kRowChunk triangles at a time, their loads
//    in flight together; while at most kShareLanes lanes of a warp hold
//    a ray (a deferred long ray in its warp), the whole warp tests each
//    of their rows (shared_rows): a lane stages its positions of the row
//    in shared memory with cp.async (ids, then their tri9 rows), the next
//    row's copies in flight while a row is tested, and a shuffle
//    reduction picks the nearest hit, so a long ray's row costs two copy
//    stages and two tests instead of ~2 dependent loads per 4 triangles
//    (the walk, shared with staged_march, is then most of its lap);
//  - the superbrick mask and, when it fits the 48 KB default shared
//    memory together with it, the brick mask copied into shared memory
//    once per block; fine, cell_slot, cell_tris and tri9 read through the
//    read-only path (at res 256 cell_tris and tri9 are ~74 MB, more than
//    the 50 MB L2, but rays in render_image's 8x128 tile order walk the
//    same bricks and read the same rows as their neighbours).
// Every lane's row staged in shared memory instead (measured, PERF.md)
// cost more than it saved: the staging takes 84 bytes a lane per row
// slot, so the multiprocessor held fewer lanes and the bulk of short
// rays, bound by throughput, slowed.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py); every constant is a float literal, as the plain
// version's float32 tensors round Python scalars; sums are taken left to
// right as ops/intersect._dot, cross products as _cross, the direction's
// inverse is one IEEE reciprocal (as `1.0 / d`), and min/max propagate NaN.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

// tri_march_launch's argument block (ops/kernels/tri_march.py):
// MarchArgs' inputs and outputs, the fields of its WalkGrid, FineGrids
// (the tri grid's cell tri_vs, tri_half) and Schedule in their place;
// smem_words: the shared memory words the tables may take.  sched:
// kSchedWords zeroed ints; deferred: n zeroed int4 where n exceeds the
// lanes the launch holds (else null).
struct TriMarchArgs {
  const float *o, *d, *t_min, *t_max;
  const uint32_t* coarse;
  int coarse_words;
  const uint32_t* l2;
  int l2_words;
  const uint32_t* fine;
  int nb;
  const int *cell_slot, *cell_tris;
  const float *tri9, *tri_origin;
  int n, nx, ny, nz, bx, by, bz;
  float ogx, ogy, ogz, vs, half, bwf, scale, tri_vs, tri_half;
  int l_width, k_first, k_drain, max_groups, max_laps, smem_words;
  float* t_out;
  int* id_out;
  float *u_out, *v_out;
  unsigned long long* unresolved;
  int* sched;
  int4* deferred;
};


namespace {

constexpr int kThreads = 128;
// the warp width: 32 on the card; the host build of the tests sets 1
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;

// The ray schedule's two settings (scripts/torch_tri_march_laps.py builds
// other values with -D): while at most kShareLanes lanes of a warp hold a
// ray, the warp tests each of their rows with all its lanes; when rays
// outnumber lanes, a ray still marching after kLapBudget laps is deferred
// (0: none).
#ifndef TRI_SHARE_LANES
#define TRI_SHARE_LANES 1
#endif
#ifndef TRI_LAP_BUDGET
#define TRI_LAP_BUDGET 8
#endif
constexpr int kShareLanes = TRI_SHARE_LANES;
constexpr int kLapBudget = TRI_LAP_BUDGET;

// The lap split (scripts/torch_tri_march_laps.py builds this file with
// -DTRI_MARCH_LAP_CLOCKS; ops/kernels/_build.py never does): each lane's
// clock64 cycles in the staged walk, the row's loads and the tests,
// summed over the rays of a launch into g_lap_clocks with the ray-laps.
#ifdef TRI_MARCH_LAP_CLOCKS
__device__ unsigned long long g_lap_clocks[4];  // walk, loads, tests, laps
struct LapClocks {
  long long t;
  unsigned long long part[3];
  int lap0;
};
// from lap `lap` of a ray on
__device__ __forceinline__ void lap_start(LapClocks& c, int lap) {
  c = LapClocks();
  c.t = clock64();
  c.lap0 = lap;
}
__device__ __forceinline__ void lap_stamp(LapClocks& c, int part) {
  const long long now = clock64();
  c.part[part] += now - c.t;
  c.t = now;
}
// the ray after `laps` laps in all
__device__ __forceinline__ void lap_flush(const LapClocks& c, int laps) {
  for (int k = 0; k < 3; ++k) atomicAdd(&g_lap_clocks[k], c.part[k]);
  atomicAdd(&g_lap_clocks[3], static_cast<unsigned long long>(laps - c.lap0));
}
#else
struct LapClocks {};
__device__ __forceinline__ void lap_start(LapClocks&, int) {}
__device__ __forceinline__ void lap_stamp(LapClocks&, int) {}
__device__ __forceinline__ void lap_flush(const LapClocks&, int) {}
#endif
enum { kClkWalk = 0, kClkLoads = 1, kClkTests = 2 };

// The idle waits (scripts/torch_tri_march_laps.py builds this file with
// -DTRI_MARCH_IDLE_CLOCKS; ops/kernels/_build.py never does): the longest
// stretch of passes in which a warp held no ray, in clock64 cycles and in
// nanoseconds of the global timer, the largest over the warps of the
// launches since the last read, in g_idle_max.
#ifdef TRI_MARCH_IDLE_CLOCKS
__device__ unsigned long long g_idle_max[2];  // cycles, ns
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct IdleClock {
  long long c0 = -1;
  unsigned long long n0 = 0;
  // a pass without a ray: the stretch starts, or goes on
  __device__ __forceinline__ void idle() {
    if (c0 < 0) {
      c0 = clock64();
      n0 = global_ns();
    }
  }
  // a pass with a ray, or the warp's end: the stretch ends
  __device__ __forceinline__ void busy(int lane) {
    if (c0 < 0) return;
    if (lane == 0) {
      atomicMax(&g_idle_max[0],
                static_cast<unsigned long long>(clock64() - c0));
      atomicMax(&g_idle_max[1], global_ns() - n0);
    }
    c0 = -1;
  }
};
#else
struct IdleClock {
  __device__ __forceinline__ void idle() {}
  __device__ __forceinline__ void busy(int) {}
};
#endif

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

// A row test's result: the nearest hit (t, id, u, v); id -1 (t +inf): none
struct Hit {
  float t;
  int id;
  float u, v;
};

__device__ __forceinline__ Hit no_hit() {
  return Hit{__int_as_float(0x7f800000), -1, 0.0f, 0.0f};
}

// One ray's march between laps: the ray, t_cur, the laps run, whether it
// was deferred and taken back (and, in the lap-split build, its clocks).
struct March {
  Ray r;
  float t_cur;
  int lap;
  bool resumed;
  LapClocks clk;
};

// A lane's own row is loaded kRowChunk triangles at a time before any of
// them is tested, so that their loads are in flight together instead of
// one chain of id load, vertex loads and test per triangle
constexpr int kRowChunk = 4;

// Moller-Trumbore over row `slot` of cell_tris (ids ascending, -1 pads
// last) by one lane with the ray of m: the nearest hit with t_lo < t <
// r.t_hi and t <= span_hi, ties to the lowest id, into h.
__device__ __forceinline__ void row_test(
    March& m, const int* __restrict__ cell_tris,
    const float* __restrict__ tri9, int slot, int l_width, float t_lo,
    float span_hi, Hit& h) {
  const Ray& r = m.r;
  h = no_hit();
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
#ifdef TRI_MARCH_LAP_CLOCKS
    // the loads land before the stamp: a volatile store of their bits
    {
      uint32_t bits = 0u;
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k)
#pragma unroll
        for (int c = 0; c < 9; ++c) bits ^= __float_as_uint(tv[k][c]);
      volatile uint32_t sink = bits;
      (void)sink;
    }
#endif
    lap_stamp(m.clk, kClkLoads);
#pragma unroll
    for (int k = 0; k < kRowChunk; ++k) {
      if (ids[k] < 0) {
        more = false;
        break;
      }
      float t, u, v;
      if (tri_hit(r, tv[k], t_lo, span_hi, t, u, v) && t < h.t)
        h = Hit{t, ids[k], u, v};
    }
    lap_stamp(m.clk, kClkTests);
  }
}

// A row shared by the warp is staged in the lanes' slices of the block's
// dynamic shared memory with asynchronous copies (cp.async, 4 bytes
// each): a lane copies its kShareSlots positions of the row's ids, then
// their tri9 rows, all of a stage's copies in flight together.  Three id
// buffers and two tri9 buffers, so that the next row's tri9 rows and the
// one after's ids fly while a row is tested.  A lane's word w lies at
// stage[w * kThreads] (lanes never share a bank).
constexpr int kShareSlots = 2;  // one round covers rows of <= 64
constexpr int kIdBufs = 3, kTriBufs = 2;
constexpr int kStageWords = (kIdBufs + 9 * kTriBufs) * kShareSlots;

__device__ __forceinline__ uint32_t* stage_ids(uint32_t* stage, int buf) {
  return stage + buf * kShareSlots * kThreads;
}
__device__ __forceinline__ uint32_t* stage_tris(uint32_t* stage, int buf) {
  return stage + (kIdBufs + 9 * buf) * kShareSlots * kThreads;
}

// The tri9 rows of the cnt landed ids in `ids` up to the first -1 pad into
// tri buffer `dst` (copies issued); returns how many ids precede the pad.
__device__ __forceinline__ int copy_tris(const uint32_t* ids, int cnt,
                                         const float* __restrict__ tri9,
                                         uint32_t* dst) {
  int k = 0;
  for (; k < cnt; ++k) {
    const int id = static_cast<int>(ids[k * kThreads]);
    if (id < 0) break;
    const float* src = tri9 + static_cast<size_t>(id) * 9;
#pragma unroll
    for (int c = 0; c < 9; ++c)
      __pipeline_memcpy_async(dst + (9 * k + c) * kThreads, src + c, 4);
  }
  return k;
}

// Moller-Trumbore over the m landed triangles of (ids, tris) in slot
// order, ids ascending: a nearer hit replaces h (ties keep the lower id).
// Two at a time, so that their loads and divisions overlap.
__device__ __forceinline__ void test_staged(const Ray& r, const uint32_t* ids,
                                            const uint32_t* tris, int m,
                                            float t_lo, float span_hi,
                                            Hit& h) {
  for (int k0 = 0; k0 < m; k0 += 2) {
    bool hit[2];
    float t[2], u[2], w[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int k = min(k0 + b, m - 1);
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c)
        v[c] = __uint_as_float(tris[(9 * k + c) * kThreads]);
      hit[b] = tri_hit(r, v, t_lo, span_hi, t[b], u[b], w[b]) && k == k0 + b;
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (hit[b] && t[b] < h.t)
        h = Hit{t[b], static_cast<int>(ids[(k0 + b) * kThreads]), u[b], w[b]};
  }
}

// One lap's cell: its row's slot, its t-span and the bounds of its test
struct LapCell {
  int slot;
  float t0, t1, t_lo, span_hi;
};

// The rows of the lanes in `rows` (a ballot; each lane's own ray in m and
// cell in c), each tested by the whole warp, one after another.  Job j is
// round j % per_row of the row of the (j / per_row)-th lane of `rows`:
// lane L takes its positions L, L + kWarp, ... (kShareSlots of them) from
// the round's first, stages them and tests them with the owner's ray.
// After a row's last round, its nearest hit, ties to the lowest id, is
// reduced with shuffles into the owner's h.  The same (t, id, u, v) as
// row_test: each triangle's test is the same expression.  Called by the
// whole warp.
__device__ __forceinline__ void shared_rows(
    March& m, const int* __restrict__ cell_tris,
    const float* __restrict__ tri9, uint32_t* stage, int l_width,
    unsigned rows, const LapCell& c, Hit& h) {
  const Ray& r = m.r;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % kWarp;
  const int span = kWarp * kShareSlots;
  const int per_row = (l_width + span - 1) / span;
  const int jobs = __popc(rows) * per_row;
  // the lane of `rows` whose row job j tests
  const auto owner = [&](int j) {
    unsigned left = rows;
    for (int k = j / per_row; k > 0; --k) left &= left - 1u;
    return __ffs(left) - 1;
  };
  // this lane's first position in job j and how many it takes
  const auto first = [&](int j) { return (j % per_row) * span + lane; };
  const auto count = [&](int j) {
    const int j0 = first(j);
    return j0 < l_width ? min(kShareSlots, (l_width - j0 + kWarp - 1) / kWarp)
                        : 0;
  };
  const auto copy_ids = [&](int j) {
    const int slot = __shfl_sync(all, c.slot, owner(j));
    const int* src = cell_tris + static_cast<size_t>(slot) * l_width +
                     first(j);
    uint32_t* dst = stage_ids(stage, j % kIdBufs);
    for (int k = 0; k < count(j); ++k)
      __pipeline_memcpy_async(dst + k * kThreads, src + k * kWarp, 4);
  };
  if (jobs == 0) return;
  copy_ids(0);
  if (jobs > 1) copy_ids(1);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  int got = copy_tris(stage_ids(stage, 0), count(0), tri9,
                      stage_tris(stage, 0));
  __pipeline_commit();
  Hit b = no_hit();
  for (int j = 0; j < jobs; ++j) {
    // job j's tri9 rows and job j + 1's ids have landed
    __pipeline_wait_prior(0);
    lap_stamp(m.clk, kClkLoads);
    int got_next = 0;
    if (j + 1 < jobs) {
      got_next = copy_tris(stage_ids(stage, (j + 1) % kIdBufs), count(j + 1),
                         tri9, stage_tris(stage, (j + 1) % kTriBufs));
      if (j + 2 < jobs) copy_ids(j + 2);
      __pipeline_commit();
    }
    lap_stamp(m.clk, kClkLoads);
    const int o = owner(j);
    Ray q = r;
    q.ox = __shfl_sync(all, r.ox, o);
    q.oy = __shfl_sync(all, r.oy, o);
    q.oz = __shfl_sync(all, r.oz, o);
    q.dx = __shfl_sync(all, r.dx, o);
    q.dy = __shfl_sync(all, r.dy, o);
    q.dz = __shfl_sync(all, r.dz, o);
    q.t_hi = __shfl_sync(all, r.t_hi, o);
    test_staged(q, stage_ids(stage, j % kIdBufs),
                stage_tris(stage, j % kTriBufs), got,
                __shfl_sync(all, c.t_lo, o), __shfl_sync(all, c.span_hi, o),
                b);
    if (j % per_row == per_row - 1) {
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const Hit x{__shfl_xor_sync(all, b.t, off),
                    __shfl_xor_sync(all, b.id, off),
                    __shfl_xor_sync(all, b.u, off),
                    __shfl_xor_sync(all, b.v, off)};
        if (x.t < b.t || (x.t == b.t && x.id < b.id)) b = x;
      }
      if (lane == o) h = b;
      b = no_hit();
    }
    lap_stamp(m.clk, kClkTests);
    got = got_next;
  }
}

// The ray schedule's counters, each on a 128-byte line of its own (zeroed
// ints on the device, counter k at sched[k * kLine]): the next ray to
// start, the rays deferred, the tickets for deferred rays handed out, and
// the rays from the counter done or deferred (each ray once: once it
// reaches n, no ray is deferred any more).  An idle warp sleeps between
// passes, kIdleNs at first, twice as long each pass up to 32 times that,
// for as long as it must: it has no timer, so no trace fails however
// long its slowest warp runs.  Why an idle warp never waits forever,
// without assuming that every block is resident at once:
//  - a warp idles only once the counter is spent, and it waits only for
//    rays that running warps hold: a ray is taken by a lane of a running
//    warp (the counter's add), and a warp holding a ray never idles: its
//    laps are bounded (max_laps), so it ends or defers each ray, adding
//    one to kSettled either way, and kSettled reaches n;
//  - a ticket below kDeferred names a slot that a running lane has
//    claimed (defer_ray's add) and writes, fenced, before its ray counts
//    as settled; a ticket at or past kDeferred once kSettled reaches n
//    (no ray can be deferred any more) is dropped;
//  - no warp ends while a deferred ray has no ticket: a warp ends only
//    holding no ray and no ticket with kSettled at n, and take_tickets
//    then gives it one (kDeferred read after kSettled is final, kTicket
//    read earlier is no larger than now);
//  - a block not yet resident has taken nothing, so no warp waits on it.
enum { kNextRay = 0, kDeferred = 1, kTicket = 2, kSettled = 3 };
constexpr int kLine = 32;
constexpr int kSchedWords = 4 * kLine;
constexpr int kIdleNs = 256;

// Everything one trace reads and writes.  o, d: (n, 3); t_min, t_max:
// (n,); coarse (coarse_words), l2 (l2_words, null for one level), fine
// (16, nb): the tri grid's brick accel; cell_slot (n_cells + 1), cell_tris
// (rows, l_width), tri9 (F + 1, 9), tri_origin (3): the tri accel.  tg is
// the tri grid, its origin read from tri_origin in the kernel.  Outputs t,
// id, u, v (n,) (+inf, -1, 0, 0 on a miss); *unresolved counts the rays
// left at the lap bound; sched holds the schedule's counters and
// deferred (n) the deferred rays (i, t_cur bits, laps run, a ready
// flag), both zeroed; deferred null: no ray is deferred.
struct MarchArgs {
  const float *o, *d, *t_min, *t_max;
  const uint32_t *coarse, *l2, *fine;
  const int *cell_slot, *cell_tris;
  const float *tri9, *tri_origin;
  int coarse_words, coarse_smem, l2_words, table_words, n, nz, l_width,
      max_laps;
  WalkGrid wg;
  FineGrid fg, tg;
  Schedule sc;
  float* t_out;
  int* id_out;
  float *u_out, *v_out;
  unsigned long long* unresolved;
  int* sched;
  int4* deferred;
};

__device__ __forceinline__ void write_hit(const MarchArgs& a, int i, float t,
                                          int id, float u, float v) {
  a.t_out[i] = t;
  a.id_out[i] = id;
  a.u_out[i] = u;
  a.v_out[i] = v;
}

// Takes up ray i at t_cur after `lap` laps (0: a new ray, t_cur its
// t_min; more: a deferred ray).
__device__ __forceinline__ void start_ray(const MarchArgs& a, int i,
                                          float t_cur, int lap, March& m) {
  m.r = load_ray(a.o, a.d, i, a.t_min[i], a.t_max[i]);
  set_tie_eps(m.r, a.fg);
  m.t_cur = t_cur;
  m.lap = lap;
  m.resumed = lap > 0;
  lap_start(m.clk, lap);
}

// Round 0 of a new ray i: the cell holding the start point o + d * t_min.
// Returns true when that ends the ray (a hit, written).
__device__ __forceinline__ bool round0(const MarchArgs& a, const FineGrid& tg,
                                       int i, March& m) {
  const Ray& r = m.r;
  const float tmin = m.t_cur;
  const int c0x = floor_cell(((r.ox + r.dx * tmin) - tg.ogx) / tg.vs);
  const int c0y = floor_cell(((r.oy + r.dy * tmin) - tg.ogy) / tg.vs);
  const int c0z = floor_cell(((r.oz + r.dz * tmin) - tg.ogz) / tg.vs);
  if (c0x < 0 || c0x >= tg.nx || c0y < 0 || c0y >= tg.ny || c0z < 0 ||
      c0z >= a.nz)
    return false;
  const int slot = __ldg(a.cell_slot + c0x + tg.nx * (c0y + tg.ny * c0z));
  if (slot < 0) return false;
  float t0, t1;
  cell_slab(r, tg, c0x, c0y, c0z, t0, t1);
  Hit h;
  row_test(m, a.cell_tris, a.tri9, slot, a.l_width, tmin,
           t1 * 1.000001f + 1e-7f, h);
  if (h.id < 0) return false;
  write_hit(a, i, h.t, h.id, h.u, h.v);
  lap_flush(m.clk, 0);
  return true;
}

// A lap of ray i is its walk (lap_cell), its cell's row test (row_test,
// or shared_rows in a warp with few rays left) and its end (lap_end).

// The walk: the next nonempty cell after t_cur, into c.  Returns false when
// there is none (the ray's miss written).
__device__ __forceinline__ bool lap_cell(const MarchArgs& a,
                                         const FineGrid& tg,
                                         const uint32_t* s_l2,
                                         const uint32_t* cmask, int i,
                                         March& m, LapCell& c) {
  m.r.t_lo = m.t_cur;
  Staged s;
  staged_first_cell<false>(m.r, a.wg, a.fg, s_l2, cmask, a.fine, a.sc, s);
  lap_stamp(m.clk, kClkWalk);
  const int lin = s.lin;
  if (lin < 0) {
    write_hit(a, i, __int_as_float(0x7f800000), -1, 0.0f, 0.0f);
    lap_flush(m.clk, m.lap + 1);
    return false;
  }
  cell_slab(m.r, tg, lin % tg.nx, (lin / tg.nx) % tg.ny,
            lin / (tg.nx * tg.ny), c.t0, c.t1);
  c.slot = max(__ldg(a.cell_slot + lin), 0);
  c.t_lo = jmax(m.t_cur, c.t0 * 0.999999f - 1e-7f);
  c.span_hi = c.t1 * 1.000001f + 1e-7f;
  return true;
}

// The lap's end after the row test h: the hit, or the advance.  Returns
// true when the ray is done (its outputs written): a hit, t_cur past
// t_max, or the lap bound (counted as unresolved; max_laps >= 1).
__device__ __forceinline__ bool lap_end(const MarchArgs& a, int i,
                                        const LapCell& c, const Hit& h,
                                        March& m) {
  const float inf = __int_as_float(0x7f800000);
  if (h.id >= 0) {
    write_hit(a, i, h.t, h.id, h.u, h.v);
    lap_flush(m.clk, m.lap + 1);
    return true;
  }
  // advance to the tested cell's midpoint, never backward (one float up
  // where a span of length 0 does not move it)
  const float mid = 0.5f * (c.t0 + c.t1);
  m.t_cur = mid > m.t_cur ? mid : nextafterf(m.t_cur, inf);
  bool done = !(m.t_cur <= m.r.t_hi);
  if (!done && ++m.lap == a.max_laps) {
    atomicAdd(a.unresolved, 1ull);
    done = true;
  }
  if (done) {
    write_hit(a, i, inf, -1, 0.0f, 0.0f);
    lap_flush(m.clk, m.lap + 1);
  }
  return done;
}

__device__ __forceinline__ int* counter(const MarchArgs& a, int k) {
  return a.sched + k * kLine;
}

// Defers ray i at t_cur after `lap` laps: its state into the next slot of
// `deferred` (its count at *count), the ready flag written last, then one
// more ray settled.  (Out of line, as take_slot: both are rare, and
// inlined they cost the lap loop registers.)
__device__ __noinline__ void defer_ray(int* count, int* settled,
                                       int4* deferred, int i, float t_cur,
                                       int lap) {
  int4* slot = deferred + atomicAdd(count, 1);
  slot->x = i;
  slot->y = __float_as_int(t_cur);
  slot->z = lap;
  __threadfence();
  *reinterpret_cast<volatile int*>(&slot->w) = 1;
  __threadfence();
  atomicAdd(settled, 1);
}

// Whether deferred slot k is written (k < n: at most n rays are deferred)
__device__ __forceinline__ bool slot_ready(const MarchArgs& a, int k) {
  return k < a.n &&
         reinterpret_cast<volatile int*>(&a.deferred[k].w)[0] != 0;
}

// The written deferred slot `slot`: (ray, t_cur bits, laps, flag).
__device__ __noinline__ int4 take_slot(const int4* slot) {
  __threadfence();
  const volatile int4* v = slot;
  return make_int4(v->x, v->y, v->z, v->w);
}

// Persistent warps, launched as many as fit on the card at once.  After
// every lap the lanes whose ray is done take the next rays (in tile order)
// from a global counter, one add for all of them, so no lane waits for the
// longest ray of its warp or block.  When rays outnumber lanes, a ray
// still marching after kLapBudget laps is deferred and its lane takes a
// new ray: the long rays cluster (neighbouring rays graze the same
// surface), and in one warp their walks diverge and take turns.  Once the
// counter is spent, a warp's lanes take tickets for deferred rays (in the
// order they were deferred) while the warp holds fewer rays and tickets
// than max(kShareLanes, 1) plus its share of those waiting, so that the
// long rays spread over the warps; a lane with a ticket takes its ray once
// the ray's slot is written.  While at most kShareLanes lanes of a warp
// hold a ray, the whole warp tests each of their rows (shared_rows).  A
// warp ends once it holds no ray and no ray can be deferred any more.
// Dynamic shared memory: the l2 and (when it fits) the brick mask, then
// kStageWords per thread for the rows.
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
  uint32_t* stage = s_tab + a.table_words + threadIdx.x;
  FineGrid tg = a.tg;
  tg.ogx = __ldg(a.tri_origin);
  tg.ogy = __ldg(a.tri_origin + 1);
  tg.ogz = __ldg(a.tri_origin + 2);
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  const int warps = gridDim.x * (kThreads / kWarp);
  // rays are deferred only when there are more of them than lanes: then a
  // deferred ray's lane takes a new one (and the slots are given)
  const bool defer = kLapBudget > 0 && a.deferred != nullptr &&
                     a.n > gridDim.x * kThreads;
  March m;
  int i = -1;                       // this lane's ray; -1 none
  int ticket = -1;                  // its deferred ray's slot; -1 none
  bool spent = false;               // the ray counter is spent (warp-wide)
  int sleep_ns = kIdleNs;           // the next idle pass's sleep
  IdleClock idle;                   // (the idle-wait build's)
  // Once the counter is spent: tickets for deferred rays into free lanes
  // while the warp holds fewer rays and tickets than max(kShareLanes, 1)
  // plus its share of the deferred rays waiting (deferred - tickets, read
  // before the pass's lap).
  const auto take_tickets = [&](int deferred, int tickets) {
    deferred = __shfl_sync(all, deferred, 0);
    tickets = __shfl_sync(all, tickets, 0);
    const unsigned free_lanes = __ballot_sync(all, i < 0 && ticket < 0);
    const int waiting = deferred - tickets;
    const int held = kWarp - __popc(free_lanes);     // rays and tickets
    const int room = waiting <= 0 ? 0
                                  : min(min(__popc(free_lanes), waiting),
                                        max(kShareLanes, 1) +
                                            waiting / warps - held);
    if (room <= 0) return;
    int first = 0;
    if (lane == 0) first = atomicAdd(counter(a, kTicket), room);
    first = __shfl_sync(all, first, 0);
    if (i < 0 && ticket < 0 && __popc(free_lanes & below) < room)
      ticket = first + __popc(free_lanes & below);
  };
  for (;;) {
    bool fin = false;               // this lane's ray is done this pass
    int take = -1;                  // the ray this lane takes up this pass
    float take_t = 0.0f;
    int take_lap = 0;
    int deferred = 0, tickets = 0;
    if (spent && lane == 0) {
      deferred = *reinterpret_cast<volatile int*>(counter(a, kDeferred));
      tickets = *reinterpret_cast<volatile int*>(counter(a, kTicket));
    }
    if (!spent) {
      const unsigned want = __ballot_sync(all, i < 0);
      if (want != 0u) {
        const int leader = __ffs(want) - 1;
        int base = 0;
        if (lane == leader)
          base = atomicAdd(counter(a, kNextRay), __popc(want));
        base = __shfl_sync(all, base, leader);
        spent = base + __popc(want) >= a.n;
        const int k = base + __popc(want & below);
        if (i < 0 && k < a.n) {
          take = k;
          take_t = a.t_min[k];
        }
      }
    } else if (ticket >= 0 && slot_ready(a, ticket)) {
      const int4 v = take_slot(a.deferred + ticket);
      take = v.x;
      take_t = __int_as_float(v.y);
      take_lap = v.z;
      ticket = -1;
    }
    if (__all_sync(all, i < 0 && take < 0)) {
      // no ray this pass: once no ray can be deferred any more, tickets
      // past the last deferred ray are dropped, and a warp with no ticket
      // is done; otherwise take tickets and sleep, longer each time
      if (spent) {
        int settled = a.n;
        if (defer && lane == 0) {
          __threadfence();
          settled = *reinterpret_cast<volatile int*>(counter(a, kSettled));
          __threadfence();
          deferred = *reinterpret_cast<volatile int*>(counter(a, kDeferred));
        }
        settled = __shfl_sync(all, settled, 0);
        if (settled >= a.n && ticket >= __shfl_sync(all, deferred, 0))
          ticket = -1;
        take_tickets(deferred, tickets);
        if (settled >= a.n && __all_sync(all, ticket < 0)) {
          idle.busy(lane);
          break;
        }
      }
      idle.idle();
      __nanosleep(sleep_ns);
      sleep_ns = min(2 * sleep_ns, 32 * kIdleNs);
      continue;
    }
    sleep_ns = kIdleNs;
    idle.busy(lane);
    if (take >= 0) {
      i = take;
      start_ray(a, i, take_t, take_lap, m);
      if (take_lap == 0 && round0(a, tg, i, m)) {
        fin = true;
        i = -1;
      }
    }
    const bool live = i >= 0;
    LapCell c;
    const bool has_row = live && lap_cell(a, tg, s_l2, cmask, i, m, c);
    if (live && !has_row) {
      fin = true;
      i = -1;
    }
    Hit h = no_hit();
    if (__popc(__ballot_sync(all, live)) <= kShareLanes)
      shared_rows(m, a.cell_tris, a.tri9, stage, a.l_width,
                  __ballot_sync(all, has_row), c, h);
    else if (has_row)
      row_test(m, a.cell_tris, a.tri9, c.slot, a.l_width, c.t_lo, c.span_hi,
               h);
    if (has_row) {
      if (lap_end(a, i, c, h, m)) {
        fin = true;
        i = -1;
      } else if (defer && !m.resumed && m.lap >= kLapBudget) {
        defer_ray(counter(a, kDeferred), counter(a, kSettled), a.deferred,
                  i, m.t_cur, m.lap);
        lap_flush(m.clk, m.lap);
        i = -1;
      }
    }
    if (spent) take_tickets(deferred, tickets);
    // rays from the counter done this pass are settled
    const unsigned settled = __ballot_sync(all, fin && !m.resumed);
    if (defer && lane == 0 && settled != 0u)
      atomicAdd(counter(a, kSettled), __popc(settled));
  }
}

// The kernel's arguments from the entry point's block.
MarchArgs march_args(const TriMarchArgs& b) {
  MarchArgs a;
  a.o = b.o;
  a.d = b.d;
  a.t_min = b.t_min;
  a.t_max = b.t_max;
  a.coarse = b.coarse;
  a.l2 = b.l2;
  a.fine = b.fine;
  a.cell_slot = b.cell_slot;
  a.cell_tris = b.cell_tris;
  a.tri9 = b.tri9;
  a.tri_origin = b.tri_origin;
  a.coarse_words = b.coarse_words;
  a.l2_words = b.l2 != nullptr ? b.l2_words : 0;
  a.coarse_smem = a.l2_words + b.coarse_words <= b.smem_words;
  a.table_words = a.l2_words + (a.coarse_smem ? b.coarse_words : 0);
  a.n = b.n;
  a.nz = b.nz;
  a.l_width = b.l_width;
  a.wg = walk_grid(b);
  a.fg = fine_grid(b, 0);
  a.tg = a.fg;
  a.tg.vs = b.tri_vs;
  a.tg.half = b.tri_half;
  a.sc.k_first = b.k_first; a.sc.k_drain = b.k_drain;
  a.sc.max_groups = b.max_groups;
  a.max_laps = b.max_laps;
  a.t_out = b.t_out;
  a.id_out = b.id_out;
  a.u_out = b.u_out;
  a.v_out = b.v_out;
  a.unresolved = b.unresolved;
  a.sched = b.sched;
  a.deferred = b.deferred;
  return a;
}

}  // namespace

// Dynamic shared memory of a block, in bytes: the tables and the staging.
static size_t smem_bytes(int table_words) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(table_words) + kStageWords * kThreads);
}

// The opt-in above the default 48 KB, then the blocks a multiprocessor
// holds with that shared memory.
static cudaError_t blocks_per_sm(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      tri_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, tri_march_kernel, kThreads, smem);
  return err;
}

// The launch configuration for `table_words` words of tables (the l2 mask
// and, when it goes to shared memory, the brick mask): out = {a lane's row
// chunk, a lane's slots of a shared row, kShareLanes, kLapBudget, threads
// a block, dynamic shared memory bytes, blocks a multiprocessor}.
extern "C" int tri_march_config(int table_words, int* out) {
  const size_t smem = smem_bytes(table_words);
  out[0] = kRowChunk;
  out[1] = kShareSlots;
  out[2] = kShareLanes;
  out[3] = kLapBudget;
  out[4] = kThreads;
  out[5] = static_cast<int>(smem);
  return static_cast<int>(blocks_per_sm(smem, &out[6]));
}

// Launches as many blocks as fit on the card at once (no more than the
// rays need).
extern "C" int tri_march_launch(const TriMarchArgs* b, void* stream) {
  if (b->n <= 0) return 0;
  const MarchArgs a = march_args(*b);
  const size_t smem = smem_bytes(a.table_words);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm(smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min((a.n + kThreads - 1) / kThreads, sms * per_sm);
  tri_march_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void tri_march_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(TriMarchArgs));
}

#ifdef TRI_MARCH_IDLE_CLOCKS
// The longest idle stretch of a warp since the last call (clock64 cycles,
// ns) into out[2], then zeroed.
extern "C" int tri_march_idle_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_idle_max,
                                         2 * sizeof(unsigned long long));
  const unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_idle_max, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

#ifdef TRI_MARCH_LAP_CLOCKS
// The lap split summed since the last call (walk, loads, tests cycles,
// ray-laps) into out[4], then zeroed.
extern "C" int tri_march_lap_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_lap_clocks,
                                         4 * sizeof(unsigned long long));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_lap_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
