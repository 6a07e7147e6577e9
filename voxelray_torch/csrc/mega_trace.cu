// K2: the exhaustive nearest-voxel trace (and shadow any-hit) for Hopper.
//
// Replaces the Pallas megakernel of voxelray_tpu/ops/pallas/mega_trace.py
// (_make_mega_kernel / _mega_call, with grid_walk._fused_init).  The
// contract is the one of trace_grid_dda: per ray, the first accepted
// occupied cell along the ray, t = +inf / lin = -1 on a miss; an `admit`
// mask and per-ray t_min / t_max make the same kernel the shadow any-hit.
// What is ported is the walk, not the TPU's SIMD-block scheduling: there
// is no "serve the B smallest pending superbricks" per (24, 128) block, no
// DMA into VMEM and no mux over tile rows.  One lane follows one ray at a
// time.
//
// Per ray, in the expression shapes of the Pallas kernel:
//   1. init (_fused_init): clip to the brick grid, fast-forward to t_min,
//      entry brick, ok.  The lane runs iff ok && admit.
//   2. superbrick walk (walk_step_t): L2 bit of the brick's superbrick; in
//      an empty superbrick, a conservative skip to the last brick the ray
//      touches there plus one exact brick step; grid exit or t_max ends
//      the ray.
//   3. transit of an occupied superbrick, brick by brick (brick_dda_step),
//      brick occupancy from row 64 of the superbrick's fine_sb tile
//      (tile_occ_brick).
//   4. in an occupied brick, the per-voxel DDA of fine_step (at most
//      FINE_STEPS = 25 cells) with the reference slab test and the accept
//      rule (t1 > max(t0,0)) & (t0 > 0) & (t0 >= t_min) & (t0 <= t_max).
//   5. the first accepted cell retires the ray with (t0, global lin);
//   6. a ray that leaves the superbrick unresolved resumes the walk.
// One addition to the Pallas walk: where two crossing times tie within
// float noise, the ray passes next to an edge, the reference's per-cell
// slab tests are not watertight there, and either side may hold a one-ulp
// sliver they accept.  The step then follows the slab test and the other
// side is probed (pick_axis, probe_cell; likewise at brick level and at a
// brick's entry face); a probed accept retires the ray once the walk is
// past its t.  Without this, a few grazing rays per frame skipped an
// occupied sliver and hit a cell behind it.
// Every brick move advances one coordinate monotonically, so a ray makes
// at most bx+by+bz+3 moves; a ray that reaches that cap sets `alive`
// (a defensive invariant: the wrapper reports the count as `unresolved`).
//
// What bounds it on the H100: divergent, latency-bound integer and float
// walking per lane.  Memory is light: the L2 table is a few words, the
// fine_sb table is 18.9 MB at 512^3 and stays in the 50 MB L2 cache, and
// the ray state lives in registers.  On the bench frame three primary
// rays in four miss the grid, the others take ~32 brick and cell steps on
// average with a tail past 300, and a shadow pass admits ~6% of the
// frame's rays.  The design: persistent warps (as many as fit on the
// card) take rays in the 8x128 tile order render_image produces, a chunk
// of 32 neighbouring pixels at a time, so a warp's lanes walk nearly the
// same bricks and the warps in flight nearby ones; a lane takes its next
// ray as soon as its ray ends (the walk is resumed one brick step at a
// time), so no lane idles behind the longest ray of its warp.  At a fetch
// the warp reads its chunk's admit bytes and hands only admitted rays to
// lanes; a ray not admitted gets its miss (t = +inf, lin = -1) written
// there, without a host-side compaction or sync.  The chunks are dealt to
// 32 counters in turn, each in its own cache line: on one counter a
// frame's ~65K fetches queue on one L2 line.  A brick's occupancy words
// are read on demand through the read-only path.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), so every product and sum rounds separately, as
// in the plain PyTorch DDA (ops/traverse.py).  The hit t is the hit_aabb
// expression of that DDA's _dda_final_t term for term, so where both find
// the same cell, t is bit-equal.  min/max propagate NaN like
// torch.minimum / jnp.minimum (on the card one PTX min.NaN / max.NaN each;
// only the payload of an intermediate NaN differs from the host build's,
// and no NaN reaches an output).  A float that is floored and cast to an
// int only steers a live ray, and every such index is clamped to the
// current superbrick or brick, so no result depends on how a NaN or an
// infinity converts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// mega_trace_launch's argument block (ops/kernels/mega_trace.py):
// TraceArgs' fields, the grid's in the place of its Grid.  next_ray:
// stripes * 32 zeroed ints on the device (a counter every 128 bytes).
struct MegaTraceArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const uint32_t *l2, *fine_sb;
  int n, nx, ny, nz, bx, by, bz;
  float ogx, ogy, ogz, vs, half, bw;
  float* t_out;
  int *lin_out, *alive_out, *next_ray;
  int stripes;
};

namespace {

constexpr int kBrick = 8;
constexpr int kFineSteps = 3 * kBrick + 1;
constexpr int kTileWords = 72 * 128;  // one superbrick tile of fine_sb
constexpr int kOccRow = 64 * 128;     // row 64: brick occupancy words
// Two crossing times count as a tie (see pick_axis) when they differ by
// less than this many ulps of the scene's coordinate scale, divided by the
// direction components: a crossing t carries the rounding of its plane
// coordinate, amplified by 1/|d| on grazing axes.
constexpr float kTieUlps = 16.0f;
// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 128;
// ints between two stripe counters: one 128-byte line each
constexpr int kCounterStride = 32;

__device__ __forceinline__ float jmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
#endif
}
__device__ __forceinline__ float jmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
#endif
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
// floor(x) as int, or `fallback` where x is not finite
__device__ __forceinline__ int floor_or(float x, int fallback) {
  return isfinite(x) ? static_cast<int>(floorf(x)) : fallback;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, inv_x, inv_y, inv_z, t_lo, t_hi;
  float tie_eps;  // kTieUlps ulps of the largest coordinate in play
  int sx, sy, sz, fx, fy, fz;
};

struct Grid {
  int nx, ny, nz, bx, by, bz, sbx, sby;
  float ogx, ogy, ogz, vs, half, bw;
};

// The nearest accepted cell found so far off the ray's own walk (see
// pick_axis); t = +inf while there is none.
struct Hit {
  float t;
  int lin;
};

// [t0, t1] of a box along the ray: the slab test of hit_aabb.
__device__ __forceinline__ void slab(const Ray& r, float lox, float loy,
                                     float loz, float hix, float hiy,
                                     float hiz, float& t0, float& t1) {
  float tb = r.inv_x * (lox - r.ox), tt = r.inv_x * (hix - r.ox);
  t0 = jmin(tb, tt);
  t1 = jmax(tb, tt);
  tb = r.inv_y * (loy - r.oy);
  tt = r.inv_y * (hiy - r.oy);
  t0 = jmax(t0, jmin(tb, tt));
  t1 = jmin(t1, jmax(tb, tt));
  tb = r.inv_z * (loz - r.oz);
  tt = r.inv_z * (hiz - r.oz);
  t0 = jmax(t0, jmin(tb, tt));
  t1 = jmin(t1, jmax(tb, tt));
}

// Slab interval of cell (gx, gy, gz) from its centre, the expression of
// the reference's per-cell AABB (raytrace.rint:46-56).
__device__ __forceinline__ void cell_slab(const Ray& r, const Grid& g, int gx,
                                          int gy, int gz, float& t0,
                                          float& t1) {
  const float ccx = g.ogx + (static_cast<float>(gx) + 0.5f) * g.vs;
  const float ccy = g.ogy + (static_cast<float>(gy) + 0.5f) * g.vs;
  const float ccz = g.ogz + (static_cast<float>(gz) + 0.5f) * g.vs;
  slab(r, ccx - g.half, ccy - g.half, ccz - g.half, ccx + g.half,
       ccy + g.half, ccz + g.half, t0, t1);
}

__device__ __forceinline__ bool accepts(const Ray& r, float t0, float t1) {
  return (t1 > jmax(t0, 0.0f)) && (t0 > 0.0f) && (t0 >= r.t_lo) &&
         (t0 <= r.t_hi);
}

__device__ __forceinline__ const uint32_t* tile_of(
    const Grid& g, const uint32_t* __restrict__ fine_sb, int bcx, int bcy,
    int bcz) {
  const int sb = (bcx >> 3) + g.sbx * ((bcy >> 3) + g.sby * (bcz >> 3));
  return fine_sb + static_cast<long long>(sb) * kTileWords;
}

__device__ __forceinline__ int brick_local(int bcx, int bcy, int bcz) {
  return (bcx & 7) + 8 * ((bcy & 7) + 8 * (bcz & 7));
}

__device__ __forceinline__ bool in_bricks(const Grid& g, int bcx, int bcy,
                                          int bcz) {
  return bcx >= 0 && bcx < g.bx && bcy >= 0 && bcy < g.by && bcz >= 0 &&
         bcz < g.bz;
}

// The axis a DDA step crosses, given the three crossing times and their
// minimum tmn.  The default is the reference rule: the first axis (x, y,
// z) whose crossing equals tmn.  Where another axis crosses within float
// noise of it (tie_eps), the ray passes next to an edge or corner and the
// crossing times cannot tell which neighbour it enters; the reference's
// per-cell slab tests are not watertight there and may accept a one-ulp
// sliver on either side.  So the step goes to the first neighbour
// (default first, then x, y, z) that the slab test says the ray passes
// through (`passes`), and `*ties` returns the other near-tied axes, whose
// neighbours the caller probes.
template <class Passes>
__device__ __forceinline__ int pick_axis(const Ray& r, float tx, float ty,
                                         float tz, float tmn, Passes passes,
                                         int* ties) {
  int axis = tx == tmn ? 0 : (ty == tmn ? 1 : 2);
  const float inv[3] = {fabsf(r.inv_x), fabsf(r.inv_y), fabsf(r.inv_z)};
  const float t[3] = {tx, ty, tz};
  int near = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (isfinite(t[k]) && t[k] - tmn <= r.tie_eps * (inv[k] + inv[axis]))
      near |= 1 << k;
  near |= 1 << axis;
  if ((near & (near - 1)) && !passes(axis)) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k != axis && ((near >> k) & 1) && passes(k)) {
        axis = k;
        break;
      }
  }
  *ties = near & ~(1 << axis);
  return axis;
}

// Occupied-and-accepted test of one cell anywhere in the brick grid; a
// nearer accept replaces `cand`.
__device__ __forceinline__ void probe_cell(const Ray& r, const Grid& g,
                                           const uint32_t* __restrict__ fine_sb,
                                           int gx, int gy, int gz, Hit& cand) {
  const int bcx = gx >> 3, bcy = gy >> 3, bcz = gz >> 3;
  if (gx < 0 || gy < 0 || gz < 0 || !in_bricks(g, bcx, bcy, bcz)) return;
  const int ll = (gx & 7) + kBrick * ((gy & 7) + kBrick * (gz & 7));
  const uint32_t word = __ldg(tile_of(g, fine_sb, bcx, bcy, bcz) +
                              (ll >> 5) * 512 + brick_local(bcx, bcy, bcz));
  if (!((word >> (ll & 31)) & 1u)) return;
  float t0, t1;
  cell_slab(r, g, gx, gy, gz, t0, t1);
  if (accepts(r, t0, t1) && t0 < cand.t) {
    cand.t = t0;
    cand.lin = gx + g.nx * (gy + g.ny * gz);
  }
}

// Per-voxel DDA through one occupied brick (fine_brick / fine_step).
// Returns true at the first accepted occupied cell, or once the walk is
// past a nearer probed candidate; `cand` then holds the nearest hit.
__device__ bool fine_brick(const Ray& r, const Grid& g,
                           const uint32_t* __restrict__ fine_sb, int bcx,
                           int bcy, int bcz, Hit& cand) {
  const float inf = __int_as_float(0x7f800000);
  const uint32_t* tile = tile_of(g, fine_sb, bcx, bcy, bcz);
  const int blocal = brick_local(bcx, bcy, bcz);
  const float bminx = g.ogx + static_cast<float>(bcx * kBrick) * g.vs;
  const float bminy = g.ogy + static_cast<float>(bcy * kBrick) * g.vs;
  const float bminz = g.ogz + static_cast<float>(bcz * kBrick) * g.vs;
  const float ex = r.dx == 0.0f ? -inf
                                : jmin((bminx - r.ox) * r.inv_x,
                                       (bminx + g.bw - r.ox) * r.inv_x);
  const float ey = r.dy == 0.0f ? -inf
                                : jmin((bminy - r.oy) * r.inv_y,
                                       (bminy + g.bw - r.oy) * r.inv_y);
  const float ez = r.dz == 0.0f ? -inf
                                : jmin((bminz - r.oz) * r.inv_z,
                                       (bminz + g.bw - r.oz) * r.inv_z);
  const float t_enter = jmax(jmax(ex, ey), ez);
  const float t_start = jmax(t_enter, 0.0f) + 1e-7f;
  const float px = r.ox + r.dx * t_start;
  const float py = r.oy + r.dy * t_start;
  const float pz = r.oz + r.dz * t_start;
  int lx = clampi(floor_or((px - bminx) / g.vs, 0), 0, kBrick - 1);
  int ly = clampi(floor_or((py - bminy) / g.vs, 0), 0, kBrick - 1);
  int lz = clampi(floor_or((pz - bminz) / g.vs, 0), 0, kBrick - 1);
  {
    // The start cell floors the entry point.  Where the ray crosses one of
    // that cell's entry faces within float noise of the entry time, the
    // cell behind the face may be the true first cell: probe it.
    const float t_in = jmax(t_enter, 0.0f);
    const float ia[3] = {fabsf(r.inv_x), fabsf(r.inv_y), fabsf(r.inv_z)};
    const float ie = t_enter == ex ? ia[0] : (t_enter == ey ? ia[1] : ia[2]);
    const float face[3] = {
        (bminx + static_cast<float>(lx + 1 - r.fx) * g.vs - r.ox) * r.inv_x,
        (bminy + static_cast<float>(ly + 1 - r.fy) * g.vs - r.oy) * r.inv_y,
        (bminz + static_cast<float>(lz + 1 - r.fz) * g.vs - r.oz) * r.inv_z};
    const float dk[3] = {r.dx, r.dy, r.dz};
    const int sk[3] = {r.sx, r.sy, r.sz};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (dk[k] != 0.0f &&
          fabsf(face[k] - t_in) <= r.tie_eps * (ia[k] + ie))
        probe_cell(r, g, fine_sb, bcx * kBrick + lx - (k == 0 ? sk[k] : 0),
                   bcy * kBrick + ly - (k == 1 ? sk[k] : 0),
                   bcz * kBrick + lz - (k == 2 ? sk[k] : 0), cand);
  }

  for (int s = 0; s < kFineSteps; ++s) {
    const int lin_local = lx + kBrick * (ly + kBrick * lz);
    const uint32_t word = __ldg(tile + (lin_local >> 5) * 512 + blocal);
    const int gx = bcx * kBrick + lx;
    const int gy = bcy * kBrick + ly;
    const int gz = bcz * kBrick + lz;
    if ((word >> (lin_local & 31)) & 1u) {
      float t0, t1;
      cell_slab(r, g, gx, gy, gz, t0, t1);
      if (accepts(r, t0, t1)) {
        if (t0 < cand.t) {
          cand.t = t0;
          cand.lin = gx + g.nx * (gy + g.ny * gz);
        }
        return true;
      }
    }
    float tnx = (bminx + static_cast<float>(lx + r.fx) * g.vs - r.ox) * r.inv_x;
    float tny = (bminy + static_cast<float>(ly + r.fy) * g.vs - r.oy) * r.inv_y;
    float tnz = (bminz + static_cast<float>(lz + r.fz) * g.vs - r.oz) * r.inv_z;
    if (r.dx == 0.0f) tnx = inf;
    if (r.dy == 0.0f) tny = inf;
    if (r.dz == 0.0f) tnz = inf;
    const float tmn = jmin(tnx, jmin(tny, tnz));
    // a probed candidate nearer than this cell's exit is the nearest hit
    if (cand.t <= tmn) return true;
    int ties;
    const int axis = pick_axis(r, tnx, tny, tnz, tmn, [&](int k) {
      float t0, t1;
      cell_slab(r, g, gx + (k == 0 ? r.sx : 0), gy + (k == 1 ? r.sy : 0),
                gz + (k == 2 ? r.sz : 0), t0, t1);
      return t1 > t0;
    }, &ties);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if ((ties >> k) & 1)
        probe_cell(r, g, fine_sb, gx + (k == 0 ? r.sx : 0),
                   gy + (k == 1 ? r.sy : 0), gz + (k == 2 ? r.sz : 0), cand);
    lx += axis == 0 ? r.sx : 0;
    ly += axis == 1 ? r.sy : 0;
    lz += axis == 2 ? r.sz : 0;
    const bool inb = lx >= 0 && lx < kBrick && ly >= 0 && ly < kBrick &&
                     lz >= 0 && lz < kBrick;
    if (!(inb && tmn <= r.t_hi)) return false;
  }
  return false;
}

// Brick occupancy from row 64 of the brick's superbrick tile.
__device__ __forceinline__ bool brick_occupied(
    const Grid& g, const uint32_t* __restrict__ fine_sb, int bcx, int bcy,
    int bcz) {
  const int bl = brick_local(bcx, bcy, bcz);
  return (__ldg(tile_of(g, fine_sb, bcx, bcy, bcz) + kOccRow + (bl >> 5)) >>
          (bl & 31)) & 1u;
}

// One exact brick DDA step (brick_dda_step); returns the crossing t.
// Near-tied neighbour bricks that the step does not enter are resolved
// into `cand` (pick_axis).
__device__ float brick_step(const Ray& r, const Grid& g,
                            const uint32_t* __restrict__ fine_sb, int& cx,
                            int& cy, int& cz, Hit& cand) {
  const float inf = __int_as_float(0x7f800000);
  float tx = (g.ogx + static_cast<float>(cx + r.fx) * g.bw - r.ox) * r.inv_x;
  float ty = (g.ogy + static_cast<float>(cy + r.fy) * g.bw - r.oy) * r.inv_y;
  float tz = (g.ogz + static_cast<float>(cz + r.fz) * g.bw - r.oz) * r.inv_z;
  if (r.dx == 0.0f) tx = inf;
  if (r.dy == 0.0f) ty = inf;
  if (r.dz == 0.0f) tz = inf;
  const float tmin = jmin(tx, jmin(ty, tz));
  int ties;
  const int axis = pick_axis(r, tx, ty, tz, tmin, [&](int k) {
    const float lx = g.ogx + static_cast<float>(
        (cx + (k == 0 ? r.sx : 0)) * kBrick) * g.vs;
    const float ly = g.ogy + static_cast<float>(
        (cy + (k == 1 ? r.sy : 0)) * kBrick) * g.vs;
    const float lz = g.ogz + static_cast<float>(
        (cz + (k == 2 ? r.sz : 0)) * kBrick) * g.vs;
    float t0, t1;
    slab(r, lx, ly, lz, lx + g.bw, ly + g.bw, lz + g.bw, t0, t1);
    return t1 > t0;
  }, &ties);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!((ties >> k) & 1)) continue;
    const int nx = cx + (k == 0 ? r.sx : 0);
    const int ny = cy + (k == 1 ? r.sy : 0);
    const int nz = cz + (k == 2 ? r.sz : 0);
    if (in_bricks(g, nx, ny, nz) && brick_occupied(g, fine_sb, nx, ny, nz))
      fine_brick(r, g, fine_sb, nx, ny, nz, cand);
  }
  cx += axis == 0 ? r.sx : 0;
  cy += axis == 1 ? r.sy : 0;
  cz += axis == 2 ? r.sz : 0;
  return tmin;
}

// Everything one trace reads and writes.  o, d: (n, 3); t_min, t_max,
// admit: (n,); l2, fine_sb: the accel's tables.  Outputs t, lin, alive
// (n,); next_ray holds the zeroed counters, kCounterStride ints apart, of
// the stripes of chunks from which the warps take their rays (chunks = the
// chunks of kWarp rays).
struct TraceArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const uint32_t *l2, *fine_sb;
  int n;
  Grid g;
  float* t_out;
  int *lin_out, *alive_out;
  int* next_ray;
  int stripes, chunks;
};

// One ray's walk between brick steps: the ray, its nearest hit so far,
// the current brick and the brick moves left.
struct Walk {
  Ray r;
  Hit hit;
  int cx, cy, cz, moves;
};

__device__ __forceinline__ void write_out(const TraceArgs& a, int i,
                                          float t, int lin, int alive) {
  a.t_out[i] = t;
  a.lin_out[i] = lin;
  a.alive_out[i] = alive;
}

// 1. init (_fused_init) of admitted ray i: clip to the brick grid,
// fast-forward to t_min, entry brick.  Returns false where the ray misses
// the grid or its [t_min, t_max] (w.hit is then the miss).
__device__ __forceinline__ bool walk_start(const TraceArgs& a, int i,
                                           Walk& w) {
  const Grid& g = a.g;
  const float inf = __int_as_float(0x7f800000);
  Ray& r = w.r;
  r.ox = a.o[3 * i]; r.oy = a.o[3 * i + 1]; r.oz = a.o[3 * i + 2];
  r.dx = a.d[3 * i]; r.dy = a.d[3 * i + 1]; r.dz = a.d[3 * i + 2];
  r.t_lo = a.t_min[i];
  r.t_hi = a.t_max[i];
  r.inv_x = 1.0f / r.dx; r.inv_y = 1.0f / r.dy; r.inv_z = 1.0f / r.dz;
  r.sx = r.dx >= 0.0f ? 1 : -1;
  r.sy = r.dy >= 0.0f ? 1 : -1;
  r.sz = r.dz >= 0.0f ? 1 : -1;
  r.fx = r.sx > 0; r.fy = r.sy > 0; r.fz = r.sz > 0;
  w.hit.t = inf;
  w.hit.lin = -1;

  const float gmx = g.ogx + static_cast<float>(g.bx) * g.bw;
  const float gmy = g.ogy + static_cast<float>(g.by) * g.bw;
  const float gmz = g.ogz + static_cast<float>(g.bz) * g.bw;
  const float tbx = r.inv_x * (g.ogx - r.ox), tby = r.inv_y * (g.ogy - r.oy),
              tbz = r.inv_z * (g.ogz - r.oz);
  const float ttx = r.inv_x * (gmx - r.ox), tty = r.inv_y * (gmy - r.oy),
              ttz = r.inv_z * (gmz - r.oz);
  const float scale = fmaxf(
      fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz)),
      fmaxf(fmaxf(fmaxf(fabsf(g.ogx), fabsf(g.ogy)), fabsf(g.ogz)),
            fmaxf(fmaxf(fabsf(gmx), fabsf(gmy)), fabsf(gmz))));
  r.tie_eps = kTieUlps * 5.9604645e-8f * scale;  // 2^-24 = half an ulp at 1
  const float t_enter = jmax(jmax(jmin(tbx, ttx), jmin(tby, tty)),
                             jmin(tbz, ttz));
  const float t_exit = jmin(jmin(jmax(tbx, ttx), jmax(tby, tty)),
                            jmax(tbz, ttz));
  const float lo = jmax(jmax(t_enter, 0.0f), r.t_lo);
  const float t_start = lo + 1e-7f;
  const bool ok = (t_exit > jmax(t_enter, 0.0f)) && (t_start <= r.t_hi) &&
                  (t_start <= t_exit + 1e-7f);
  if (!ok) return false;
  const float px = r.ox + r.dx * t_start;
  const float py = r.oy + r.dy * t_start;
  const float pz = r.oz + r.dz * t_start;
  w.cx = clampi(floor_or((px - g.ogx) / g.bw, 0), 0, g.bx - 1);
  w.cy = clampi(floor_or((py - g.ogy) / g.bw, 0), 0, g.by - 1);
  w.cz = clampi(floor_or((pz - g.ogz) / g.bw, 0), 0, g.bz - 1);
  w.moves = g.bx + g.by + g.bz + 3;
  return true;
}

// One brick of the walk.  Returns true when the ray is done: an accepted
// cell, the grid's exit or t_max, a probed hit nearer than anything ahead,
// or the move cap (which sets `alive`).
__device__ __forceinline__ bool walk_brick(const TraceArgs& a, Walk& w,
                                           int& alive) {
  const Grid& g = a.g;
  const Ray& r = w.r;
  const float inf = __int_as_float(0x7f800000);
  const int scx = w.cx >> 3, scy = w.cy >> 3, scz = w.cz >> 3;
  const int sb = scx + g.sbx * (scy + g.sby * scz);
  const bool sb_occ = (__ldg(a.l2 + (sb >> 5)) >> (sb & 31)) & 1u;
  // 3-5. in an occupied superbrick, an occupied brick's per-voxel walk;
  // the first accept retires the ray
  if (sb_occ && brick_occupied(g, a.fine_sb, w.cx, w.cy, w.cz) &&
      fine_brick(r, g, a.fine_sb, w.cx, w.cy, w.cz, w.hit))
    return true;
  if (--w.moves < 0) {
    alive = 1;
    return true;
  }
  if (!sb_occ) {
    // 2. empty superbrick: a conservative skip to the last brick the ray
    // touches there, then the exact brick step below
    float tsx = (g.ogx + static_cast<float>((scx + r.fx) * 8) * g.bw -
                 r.ox) * r.inv_x;
    float tsy = (g.ogy + static_cast<float>((scy + r.fy) * 8) * g.bw -
                 r.oy) * r.inv_y;
    float tsz = (g.ogz + static_cast<float>((scz + r.fz) * 8) * g.bw -
                 r.oz) * r.inv_z;
    if (r.dx == 0.0f) tsx = inf;
    if (r.dy == 0.0f) tsy = inf;
    if (r.dz == 0.0f) tsz = inf;
    const float t_ex = jmin(tsx, jmin(tsy, tsz));
    int lx = floor_or((r.ox + r.dx * t_ex - g.ogx) / g.bw, w.cx + r.sx);
    int ly = floor_or((r.oy + r.dy * t_ex - g.ogy) / g.bw, w.cy + r.sy);
    int lz = floor_or((r.oz + r.dz * t_ex - g.ogz) / g.bw, w.cz + r.sz);
    lx = clampi(lx - r.sx, scx * 8, scx * 8 + 7);
    ly = clampi(ly - r.sy, scy * 8, scy * 8 + 7);
    lz = clampi(lz - r.sz, scz * 8, scz * 8 + 7);
    w.cx = r.sx > 0 ? max(lx, w.cx) : min(lx, w.cx);
    w.cy = r.sy > 0 ? max(ly, w.cy) : min(ly, w.cy);
    w.cz = r.sz > 0 ? max(lz, w.cz) : min(lz, w.cz);
  }
  // 6. one exact brick step; a ray that leaves its superbrick resumes the
  // superbrick walk at its next brick
  const float tmin = brick_step(r, g, a.fine_sb, w.cx, w.cy, w.cz, w.hit);
  return !(in_bricks(g, w.cx, w.cy, w.cz) && tmin <= r.t_hi) ||
         w.hit.t <= tmin;
}

// Persistent warps, launched as many as fit on the card at once.  The
// rays come in chunks of kWarp consecutive rays; chunk k belongs to
// stripe k % a.stripes, and each stripe has its own counter, so that the
// warps' atomics spread over that many words while all stripes advance
// through the frame side by side (each counter in its own 128-byte line:
// in one line the stripes gain nothing).  A warp takes chunks from its own
// stripe, then from the next ones that have chunks left.  Each lane reads
// one admit byte of the chunk and writes its ray's miss if the ray is not
// admitted; the warp hands the admitted rays to its idle lanes in ray
// order, fetching chunks until every idle lane has a ray or none is left.
// After every brick step, the lanes whose ray is done take the next rays.
__global__ void __launch_bounds__(kThreads) mega_trace_kernel(TraceArgs a) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  Walk w;
  int i = -1;            // this lane's ray: -1 none, a.n once none is left
  int base = 0;          // the warp's chunk: rays [base, base + kWarp)
  unsigned pending = 0;  // its admitted rays not yet handed out
  int stripe = (blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp) %
               a.stripes;         // the stripe the warp takes chunks from
  int left = a.stripes;  // stripes not yet found handed out
  for (;;) {
    const bool need = i < 0;
    unsigned want = __ballot_sync(0xffffffffu, need);
    while (want != 0u && (pending != 0u || left > 0)) {
      if (pending == 0u) {
        // the stripe's next chunk, or the next stripe's
        int got = -1;
        if (lane == 0) {
          int* ctr = a.next_ray + stripe * kCounterStride;
          // a plain read first: a handed-out stripe costs no atomic
          if (*static_cast<volatile int*>(ctr) * a.stripes + stripe <
              a.chunks)
            got = atomicAdd(ctr, 1) * a.stripes + stripe;
        }
        got = __shfl_sync(0xffffffffu, got, 0);
        if (got < 0 || got >= a.chunks) {
          stripe = stripe + 1 == a.stripes ? 0 : stripe + 1;
          --left;
          continue;
        }
        base = got * kWarp;
        const int c = base + lane;
        const bool adm = c < a.n && a.admit[c] != 0;
        if (c < a.n && !adm) write_out(a, c, inf, -1, 0);
        pending = __ballot_sync(0xffffffffu, adm);
        continue;
      }
      // the k-th lane of `want` takes the k-th admitted ray of `pending`
      const int take = min(__popc(want), __popc(pending));
      const int k = __popc(want & below);
      if (((want >> lane) & 1u) && k < take) {
        unsigned m = pending;
        for (int j = 0; j < k; ++j) m &= m - 1u;
        i = base + __ffs(m) - 1;
      }
      for (int j = 0; j < take; ++j) {
        want &= want - 1u;
        pending &= pending - 1u;
      }
    }
    if (need) {
      if (i < 0) {
        i = a.n;
      } else if (!walk_start(a, i, w)) {
        write_out(a, i, inf, -1, 0);
        i = -1;
      }
    }
    if (__all_sync(0xffffffffu, i >= a.n)) break;
    int alive = 0;
    if (i >= 0 && i < a.n && walk_brick(a, w, alive)) {
      write_out(a, i, w.hit.t, w.hit.lin, alive);
      i = -1;
    }
  }
}

// The kernel's arguments from the entry point's block.
TraceArgs trace_args(const MegaTraceArgs& b) {
  TraceArgs a;
  a.o = b.o;
  a.d = b.d;
  a.t_min = b.t_min;
  a.t_max = b.t_max;
  a.admit = b.admit;
  a.l2 = b.l2;
  a.fine_sb = b.fine_sb;
  a.n = b.n;
  a.g.nx = b.nx; a.g.ny = b.ny; a.g.nz = b.nz;
  a.g.bx = b.bx; a.g.by = b.by; a.g.bz = b.bz;
  a.g.sbx = (b.bx + 7) / 8;
  a.g.sby = (b.by + 7) / 8;
  a.g.ogx = b.ogx; a.g.ogy = b.ogy; a.g.ogz = b.ogz;
  a.g.vs = b.vs; a.g.half = b.half; a.g.bw = b.bw;
  a.t_out = b.t_out;
  a.lin_out = b.lin_out;
  a.alive_out = b.alive_out;
  a.next_ray = b.next_ray;
  a.stripes = b.stripes;
  a.chunks = (b.n + kWarp - 1) / kWarp;
  return a;
}

}  // namespace

// Launches as many blocks as fit on the card at once (no more than the
// rays need).
extern "C" int mega_trace_launch(const MegaTraceArgs* b, void* stream) {
  if (b->n <= 0) return 0;
  const TraceArgs a = trace_args(*b);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_trace_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min((a.n + kThreads - 1) / kThreads, sms * per_sm);
  mega_trace_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void mega_trace_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(MegaTraceArgs));
}
