// K4: the per-voxel walk through each ray's candidate bricks, for Hopper.
//
// Replaces the Pallas kernel of voxelray_tpu/ops/pallas/brick_fine.py
// (_make_kernel, launched by fine_walk_multi, pallas_call :296).  Per ray:
// for each of its <= K candidate bricks in order (brick lin, -1 = none),
// a DDA over the <= 25 cells the ray crosses inside the brick, with the
// reference's per-cell slab test and accept rule
// (t1 > max(t0, 0)) && (t0 > 0) && (t_min <= t0 <= t_max)
// (raytrace.rint:46-56); the first accepted cell, in slot order, gives
// (t0, global cell lin); a ray with none gets (+inf, -1).
//
// The TPU kernel takes the candidate bricks' 16 occupancy words gathered
// into a (K, 16, N) array beforehand, because a TPU lane cannot load from
// a table.  This kernel reads the word it needs from the accel's fine
// table (16, NB), word-major, by brick id: that saves writing and reading
// K x 16 x N words per call.  Padded cells of the boundary bricks hold 0,
// so there is no in-grid test (:140-141).
//
// Every expression keeps the Pallas kernel's shape: the brick entry with
// its +1e-7 seed and clamp (:94-108), the slab test (:143-160) and the
// cell step with the tie order x, then y, then z (:168-189).  A float
// floored into a cell index goes through floor_cell (NaN -> 0, clamped to
// +-2^30), as in the plain version (ops/kernels/brick_fine.py).
//
// One addition to the Pallas walk, the near-tie handling of the
// megakernel (mega_trace.cu: pick_axis, probe_cell): where two crossing
// times tie within 16 ulps of the coordinate scale over |d|, the ray
// passes next to an edge, the reference's per-cell slab tests are not
// watertight there, and the exact tie rule can step around a one-ulp
// sliver cell that the slab test accepts (the staged walk of the JAX
// package does so for ray 888349 of the 1920x1080 bench frame: it hits
// cell (313, 168, 362) at 7.0028 where the exhaustive reference hits
// (314, 169, 361) at 6.9904).  The step then follows the slab test, the
// other near-tied neighbours are probed, and so is the cell behind an
// entry face the ray crosses within the same noise; the nearest probed
// accept is the ray's hit once the walk is past its t.  Elsewhere the
// walk is the Pallas one.
//
// What bounds it on the H100: latency of the per-thread walk (a few dozen
// instructions per cell) and one dependent word load per cell from the
// fine table, which at 512^3 is 16.8 MB and stays in the 50 MB L2.  One
// thread follows one ray; a slot without a brick (-1) costs one load.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), so (t, lin) is bit-equal to the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBrick = 8;
constexpr int kSteps = 3 * kBrick + 1;
// 16 ulps of the coordinate scale (2^-20 of it): the near-tie window of
// pick_axis, as in mega_trace.cu
constexpr float kTieScale = 9.5367432e-07f;

struct FineGrid {
  int nx, ny, bx, by, bz, nb;
  float ogx, ogy, ogz, vs, half, bwf;
  float scale;  // largest |coordinate| of the grid's corners
};

struct FineRay {
  float ox, oy, oz, dx, dy, dz, inv_x, inv_y, inv_z, t_lo, t_hi, tie_eps;
  int sx, sy, sz, fx, fy, fz;
};

__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
// floor(x) as an int: NaN -> 0, clamped to +-2^30 (geometry.floor_cell)
__device__ __forceinline__ int floor_cell(float x) {
  if (isnan(x)) return 0;
  return static_cast<int>(
      fminf(fmaxf(floorf(x), -1073741824.0f), 1073741824.0f));
}

// [t0, t1] of cell (gx, gy, gz) along the ray: the reference cell AABB
// slab test (raytrace.rint:46-56), the expressions of brick_fine.py:143-158
__device__ __forceinline__ void cell_slab(const FineRay& r, const FineGrid& g,
                                          int gx, int gy, int gz, float& t0,
                                          float& t1) {
  const float ccx = g.ogx + (static_cast<float>(gx) + 0.5f) * g.vs;
  const float ccy = g.ogy + (static_cast<float>(gy) + 0.5f) * g.vs;
  const float ccz = g.ogz + (static_cast<float>(gz) + 0.5f) * g.vs;
  float tb = r.inv_x * ((ccx - g.half) - r.ox);
  float tt = r.inv_x * ((ccx + g.half) - r.ox);
  t0 = jmin(tb, tt);
  t1 = jmax(tb, tt);
  tb = r.inv_y * ((ccy - g.half) - r.oy);
  tt = r.inv_y * ((ccy + g.half) - r.oy);
  t0 = jmax(t0, jmin(tb, tt));
  t1 = jmin(t1, jmax(tb, tt));
  tb = r.inv_z * ((ccz - g.half) - r.oz);
  tt = r.inv_z * ((ccz + g.half) - r.oz);
  t0 = jmax(t0, jmin(tb, tt));
  t1 = jmin(t1, jmax(tb, tt));
}

__device__ __forceinline__ bool accepts(const FineRay& r, float t0,
                                        float t1) {
  return (t1 > jmax(t0, 0.0f)) && (t0 > 0.0f) && (t0 >= r.t_lo) &&
         (t0 <= r.t_hi);
}

// Occupied-and-accepted test of one cell anywhere in the grid, read from
// the word-major fine table; a nearer accept replaces (best_t, best_lin).
__device__ __forceinline__ void probe_cell(
    const FineRay& r, const FineGrid& g, const uint32_t* __restrict__ fine,
    int gx, int gy, int gz, float& best_t, int& best_lin) {
  if (gx < 0 || gy < 0 || gz < 0) return;
  const int bcx = gx >> 3, bcy = gy >> 3, bcz = gz >> 3;
  if (bcx >= g.bx || bcy >= g.by || bcz >= g.bz) return;
  const int bid = bcx + g.bx * (bcy + g.by * bcz);
  const int ll = (gx & 7) + kBrick * ((gy & 7) + kBrick * (gz & 7));
  if (!((__ldg(fine + (ll >> 5) * g.nb + bid) >> (ll & 31)) & 1u)) return;
  float t0, t1;
  cell_slab(r, g, gx, gy, gz, t0, t1);
  if (accepts(r, t0, t1) && t0 < best_t) {
    best_t = t0;
    best_lin = gx + g.nx * (gy + g.ny * gz);
  }
}

// o, d: (n, 3); bricks: (k_slots, n); fine: (16, nb) words; t_min, t_max:
// (n,).  Writes t_out, lin_out (n,).
__global__ void brick_fine_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const int* __restrict__ bricks, int k_slots,
    const uint32_t* __restrict__ fine, const float* __restrict__ t_min,
    const float* __restrict__ t_max, int n, FineGrid g,
    float* __restrict__ t_out, int* __restrict__ lin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float inf = __int_as_float(0x7f800000);
  FineRay r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.t_lo = t_min[i];
  r.t_hi = t_max[i];
  r.inv_x = 1.0f / r.dx; r.inv_y = 1.0f / r.dy; r.inv_z = 1.0f / r.dz;
  r.sx = r.dx >= 0.0f ? 1 : -1;
  r.sy = r.dy >= 0.0f ? 1 : -1;
  r.sz = r.dz >= 0.0f ? 1 : -1;
  r.fx = r.sx > 0; r.fy = r.sy > 0; r.fz = r.sz > 0;
  r.tie_eps = kTieScale * fmaxf(fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)),
                                      fabsf(r.oz)), g.scale);
  const float ia[3] = {fabsf(r.inv_x), fabsf(r.inv_y), fabsf(r.inv_z)};
  const float dk[3] = {r.dx, r.dy, r.dz};
  const int sk[3] = {r.sx, r.sy, r.sz};

  float best_t = inf;
  int best_lin = -1;
  bool done = false;
  for (int s = 0; s < k_slots && !done; ++s) {
    const int bid = bricks[s * n + i];
    if (bid < 0) continue;
    const int bcx = bid % g.bx;
    const int bcy = (bid / g.bx) % g.by;
    const int bcz = bid / (g.bx * g.by);
    const float bminx = g.ogx + static_cast<float>(bcx * kBrick) * g.vs;
    const float bminy = g.ogy + static_cast<float>(bcy * kBrick) * g.vs;
    const float bminz = g.ogz + static_cast<float>(bcz * kBrick) * g.vs;
    // entry t into the brick, one axis at a time (axis_entry)
    const float ex = r.dx == 0.0f ? -inf
                                  : jmin((bminx - r.ox) * r.inv_x,
                                         (bminx + g.bwf - r.ox) * r.inv_x);
    const float ey = r.dy == 0.0f ? -inf
                                  : jmin((bminy - r.oy) * r.inv_y,
                                         (bminy + g.bwf - r.oy) * r.inv_y);
    const float ez = r.dz == 0.0f ? -inf
                                  : jmin((bminz - r.oz) * r.inv_z,
                                         (bminz + g.bwf - r.oz) * r.inv_z);
    const float t_enter = jmax(jmax(ex, ey), ez);
    const float t_start = jmax(t_enter, 0.0f) + 1e-7f;
    int lx = clampi(floor_cell((r.ox + r.dx * t_start - bminx) / g.vs), 0, 7);
    int ly = clampi(floor_cell((r.oy + r.dy * t_start - bminy) / g.vs), 0, 7);
    int lz = clampi(floor_cell((r.oz + r.dz * t_start - bminz) / g.vs), 0, 7);
    {
      // The start cell floors the entry point.  Where the ray crosses one
      // of that cell's entry faces within float noise of the entry time,
      // the cell behind the face may be the true first cell: probe it.
      const float t_in = jmax(t_enter, 0.0f);
      const float ie = t_enter == ex ? ia[0] : (t_enter == ey ? ia[1] : ia[2]);
      const float face[3] = {
          (bminx + static_cast<float>(lx + 1 - r.fx) * g.vs - r.ox) * r.inv_x,
          (bminy + static_cast<float>(ly + 1 - r.fy) * g.vs - r.oy) * r.inv_y,
          (bminz + static_cast<float>(lz + 1 - r.fz) * g.vs - r.oz) * r.inv_z};
      for (int k = 0; k < 3; ++k)
        if (dk[k] != 0.0f && fabsf(face[k] - t_in) <= r.tie_eps * (ia[k] + ie))
          probe_cell(r, g, fine, bcx * kBrick + lx - (k == 0 ? sk[k] : 0),
                     bcy * kBrick + ly - (k == 1 ? sk[k] : 0),
                     bcz * kBrick + lz - (k == 2 ? sk[k] : 0), best_t,
                     best_lin);
    }
    const uint32_t* words = fine + bid;
    for (int step = 0; step < kSteps; ++step) {
      const int lin_local = lx + kBrick * (ly + kBrick * lz);
      const uint32_t word = __ldg(words + (lin_local >> 5) * g.nb);
      const int gx = bcx * kBrick + lx;
      const int gy = bcy * kBrick + ly;
      const int gz = bcz * kBrick + lz;
      if ((word >> (lin_local & 31)) & 1u) {
        float t0, t1;
        cell_slab(r, g, gx, gy, gz, t0, t1);
        if (accepts(r, t0, t1)) {
          if (t0 < best_t) {
            best_t = t0;
            best_lin = gx + g.nx * (gy + g.ny * gz);
          }
          done = true;
          break;
        }
      }
      // step to the next cell in the brick
      float tn[3] = {
          (bminx + static_cast<float>(lx + r.fx) * g.vs - r.ox) * r.inv_x,
          (bminy + static_cast<float>(ly + r.fy) * g.vs - r.oy) * r.inv_y,
          (bminz + static_cast<float>(lz + r.fz) * g.vs - r.oz) * r.inv_z};
      for (int k = 0; k < 3; ++k)
        if (dk[k] == 0.0f) tn[k] = inf;
      const float tmn = jmin(tn[0], jmin(tn[1], tn[2]));
      // a probed candidate nearer than this cell's exit is the nearest hit
      if (best_t <= tmn) {
        done = true;
        break;
      }
      // pick_axis of mega_trace.cu: the reference tie rule (x, then y,
      // then z), unless another crossing lies within tie_eps; then the
      // step follows the slab test and the other near-tied neighbours are
      // probed
      int axis = tn[0] == tmn ? 0 : (tn[1] == tmn ? 1 : 2);
      int near = 1 << axis;
      for (int k = 0; k < 3; ++k)
        if (isfinite(tn[k]) && tn[k] - tmn <= r.tie_eps * (ia[k] + ia[axis]))
          near |= 1 << k;
      if (near & (near - 1)) {
        bool pass[3];
        for (int k = 0; k < 3; ++k) {
          float t0, t1;
          cell_slab(r, g, gx + (k == 0 ? r.sx : 0), gy + (k == 1 ? r.sy : 0),
                    gz + (k == 2 ? r.sz : 0), t0, t1);
          pass[k] = t1 > t0;
        }
        if (!pass[axis])
          for (int k = 0; k < 3; ++k)
            if (k != axis && ((near >> k) & 1) && pass[k]) {
              axis = k;
              break;
            }
        for (int k = 0; k < 3; ++k)
          if (k != axis && ((near >> k) & 1))
            probe_cell(r, g, fine, gx + (k == 0 ? r.sx : 0),
                       gy + (k == 1 ? r.sy : 0), gz + (k == 2 ? r.sz : 0),
                       best_t, best_lin);
      }
      lx += axis == 0 ? r.sx : 0;
      ly += axis == 1 ? r.sy : 0;
      lz += axis == 2 ? r.sz : 0;
      const bool inb = lx >= 0 && lx < kBrick && ly >= 0 && ly < kBrick &&
                       lz >= 0 && lz < kBrick;
      if (!(inb && tmn <= r.t_hi)) break;
    }
  }
  t_out[i] = best_t;
  lin_out[i] = best_lin;
}

}  // namespace

extern "C" int brick_fine_launch(
    const void* o, const void* d, const void* bricks, int k_slots,
    const void* fine, int nb, const void* t_min, const void* t_max, int n,
    int nx, int ny, int bx, int by, int bz, float ogx, float ogy, float ogz,
    float vs, float half, float bwf, float scale, void* t_out, void* lin_out,
    void* stream) {
  if (n <= 0) return 0;
  FineGrid g;
  g.nx = nx; g.ny = ny; g.bx = bx; g.by = by; g.bz = bz; g.nb = nb;
  g.ogx = ogx; g.ogy = ogy; g.ogz = ogz;
  g.vs = vs; g.half = half; g.bwf = bwf; g.scale = scale;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  brick_fine_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int*>(bricks), k_slots,
      static_cast<const uint32_t*>(fine), static_cast<const float*>(t_min),
      static_cast<const float*>(t_max), n, g, static_cast<float*>(t_out),
      static_cast<int*>(lin_out));
  return static_cast<int>(cudaGetLastError());
}
