// The staged brick walk's device code, shared by K3 (grid_walk.cu), K4
// (brick_fine.cu), the staged trace (staged_march.cu) and the triangle
// march (tri_march.cu); the last two run both per ray (staged_group,
// staged_first_cell).  One copy of each walk, so the kernels cannot drift.
//
// K3, the brick-level walk (the Pallas kernels of
// voxelray_tpu/ops/pallas/grid_walk.py): walk_init is _fused_init (bbox
// clip, t_min fast-forward, entry brick), walk_land the two-level landing
// in an empty superbrick (:319-359), walk_step one exact brick step with
// next_t (:162-170) and the tie order x, then y, then z (:191-194).
// K4, the per-voxel walk through one brick (voxelray_tpu/ops/pallas/
// brick_fine.py): fine_brick, with the brick entry and its +1e-7 seed and
// clamp (:94-108), the slab test (:143-160), the cell step (:168-189) and
// the megakernel's near-tie steps and probes (see brick_fine.cu).
//
// A float floored into a cell index goes through floor_cell (NaN -> 0,
// clamped to +-2^30, as ops/geometry.floor_cell), where the reference's
// conversion is implementation-defined.  Every expression is written as the
// plain PyTorch versions evaluate it; built with --fmad=false and without
// fast math, the results are bit-equal to them.
//
// The including source provides the CUDA runtime (or the host test's
// stand-in for it) before this header.
#pragma once

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBrick = 8;
constexpr int kSteps = 3 * kBrick + 1;
// 16 ulps of the coordinate scale (2^-20 of it): the near-tie window of
// pick_axis, as in mega_trace.cu
constexpr float kTieScale = 9.5367432e-07f;

// K3's brick grid: brick dims, superbrick dims (x, y), origin, brick width
struct WalkGrid {
  int bx, by, bz, sbx, sby;
  float ogx, ogy, ogz, bw;
};

// K4's voxel grid: voxel dims (x, y), brick dims, the fine table's window
// (it holds the nb bricks from id off on: the whole grid, or a Z-slab's
// contiguous block of brick ids), origin, voxel size, half of it, brick
// width, and the largest |coordinate| of the brick grid's corners
struct FineGrid {
  int nx, ny, bx, by, bz, nb, off;
  float ogx, ogy, ogz, vs, half, bwf;
  float scale;
};

// The grids of an argument block b that holds their fields (bricks bx,
// by, bz; origin ogx, ogy, ogz; brick width bwf; cells nx, ny of size vs,
// half = vs / 2; the coordinate scale; the fine table's nb bricks), the
// fine table's window starting at brick `off`.
template <class B>
WalkGrid walk_grid(const B& b) {
  WalkGrid g;
  g.bx = b.bx; g.by = b.by; g.bz = b.bz;
  g.sbx = (b.bx + 7) / 8;
  g.sby = (b.by + 7) / 8;
  g.ogx = b.ogx; g.ogy = b.ogy; g.ogz = b.ogz; g.bw = b.bwf;
  return g;
}

template <class B>
FineGrid fine_grid(const B& b, int off) {
  FineGrid g;
  g.nx = b.nx; g.ny = b.ny; g.bx = b.bx; g.by = b.by; g.bz = b.bz;
  g.nb = b.nb;
  g.off = off;
  g.ogx = b.ogx; g.ogy = b.ogy; g.ogz = b.ogz;
  g.vs = b.vs; g.half = b.half; g.bwf = b.bwf; g.scale = b.scale;
  return g;
}

// One ray: origin, direction, its IEEE reciprocal, the accept bounds
// [t_lo, t_hi], K4's near-tie window, step signs and forward flags
struct Ray {
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
__device__ __forceinline__ bool bit_at(const uint32_t* table, int lin) {
  return (table[lin >> 5] >> (lin & 31)) & 1u;
}
__device__ __forceinline__ bool in_grid(const WalkGrid& g, int cx, int cy,
                                        int cz) {
  return cx >= 0 && cx < g.bx && cy >= 0 && cy < g.by && cz >= 0 &&
         cz < g.bz;
}

// Ray i of (n, 3) arrays o, d with accept bounds [t_lo, t_hi]; tie_eps is
// left 0 (set_tie_eps fills it for K4).
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i,
                                        float t_lo, float t_hi) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.t_lo = t_lo;
  r.t_hi = t_hi;
  r.tie_eps = 0.0f;
  r.inv_x = 1.0f / r.dx; r.inv_y = 1.0f / r.dy; r.inv_z = 1.0f / r.dz;
  r.sx = r.dx >= 0.0f ? 1 : -1;
  r.sy = r.dy >= 0.0f ? 1 : -1;
  r.sz = r.dz >= 0.0f ? 1 : -1;
  r.fx = r.sx > 0; r.fy = r.sy > 0; r.fz = r.sz > 0;
  return r;
}

// 16 ulps of the larger of the origin's and the grid's coordinate scale
__device__ __forceinline__ void set_tie_eps(Ray& r, const FineGrid& g) {
  r.tie_eps = kTieScale * fmaxf(fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)),
                                      fabsf(r.oz)), g.scale);
}

// ---- K3: the brick-level walk ---------------------------------------------

// _fused_init: bbox clip, t_min fast-forward, entry brick (cx, cy, cz);
// returns whether the walk starts active (r.t_hi is the ray's t_max)
__device__ __forceinline__ bool walk_init(const WalkGrid& g, const Ray& r,
                                          float t_min, int& cx, int& cy,
                                          int& cz) {
  const float gmx = g.ogx + static_cast<float>(g.bx) * g.bw;
  const float gmy = g.ogy + static_cast<float>(g.by) * g.bw;
  const float gmz = g.ogz + static_cast<float>(g.bz) * g.bw;
  const float tbx = r.inv_x * (g.ogx - r.ox), tby = r.inv_y * (g.ogy - r.oy),
              tbz = r.inv_z * (g.ogz - r.oz);
  const float ttx = r.inv_x * (gmx - r.ox), tty = r.inv_y * (gmy - r.oy),
              ttz = r.inv_z * (gmz - r.oz);
  const float t_enter = jmax(jmax(jmin(tbx, ttx), jmin(tby, tty)),
                             jmin(tbz, ttz));
  const float t_exit = jmin(jmin(jmax(tbx, ttx), jmax(tby, tty)),
                            jmax(tbz, ttz));
  const float lo = jmax(jmax(t_enter, 0.0f), t_min);
  const float t_start = lo + 1e-7f;
  cx = clampi(floor_cell((r.ox + r.dx * t_start - g.ogx) / g.bw), 0, g.bx - 1);
  cy = clampi(floor_cell((r.oy + r.dy * t_start - g.ogy) / g.bw), 0, g.by - 1);
  cz = clampi(floor_cell((r.oz + r.dz * t_start - g.ogz) / g.bw), 0, g.bz - 1);
  return (t_exit > jmax(t_enter, 0.0f)) && (t_start <= r.t_hi) &&
         (t_start <= t_exit + 1e-7f);
}

// Two-level walk: in an empty superbrick (bit clear in l2), land on the
// last brick the ray touches there (undershoot biased, never backward).
__device__ __forceinline__ void walk_land(const WalkGrid& g, const Ray& r,
                                          const uint32_t* l2, int& cx,
                                          int& cy, int& cz) {
  const int scx = cx >> 3, scy = cy >> 3, scz = cz >> 3;
  if (bit_at(l2, scx + g.sbx * (scy + g.sby * scz))) return;
  const float inf = __int_as_float(0x7f800000);
  float tsx = (g.ogx + static_cast<float>((scx + r.fx) * 8) * g.bw - r.ox) *
              r.inv_x;
  float tsy = (g.ogy + static_cast<float>((scy + r.fy) * 8) * g.bw - r.oy) *
              r.inv_y;
  float tsz = (g.ogz + static_cast<float>((scz + r.fz) * 8) * g.bw - r.oz) *
              r.inv_z;
  if (r.dx == 0.0f) tsx = inf;
  if (r.dy == 0.0f) tsy = inf;
  if (r.dz == 0.0f) tsz = inf;
  const float t_ex = jmin(tsx, jmin(tsy, tsz));
  const int lx = clampi(floor_cell((r.ox + r.dx * t_ex - g.ogx) / g.bw) - r.sx,
                        scx * 8, scx * 8 + 7);
  const int ly = clampi(floor_cell((r.oy + r.dy * t_ex - g.ogy) / g.bw) - r.sy,
                        scy * 8, scy * 8 + 7);
  const int lz = clampi(floor_cell((r.oz + r.dz * t_ex - g.ogz) / g.bw) - r.sz,
                        scz * 8, scz * 8 + 7);
  cx = r.sx > 0 ? max(lx, cx) : min(lx, cx);
  cy = r.sy > 0 ? max(ly, cy) : min(ly, cy);
  cz = r.sz > 0 ? max(lz, cz) : min(lz, cz);
}

// Brick lin of (cx, cy, cz) and whether that brick is occupied.  A cell
// outside the grid is empty (a two-level landing in a superbrick that
// sticks out of the grid can lie there; its lin would alias another row).
// kLdg reads `coarse` through the read-only path (global memory only);
// otherwise `coarse` may point to shared memory.
template <bool kLdg>
__device__ __forceinline__ bool walk_occupied(const WalkGrid& g,
                                              const uint32_t* coarse, int cx,
                                              int cy, int cz, int& lin) {
  lin = cx + g.bx * (cy + g.by * cz);
  if (!in_grid(g, cx, cy, cz)) return false;
  const uint32_t word = kLdg ? __ldg(coarse + (lin >> 5)) : coarse[lin >> 5];
  return (word >> (lin & 31)) & 1u;
}

// One exact brick step (tie order x, then y, then z); returns the time the
// ray leaves the brick it stepped from.
__device__ __forceinline__ float walk_step(const WalkGrid& g, const Ray& r,
                                           int& cx, int& cy, int& cz) {
  const float inf = __int_as_float(0x7f800000);
  float tx = (g.ogx + static_cast<float>(cx + r.fx) * g.bw - r.ox) * r.inv_x;
  float ty = (g.ogy + static_cast<float>(cy + r.fy) * g.bw - r.oy) * r.inv_y;
  float tz = (g.ogz + static_cast<float>(cz + r.fz) * g.bw - r.oz) * r.inv_z;
  if (r.dx == 0.0f) tx = inf;
  if (r.dy == 0.0f) ty = inf;
  if (r.dz == 0.0f) tz = inf;
  const float tmn = jmin(tx, jmin(ty, tz));
  if (tx == tmn)
    cx += r.sx;
  else if (ty == tmn)
    cy += r.sy;
  else
    cz += r.sz;
  return tmn;
}

// ---- K4: the per-voxel walk through one brick -------------------------------

// [t0, t1] of cell (gx, gy, gz) along the ray: the reference cell AABB
// slab test (raytrace.rint:46-56), the expressions of brick_fine.py:143-158
__device__ __forceinline__ void cell_slab(const Ray& r, const FineGrid& g,
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

// the reference's accept rule (t1 > max(t0, 0)) && (t0 > 0) and the
// renderer's t_lo <= t0 <= t_hi
__device__ __forceinline__ bool accepts(const Ray& r, float t0, float t1) {
  return (t1 > jmax(t0, 0.0f)) && (t0 > 0.0f) && (t0 >= r.t_lo) &&
         (t0 <= r.t_hi);
}

// Occupied-and-accepted test of one cell anywhere in the grid, read from
// the word-major fine table; a nearer accept replaces (best_t, best_lin).
// kWindow: the table is a window of g.nb bricks from id g.off on (K4), and
// a cell whose brick lies outside it reads as empty; otherwise the table
// holds every brick of the grid and g.off is not read (the triangle march).
template <bool kWindow>
__device__ __forceinline__ void probe_cell(
    const Ray& r, const FineGrid& g, const uint32_t* __restrict__ fine,
    int gx, int gy, int gz, float& best_t, int& best_lin) {
  if (gx < 0 || gy < 0 || gz < 0) return;
  const int bcx = gx >> 3, bcy = gy >> 3, bcz = gz >> 3;
  if (bcx >= g.bx || bcy >= g.by || bcz >= g.bz) return;
  int col = bcx + g.bx * (bcy + g.by * bcz);
  if (kWindow) {
    col -= g.off;
    if (col < 0 || col >= g.nb) return;
  }
  const int ll = (gx & 7) + kBrick * ((gy & 7) + kBrick * (gz & 7));
  if (!((__ldg(fine + (ll >> 5) * g.nb + col) >> (ll & 31)) & 1u)) return;
  float t0, t1;
  cell_slab(r, g, gx, gy, gz, t0, t1);
  if (accepts(r, t0, t1) && t0 < best_t) {
    best_t = t0;
    best_lin = gx + g.nx * (gy + g.ny * gz);
  }
}

// K4's walk through brick `bid`, which lies in the fine table (in its
// window, with kWindow as in probe_cell): a DDA over the <= 25 cells the
// ray crosses in it; the first accepted occupied cell, or a nearer probed
// one, becomes (best_t, best_lin).  Returns true once the ray's hit is
// decided (an accepted cell, or a probed candidate nearer than the current
// cell's exit); false when the ray leaves the brick or passes r.t_hi
// first.  Needs r.tie_eps (set_tie_eps).  The brick's own cell words come
// from word(w), w = 0..15 (fine_brick reads them from the table; a caller
// may read a copy of them); probes of other bricks read the table.
template <bool kWindow, class Word>
__device__ __forceinline__ bool fine_brick_words(
    const Ray& r, const FineGrid& g, const uint32_t* __restrict__ fine,
    int bid, float& best_t, int& best_lin, const Word& word) {
  const float inf = __int_as_float(0x7f800000);
  const float ia[3] = {fabsf(r.inv_x), fabsf(r.inv_y), fabsf(r.inv_z)};
  const float dk[3] = {r.dx, r.dy, r.dz};
  const int sk[3] = {r.sx, r.sy, r.sz};
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
        probe_cell<kWindow>(r, g, fine,
                            bcx * kBrick + lx - (k == 0 ? sk[k] : 0),
                            bcy * kBrick + ly - (k == 1 ? sk[k] : 0),
                            bcz * kBrick + lz - (k == 2 ? sk[k] : 0),
                            best_t, best_lin);
  }
  for (int step = 0; step < kSteps; ++step) {
    const int lin_local = lx + kBrick * (ly + kBrick * lz);
    const uint32_t cells = word(lin_local >> 5);
    const int gx = bcx * kBrick + lx;
    const int gy = bcy * kBrick + ly;
    const int gz = bcz * kBrick + lz;
    if ((cells >> (lin_local & 31)) & 1u) {
      float t0, t1;
      cell_slab(r, g, gx, gy, gz, t0, t1);
      if (accepts(r, t0, t1)) {
        if (t0 < best_t) {
          best_t = t0;
          best_lin = gx + g.nx * (gy + g.ny * gz);
        }
        return true;
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
    if (best_t <= tmn) return true;
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
          probe_cell<kWindow>(r, g, fine, gx + (k == 0 ? r.sx : 0),
                              gy + (k == 1 ? r.sy : 0),
                              gz + (k == 2 ? r.sz : 0), best_t, best_lin);
    }
    lx += axis == 0 ? r.sx : 0;
    ly += axis == 1 ? r.sy : 0;
    lz += axis == 2 ? r.sz : 0;
    const bool inb = lx >= 0 && lx < kBrick && ly >= 0 && ly < kBrick &&
                     lz >= 0 && lz < kBrick;
    if (!(inb && tmn <= r.t_hi)) return false;
  }
  return false;
}

// fine_brick_words with the brick's words read from the table
template <bool kWindow>
__device__ __forceinline__ bool fine_brick(const Ray& r, const FineGrid& g,
                                           const uint32_t* __restrict__ fine,
                                           int bid, float& best_t,
                                           int& best_lin) {
  const uint32_t* words = fine + (kWindow ? bid - g.off : bid);
  const int nb = g.nb;
  return fine_brick_words<kWindow>(
      r, g, fine, bid, best_t, best_lin,
      [words, nb](int w) { return __ldg(words + w * nb); });
}

// ---- the staged walk of one ray: K3's groups and K4 over them --------------

// The lap loop's schedule (ops/kernels/staged_march.py, staged_march_plain):
// candidate bricks of the first K4 call and of each drain call, and K4
// calls (groups) per staged trace at most
struct Schedule {
  int k_first, k_drain, max_groups;
};

// One ray's staged walk between groups: K3's resume state (brick, whether
// the walk goes on), the groups run, and the first accepted cell (t, lin),
// (+inf, -1) while there is none
struct Staged {
  int cx, cy, cz, group;
  bool active;
  float t;
  int lin;
};

// How a group ends: the walk goes on, the ray is done (s.lin is its cell,
// -1 a miss), or the ray is left at the group bound (a miss, counted as
// unresolved by the lap loop; never reached, by construction)
enum class StagedEnd { kMore, kDone, kBound };

// K3's fused init from r.t_lo
__device__ __forceinline__ void staged_start(const Ray& r, const WalkGrid& wg,
                                             Staged& s) {
  s.active = walk_init(wg, r, r.t_lo, s.cx, s.cy, s.cz);
  s.group = 0;
  s.t = __int_as_float(0x7f800000);
  s.lin = -1;
}

// One group, one K4 call of the lap loop: K3 brick steps collecting k_first
// (later k_drain) occupied bricks, K4 over each brick as it is collected,
// in slot order; the group ends with a candidate that ends the search, and
// then the ray is done.  Otherwise the ray goes on (K3's `cont`) from where
// K3 stopped.  l2 is null for the single-level walk; coarse may be in shared
// memory.  kWindow: the fine table is a window (probe_cell), and a brick
// outside it counts as no candidate, as in K4.  k4(lin, best_t, best_lin)
// is K4 over brick lin (fine_brick's contract; staged_group's is
// fine_brick itself).
template <bool kWindow, class K4>
__device__ __forceinline__ StagedEnd staged_group_with(
    const Ray& r, const WalkGrid& wg, const FineGrid& fg, const uint32_t* l2,
    const uint32_t* coarse, const Schedule& sc, Staged& s, const K4& k4) {
  const int k = s.group == 0 ? sc.k_first : sc.k_drain;
  const int max_steps = wg.bx + wg.by + wg.bz + 3;
  int cx = s.cx, cy = s.cy, cz = s.cz;
  bool active = s.active;
  float best_t = __int_as_float(0x7f800000);
  int best_lin = -1;
  int nhit = 0;
  bool done = false;
  for (int step = 0; step < max_steps && active; ++step) {
    if (l2 != nullptr) walk_land(wg, r, l2, cx, cy, cz);
    int lin;
    if (walk_occupied<false>(wg, coarse, cx, cy, cz, lin)) {
      ++nhit;
      // K4 over the collected brick; once K4 is done with this group the
      // walk still collects the group's bricks (its resume state)
      if (!done && (!kWindow || (lin >= fg.off && lin - fg.off < fg.nb)) &&
          k4(lin, best_t, best_lin)) {
        if (best_lin >= 0) {
          s.t = best_t;
          s.lin = best_lin;
          return StagedEnd::kDone;
        }
        done = true;
      }
    }
    const float tmn = walk_step(wg, r, cx, cy, cz);
    active = nhit < k && in_grid(wg, cx, cy, cz) && tmn <= r.t_hi;
  }
  if (best_lin >= 0) {
    s.t = best_t;
    s.lin = best_lin;
    return StagedEnd::kDone;
  }
  if (!(in_grid(wg, cx, cy, cz) && (active || nhit >= k)))
    return StagedEnd::kDone;
  s.cx = cx;
  s.cy = cy;
  s.cz = cz;
  s.active = true;
  return ++s.group == sc.max_groups ? StagedEnd::kBound : StagedEnd::kMore;
}

// staged_group_with K4 reading the fine table
template <bool kWindow>
__device__ __forceinline__ StagedEnd staged_group(
    const Ray& r, const WalkGrid& wg, const FineGrid& fg, const uint32_t* l2,
    const uint32_t* coarse, const uint32_t* __restrict__ fine,
    const Schedule& sc, Staged& s) {
  return staged_group_with<kWindow>(
      r, wg, fg, l2, coarse, sc, s,
      [&r, &fg, fine](int lin, float& best_t, int& best_lin) {
        return fine_brick<kWindow>(r, fg, fine, lin, best_t, best_lin);
      });
}

// The first accepted cell after r.t_lo along the staged walk, in s (the
// (t, lin) trace_grid_fast(mega=False, k_hits=sc.k_first) gives this ray).
template <bool kWindow>
__device__ __forceinline__ StagedEnd staged_first_cell(
    const Ray& r, const WalkGrid& wg, const FineGrid& fg, const uint32_t* l2,
    const uint32_t* coarse, const uint32_t* __restrict__ fine,
    const Schedule& sc, Staged& s) {
  staged_start(r, wg, s);
  StagedEnd end;
  do {
    end = staged_group<kWindow>(r, wg, fg, l2, coarse, fine, sc, s);
  } while (end == StagedEnd::kMore);
  return end;
}

}  // anonymous namespace
