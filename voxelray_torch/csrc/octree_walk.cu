// The octree walk: the nearest voxel hit (and the shadow any-hit) over a
// Morton octree, one launch a trace.
//
// Replaces the host-stepped loop of ops/octree_traverse.py `_walk` (the
// JAX package's `_trace_octree_impl`, voxelray_tpu/ops/octree_traverse.py,
// a lax.while_loop of region steps over every ray at once, with no Pallas
// kernel of its own).  That loop stepped every live ray once per iteration
// and compacted the live rays between iterations: one `nonzero` and one
// host sync a region step, ~70k launches a shadowed 512^3 frame.  Here one
// thread follows one ray through all its region steps in registers, and
// the trace is one launch with no sync.
//
// Per ray, the semantics of `_walk`, expression for expression:
//   enter    clip to the root cube [origin, origin + vs * 2^bits]; the
//            walk starts at max(t_enter, 0) + 1e-6, in the cell there;
//            entering from outside, the sliver cells of the entry face
//            are probed (probe, below).
//   lookup   one read of the region map (Octree.region_map), then under
//            an INTERNAL entry of a coarse map (map_bits < bits) the
//            child-link descent for the remaining levels; without a map
//            the descent from the root.  The region is the deepest empty
//            octant or occupied leaf cube holding the cell.
//   test     on a leaf, the slab test of its first max_items items,
//            accepting t0 where t1 > max(t0, 0), t0 > 0 and t_min <= t0
//            <= t_max; the nearest accepted item (the first on a tie)
//            pends.
//   probe    where the pending hit lies past the region's exit less its
//            window, the sliver cells of the exit: the cell the ray leaves
//            by, stepped across each face plane crossed within the
//            TIE_ABS / TIE_REL window around the exit, over the seven
//            subsets of the axes, outside the region and inside the root
//            cube; each one's region tested as above.
//   advance  to max(region exit, t) + 1e-6; the ray ends at a pending hit
//            before the exit (its result), past the root cube's exit or
//            past t_max (the pending hit, else a miss); the next cell is
//            stepped past every region face crossed by then, and a ray
//            whose step crosses out of the root cube ends as a miss.
//   cut      a ray still walking after max_outer region steps returns a
//            miss and counts as cut.
// Built with --fmad=false and without fast math (ops/kernels/_build.py),
// every product and sum rounds separately, as PyTorch's elementwise ops
// do; min / max propagate NaN like torch.minimum / torch.maximum, argmin /
// argmax take the first NaN, else the first extreme, like torch's; floors
// go through `floor_cell` (ops/geometry.floor_cell's rule).  So t and lin
// are bit-equal to `_walk`'s, ray by ray (tests/test_torch_kernels_host.py
// holds a g++ build of this file to it).
//
// What bounds it on the H100: dependent loads, the region map's word and
// a leaf's item rows (16 bytes each, up to max_items), and divergent
// integer and float work per lane; the tables (a 64 MB region map at 2^8
// a side, the nodes, 16 bytes an item) are read through the read-only
// path.  A ray's state lives in registers.  One thread a ray, in the
// order of the frame's pixels, so a warp walks 32 neighbouring rays; in
// the any-hit mode a thread reads its ray's admit byte first and writes
// the not-admitted ray's result (not occluded) at once.  K2's schedule
// (persistent warps that refill a lane after each step) measured 30-45%
// slower here: a ray takes ~2.7 region steps on the benchmark's frames,
// too few for the refill to repay its fetch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// octree_walk_launch's argument block (ops/kernels/octree_walk.py).
//   o, d: (n, 3) rays; t_min, t_max: (n,), or null for the scalars t_lo /
//   t_hi; admit: (n,) bytes, or null (every ray walks).
//   region_map: int32[2^(3 map_bits)] (models/octree.build_region_map), or
//   null (the descent from the root); children: int32 (M, 8), -1 for an
//   empty octant; node_start, node_count: int32 (M,); items: int32 (rows,
//   4) item cells (x, y, z, 0).
//   Outputs: the nearest-hit mode writes t_out (n,) and lin_out (n,)
//   (hit_out null); the any-hit mode hit_out (n,) bytes, 1 where the walk
//   found a hit (t_out, lin_out null).  stats: null, or 4 zeroed uint64:
//   rays walked, region steps, rays cut at max_outer, the most region
//   steps of one ray.
struct OctreeWalkArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const int *region_map, *children, *node_start, *node_count, *items;
  int n, bits, map_bits, max_items, max_outer, nx, ny;
  float t_lo, t_hi, ogx, ogy, ogz, vs, half;
  float* t_out;
  int* lin_out;
  uint8_t* hit_out;
  unsigned long long* stats;
};

namespace {

// region map words (models/octree.py LEAF_FLAG, INTERNAL_FLAG)
constexpr int kLeafFlag = 1 << 30;
constexpr int kInternalFlag = 1 << 29;
// the walk's advance past a region's exit, and the window of a crossing
// (ops/octree_traverse.py TIE_ABS, TIE_REL = 2^-21)
constexpr float kAdvance = 1e-6f;
constexpr float kTieAbs = 1e-6f;
constexpr float kTieRel = 4.76837158203125e-07f;
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 128;

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

// floor(x) as a cell index: NaN -> 0, clamped to +-2^30
// (ops/geometry.floor_cell)
__device__ __forceinline__ int floor_cell(float x) {
  if (isnan(x)) return 0;
  return static_cast<int>(
      fminf(fmaxf(floorf(x), -1073741824.0f), 1073741824.0f));
}

// torch.argmin over three values: the first NaN, else the first minimum
__device__ __forceinline__ int argmin3(const float* v) {
  int k = 0;
  if (isnan(v[0])) return 0;
  if (isnan(v[1])) return 1;
  if (isnan(v[2])) return 2;
  if (v[1] < v[k]) k = 1;
  if (v[2] < v[k]) k = 2;
  return k;
}
// v[k] of three values without indexing an array by a variable (which
// would put the array in local memory)
__device__ __forceinline__ float pick3(const float* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}
// torch.argmax over three values: the first NaN, else the first maximum
__device__ __forceinline__ int argmax3(const float* v) {
  int k = 0;
  if (isnan(v[0])) return 0;
  if (isnan(v[1])) return 1;
  if (isnan(v[2])) return 2;
  if (v[1] > v[k]) k = 1;
  if (v[2] > v[k]) k = 2;
  return k;
}

struct Ray {
  float o[3], d[3], inv[3];
  float t_lo, t_hi;
};

// The nearest accepted hit found so far: t = +inf while there is none.
struct Hit {
  float t;
  int lin;
};

__device__ __forceinline__ bool accepts(const Ray& r, float t0, float t1) {
  return (t1 > jmax(t0, 0.0f)) && (t0 > 0.0f) && (t0 >= r.t_lo) &&
         (t0 <= r.t_hi);
}

// Coordinate k of the cell of the point o + d * t, unclamped (_cell_at).
__device__ __forceinline__ int cell_at(const OctreeWalkArgs& a, const Ray& r,
                                       int k, float t) {
  const float og = k == 0 ? a.ogx : (k == 1 ? a.ogy : a.ogz);
  return floor_cell((r.o[k] + r.d[k] * t - og) / a.vs);
}

__device__ __forceinline__ bool is_leaf(const OctreeWalkArgs& a, int node) {
  const int* ch = a.children + 8 * node;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (__ldg(ch + j) >= 0) return false;
  return true;
}

// The region of cell c (_region): its node, the log2 of its side in cells,
// and whether it is an occupied leaf.
__device__ __forceinline__ void region_of(const OctreeWalkArgs& a,
                                          const int* c, int& node, int& lg,
                                          bool& leaf) {
  const int bits = a.bits;
  int level = 0;
  node = 0;
  if (a.region_map) {
    const int ds = bits - a.map_bits;
    const int sm = 1 << a.map_bits;
    const int val = __ldg(a.region_map + ((c[0] >> ds) +
                                          sm * ((c[1] >> ds) +
                                                sm * (c[2] >> ds))));
    leaf = (val & kLeafFlag) != 0;
    lg = val & 31;
    node = (val >> 5) & ((1 << 25) - 1);
    // a coarse map's INTERNAL entry: the descent resumes below its node
    if (leaf || ds == 0 || !(val & kInternalFlag)) return;
    node = (val >> 5) & ((1 << 24) - 1);
    level = a.map_bits;
  } else if (is_leaf(a, 0)) {
    lg = bits;
    leaf = true;
    return;
  }
  for (; level < bits; ++level) {
    const int shift = bits - 1 - level;
    const int oct = ((c[0] >> shift) & 1) | (((c[1] >> shift) & 1) << 1) |
                    (((c[2] >> shift) & 1) << 2);
    const int child = __ldg(a.children + 8 * node + oct);
    lg = bits - (level + 1);
    if (child < 0) {
      leaf = false;
      return;
    }
    node = child;
    if (is_leaf(a, node)) {
      leaf = true;
      return;
    }
  }
  // a node at depth bits is a leaf by construction
  lg = 0;
  leaf = true;
}

// The region of cell c and its nearest accepted item, which replaces `h`
// if nearer (region_hits, then the caller's strict `<`).  Returns lg.
__device__ __forceinline__ int region_hits(const OctreeWalkArgs& a,
                                           const Ray& r, const int* c,
                                           Hit& h) {
  int node, lg;
  bool leaf;
  region_of(a, c, node, lg, leaf);
  if (!leaf) return lg;
  const int start = __ldg(a.node_start + node);
  const int count = min(__ldg(a.node_count + node), a.max_items);
  const float og[3] = {a.ogx, a.ogy, a.ogz};
  float tb = __int_as_float(0x7f800000);
  int lin = -1;
  for (int k = 0; k < count; ++k) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(a.items) + start + k);
    const int cell[3] = {q.x, q.y, q.z};
    float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float cc = og[ax] + (static_cast<float>(cell[ax]) + 0.5f) * a.vs;
      const float tb_ = r.inv[ax] * ((cc - a.half) - r.o[ax]);
      const float tt_ = r.inv[ax] * ((cc + a.half) - r.o[ax]);
      const float lo = jmin(tb_, tt_), hi = jmax(tb_, tt_);
      t0 = ax == 0 ? lo : jmax(t0, lo);
      t1 = ax == 0 ? hi : jmin(t1, hi);
    }
    if (accepts(r, t0, t1) && t0 < tb) {
      tb = t0;
      lin = q.x + a.nx * (q.y + a.ny * q.z);
    }
  }
  if (tb < h.t) {
    h.t = tb;
    h.lin = lin;
  }
  return lg;
}

// The sliver cells of a boundary crossing (`probe`): `base` is the cell a
// ray leaves at t_b, its region [lo, hi] (at the root cube's entry the cell
// outside, lo = hi = base).  Each cell of base stepped across the planes of
// its faces that the ray crosses within the window around t_b, on two or
// more axes, outside [lo, hi] and inside the root cube, is tested like the
// walk's regions; the nearest accepted item pends in h.
__device__ __forceinline__ void probe(const OctreeWalkArgs& a, const Ray& r,
                                      const int* base, const int* lo,
                                      const int* hi, float t_b, Hit& h) {
  const float inf = __int_as_float(0x7f800000);
  const int side = 1 << a.bits;
  const float og[3] = {a.ogx, a.ogy, a.ogz};
  float t_fwd[3], t_back[3], win[3], dist[3];
  int step[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int up = r.d[k] > 0.0f ? 1 : 0;
    const float fwd = og[k] + static_cast<float>(base[k] + up) * a.vs;
    const float back = og[k] + static_cast<float>(base[k] + 1 - up) * a.vs;
    const bool moving = r.d[k] != 0.0f;
    t_fwd[k] = moving ? (fwd - r.o[k]) * r.inv[k] : inf;
    t_back[k] = moving ? (back - r.o[k]) * r.inv[k] : -inf;
    win[k] = moving ? kTieAbs + kTieRel * (fabsf(t_b) +
                                           (fabsf(fwd) + fabsf(r.o[k])) *
                                               fabsf(r.inv[k]))
                    : 0.0f;
    dist[k] = fabsf(t_fwd[k] - t_b);
    step[k] = up * 2 - 1;
  }
  const float w_first = pick3(win, argmin3(dist));
  int off[3], crossed = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = win[k] + w_first;
    off[k] = t_fwd[k] <= t_b + kAdvance + w
                 ? step[k]
                 : (t_back[k] >= t_b - w ? -step[k] : 0);
    crossed += off[k] != 0;
  }
  // one crossed plane is the walk's own landing; slivers need two
  if (crossed < 2) return;
  Hit best = {inf, -1};
  for (int s = 0; s < 7; ++s) {
    // the seven non-empty subsets of the three axes as bit masks, in
    // ops/octree_traverse._SUBSETS' order: 1, 2, 4, 3, 5, 6, 7
    const int m = s < 3 ? 1 << s : (s == 6 ? 7 : 7 - (4 >> (s - 3)));
    int pc[3];
    bool ok = true, outside = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool in = (m >> k) & 1;
      ok = ok && (!in || off[k] != 0);
      pc[k] = base[k] + (in ? off[k] : 0);
      outside = outside || pc[k] < lo[k] || pc[k] > hi[k];
      ok = ok && pc[k] >= 0 && pc[k] < side;
    }
    if (ok && outside) region_hits(a, r, pc, best);
  }
  if (best.t < h.t) h = best;
}

// One ray's walk (_walk): its nearest hit, or +inf / -1; `regions` its
// region steps, `cut` whether max_outer cut it.
__device__ Hit walk(const OctreeWalkArgs& a, const Ray& r, int& regions,
                    bool& cut) {
  const float inf = __int_as_float(0x7f800000);
  const Hit miss = {inf, -1};
  const int side = 1 << a.bits;
  const float og[3] = {a.ogx, a.ogy, a.ogz};
  const float extent = static_cast<float>(side) * a.vs;
  float tn[3], tf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float tb = r.inv[k] * (og[k] - r.o[k]);
    const float tt = r.inv[k] * ((og[k] + extent) - r.o[k]);
    tn[k] = jmin(tb, tt);
    tf[k] = jmax(tb, tt);
  }
  const float t_enter = jmax(jmax(tn[0], tn[1]), tn[2]);
  const float t_exit = jmin(jmin(tf[0], tf[1]), tf[2]);
  float t = jmax(t_enter, 0.0f) + kAdvance;
  if (!((t_exit > jmax(t_enter, 0.0f)) && (t <= r.t_hi))) return miss;
  Hit h = miss;
  int cell[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    cell[k] = min(max(cell_at(a, r, k, t), 0), side - 1);
  if (t_enter > 0.0f) {
    // entering the root cube: the base is the cell outside it
    int base[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      base[k] = min(max(cell_at(a, r, k, t_enter), 0), side - 1);
    const int ax = argmax3(tn);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == ax) base[k] = r.d[k] > 0.0f ? -1 : side;
    probe(a, r, base, base, base, t_enter, h);
  }
  regions = 0;
  while (regions < a.max_outer) {
    ++regions;
    const int lg = region_hits(a, r, cell, h);
    int lo[3], hi[3];
    float t_ax[3];
    const float ext = static_cast<float>(1 << lg) * a.vs;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = (cell[k] >> lg) << lg;
      hi[k] = lo[k] + (1 << lg) - 1;
      const float rmin = og[k] + static_cast<float>(lo[k]) * a.vs;
      t_ax[k] = r.d[k] != 0.0f ? jmax((rmin - r.o[k]) * r.inv[k],
                                      (rmin + ext - r.o[k]) * r.inv[k])
                               : inf;
    }
    const float t_rex = jmin(jmin(t_ax[0], t_ax[1]), t_ax[2]);
    // probe the exit of rays still going and of those whose hit lies
    // within the exit plane's window
    const int a0 = argmin3(t_ax);
    const float o0 = pick3(r.o, a0);
    const float reach = fabsf(o0 + pick3(r.d, a0) * t_rex) + fabsf(o0);
    const float win0 =
        kTieAbs + kTieRel * (fabsf(t_rex) + reach * fabsf(pick3(r.inv, a0)));
    if (h.t > t_rex - win0) {
      int base[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        base[k] = min(max(cell_at(a, r, k, t_rex), lo[k]), hi[k]);
      probe(a, r, base, lo, hi, t_rex, h);
    }
    // a ray ends at a hit before its region's exit, at t_max, or past the
    // root cube
    t = jmax(t_rex, t) + kAdvance;
    if (!((h.t > t_rex) && (t < t_exit) && (t <= r.t_hi))) return h;
    // the next cell: at the new t, and past every face of the region whose
    // plane the ray has crossed by then
    bool out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool crossed = t_ax[k] <= t;
      int nxt = cell_at(a, r, k, t);
      if (crossed && r.d[k] > 0.0f) nxt = max(nxt, hi[k] + 1);
      else if (crossed && r.d[k] < 0.0f) nxt = min(nxt, lo[k] - 1);
      out = out || (crossed && (nxt < 0 || nxt >= side));
      cell[k] = min(max(nxt, 0), side - 1);
    }
    if (out) return miss;
  }
  cut = true;
  return miss;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    const unsigned long long u = __shfl_down_sync(0xffffffffu, v, s);
    v = u > v ? u : v;
  }
  return v;
}

// One thread a ray.  Every thread of a warp reaches the counters' warp
// reduction at the end.
__global__ void __launch_bounds__(kThreads) octree_walk_kernel(
    OctreeWalkArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int regions = 0;
  bool cut = false, walked = false;
  if (i < a.n) {
    Hit h = {__int_as_float(0x7f800000), -1};
    if (!a.admit || a.admit[i]) {
      Ray r;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        r.o[k] = a.o[3 * i + k];
        r.d[k] = a.d[3 * i + k];
        r.inv[k] = 1.0f / r.d[k];
      }
      r.t_lo = a.t_min ? a.t_min[i] : a.t_lo;
      r.t_hi = a.t_max ? a.t_max[i] : a.t_hi;
      walked = true;
      h = walk(a, r, regions, cut);
    }
    if (a.hit_out) {
      a.hit_out[i] = isfinite(h.t) ? 1 : 0;
    } else {
      a.t_out[i] = h.t;
      a.lin_out[i] = h.lin;
    }
  }
  if (a.stats) {
    const unsigned long long w = warp_sum(walked), g = warp_sum(regions),
                             c = warp_sum(cut),
                             m = warp_max(static_cast<unsigned long long>(
                                 regions));
    if (threadIdx.x % kWarp == 0) {
      atomicAdd(a.stats, w);
      atomicAdd(a.stats + 1, g);
      atomicAdd(a.stats + 2, c);
      atomicMax(a.stats + 3, m);
    }
  }
}

}  // namespace

extern "C" int octree_walk_launch(const OctreeWalkArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const int blocks = (a->n + kThreads - 1) / kThreads;
  octree_walk_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void octree_walk_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(OctreeWalkArgs));
}
