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
// so there is no in-grid test (:140-141).  The table may be a window: it
// holds the NB bricks from id fine_off on (a Z-slab's block of brick ids,
// voxelray_tpu/ops/traverse_fast.py:152-226, with the port's one-layer
// halo).  Brick b is column b - fine_off, as in the TPU path's gather
// (_take_fine :229); a candidate brick outside the window counts as none,
// and a probe of a cell there reads nothing.
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
// The per-brick walk (fine_brick, with cell_slab, accepts and probe_cell)
// is in brick_walk.cuh, shared with K3 and the triangle march.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), so (t, lin) is bit-equal to the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

// brick_fine_launch's argument block (ops/kernels/brick_fine.py): the
// kernel's arguments, FineGrid's fields in its place (fine holds the nb
// bricks from fine_off on).
struct BrickFineArgs {
  const float *o, *d;
  const int* bricks;  // (k_slots, n)
  int k_slots;
  const uint32_t* fine;
  int nb, fine_off;
  const float *t_min, *t_max;
  int n, nx, ny, bx, by, bz;
  float ogx, ogy, ogz, vs, half, bwf, scale;
  float* t_out;
  int* lin_out;
};

namespace {

// o, d: (n, 3); bricks: (k_slots, n); fine: (16, g.nb) words of the bricks
// from g.off on; t_min, t_max: (n,).  Writes t_out, lin_out (n,).
__global__ void brick_fine_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const int* __restrict__ bricks, int k_slots,
    const uint32_t* __restrict__ fine, const float* __restrict__ t_min,
    const float* __restrict__ t_max, int n, FineGrid g,
    float* __restrict__ t_out, int* __restrict__ lin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(o, d, i, t_min[i], t_max[i]);
  set_tie_eps(r, g);
  float best_t = __int_as_float(0x7f800000);
  int best_lin = -1;
  for (int s = 0; s < k_slots; ++s) {
    const int bid = bricks[s * n + i];
    if (bid >= g.off && bid - g.off < g.nb &&
        fine_brick<true>(r, g, fine, bid, best_t, best_lin))
      break;
  }
  t_out[i] = best_t;
  lin_out[i] = best_lin;
}

}  // namespace

extern "C" int brick_fine_launch(const BrickFineArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const int threads = 128;
  const int blocks = (a->n + threads - 1) / threads;
  brick_fine_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a->o, a->d, a->bricks, a->k_slots, a->fine, a->t_min, a->t_max, a->n,
      fine_grid(*a, a->fine_off), a->t_out, a->lin_out);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void brick_fine_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(BrickFineArgs));
}
