// K3: the resumable brick-level walk of the staged trace, for Hopper.
//
// Replaces the Pallas kernels of voxelray_tpu/ops/pallas/grid_walk.py:
// coarse_walk (_make_kernel / _make_kernel_2l, pallas_call :496) and
// coarse_walk_init (the same walk seeded by _fused_init, pallas_call :569).
// Per ray: walk the 8^3-brick grid with an exact DDA over the brick
// bitmask `coarse`, record the next k_hits occupied bricks (brick lin,
// -1 = none) and return the walk state after them, so a later call resumes
// there.  With the superbrick bitmask `l2`, a ray inside an empty
// superbrick first lands on the last brick it touches there (undershoot
// biased, never backward) and then takes one exact step: the brick
// sequence is the single-level walk's.
//
// What is ported is the walk, not the TPU's scheduling: the Pallas kernel
// muxes table rows through lane gathers (mux_lookup, hoist_rows) and caps
// the steps of a whole (BQ, 128) block; here one thread follows one ray, a
// table lookup is an indexed load, and each thread stops after
// bx+by+bz+3 steps, the per-lane bound that block cap stands for.
//
// Every expression keeps the Pallas kernel's shape: next_t (:162-170), the
// tie order x, then y, then z (:191-194), the two-level landing (:319-359)
// and the `cont` rule (:245).  Two deliberate differences, both in the
// plain version (ops/kernels/grid_walk.py) too:
//  - a float that is floored into a cell index goes through floor_cell,
//    which maps NaN to 0 and clamps to +-2^30 before the conversion, where
//    the reference's conversion is implementation-defined;
//  - a cell outside the grid is empty.  The Pallas two-level walk can land
//    outside the grid in a superbrick that sticks out of it (brick dims
//    not a multiple of 8) and then reads the brick bit at the aliased lin
//    cx + bx*(cy + by*cz): a brick elsewhere, sometimes occupied, which it
//    reports as a candidate the single-level walk never visits.  Here the
//    two-level brick sequence is the single-level one's.
//
// What bounds it on the H100: divergent, latency-bound integer and float
// stepping, a handful of instructions and one table load per brick.  The
// brick bitmask (<= 32 KB at 512^3, 4 KB for a 256-res triangle grid) is
// read through the read-only path and stays in L1; the superbrick bitmask
// is copied into shared memory once per block.  Rays arrive in the 8x128
// tile order of render_image, so a warp walks neighbouring pixels.
//
// The walk itself (walk_init, walk_land, walk_occupied, walk_step) is in
// brick_walk.cuh, shared with K4 and the triangle march.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py): every product, sum and division rounds as in the
// plain PyTorch version, so the brick sequence and the state are
// bit-equal to it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

// grid_walk_launch's argument block (ops/kernels/grid_walk.py): the
// kernel's arguments, WalkGrid's fields in its place.
struct GridWalkArgs {
  const float *o, *d, *t_min, *t_max;
  const int *cell_in, *active_in;
  const uint32_t *coarse, *l2;
  int l2_words, n, bx, by, bz;
  float ogx, ogy, ogz, bwf;
  int k_hits;
  int *hits_out, *cell_out, *cont_out;
};

namespace {

// o, d: (n, 3); t_max: (n,).  Entry state either from (cell_in (n, 3),
// active_in (n,)) or, when cell_in is null, from _fused_init with t_min.
// l2 (l2_words words) is null for the single-level walk.  Writes
// hits_out (k_hits, n), cell_out (n, 3) and cont_out (n,).
__global__ void grid_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const int* __restrict__ cell_in, const int* __restrict__ active_in,
    const uint32_t* __restrict__ coarse, const uint32_t* __restrict__ l2,
    int l2_words, int n, WalkGrid g, int k_hits, int* __restrict__ hits_out,
    int* __restrict__ cell_out, int* __restrict__ cont_out) {
  extern __shared__ uint32_t s_l2[];
  if (l2 != nullptr) {
    for (int w = threadIdx.x; w < l2_words; w += blockDim.x) s_l2[w] = l2[w];
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = t_max[i];
  const Ray r = load_ray(o, d, i, 0.0f, tmax);

  int cx, cy, cz;
  bool active;
  if (cell_in == nullptr) {
    active = walk_init(g, r, t_min[i], cx, cy, cz);
  } else {
    cx = cell_in[3 * i];
    cy = cell_in[3 * i + 1];
    cz = cell_in[3 * i + 2];
    active = active_in[i] != 0;
  }
  for (int s = 0; s < k_hits; ++s) hits_out[s * n + i] = -1;

  int nhit = 0;
  const int max_steps = g.bx + g.by + g.bz + 3;
  for (int step = 0; step < max_steps && active; ++step) {
    if (l2 != nullptr) walk_land(g, r, s_l2, cx, cy, cz);
    int lin;
    if (walk_occupied<true>(g, coarse, cx, cy, cz, lin))
      hits_out[(nhit++) * n + i] = lin;
    // one exact brick step; the lane that filled its last slot steps too,
    // so its cell is the resume position
    const float tmn = walk_step(g, r, cx, cy, cz);
    active = nhit < k_hits && in_grid(g, cx, cy, cz) && tmn <= tmax;
  }
  cell_out[3 * i] = cx;
  cell_out[3 * i + 1] = cy;
  cell_out[3 * i + 2] = cz;
  cont_out[i] = in_grid(g, cx, cy, cz) && (active || nhit >= k_hits);
}

}  // namespace

extern "C" int grid_walk_launch(const GridWalkArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const int threads = 128;
  const int blocks = (a->n + threads - 1) / threads;
  const size_t smem = a->l2 != nullptr ? sizeof(uint32_t) * a->l2_words : 0;
  grid_walk_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      a->o, a->d, a->t_min, a->t_max, a->cell_in, a->active_in, a->coarse,
      a->l2, a->l2_words, a->n, walk_grid(*a), a->k_hits, a->hits_out,
      a->cell_out, a->cont_out);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void grid_walk_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(GridWalkArgs));
}
