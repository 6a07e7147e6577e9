// staged_march: the whole staged trace of every ray in one launch, for
// Hopper.
//
// Replaces the TPU kernels the JAX staged trace drives lap by lap, K3's
// brick walk (voxelray_tpu/ops/pallas/grid_walk.py, coarse_walk :496 and
// coarse_walk_init :569) and K4's per-voxel walk
// (voxelray_tpu/ops/pallas/brick_fine.py, fine_walk_multi :296), with the
// lap glue between them (voxelray_tpu/ops/traverse_fast.py:365,
// _trace_fast_impl: the rounds, the compaction of the active rays, the
// drain laps).  The port's plain version (ops/kernels/staged_march.py,
// staged_march_plain) runs the same laps as K3 and K4 launches from the
// host; this kernel gives its (t, lin, unresolved) bit for bit.
//
// One lane holds one ray, its state in registers: K3's fused init from
// t_min, then groups: K3 brick steps collecting k_first (later k_drain)
// occupied bricks, K4 over each brick as it is collected (in slot order, a
// brick outside the fine table's window counting as none), until a group
// ends with the ray's first accepted cell or the walk has nothing left.  A
// ray still walking after max_groups groups adds one to `unresolved` (0 by
// construction).  The walk is brick_walk.cuh's staged_group, shared with
// K3, K4 and tri_march.
//
// What bounds it on the H100: the latency of the longest rays' walks, a
// chain of dependent brick and fine-word loads, not bandwidth or
// arithmetic.  What the lap loop adds to that, and this design removes:
// each lap wrote k candidate bricks per ray to device memory and read them
// back, compacted the active rays with a host sync and gathered their
// inputs again.  Here the candidate bricks never leave registers and the
// host waits for nothing.  Persistent warps (as many as fit on the card)
// take rays in chunks of kWarp, dealt to `stripes` counters in turn, each
// in its own 128-byte line, as K2 (mega_trace.cu) does; at a fetch each lane
// reads one admit byte of the chunk and writes the miss of a ray that is
// not admitted, so a shadow pass that admits a few percent of the frame
// hands only those rays to lanes, with no host-side compaction.  After
// every group the lanes whose ray is done take the next rays, so no lane
// idles behind the longest ray of its warp (a refill after every brick
// step, as K2 does, was no faster on the bench frame and slower on its
// shadow pass: PERF.md).  The superbrick mask and, when it fits the 48 KB
// default shared memory beside it, the brick mask (15 KB at 512^3) are
// copied into shared memory once per block; the fine table is read
// through the read-only path.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), as K3 and K4, whose device code this kernel runs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 128;
// ints between two stripe counters: one 128-byte line each
constexpr int kCounterStride = 32;

// Everything one trace reads and writes.  o, d: (n, 3); t_min, t_max: (n,);
// admit: (n,) bytes, null for every ray; coarse (coarse_words), l2
// (l2_words, null for one level), fine (16, fg.nb) the bricks from fg.off
// on.  Outputs t, lin (n,) ((+inf, -1) on a miss), *unresolved; next_ray
// holds the zeroed counters, kCounterStride ints apart, of the stripes of
// chunks from which the warps take their rays.
struct StagedArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const uint32_t *coarse, *l2, *fine;
  int coarse_words, coarse_smem, l2_words, n;
  WalkGrid wg;
  FineGrid fg;
  Schedule sc;
  float* t_out;
  int* lin_out;
  unsigned long long* unresolved;
  int* next_ray;
  int stripes, chunks;
};

__device__ __forceinline__ void write_out(const StagedArgs& a, int i, float t,
                                          int lin) {
  a.t_out[i] = t;
  a.lin_out[i] = lin;
}

// Persistent warps.  Chunk k of kWarp consecutive rays belongs to stripe
// k % a.stripes; a warp takes chunks from its own stripe, then from the
// next ones that have chunks left, and hands the chunk's admitted rays to
// its idle lanes in ray order until every idle lane has a ray or none is
// left.  After every group the lanes whose ray is done take the next rays.
__global__ void __launch_bounds__(kThreads) staged_march_kernel(StagedArgs a) {
  extern __shared__ uint32_t s_tab[];
  for (int w = threadIdx.x; w < a.l2_words; w += blockDim.x)
    s_tab[w] = a.l2[w];
  if (a.coarse_smem)
    for (int w = threadIdx.x; w < a.coarse_words; w += blockDim.x)
      s_tab[a.l2_words + w] = a.coarse[w];
  __syncthreads();
  const uint32_t* s_l2 = a.l2 != nullptr ? s_tab : nullptr;
  const uint32_t* cmask = a.coarse_smem ? s_tab + a.l2_words : a.coarse;
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  Ray r;
  Staged s;
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
        const bool adm = c < a.n && (a.admit == nullptr || a.admit[c] != 0);
        if (c < a.n && !adm) write_out(a, c, inf, -1);
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
      } else {
        r = load_ray(a.o, a.d, i, a.t_min[i], a.t_max[i]);
        set_tie_eps(r, a.fg);
        staged_start(r, a.wg, s);
      }
    }
    if (__all_sync(0xffffffffu, i >= a.n)) break;
    if (i >= 0 && i < a.n) {
      const StagedEnd end =
          staged_group<true>(r, a.wg, a.fg, s_l2, cmask, a.fine, a.sc, s);
      if (end != StagedEnd::kMore) {
        if (end == StagedEnd::kBound) atomicAdd(a.unresolved, 1ull);
        write_out(a, i, s.t, s.lin);
        i = -1;
      }
    }
  }
}

// The kernel's arguments from the C entry point's (shared with the host
// build's launcher in tests/test_torch_kernels_host.py).
StagedArgs staged_args(
    const void* o, const void* d, const void* t_min, const void* t_max,
    const void* admit, const void* coarse, int coarse_words, const void* l2,
    int l2_words, const void* fine, int nb, int fine_off, int n, int nx,
    int ny, int bx, int by, int bz, float ogx, float ogy, float ogz,
    float vs, float half, float bwf, float scale, int k_first, int k_drain,
    int max_groups, int smem_words, void* t_out, void* lin_out,
    void* unresolved, void* next_ray, int stripes) {
  StagedArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.t_min = static_cast<const float*>(t_min);
  a.t_max = static_cast<const float*>(t_max);
  a.admit = static_cast<const uint8_t*>(admit);
  a.coarse = static_cast<const uint32_t*>(coarse);
  a.l2 = static_cast<const uint32_t*>(l2);
  a.fine = static_cast<const uint32_t*>(fine);
  a.coarse_words = coarse_words;
  a.l2_words = l2 != nullptr ? l2_words : 0;
  a.coarse_smem = a.l2_words + coarse_words <= smem_words;
  a.n = n;
  a.wg.bx = bx; a.wg.by = by; a.wg.bz = bz;
  a.wg.sbx = (bx + 7) / 8;
  a.wg.sby = (by + 7) / 8;
  a.wg.ogx = ogx; a.wg.ogy = ogy; a.wg.ogz = ogz; a.wg.bw = bwf;
  a.fg.nx = nx; a.fg.ny = ny; a.fg.bx = bx; a.fg.by = by; a.fg.bz = bz;
  a.fg.nb = nb;
  a.fg.off = fine_off;
  a.fg.ogx = ogx; a.fg.ogy = ogy; a.fg.ogz = ogz;
  a.fg.vs = vs; a.fg.half = half; a.fg.bwf = bwf; a.fg.scale = scale;
  a.sc.k_first = k_first;
  a.sc.k_drain = k_drain;
  a.sc.max_groups = max_groups;
  a.t_out = static_cast<float*>(t_out);
  a.lin_out = static_cast<int*>(lin_out);
  a.unresolved = static_cast<unsigned long long*>(unresolved);
  a.next_ray = static_cast<int*>(next_ray);
  a.stripes = stripes;
  a.chunks = (n + kWarp - 1) / kWarp;
  return a;
}

}  // namespace

// next_ray: stripes * 32 zeroed ints on the device (a counter every 128
// bytes); unresolved: a zeroed 64-bit counter.  Launches as many blocks as
// fit on the card at once (no more than the rays need).
extern "C" int staged_march_launch(
    const void* o, const void* d, const void* t_min, const void* t_max,
    const void* admit, const void* coarse, int coarse_words, const void* l2,
    int l2_words, const void* fine, int nb, int fine_off, int n, int nx,
    int ny, int bx, int by, int bz, float ogx, float ogy, float ogz,
    float vs, float half, float bwf, float scale, int k_first, int k_drain,
    int max_groups, int smem_words, void* t_out, void* lin_out,
    void* unresolved, void* next_ray, int stripes, void* stream) {
  if (n <= 0) return 0;
  const StagedArgs a = staged_args(
      o, d, t_min, t_max, admit, coarse, coarse_words, l2, l2_words, fine, nb,
      fine_off, n, nx, ny, bx, by, bz, ogx, ogy, ogz, vs, half, bwf, scale,
      k_first, k_drain, max_groups, smem_words, t_out, lin_out, unresolved,
      next_ray, stripes);
  const size_t smem =
      sizeof(uint32_t) * (a.l2_words + (a.coarse_smem ? coarse_words : 0));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, staged_march_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min((n + kThreads - 1) / kThreads, sms * per_sm);
  staged_march_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
