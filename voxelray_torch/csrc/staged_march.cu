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
// What bounds it on the H100: the latency of the longest rays, not
// bandwidth or arithmetic.  On the bench frame 98.8% of the primary rays
// end in their first group and none runs more than 5, but neighbouring
// rays graze the same surfaces, so the long rays come in clusters, and in
// one warp their walks diverge and take turns: the 40 longest take 2.7x
// as long packed into warps as one to a warp; alone, a long ray's cycles
// are three quarters K4's cell steps and probes (PERF.md).  The design:
//  - no intermediate tensors and no host round trips between groups (the
//    lap loop wrote k candidate bricks per ray to device memory, read
//    them back, compacted the active rays with a host sync and gathered
//    their inputs again);
//  - persistent warps (as many as fit on the card) take rays in chunks of
//    kWarp, dealt to `stripes` counters in turn, each in its own 128-byte
//    line, as K2 (mega_trace.cu) does; at a fetch each lane reads one
//    admit byte of the chunk and writes the miss of a ray that is not
//    admitted, so a shadow pass that admits a few percent of the frame
//    hands only those rays to lanes, with no host-side compaction; after
//    every group the lanes whose ray is done take the next rays (a refill
//    after every brick step, as K2 does, was no faster: PERF.md);
//  - when every ray is traced and rays outnumber lanes, a ray still
//    walking after kGroupBudget groups is deferred (its index and K3's
//    resume brick to a slot, its groups last; staged_group resumes from
//    them bit for bit, so any lane can take it on) and its lane takes a
//    new ray; once the stripes are spent, warps take the deferred rays
//    back by ticket, at most one and their share of those waiting each,
//    so the long rays spread over the card (tri_march's schedule);
//  - K4 copies the 16 words of each brick it walks into the lane's slot
//    of shared memory in one batch of cp.async copies, so a brick costs
//    one load latency instead of one per cell step (probes of other
//    bricks read the table);
//  - the superbrick mask and, when it fits the 48 KB default shared
//    memory beside it, the brick mask (15 KB at 512^3) are copied into
//    shared memory once per block; the fine table is read through the
//    read-only path;
//  - the deferral's state costs registers: __launch_bounds__ holds 6
//    blocks of 128 a multiprocessor, as before it.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), as K3 and K4, whose device code this kernel runs.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_walk.cuh"

// staged_march_launch's argument block (ops/kernels/staged_march.py):
// StagedArgs' inputs and outputs, the fields of its WalkGrid, FineGrid
// and Schedule in their place; smem_words: the shared memory words the
// tables may take.  next_ray: stripes * 32 zeroed ints (a counter every
// 128 bytes); unresolved: a zeroed 64-bit counter; sched: 3 * 32 zeroed
// ints; deferred: n int4 and deferred_group n zeroed ints where every ray
// is traced and n exceeds the lanes the launch holds (else null).
struct StagedMarchArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const uint32_t* coarse;
  int coarse_words;
  const uint32_t* l2;
  int l2_words;
  const uint32_t* fine;
  int nb, fine_off, n, nx, ny, bx, by, bz;
  float ogx, ogy, ogz, vs, half, bwf, scale;
  int k_first, k_drain, max_groups, smem_words;
  float* t_out;
  int* lin_out;
  unsigned long long* unresolved;
  int* next_ray;
  int stripes;
  int* sched;
  int4* deferred;
  int* deferred_group;
};

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 128;
// ints between two stripe counters: one 128-byte line each
constexpr int kCounterStride = 32;

// The ray schedule's setting (scripts/torch_staged_march_laps.py builds
// other values with -D): when every ray is traced and rays outnumber the
// lanes, a ray still walking after kGroupBudget groups is deferred (0:
// none).
#ifndef STAGED_GROUP_BUDGET
#define STAGED_GROUP_BUDGET 1
#endif
constexpr int kGroupBudget = STAGED_GROUP_BUDGET;
// the blocks a multiprocessor holds (__launch_bounds__): the deferral's
// state would otherwise take the registers of one
constexpr int kMinBlocks = 6;
// a brick's cell words (512 bits), one per row of a lane's slot
constexpr int kBrickWords = 16;

// The clock split (scripts/torch_staged_march_laps.py builds this file
// with -DSTAGED_MARCH_CLOCKS; ops/kernels/_build.py never does): each
// lane's clock64 cycles on its ray in four parts, added to the ray's row
// of g_ray_clocks (n rows of kClkParts + 1: the parts, then the groups
// the ray ran).  A lane's cycles include the time its warp spends on
// other lanes' paths, so the split is exact only for a ray alone.
enum { kClkK3 = 0, kClkLoads = 1, kClkK4 = 2, kClkWait = 3, kClkParts = 4 };
#ifdef STAGED_MARCH_CLOCKS
__device__ unsigned long long* g_ray_clocks;
struct LaneClocks {
  long long t;
  unsigned long long part[kClkParts];
  // a ray taken up (or resumed): its parts from now on
  __device__ __forceinline__ void start() {
    for (int k = 0; k < kClkParts; ++k) part[k] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void stamp(int k) {
    const long long now = clock64();
    part[k] += now - t;
    t = now;
  }
  // the ray's parts into its row (groups > 0: the ray is done after them)
  __device__ __forceinline__ void flush(int i, int groups) {
    unsigned long long* row = g_ray_clocks + static_cast<size_t>(i) *
                                                 (kClkParts + 1);
    for (int k = 0; k < kClkParts; ++k) atomicAdd(row + k, part[k]);
    if (groups > 0) row[kClkParts] = groups;
  }
};
#define STAGED_CLK(call) clk.call
#else
#define STAGED_CLK(call)
#endif

// The deferral's counters, each on a 128-byte line of its own (zeroed ints
// on the device, counter k at sched[k * kCounterStride]): the rays
// deferred, the tickets for deferred rays handed out, and the rays settled
// (done or deferred; each ray from the stripes once).  An idle warp sleeps
// between passes, kIdleNs at first, twice as long each pass up to 32
// times that, for as long as it must (no timer: see tri_march.cu, whose
// schedule this is, for why no idle warp waits forever).
enum { kDeferred = 0, kTicket = 1, kSettled = 2 };
// a lane's ticket while the ray it holds is one it took back
constexpr int kResumed = -2;
constexpr int kIdleNs = 256;

// Everything one trace reads and writes.  o, d: (n, 3); t_min, t_max: (n,);
// admit: (n,) bytes, null for every ray; coarse (coarse_words), l2
// (l2_words, null for one level), fine (16, fg.nb) the bricks from fg.off
// on.  Outputs t, lin (n,) ((+inf, -1) on a miss), *unresolved; next_ray
// holds the zeroed counters, kCounterStride ints apart, of the stripes of
// chunks from which the warps take their rays.  sched: the deferral's
// zeroed counters; deferred (n) and deferred_group (n, zeroed): a deferred
// ray's (index, brick) and its groups run (written last, nonzero: the
// slot is ready); deferred null: no ray is deferred.
struct StagedArgs {
  const float *o, *d, *t_min, *t_max;
  const uint8_t* admit;
  const uint32_t *coarse, *l2, *fine;
  int coarse_words, coarse_smem, l2_words, table_words, n;
  WalkGrid wg;
  FineGrid fg;
  Schedule sc;
  float* t_out;
  int* lin_out;
  unsigned long long* unresolved;
  int* next_ray;
  int stripes, chunks;
  int* sched;
  int4* deferred;
  int* deferred_group;
};

__device__ __forceinline__ void write_out(const StagedArgs& a, int i, float t,
                                          int lin) {
  a.t_out[i] = t;
  a.lin_out[i] = lin;
}

__device__ __forceinline__ int* counter(const StagedArgs& a, int k) {
  return a.sched + k * kCounterStride;
}

// Defers ray i at brick (cx, cy, cz) after `group` groups: (i, brick)
// into the next slot of `deferred` (its count at *count), its groups into
// deferred_group last (the ready flag), then one more ray settled.  (Out
// of line, as take_slot: both are rare, and inlined they cost the walk
// registers.)
__device__ __noinline__ void defer_ray(int* count, int* settled,
                                       int4* deferred, int* deferred_group,
                                       int i, int cx, int cy, int cz,
                                       int group) {
  const int k = atomicAdd(count, 1);
  deferred[k] = make_int4(i, cx, cy, cz);
  __threadfence();
  *reinterpret_cast<volatile int*>(deferred_group + k) = group;
  __threadfence();
  atomicAdd(settled, 1);
}

// Deferred slot k's groups, 0 until the slot is written (k < n: at most n
// rays are deferred)
__device__ __forceinline__ int slot_groups(const StagedArgs& a, int k) {
  return k < a.n ? reinterpret_cast<volatile int*>(a.deferred_group)[k] : 0;
}

// A written deferred slot: (ray, brick x, y, z).
__device__ __noinline__ int4 take_slot(const int4* slot) {
  __threadfence();
  const volatile int4* v = slot;
  return make_int4(v->x, v->y, v->z, v->w);
}

// Persistent warps.  Chunk k of kWarp consecutive rays belongs to stripe
// k % a.stripes; a warp takes chunks from its own stripe, then from the
// next ones that have chunks left, and hands the chunk's admitted rays to
// its idle lanes in ray order until every idle lane has a ray or none is
// left.  After every group the lanes whose ray is done take the next rays.
// With deferral (kGroupBudget > 0, every ray traced, more rays than
// lanes): a ray still walking after kGroupBudget groups is deferred and
// its lane takes a new ray; once the stripes are spent, a warp's lanes
// take tickets for deferred rays (in the order they were deferred) while
// the warp holds fewer rays and tickets than one plus its share of those
// waiting, so that the long rays spread over the warps.  A warp ends once
// it holds no ray and no ray can be deferred any more.  Dynamic shared
// memory: the l2 and (when it fits) the brick mask, then kBrickWords words
// a thread for K4's brick.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    staged_march_kernel(StagedArgs a) {
  extern __shared__ uint32_t s_tab[];
  for (int w = threadIdx.x; w < a.l2_words; w += blockDim.x)
    s_tab[w] = a.l2[w];
  if (a.coarse_smem)
    for (int w = threadIdx.x; w < a.coarse_words; w += blockDim.x)
      s_tab[a.l2_words + w] = a.coarse[w];
  __syncthreads();
  const uint32_t* s_l2 = a.l2 != nullptr ? s_tab : nullptr;
  const uint32_t* cmask = a.coarse_smem ? s_tab + a.l2_words : a.coarse;
  // this lane's slot: word w at stage[w * kThreads] (no bank shared)
  uint32_t* stage = s_tab + a.table_words + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const int warps = gridDim.x * (kThreads / kWarp);
  const bool defer = kGroupBudget > 0 && a.deferred != nullptr &&
                     a.admit == nullptr && a.n > gridDim.x * kThreads;
  Ray r;
  Staged s;
#ifdef STAGED_MARCH_CLOCKS
  LaneClocks clk;
#endif
  // K4 over brick lin, its words read from the lane's slot after one
  // batch of asynchronous copies
  const auto k4 = [&](int lin, float& best_t, int& best_lin) {
    STAGED_CLK(stamp(kClkK3));
    const uint32_t* src = a.fine + (lin - a.fg.off);
#pragma unroll
    for (int w = 0; w < kBrickWords; ++w)
      __pipeline_memcpy_async(stage + w * kThreads, src + w * a.fg.nb, 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    STAGED_CLK(stamp(kClkLoads));
    const bool got = fine_brick_words<true>(
        r, a.fg, a.fine, lin, best_t, best_lin,
        [stage](int w) { return stage[w * kThreads]; });
    STAGED_CLK(stamp(kClkK4));
    return got;
  };
  int i = -1;            // this lane's ray; -1 none
  // while the lane holds no ray: its deferred ray's slot, -1 none; while
  // it holds one: kResumed where that ray was deferred and taken back,
  // else -1
  int ticket = -1;
  int base = 0;          // the warp's chunk: rays [base, base + kWarp)
  unsigned pending = 0;  // its admitted rays not yet handed out
  int stripe = (blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp) %
               a.stripes;         // the stripe the warp takes chunks from
  int left = a.stripes;  // stripes not yet found handed out
  // the warp's rays done, not yet added to kSettled (lane 0's, in shared
  // memory: registers are the walk's)
  __shared__ int s_unsettled[kThreads / kWarp];
  int& unsettled = s_unsettled[threadIdx.x / kWarp];
  if (lane == 0) unsettled = 0;
  int sleep_ns = kIdleNs;
  // Once the stripes are spent: tickets for deferred rays into free lanes
  // while the warp holds fewer rays and tickets than one plus its share of
  // the deferred rays waiting (deferred - tickets; tickets read first, so
  // that the count waiting is never below the true one)
  const auto take_tickets = [&](int deferred, int tickets) {
    deferred = __shfl_sync(all, deferred, 0);
    tickets = __shfl_sync(all, tickets, 0);
    const unsigned free_lanes = __ballot_sync(all, i < 0 && ticket < 0);
    const int waiting = deferred - tickets;
    const int held = kWarp - __popc(free_lanes);
    const int room = waiting <= 0 ? 0
                                  : min(min(__popc(free_lanes), waiting),
                                        1 + waiting / warps - held);
    if (room <= 0) return;
    int first = 0;
    if (lane == 0) first = atomicAdd(counter(a, kTicket), room);
    first = __shfl_sync(all, first, 0);
    if (i < 0 && ticket < 0 && __popc(free_lanes & below) < room)
      ticket = first + __popc(free_lanes & below);
  };
  // this warp's settled rays into kSettled
  const auto settle = [&]() {
    if (lane == 0 && unsettled > 0) {
      atomicAdd(counter(a, kSettled), unsettled);
      unsettled = 0;
    }
  };
  for (;;) {
    const bool need = i < 0;
    unsigned want = __ballot_sync(all, need);
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
        got = __shfl_sync(all, got, 0);
        if (got < 0 || got >= a.chunks) {
          stripe = stripe + 1 == a.stripes ? 0 : stripe + 1;
          --left;
          continue;
        }
        base = got * kWarp;
        const int c = base + lane;
        const bool adm = c < a.n && (a.admit == nullptr || a.admit[c] != 0);
        if (c < a.n && !adm) write_out(a, c, inf, -1);
        pending = __ballot_sync(all, adm);
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
    const bool spent = pending == 0u && left <= 0;
    // this pass's new ray: a fresh one from the fetch (its slot group
    // 0), or the deferred ray of a written ticket
    int take = -1, group = 0;
    int4 slot;
    if (need && i >= 0) {
      take = i;
    } else if (need && ticket >= 0) {
      group = slot_groups(a, ticket);
      if (group != 0) {
        slot = take_slot(a.deferred + ticket);
        take = slot.x;
        ticket = kResumed;
      }
    }
    if (take >= 0) {
      i = take;
      r = load_ray(a.o, a.d, i, a.t_min[i], a.t_max[i]);
      set_tie_eps(r, a.fg);
      if (group == 0) {
        staged_start(r, a.wg, s);
      } else {
        s.cx = slot.y;
        s.cy = slot.z;
        s.cz = slot.w;
        s.group = group;
        s.active = true;
        s.t = inf;
        s.lin = -1;
      }
      STAGED_CLK(start());
    }
    if (__all_sync(all, i < 0)) {
      // no ray this pass (the stripes are spent): without deferral the
      // warp is done; with it, once no ray can be deferred any more,
      // tickets past the last deferred ray are dropped and a warp with no
      // ticket is done; otherwise take tickets and sleep, longer each time
      if (!defer) break;
      settle();
      int settled = 0, deferred = 0, tickets = 0;
      if (lane == 0) {
        tickets = *reinterpret_cast<volatile int*>(counter(a, kTicket));
        __threadfence();
        settled = *reinterpret_cast<volatile int*>(counter(a, kSettled));
        __threadfence();
        deferred = *reinterpret_cast<volatile int*>(counter(a, kDeferred));
      }
      settled = __shfl_sync(all, settled, 0);
      if (settled >= a.n && ticket >= __shfl_sync(all, deferred, 0))
        ticket = -1;
      take_tickets(deferred, tickets);
      if (settled >= a.n && __all_sync(all, ticket < 0)) break;
      __nanosleep(sleep_ns);
      sleep_ns = min(2 * sleep_ns, 32 * kIdleNs);
      continue;
    }
    sleep_ns = kIdleNs;
    bool fin = false;  // a ray from the stripes done this pass
    if (i >= 0) {
      STAGED_CLK(stamp(kClkWait));
      const StagedEnd end = staged_group_with<true>(r, a.wg, a.fg, s_l2,
                                                    cmask, a.sc, s, k4);
      STAGED_CLK(stamp(kClkK3));
      if (end != StagedEnd::kMore) {
        if (end == StagedEnd::kBound) atomicAdd(a.unresolved, 1ull);
        write_out(a, i, s.t, s.lin);
        STAGED_CLK(flush(i, s.group + (end == StagedEnd::kBound ? 0 : 1)));
        fin = ticket != kResumed;
        ticket = -1;
        i = -1;
      } else if (defer && ticket != kResumed && s.group >= kGroupBudget) {
        STAGED_CLK(flush(i, 0));
        defer_ray(counter(a, kDeferred), counter(a, kSettled), a.deferred,
                  a.deferred_group, i, s.cx, s.cy, s.cz, s.group);
        i = -1;
      }
    }
    if (defer) {
      const unsigned done = __ballot_sync(all, fin);
      if (lane == 0) unsettled += __popc(done);
      if (spent) {
        settle();
        int deferred = 0, tickets = 0;
        if (lane == 0) {
          tickets = *reinterpret_cast<volatile int*>(counter(a, kTicket));
          deferred = *reinterpret_cast<volatile int*>(counter(a, kDeferred));
        }
        take_tickets(deferred, tickets);
      }
    }
  }
}

// The kernel's arguments from the entry point's block.
StagedArgs staged_args(const StagedMarchArgs& b) {
  StagedArgs a;
  a.o = b.o;
  a.d = b.d;
  a.t_min = b.t_min;
  a.t_max = b.t_max;
  a.admit = b.admit;
  a.coarse = b.coarse;
  a.l2 = b.l2;
  a.fine = b.fine;
  a.coarse_words = b.coarse_words;
  a.l2_words = b.l2 != nullptr ? b.l2_words : 0;
  a.coarse_smem = a.l2_words + b.coarse_words <= b.smem_words;
  a.table_words = a.l2_words + (a.coarse_smem ? b.coarse_words : 0);
  a.n = b.n;
  a.wg = walk_grid(b);
  a.fg = fine_grid(b, b.fine_off);
  a.sc.k_first = b.k_first;
  a.sc.k_drain = b.k_drain;
  a.sc.max_groups = b.max_groups;
  a.t_out = b.t_out;
  a.lin_out = b.lin_out;
  a.unresolved = b.unresolved;
  a.next_ray = b.next_ray;
  a.stripes = b.stripes;
  a.chunks = (b.n + kWarp - 1) / kWarp;
  a.sched = b.sched;
  a.deferred = b.deferred;
  a.deferred_group = b.deferred_group;
  return a;
}

}  // namespace

// Dynamic shared memory of a block, in bytes: the tables and the slots.
static size_t smem_bytes(int table_words) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(table_words) + kBrickWords * kThreads);
}

// The opt-in above the default 48 KB, then the blocks a multiprocessor
// holds with that shared memory.
static cudaError_t blocks_per_sm(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      staged_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, staged_march_kernel, kThreads, smem);
  return err;
}

// The launch configuration for `table_words` words of tables (the l2 mask
// and, when it goes to shared memory, the brick mask): out = {kGroupBudget,
// threads a block, dynamic shared memory bytes, blocks a multiprocessor}.
extern "C" int staged_march_config(int table_words, int* out) {
  const size_t smem = smem_bytes(table_words);
  out[0] = kGroupBudget;
  out[1] = kThreads;
  out[2] = static_cast<int>(smem);
  return static_cast<int>(blocks_per_sm(smem, &out[3]));
}

// Launches as many blocks as fit on the card at once (no more than the
// rays need).
extern "C" int staged_march_launch(const StagedMarchArgs* b, void* stream) {
  if (b->n <= 0) return 0;
  const StagedArgs a = staged_args(*b);
  const size_t smem = smem_bytes(a.table_words);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm(smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = min((a.n + kThreads - 1) / kThreads, sms * per_sm);
  staged_march_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument block (the wrapper's must match).
extern "C" void staged_march_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(StagedMarchArgs));
}

#ifdef STAGED_MARCH_CLOCKS
// The clock split's rows: n * (kClkParts + 1) zeroed 64-bit counters on the
// device, for the launches that follow.
extern "C" int staged_march_clocks(void* rows) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_ray_clocks, &rows, sizeof(rows)));
}
#endif
