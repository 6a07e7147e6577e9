// tri_bin: a deforming mesh's triangle table and its triangle accel's
// tables, written by the binning, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package bins a triangle accel's
// triangles with its voxelizer's bucket plan and hit mask
// (voxelray_tpu/ops/tri_accel.py:95-121), and the port did so with the
// plain PyTorch hit stream (ops/voxelize.tri_cell_pairs), ~200 ms of
// plain stream a build at 1M triangles.  A mesh that deforms every
// frame rebuilds its accel every frame, so the binning became kernels,
// and then the rows: a counting sort of every (triangle, cell) pair whose
// SAT passes inside the triangle's clamped window of the tri grid straight
// into the accel's tables (ops/tri_accel.py TriAccel):
//
//   cell_slot  (cells + 1,) int32: each cell's row of cell_tris, rows in
//              ascending cell order; -1 for an empty cell and at the end
//   mask       (cells,) uint8: 1 where the cell is nonempty
//   cell_tris  (rows, l_width) int32: each nonempty cell's triangles in
//              ascending id (the brute trace's lowest-index tie rule
//              needs it), -1 pads at the end
//
// Six kernels behind six entry points, in stream order:
//
//   tri_corners_kernel     the step's triangle table from its vertex array
//                          (tri9, the binning's input, and the scene's
//                          corners, flat normals and areas)
//   tri_bin_count_kernel   each cell's hit count (global atomics) and the
//                          triangles with a coordinate outside the
//                          caller's box (or not a number)
//   tri_cells_kernel       a warp a chunk of cells, the chunks taken in
//                          order: the mask; the chunk's first row, the
//                          nonempty cells of the chunks before it, by a
//                          look-back over their published counts; the
//                          chunk's cell_slot by a ballot a step; the sizes
//                          block's totals by atomics
//     (the wrapper reads the sizes block: the step's one host sync)
//   tri_bin_emit_kernel    the count pass's windows again, each hit
//                          written into its cell's row at the slot an
//                          atomic on the row's cursor hands out
//   tri_rows_kernel        a warp a row of at most kWarpRow hits: the
//                          row's entries ordered in registers (each one's
//                          rank among them), then the pads
//   tri_rows_wide_kernel   launched only where a row is longer: a warp a
//                          row, a bitonic sort in shared memory (up to
//                          kWideRow entries) or in the row itself
//
// The atomics leave a row's entries in an order that changes from run to
// run; a row's ids are distinct (a triangle's window lists each cell once),
// so ordering them gives one table, bit-equal to the plain version's
// (ops/kernels/tri_bin.py: cells_plain, rows_plain over the serial hit
// stream).
//
// What bounds it on the H100: the SAT arithmetic, as in K1: at the
// deforming knot's size (1.05M triangles, a 256-cell tri grid of 7.93M
// cells) ~19M window cells a pass of up to ~270 float operations each,
// many of which exit early, twice.  The bytes are small beside the card's
// bandwidth: the triangle rows (38 MB) read twice, the cells (31.7 MB)
// counted, read once and slotted (31.7 MB), 4 bytes and one atomic a hit
// (~3.3M), the rows (~40 MB) written; the corners pass moves ~124 MB once
// (the faces, the gathered corners, five outputs), staged a warp at a time
// so that the writes are contiguous.  The window loop is K1's: a warp
// takes 32 consecutive triangles a round, one a lane, stages them in shared
// memory, and lays the round's window cells over its lanes with no lane
// idle inside a window (voxel_accum.cu's comment).  The window and the SAT
// are csrc/sat.cuh's, K1's own.
//
// Numerics: --fmad=false and no fast math, as every kernel of the port:
// the tables, the flat normals and the areas are bit-equal to the plain
// versions'.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sat.cuh"

// Every pass's argument block (ops/kernels/tri_bin.py); a pass reads the
// fields it names.
struct TriBinArgs {
  const float* tri;  // (n_tri, 9) float32 rows v0 | v1 | v2
  int n_tri;
  float ogx, ogy, ogz, vs, half;
  int nx, ny, nz;
  float lox, loy, loz, hix, hiy, hiz;  // the caller's box
  int w0, w1;         // cells: the widths whose wider cells it counts
  int n_rows, l_width;  // emit, rows: the table's shape
  int* cell_count;    // count: (cells,), zeroed by the launcher
  long long* sizes;   // count: kSizes words, zeroed; cells: added to
  unsigned long long* status;  // cells: a word a chunk and the ticket
  int* cell_slot;     // cells: (cells + 1,)
  uint8_t* mask;      // cells: (cells,)
  int* cursor;        // emit: (n_rows,), zeroed by the launcher; rows: read
  int* cell_tris;     // emit, rows: (n_rows, l_width)
};

// The corners pass's block: the step's vertex array and faces in, the
// triangle table and the scene's per-triangle fields out.
struct TriCornersArgs {
  const float* verts;        // (V, 3)
  const long long* corners;  // (n_tri * 3,): the faces' vertex indices
  int n_tri;
  float* tri9;               // (n_tri + 1, 9): v0 | v1 | v2, then zeros
  float *v0, *v1, *v2;       // (n_tri, 3) each
  float* flat;               // (n_tri, 3): the flat face normals
  float* area;               // (n_tri,)
};

namespace {

// Lanes per warp: 32 on the card; the host test build runs one-lane warps.
#ifndef VOXELRAY_WARP
#define VOXELRAY_WARP 32
#endif
constexpr int kWarp = VOXELRAY_WARP;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;  // warps per block
constexpr unsigned kFull = 0xffffffffu;
// A row the warp path orders in registers; a longer one the wide path, in
// shared memory up to kWideRow (ops/tri_accel.L_WIDTHS[1]), else in place.
constexpr int kWarpRow = 64;
constexpr int kWideRow = 4096;
constexpr int kNoTri = 0x7fffffff;  // sorts after every triangle id
// The sizes block's words, which the wrapper reads in one copy.
enum { kPairs, kNonempty, kWidest, kOver0, kOver1, kOutside, kWide,
       kSizes = 8 };
// The cells pass's chunk: kLaneCells cells a lane, cell base + k * kWarp +
// lane in step k.  A chunk's status word: its state in the top two bits
// (0: not yet; kOwn: the count below is the chunk's own nonempty cells;
// kUpTo: those of every chunk up to it), the count below.
constexpr int kLaneCells = 64;
constexpr long long kChunk = static_cast<long long>(kLaneCells) * kWarp;
constexpr unsigned long long kOwn = 1ull << 62, kUpTo = 2ull << 62,
                             kCount = kOwn - 1;

// A warp's round of kWarp triangles, staged in shared memory: triangle j's
// vertices, its window's first cell and x, y extents and its first slot in
// the round (first[kWarp] is the round's slot total).
struct Round {
  float v[kWarp][9];
  int start[kWarp][3];
  int wx[kWarp], wy[kWarp];
  long long first[kWarp + 1];
};

__device__ __forceinline__ long long warp_id() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
         kWarp;
}

__device__ __forceinline__ long long n_warps() {
  return static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
}

__device__ __forceinline__ long long n_cells(const TriBinArgs& a) {
  return static_cast<long long>(a.nx) * a.ny * a.nz;
}

__device__ __forceinline__ bool in_box(const TriBinArgs& a, const float* p) {
  bool in = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = p[3 * c], y = p[3 * c + 1], z = p[3 * c + 2];
    in = in && x >= a.lox && x <= a.hix && y >= a.loy && y <= a.hiy &&
         z >= a.loz && z <= a.hiz;
  }
  return in;
}

// Stage this lane's triangle t of the round (its window empty if none or
// if a vertex is not finite) and scan the round's window sizes: returns
// the round's slot total.  Counts the triangle in *outside (where given)
// when it leaves the caller's box.
__device__ __forceinline__ long long stage(const TriBinArgs& a, Round& rd,
                                           int lane, long long t,
                                           unsigned long long* outside) {
  long long cap = 0;
  if (t < a.n_tri) {
    float* p = rd.v[lane];
#pragma unroll
    for (int i = 0; i < 9; ++i) p[i] = __ldg(a.tri + 9 * t + i);
    if (outside && !in_box(a, p)) ++*outside;
    if (all_finite9(p)) {
      int w[3];
      cap = sat_window(p, a.ogx, a.ogy, a.ogz, a.vs, a.nx, a.ny, a.nz,
                       rd.start[lane], w);
      rd.wx[lane] = w[0];
      rd.wy[lane] = w[1];
    }
  }
  // exclusive scan of the window sizes over the warp
  long long incl = cap;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  rd.first[lane] = incl - cap;
  if (lane == kWarp - 1) rd.first[kWarp] = incl;
  __syncwarp();
  return rd.first[kWarp];
}

// Slot k of the round, in triangle j's window: its cell and the SAT.
__device__ __forceinline__ bool slot_hit(const TriBinArgs& a, const Round& rd,
                                         int j, long long k, int* lin) {
  // a window holds fewer than 2^31 cells (the wrapper checks the grid)
  const unsigned q = static_cast<unsigned>(k - rd.first[j]);
  const unsigned wx = rd.wx[j], wy = rd.wy[j];
  const unsigned row = q / wx;
  const int cx = rd.start[j][0] + static_cast<int>(q - row * wx);
  const int cy = rd.start[j][1] + static_cast<int>(row % wy);
  const int cz = rd.start[j][2] + static_cast<int>(row / wy);
  const float ccx = a.ogx + (static_cast<float>(cx) + 0.5f) * a.vs;
  const float ccy = a.ogy + (static_cast<float>(cy) + 0.5f) * a.vs;
  const float ccz = a.ogz + (static_cast<float>(cz) + 0.5f) * a.vs;
  *lin = cx + a.nx * (cy + a.ny * cz);
  return tri_box_overlap(ccx, ccy, ccz, a.half, rd.v[j]);
}

// Both window passes: every round's slots, kWarp at a time (slot k's
// triangle j only moves forward as the lane's k grows); a hit counted in
// its cell (count) or written into its cell's row (emit).
template <bool kEmit>
__device__ __forceinline__ void bin_windows(const TriBinArgs& a, Round& rd) {
  const int lane = threadIdx.x % kWarp;
  const long long n_rounds = (a.n_tri + kWarp - 1) / kWarp;
  unsigned long long outside = 0;
  for (long long round = warp_id(); round < n_rounds; round += n_warps()) {
    const long long total = stage(a, rd, lane, round * kWarp + lane,
                                  kEmit ? nullptr : &outside);
    int j = 0;
    for (long long k = lane; k < total; k += kWarp) {
      while (k >= rd.first[j + 1]) ++j;
      int lin;
      if (!slot_hit(a, rd, j, k, &lin)) continue;
      if constexpr (kEmit) {
        const long long row = a.cell_slot[lin];
        const int at = atomicAdd(a.cursor + row, 1);
        // at < the cell's count <= l_width (the wrapper's rows are as wide
        // as the widest cell)
        if (at < a.l_width)
          a.cell_tris[row * a.l_width + at] =
              static_cast<int>(round * kWarp + j);
      } else {
        atomicAdd(a.cell_count + lin, 1);
      }
    }
    __syncwarp();  // the next round overwrites the staged triangles
  }
  if constexpr (!kEmit) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      outside += __shfl_down_sync(kFull, outside, off);
    if (lane == 0 && outside)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.sizes + kOutside),
                outside);
  }
}

__global__ void __launch_bounds__(kThreads)
    tri_bin_count_kernel(const TriBinArgs a) {
  __shared__ Round s_round[kWarps];
  bin_windows<false>(a, s_round[threadIdx.x / kWarp]);
}

__global__ void __launch_bounds__(kThreads)
    tri_bin_emit_kernel(const TriBinArgs a) {
  __shared__ Round s_round[kWarps];
  bin_windows<true>(a, s_round[threadIdx.x / kWarp]);
}

// The step's triangle table: a warp takes kWarp triangles, a lane one:
// its corners gathered, then scene._face_terms' float32 expressions term
// for term (the norm's root in float64, as there), staged in the warp's
// tile so that the warp writes each output's run of rows contiguously.
// Thread 0 writes the zero pad row.
struct CornerTile {
  float p[kWarp * 9];  // the corners, v0 | v1 | v2 a triangle
  float f[kWarp * 4];  // the flat normal and the area a triangle
};

__global__ void __launch_bounds__(kThreads)
    tri_corners_kernel(const TriCornersArgs a) {
  __shared__ CornerTile s_tile[kWarps];
  CornerTile& tile = s_tile[threadIdx.x / kWarp];
  const int lane = threadIdx.x % kWarp;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 9; ++i) a.tri9[9ll * a.n_tri + i] = 0.0f;
  for (long long t0 = warp_id() * kWarp; t0 < a.n_tri;
       t0 += n_warps() * kWarp) {
    const long long t = t0 + lane;
    const int m = static_cast<int>(min(static_cast<long long>(kWarp),
                                       a.n_tri - t0));
    if (lane < m) {
      float* p = tile.p + 9 * lane;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long v = a.corners[3 * t + c];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          p[3 * c + d] = __ldg(a.verts + 3 * v + d);
      }
      const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
      const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
      const float n[3] = {e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                          e1x * e2y - e1y * e2x};
      const float sq = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
      const float norm = static_cast<float>(sqrt(static_cast<double>(sq)));
      const float div = fmaxf(norm, 1e-30f);
      float* f = tile.f + 4 * lane;
#pragma unroll
      for (int d = 0; d < 3; ++d) f[d] = norm > 0.0f ? n[d] / div : n[d];
      f[3] = 0.5f * norm;
    }
    __syncwarp();
    for (int i = lane; i < 9 * m; i += kWarp) a.tri9[9 * t0 + i] = tile.p[i];
    for (int i = lane; i < 3 * m; i += kWarp) {
      const int j = i / 3, d = i - 3 * j;
      a.v0[3 * t0 + i] = tile.p[9 * j + d];
      a.v1[3 * t0 + i] = tile.p[9 * j + 3 + d];
      a.v2[3 * t0 + i] = tile.p[9 * j + 6 + d];
      a.flat[3 * t0 + i] = tile.f[4 * j + d];
    }
    if (lane < m) a.area[t] = tile.f[4 * lane + 3];
    __syncwarp();  // the next triangles overwrite the tile
  }
}

// The cells pass: a warp takes chunks by ticket, so the chunks before its
// own are held by warps already running, which publish their own counts
// before they wait on anything (no wait can close a cycle).  For each
// chunk: its counts (registers: one bit a cell), its own nonempty count
// published, then the look-back (the published counts of the chunks
// before it, kWarp at a time, back to one that publishes every chunk up
// to it), then every chunk up to it published and its cells' mask bytes
// and rows, kWarp at a time, a ballot each.  The warp of the last chunk
// writes the nonempty total and the trailing -1; every warp adds its
// totals to the sizes block (the count pass zeroed it).
__global__ void __launch_bounds__(kThreads)
    tri_cells_kernel(const TriBinArgs a) {
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  const long long n = n_cells(a);
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  volatile unsigned long long* status = a.status;
  long long pairs = 0;
  int widest = 0, over0 = 0, over1 = 0, wide = 0;
  for (;;) {
    unsigned long long c = 0;
    if (lane == 0) c = atomicAdd(a.status + n_chunks, 1ull);
    c = __shfl_sync(kFull, c, 0);
    if (c >= static_cast<unsigned long long>(n_chunks)) break;
    const long long base = static_cast<long long>(c) * kChunk;
    unsigned long long bits = 0;  // bit k: the lane's cell of step k
    // loads only: a store through the byte mask could alias the counts,
    // and would keep the loads from running ahead
#pragma unroll 8
    for (int k = 0; k < kLaneCells; ++k) {
      const long long i = base + static_cast<long long>(k) * kWarp + lane;
      const int m = i < n ? a.cell_count[i] : 0;
      bits |= static_cast<unsigned long long>(m > 0) << k;
      pairs += m;
      widest = max(widest, m);
      over0 += m > a.w0;
      over1 += m > a.w1;
      wide += m > kWarpRow;
    }
    long long own = __popcll(bits);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      own += __shfl_xor_sync(kFull, own, off);
    if (lane == 0) status[c] = (c ? kOwn : kUpTo) | own;
    // the look-back, kWarp chunks at a time, lane l reading chunk p - l:
    // every count down to the nearest chunk that publishes all up to it
    long long first = 0;
    for (long long p = static_cast<long long>(c) - 1; p >= 0; p -= kWarp) {
      const long long q = p - lane;
      unsigned long long st = kUpTo;  // past chunk 0: nothing, all up to it
      do {
        if (q >= 0) st = status[q];
      } while (__any_sync(kFull, st < kOwn));
      const unsigned up = __ballot_sync(kFull, st >= kUpTo);
      const int last = up ? __ffs(up) - 1 : kWarp - 1;
      long long got = lane <= last ? static_cast<long long>(st & kCount) : 0;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        got += __shfl_xor_sync(kFull, got, off);
      first += got;
      if (up) break;
    }
    if (lane == 0) status[c] = kUpTo | (first + own);
    long long row = first;
    for (int k = 0; k < kLaneCells; ++k) {
      const long long i = base + static_cast<long long>(k) * kWarp + lane;
      const bool full = (bits >> k) & 1;
      const unsigned ballot = __ballot_sync(kFull, full);
      if (i < n) {
        a.mask[i] = full;
        a.cell_slot[i] =
            full ? static_cast<int>(row + __popc(ballot & below)) : -1;
      }
      row += __popc(ballot);
    }
    if (lane == 0 && c == static_cast<unsigned long long>(n_chunks) - 1) {
      a.sizes[kNonempty] = first + own;
      a.cell_slot[n] = -1;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    pairs += __shfl_down_sync(kFull, pairs, off);
    widest = max(widest, __shfl_down_sync(kFull, widest, off));
    over0 += __shfl_down_sync(kFull, over0, off);
    over1 += __shfl_down_sync(kFull, over1, off);
    wide += __shfl_down_sync(kFull, wide, off);
  }
  if (lane != 0) return;
  // the totals, where not 0: few atomics on the block's words
  using u64 = unsigned long long;
  u64* sizes = reinterpret_cast<u64*>(a.sizes);
  if (pairs) atomicAdd(sizes + kPairs, static_cast<u64>(pairs));
  if (widest) atomicMax(sizes + kWidest, static_cast<u64>(widest));
  if (over0) atomicAdd(sizes + kOver0, static_cast<u64>(over0));
  if (over1) atomicAdd(sizes + kOver1, static_cast<u64>(over1));
  if (wide) atomicAdd(sizes + kWide, static_cast<u64>(wide));
}

// Row r's filled entries: the emit pass's count, at most l_width.
__device__ __forceinline__ int row_length(const TriBinArgs& a, long long r) {
  return min(a.cursor[r], a.l_width);
}

// The warp path: a warp a row of at most kWarpRow entries, kPer of them a
// lane (entry i = lane + kWarp * r in v[r]; past the row's end kNoTri),
// ordered by a bitonic network: a partner in another lane by a shuffle,
// in another register of the lane in place.  A row of at most kWarp
// entries takes one register a lane.  Longer rows are the wide path's.
template <int kPer>
__device__ __forceinline__ void order_row(int* row, int n, int lane) {
  int v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + kWarp * r;
    v[r] = i < n ? row[i] : kNoTri;
  }
#pragma unroll
  for (int k = 2; k <= kWarp * kPer; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const bool up = ((lane + kWarp * r) & k) == 0;  // ascending run
        if (j < kWarp) {
          const int o = __shfl_xor_sync(kFull, v[r], j);
          v[r] = (((lane & j) == 0) == up) ? min(v[r], o) : max(v[r], o);
        } else if ((r & (j / kWarp)) == 0) {
          const int q = r | (j / kWarp);
          const int lo = min(v[r], v[q]), hi = max(v[r], v[q]);
          v[r] = up ? lo : hi;
          v[q] = up ? hi : lo;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (lane + kWarp * r < n) row[lane + kWarp * r] = v[r];
}

__global__ void __launch_bounds__(kThreads)
    tri_rows_kernel(const TriBinArgs a) {
  const int lane = threadIdx.x % kWarp;
  for (long long r = warp_id(); r < a.n_rows; r += n_warps()) {
    const int n = row_length(a, r);
    if (n > kWarpRow) continue;
    int* row = a.cell_tris + r * a.l_width;
    if (n <= kWarp)
      order_row<1>(row, n, lane);
    else
      order_row<kWarpRow / kWarp>(row, n, lane);
    for (int i = n + lane; i < a.l_width; i += kWarp) row[i] = -1;
  }
}

// Orders x[0, n) ascending, one warp: a bitonic network over the next
// power of two whose entries past n count as larger than every id and are
// never touched.  Each merge's first step pairs i with its mirror
// i ^ (k - 1) and every later step i with i ^ j, the smaller id going to
// the lower index, so a pair reaching past n never moves (its entry there
// is the larger).
__device__ __forceinline__ void order_wide(int* x, int n, int lane) {
  for (int k = 2; k < 2 * n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int m = j == k >> 1 ? k - 1 : j;
      for (int i = lane; i < n; i += kWarp) {
        const int o = i ^ m;
        if (o <= i || o >= n) continue;
        const int p = x[i], q = x[o];
        if (p > q) {
          x[i] = q;
          x[o] = p;
        }
      }
      __syncwarp();
    }
  }
}

// The wide path: a block is one warp; it looks at kWarp rows at a time and
// orders each row longer than kWarpRow: up to kWideRow entries in shared
// memory, a longer row where it lies; then writes the row's pads.
__global__ void __launch_bounds__(kWarp)
    tri_rows_wide_kernel(const TriBinArgs a) {
  __shared__ int s[kWideRow];
  const int lane = threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kWarp;
  for (long long r0 = blockIdx.x * static_cast<long long>(kWarp);
       r0 < a.n_rows; r0 += step) {
    const bool wide = r0 + lane < a.n_rows && row_length(a, r0 + lane) >
                                                  kWarpRow;
    unsigned todo = __ballot_sync(kFull, wide);
    while (todo) {
      const long long r = r0 + __ffs(todo) - 1;
      todo &= todo - 1;
      const int n = row_length(a, r);
      int* row = a.cell_tris + r * a.l_width;
      if (n <= kWideRow) {
        for (int i = lane; i < n; i += kWarp) s[i] = row[i];
        __syncwarp();
        order_wide(s, n, lane);
        for (int i = lane; i < n; i += kWarp) row[i] = s[i];
      } else {
        order_wide(row, n, lane);
      }
      for (int i = n + lane; i < a.l_width; i += kWarp) row[i] = -1;
      __syncwarp();  // the next row overwrites s
    }
  }
}

// The card's multiprocessors times the blocks a grid-stride launch keeps
// in flight on each.
constexpr long long kMaxBlocks = 132 * 64;

unsigned blocks_for(long long warps, long long per_block) {
  const long long blocks = (warps + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// The count pass: cell_count (cells,) int32 and the sizes block (kSizes
// words) zeroed, then each cell's hits and the outside word added.
extern "C" int tri_bin_count_launch(const TriBinArgs* b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(b->nx) * b->ny * b->nz;
  cudaError_t err = cudaMemsetAsync(b->cell_count, 0, sizeof(int) * cells,
                                    st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(b->sizes, 0, sizeof(long long) * kSizes, st);
  if (err != cudaSuccess || b->n_tri <= 0) return static_cast<int>(err);
  tri_bin_count_kernel<<<blocks_for((b->n_tri + kWarp - 1) / kWarp, kWarps),
                         kThreads, 0, st>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// The cells pass, after the count pass: cell_slot, mask and the sizes
// block's words but kOutside; status holds at least one word a chunk and
// one more, zeroed here.
extern "C" int tri_cells_launch(const TriBinArgs* b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(b->nx) * b->ny * b->nz;
  const long long n_chunks = (cells + kChunk - 1) / kChunk;
  const cudaError_t err = cudaMemsetAsync(
      b->status, 0, sizeof(unsigned long long) * (n_chunks + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two chunks a warp on the knot's grid: few atomics on the sizes block
  tri_cells_kernel<<<blocks_for((n_chunks + 1) / 2, kWarps), kThreads, 0,
                     st>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// The corners pass: tri9, v0, v1, v2, flat and area written.
extern "C" int tri_corners_launch(const TriCornersArgs* b, void* stream) {
  tri_corners_kernel<<<blocks_for(b->n_tri / kWarp + 1, kWarps), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// The emit pass, after the cells pass: cursor (n_rows,) zeroed, then every
// hit in its row of cell_tris (n_rows, l_width), l_width at least the
// widest cell; the rest of each row unwritten.
extern "C" int tri_bin_emit_launch(const TriBinArgs* b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(b->cursor, 0, sizeof(int) * b->n_rows, st);
  if (err != cudaSuccess || b->n_tri <= 0) return static_cast<int>(err);
  tri_bin_emit_kernel<<<blocks_for((b->n_tri + kWarp - 1) / kWarp, kWarps),
                        kThreads, 0, st>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// The rows pass, after the emit pass: each row of at most kWarpRow entries
// ordered and padded with -1.
extern "C" int tri_rows_launch(const TriBinArgs* b, void* stream) {
  if (b->n_rows <= 0) return 0;
  tri_rows_kernel<<<blocks_for(b->n_rows, kWarps), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// The wide path of the rows pass: each longer row ordered and padded.
extern "C" int tri_rows_wide_launch(const TriBinArgs* b, void* stream) {
  if (b->n_rows <= 0) return 0;
  tri_rows_wide_kernel<<<blocks_for((b->n_rows + kWarp - 1) / kWarp, 1),
                         kWarp, 0, static_cast<cudaStream_t>(stream)>>>(*b);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument blocks (the wrapper's must match).
extern "C" void tri_bin_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(TriBinArgs));
  out[1] = static_cast<int>(sizeof(TriCornersArgs));
}
