"""The CUDA kernels' own source, built for the host, against their plain
PyTorch versions.

csrc/voxel_accum.cu, mega_trace.cu, grid_walk.cu, brick_fine.cu,
staged_march.cu, tri_march.cu, frame_shade.cu (the frame glue: camera
rays, the closest-hit surface, shade + post; held to render/pipeline.py's
PyTorch glue), accel_build.cu (a voxel scene's brick accel tables and
its boxes; held to build_accel's PyTorch build and aabbs_from_linear),
tri_bin.cu and octree_walk.cu (held to ops/octree_traverse._walk) are
compiled with g++ (SHIM below standing in for the CUDA
runtime, each launch `kernel<<<...>>>(...)` running the kernel's blocks
and threads on the host, csrc/ on the include path for the shared
brick_walk.cuh), and each kernel runs thread by thread on the CPU.  The
tests call each source's own C entry point, int <kernel>_launch(const
<X>Args*, void*), with the argument block its wrapper builds
(ops/kernels/*.py), bound by the wrapper's _build.entry, which checks the
block's size against the build's `<file>_sizes`.  Shared memory is one
host array that the host launcher of a kernel whose threads fill it
(DRIVERS) fills before the threads run, so running them one at a time
never reads a word before it is written.  Every warp is one lane wide (the kernels
take their warp width from VOXELRAY_WARP, which SHIM sets to 1), so
warp-wide steps (K1's window scan and hit reduction, K2's, staged_march's
and tri_march's ray fetch, tri_march's shared row test) are exact and
K1's set_calls is compared too; asynchronous copies are made at once.
Both sides use IEEE float32 without contraction, as on the card, so
this holds the kernels' logic (windows, SAT, walk, near-tie probes, ray
schedules) to the plain versions without a GPU.  The held runs of
staged_march and tri_march run two of their warps at once on two host
threads, one of them stopped inside its first ray until the other has
idled, to show that an idle warp waits for a running warp's ray however
long that takes.  Skips where g++ is missing.
"""
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelray_torch.io import meshes
from voxelray_torch.io.objload import LoadedModel, Material
from voxelray_torch.io.textures import write_png
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.scene import Light, build_scene
from voxelray_torch.ops import geometry
from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
from voxelray_torch.ops.aabbs import aabbs_from_linear
from voxelray_torch.ops.kernels import (_build, accel_build, brick_fine,
                                        frame_shade, grid_walk, mega_trace,
                                        octree_walk, staged_march, tri_bin,
                                        tri_march, voxel_accum)
from voxelray_torch.ops.kernels.brick_fine import fine_plain
from voxelray_torch.ops.kernels.grid_walk import walk_plain
from voxelray_torch.ops.kernels.mega_trace import trace_grid_mega_plain
from voxelray_torch.ops.kernels.tri_march import tri_march_plain
from voxelray_torch.ops.traverse import trace_grid_dda
from voxelray_torch.ops.traverse_fast import build_accel, trace_grid_fast
from voxelray_torch.ops.tri_accel import build_tri_accel
from voxelray_torch.ops.voxelize import voxelize_plain
from voxelray_torch.render import pipeline, shading
from voxelray_torch.render.camera import Camera
from voxelray_torch.utils.parity import adjudicate_hit_diffs

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "voxelray_torch" / "csrc"
# tri_march's row chunk: the triangles a lane loads together from its row
ROW_CHUNK = int(re.search(r"constexpr int kRowChunk = (\d+);",
                          (CSRC / "tri_march.cu").read_text()).group(1))
# tri_march's ray schedule in the two host builds that the march tests
# run (-D settings csrc/tri_march.cu reads): "own", every row through its
# lane's row_test and no ray deferred; "shared", every lap's row through
# shared_rows (a one-lane warp holds one ray) and rays deferred after 2
# laps and taken back once the ray counter is spent
TRI_SCHEDULES = {"own": ["-DTRI_SHARE_LANES=0", "-DTRI_LAP_BUDGET=0"],
                 "shared": ["-DTRI_SHARE_LANES=1", "-DTRI_LAP_BUDGET=2"]}
# staged_march's ray schedule in the two host builds that its tests run
# (-D settings csrc/staged_march.cu reads): "undeferred", no ray
# deferred; "deferred", rays deferred after 1 group and taken back once
# the stripes are spent
STAGED_SCHEDULES = {"undeferred": ["-DSTAGED_GROUP_BUDGET=0"],
                    "deferred": ["-DSTAGED_GROUP_BUDGET=1"]}
# the host clock's step in the held runs: one step is past 2^33 cycles,
# the idle timeout tri_march once trapped at
HELD_CLOCK_STEP = 1 << 34
# idle passes of the free warp before the held warp goes on
HELD_PASSES = 4

# The CUDA subset csrc/*.cu uses, for a host build.  Each "thread" runs
# to completion one after another, as a warp of one lane: K1 and K2 see
# a warp width of 1 (lane 0), and so do staged_march and tri_march.
# Shuffles return the lane's own value, ballots its own bit.  A held run
# (host_set_held, host_run) runs threads 1 and 0 at once instead.  The
# card is one multiprocessor that holds one block, so a launcher that
# sizes its grid by occupancy launches one block; host_set_blocks(b > 0)
# runs b blocks in the place of every launch's grid.
SHIM = '''
#include <math.h>
#include <sched.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <thread>
using std::max;
using std::min;

#define VOXELRAY_WARP 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __shared__ static
#define __syncthreads()
#define __syncwarp()
#define __launch_bounds__(...)

static uint32_t host_shared[1 << 16];

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
static HostDim3 blockDim, gridDim;
static thread_local HostDim3 blockIdx, threadIdx;

// The held run: thread 1 stops at its first read of the fine table
// [host_fine_lo, host_fine_hi) (its ray taken, not done) until thread 0 has
// slept host_held_passes idle passes (or ended); host_idle_passes counts
// them.  0 passes: no held run.
static int host_held_passes = 0, host_idle_passes = 0;
static int host_release = 1, host_held = 0;
static const void *host_fine_lo = nullptr, *host_fine_hi = nullptr;
static thread_local int host_holder = 0;
extern "C" void host_set_held(int passes) { host_held_passes = passes; }
extern "C" int host_idle_count() { return host_idle_passes; }
inline void host_hold(const void* p) {
  if (!host_holder || p < host_fine_lo || p >= host_fine_hi) return;
  host_holder = 0;
  __atomic_store_n(&host_held, 1, __ATOMIC_SEQ_CST);
  while (!__atomic_load_n(&host_release, __ATOMIC_SEQ_CST)) sched_yield();
}
inline void __nanosleep(unsigned) {
  if (__atomic_add_fetch(&host_idle_passes, 1, __ATOMIC_SEQ_CST) >=
      host_held_passes)
    __atomic_store_n(&host_release, 1, __ATOMIC_SEQ_CST);
  sched_yield();
}
// The kernel's threads 0 .. threads - 1 one after another; in a held run
// threads 1 (held) and 0 at once, and no other
template <class F>
inline void host_run(unsigned threads, F kernel) {
  if (host_held_passes <= 0) {
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      kernel();
    }
    return;
  }
  host_release = 0;
  host_held = 0;
  host_idle_passes = 0;
  std::thread held([&] {
    threadIdx.x = 1;
    host_holder = 1;
    kernel();
    __atomic_store_n(&host_held, 1, __ATOMIC_SEQ_CST);
  });
  while (!__atomic_load_n(&host_held, __ATOMIC_SEQ_CST)) sched_yield();
  std::thread free_warp([&] {
    threadIdx.x = 0;
    kernel();
    __atomic_store_n(&host_release, 1, __ATOMIC_SEQ_CST);
  });
  free_warp.join();
  held.join();
}

template <class T>
inline T __ldg(const T* p) {
  host_hold(p);
  return *p;
}
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
inline float __uint_as_float(uint32_t i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
// asynchronous copies (the staging of tri_march's rows and staged_march's
// brick words): the copy is made at once, so committing and waiting have
// nothing to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  host_hold(src);
  memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// the deferred rays' slots, fenced as on the card (a held run has two
// threads)
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
// frame_shade.cu's per-ray record
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline void __trap() { abort(); }
// the clock advances HOST_CLOCK_STEP cycles a read
#ifndef HOST_CLOCK_STEP
#define HOST_CLOCK_STEP 1
#endif
inline long long clock64() {
  static long long t = 0;
  return __atomic_fetch_add(&t, static_cast<long long>(HOST_CLOCK_STEP),
                            __ATOMIC_SEQ_CST);
}
template <class T>
inline T atomicSub(T* p, T v) {
  return __atomic_fetch_sub(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
inline T atomicOr(T* p, T v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
inline T atomicMax(T* p, T v) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int) { return v; }
template <class T>
inline T __shfl_up_sync(unsigned, T v, int) { return v; }
template <class T>
inline T __shfl_down_sync(unsigned, T v, int) { return v; }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) {
  return p ? 1u : 0u;
}
inline bool __all_sync(unsigned, int p) { return p != 0; }
inline bool __any_sync(unsigned, int p) { return p != 0; }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount,
       cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t n,
                                   cudaStream_t) {
  memset(p, value, n);
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host build"; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = 1;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, K, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
static long long host_blocks = 0;
extern "C" void host_set_blocks(int blocks) { host_blocks = blocks; }
// kernel<<<grid, block, smem, stream>>>(args...), as _host_build rewrites
// it: every block of the grid, each one's threads through host_run
template <class K, class... A>
inline void host_grid(K kernel, long long grid, long long block, size_t,
                      cudaStream_t, A... args) {
  gridDim.x = static_cast<unsigned>(host_blocks > 0 ? host_blocks : grid);
  blockDim.x = static_cast<unsigned>(block);
  for (unsigned b = 0; b < gridDim.x; ++b) {
    blockIdx.x = b;
    host_run(blockDim.x, [&] { kernel(args...); });
  }
}
'''

# Host launchers of the kernels whose threads fill shared memory before
# they read it (grid_walk's l2, the marches' tables): the host build fills
# it first, then calls the source's own launcher.  A march's held run
# stops a thread at its first read of the fine table.
DRIVERS = {"grid_walk": """
extern "C" int host_launch(const GridWalkArgs* a, void* stream) {
  if (a->l2) memcpy(host_shared, a->l2, sizeof(uint32_t) * a->l2_words);
  return grid_walk_launch(a, stream);
}
"""}
for _name, _block, _pack in (
        ("staged_march", "StagedMarchArgs", "staged_args"),
        ("tri_march", "TriMarchArgs", "march_args")):
    DRIVERS[_name] = f"""
extern "C" int host_launch(const {_block}* b, void* stream) {{
  const auto a = {_pack}(*b);
  if (a.l2_words) memcpy(host_shared, a.l2, sizeof(uint32_t) * a.l2_words);
  if (a.coarse_smem)
    memcpy(host_shared + a.l2_words, a.coarse,
           sizeof(uint32_t) * a.coarse_words);
  host_fine_lo = a.fine;
  host_fine_hi = a.fine + 16 * a.fg.nb;
  return {_name}_launch(b, stream);
}}
"""
# every source, by the name of its file, each with its ctypes blocks
SOURCES = {"voxel_accum": [voxel_accum.VoxelAccumArgs],
           "mega_trace": [mega_trace.MegaTraceArgs],
           "grid_walk": [grid_walk.GridWalkArgs],
           "brick_fine": [brick_fine.BrickFineArgs],
           "staged_march": [staged_march.StagedMarchArgs],
           "tri_march": [tri_march.TriMarchArgs],
           "tri_bin": [tri_bin.TriBinArgs, tri_bin.TriCornersArgs],
           "frame_shade": [frame_shade.RaysArgs, frame_shade.SurfaceArgs,
                           frame_shade.ShadeArgs],
           "accel_build": [accel_build.AccelArgs, accel_build.BoxArgs],
           "octree_walk": [octree_walk.OctreeWalkArgs]}


def _host_build(out, name, src, driver, include, defines=()):
    """g++ build of kernel source `src` (each launch a host_grid call)
    with the host driver appended, headers from `include`, macros
    `defines` (-D flags): the loaded library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out.mkdir(exist_ok=True)
    (out / "cuda_host_shim.h").write_text(SHIM)
    body = src.replace("#include <cuda_runtime.h>",
                       '#include "cuda_host_shim.h"')
    body = body.replace("#include <cuda_pipeline.h>\n", "")
    body = re.sub(r"extern __shared__ uint32_t (\w+)\[\];",
                  r"uint32_t* \1 = host_shared;", body)
    body = re.sub(r"(\w+)<<<(.*?)>>>\(", r"host_grid(\1, \2, ", body,
                  flags=re.S)
    cpp = out / f"{name}.cpp"
    cpp.write_text(body + driver)
    lib = out / f"lib{name}.so"
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-std=c++17",
                    *defines, "-I", str(include), "-I", str(out), "-shared",
                    "-fPIC", "-pthread", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _launch(lib, a, name="host_launch"):
    """Entry point `name` of host build `lib` on argument block `a`."""
    assert _build.entry(name, type(a), lib)(ctypes.byref(a), None) == 0


def _tensors(*objs):
    """The tensors among objs and among the fields of those that are
    dataclasses (an accel), recursively."""
    out = []
    for x in objs:
        if torch.is_tensor(x):
            out.append(x)
        elif hasattr(x, "__dataclass_fields__"):
            out += _tensors(*vars(x).values())
    return out


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Each source's host build by name; tri_march's and staged_march's
    once per ray schedule, as "tri_march/own", "tri_march/shared",
    "staged_march/undeferred" and "staged_march/deferred"."""
    from concurrent.futures import ThreadPoolExecutor
    out = tmp_path_factory.mktemp("host_kernels")
    schedules = {"tri_march": TRI_SCHEDULES,
                 "staged_march": STAGED_SCHEDULES}
    builds = {}
    for name in SOURCES:
        for key, defines in ({f"{name}/{k}": v for k, v in
                              schedules[name].items()}
                             if name in schedules else {name: ()}).items():
            builds[key] = (name, defines)
    # each build in a directory of its own: a build writes the shim there
    with ThreadPoolExecutor(4) as pool:
        libs = {key: pool.submit(
            _host_build, out / key.replace("/", "_"), key.replace("/", "_"),
            (CSRC / f"{name}.cu").read_text(), DRIVERS.get(name, ""), CSRC,
            defines) for key, (name, defines) in builds.items()}
        return {key: lib.result() for key, lib in libs.items()}


@pytest.mark.parametrize("block", [b for blocks in SOURCES.values()
                                   for b in blocks],
                         ids=lambda b: b.__name__)
def test_host_block_sizes_are_the_wrappers(host_kernels, block):
    """Each source's `<file>_sizes`, built for the host, reports the size
    of the wrapper's ctypes structure for each of its argument blocks."""
    report, k = block.SIZES
    lib = next(lib for key, lib in host_kernels.items()
               if key.split("/")[0] + "_sizes" == report)
    sizes = (ctypes.c_int * 8)()
    lib[report](sizes)
    assert sizes[k] == ctypes.sizeof(block) > 0


def _mesh_grid(name, res):
    v, f = {"icosphere": lambda: meshes.icosphere(3),
            "knot": lambda: meshes.torus_knot(2, 3, 128, 64),
            "cube": lambda: meshes.cube(2.0)}[name]()
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / res
    return v, f, bb_min, bb_max, vs, geometry.grid_dims(bb_min, bb_max, vs)


def _host_voxelize(lib, v, f, bb_min, vs, dims):
    """K1 built for the host: (occ, set_calls, faces out of range)."""
    a, (occ, counts) = voxel_accum.accum_args(
        torch.from_numpy(v), torch.from_numpy(f), bb_min, vs, dims)
    _launch(lib, a, "voxel_accum_launch")
    return occ.numpy(), int(counts[0]), int(counts[1])


@pytest.mark.parametrize("name,res", [("icosphere", 64), ("knot", 128),
                                      ("cube", 64)])
def test_host_k1_occupancy_matches_plain(host_kernels, name, res):
    """Occupancy and set_calls (the per-warp hit reduction is exact with
    one-lane warps) bit-equal to voxelize_plain."""
    v, f, bb_min, _, vs, dims = _mesh_grid(name, res)
    occ, calls, bad = _host_voxelize(host_kernels["voxel_accum"], v, f,
                                     bb_min, vs, dims)
    ref, calls_p = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                                  bb_min, vs, dims)
    assert occ.sum() > 0 and bad == 0
    assert np.array_equal(occ, ref.numpy())
    assert calls == calls_p


def test_host_k1_mixed_windows_match_plain(host_kernels):
    """The slot-to-cell index math on windows of 8 cells, one tall window
    of thousands of cells, a degenerate and a collinear triangle, and
    triangles with a NaN or an infinite vertex (empty windows),
    interleaved: occupancy and set_calls equal voxelize_plain.  (A
    one-lane warp takes one triangle per round; the card's 32-triangle
    rounds are held to plain by chip_smoke.py and the CUDA-marked
    tests.)"""
    rng = np.random.default_rng(7)
    vs, dims, origin = 0.1, (32, 30, 24), np.zeros(3, np.float32)
    c = rng.uniform(0.2, 2.2, (300, 3)).astype(np.float32)
    tris = [c[:, None] + rng.uniform(-0.02, 0.02, (300, 3, 3))]
    special = np.asarray([
        [[0.15, 0.15, 0.1], [2.9, 0.4, 1.2], [0.5, 2.8, 2.2]],   # tall
        [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.2, 1.3, 1.1]],     # degenerate
        [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [1.5, 1.5, 1.5]],     # collinear
        [[np.nan, 0.3, 0.3], [0.4, 0.4, 0.4], [0.3, 0.5, 0.3]],
        [[0.3, 0.3, 0.3], [np.inf, 0.4, 0.4], [0.3, 0.5, 0.3]]])
    tris = np.concatenate(tris + [special]).astype(np.float32)
    order = rng.permutation(len(tris))
    v = np.ascontiguousarray(tris[order].reshape(-1, 3))
    f = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    occ, calls, bad = _host_voxelize(host_kernels["voxel_accum"], v, f,
                                     origin, vs, dims)
    ref, calls_p = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                                  origin, vs, dims)
    assert bad == 0 and calls == calls_p > 1000
    assert np.array_equal(occ, ref.numpy())


def test_host_k1_sentinel_triangles_add_nothing(host_kernels):
    """The +inf sentinel triangles that parallel/comm.shard_triangles pads
    a shard with: a shard of padding alone adds no occupancy and no
    set_calls, and padding after real triangles changes nothing."""
    v, f, bb_min, _, vs, dims = _mesh_grid("icosphere", 64)
    tri = v[f].astype(np.float32)
    pad = np.full((7, 3, 3), np.inf, np.float32)
    lib = host_kernels["voxel_accum"]

    def run(t):
        vv = np.ascontiguousarray(t.reshape(-1, 3))
        ff = np.arange(len(vv), dtype=np.int32).reshape(-1, 3)
        return _host_voxelize(lib, vv, ff, bb_min, vs, dims)

    occ0, calls0, bad0 = run(pad)
    assert bad0 == 0 and calls0 == 0 and not occ0.any()
    occ, calls, _ = run(tri)
    occ_p, calls_p, _ = run(np.concatenate([tri, pad]))
    assert calls_p == calls > 0 and np.array_equal(occ_p, occ)


def _host_trace(lib, o, d, tmn, tmx, admit, accel):
    """K2 built for the host; its outputs start as garbage, so every ray
    must be written."""
    a, outs = mega_trace.trace_args(*map(torch.from_numpy,
                                         (o, d, tmn, tmx, admit)), accel)
    for x in outs:
        x.fill_(7)
    _launch(lib, a, "mega_trace_launch")
    return tuple(x.numpy() for x in outs)


@pytest.mark.parametrize("name,res", [("icosphere", 144), ("knot", 128)])
@pytest.mark.parametrize("eye_scale", [1.0, 0.2, 0.05])
def test_host_k2_matches_plain(host_kernels, name, res, eye_scale):
    v, f, bb_min, bb_max, vs, dims = _mesh_grid(name, res)
    occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                            bb_min, vs, dims)
    accel = build_accel(occ, bb_min, vs)
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9])
                           * eye_scale * float(max(bb_max - bb_min))),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(128, 64)
    o, d = make_camera_rays(128, 64, vi, pi)
    o, d = o.reshape(-1, 3).numpy().copy(), d.reshape(-1, 3).numpy().copy()
    n = len(o)
    rng = np.random.default_rng(res)
    bounds = {
        "primary": (np.full(n, TMIN, np.float32),
                    np.full(n, TMAX, np.float32), np.ones(n, bool)),
        "bounded": (rng.uniform(0.001, 0.5, n).astype(np.float32),
                    rng.uniform(0.5, 4.0, n).astype(np.float32),
                    rng.random(n) < 0.6),
    }
    for kind, (tmn, tmx, admit) in bounds.items():
        t, lin, alive = _host_trace(host_kernels["mega_trace"], o, d, tmn,
                                    tmx, admit, accel)
        tp, lp, _ = trace_grid_mega_plain(
            torch.from_numpy(o), torch.from_numpy(d), accel,
            torch.from_numpy(tmn), torch.from_numpy(tmx),
            torch.from_numpy(admit))
        tp, lp = tp.numpy(), lp.numpy()
        assert int(alive.sum()) == 0
        hit, hit_p = np.isfinite(t), np.isfinite(tp)
        same = hit & hit_p & (lin == lp)
        assert np.array_equal(t[same], tp[same]), kind
        diff = np.flatnonzero((hit != hit_p) | (hit & hit_p & (lin != lp)))
        if kind == "bounded":
            assert len(diff) == 0
        elif len(diff):
            adj = adjudicate_hit_diffs(o, d, occ.numpy().astype(bool),
                                       bb_min, vs, diff, t, lin, tp, lp)
            assert adj["adjudication_ok"], adj
        assert hit.sum() > 100 or kind == "bounded"


@pytest.mark.parametrize("name,res", [("icosphere", 144), ("knot", 128)])
def test_host_k2_sparse_admit_matches_plain(host_kernels, name, res):
    """A shadow-like pass: ~5% of the rays admitted, scattered, with per-ray
    t_min / t_max.  The fetch hands only admitted rays to lanes and writes
    the miss (+inf, -1, alive 0) of every other ray itself; admitted rays
    match trace_grid_mega_plain bit for bit."""
    v, f, bb_min, bb_max, vs, dims = _mesh_grid(name, res)
    occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                            bb_min, vs, dims)
    accel = build_accel(occ, bb_min, vs)
    rng = np.random.default_rng(res + 1)
    ext = float(max(bb_max - bb_min))
    n = 6000
    o = (bb_min + rng.uniform(-0.2, 1.2, (n, 3)) * ext).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmn = rng.uniform(0.001, 0.3 * ext, n).astype(np.float32)
    tmx = (tmn + rng.uniform(0.0, 1.5 * ext, n)).astype(np.float32)
    admit = rng.random(n) < 0.05
    t, lin, alive = _host_trace(host_kernels["mega_trace"], o, d, tmn, tmx,
                                admit, accel)
    tp, lp, _ = trace_grid_mega_plain(
        torch.from_numpy(o), torch.from_numpy(d), accel,
        torch.from_numpy(tmn), torch.from_numpy(tmx),
        torch.from_numpy(admit))
    assert not alive.any()
    assert np.array_equal(lin, lp.numpy()) and np.array_equal(t, tp.numpy())
    assert np.isinf(t[~admit]).all() and (lin[~admit] == -1).all()
    assert 0 < (lin >= 0).sum() < admit.sum()


def _edge_scene(rng, n_grid=64, vs=0.125, origin=(-1.37, 0.213, -2.9),
                n_per=32):
    """Rays aimed exactly at grid edges, one occupied cell on one side of
    each edge and one farther along: the grazing geometry where two
    crossing times tie within float noise."""
    occ = np.zeros((n_grid,) * 3, np.uint8)
    org = np.asarray(origin, np.float32)
    os_, ds = [], []
    for a in range(1, n_grid // 4):
        for b in range(1, n_grid // 4):
            x, y, z = 4 * a, 4 * b, int(rng.integers(4, n_grid - 4))
            if rng.integers(0, 2):
                occ[z, y - 1, x] = 1
            else:
                occ[z, y, x - 1] = 1
            occ[z, y + 3, x + 3] = 1
            p = org + np.array([x, y, z + rng.uniform(0.2, 0.8)],
                               np.float32) * np.float32(vs)
            d = rng.uniform(0.05, 1.0, (n_per, 3))
            d[:, 2] = rng.uniform(-1.0, 1.0, n_per)
            d = (d / np.linalg.norm(d, axis=1, keepdims=True)) \
                .astype(np.float32)
            os_.append((p[None] - d * np.float32(0.2)).astype(np.float32))
            ds.append(d)
    return occ, org, vs, np.concatenate(os_), np.concatenate(ds)


def test_host_k2_edge_grazing_rays_match_the_oracle(host_kernels):
    """Where the DDA's tie rule alone would step around a one-ulp sliver
    the reference's slab test accepts (about one ray in ten here), the
    kernel's near-tie probes find it: every ray that differs from the
    plain DDA matches the numpy oracle."""
    occ, org, vs, o, d = _edge_scene(np.random.default_rng(1))
    accel = build_accel(torch.from_numpy(occ), org, vs)
    n = len(o)
    tmn, tmx = np.full(n, TMIN, np.float32), np.full(n, TMAX, np.float32)
    t, lin, alive = _host_trace(host_kernels["mega_trace"], o, d, tmn, tmx,
                                np.ones(n, bool), accel)
    tp, lp, _ = trace_grid_mega_plain(
        torch.from_numpy(o), torch.from_numpy(d), accel,
        torch.from_numpy(tmn), torch.from_numpy(tmx),
        torch.ones(n, dtype=torch.bool))
    tp, lp = tp.numpy(), lp.numpy()
    assert int(alive.sum()) == 0 and np.isfinite(t).sum() > n // 3
    hit, hit_p = np.isfinite(t), np.isfinite(tp)
    diff = np.flatnonzero((hit != hit_p) | (hit & hit_p & (lin != lp)))
    assert len(diff) < n // 100
    adj = adjudicate_hit_diffs(o, d, occ.astype(bool), org, vs, diff, t,
                               lin, tp, lp)
    assert adj["adjudication_ok"] and adj["fast_within_envelope"] == 0, adj


def _walk_scene(kind):
    """(accel, o, d, t_min, t_max) for the K3/K4 host cases: an icosphere
    shell (one coarse row) or random boxes in a 27x26x24-brick grid (five
    coarse rows, superbricks sticking out of the grid); camera rays plus
    random rays from inside, with per-ray bounds from a seed."""
    rng = np.random.default_rng({"shell": 3, "boxes": 4}[kind])
    if kind == "shell":
        v, f, bb_min, _, vs, dims = _mesh_grid("icosphere", 48)
        occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                                bb_min, vs, dims)
        origin = bb_min
    else:
        nx, ny, nz = 216, 208, 192
        occ = np.zeros((nz, ny, nx), np.uint8)
        for _ in range(70):
            lo = rng.integers(0, [nz - 8, ny - 8, nx - 8])
            hi = np.minimum(lo + rng.integers(2, 24, 3), [nz, ny, nx])
            occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
        occ, origin, vs = torch.from_numpy(occ), \
            np.asarray([-1.3, 0.2, -0.7], np.float32), 0.0125
    accel = build_accel(occ, origin, vs)
    ext = np.asarray(accel.dims, np.float64) * vs
    center = origin + ext / 2
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * 1.3
                           * ext.max()), center=tuple(center))
    _, _, vi, pi = cam.matrices(64, 48)
    o, d = make_camera_rays(64, 48, vi, pi)
    m = 2048
    o_in = (origin + rng.uniform(0.1, 0.9, (m, 3)) * ext).astype(np.float32)
    d_in = rng.normal(size=(m, 3))
    d_in = (d_in / np.linalg.norm(d_in, axis=1, keepdims=True)) \
        .astype(np.float32)
    o = np.concatenate([o.reshape(-1, 3).numpy(), o_in])
    d = np.concatenate([d.reshape(-1, 3).numpy(), d_in])
    n = len(o)
    tmn = np.where(rng.random(n) < 0.5, TMIN,
                   rng.uniform(0.001, 0.4 * ext.max(), n)).astype(np.float32)
    tmx = np.where(rng.random(n) < 0.6, TMAX,
                   tmn + rng.uniform(0, 2 * ext.max(), n)).astype(np.float32)
    return accel, o, d, tmn, tmx


def _host_walk(lib, accel, o, d, tmn, tmx, cell, active, two_level, k):
    t = torch.from_numpy
    a, outs = grid_walk.walk_args(
        t(o), t(d), t(tmn), t(tmx), None if cell is None else t(cell),
        None if active is None else t(active), accel.coarse,
        accel.l2 if two_level else None, bdims=accel.bdims,
        origin_key=accel.origin_key,
        brick_world=float(accel.voxel_size * 8), k_hits=k)
    _launch(lib, a)
    return tuple(x.numpy() for x in outs)


@pytest.mark.parametrize("kind", ["shell", "boxes"])
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("k,init", [(1, True), (5, True), (5, False)])
def test_host_k3_matches_plain(host_kernels, kind, two_level, k, init):
    """Candidate bricks, resume cells (of finished walks too) and `cont`
    bit-equal between the kernel and walk_plain."""
    accel, o, d, tmn, tmx = _walk_scene(kind)
    t = torch.from_numpy
    kw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
              brick_world=float(accel.voxel_size * 8), k_hits=k)
    l2 = accel.l2 if two_level else None
    if init:
        cell = active = None
        ref = walk_plain(t(o), t(d), t(tmn), t(tmx), None, None,
                         accel.coarse, l2, **kw)
    else:
        # resume from where a one-brick walk stopped
        _, cell_t, cont = walk_plain(t(o), t(d), t(tmn), t(tmx), None, None,
                                     accel.coarse, l2, **dict(kw, k_hits=1))
        cell = np.ascontiguousarray(cell_t.numpy())
        active = np.ascontiguousarray(cont.numpy())
        ref = walk_plain(t(o), t(d), None, t(tmx), cell_t, cont,
                         accel.coarse, l2, **kw)
    got = _host_walk(host_kernels["grid_walk"], accel, o, d, tmn, tmx, cell,
                     active, two_level, k)
    for g_, r_ in zip(got, ref):
        assert np.array_equal(g_, r_.numpy())
    assert (got[0] >= 0).sum() > 200


@pytest.mark.parametrize("kind", ["shell", "boxes"])
def test_host_k4_matches_plain(host_kernels, kind):
    """(t, lin) bit-equal between the kernel and fine_plain for 1 to 5
    candidate slots taken from the walk."""
    accel, o, d, tmn, tmx = _walk_scene(kind)
    t = torch.from_numpy
    hits, _, _ = walk_plain(t(o), t(d), t(tmn), t(tmx), None, None,
                            accel.coarse, accel.l2, bdims=accel.bdims,
                            origin_key=accel.origin_key,
                            brick_world=float(accel.voxel_size * 8),
                            k_hits=5)
    for kk in (1, 2, 5):
        bricks = np.ascontiguousarray(hits[:kk].numpy())
        t_k, lin_k = _host_fine(host_kernels["brick_fine"], o, d, bricks,
                                accel.fine, 0, tmn, tmx, accel)
        t_p, lin_p = fine_plain(t(o), t(d), t(bricks), accel.fine, t(tmn),
                                t(tmx), dims=accel.dims, bdims=accel.bdims,
                                origin_key=accel.origin_key,
                                voxel_size=accel.voxel_size)
        assert np.array_equal(lin_k, lin_p.numpy())
        assert np.array_equal(t_k, t_p.numpy())
        assert (lin_k >= 0).sum() > 100


def test_host_k4_edge_grazing_rays_match_the_oracle(host_kernels):
    """The staged walk on rays aimed exactly at grid edges: K4's near-tie
    steps and probes (those of K2) keep every ray that differs from the
    exhaustive DDA on the numpy oracle's cell, and the kernel built for
    the host gives fine_plain's (t, lin) bit for bit on these rays."""
    occ, org, vs, o, d = _edge_scene(np.random.default_rng(1))
    accel = build_accel(torch.from_numpy(occ), org, vs)
    t = torch.from_numpy
    n = len(o)
    t_s, lin_s, unresolved = trace_grid_fast(t(o), t(d), accel, mega=False,
                                             return_stats=True)
    t_p, lin_p = trace_grid_dda(t(o), t(d), t(occ.reshape(-1)), org,
                                dims=accel.dims, voxel_size=vs)
    ts, ls, tp, lp = t_s.numpy(), lin_s.numpy(), t_p.numpy(), lin_p.numpy()
    assert unresolved == 0 and np.isfinite(ts).sum() > n // 3
    hit, hit_p = np.isfinite(ts), np.isfinite(tp)
    diff = np.flatnonzero((hit != hit_p) | (hit & hit_p & (ls != lp)))
    assert len(diff) < n // 100
    adj = adjudicate_hit_diffs(o, d, occ.astype(bool), org, vs, diff, ts,
                               ls, tp, lp)
    assert adj["adjudication_ok"] and adj["fast_within_envelope"] == 0, adj
    tmn, tmx = np.full(n, TMIN, np.float32), np.full(n, TMAX, np.float32)
    hits, _, _ = walk_plain(t(o), t(d), t(tmn), t(tmx), None, None,
                            accel.coarse, None, bdims=accel.bdims,
                            origin_key=accel.origin_key,
                            brick_world=float(accel.voxel_size * 8),
                            k_hits=5)
    t_k, lin_k = _host_fine(host_kernels["brick_fine"], o, d, hits.numpy(),
                            accel.fine, 0, tmn, tmx, accel)
    t_f, lin_f = fine_plain(t(o), t(d), hits, accel.fine, t(tmn), t(tmx),
                            dims=accel.dims, bdims=accel.bdims,
                            origin_key=accel.origin_key, voxel_size=vs)
    assert np.array_equal(lin_k, lin_f.numpy())
    assert np.array_equal(t_k, t_f.numpy())


def _host_fine(lib, o, d, bricks, fine, fine_off, tmn, tmx, accel):
    """K4 built for the host over the window `fine` of the bricks from id
    fine_off on, in the grid of `accel`: (t, lin)."""
    t = torch.from_numpy
    a, outs = brick_fine.fine_args(
        t(o), t(d), t(np.ascontiguousarray(bricks, np.int32)),
        fine.contiguous(), t(tmn), t(tmx), dims=accel.dims,
        bdims=accel.bdims, origin_key=accel.origin_key,
        voxel_size=accel.voxel_size, fine_off=fine_off)
    _launch(lib, a, "brick_fine_launch")
    return tuple(x.numpy() for x in outs)


def test_host_k4_fine_window_matches_plain(host_kernels):
    """K4 reading a Z-slab accel's fine window (fine_off > 0; slab rows 48
    to 95 of the 115x54x121 knot) on 20,000 rays aimed at brick edges and
    corners: (t, lin) bit-equal to fine_plain over the same window, with
    and without the slab's one-layer halo, and with a first slot of
    bricks outside the window (which count as none).  Probes cross both
    window edges: without the halo, some rays' cells differ from K4 over
    the whole table on the same candidates; with it none do."""
    from test_torch_trace import _brick_edge_rays

    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.ops.traverse_fast import build_accel_slab
    v, f = meshes.torus_knot(2, 3, 256, 32)
    bb_min, bb_max = geometry.mesh_bbox(v)
    ext = float(max(bb_max - bb_min))
    g = GridBool.from_mesh(v, f, ext / 120, device="cpu")
    occ = g.occupancy()
    nz = occ.shape[0]
    whole = build_accel(occ, g.origin, g.voxel_size)
    o, d = _brick_edge_rays(g, ext, 20000, 0)
    n = len(o)
    tmn, tmx = np.full(n, TMIN, np.float32), np.full(n, TMAX, np.float32)
    t = torch.from_numpy
    kw = dict(dims=whole.dims, bdims=whole.bdims,
              origin_key=whole.origin_key, voxel_size=whole.voxel_size)
    z0, z1 = 48, 96
    halo = dict(below=occ[z0 - 8:z0], above=occ[z1:z1 + 8])
    bx, by, _ = whole.bdims
    outside = np.where(np.arange(n) % 2, 0, bx * by * 13 + 5)
    for with_halo in (False, True):
        sl = build_accel_slab(occ[z0:z1], z0, nz, g.origin, g.voxel_size,
                              **(halo if with_halo else {}))
        assert sl.fine_off == bx * by * (5 if with_halo else 6)
        hits, _, _ = walk_plain(t(o), t(d), t(tmn), t(tmx), None, None,
                                sl.coarse, sl.l2, bdims=sl.bdims,
                                origin_key=sl.origin_key,
                                brick_world=float(sl.voxel_size * 8),
                                k_hits=5)
        assert (hits >= 0).sum() > 1000
        bricks = np.concatenate([outside[None], hits.numpy()])
        t_k, lin_k = _host_fine(host_kernels["brick_fine"], o, d, bricks,
                                sl.fine, sl.fine_off, tmn, tmx, whole)
        t_p, lin_p = fine_plain(t(o), t(d), t(bricks), sl.fine, t(tmn),
                                t(tmx), fine_off=sl.fine_off, **kw)
        assert np.array_equal(lin_k, lin_p.numpy())
        assert np.array_equal(t_k, t_p.numpy())
        t_w, lin_w = _host_fine(host_kernels["brick_fine"], o, d,
                                hits.numpy(), whole.fine, 0, tmn, tmx,
                                whole)
        edge = np.flatnonzero(lin_w != lin_k)
        print(f"halo {with_halo}: {len(edge)} rays whose cell needs a "
              f"probe outside the window: {edge[:8]}")
        assert (len(edge) > 0) != with_halo
        assert (lin_k >= 0).sum() > 1000


def _staged_scene(kind, rng):
    """(accel, o, d, t_min, t_max) for a staged_march host case: the K3/K4
    scenes (camera rays and rays from inside, per-ray bounds), the boxes
    grid seen from a camera inside it, the edge-grazing rays, or a Z-slab
    accel (rows 48 to 95 of the 115x54x121 knot, with its halo, so its
    fine table is a window) on rays aimed at brick edges and corners."""
    if kind in ("shell", "boxes"):
        return _walk_scene(kind)
    if kind == "inside":
        accel = _walk_scene("boxes")[0]
        ext = np.asarray(accel.dims, np.float64) * accel.voxel_size
        center = np.asarray(accel.origin_key) + ext / 2
        cam = Camera(eye=tuple(center + np.asarray([0.05, 0.02, -0.03])
                               * ext.max()),
                     center=tuple(center + np.asarray([0.3, 0.1, 0.2])
                                  * ext.max()))
        _, _, vi, pi = cam.matrices(64, 48)
        o, d = make_camera_rays(64, 48, vi, pi)
        o, d = o.reshape(-1, 3).numpy().copy(), d.reshape(-1, 3).numpy().copy()
    elif kind == "edge":
        occ, org, vs, o, d = _edge_scene(rng)
        accel = build_accel(torch.from_numpy(occ), org, vs)
    else:
        from test_torch_trace import _brick_edge_rays

        from voxelray_torch.models.grids import GridBool
        from voxelray_torch.ops.traverse_fast import build_accel_slab
        v, f = meshes.torus_knot(2, 3, 256, 32)
        bb_min, bb_max = geometry.mesh_bbox(v)
        ext = float(max(bb_max - bb_min))
        g = GridBool.from_mesh(v, f, ext / 120, device="cpu")
        occ = g.occupancy()
        z0, z1 = 48, 96
        accel = build_accel_slab(occ[z0:z1], z0, occ.shape[0], g.origin,
                                 g.voxel_size, below=occ[z0 - 8:z0],
                                 above=occ[z1:z1 + 8])
        assert accel.fine_off > 0
        o, d = _brick_edge_rays(g, ext, 4000, 0)
    n = len(o)
    return (accel, o, d, np.full(n, TMIN, np.float32),
            np.full(n, TMAX, np.float32))


# staged_march_plain's outputs by case, computed once for every schedule
_STAGED_PLAIN = {}


@pytest.mark.parametrize("kind", ["shell", "boxes", "inside", "edge",
                                  "slab"])
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("k,sparse", [(5, False), (4, True)])
@pytest.mark.parametrize("schedule", list(STAGED_SCHEDULES))
def test_host_staged_march_matches_plain(host_kernels, kind, two_level, k,
                                         sparse, schedule):
    """staged_march built for the host (one-lane warps, so a lane takes a
    new ray after every group, as on the card) in each build of
    STAGED_SCHEDULES against staged_march_plain, the lap loop over K3 and
    K4: t bits and lin equal, unresolved 0 on both sides; k 5 as the
    primary trace calls it (rays outnumber the block's 128 lanes, so the
    "deferred" build defers the rays still walking after a group and takes
    them back), k 4 with a sparse admit mask (~5%) as the shadow pass
    does, whose other rays the kernel's fetch writes as misses."""
    rng = np.random.default_rng(11)
    accel, o, d, tmn, tmx = _staged_scene(kind, rng)
    t = torch.from_numpy
    n = len(o)
    admit = t(rng.random(n) < 0.05) if sparse else None
    args = (t(o), t(d), accel, t(tmn), t(tmx), admit, k, two_level)
    key = (kind, two_level, k, sparse)
    if key not in _STAGED_PLAIN:
        _STAGED_PLAIN[key] = staged_march.staged_march_plain(*args)
    want_t, want_lin, want_unres = _STAGED_PLAIN[key]
    assert want_unres == 0
    a, outs = staged_march.staged_args(t(o), t(d), accel, t(tmn), t(tmx),
                                       admit, k, two_level, lanes=128)
    outs[0].fill_(7.0)
    outs[1].fill_(7)
    assert ("deferred" not in a.keep) == sparse and n > 128
    _launch(host_kernels[f"staged_march/{schedule}"], a)
    got_t, got_lin, unresolved = outs
    assert int(unresolved) == 0
    assert torch.equal(got_lin, want_lin)
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    hits = int((want_lin >= 0).sum())
    assert hits > (5 if sparse else 100)
    if sparse:
        assert not (got_lin[~admit] >= 0).any()
    elif schedule == "deferred":
        # rays were deferred, and every ticket handed out was taken
        sched = a.keep["sched"]
        assert int(sched[0]) > 0 and int(sched[32]) >= int(sched[0])


def _run_held(lib_path, a, tensors, passes):
    """host_launch of the host build at lib_path on argument block `a` in
    a held run (SHIM's host_run: thread 1 stops inside its first ray
    until thread 0 has slept `passes` idle passes), in a subprocess, so
    that a build that aborts fails the run and not the test process.
    `tensors`: the CPU tensors whose storage a's pointers point into,
    written back with the run's results.  Returns (exit code, idle passes
    slept)."""
    import tempfile
    views = {}
    for x in tensors:
        st = x.untyped_storage()
        views[st.data_ptr()] = torch.empty(0, dtype=torch.uint8).set_(st)
    spans = list(views.items())
    fixes = []      # (the pointer's offset in the block, storage, offset)
    for name, kind in type(a)._fields_:
        p = getattr(a, name)
        if kind is ctypes.c_void_p and p:
            k = next(k for k, (base, v) in enumerate(spans)
                     if base <= p < base + v.numel())
            fixes.append((getattr(type(a), name).offset, k, p - spans[k][0]))
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "in.npz",
                 *[v.numpy() for _, v in spans], block=np.frombuffer(
                     bytes(a), np.uint8))
        (Path(tmp) / "fixes.json").write_text(json.dumps(fixes))
        runner = Path(tmp) / "run.py"
        runner.write_text(f"""
import ctypes, json
import numpy as np
tmp = {str(tmp)!r}
lib = ctypes.CDLL({str(lib_path)!r})
data = dict(np.load(tmp + "/in.npz"))
arrays = [data[f"arr_{{k}}"] for k in range(len(data) - 1)]
block = (ctypes.c_char * data["block"].size).from_buffer_copy(data["block"])
for offset, k, delta in json.load(open(tmp + "/fixes.json")):
    ctypes.c_void_p.from_buffer(block, offset).value = (
        arrays[k].ctypes.data + delta)
lib.host_set_held({passes})
lib.host_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
rc = lib.host_launch(ctypes.addressof(block), None)
np.savez(tmp + "/out.npz", *arrays)
print(rc, lib.host_idle_count())
""")
        proc = subprocess.run([sys.executable, str(runner)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return proc.returncode, 0
        out = np.load(Path(tmp) / "out.npz")
        for k, (_, v) in enumerate(spans):
            v.copy_(torch.from_numpy(out[f"arr_{k}"]))
        rc, idle = map(int, proc.stdout.split()[-2:])
        return rc, idle


@pytest.fixture(scope="module")
def held_builds(tmp_path_factory):
    """The host builds of the held runs, by kernel: tri_march's "shared"
    schedule and staged_march's "deferred" one, each with a clock that
    advances HELD_CLOCK_STEP a read; paths of the libraries."""
    out = tmp_path_factory.mktemp("held")
    paths = {}
    for name, defines in (("tri_march", TRI_SCHEDULES["shared"]),
                          ("staged_march", STAGED_SCHEDULES["deferred"])):
        _host_build(out, name, (CSRC / f"{name}.cu").read_text(),
                    DRIVERS[name], CSRC,
                    [*defines, f"-DHOST_CLOCK_STEP={HELD_CLOCK_STEP}ll"])
        paths[name] = out / f"lib{name}.so"
    return paths


@pytest.mark.parametrize("kernel", ["tri_march", "staged_march"])
def test_host_idle_warp_waits_out_a_held_ray(held_builds, kernel):
    """An idle warp never gives up on a ray that a running warp holds, and
    no trace fails on a timer however long its slowest warp takes: two
    one-lane warps run at once, the first stopped inside its first ray
    until the second, done with every other ray (deferring and taking
    back the long ones), has slept HELD_PASSES idle passes in a row, the
    host clock advancing 2^34 cycles a read (past the 2^33 after which
    tri_march once trapped, aborting the launch).  The outputs are the
    lap loop's bit for bit, unresolved 0."""
    t = torch.from_numpy
    if kernel == "tri_march":
        tri, accel = _tri_scene("knot", 32)
        o, d, tmn, tmx = map(t, _tri_rays("camera", tri, accel,
                                          np.random.default_rng(32)))
        want = tri_march_plain(o, d, tmn, tmx, accel)
        a, outs = tri_march.march_args(o, d, tmn, tmx, accel, False,
                                       lanes=128)
    else:
        accel, o, d, tmn, tmx = map(
            lambda x: t(x) if isinstance(x, np.ndarray) else x,
            _staged_scene("boxes", np.random.default_rng(11)))
        want = staged_march.staged_march_plain(o, d, accel, tmn, tmx, None,
                                               5, True)
        a, outs = staged_march.staged_args(o, d, accel, tmn, tmx, None, 5,
                                           True, lanes=128)
    rc, idle = _run_held(held_builds[kernel], a,
                         _tensors(o, d, tmn, tmx, accel, *outs,
                                  *a.keep.values()), HELD_PASSES)
    assert rc == 0, f"the held run failed (exit code {rc})"
    assert idle >= HELD_PASSES
    assert int(outs[-1].sum()) == 0 and want[-1] == 0
    assert torch.equal(outs[1], want[1])
    assert torch.equal(outs[0].view(torch.int32), want[0].view(torch.int32))
    assert int((want[1] >= 0).sum()) > 100


def _tri_scene(name, res):
    """(triangles (F, 3, 3), TriAccel on the CPU) of a small mesh, or of
    "pair": a knot and a sphere far apart along x, an empty superbrick
    between them.  "long-rows" is the knot on a grid coarse enough that
    rows span several of tri_march's row chunks; "capped" the knot with
    rows cut at ROW_CHUNK + 5 triangles (max_l_width: the cells beyond it
    overflow, and a full row ends inside its second chunk)."""
    kv, kf = meshes.torus_knot(2, 3, 64, 8)
    sv, sf = meshes.icosphere(3)
    tri = {"icosphere": lambda: sv[sf], "pair": lambda: np.concatenate([
               kv[kf], sv[sf] * np.float32(0.4) + np.float32([9.0, 0, 0])])
           }.get(name, lambda: kv[kf])()
    cap = {"capped": ROW_CHUNK + 5}.get(name, 512)
    return tri, build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=res,
                                max_l_width=cap, device="cpu")


def _tri_rays(kind, tri, ta, rng):
    """(o, d, t_min, t_max) float32 for one tri_march host case: camera
    rays from the bench camera's direction or from inside the mesh's box,
    shadow rays from the bench rays' hit points toward a point light
    (t_min = TMIN: round 0 tests the start point's cell), or rays
    through cell edges and corners of the tri grid, a third of them with
    zero direction components."""
    lo, hi = tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)
    center, extent = (lo + hi) * 0.5, float(max(hi - lo))
    if kind == "grazing":
        m = 3072
        og, vs = ta.origin.numpy(), np.float32(ta.voxel_size)
        p = og + rng.integers(1, ta.dims, (m, 3)).astype(np.float32) * vs
        edge = rng.random(m) < 0.5
        ax = rng.integers(0, 3, m)
        p[edge, ax[edge]] += rng.uniform(0.1, 0.9, edge.sum()) * vs
        d = rng.normal(size=(m, 3))
        d[np.arange(m) % 3 == 0, ax[np.arange(m) % 3 == 0]] = 0.0
        d[np.arange(m) % 9 == 0, (ax[np.arange(m) % 9 == 0] + 1) % 3] = 0.0
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o = (p - d * np.float32(0.7 * extent)).astype(np.float32)
        return (o, d, np.full(m, TMIN, np.float32),
                np.full(m, TMAX, np.float32))
    off = [0.25, 0.12, -0.2] if kind == "inside" else [0.9, 0.55, -0.9]
    cam = Camera(eye=tuple(center + np.asarray(off) * extent),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(64, 48)
    o, d = make_camera_rays(64, 48, vi, pi)
    o, d = o.reshape(-1, 3).numpy().copy(), d.reshape(-1, 3).numpy().copy()
    tmn = np.full(len(o), TMIN, np.float32)
    tmx = np.full(len(o), TMAX, np.float32)
    if kind == "shadow":
        t, _, _, _, _ = tri_march_plain(*map(torch.from_numpy,
                                             (o, d, tmn, tmx)), ta)
        hit = np.isfinite(t.numpy())
        p = (o[hit] + d[hit] * t.numpy()[hit, None]).astype(np.float32)
        # a light behind the mesh: most shadow rays cross it
        light = (center + np.asarray([-1.2, 1.5, 1.1]) * extent)
        to_l = (light - p).astype(np.float32)
        dist = np.linalg.norm(to_l, axis=1).astype(np.float32)
        return (p, (to_l / dist[:, None]).astype(np.float32),
                np.full(len(p), TMIN, np.float32), dist)
    return o, d, tmn, tmx


@pytest.mark.parametrize("name,res", [("icosphere", 24), ("knot", 32),
                                      ("pair", 192), ("long-rows", 6),
                                      ("capped", 8)])
@pytest.mark.parametrize("kind", ["camera", "inside", "shadow", "grazing"])
@pytest.mark.parametrize("two_level", [False, True])
def test_host_tri_march_matches_plain(host_kernels, name, res, kind,
                                      two_level):
    """The march kernel built for the host (its warps one lane wide, so
    the lane takes a new ray from the counter after every lap, as on the
    card; its asynchronous row copies made at once) against
    tri_march_plain (the lap loop over the staged walk), with every row
    tested by its own lane and with every lap's row through the shared
    row test (the two builds of TRI_SCHEDULES): t and id bit-equal, u and
    v bit-equal where there is a hit, unresolved 0 on both sides.  The
    pair's grid has an empty superbrick, so its two-level walk takes the
    landing step; "long-rows" has rows longer
    than one row chunk, ending at and inside a chunk; "capped" rows cut
    by l_width."""
    tri, ta = _tri_scene(name, res)
    per_row = (ta.cell_tris >= 0).sum(1)
    if name == "long-rows":
        assert ta.l_width > 2 * ROW_CHUNK
        assert bool(((per_row > ROW_CHUNK) & (per_row % ROW_CHUNK != 0))
                    .any())
    if name == "capped":
        assert ta.overflow_cells > 0 and ta.l_width == ROW_CHUNK + 5
        assert bool((per_row == ta.l_width).any())
    o, d, tmn, tmx = _tri_rays(kind, tri, ta, np.random.default_rng(res))
    t = torch.from_numpy
    want = tri_march_plain(t(o), t(d), t(tmn), t(tmx), ta,
                           two_level=two_level)
    n = len(o)
    hit = want[1] >= 0
    assert want[4] == 0 and int(hit.sum()) > 20
    for schedule in TRI_SCHEDULES:
        a, outs = tri_march.march_args(t(o), t(d), t(tmn), t(tmx), ta,
                                       two_level)
        _launch(host_kernels[f"tri_march/{schedule}"], a)
        got_t, got_id, got_u, got_v, unresolved = outs
        assert int(unresolved) == 0
        assert torch.equal(got_id, want[1])
        assert torch.equal(got_t, want[0])
        assert torch.equal(got_u[hit], want[2][hit])
        assert torch.equal(got_v[hit], want[3][hit])
    if name == "pair":
        n_sup = int(np.prod([-(-b // 8) for b in ta.brick.bdims]))
        bits = np.unpackbits(ta.brick.l2.numpy().view(np.uint8),
                             bitorder="little")[:n_sup]
        assert n_sup > 1 and not bits.all()


def _counting_build(out, name):
    """Kernel `name` (tri_march or staged_march) built for the host with
    two counters added to brick_walk.cuh: the brick walk's iterations in
    staged_group and K4's cell steps in fine_brick.  Returns a launcher
    of an argument block that gives (brick steps, cell steps)."""
    hdr = (CSRC / "brick_walk.cuh").read_text()
    cell_loop = "  for (int step = 0; step < kSteps; ++step) {\n"
    assert hdr.count(cell_loop) == 1
    brick_loop = ("  for (int step = 0; step < max_steps && active; "
                  "++step) {\n")
    assert hdr.count(brick_loop) == 1
    hdr = hdr.replace("namespace {\n", "static unsigned long long "
                      "g_bricks = 0, g_cells = 0;\nnamespace {\n", 1)
    (out / "brick_walk.cuh").write_text(
        hdr.replace(cell_loop, cell_loop + "    ++g_cells;\n")
        .replace(brick_loop, brick_loop + "    ++g_bricks;\n"))
    lib = _host_build(out, f"{name}_counting",
                      (CSRC / f"{name}.cu").read_text(),
                      DRIVERS[name] + '''
extern "C" void host_counts(unsigned long long* c) {
  c[0] = g_bricks;
  c[1] = g_cells;
  g_bricks = g_cells = 0;
}
''', out)

    def run(a):
        _launch(lib, a)
        c = (ctypes.c_ulonglong * 2)()
        lib.host_counts(c)
        return int(c[0]), int(c[1])
    return run


@pytest.fixture(scope="module")
def counting_march(tmp_path_factory):
    """tri_march built for the host with the step counters
    (_counting_build)."""
    return _counting_build(tmp_path_factory.mktemp("counting_march"),
                           "tri_march")


@pytest.fixture(scope="module")
def counting_staged(tmp_path_factory):
    """staged_march built for the host with the step counters
    (_counting_build)."""
    return _counting_build(tmp_path_factory.mktemp("counting_staged"),
                           "staged_march")


@pytest.mark.parametrize("name,res", [("icosphere", 24), ("knot", 32),
                                      ("pair", 192)])
@pytest.mark.parametrize("kind", ["camera", "grazing"])
def test_host_tri_march_work_count_is_the_kernels(counting_march, name, res,
                                                   kind):
    """chip_smoke.py's bound for tri_march counts the march's brick and
    cell steps from the plain lap loop (march_work); the count must be
    the very steps the kernel takes, not the lap loop's own (K3 walks on
    past the brick where K4 decides the hit, the kernel does not)."""
    import sys
    sys.path.insert(0, str(HERE.parent))
    from chip_smoke import march_work
    tri, ta = _tri_scene(name, res)
    o, d, tmn, tmx = map(torch.from_numpy, _tri_rays(
        kind, tri, ta, np.random.default_rng(res)))
    a, outs = tri_march.march_args(o, d, tmn, tmx, ta, False)
    bricks, cells = counting_march(a)
    want, work, _ = march_work(o, d, tmn, tmx, ta)
    assert torch.equal(outs[1], want[1])
    assert cells > 0 and bricks > 0
    assert (work["brick_steps"], work["cell_steps"]) == (bricks, cells)


@pytest.mark.parametrize("kind", ["boxes", "edge", "slab"])
@pytest.mark.parametrize("k,sparse", [(5, False), (4, True)])
def test_host_staged_march_work_count_is_the_kernels(counting_staged, kind,
                                                     k, sparse):
    """chip_smoke.py's bound for staged_march counts the brick and cell
    steps from the plain lap loop (staged_work, through counted_walks,
    the same count as tri_march's): they are the very steps the kernel
    takes on these rays."""
    import sys
    sys.path.insert(0, str(HERE.parent))
    from chip_smoke import staged_work
    rng = np.random.default_rng(11)
    accel, o, d, tmn, tmx = _staged_scene(kind, rng)
    t = torch.from_numpy
    n = len(o)
    admit = t(rng.random(n) < 0.05) if sparse else None
    args = (t(o), t(d), accel, t(tmn), t(tmx), admit, k, None)
    a, outs = staged_march.staged_args(*args)
    bricks, cells = counting_staged(a)
    want, work, _ = staged_work(*args)
    assert torch.equal(outs[1], want[1]) and int(outs[2]) == 0
    assert cells > 0 and bricks > 0
    assert (work["brick_steps"], work["cell_steps"]) == (bricks, cells)


# ---- the frame glue: csrc/frame_shade.cu against render/pipeline.py -----

CLEAR = (0.2, 0.3, 0.5, 1.0)
POINT = Light()
DIRECTIONAL = Light(position=(-3.0, 7.0, 2.0), intensity=2.5, type=1)
# (scene, backend, width, height, light): tiled frames (the fast backend at
# a multiple of 8x128) and row-major ones, each route's voxel centre rule
FRAME_CASES = {
    "vox-fast-tiled": ("vox", "fast", 128, 64, POINT),
    "vox-brute": ("vox", "brute", 96, 54, DIRECTIONAL),
    "vox-dda": ("vox", "dda", 96, 54, POINT),
    "octree": ("octree", "octree", 96, 54, POINT),
    "tri-tiled": ("tri", "fast", 128, 64, DIRECTIONAL),
    "textured": ("tex", "dda", 96, 54, POINT),
    "mixed-tiled": ("mixed", "fast", 128, 64, POINT),
    "mixed-brute": ("mixed", "brute", 96, 54, DIRECTIONAL),
}


@pytest.fixture(scope="module")
def frame_host(host_kernels):
    """csrc/frame_shade.cu built for the host."""
    return host_kernels["frame_shade"]


def _tri_model(v, f, rng, tex=None):
    """A LoadedModel with vertex normals, UVs past [0, 1] (the texture
    repeats) and three materials: specular (illum 2), specular with the
    shininess floor and, when `tex` is a file, textured (illum 3), and
    diffuse without ambient (illum 0)."""
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    verts[:, 3:6] = v / np.linalg.norm(v, axis=1, keepdims=True)
    verts[:, 9:11] = rng.uniform(-0.5, 1.5, (len(v), 2))
    rows = [Material(ambient=(.2, .2, .2), diffuse=(.7, .6, .5),
                     specular=(1, 1, 1), shininess=32.0, illum=2),
            Material(ambient=(.1, .1, .1), diffuse=(.9, .9, .9),
                     specular=(.5, .5, .5), shininess=2.0, illum=3,
                     texture_id=0 if tex else -1),
            Material(ambient=(.3, .2, .1), diffuse=(.4, .8, .6), illum=0)]
    return LoadedModel(vertices=verts, indices=f.reshape(-1).astype(np.uint32),
                       materials=np.stack([m.as_row() for m in rows]),
                       mat_index=rng.integers(0, 3, len(f)).astype(np.int32),
                       textures=[tex] if tex else [])


@pytest.fixture(scope="module")
def frame_scenes(tmp_path_factory):
    """Small CPU scenes: a voxel grid, the same as an octree, a triangle
    mesh, a textured one, and a mixed scene.  The meshes take the brute
    triangle trace (the kernels read the trace's t, id, u, v whichever
    trace gave them)."""
    from voxelray_torch.models.octree import Octree
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("frame_tex")
    tex = np.stack(np.meshgrid(np.linspace(0, 1, 12), np.linspace(1, 0, 9)),
                   -1)
    write_png(str(tmp / "tex.png"),
              np.concatenate([tex, tex[..., :1] * tex[..., 1:]], -1))
    shiny = Material(ambient=(0.1, 0.05, 0.1), diffuse=(0.8, 0.7, 0.2),
                     specular=(0.6, 0.6, 0.6), shininess=24.0, illum=2)
    gv, gf = meshes.bunny_like(2)
    gv = (gv * np.float32(0.5) + np.float32([0.9, -0.3, -0.7])) \
        .astype(np.float32)
    grid = GridBool.from_mesh(gv, gf, 0.07, device="cpu")
    v, f = meshes.icosphere(2)
    return {
        "vox": build_scene(grid=grid, voxel_material=shiny, device="cpu"),
        "octree": build_scene(grid=Octree.from_mesh(gv, gf, 0.07,
                                                    device="cpu"),
                              voxel_material=shiny, device="cpu"),
        "tri": build_scene(models=[_tri_model(v, f, rng)], tri_accel=False,
                           device="cpu"),
        "tex": build_scene(models=[_tri_model(v, f, rng,
                                              str(tmp / "tex.png"))],
                           tri_accel=False, device="cpu"),
        "mixed": build_scene(models=[_tri_model(v, f, rng,
                                                str(tmp / "tex.png"))],
                             grid=grid, voxel_material=shiny,
                             tri_accel=False, device="cpu"),
    }


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """torch.sqrt rounded as one IEEE float32 square root, as PyTorch's
    CUDA sqrt and the kernels round it: the CPU's vectorised float32
    torch.sqrt can be an ulp off (~0.7% of values with PyTorch 2.13 on
    AVX-512), so the plain glue is held to the kernels with this one."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: sqrt(x.double()).to(x.dtype))


def _frame_camera(width, height):
    _, _, vi, pi = Camera(eye=(2.4, 1.5, -2.6),
                          center=(-0.2, 0.0, 0.2)).matrices(width, height)
    return vi, pi


def _ulps(a, b):
    """Per-element distance in float32 ulps (NaN against NaN is 0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return torch.where(both_nan, 0, (ordered(a) - ordered(b)).abs())


def _host_rays(lib, width, height, vi, pi, tiled):
    a, o, d = frame_shade.rays_args(width, height, vi, pi, tiled,
                                    torch.device("cpu"))
    o.fill_(7.0)
    d.fill_(7.0)
    _launch(lib, a, "camera_rays_launch")
    return o, d


def _primary(scene, o, d, backend):
    tri = (pipeline._trace_triangles(scene, o, d, TMIN, TMAX)
           if scene.n_triangles else None)
    t_vox, vox_id = pipeline._trace_voxels(scene, o, d, TMIN, TMAX, backend)
    return tri, t_vox, vox_id


def _host_surface(lib, scene, o, d, primary, light, backend):
    tri, t_vox, vox_id = primary
    a, surf = frame_shade.surface_args(
        o, d, t_vox, vox_id, tri, pipeline._surface_tables(scene, backend),
        light.position, light.intensity, light.type)
    for x in surf:
        x.view(torch.uint8).fill_(0xA5)     # every output must be written
    _launch(lib, a, "hit_surface_launch")
    return surf


@pytest.mark.parametrize("width,height,tiled", [(256, 16, True),
                                                (128, 8, True),
                                                (96, 54, False),
                                                (7, 5, False)])
def test_host_camera_rays_match_plain(frame_host, ieee_sqrt, width, height,
                                      tiled):
    """camera_rays equals make_camera_rays followed by _tile_rays (tiled)
    or flattened (row-major), bit for bit, and the plain frame rays of
    render_image's fast and dda backends."""
    vi, pi = _frame_camera(width, height)
    o, d = _host_rays(frame_host, width, height, vi, pi, tiled)
    po, pd = make_camera_rays(width, height, vi, pi)
    if tiled:
        po = pipeline._tile_rays(po, height, width)
        pd = pipeline._tile_rays(pd, height, width)
    assert torch.equal(o, po.reshape(-1, 3))
    assert torch.equal(d, pd.reshape(-1, 3))
    fo, fd, _ = pipeline._frame_rays(build_scene(device="cpu"), vi, pi,
                                     width, height,
                                     "fast" if tiled else "dda")
    assert torch.equal(o, fo.reshape(-1, 3))
    assert torch.equal(d, fd.reshape(-1, 3))


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_host_hit_surface_matches_plain(frame_host, frame_scenes, ieee_sqrt,
                                        case):
    """hit_surface against surface_terms on the same traces: the shadow
    query (world_pos, l_vec, light_dist, the admit mask) of every ray bit
    for bit, and of every hit its flags, shading normal, diffuse term
    (texture-sampled on a textured triangle), intensity and material
    row."""
    name, backend, width, height, light = FRAME_CASES[case]
    scene = frame_scenes[name]
    vi, pi = _frame_camera(width, height)
    o, d, _ = pipeline._frame_rays(scene, vi, pi, width, height, backend)
    primary = _primary(scene, o, d, backend)
    surf = _host_surface(frame_host, scene, o, d, primary, light, backend)
    tri, t_vox, vox_id = primary
    s = pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                               backend)
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    for got, want in ((surf.world_pos, s.world_pos), (surf.l_vec, s.l_vec),
                      (surf.light_dist, s.light_dist)):
        assert torch.equal(bits(got), bits(want))
    assert torch.equal(surf.admit, s.hit & s.facing)
    hit = s.hit.reshape(-1)
    rec = surf.rec
    flags = rec.view(torch.int32)[:, 3]
    assert torch.equal((flags & 1) != 0, hit)
    assert torch.equal((flags & 2) != 0, s.vox_hit.reshape(-1))
    assert torch.equal((flags[hit] & 4) != 0, s.facing.reshape(-1)[hit])
    assert torch.equal(bits(rec[hit, 0:3]), bits(s.normal.reshape(-1, 3)[hit]))
    assert torch.equal(bits(rec[hit, 4:7]),
                       bits(s.diffuse.reshape(-1, 3)[hit]))
    assert torch.equal(bits(rec[hit, 7]), bits(s.intensity.reshape(-1)[hit]))
    code = (flags[hit] >> 3).long()
    rows = torch.where((code == 0)[:, None], scene.voxel_material,
                       scene.materials[torch.clamp(code - 1, min=0)])
    assert torch.equal(rows, s.mat.reshape(-1, 20)[hit])
    # the case has what it is there for: misses, hits of each kind
    assert 0 < int(hit.sum()) < hit.numel()
    if scene.n_voxels:
        assert int(s.vox_hit.sum()) > 50
    if scene.n_triangles:
        assert int((s.hit & ~s.vox_hit).sum()) > 50


def _host_shade(lib, scene, surf, d, occluded, frame=None):
    a, out = frame_shade.shade_args(surf, d, occluded, scene.materials,
                                    scene.voxel_material, CLEAR, frame)
    out.fill_(7.0)
    _launch(lib, a, "shade_post_launch")
    return out


@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_host_shade_post_matches_plain(frame_host, frame_scenes, ieee_sqrt,
                                       monkeypatch, case, shadows):
    """The frame through the kernels (camera_rays, the plain traces,
    hit_surface, the plain shadow pass, shade_post) against the plain
    frame.  The specular term, which passes through pow, is within 2 ulp
    of compute_specular's (shade_post reads it alone off a record with
    the diffuse term 0 and intensity 1); with the kernel's specular term
    in its place, render_rays' linear RGB is shade_post's bit for bit, and
    render_image's framebuffer within 2 ulp (gamma's pow), alpha 1."""
    name, backend, width, height, light = FRAME_CASES[case]
    scene = frame_scenes[name]
    vi, pi = _frame_camera(width, height)
    tiled = pipeline._tiles(backend, height, width)
    o, d = _host_rays(frame_host, width, height, vi, pi, tiled)
    if not tiled:
        o, d = o.reshape(height, width, 3), d.reshape(height, width, 3)
    primary = _primary(scene, o, d, backend)
    surf = _host_surface(frame_host, scene, o, d, primary, light, backend)
    occluded = (pipeline._occlusion(scene, surf.world_pos, surf.l_vec,
                                    surf.light_dist, surf.admit, backend,
                                    None, None, None) if shadows else None)
    flags = surf.rec.view(torch.int32)[:, 3]
    unit = surf.rec.clone()
    unit[:, 4:7], unit[:, 7] = 0.0, 1.0
    spec = _host_shade(frame_host, scene, surf._replace(rec=unit), d,
                       occluded)
    spec = torch.where(((flags & 1) != 0).reshape(spec.shape[:-1] + (1,)),
                       spec, 0.0)
    tri, t_vox, vox_id = primary
    s = pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                               backend)
    want = shading.compute_specular(s.mat, d, s.l_vec, s.normal)
    occ = (occluded.reshape(-1) if shadows
           else torch.zeros(flags.shape, dtype=torch.bool))
    lit = ((flags & 5) == 5) & ~occ         # hit, facing, not occluded
    powered = (lit & (s.mat.reshape(-1, 20)[:, 18] >= 2.0)).reshape(
        spec.shape[:-1])
    assert int(_ulps(spec[powered], want[powered]).max()) <= 2
    assert bool((spec[~powered] == 0).all()) and int(powered.sum()) > 20
    monkeypatch.setattr(pipeline.shading, "compute_specular",
                        lambda *args: spec)
    kw = dict(light=light, clear_color=CLEAR, backend=backend,
              shadows=shadows)
    rgb = _host_shade(frame_host, scene, surf, d, occluded)
    want = pipeline.render_rays(scene, o, d, **kw)
    assert rgb.shape == want.shape and torch.equal(rgb, want)
    img = _host_shade(frame_host, scene, surf, d, occluded,
                      (height, width, tiled))
    want = pipeline.render_image(scene, vi, pi, width=width, height=height,
                                 **kw)
    assert int(_ulps(img, want).max()) <= 2
    assert bool((img[..., 3] == 1.0).all())
    assert bool(((flags & 1) == 0).any())       # the frame has misses
    assert bool(((flags & 5) == 5)[occ].all())  # only admitted rays occlude


# ---- a voxel scene's rebuild: csrc/accel_build.cu against the PyTorch build

@pytest.fixture(scope="module")
def accel_host(host_kernels):
    """csrc/accel_build.cu built for the host: both passes of the accel
    build and the boxes."""
    return host_kernels["accel_build"]


def _occupancy(kind):
    """(Z, Y, X) uint8 grids: dims that are not multiples of 8 or 64 (one
    a 491-cell x-row, as the deforming cell's), superbricks cut by the
    grid's edge, more than 32 superbricks and more than one row of coarse
    words, empty and full grids, one cell; cells hold 1, 2, 128 or 255."""
    seed, dims, density = {"odd": (1, (13, 21, 37), 0.3),
                           "rows491": (2, (9, 5, 491), 0.2),
                           "edges": (3, (70, 9, 66), 0.05),
                           "many": (4, (330, 70, 130), 0.002),
                           "empty": (5, (17, 16, 24), 0.0),
                           "full": (6, (24, 16, 65), 1.0),
                           "one": (7, (1, 1, 1), 1.0)}[kind]
    rng = np.random.default_rng(seed)
    cells = rng.random(dims) < density
    values = rng.choice(np.uint8([1, 2, 128, 255]), dims)
    return torch.from_numpy(np.where(cells, values, 0).astype(np.uint8))


@pytest.mark.parametrize("fine_sb", [True, False])
@pytest.mark.parametrize("kind", ["odd", "rows491", "edges", "many", "empty",
                                  "full", "one"])
def test_host_accel_tables_match_plain(accel_host, kind, fine_sb):
    """Both passes over the occupancy write every table the PyTorch build
    (build_accel on CPU tensors) makes, bit for bit: fine, coarse, l2 and,
    with fine_sb, the superbrick tiles; every word is written (the tables
    start as garbage)."""
    occ = _occupancy(kind)
    want = build_accel(occ, np.zeros(3, np.float32), 0.1, fine_sb=fine_sb)
    a, tables = accel_build.accel_args(occ, want.bdims, fine_sb)
    for x in tables:
        if x is not None:
            x.view(torch.uint8).fill_(0xA5)
    _launch(accel_host, a, "accel_build_launch")
    fine, coarse, l2, tiles = tables
    assert torch.equal(fine, want.fine)
    assert torch.equal(coarse, want.coarse)
    assert torch.equal(l2, want.l2)
    assert (tiles is None) == (want.fine_sb is None)
    if fine_sb:
        assert torch.equal(tiles, want.fine_sb)
    occupied = int((occ != 0).sum())
    assert (int((fine != 0).sum()) > 0) == (occupied > 0)


@pytest.mark.parametrize("dims,origin,vs", [
    ((491, 245, 512), (-2.1484375, -1.0712, -2.2), 4.3 / 512),
    ((37, 21, 13), (0.7, -1.3, 2.1), 0.07),
    ((1, 1, 1), (0.0, 0.0, 0.0), 1.0)])
def test_host_aabb_boxes_match_plain(accel_host, dims, origin, vs):
    """The boxes of linear cell indices (the first and last cell among
    them) bit-equal to aabbs_from_linear on CPU tensors; every row
    written."""
    rng = np.random.default_rng(11)
    n_cells = dims[0] * dims[1] * dims[2]
    lin = torch.from_numpy(np.concatenate([
        [0, n_cells - 1], rng.integers(0, n_cells, 5000)]).astype(np.int64))
    a, boxes = accel_build.box_args(lin, dims, origin, vs)
    boxes.fill_(7.0)
    _launch(accel_host, a, "aabb_boxes_launch")
    want = aabbs_from_linear(lin, dims, np.float32(origin), vs)
    assert boxes.shape == want.shape and torch.equal(boxes, want)


# ---- the octree walk: csrc/octree_walk.cu against ops/octree_traverse._walk

def _octree_tree(name):
    """(tree, mesh vertices) of the octree cases, all at most 64 cells a
    side: the knot and the icosphere with their full region maps, the
    knot's tree under a coarse map of 3 bits (the descent below its
    INTERNAL entries), the icosphere's without a map or item rows (the
    descent from the root), and bunny_like(2) at 0.11, whose SLIVER_RAYS
    miss in the JAX package's walk."""
    from voxelray_torch.models.octree import Octree, build_region_map
    mesh, res = {"knot": ("knot", 64), "knot-coarse": ("knot", 64),
                 "icosphere": ("icosphere", 48),
                 "icosphere-nomap": ("icosphere", 48),
                 "bunny": ("bunny", None)}[name]
    if mesh == "bunny":
        v, f = meshes.bunny_like(2)
        vs = 0.11
    else:
        v, f, _, _, vs, _ = _mesh_grid(mesh, res)
    tree = Octree.from_mesh(v, f, vs, device="cpu")
    if name == "knot-coarse":
        tree = dataclasses.replace(tree, map_bits=3, region_map=torch.from_numpy(
            build_region_map(tree.children.numpy(), tree.bits_per_axis, 3)))
    elif name == "icosphere-nomap":
        tree = dataclasses.replace(tree, region_map=None, items4=None)
    assert 0 < tree.bits_per_axis <= 6
    return tree, v


def _octree_rays(tree, v, kind, seed=0):
    """(o, d) float32 (N, 3) of a ray set: "camera" (64 x 36 from outside),
    "inside" (from points inside the root cube), "grazing" (along an axis,
    from points on cell face planes and edges, some directions tilted by
    an ulp), "edges" (aimed at edges of occupied cells, test_torch_octree's
    stress set) and, on the bunny, its SLIVER_RAYS before them."""
    rng = np.random.default_rng(seed)
    lo, hi = v.min(axis=0), v.max(axis=0)
    if kind == "camera":
        center = (lo + hi) * 0.5
        cam = Camera(eye=tuple(center + np.float32([0.9, 0.55, -0.9]) * 0.85
                               * float(max(hi - lo))), center=tuple(center))
        _, _, vi, pi = cam.matrices(64, 36)
        o, d = make_camera_rays(64, 36, vi, pi)
        return (np.ascontiguousarray(o.reshape(-1, 3).numpy()),
                np.ascontiguousarray(d.reshape(-1, 3).numpy()))
    og = np.float32(tree.origin_key)
    vs = np.float32(tree.voxel_size)
    side = 1 << tree.bits_per_axis
    if kind == "inside":
        n = 1500
        o = og + rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32) \
            * np.float32(side) * vs
        d = rng.normal(size=(n, 3))
    elif kind == "grazing":
        n = 1500
        nx, ny, _ = tree.dims
        lin = torch.nonzero(tree.occupancy().reshape(-1)).squeeze(1).numpy()
        pick = lin[rng.integers(0, len(lin), n)]
        cell = np.stack([pick % nx, (pick // nx) % ny, pick // (nx * ny)], 1)
        axis = rng.integers(0, 3, n)
        # on one or two face planes of the cell, in from 2 to 6 cells back
        corner = (cell + rng.integers(0, 2, (n, 3))).astype(np.float32)
        frac = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
        on_edge = rng.random(n) < 0.5
        frac[on_edge] = 0.0
        o = og + (corner + frac * (rng.random((n, 3)) < 0.5)) * vs
        back = rng.uniform(2, 6, n).astype(np.float32)
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), axis] = sign
        o[np.arange(n), axis] -= sign * back * vs
        tilt = rng.random(n) < 0.3
        other = (axis + rng.integers(1, 3, n)) % 3
        d[np.flatnonzero(tilt), other[tilt]] = np.float32(2.0 ** -23)
    else:
        from test_torch_octree import SLIVER_RAYS, _edge_rays
        o, d = _edge_rays(tree, 3000, seed)
        if tree.voxel_size == 0.11:
            hexed = np.float32([[[float.fromhex(x) for x in v3] for v3 in r]
                                for r in SLIVER_RAYS])
            o = np.concatenate([hexed[:, 0], o])
            d = np.concatenate([hexed[:, 1], d])
    d = np.asarray(d, np.float64)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return np.ascontiguousarray(o, np.float32), \
        np.ascontiguousarray(d, np.float32)


def _host_octree(lib, o, d, tmn, tmx, tree, **kw):
    """The walk built for the host on (o, d): its outputs (every word
    written: they start as garbage) and its stats block."""
    bound = (lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray)
             else x)
    a, outs, stats = octree_walk.walk_args(
        torch.from_numpy(o), torch.from_numpy(d), bound(tmn), bound(tmx),
        tree, stats=True, **kw)
    for x in outs:
        x.view(torch.uint8).fill_(0xA5)
    _launch(lib, a, "octree_walk_launch")
    return [x.numpy() for x in outs], dict(zip(octree_walk.STATS,
                                               stats.tolist()))


def _plain_octree(o, d, tmn, tmx, tree, max_outer=512):
    from voxelray_torch.ops.octree_traverse import _walk
    n = len(o)
    bound = (lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray)
             else torch.full((n,), float(x)))
    t, lin, cut, steps, regions = _walk(
        torch.from_numpy(o), torch.from_numpy(d), tree, bound(tmn),
        bound(tmx), max_outer)
    return t.numpy(), lin.numpy(), {"rays": n, "regions": regions,
                                    "cut_rays": cut, "most_regions": steps}


@pytest.mark.parametrize("rays", ["camera", "inside", "grazing", "edges"])
@pytest.mark.parametrize("tree_name", ["knot", "knot-coarse", "icosphere",
                                       "icosphere-nomap", "bunny"])
def test_host_octree_walk_matches_plain(host_kernels, tree_name, rays):
    """The nearest hit of every ray, t and cell, bit-equal to _walk's, with
    the same counts: rays walked, region steps (their sum and the most of
    one ray) and none cut."""
    tree, v = _octree_tree(tree_name)
    o, d = _octree_rays(tree, v, rays)
    (t, lin), stats = _host_octree(host_kernels["octree_walk"], o, d, TMIN,
                                   TMAX, tree)
    tp, lp, want = _plain_octree(o, d, TMIN, TMAX, tree)
    assert np.array_equal(t, tp) and np.array_equal(lin, lp)
    assert stats == want and stats["cut_rays"] == 0
    assert np.isfinite(t).sum() > len(o) // 20


@pytest.mark.parametrize("tree_name", ["knot", "knot-coarse", "bunny"])
def test_host_octree_any_hit_matches_plain(host_kernels, tree_name):
    """The shadow pass: from the camera rays' hit points toward a light,
    t_max each ray's distance to it, a sparse admit mask (a third of the
    hits).  The any-hit mode's answer is isfinite of _walk's t over the
    admitted rays, False elsewhere; it walks the admitted rays alone."""
    tree, v = _octree_tree(tree_name)
    o, d = _octree_rays(tree, v, "camera")
    (t, _), _ = _host_octree(host_kernels["octree_walk"], o, d, TMIN, TMAX,
                             tree)
    hit = np.isfinite(t)
    p = o + d * np.where(hit, t, 1.0)[:, None]
    to_light = np.float32([10.0, 55.0, 8.0]) - p
    dist = np.linalg.norm(to_light, axis=1).astype(np.float32)
    ld = (to_light / dist[:, None]).astype(np.float32)
    admit = hit & (np.random.default_rng(3).random(len(o)) < 0.35)
    (occluded,), stats = _host_octree(
        host_kernels["octree_walk"], p, ld, TMIN, dist, tree,
        admit=torch.from_numpy(admit), any_hit=True)
    tp, _, want = _plain_octree(p[admit], ld[admit], TMIN, dist[admit],
                                tree)
    expect = np.zeros(len(o), bool)
    expect[admit] = np.isfinite(tp)
    assert np.array_equal(occluded, expect)
    assert stats == want and 0 < expect.sum() < admit.sum()


def test_host_octree_walk_cut_at_max_outer(host_kernels):
    """A bound of 2 region steps cuts the rays that need more: they miss,
    and the kernel counts as many cut rays as _walk does, with the same
    results for the rest."""
    tree, v = _octree_tree("knot")
    o, d = _octree_rays(tree, v, "camera")
    (t, lin), stats = _host_octree(host_kernels["octree_walk"], o, d, TMIN,
                                   TMAX, tree, max_outer=2)
    tp, lp, want = _plain_octree(o, d, TMIN, TMAX, tree, max_outer=2)
    assert np.array_equal(t, tp) and np.array_equal(lin, lp)
    assert stats == want and stats["cut_rays"] > 100
    assert stats["most_regions"] == 2
