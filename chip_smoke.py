#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (voxelray_torch) at full size.

Drives the port's paths the way a user calls them, at the bench's size:

  * the voxel path: a 1,048,576-triangle torus knot voxelized to 512^3
    (GridBool.from_mesh, kernel K1), the voxel scene and its brick accel
    (build_scene), and a 1920x1080 frame with shadow rays (render_image,
    backend="fast": the megakernel K2);
  * the same frame through the staged walk (fast_opts {"mega": False}):
    one staged_march launch per trace, the whole staged walk of K3
    grid_walk and K4 brick_fine in one kernel; K3 and K4 themselves
    launch only in the lap loop it is held to (staged_march_plain);
  * the triangle path: the same knot as a triangle model
    (build_scene(models=[...]) builds the triangle accel on the card) and
    a 1920x1080 frame with shadow rays, whose tri-grid march is one
    tri_march launch per trace (K3 and K4 are not launched there);
  * the encodings (phase 8): the 512^3 grid's AABBs extracted (GridBool
    .get_aabbs and get_aabbs_fixed), GridAabbStruct, GridVec and the
    octree built on the card (build ms, memory_usage_bytes), and gate 3's
    octree scene rendered with backend="octree", its primary trace (the
    octree_walk kernel under the coarse region map) held to the plain
    walk and against K2's; then a brute AABB trace of sampled rays
    against K2 and
    save_grid / load_grid round trips;
  * the front end (phase 9): `python -m voxelray_torch.cli`'s main in
    this process on the knot at 512^3 with the ground plane, one
    1920x1080 frame (counted: K1 and K2), bit-equal to render_scene on
    the same grid and plane, then its raster and octree AOV modes; gates
    1-5 at scale 1; K1's 512^3 grid against the serial C++ voxelizer
    (voxelray_torch/native); render_aov fast against dda on the voxel
    frame;
  * the multi-device layer (phase 10, parallel/comm.py) on a rehearsal
    mesh of 4 entries on the one card and on make_mesh(), the real mesh:
    voxelize_sharded (K1 per shard) of the knot less one triangle, so the
    sentinel pad runs; render_sharded (K2 per row shard) of the frame;
    render_zslab_sharded of the frame with the grid in 4 Z-slabs of 128
    rows (each a build_accel_slab accel, one staged_march launch per
    slab trace with a fine window, bit-equal to the lap loop over K3/K4
    on every slab, no host sync between the slabs), its merged trace
    bit-equal to the monolithic staged walk's; the DDA
    Z-slab render at gate 2's bunny (128^3, 1280x720); gate 5's mesh.
  * the bench (phase 11): `python -m voxelray_torch.bench`'s run() at
    the full preset in this process (K1 through voxelize_planned, K2;
    its parity and exhaustiveness gates must pass), its JSON line logged;
    voxelize_planned on the knot bit-equal to phase 1's voxelize_mesh; a
    deforming knot's frames queued through a deform_safe plan with no
    host sync (sync debug mode "error"), each bit-equal to voxelize_mesh
    and one to voxelize_plain; one voxel frame, which must make no host
    sync.
  * the frame glue (phase 12): on the voxel and the triangle frame, the
    three kernels of csrc/frame_shade.cu (camera_rays, hit_surface,
    shade_post) each against the plain PyTorch stage it replaced on the
    same inputs: the rays, the shadow query and the shading record bit
    for bit, the framebuffer within 2 ulp; each launched once a frame in
    phases 2 and 7.
  * the planned triangle build (phase 13): the knot under 4 deformed
    vertex sets, one plan_tri_accel over their union box (the tri-deform
    cell's 256-cell grid); on each set build_tri_accel_planned through the
    tri_bin kernels against the plain path (tri_cell_pairs on the card),
    table for table, bit for bit; the count, cells, emit and rows passes
    and the corners pass against their plain versions (the counts, the
    sizes block, the rows of the serial pair stream, the triangle table
    and face terms); set 1 with PILES small triangles piled into a cell
    each, whose rows the wide path orders (launched once), against the
    plain rows; the rebuild's one host sync and its kernels (the tri_bin
    passes and accel_build alone); each pass's ms (CUDA events) beside
    the bound, the wide path's on the piled set.
  * the octree walk (phase 15, BASELINE configs[2]): the knot's GridVec
    at 256 cells on its longest axis (245x114x256) under its Morton
    octree (Octree.from_grid, equal field by field to Octree.from_mesh),
    the gate-3 scene over it; on the frames of the orbit cameras the
    octree_walk kernel (one launch a trace) against the plain walk on the
    card (_walk; the shadow rays through the admit mask against the
    admitted rays compacted), ray by ray: 0 rays apart, 0 cut at
    max_outer; the kernel's ms by CUDA events beside its byte bound, its
    registers and spills; the frame's launches and host syncs (0), and
    the frame with the kernel against the frame with the plain walk.
  * the voxel scene's rebuild (phase 14): the deforming cell's grid
    (491x245x512 over the union box of its 32 vertex sets, set 1
    voxelized by K1) and phase 13's tri grid: accel_build's tables (with
    and without the superbrick tiles) and aabb_boxes' boxes against their
    plain versions on the card, bit for bit; a step's build_scene, its
    launches, its one host sync, its time; kernel ms beside the bound.

Each path runs once with the kernels' launch counters set to 0 just
before it and read just after (staged_march's row counts the staged
voxel frame's launches; the K3 and K4 rows count the same frame's
through the lap loop that staged_march replaced; K1's row adds the
bench's and the planned calls' launches to the voxel path's).  A repeated
device is a rehearsal: its times are not a multi-card speed.  Then every
kernel is held against its plain PyTorch version on the same inputs on
the card and timed beside it (tri_march and staged_march against the lap
loops over K3 and K4 they replace, run with the kernels and fully plain,
on the frame's primary and shadow rays), the traces are checked against
the exhaustive references, and whole frames are timed (the triangle and
the staged voxel frame also with the lap loop, for the same-run before
and after).  K1 is also timed alone (no zeroed volume, no sync); K2 also
on the primary rays of each step class (k2_step_classes) and on the
shadow pass's admitted rays compacted.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels are built from csrc/ into
voxelray_torch/_build/ at first use).  Exits non-zero without a CUDA
device, outside the repository, or when any check fails.  The last three
lines of standard output are: the kernel table (JSON), the card's name
and power limit as nvidia-smi reports them, and the result line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

MESH = dict(p=2, q=3, segments=1024, tube_segments=512)
GRID_RES = 512
WIDTH, HEIGHT = 1920, 1080
CHECK_W, CHECK_H = 480, 270
N_FRAMES = 4
MAX_DIFF_RAYS = 2048
PIXEL_ATOL = 2e-5
PIXEL_FRAC = 0.999
TRI_RTOL, TRI_ATOL = 3e-6, 1e-7
N_BRUTE = 4096
# phase 9: the CLI's knot at knot512's voxel size, bunny at vec256's
CLI_MESH, CLI_VS, BUNNY_VS = "knot1m", 4.3 / 512, 2.8 / 256
GATE_SCALE = 1.0
SMALL_W, SMALL_H = 1280, 720
# phase 10: frames of the sharded paths against render_image's; the DDA
# Z-slab path at gate 2's bunny128 voxel size
RTOL, ATOL = 2e-6, 1e-7
BUNNY_DDA_VS = 2.8 / 128
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# fp32 operations per step, counted from the kernels' expressions:
# K1 and tri_bin one SAT test of a (triangle, cell) slot (13 axes) plus
# its cell centre (csrc/sat.cuh; counted term by term as
# benchmark/vrbench/work.py's SAT_OPS); K2 and K4 one cell's slab test
# plus the DDA step; K3 (and K2 between bricks) one brick's crossing
# times, their minimum and the step; tri_march per lap K3's fused init
# (bbox clip and entry brick) and the advance, per tested row the cell's
# span (a slab test), per ray-triangle pair Moller-Trumbore with its
# accept tests
OPS_SAT, OPS_CELL, OPS_BRICK = 270, 52, 17
OPS_LAP, OPS_TRI = 48, 61
# phase 13: the planned triangle build over TRI_SETS vertex sets spread
# over the deforming cell's cycle (amplitude 0.15), its tri grid's cells
# on the longest axis
TRI_SETS, TRI_AMPLITUDE, TRI_RES = 4, 0.15, 256
# ... and set 1 with small triangles piled into a cell each, rows longer
# than the rows pass's warp path (tri_bin.WARP_ROW)
PILES = (100, 600)
TRI_BIN = ("tri_bin_count", "tri_cells", "tri_bin_emit", "tri_rows")
TRI_KERNELS = ("tri_corners_kernel", "tri_bin_count_kernel",
               "tri_cells_kernel", "tri_bin_emit_kernel", "tri_rows_kernel",
               "tri_rows_wide_kernel")
# phase 14: the voxel scene's rebuild over the deforming cell's grid, GRID_RES
# cells on the longest axis of the union box of its DEFORM_SETS vertex sets
DEFORM_SETS = 32
# phase 15: the octree over the knot's GridVec at OCTREE_RES cells on the
# longest axis (BASELINE configs[2]), at most 16 items a leaf; the bench's
# light
OCTREE_RES = 256
BENCH_LIGHT = ((10.0, 55.0, 8.0), 1000.0)
# phase 12: the frame glue's kernels (csrc/frame_shade.cu); their calls
# timed queued behind a ~10 ms sleep, longer than the host takes to queue
# them
FRAME_KERNELS = ("camera_rays", "hit_surface", "shade_post")
FRAME_REPS, QUEUE_CYCLES = 20, 20_000_000


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps):
    """Mean device ms of fn() over reps runs (after one warm-up)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean device ms of fn() over reps calls queued behind a sleeping
    kernel, so that the host's time a call does not pace them (after one
    warm-up)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps):
    """Host us a call of fn() over reps calls (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    fp32 operations over the fp32 peak."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops):
    b_ms, b_by = bound(nbytes, ops)
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP), launches {launches}, max |err| {err}")
    return {"name": name, "route": "cuda",
            "source": f"voxelray_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(b_ms, 5), "bound_by": b_by, "library_ms": None}


def ptxas_of(log, kernel):
    """ptxas's lines (registers, stack, spills) for the entry function
    whose name holds `kernel`."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and ("registers" in ln or "spill" in ln):
            out.append(ln.strip().removeprefix("ptxas info    : "))
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_camera(bb_min, bb_max):
    """The bench camera (bench.py:366-369) and its orbit."""
    import numpy as np
    from voxelray_torch.render.camera import Camera, orbit_path
    extent = float(max(bb_max - bb_min))
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * extent),
                 center=tuple(center))
    r_orbit = float(np.linalg.norm(np.asarray([0.9, 0.55, -0.9]) * extent))
    orbit = orbit_path(N_FRAMES, center=tuple(float(c) for c in center),
                       radius=r_orbit,
                       height=float(center[1] + 0.55 * extent))
    return cam, orbit


def close_camera(bb_min, bb_max):
    """A camera inside the knot's box, looking at its centre: most rays
    hit within a few cells, many at grazing angles."""
    import numpy as np
    from voxelray_torch.render.camera import Camera
    extent = float(max(bb_max - bb_min))
    center = (bb_min + bb_max) * 0.5
    return Camera(eye=tuple(center + np.asarray([0.25, 0.12, -0.2]) * extent),
                  center=tuple(center))


def compare_traces(what, o, d, occ, origin, vs, t_k, lin_k, t_p, lin_p):
    """Kernel vs plain: differing rays <= MAX_DIFF_RAYS, each adjudicated
    against the numpy oracle; t bit-equal where the cells agree.
    Returns (n_diff, max_abs_t_err over agreeing hits)."""
    import numpy as np
    from voxelray_torch.utils.parity import adjudicate_hit_diffs
    tk, lk = t_k.cpu().numpy(), lin_k.cpu().numpy()
    tp, lp = t_p.cpu().numpy(), lin_p.cpu().numpy()
    hk, hp = np.isfinite(tk), np.isfinite(tp)
    diff = (hk != hp) | (hk & hp & (lk != lp))
    same = hk & hp & (lk == lp)
    err = float(np.max(np.abs(tk[same] - tp[same]))) if same.any() else 0.0
    idx = np.flatnonzero(diff)
    log(f"{what}: kernel hits {int(hk.sum())}, plain hits {int(hp.sum())}, "
        f"differing rays {len(idx)}, max |t| err where cells agree {err}")
    require(len(idx) <= MAX_DIFF_RAYS,
            f"{what}: {len(idx)} differing rays > {MAX_DIFF_RAYS}")
    require(err == 0.0, f"{what}: t differs where the cells agree")
    if len(idx):
        adj = adjudicate_hit_diffs(o.cpu().numpy(), d.cpu().numpy(), occ,
                                   origin, vs, idx, tk, lk, tp, lp)
        log(f"{what}: adjudication {adj}")
        require(adj["adjudication_ok"], f"{what}: a differing ray failed "
                "adjudication against the oracle")
    return len(idx), err


def time_frames(scene, mats, backend="fast", **kw):
    """{shadows: ms per WIDTHxHEIGHT frame} over the orbit cameras, after
    one warm-up pass; kw go to render_image."""
    import torch
    from voxelray_torch.render import pipeline
    out = {}
    for shadows in (True, False):
        def frames():
            for mvi, mpi in mats:
                pipeline.render_image(scene, mvi, mpi, width=WIDTH,
                                      height=HEIGHT, backend=backend,
                                      shadows=shadows, **kw)
        frames()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames()
        torch.cuda.synchronize()
        out[shadows] = (time.perf_counter() - t0) * 1e3 / len(mats)
    return out


def log_frames(what, frame_ms, smi):
    for shadows, ms in frame_ms.items():
        log(f"{what} frame {WIDTH}x{HEIGHT} shadows={shadows}: {ms:.3f} "
            f"ms/frame, {WIDTH * HEIGHT / ms / 1e3:.2f} Mrays/s (primary "
            f"rays) over {N_FRAMES} orbit cameras [{smi}]")


def _kernel(mod):
    """A kernel's counter name: its module's last name, or the name given
    (the frame glue's three kernels share one module)."""
    return mod if isinstance(mod, str) else mod.__name__.rsplit(".", 1)[-1]


def launched(mod):
    """A kernel module's launches since its reset (utils/trace.py)."""
    from voxelray_torch.utils import trace
    return trace.counter("launches." + _kernel(mod))


def counts_of(*mods):
    return {_kernel(m): launched(m) for m in mods}


def reset(*mods):
    from voxelray_torch.utils import trace
    for m in mods:
        trace.reset_counters("launches." + _kernel(m))


def mega_work(o, d, tmn, tmx, accel):
    """K2's own work on these rays, counted by the plain staged walk one
    occupied brick at a time, which is K2's order: the two-level brick
    walk (empty superbricks skipped) to the next occupied brick, the
    per-voxel walk through it, on until the first accepted cell.
    Returns (brick steps, cell steps: (N,) int64 per ray, distinct
    occupied bricks read, hit cell lin per ray)."""
    import torch
    from voxelray_torch.ops.kernels import brick_fine, grid_walk
    wkw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
               brick_world=float(accel.voxel_size * 8), k_hits=1,
               per_hit=True)
    fkw = dict(dims=accel.dims, bdims=accel.bdims,
               origin_key=accel.origin_key, voxel_size=accel.voxel_size,
               count_steps=True)
    n = o.shape[0]
    lin_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    idx = torch.arange(n, device=o.device)
    hits, cell, cont, steps = grid_walk.walk_plain(
        o, d, tmn, tmx, None, None, accel.coarse, accel.l2, **wkw)
    brick_steps = steps[0].clone()
    cell_steps = torch.zeros_like(brick_steps)
    seen = []
    for _ in range(sum(accel.bdims) + 4):
        seen.append(hits[0])
        t, lin, steps = brick_fine.fine_plain(o[idx], d[idx], hits,
                                              accel.fine, tmn[idx],
                                              tmx[idx], **fkw)
        cell_steps[idx] += steps
        got = torch.isfinite(t)
        lin_out[idx[got]] = lin[got]
        keep = torch.nonzero(~got & (cont > 0)).squeeze(1)
        idx, cell = idx[keep], cell[keep]
        if idx.numel() == 0:
            break
        hits, cell, cont, steps = grid_walk.walk_plain(
            o[idx], d[idx], None, tmx[idx], cell,
            torch.ones(idx.shape, dtype=torch.int32, device=o.device),
            accel.coarse, accel.l2, **wkw)
        brick_steps[idx] += steps[0]
    require(idx.numel() == 0, "K2 work count: rays left at the step bound")
    bricks = torch.unique(torch.cat(seen))
    return brick_steps, cell_steps, int((bricks >= 0).sum()), lin_out


def k2_step_classes(brick_steps, cell_steps):
    """The rays split by their K2 steps (brick + cell steps, mega_work's
    per-ray counts): {class name: ray indices} for fewer than 8 steps, 8
    to 31, at least 32 and the longest ray alone, and the step histogram
    and the SIMT efficiency of one ray per thread in 32-ray warps (the
    steps over 32 x the sum of each warp's longest ray: the share of
    lane-steps doing work when a warp runs until its longest ray ends),
    of brick steps, cell steps and operations (OPS_BRICK, OPS_CELL)."""
    import torch
    steps = brick_steps + cell_steps

    def simt(x):
        w = torch.nn.functional.pad(x, (0, (-x.numel()) % 32)).reshape(-1, 32)
        return float(x.sum()) / (32 * float(w.amax(1).sum()))

    classes = {"< 8 steps": steps < 8,
               "8-31 steps": (steps >= 8) & (steps < 32),
               ">= 32 steps": steps >= 32}
    idx = {k: torch.nonzero(m).squeeze(1) for k, m in classes.items()}
    idx["the longest ray"] = torch.argmax(steps)[None]
    stats = {"rays_with_steps_at_least": {
                 k: int((steps >= k).sum()) for k in
                 (1, 2, 4, 8, 16, 32, 64, 128, 256)},
             "max_steps": int(steps.max()),
             "simt_efficiency": {
                 "brick": simt(brick_steps), "cell": simt(cell_steps),
                 "operations": simt(brick_steps * OPS_BRICK
                                    + cell_steps * OPS_CELL)}}
    return idx, stats


@contextlib.contextmanager
def lap_loop_march():
    """Inside, trace_triangles_grid on the card runs the lap loop over the
    K3 and K4 kernels (tri_march_plain), the march before its kernel."""
    from voxelray_torch.ops import tri_accel
    from voxelray_torch.ops.kernels import tri_march
    saved = tri_accel.tri_march_cuda
    tri_accel.tri_march_cuda = tri_march.tri_march_plain
    try:
        yield
    finally:
        tri_accel.tri_march_cuda = saved


@contextlib.contextmanager
def lap_loop_staged():
    """Inside, the staged trace on the card (trace_grid_fast(mega=False))
    runs the lap loop over the K3 and K4 kernels (staged_march_plain),
    the staged walk before its kernel."""
    from voxelray_torch.ops.kernels import staged_march
    saved = staged_march.staged_march_cuda
    staged_march.staged_march_cuda = staged_march.staged_march_plain
    try:
        yield
    finally:
        staged_march.staged_march_cuda = saved


@contextlib.contextmanager
def counted_walks(work):
    """Inside, K3 and K4 run their plain versions (on CPU and CUDA tensors
    alike) and add to `work` the staged walk's brick and cell steps as
    the one-launch kernels (staged_march, tri_march) take them, and the
    bricks K4 reads ("bricks_seen", a mask over brick ids).  Each K4 call
    of the lap loop follows the K3 call that collected its bricks; the
    kernels walk a group's bricks only up to the one at which K4 decides
    the hit, so a ray's brick steps in a group are K3's iterations up to
    that brick (all of them where none decides)."""
    import torch
    from voxelray_torch.ops.kernels import brick_fine, grid_walk
    work.setdefault("brick_steps", 0)
    work.setdefault("cell_steps", 0)
    group = {}
    saved = (grid_walk.walk_cuda, grid_walk.walk_plain, brick_fine.fine_cuda,
             brick_fine.fine_plain)
    walk_plain, fine_plain = saved[1], saved[3]

    def walk(*a, **kw):
        *out, hit_steps = walk_plain(*a, **kw, per_hit=True)
        group["hit_steps"] = hit_steps
        return tuple(out)

    def fine(*a, **kw):
        *out, steps, decided = fine_plain(*a, **kw, count_steps=True,
                                          per_hit=True)
        hit_steps = group.pop("hit_steps")
        slot = torch.clamp(decided, max=hit_steps.shape[0] - 1)
        work["brick_steps"] += int(hit_steps.gather(0, slot[None]).sum())
        work["cell_steps"] += int(steps.sum())
        bricks = a[2]
        bx, by, bz = kw["bdims"]
        seen = work.setdefault("bricks_seen", torch.zeros(
            bx * by * bz, dtype=torch.bool, device=bricks.device))
        slots = torch.arange(bricks.shape[0], device=bricks.device)[:, None]
        off = kw.get("fine_off", 0)
        read = bricks[(slots <= decided[None]) & (bricks >= off)
                      & (bricks < off + a[3].shape[1])]
        seen[read.long()] = True
        return tuple(out)

    grid_walk.walk_cuda = grid_walk.walk_plain = walk
    brick_fine.fine_cuda = brick_fine.fine_plain = fine
    try:
        yield
    finally:
        (grid_walk.walk_cuda, grid_walk.walk_plain, brick_fine.fine_cuda,
         brick_fine.fine_plain) = saved


def march_work(o, d, tmn, tmx, ta):
    """The fully plain march (the lap loop over the plain K3 and K4) on
    these rays, counting tri_march's own work on them: ray-laps, rows
    tested, ray-triangle tests, distinct rows and triangles read, and the
    staged walk's brick and cell steps as the kernel takes them
    (counted_walks).  On CPU tensors too.  Returns (outputs, work,
    seconds)."""
    import torch
    from voxelray_torch.ops.kernels import tri_march
    work = {}
    with counted_walks(work):
        t0 = time.perf_counter()
        out = tri_march.tri_march_plain(o, d, tmn, tmx, ta, work=work)
        if o.is_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, work, secs


def staged_work(*args):
    """The fully plain staged trace (the lap loop over the plain K3 and
    K4) on staged_march_plain's arguments, counting staged_march's own
    work on them (counted_walks).  Returns (outputs, work, seconds)."""
    import torch
    from voxelray_torch.ops.kernels import staged_march
    work = {}
    with counted_walks(work):
        t0 = time.perf_counter()
        out = staged_march.staged_march_plain(*args)
        if args[0].is_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, work, secs


def check_staged(what, o, d, tmn, tmx, admit, accel, k):
    """staged_march against the lap loop it replaces on the same rays, run
    with the K3/K4 kernels and fully plain: t bits and lin equal,
    unresolved 0 on every side.  Returns (kernel ms, lap-loop ms, plain
    ms, bytes, operations)."""
    import torch
    from voxelray_torch.ops.kernels import staged_march
    args = (o, d, accel, tmn, tmx, admit, k, None)
    got = staged_march.staged_march_cuda(*args)
    unresolved = int(got[2])
    lap = staged_march.staged_march_plain(*args)
    plain, work, plain_s = staged_work(*args)
    log(f"{what}: staged_march unresolved {unresolved}, lap loop "
        f"{lap[2]}, plain lap loop {plain[2]}")
    require(unresolved == lap[2] == plain[2] == 0,
            f"{what}: a staged trace left rays unresolved")
    for ref, name in ((lap, "the lap loop with K3/K4"),
                      (plain, "the plain lap loop")):
        require(torch.equal(got[1], ref[1]), f"{what}: staged_march cells "
                f"differ from {name}")
        require(torch.equal(got[0].view(torch.int32),
                            ref[0].view(torch.int32)),
                f"{what}: staged_march t differs from {name}")
    ms = cuda_ms(lambda: staged_march.staged_march_cuda(*args), 5)
    lap_ms = cuda_ms(lambda: staged_march.staged_march_plain(*args), 1)
    n = o.shape[0]
    n_rays = n if admit is None else int(admit.sum())
    n_bricks = int(work["bricks_seen"].sum()) if "bricks_seen" in work \
        else 0
    l2_words = accel.l2.numel() if accel.coarse.shape[0] > 4 else 0
    # t, lin out for every ray, its admit byte, o, d and bounds in for
    # each ray traced, the brick masks, the fine words of every brick K4
    # reads
    nbytes = (n * 8 + (0 if admit is None else n) + n_rays * 32
              + 4 * (accel.coarse.numel() + l2_words) + 64 * n_bricks)
    ops = (n_rays * OPS_LAP + work["brick_steps"] * OPS_BRICK
           + work["cell_steps"] * OPS_CELL)
    b_ms, b_by = bound(nbytes, ops)
    log(f"{what}: staged_march ({n} rays, {n_rays} traced, k {k}, "
        f"{int((got[1] >= 0).sum())} hits, fine window of "
        f"{accel.fine.shape[1]} bricks from {accel.fine_off}) bit-equal to "
        f"the lap loop with K3/K4 and to the plain lap loop; work "
        f"{work['brick_steps']} brick steps, {work['cell_steps']} cell "
        f"steps, {n_bricks} bricks read; kernel {ms:.4f} ms, lap loop with "
        f"K3/K4 {lap_ms:.4f} ms (same run: before {lap_ms:.4f} ms, after "
        f"{ms:.4f} ms), plain lap loop {plain_s * 1e3:.1f} ms, bound "
        f"{b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP)")
    return ms, lap_ms, plain_s * 1e3, nbytes, ops


def check_march(what, o, d, tmn, tmx, ta):
    """tri_march against the lap loop it replaces on the same rays, run
    with the K3/K4 kernels and fully plain: (t, id) bit-equal, (u, v)
    bit-equal where there is a hit, unresolved 0 on every side.  Returns
    (kernel ms, lap-loop ms, plain ms, bytes, operations)."""
    import torch
    from voxelray_torch.ops.kernels import tri_march
    args = (o, d, tmn, tmx, ta)
    got = tri_march.tri_march_cuda(*args)
    unresolved = int(got[4])
    lap = tri_march.tri_march_plain(*args)
    plain, work, plain_s = march_work(*args)
    log(f"{what}: tri_march unresolved {unresolved}, lap loop "
        f"{lap[4]}, plain lap loop {plain[4]}")
    require(unresolved == lap[4] == plain[4] == 0,
            f"{what}: a march left rays unresolved")
    for ref, name in ((lap, "the lap loop with K3/K4"),
                      (plain, "the plain lap loop")):
        hit = ref[1] >= 0
        for k, a, b in (("t", got[0], ref[0]), ("id", got[1], ref[1]),
                        ("u", got[2][hit], ref[2][hit]),
                        ("v", got[3][hit], ref[3][hit])):
            require(torch.equal(a, b), f"{what}: tri_march {k} differs "
                    f"from {name}")
    ms = cuda_ms(lambda: tri_march.tri_march_cuda(*args), 5)
    lap_ms = cuda_ms(lambda: tri_march.tri_march_plain(*args), 1)
    n = o.shape[0]
    rows_read = int(work["rows_seen"].sum())
    tris_read = int(work["tris_seen"].sum())
    br = ta.brick
    nbytes = (n * 48 + rows_read * (4 * ta.l_width + 4) + tris_read * 36
              + 4 * (br.coarse.numel() + br.l2.numel()))
    ops = (work["laps"] * OPS_LAP + work["rows"] * OPS_CELL
           + work["brick_steps"] * OPS_BRICK + work["cell_steps"] * OPS_CELL
           + work["tests"] * OPS_TRI)
    b_ms, b_by = bound(nbytes, ops)
    log(f"{what}: tri_march ({n} rays, {int((got[1] >= 0).sum())} hits) "
        f"bit-equal to the lap loop with K3/K4 and to the plain lap loop; "
        f"work {work['laps']} ray-laps, {work['rows']} rows, "
        f"{work['tests']} ray-triangle tests, {work['brick_steps']} brick "
        f"steps, {work['cell_steps']} cell steps, {rows_read} rows and "
        f"{tris_read} triangles read; kernel {ms:.4f} ms, lap loop with "
        f"K3/K4 {lap_ms:.4f} ms (same run: before {lap_ms:.4f} ms, after "
        f"{ms:.4f} ms), plain lap loop {plain_s * 1e3:.1f} ms, bound "
        f"{b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP)")
    return ms, lap_ms, plain_s * 1e3, nbytes, ops


def knot_model(v, f):
    """The mesh as the ObjLoader flattens an OBJ without normals or UVs:
    per-corner streams, flat face normals, one default material."""
    import numpy as np
    from voxelray_torch.io.objload import LoadedModel, Material
    pos = v[f].reshape(-1, 3)
    p = pos.reshape(-1, 3, 3)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), n)
    verts = np.zeros((len(pos), 11), np.float32)
    verts[:, 0:3] = pos
    verts[:, 3:6] = np.repeat(n, 3, axis=0)
    return LoadedModel(vertices=verts,
                       indices=np.arange(len(pos), dtype=np.uint32),
                       materials=Material().as_row()[None],
                       textures=[], mat_index=np.zeros(len(f), np.int32))


def check_walk(what, o, d, tmn, tmx, accel, k, cell=None, active=None):
    """K3 against walk_plain on one call's inputs: every output bit-equal.
    Returns (outputs, kernel ms, plain ms, lane steps, bytes)."""
    import torch
    from voxelray_torch.ops.kernels import grid_walk
    l2 = accel.l2 if accel.coarse.shape[0] > 4 else None
    kw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
              brick_world=float(accel.voxel_size * 8), k_hits=k)
    args = (o, d, tmn if cell is None else None, tmx, cell, active,
            accel.coarse, l2)
    got = grid_walk.walk_cuda(*args, **kw)
    *want, steps = grid_walk.walk_plain(*args, **kw, count_steps=True)
    for name, a, b in zip(("hits", "cell", "cont"), got, want):
        require(torch.equal(a, b), f"{what}: K3 {name} differ from plain")
    ms = cuda_ms(lambda: grid_walk.walk_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: grid_walk.walk_plain(*args, **kw), 1)
    n = o.shape[0]
    nbytes = n * (32 if cell is None else 44) + n * (4 * k + 16) \
        + 4 * accel.coarse.numel() + (0 if l2 is None else 4 * l2.numel())
    b_ms, b_by = bound(nbytes, steps * OPS_BRICK)
    log(f"{what}: K3 ({'two' if l2 is not None else 'one'} level, k {k}, "
        f"{n} rays) bit-equal to plain; {int((got[0] >= 0).sum())} "
        f"candidates, {steps} brick steps; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
    return got, ms, plain_ms, steps, nbytes


def check_fine(what, o, d, bricks, tmn, tmx, accel):
    """K4 against fine_plain on one call's inputs: (t, lin) bit-equal.
    Returns (outputs, kernel ms, plain ms, lane steps, bytes)."""
    import torch
    from voxelray_torch.ops.kernels import brick_fine
    kw = dict(dims=accel.dims, bdims=accel.bdims,
              origin_key=accel.origin_key, voxel_size=accel.voxel_size,
              fine_off=accel.fine_off)
    args = (o, d, bricks, accel.fine, tmn, tmx)
    got = brick_fine.fine_cuda(*args, **kw)
    *want, steps = brick_fine.fine_plain(*args, **kw, count_steps=True)
    steps = int(steps.sum())
    require(torch.equal(got[1], want[1]), f"{what}: K4 cells differ")
    require(torch.equal(got[0], want[0]), f"{what}: K4 t differ")
    ms = cuda_ms(lambda: brick_fine.fine_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: brick_fine.fine_plain(*args, **kw), 1)
    n, k = o.shape[0], bricks.shape[0]
    n_bricks = int(torch.unique(bricks[bricks >= 0]).numel())
    nbytes = n * (32 + 4 * k) + n * 8 + 64 * n_bricks
    b_ms, b_by = bound(nbytes, steps * OPS_CELL)
    log(f"{what}: K4 (k {k}, {n} rays, {n_bricks} distinct bricks, fine "
        f"window of {accel.fine.shape[1]} bricks from {accel.fine_off}) "
        f"bit-equal to plain; {int((got[1] >= 0).sum())} hits, {steps} "
        f"cell steps; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms by {b_by}")
    return got, ms, plain_ms, steps, nbytes


def wall_ms(fn):
    """(fn's result, wall ms of one call with the device synced)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def numpy_aabbs(occ_np, origin, vs):
    """The numpy float32 aabbs_from_linear of np.flatnonzero: the rows
    the extraction must give bit for bit."""
    import numpy as np
    nz, ny, nx = occ_np.shape
    lin = np.flatnonzero(occ_np.reshape(-1))
    x, y, z = lin % nx, (lin // nx) % ny, lin // (nx * ny)
    v = np.float32(vs)
    h = np.float32(0.5) * v
    org = np.asarray(origin, np.float32)
    c = [org[i] + (a.astype(np.float32) + np.float32(0.5)) * v
         for i, a in enumerate((x, y, z))]
    return np.stack([c[0] - h, c[1] - h, c[2] - h, c[0] + h, c[1] + h,
                     c[2] + h], axis=-1)


def check_extraction(grid, occ_np, smi):
    """GridBool.get_aabbs and get_aabbs_fixed (capacity 1 << 20, word and
    group capacities from the counts plus 10%, rounded up to 8192, as
    bench.py:296-303 sizes them): count equal to the occupied cells, rows
    bit-equal to numpy's.  Returns the exact rows."""
    import numpy as np
    import torch
    from voxelray_torch.ops import aabbs as ops_aabbs
    occ = grid.occupancy()
    n_occ = int(occ_np.sum())
    nzw = ops_aabbs.count_nonzero_words(occ)
    nzg = ops_aabbs.count_nonzero_groups(occ)
    wcap = -(-int(nzw * 1.1) // 8192) * 8192
    gcap = -(-int(nzg * 1.1) // 8192) * 8192
    want = torch.from_numpy(numpy_aabbs(occ_np, grid.origin,
                                        grid.voxel_size))
    exact = grid.get_aabbs()
    fixed, count = grid.get_aabbs_fixed(capacity=1 << 20, word_capacity=wcap,
                                        group_capacity=gcap)
    log(f"AABB extraction: {n_occ} occupied cells, count {int(count)}, "
        f"{nzw} nonzero words (word_capacity {wcap}), {nzg} nonzero groups "
        f"(group_capacity {gcap})")
    require(int(count) == n_occ == exact.shape[0],
            "extraction count differs from the occupied cells")
    require(torch.equal(exact.cpu(), want), "get_aabbs rows differ from "
            "numpy's aabbs_from_linear of np.flatnonzero")
    require(torch.equal(fixed[:n_occ].cpu(), want),
            "get_aabbs_fixed rows differ from numpy's")
    require(not bool(fixed[n_occ:].any()), "get_aabbs_fixed: rows past "
            "count are not zero")
    fixed_ms = cuda_ms(lambda: grid.get_aabbs_fixed(
        capacity=1 << 20, word_capacity=wcap, group_capacity=gcap), 10)
    exact_ms = cuda_ms(grid.get_aabbs, 10)
    log(f"AABB extraction ms (CUDA events, mean of 10): get_aabbs_fixed "
        f"{fixed_ms:.4f} (compaction of the words, no host sync), get_aabbs "
        f"{exact_ms:.4f} (torch.nonzero over the unpacked occupancy, one "
        f"sync); {exact.shape[0] * 24} bytes of rows [{smi}]")
    return exact


def build_encodings(grid, v, f, vs, device, smi):
    """GridBool (K1), GridAabbStruct, GridVec and Octree from the mesh on
    the card, each with its build ms and memory_usage_bytes (the
    reference Benchmaker's build ms / bytes), held to GridBool."""
    import torch
    from voxelray_torch.models.grids import (GridAabbStruct, GridBool,
                                             GridVec)
    from voxelray_torch.models.octree import Octree
    occ = grid.occupancy()
    builds = {}
    for name, cls in (("bool", GridBool), ("aabbstruct", GridAabbStruct),
                      ("vec", GridVec), ("octree", Octree)):
        enc, ms = wall_ms(lambda: cls.from_mesh(v, f, vs, device=device))
        builds[name] = enc
        log(f"encoding {name}: build {ms:.1f} ms, memory_usage_bytes "
            f"{enc.memory_usage_bytes()} [{smi}]")
        require(torch.equal(enc.occupancy(), occ),
                f"{name}: occupancy differs from GridBool's")
    gs, gv, tree = builds["aabbstruct"], builds["vec"], builds["octree"]
    require(torch.equal(builds["bool"].words, grid.words),
            "GridBool rebuilt with other words")
    require(torch.equal(gs.get_aabbs(), grid.get_aabbs()),
            "GridAabbStruct AABBs differ from GridBool's")
    require(gv.aabbs.shape[0] == gv.set_calls == tree.n_items
            == tree.set_calls == grid.set_calls,
            f"item counts {gv.aabbs.shape[0]} / {tree.n_items} differ from "
            f"K1's set_calls {grid.set_calls}")
    require((tree.bits_per_axis, tree.map_bits) == (9, 8),
            f"octree bits {tree.bits_per_axis}, map_bits {tree.map_bits}")
    log(f"octree: {tree.n_items} items, {tree.n_nodes} nodes, bits "
        f"{tree.bits_per_axis}, map_bits {tree.map_bits}; GridVec "
        f"{gv.aabbs.shape[0]} boxes; GridAabbStruct {gs.used.shape[0]} "
        "cells")
    return gv, tree


def octree_frame(tree, gv, mats, o, d, occ_np, device, smi):
    """The gate-3 scene (occupancy from the tree, GridVec's list, the
    tree; voxelray_tpu/utils/gates.py:61-80): its primary trace on the
    bench camera's rays (the octree_walk kernel under the 512^3 tree's
    coarse region map) against the plain walk on the card, ray by ray,
    and against K2's on the same scene; frames with backend "octree" over
    the orbit cameras; no ray cut by max_outer in any of these traces (the
    counter octree.cut_rays).  Returns K2's (t, lin)."""
    import torch
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import octree_traverse
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.traverse_fast import trace_grid_fast
    from voxelray_torch.utils import trace
    oscene, build_ms = wall_ms(lambda: build_scene(
        grid=tree, aabbs=gv.get_aabbs(), octree=tree, device=device))
    log(f"octree scene: build_scene {build_ms:.1f} ms, {oscene.n_voxels} "
        "boxes")
    t_k, lin_k = trace_grid_fast(o, d, oscene.accel)
    cut = trace.counters().get("octree.cut_rays", 0)
    # recording stays on over every octree trace of the phase (the primary
    # trace, every frame's primary and shadow traces, the profiled frames)
    # so that octree.cut_rays counts them all; the frames' times and the
    # profiled launches then include the counters' adds
    trace.enable()
    try:
        (t_o, lin_o, steps), trace_ms = wall_ms(
            lambda: octree_traverse.trace_octree(o, d, tree,
                                                 return_stats=True))
        steps = int(steps)
        (t_p, lin_p), plain_ms = wall_ms(lambda: plain_walk_cuda(
            o.reshape(-1, 3), d.reshape(-1, 3), TMIN, TMAX, tree)[0])
        apart = int(((t_o.reshape(-1) != t_p) | (lin_o.reshape(-1) != lin_p))
                    .sum())
        log(f"octree primary trace ({o.shape[0]} rays): {trace_ms:.1f} ms "
            f"(the plain walk {plain_ms:.1f} ms), the most regions of a ray "
            f"{steps}, {apart} rays apart from the plain walk [{smi}]")
        require(apart == 0, f"octree_walk at 512^3: {apart} rays apart "
                "from the plain walk")
        compare_traces("octree primary vs K2", o, d, occ_np, tree.origin,
                       tree.voxel_size, t_o, lin_o, t_k, lin_k)
        log_frames("octree (backend octree)",
                   time_frames(oscene, mats, backend="octree"), smi)
        from scripts.torch_frame_profile import profile_frame
        from voxelray_torch.render import pipeline
        for shadows in (True, False):
            prof = profile_frame(lambda: pipeline.render_image(
                oscene, *mats[0], width=WIDTH, height=HEIGHT,
                backend="octree", shadows=shadows), ())
            log(f"octree frame shadows={shadows} under torch.profiler: "
                f"wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms, idle share "
                f"{prof['device_idle_share']:.3f}, "
                f"{prof['device_launches']} device launches [{smi}]")
        torch.cuda.synchronize(device)
        cut = trace.counters().get("octree.cut_rays", 0) - cut
    finally:
        trace.disable()
    log(f"octree: rays cut by max_outer over every octree trace {cut}")
    require(cut == 0, "octree rays cut by max_outer")
    return t_k, lin_k


def brute_check(boxes, o, d, t_k, lin_k, occ_lin, device, smi):
    """The brute AABB trace on N_BRUTE sampled bench rays over the
    extracted boxes against K2: hit mask and cell equal, t within rtol
    2e-6."""
    import numpy as np
    import torch
    from voxelray_torch.ops.traverse import trace_aabbs_brute
    n = o.shape[0]
    rng = np.random.default_rng(1)
    hit_idx = torch.nonzero(torch.isfinite(t_k)).squeeze(1).cpu().numpy()
    idx = np.concatenate([rng.choice(hit_idx, N_BRUTE // 2, replace=False),
                          rng.choice(n, N_BRUTE // 2, replace=False)])
    idx_t = torch.as_tensor(idx, device=device)
    (tb, pid), ms = wall_ms(lambda: trace_aabbs_brute(o[idx_t], d[idx_t],
                                                      boxes))
    tk, lk = t_k[idx_t], lin_k[idx_t]
    hb, hk = torch.isfinite(tb), torch.isfinite(tk)
    cell = torch.where(hb, occ_lin[torch.clamp(pid, min=0).long()], -1)
    t_err = float(((tb[hb] - tk[hb]).abs() / tk[hb].abs()).max()) \
        if bool(hb.any()) else 0.0
    log(f"AABB brute check ({N_BRUTE} rays x {boxes.shape[0]} boxes): "
        f"{ms:.1f} ms, hits brute {int(hb.sum())} K2 {int(hk.sum())}, same "
        f"cell {int((cell == lk.long())[hb].sum())}, max rel t err {t_err} "
        f"[{smi}]")
    require(bool((hb == hk).all()), "brute AABB and K2 hit masks differ")
    require(bool((cell[hb] == lk[hb].long()).all()),
            "brute AABB and K2 cells differ")
    require(t_err <= 2e-6, "brute AABB t outside rtol 2e-6 of K2's")


def check_roundtrip(grid, tree, device):
    """save_grid / load_grid of the GridBool and the octree: every field
    equal."""
    import tempfile
    import torch
    from voxelray_torch.utils.checkpoint import load_grid, save_grid
    with tempfile.TemporaryDirectory() as tmp:
        for name, g in (("grid", grid), ("octree", tree)):
            path = os.path.join(tmp, f"{name}.npz")
            save_grid(path, g)
            back = load_grid(path, device=device)
            for k, a in vars(g).items():
                b = getattr(back, k)
                same = (torch.equal(a, b) if torch.is_tensor(a)
                        else bool((a == b).all()) if hasattr(a, "all")
                        else a == b)
                require(same, f"{name} round trip: field {k} differs")
            log(f"save_grid / load_grid {name}: {os.path.getsize(path)} "
                "bytes, every field equal")


def run_encodings(grid, v, f, vs, mats, o, d, occ_np, device):
    """Phase 8: AABB extraction, the four encodings (K1 voxelizes), the
    octree frame against K2's trace, counted as one path; then the brute
    AABB trace and the checkpoints."""
    import torch
    from voxelray_torch.ops.kernels import mega_trace, voxel_accum
    smi = smi_line()
    reset(voxel_accum, mega_trace)
    torch.cuda.synchronize()
    boxes = check_extraction(grid, occ_np, smi)
    gv, tree = build_encodings(grid, v, f, vs, device, smi)
    t_k, lin_k = octree_frame(tree, gv, mats, o, d, occ_np, device, smi)
    torch.cuda.synchronize()
    counts = counts_of(voxel_accum, mega_trace)
    log(f"encodings path launches: {counts}")
    require(counts["voxel_accum"] > 0, "phase 8: K1 was not launched")
    require(counts["mega_trace"] > 0, "phase 8: K2 was not launched")
    occ_lin = torch.nonzero(grid.occupancy().reshape(-1)).squeeze(1)
    brute_check(boxes, o, d, t_k, lin_k, occ_lin, device, smi)
    check_roundtrip(grid, tree, device)


def cli_main(args):
    """voxelray_torch.cli.main(args) in this process: (rc, wall ms)."""
    from voxelray_torch import cli
    return wall_ms(lambda: cli.main(args))


def check_cli(v, f, kmods, device, tmp, smi):
    """The CLI at full size: the knot voxelized to 512^3 with the ground
    plane, one 1920x1080 frame with shadows through the default backend
    (fast), counted; its image against render_scene on a scene built
    directly from the same grid and plane; then --mode raster and the
    octree AOV on bunny at 2.8/256, 1280x720."""
    import numpy as np
    import torch
    from voxelray_torch import cli
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.render import raster
    from voxelray_torch.render.camera import Camera
    from voxelray_torch.render.pipeline import render_scene
    dev = ["--device", str(device)]
    out = os.path.join(tmp, "cli.npy")
    reset(*kmods)
    rc, ms = cli_main([CLI_MESH, str(CLI_VS), "--width", str(WIDTH),
                       "--height", str(HEIGHT), "--out", out] + dev)
    counts = counts_of(*kmods)
    log(f"CLI {CLI_MESH} {CLI_VS} {WIDTH}x{HEIGHT} (voxelize, scene with the "
        f"plane, one frame, shadows): rc {rc}, {ms:.1f} ms wall, launches "
        f"{counts}")
    require(rc == 0, "the CLI failed")
    require(counts["voxel_accum"] >= 1, "CLI: K1 was not launched")
    require(counts["mega_trace"] >= 2, "CLI: K2 was not launched twice")
    scene = build_scene(models=[cli._ground_plane()],
                        grid=GridBool.from_mesh(v, f, CLI_VS, device=device),
                        device=device)
    route = ("the triangle accel" if scene.tri_accel is not None else
             "the brute triangle trace (no accel under 256 triangles)")
    log(f"CLI scene: {scene.n_triangles} plane triangles through {route}, "
        f"tri_march launches {counts['tri_march']}")
    ref = render_scene(scene, Camera(), width=WIDTH, height=HEIGHT,
                       backend="fast", shadows=True).cpu().numpy()
    img = np.load(out)
    require(img.shape == (HEIGHT, WIDTH, 4), f"CLI image {img.shape}")
    require(np.array_equal(img, ref), "the CLI frame differs from "
            "render_scene on the same grid and plane")
    frame_ms = cuda_ms(lambda: render_scene(
        scene, Camera(), width=WIDTH, height=HEIGHT, backend="fast",
        shadows=True), 5)
    log(f"CLI frame: bit-equal to render_scene; {frame_ms:.3f} ms a frame, "
        f"{WIDTH * HEIGHT / frame_ms / 1e3:.2f} Mrays/s (mean of 5) [{smi}]")

    small = ["--width", str(SMALL_W), "--height", str(SMALL_H)] + dev
    out = os.path.join(tmp, "raster.npy")
    rc, ms = cli_main(["bunny", str(BUNNY_VS), "--mode", "raster", "--out",
                       out] + small)
    img = np.load(out)
    require(rc == 0 and img.shape == (SMALL_H, SMALL_W, 4), "CLI raster")
    require(bool(np.isfinite(img).all()), "CLI raster: non-finite pixels")
    bg = np.float32(1.0)
    covered = int((img[..., :3] != bg).any(-1).sum())
    require(covered > 0, "CLI raster drew nothing")
    pscene = build_scene(models=[cli._ground_plane()], device=device)
    r_ms = cuda_ms(lambda: raster.rasterize_scene(
        pscene, Camera(), width=SMALL_W, height=SMALL_H), 5)
    log(f"CLI raster bunny {SMALL_W}x{SMALL_H}: rc {rc}, {ms:.1f} ms wall, "
        f"{covered} covered pixels; rasterize_scene {r_ms:.3f} ms (mean of "
        f"5) [{smi}]")
    out = os.path.join(tmp, "aov.npy")
    rc, ms = cli_main(["bunny", str(BUNNY_VS), "--encoding", "octree",
                       "--backend", "octree", "--aov", "--out", out] + small)
    aov = np.load(out)
    hit = np.isfinite(aov[..., 0])
    norm = np.linalg.norm(aov[hit][:, 1:], axis=-1)
    log(f"CLI octree AOV bunny {SMALL_W}x{SMALL_H}: rc {rc}, {ms:.1f} ms "
        f"wall, {int(hit.sum())} hit pixels, |normal| in "
        f"[{norm.min() if hit.any() else 0}, "
        f"{norm.max() if hit.any() else 0}] [{smi}]")
    require(rc == 0 and aov.shape == (SMALL_H, SMALL_W, 4), "CLI AOV")
    require(hit.any() and np.allclose(norm, 1.0, atol=1e-5),
            "CLI AOV: no hits or normals not unit")
    torch.cuda.synchronize()


def check_gates(device, smi):
    """Gates 1-5 at scale 1 on the card, each timed (wall)."""
    import numpy as np
    from voxelray_torch.io import meshes
    from voxelray_torch.native import voxelize_native
    from voxelray_torch.utils.gates import run_gate
    res = {}
    for name in ("cube64", "bunny128", "vec256", "knot512", "deform8"):
        res[name], ms = wall_ms(lambda: run_gate(name, scale=GATE_SCALE,
                                                 device=device))
        shown = {k: x for k, x in res[name].items() if k != "occupancy"}
        log(f"gate {name} (scale {GATE_SCALE}): {ms:.1f} ms wall, {shown} "
            f"[{smi}]")
    g = res["cube64"]
    require(g["bit_exact"] and g["set_calls_match"], "gate 1 not bit-exact")
    require(res["bunny128"]["hit_fraction"] > 0.01, "gate 2 hit fraction")
    g = res["vec256"]
    require(g["backend"] == "octree" and g["normals_unit"], "gate 3")
    g = res["knot512"]
    require(g["frames"] == 8 and all(np.isfinite(g["frame_means"])),
            "gate 4 frames")
    g = res["deform8"]
    require(g["devices"] == 1 and g["frames"] == 8, "gate 5 frames")
    v, f = meshes.make_scene_mesh("bunny")
    occ = g["occupancy"].cpu().numpy()
    for i in (0, 7):
        want, calls = voxelize_native(meshes.deformed(v, 2 * np.pi * i / 8),
                                      f, g["voxel_size"], g["origin"],
                                      g["dims"])
        require(np.array_equal(occ[i], want)
                and g["set_calls_per_frame"][i] == calls,
                f"gate 5 frame {i} differs from voxelize_native")
    require(not np.array_equal(occ[0], occ[7]), "gate 5: frames 0 and 7 "
            "are equal")
    log("gate 5: frames 0 and 7 bit-equal to voxelize_native, and differ")


def check_k1_native(grid, v, f, vs, occ_np, k1_ms, smi):
    """K1's 512^3 grid against the serial C++ voxelizer."""
    import numpy as np
    from voxelray_torch.native import load_library, voxelize_native
    load_library()
    (occ_n, calls_n), ms = wall_ms(lambda: voxelize_native(
        v, f, vs, grid.origin, grid.dims))
    log(f"voxelize_native {len(f)} triangles to {grid.dims}: {ms:.1f} ms "
        f"(one host thread), K1 {k1_ms:.4f} ms; occupied "
        f"{int(occ_n.sum())}, set_calls {calls_n} [{smi}]")
    require(np.array_equal(occ_n.astype(bool), occ_np),
            "K1 occupancy differs from voxelize_native")
    require(calls_n == grid.set_calls, "K1 set_calls differ from "
            "voxelize_native")


def check_aov_parity(scene, cam, occ_np, grid, device, smi):
    """render_aov fast against dda on the voxel frame: hit masks equal,
    depth within rtol 2e-6, every differing ray adjudicated (at most
    MAX_DIFF_RAYS), normals unit."""
    import numpy as np
    import torch
    from voxelray_torch.ops.intersect import make_camera_rays
    from voxelray_torch.ops.traverse import trace_grid_dda
    from voxelray_torch.ops.traverse_fast import trace_grid_fast
    from voxelray_torch.render.pipeline import render_aov
    (df, nf, hf), f_ms = wall_ms(lambda: render_aov(
        scene, cam, width=WIDTH, height=HEIGHT, backend="fast"))
    (dd, nd, hd), d_ms = wall_ms(lambda: render_aov(
        scene, cam, width=WIDTH, height=HEIGHT, backend="dda"))
    require(bool(torch.equal(hf, hd)), "AOV hit masks differ, fast vs dda")
    far = hf & ~torch.isclose(df, dd, rtol=2e-6, atol=0.0)
    unit = (torch.linalg.norm(nf[hf], dim=-1) - 1).abs().max()
    log(f"AOV {WIDTH}x{HEIGHT} fast {f_ms:.1f} ms, dda {d_ms:.1f} ms: "
        f"{int(hf.sum())} hit pixels, {int(far.sum())} with depth outside "
        f"rtol 2e-6, max ||normal| - 1| {float(unit)} [{smi}]")
    require(float(unit) <= 1e-5, "AOV normals not unit")
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=device)
    o, d = o[far].contiguous(), d[far].contiguous()
    t_f, lin_f = trace_grid_fast(o, d, scene.accel)
    t_d, lin_d = trace_grid_dda(o, d, scene.occ_flat, scene.grid_origin,
                                dims=scene.grid_dims,
                                voxel_size=scene.grid_voxel_size)
    n_diff, _ = compare_traces("AOV fast vs dda, pixels apart", o, d,
                               occ_np, grid.origin, grid.voxel_size, t_f,
                               lin_f, t_d, lin_d)
    require(n_diff == int(far.sum()), "AOV: a depth apart with equal cells")


def run_frontend(grid, v, f, vs, scene, cam, occ_np, k1_ms, kmods,
                 device):
    """Phase 9: the front end.  The CLI at full size, gates 1-5 at scale
    1, K1's 512^3 grid against the serial C++ voxelizer, and the bench's
    AOV parity of fast against dda on the voxel frame."""
    import tempfile
    smi = smi_line()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        check_cli(v, f, kmods, device, tmp, smi)
    check_gates(device, smi)
    check_k1_native(grid, v, f, vs, occ_np, k1_ms, smi)
    check_aov_parity(scene, cam, occ_np, grid, device, smi)
    log(f"phase 9 (front end): {time.time() - t0:.1f} s")


def wall_mean_ms(fn, reps):
    """Mean wall ms of fn() over reps calls, the device synced, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def frames_close(what, img, ref):
    """Frames with equal hit masks and within rtol 2e-6 / atol 1e-7:
    returns the largest difference."""
    import numpy as np
    import torch
    miss = float(np.float32(0.8) ** np.float32(1 / 2.2))
    hit, hit_r = ((x[..., :3] != miss).any(-1) for x in (img, ref))
    err = float((img - ref).abs().max())
    log(f"{what}: {int(hit.sum())} hit pixels, max |difference| {err}")
    require(bool(torch.equal(hit, hit_r)), f"{what}: hit masks differ")
    require(bool(torch.allclose(img, ref, rtol=RTOL, atol=ATOL)),
            f"{what}: outside rtol {RTOL} / atol {ATOL}")
    return err


def check_voxelize_sharded(v, f, bb_min, vs, dims, meshes_, k1_ms, smi):
    """voxelize_sharded of the knot less one triangle (1,048,575: the
    sentinel pad runs) on each mesh, counted, against K1 alone on the
    same triangles; a shard of sentinel triangles adds nothing."""
    import numpy as np
    import torch
    from voxelray_torch.ops.kernels import voxel_accum
    from voxelray_torch.parallel.comm import voxelize_sharded
    dev = meshes_[0][1].devices[0]
    f_odd = f[:-1]
    occ_k, calls_k = voxel_accum.voxel_accum_cuda(
        torch.as_tensor(v, device=dev),
        torch.as_tensor(f_odd.astype(np.int32), device=dev), bb_min, vs,
        dims)
    pad = torch.full((96, 3), float("inf"), device=dev)
    occ0, calls0 = voxel_accum.voxel_accum_cuda(
        pad, torch.arange(96, dtype=torch.int32, device=dev).reshape(-1, 3),
        bb_min, vs, dims)
    require(calls0 == 0 and not bool(occ0.any()),
            "K1: sentinel triangles added occupancy or set_calls")
    tri = v[f_odd]
    for name, mesh in meshes_:
        reset(voxel_accum)
        torch.cuda.synchronize()
        occ, calls = voxelize_sharded(tri, bb_min, mesh, dims=dims,
                                      voxel_size=vs)
        torch.cuda.synchronize()
        launches = launched(voxel_accum)
        require(launches == mesh.size, f"voxelize_sharded on {name}: "
                f"{launches} K1 launches for {mesh.size} shards")
        require(bool(torch.equal(occ, occ_k)) and int(calls) == calls_k,
                f"voxelize_sharded on {name} differs from K1 alone")
        ms = wall_mean_ms(lambda: voxelize_sharded(
            tri, bb_min, mesh, dims=dims, voxel_size=vs), 3)
        log(f"voxelize_sharded, {name}: {len(tri)} triangles in "
            f"{mesh.size} shards, K1 launches {launches}, occupancy and "
            f"set_calls ({calls_k}) bit-equal to K1 alone; {ms:.2f} ms wall "
            f"(mean of 3: host padding, copies and kernels), K1 kernel "
            f"alone {k1_ms:.4f} ms [{smi}]")


def check_render_sharded(scene, vi, pi, ref, meshes_, smi):
    """render_sharded (backend fast, shadows on) on each mesh, counted,
    against render_image's frame `ref`."""
    import torch
    from voxelray_torch.ops.kernels import mega_trace
    from voxelray_torch.parallel.comm import render_sharded
    from voxelray_torch.render import pipeline
    kw = dict(width=WIDTH, height=HEIGHT, backend="fast", shadows=True)
    ref_ms = cuda_ms(lambda: pipeline.render_image(scene, vi, pi, **kw), 3)
    for name, mesh in meshes_:
        reset(mega_trace)
        torch.cuda.synchronize()
        img = render_sharded(scene, vi, pi, mesh, **kw)
        torch.cuda.synchronize()
        launches = launched(mega_trace)
        require(launches > 0, f"render_sharded on {name}: K2 not launched")
        frames_close(f"render_sharded, {name}, vs render_image", img, ref)
        ms = cuda_ms(lambda: render_sharded(scene, vi, pi, mesh, **kw), 3)
        rows = -(-HEIGHT // mesh.size)
        log(f"render_sharded, {name}: {mesh.size} shards of {rows} rows "
            f"({'tiled' if rows % 8 == 0 else 'not tiled'}), K2 launches "
            f"{launches}; {ms:.3f} ms a frame, render_image {ref_ms:.3f} ms "
            f"(mean of 3) [{smi}]")


def check_zslab_fast(scene, grid, vi, pi, rays, k2_trace, img_k2, occ_np,
                     rehearsal, real, kmods, smi):
    """render_zslab_sharded, backend fast, with the grid in 4 slabs of 128
    rows on the rehearsal mesh: per slab its build ms, fine-window bytes
    and staged-trace ms with its launches (one staged_march, no K3/K4);
    K3, K4 and staged_march held against their plain versions on a slab
    with a fine window; the slabs' traces queued with no host sync; the
    merged primary
    trace bit-equal to the monolithic staged walk's and held to K2's; the
    frame, counted, against render_image through the staged walk, and
    against K2's frame; then the one-slab frame on make_mesh().  Returns
    the Z-slab frame's launches."""
    import numpy as np
    import torch
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import brick_fine, grid_walk, staged_march
    from voxelray_torch.ops.traverse_fast import (build_accel_slab,
                                                  trace_grid_fast)
    from voxelray_torch.parallel.comm import (render_zslab_sharded,
                                              split_zslabs, zslab_rows)
    from voxelray_torch.render import pipeline
    o, d, tmn, tmx = rays
    nx, ny, nz = scene.grid_dims
    zs, split_ms = wall_ms(lambda: split_zslabs(scene, rehearsal, "fast"))
    log(f"Z-slab split of the {nx}x{ny}x{nz} grid over {rehearsal.size} "
        f"slabs of {zs.nzs} rows (on the host, then one slab a device): "
        f"{split_ms:.1f} ms [{smi}]")
    require(zs.nzs == 128, f"slab height {zs.nzs}")
    occ3 = scene.occ_flat.reshape(nz, ny, nx)
    for i, sl in enumerate(zs.slabs):
        z0, z1 = i * zs.nzs, (i + 1) * zs.nzs
        again, b_ms = wall_ms(lambda: build_accel_slab(
            zslab_rows(occ3, z0, z1), z0, nz, zs.origin, zs.voxel_size,
            below=zslab_rows(occ3, z0 - 8, z0) if z0 else None,
            above=zslab_rows(occ3, z1, z1 + 8) if z1 < nz else None))
        require(all(torch.equal(getattr(again, k), getattr(sl, k))
                    for k in ("coarse", "fine", "l2")),
                f"slab {i}: rebuilt with other tables")
        reset(staged_march, grid_walk, brick_fine)
        trace_grid_fast(o, d, sl)
        torch.cuda.synchronize()
        counts = counts_of(staged_march, grid_walk, brick_fine)
        require(counts == {"staged_march": 1, "grid_walk": 0,
                           "brick_fine": 0},
                f"slab {i}: the staged trace is not one staged_march launch")
        # the slab's staged_march bit-equal to the lap loop over K3/K4
        args = (o, d, sl, tmn, tmx, None, 5, None)
        got = staged_march.staged_march_cuda(*args)
        lap = staged_march.staged_march_plain(*args)
        require(int(got[2]) == lap[2] == 0
                and torch.equal(got[1], lap[1])
                and torch.equal(got[0].view(torch.int32),
                                lap[0].view(torch.int32)),
                f"slab {i}: staged_march differs from the lap loop or left "
                "rays unresolved")
        t_ms = cuda_ms(lambda: trace_grid_fast(o, d, sl), 3)
        log(f"slab {i} (rows {z0}-{z1 - 1}): build {b_ms:.2f} ms on the "
            f"card, fine window {sl.fine.shape[1]} bricks from brick "
            f"{sl.fine_off} ({sl.fine.numel() * 4} bytes), primary staged "
            f"trace {t_ms:.3f} ms (mean of 3), launches {counts}, "
            f"bit-equal to the lap loop, unresolved 0 [{smi}]")
    (hits, _, _), *_ = check_walk("Z-slab 1 round 1", o, d, tmn, tmx,
                                  zs.slabs[1], 5)
    check_fine("Z-slab 1 round 1", o, d, hits, tmn, tmx, zs.slabs[1])
    check_staged("Z-slab 1", o, d, tmn, tmx, None, zs.slabs[1], 5)
    # the slabs' traces queue one after another with no host sync between
    # them (on distinct cards they run at once)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        zs.per_slab(o, d, TMIN, TMAX)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"Z-slab per-slab traces ({rehearsal.size} slabs): no host sync "
        "(torch.cuda.set_sync_debug_mode(\"error\"))")
    t_s, lin_s = trace_grid_fast(o, d, scene.accel, mega=False)
    t_z, lin_z = zs.trace(o, d)
    require(bool(torch.equal(lin_z, lin_s)) and bool(torch.equal(t_z, t_s)),
            "the Z-slab merged trace differs from the monolithic staged "
            "walk")
    log(f"Z-slab merged primary trace: {int((lin_z >= 0).sum())} hits, "
        "cells and t bit-equal to the monolithic staged walk")
    compare_traces("Z-slab merged primary vs K2", o, d, occ_np, grid.origin,
                   grid.voxel_size, t_z, lin_z, *k2_trace)
    kw = dict(width=WIDTH, height=HEIGHT, shadows=True)
    staged = dict(fast_opts={"mega": False}, shadow_opts={"mega": False})
    reset(*kmods)
    torch.cuda.synchronize()
    img = render_zslab_sharded(scene, vi, pi, rehearsal, backend="fast",
                               **kw)
    torch.cuda.synchronize()
    counts = counts_of(*kmods)
    log(f"Z-slab frame (4 slabs, shadows on) launches: {counts}")
    require(counts["staged_march"] > 0, "the Z-slab frame did not launch "
            "staged_march")
    require(counts["grid_walk"] == 0 and counts["brick_fine"] == 0,
            "the Z-slab frame launched K3 or K4")
    ref = pipeline.render_image(scene, vi, pi, backend="fast", **staged,
                                **kw)
    frames_close("Z-slab frame vs render_image (staged walk)", img, ref)
    miss = float(np.float32(0.8) ** np.float32(1 / 2.2))
    close = float(((img - img_k2).abs() <= PIXEL_ATOL).all(-1).float()
                  .mean())
    same_hits = bool(torch.equal((img[..., :3] != miss).any(-1),
                                 (img_k2[..., :3] != miss).any(-1)))
    log(f"Z-slab frame vs K2's frame: hit masks equal {same_hits}, share "
        f"of pixels within {PIXEL_ATOL}: {close}")
    require(same_hits and close >= PIXEL_FRAC,
            "the Z-slab frame fails the gate against K2's frame")
    z_ms = wall_mean_ms(lambda: render_zslab_sharded(
        scene, vi, pi, rehearsal, backend="fast", **kw), 3)
    s_ms = wall_mean_ms(lambda: pipeline.render_image(
        scene, vi, pi, backend="fast", **staged, **kw), 3)
    img1 = render_zslab_sharded(scene, vi, pi, real, backend="fast", **kw)
    frames_close(f"Z-slab frame on make_mesh() ({real.size} slab) vs "
                 "render_image (staged walk)", img1, ref)
    log(f"Z-slab frame {WIDTH}x{HEIGHT}, shadows on: {z_ms:.2f} ms wall "
        f"(mean of 3, the split included), render_image through the staged "
        f"walk {s_ms:.2f} ms [{smi}]")
    return counts


def check_zslab_dda(device, rehearsal, smi):
    """The DDA Z-slab path at gate 2's size (bunny at 2.8/128,
    1280x720): the merged trace bit-equal to trace_grid_dda's, and the
    frame against render_image's dda frame."""
    import torch
    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops.intersect import make_camera_rays
    from voxelray_torch.ops.traverse import trace_grid_dda
    from voxelray_torch.parallel.comm import (render_zslab_sharded,
                                              split_zslabs)
    from voxelray_torch.render.camera import Camera
    from voxelray_torch.render.pipeline import render_image
    v, f = meshes.make_scene_mesh("bunny")
    scene = build_scene(grid=GridBool.from_mesh(v, f, BUNNY_DDA_VS,
                                                device=device),
                        device=device)
    _, _, vi, pi = Camera().matrices(SMALL_W, SMALL_H)
    o, d = (x.reshape(-1, 3) for x in make_camera_rays(
        SMALL_W, SMALL_H, vi, pi, device=device))
    zs = split_zslabs(scene, rehearsal, "dda")
    (t_z, lin_z), z_ms = wall_ms(lambda: zs.trace(o, d))
    (t_m, lin_m), m_ms = wall_ms(lambda: trace_grid_dda(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size=scene.grid_voxel_size))
    require(bool(torch.equal(lin_z, lin_m)) and bool(torch.equal(t_z, t_m)),
            "the DDA Z-slab merged trace differs from trace_grid_dda")
    kw = dict(width=SMALL_W, height=SMALL_H, backend="dda", shadows=True)
    img, f_ms = wall_ms(lambda: render_zslab_sharded(scene, vi, pi,
                                                     rehearsal, **kw))
    frames_close("DDA Z-slab frame vs render_image dda", img,
                 render_image(scene, vi, pi, **kw))
    log(f"DDA Z-slab, bunny {scene.grid_dims} in {zs.mesh.size} slabs of "
        f"{zs.nzs} rows, {SMALL_W}x{SMALL_H}: merged trace "
        f"({int((lin_z >= 0).sum())} hits) bit-equal to trace_grid_dda; "
        f"trace {z_ms:.1f} ms against {m_ms:.1f} ms, frame {f_ms:.1f} ms "
        f"wall [{smi}]")


def check_gate5_mesh(device, other, smi):
    """Gate 5 through its mesh (make_mesh(): every card), and its frames
    dealt over the mesh `other`: the same occupancy and set_calls."""
    import numpy as np
    import torch
    from voxelray_torch.io import meshes
    from voxelray_torch.parallel.comm import voxelize_frames_sharded
    from voxelray_torch.utils.gates import run_gate
    res, ms = wall_ms(lambda: run_gate("deform8", scale=GATE_SCALE,
                                       device=device))
    require(res["devices"] == torch.cuda.device_count(),
            f"gate 5 ran on {res['devices']} devices")
    v, f = meshes.make_scene_mesh("bunny")
    n = res["frames"]
    fv = np.stack([meshes.deformed(v, 2 * np.pi * i / n) for i in range(n)])
    occ, calls = voxelize_frames_sharded(fv, f, res["origin"], other,
                                         dims=res["dims"],
                                         voxel_size=res["voxel_size"])
    require(bool(torch.equal(occ, res["occupancy"]))
            and calls.tolist() == res["set_calls_per_frame"],
            "gate 5's frames over the other mesh differ")
    log(f"gate 5 through make_mesh() ({res['devices']} devices): {ms:.1f} "
        f"ms wall; its {n} frames over the mesh "
        f"{[str(x) for x in other.devices]}: bit-equal [{smi}]")


def run_multidevice(v, f, grid, scene, vi, pi, rays, k2_trace, img_k2,
                    occ_np, k1_ms, kmods, device):
    """Phase 10: the multi-device layer on a rehearsal mesh of 4 entries
    on the one card and on make_mesh().  Returns the Z-slab frame's
    launches."""
    import torch
    from voxelray_torch.parallel.comm import make_mesh
    smi = smi_line()
    t0 = time.time()
    rehearsal = make_mesh(devices=[device] * 4)
    real = make_mesh()
    require(real.size == torch.cuda.device_count(), "make_mesh() size")
    meshes_ = (("rehearsal mesh of 4 on one card", rehearsal),
               (f"make_mesh() ({real.size} card)", real))
    check_voxelize_sharded(v, f, grid.origin, grid.voxel_size, grid.dims,
                           meshes_, k1_ms, smi)
    check_render_sharded(scene, vi, pi, img_k2, meshes_, smi)
    counts = check_zslab_fast(scene, grid, vi, pi, rays, k2_trace, img_k2,
                              occ_np, rehearsal, real, kmods, smi)
    check_zslab_dda(device, rehearsal, smi)
    check_gate5_mesh(device, rehearsal, smi)
    log(f"phase 10 (multi-device layer): {time.time() - t0:.1f} s")
    return counts


def host_syncs(fn, device):
    """The host syncs fn() makes on the card, as file:line of the calls
    that synced (torch.cuda.set_sync_debug_mode("warn")); a known sync is
    counted first to show that the warnings arrive."""
    import warnings
    import torch

    def sites():
        return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
                if "called a synchronizing" in str(w.message)]

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            int(torch.ones(1, device=device).sum())
            require(len(sites()) == 1, "sync debug mode: a known sync was "
                    "not reported")
            del rec[:]
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sites()


def check_planned(v, f, grid, device, smi):
    """voxelize_planned on the knot against phase 1's voxelize_mesh, then
    a deforming knot: a deform_safe plan from frame 0 of an 8-frame
    animation with the animation's bbox (as gate 5 takes it), frames 0-3
    queued through it under torch.cuda.set_sync_debug_mode("error"), each
    bit-equal to voxelize_mesh with that bbox and frame 1 to
    voxelize_plain.  Returns K1's launches in the planned calls."""
    import numpy as np
    import torch
    from voxelray_torch.io import meshes
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.kernels import voxel_accum
    from voxelray_torch.ops.voxelize import (plan_voxelize, voxelize_mesh,
                                             voxelize_plain,
                                             voxelize_planned)
    vs = grid.voxel_size
    plan, plan_ms = wall_ms(lambda: plan_voxelize(
        v, f, vs, bb_min=grid.origin, bb_max=geometry.mesh_bbox(v)[1],
        device=device))
    v_t = torch.as_tensor(v, device=device)
    reset(voxel_accum)
    occ, calls = voxelize_planned(plan, v_t)
    torch.cuda.synchronize()
    launches = launched(voxel_accum)
    require(plan.dims == grid.dims and launches == 1, "planned voxelize: "
            f"dims {plan.dims}, {launches} K1 launches")
    require(torch.equal(occ, grid.occupancy())
            and int(calls) == grid.set_calls, "voxelize_planned differs "
            "from phase 1's voxelize_mesh")
    log(f"voxelize_planned, knot at {plan.dims}: plan {plan_ms:.1f} ms on "
        f"the host ({len(plan.buckets)} buckets), occupancy and set_calls "
        f"({int(calls)}) bit-equal to phase 1's voxelize_mesh [{smi}]")

    n_anim = 8
    fv = np.stack([meshes.deformed(v, 2 * np.pi * i / n_anim)
                   for i in range(n_anim)])
    dmin, dmax = geometry.mesh_bbox(fv.reshape(-1, 3))
    dplan = plan_voxelize(fv[0], f, vs, bb_min=dmin, bb_max=dmax,
                          deform_safe=True, device=device)
    frames = [torch.as_tensor(x, device=device) for x in fv[:4]]
    torch.cuda.synchronize()
    reset(voxel_accum)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        outs = [voxelize_planned(dplan, x) for x in frames]
        queued_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    require(launched(voxel_accum) == len(frames),
            f"deformed frames: {launched(voxel_accum)} K1 launches")
    launches += launched(voxel_accum)
    for i, (occ_i, calls_i) in enumerate(outs):
        ref = voxelize_mesh(fv[i], f, vs, bb_min=dmin, bb_max=dmax,
                            device=device)
        require(torch.equal(occ_i, ref["occ"])
                and int(calls_i) == ref["set_calls"],
                f"deformed frame {i}: voxelize_planned differs from "
                "voxelize_mesh")
    occ_p, calls_p = voxelize_plain(frames[1], dplan.faces, dplan.origin, vs,
                                    dplan.dims)
    require(torch.equal(outs[1][0], occ_p) and int(outs[1][1]) == calls_p,
            "deformed frame 1: voxelize_planned differs from voxelize_plain")
    require(not torch.equal(outs[0][0], outs[2][0]),
            "deformed frames 0 and 2 are equal")
    log(f"deforming knot, {dplan.dims}, deform_safe plan "
        f"({len(dplan.buckets)} buckets): frames 0-3 queued with no host "
        f"sync (sync debug mode error) in {queued_ms:.2f} ms of host time, "
        f"{frame_ms:.3f} ms a frame synced once; each bit-equal to "
        f"voxelize_mesh with the animation's bbox, frame 1 to "
        f"voxelize_plain; set_calls {[int(c) for _, c in outs]} [{smi}]")
    return launches


def run_bench(v, f, grid, scene, vi, pi, kmods, device):
    """Phase 11: the port's bench (voxelray_torch.bench.run) at the full
    preset in this process, counted; the planned voxelize
    (check_planned); the host syncs of one voxel frame.  Returns K1's
    launches in the bench and the planned calls."""
    import torch
    from voxelray_torch import bench
    from voxelray_torch.render import pipeline
    smi = smi_line()
    t0 = time.time()
    reset(*kmods)
    torch.cuda.synchronize()
    res = bench.run(device, preset="full", runs=3, backend="fast",
                    mega=True, skip_parity=False)
    torch.cuda.synchronize()
    counts = counts_of(*kmods)
    log(f"bench line (voxelray_torch.bench.run, preset full, runs 3): "
        f"{json.dumps(res)}")
    log(f"bench launches: {counts} [{smi}]")
    require(res["parity_ok"] is True, "bench: a gate failed")
    require(res["parity"]["unresolved"] == 0, "bench: unresolved rays")
    require(counts["voxel_accum"] > 0, "bench: K1 was not launched")
    require(counts["mega_trace"] > 0, "bench: K2 was not launched")
    planned = check_planned(v, f, grid, device, smi)
    for shadows in (True, False):
        sites = host_syncs(lambda: pipeline.render_image(
            scene, vi, pi, width=WIDTH, height=HEIGHT, backend="fast",
            shadows=shadows), device)
        log(f"host syncs in one {WIDTH}x{HEIGHT} voxel frame (K2), shadows="
            f"{shadows}: {len(sites)} {sites}")
        require(not sites, "a voxel frame on the card made a host sync")
    log(f"phase 11 (bench, planned voxelize): {time.time() - t0:.1f} s")
    return counts["voxel_accum"] + planned


def check_frame_glue(what, scene, vi, pi, device):
    """Phase 12: the frame glue's kernels on the scene's WIDTHxHEIGHT frame
    with shadows (fast backend, render_image's light and clear colour),
    each held against the plain stage it replaced on the same inputs on
    the card: camera_rays against make_camera_rays + _tile_rays and
    hit_surface's shadow query and record against surface_terms, bit for
    bit; shade_post's framebuffer against the plain shade stage, untiling
    and gamma_post within 2 ulp (pow).  render_image's frame must be
    shade_post's.  Each kernel is timed alone (queued_ms) beside its plain
    stage (one call, its syncs included) and its wrapper's host time.
    Returns {kernel: (ms, plain_ms, nbytes, err, host_us)}, nbytes each
    ray's inputs and outputs once as the kernel reads and writes them."""
    import torch
    from voxelray_torch.models.scene import Light
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import frame_shade
    from voxelray_torch.render import pipeline, shading
    backend, light, clear = "fast", Light(), (1.0, 1.0, 1.0, 1.0)
    tiled = pipeline._tiles(backend, HEIGHT, WIDTH)
    n = WIDTH * HEIGHT
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731

    def rays():
        return frame_shade.camera_rays_cuda(WIDTH, HEIGHT, vi, pi, tiled,
                                            device)

    def plain_rays():
        po, pd = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=device)
        if tiled:
            po = pipeline._tile_rays(po, HEIGHT, WIDTH)
            pd = pipeline._tile_rays(pd, HEIGHT, WIDTH)
        return po.reshape(-1, 3), pd.reshape(-1, 3)

    o, d = rays()
    po, pd = plain_rays()
    require(torch.equal(bits(o), bits(po)) and torch.equal(bits(d), bits(pd)),
            f"{what}: camera_rays differs from make_camera_rays + tiling")
    tri = (pipeline._trace_triangles(scene, o, d, TMIN, TMAX)
           if scene.n_triangles else None)
    t_vox, vox_id = pipeline._trace_voxels(scene, o, d, TMIN, TMAX, backend)
    tables = pipeline._surface_tables(scene, backend)

    def surface():
        return frame_shade.hit_surface_cuda(o, d, t_vox, vox_id, tri, tables,
                                            light.position, light.intensity,
                                            light.type)

    def plain_surface():
        return pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                                      backend)

    q, s = surface(), plain_surface()
    hit = s.hit
    flags = q.rec.view(torch.int32)[:, 3]
    require(all(torch.equal(bits(a), bits(b)) for a, b in (
        (q.world_pos, s.world_pos), (q.l_vec, s.l_vec),
        (q.light_dist, s.light_dist))) and torch.equal(q.admit,
                                                       hit & s.facing),
        f"{what}: hit_surface's shadow query differs from surface_terms'")
    require(torch.equal((flags & 1) != 0, hit)
            and torch.equal((flags & 2) != 0, s.vox_hit)
            and torch.equal((flags[hit] & 4) != 0, s.facing[hit])
            and torch.equal(bits(q.rec[hit, 0:3]), bits(s.normal[hit]))
            and torch.equal(bits(q.rec[hit, 4:7]), bits(s.diffuse[hit]))
            and torch.equal(bits(q.rec[hit, 7]), bits(s.intensity[hit])),
            f"{what}: hit_surface's record differs from surface_terms'")
    occ = pipeline._occlusion(scene, q.world_pos, q.l_vec, q.light_dist,
                              q.admit, backend, None, None, None)
    frame = (HEIGHT, WIDTH, tiled)

    def shade():
        return frame_shade.shade_post_cuda(q, d, occ, scene.materials,
                                           scene.voxel_material, clear,
                                           frame)

    def plain_shade():
        shadowed = torch.where(s.facing, occ, torch.ones_like(occ))
        rgb = pipeline._shade(s, d, shadowed, clear)
        rgb = (pipeline._untile_rays(rgb, HEIGHT, WIDTH) if tiled
               else rgb.reshape(HEIGHT, WIDTH, 3))
        rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        return shading.gamma_post(rgba)

    img, ref = shade(), plain_shade()
    ulps = int((bits(img).long() - bits(ref).long()).abs().max())
    err = float((img - ref).abs().max())
    log(f"{what}: camera rays and the shadow query bit-equal to the plain "
        f"glue; framebuffer {ulps} ulp apart at most (|err| {err})")
    require(ulps <= 2, f"{what}: shade_post's frame is {ulps} ulp from the "
            "plain stage's")
    full = pipeline.render_image(scene, vi, pi, width=WIDTH, height=HEIGHT,
                                 backend=backend, shadows=True)
    require(torch.equal(bits(full), bits(img)),
            f"{what}: render_image's frame is not the kernels'")

    n_hit = int(hit.sum())
    # specular reads d and l_vec only where lit by a specular material
    illum = s.mat[..., 18] >= 2.0
    spec = int((hit & s.facing & ~occ & illum).sum())
    tri_bytes = 0
    if tri is not None:
        ids = torch.unique(tri[1][hit & ~s.vox_hit]).numel()
        # t, id, u, v of every ray; each hit triangle's three normals and
        # its material and texture ids
        tri_bytes = 16 * n + ids * (36 + 8)
    nbytes = {
        # origins and dirs written
        "camera_rays": 24 * n,
        # o, d, t_vox in, vox_id of the voxel hits; world_pos, l_vec,
        # light_dist, admit and the 32-byte record out
        "hit_surface": 28 * n + 4 * int(s.vox_hit.sum()) + tri_bytes
        + 61 * n,
        # the record's first half and the RGBA out for every ray; its
        # second half and the occlusion byte of a hit
        "shade_post": 32 * n + 17 * n_hit + 24 * spec,
    }
    out = {}
    for name, fn, plain in (("camera_rays", rays, plain_rays),
                            ("hit_surface", surface, plain_surface),
                            ("shade_post", shade, plain_shade)):
        out[name] = (queued_ms(fn, FRAME_REPS), cuda_ms(plain, 1),
                     nbytes[name], err if name == "shade_post" else 0.0,
                     host_us(fn, FRAME_REPS))
        log(f"{what} {name}: kernel {out[name][0]:.4f} ms, plain stage "
            f"{out[name][1]:.4f} ms, {nbytes[name] / 1e6:.1f} MB, wrapper "
            f"{out[name][4]:.1f} us host a call")
    return out


def device_kernels(fn):
    """The names of the kernels fn() runs on the card, one a launch
    (torch.profiler; copies and fills left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memset", "Memcpy"))]


def run_tri_deform(device):
    """Phase 13 (module docstring): returns tri_bin's kernel row."""
    import numpy as np
    import torch

    from voxelray_torch.io import meshes
    from voxelray_torch.ops import tri_accel
    from voxelray_torch.ops.kernels import _build, tri_bin
    from voxelray_torch.ops.tri_accel import (build_tri_accel_planned,
                                              plan_tri_accel)
    from voxelray_torch.ops.voxelize import window_bounds

    t0 = time.time()
    v, f = meshes.torus_knot(**MESH)
    # sets 0, 8, 16 and 24 of the cell's 32-set cycle
    sets = [meshes.deformed(v, 2.0 * np.pi * k / TRI_SETS, TRI_AMPLITUDE)
            for k in range(TRI_SETS)]
    lo = np.min([x.min(axis=0) for x in sets], axis=0)
    hi = np.max([x.max(axis=0) for x in sets], axis=0)
    plan = plan_tri_accel(f, len(v), bb_min=lo, bb_max=hi, res=TRI_RES,
                          device=device)
    on_card = [torch.as_tensor(x, device=device) for x in sets]
    nx, ny, nz = plan.dims
    log(f"tri-deform: {len(f)} triangles, {TRI_SETS} sets, tri grid "
        f"{plan.dims}, cell {plan.voxel_size}")

    @contextlib.contextmanager
    def plain_binning():
        saved = tri_accel._use_kernel
        tri_accel._use_kernel = lambda dev: False
        try:
            yield
        finally:
            tri_accel._use_kernel = saved

    def apart(a, b, what):
        """The largest |a - b| of two integer tables, required to be 0."""
        d = None
        if a.shape == b.shape:
            d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        require(d == 0, f"{what} differs (largest difference {d})")
        return d

    err = 0
    for k, x in enumerate(on_card):
        reset(*TRI_BIN, "tri_rows_wide")
        got = build_tri_accel_planned(plan, x)
        launches = counts_of(*TRI_BIN, "tri_rows_wide")
        require(launches == {**dict.fromkeys(TRI_BIN, 1), "tri_rows_wide": 0},
                f"tri-deform set {k}: tri_bin launches {launches}")
        with plain_binning():
            want = build_tri_accel_planned(plan, x)
        require(got is not None and want is not None,
                f"tri-deform set {k}: a cell outgrew the rows")
        require(got.l_width == want.l_width and got.dims == want.dims,
                f"tri-deform set {k}: l_width {got.l_width} / "
                f"{want.l_width}")
        for name in ("cell_slot", "cell_tris"):
            err = max(err, apart(getattr(got, name), getattr(want, name),
                                 f"tri-deform set {k}: {name}"))
        require(torch.equal(got.tri9, want.tri9),
                f"tri-deform set {k}: tri9 differs from the plain path's")
        for name in ("coarse", "fine", "l2", "origin"):
            require(torch.equal(getattr(got.brick, name),
                                getattr(want.brick, name)),
                    f"tri-deform set {k}: brick {name} differs")
        n_ne = int((got.cell_slot >= 0).sum())
        log(f"tri-deform set {k}: tables bit-equal to the plain path's "
            f"(l_width {got.l_width}, {n_ne} nonempty cells, "
            f"{int((got.cell_tris >= 0).sum())} pairs)")

    # the passes against their plain versions, on set 1
    tri9 = plan.tri9(on_card[1])
    n = plan.n_triangles
    args = (tri9, n, plan.origin, plan.voxel_size, plan.dims)
    counts = tri_bin.count(*args, *plan.box)
    plain = tri_bin.count_plain(*args, *plan.box)
    for name, a, b in zip(("cell_count", "sizes"), counts, plain):
        err = max(err, apart(a, b, f"tri_bin count pass: {name}"))
    cells = tri_bin.cells(*counts, tri_accel.L_WIDTHS)
    plain_cells = tri_bin.cells_plain(*plain, tri_accel.L_WIDTHS)
    for name, a, b in zip(("cell_slot", "mask", "sizes"),
                          (*cells, counts[1]), (*plain_cells, plain[1])):
        err = max(err, apart(a, b, f"tri_bin cells pass: {name}"))
    sizes = dict(zip(tri_bin.SIZES, counts[1].tolist()))
    n_rows, l_width = sizes["nonempty"], sizes["widest"]
    p_tri, p_lin = tri_bin.emit_plain(*args)
    p_lin, order = torch.sort(p_lin, stable=True)
    err = max(err, apart(
        tri_bin.rows(*args, cells[0], n_rows, l_width, sizes["wide"]),
        tri_bin.rows_plain(p_tri[order], p_lin, cells[0], n_rows, l_width),
        "tri_bin emit and rows passes: cell_tris (against the serial hit "
        "stream's)"))
    corners = plan.corners
    for name, a, b in zip(("tri9", "v0", "v1", "v2", "flat", "area"),
                          tri_bin.corners(on_card[1], corners),
                          tri_bin.corners_plain(on_card[1], corners)):
        require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                f"tri_bin corners pass: {name} differs from the plain one")
    log(f"tri_bin: every pass bit-equal to its plain version ({sizes})")

    # the wide path: set 1 and PILES small triangles in a cell each
    rng = np.random.default_rng(20)
    vs = plan.voxel_size
    piles = [plan.origin + (np.array(c) + 0.5) * vs
             + rng.uniform(-vs / 3, vs / 3, (m, 9)).reshape(m, 3, 3)
             for c, m in zip(((1, 1, 1), (nx - 2, ny - 2, nz - 2)), PILES)]
    tri9_p = torch.cat([tri9[:n], torch.as_tensor(
        np.concatenate(piles).reshape(-1, 9).astype(np.float32),
        device=device), tri9[n:]])
    n_p = n + sum(PILES)
    args_p = (tri9_p, n_p, plan.origin, plan.voxel_size, plan.dims)
    counts_p = tri_bin.count(*args_p, *plan.box)
    cells_p = tri_bin.cells(*counts_p, tri_accel.L_WIDTHS)
    sizes_p = dict(zip(tri_bin.SIZES, counts_p[1].tolist()))
    require(sizes_p["wide"] == len(PILES)
            and sizes_p["widest"] == max(PILES),
            f"the piled set: sizes {sizes_p}")
    rows_p, width_p = sizes_p["nonempty"], sizes_p["widest"]
    reset(*TRI_BIN, "tri_rows_wide")
    got_p = tri_bin.rows(*args_p, cells_p[0], rows_p, width_p,
                         sizes_p["wide"])
    torch.cuda.synchronize()
    launches_p = counts_of("tri_bin_emit", "tri_rows", "tri_rows_wide")
    require(launches_p == dict.fromkeys(launches_p, 1),
            f"the piled set: launches {launches_p}")
    p_tri, p_lin = tri_bin.emit_plain(*args_p)
    p_lin, order = torch.sort(p_lin, stable=True)
    err = max(err, apart(got_p, tri_bin.rows_plain(
        p_tri[order], p_lin, cells_p[0], rows_p, width_p),
        "the piled set: cell_tris (against the serial hit stream's)"))
    del got_p, p_tri, p_lin, order
    wide_block = tri_bin.rows_args(*args_p, cells_p[0], rows_p, width_p)[0]
    _build.launch("tri_bin_emit", wide_block, device)
    wide_ms = cuda_ms(lambda: _build.launch("tri_rows_wide", wide_block,
                                            device), 20)
    # the cursors read, each wide row read and written across its width
    wide_bytes = 4 * rows_p + 8 * len(PILES) * width_p
    log(f"tri_rows_wide, the piled set ({sizes_p['wide']} wide rows of "
        f"{list(PILES)}, rows {rows_p} x {width_p}): bit-equal to the "
        f"plain rows; kernel {wide_ms:.4f} ms, bound "
        f"{bound(wide_bytes, 0)[0]:.5f} ms by bytes")
    del wide_block, counts_p, cells_p
    sites = host_syncs(lambda: build_tri_accel_planned(plan, on_card[2]),
                       device)
    log(f"tri-deform rebuild: {len(sites)} host sync(s) at {sites}")
    require(len(sites) == 1, "the planned rebuild syncs more than once")
    tri9_2 = plan.tri9(on_card[2])
    names = device_kernels(lambda: build_tri_accel_planned(
        plan, on_card[2], tri9=tri9_2))
    log(f"tri-deform rebuild's kernels (tri9 given): {names}")
    own = TRI_KERNELS + ("accel_words_kernel", "accel_tiles_kernel")
    require(all(any(k in name for k in own) for name in names),
            "the planned rebuild runs a kernel not its own")

    # times: each pass, the rebuild, the plain binning
    # the cells pass adds to its sizes block: a copy here
    blocks = {"tri_corners": tri_bin.corners_args(on_card[1], corners)[0],
              "tri_bin_count": tri_bin.count_args(*args, *plan.box)[0],
              "tri_cells": tri_bin.cells_args(counts[0], counts[1].clone(),
                                              tri_accel.L_WIDTHS)[0]}
    blocks["tri_bin_emit"] = blocks["tri_rows"] = tri_bin.rows_args(
        *args, cells[0], n_rows, l_width)[0]
    pass_ms = {entry: cuda_ms(lambda: _build.launch(entry, blocks[entry],
                                                    device), 20)
               for entry in ("tri_corners",) + TRI_BIN}
    build_ms = wall_mean_ms(lambda: build_tri_accel_planned(
        plan, on_card[3]), 10)
    with plain_binning():
        plain_ms = wall_mean_ms(lambda: build_tri_accel_planned(
            plan, on_card[3]), 2)
    start, end = window_bounds(tri9[:n].reshape(n, 3, 3).amin(dim=1),
                               tri9[:n].reshape(n, 3, 3).amax(dim=1),
                               plan.origin, plan.voxel_size, plan.dims)
    tests = int((end - start).clamp(min=0).long().prod(dim=1).sum())
    # the binning's: inputs once (the vertex set, the faces), outputs once
    # (cell_slot, the mask, the rows); the corners pass's apart
    nbytes = 12 * len(v) + 12 * n + 5 * nx * ny * nz + 4 * n_rows * l_width
    corners_ms = pass_ms.pop("tri_corners")
    corners_bytes = 12 * len(v) + 24 * n + (36 + 36 + 12 + 4) * n + 36
    log(f"tri_corners: kernel {corners_ms:.4f} ms, bound "
        f"{bound(corners_bytes, 0)[0]:.5f} ms by bytes "
        f"({corners_bytes / 1e6:.1f} MB)")
    log("tri_bin: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in
                                  pass_ms.items())
        + f"; the planned rebuild {build_ms:.4f} ms a set (synced), with "
        f"the plain binning {plain_ms:.4f} ms; {tests} window cells, "
        f"{sizes['pairs']} pairs, rows {n_rows} x {l_width}")
    row = kernel_row("tri_bin", "tri_bin.cu", "none (the triangle accel's "
                     "binning, voxelray_tpu/ops/tri_accel.py:95-121)",
                     sum(launches.values()), err, sum(pass_ms.values()),
                     plain_ms, nbytes, tests * OPS_SAT)
    row["pass_ms"] = {k: round(ms, 4) for k, ms in pass_ms.items()}
    row["corners_ms"] = round(corners_ms, 4)
    row["wide_ms"] = round(wide_ms, 4)
    row["ptxas"] = {k: ptxas_of(_build.build_log(), k) for k in TRI_KERNELS}
    log(f"tri_bin: {row}")
    log(f"phase 13 (the planned triangle build): {time.time() - t0:.1f} s")
    return row


def run_scene_build(device):
    """Phase 14 (module docstring): returns the kernel rows of accel_build
    and aabb_boxes."""
    import numpy as np
    import torch

    from voxelray_torch.io import meshes
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import aabbs, traverse_fast
    from voxelray_torch.ops.kernels import _build, accel_build, tri_bin
    from voxelray_torch.ops.tri_accel import plan_tri_accel
    from voxelray_torch.ops.voxelize import plan_voxelize, voxelize_planned

    t0 = time.time()
    smi = smi_line()
    v, f = meshes.torus_knot(**MESH)
    sets = [meshes.deformed(v, 2.0 * np.pi * k / DEFORM_SETS,
                            TRI_AMPLITUDE) for k in range(DEFORM_SETS)]
    lo = np.min([x.min(axis=0) for x in sets], axis=0)
    hi = np.max([x.max(axis=0) for x in sets], axis=0)
    vs = float(max(hi - lo)) / GRID_RES
    plan = plan_voxelize(sets[0], f, vs, bb_min=lo, bb_max=hi,
                         deform_safe=True, device=device)
    occ, _ = voxelize_planned(plan, torch.as_tensor(sets[1], device=device))
    tplan = plan_tri_accel(f, len(v), bb_min=lo, bb_max=hi, res=TRI_RES,
                           device=device)
    tri9 = tplan.tri9(torch.as_tensor(sets[1], device=device))
    nx, ny, nz = tplan.dims
    cells = tri_bin.count(tri9, tplan.n_triangles, tplan.origin,
                          tplan.voxel_size, tplan.dims, *tplan.box)[0]
    tocc = (cells > 0).view(torch.uint8).reshape(nz, ny, nx)
    torch.cuda.synchronize()

    def tables(what, grid, fine_sb):
        """The tables of both paths on the card, bit-equal; (kernel ms,
        plain ms, bytes)."""
        gz, gy, gx = grid.shape
        bdims = (-(-gx // 8), -(-gy // 8), -(-gz // 8))
        reset(accel_build)
        got = accel_build.accel_tables(grid, bdims, fine_sb)
        torch.cuda.synchronize()
        require(launched(accel_build) == 1, f"{what}: accel_build calls "
                f"{launched(accel_build)}")
        want = traverse_fast.accel_tables_plain(grid, bdims, fine_sb)
        for name, a, b in zip(("fine", "coarse", "l2", "fine_sb"), got,
                              want):
            require((a is None) == (b is None)
                    and (a is None or torch.equal(a, b)),
                    f"{what}: {name} differs from the plain build's")
        ms = queued_ms(lambda: accel_build.accel_tables(grid, bdims,
                                                        fine_sb), 20)
        plain_ms = wall_mean_ms(lambda: traverse_fast.accel_tables_plain(
            grid, bdims, fine_sb), 5)
        nbytes = grid.numel() + 4 * sum(x.numel() for x in got
                                        if x is not None)
        log(f"accel_build, {what} {tuple(grid.shape[::-1])} (fine_sb "
            f"{fine_sb}, {int((got[0] != 0).sum())} nonzero words): "
            f"tables bit-equal to the plain build's; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound "
            f"{bound(nbytes, 0)[0]:.5f} ms ({nbytes / 1e6:.1f} MB) [{smi}]")
        return ms, plain_ms, nbytes

    acc_ms, acc_plain, acc_bytes = tables("the deforming grid", occ, True)
    tri_ms, tri_plain, tri_bytes = tables("the tri grid", tocc, False)

    # the boxes of the deforming grid's cells, against the plain version
    lin = torch.nonzero(occ.reshape(-1)).reshape(-1)
    n = lin.numel()
    reset("aabb_boxes")
    box = accel_build.aabb_boxes(lin, plan.dims, plan.origin, vs)
    torch.cuda.synchronize()
    require(launched("aabb_boxes") == 1, "aabb_boxes: "
            f"{launched('aabb_boxes')} launches")
    require(torch.equal(box, aabbs.aabbs_from_linear_plain(
        lin, plan.dims, plan.origin, vs)), "aabb_boxes differs from the "
        "plain boxes")
    box_ms = queued_ms(lambda: accel_build.aabb_boxes(
        lin, plan.dims, plan.origin, vs), 20)
    box_plain = wall_mean_ms(lambda: aabbs.aabbs_from_linear_plain(
        lin, plan.dims, plan.origin, vs), 5)
    nonzero_ms = wall_mean_ms(lambda: torch.nonzero(occ.reshape(-1)), 10)
    box_bytes = 32 * n
    log(f"aabb_boxes, {n} cells: bit-equal to the plain boxes; kernel "
        f"{box_ms:.4f} ms, plain {box_plain:.4f} ms, bound "
        f"{bound(box_bytes, 0)[0]:.5f} ms; the nonzero that sizes them "
        f"{nonzero_ms:.4f} ms (synced) [{smi}]")

    # the step's build_scene: its launches, syncs and time
    grid = {"occ": occ, "dims": plan.dims, "origin": plan.origin,
            "voxel_size": vs}
    build_scene(grid=grid, device=device)
    reset(accel_build, "aabb_boxes")
    scene = build_scene(grid=grid, device=device)
    torch.cuda.synchronize()
    launches = counts_of(accel_build, "aabb_boxes")
    require(launches == {"accel_build": 1, "aabb_boxes": 1},
            f"build_scene: launches {launches}")
    require(scene.n_voxels == n and torch.equal(scene.voxel_aabbs, box),
            "build_scene: the boxes differ from aabb_boxes'")
    sites = host_syncs(lambda: build_scene(grid=grid, device=device),
                       device)
    log(f"build_scene of the deforming grid: {len(sites)} host sync(s) at "
        f"{sites}")
    require(len(sites) == 1, "the voxel scene's rebuild syncs more than "
            "once")
    step_ms = wall_mean_ms(lambda: build_scene(grid=grid, device=device),
                           20)
    step_us = host_us(lambda: build_scene(grid=grid, device=device), 20)
    log(f"build_scene of the deforming grid: {step_ms:.4f} ms synced, "
        f"{step_us:.1f} us of host time a call [{smi}]")

    log_ = _build.build_log()
    rows = [kernel_row(
        "accel_build", "accel_build.cu", "none (the brick accel's tables: "
        "voxelray_tpu/ops/traverse_fast.py:95 build_accel, "
        "voxelray_tpu/ops/pallas/mega_trace.py:70 build_fine_sb, XLA ops)",
        1, 0, acc_ms, acc_plain, acc_bytes, 0)]
    rows[0].update(tri_grid={"ms": round(tri_ms, 4),
                             "plain_ms": round(tri_plain, 4),
                             "bound_ms": round(bound(tri_bytes, 0)[0], 5)},
                   ptxas=(ptxas_of(log_, "accel_words_kernel")
                          + ptxas_of(log_, "accel_tiles_kernel")))
    rows.append(kernel_row(
        "aabb_boxes", "accel_build.cu", "none (voxelray_tpu/ops/aabbs.py "
        "aabbs_from_linear, XLA ops)", 1, 0.0, box_ms, box_plain, box_bytes,
        0))
    rows[1].update(nonzero_ms=round(nonzero_ms, 4),
                   build_scene_ms=round(step_ms, 4),
                   build_scene_host_us=round(step_us, 1),
                   ptxas=ptxas_of(log_, "aabb_boxes_kernel"))
    for row in rows:
        log(f"{row['name']}: {row}")
    log(f"phase 14 (the voxel scene's rebuild): {time.time() - t0:.1f} s")
    return rows


def plain_walk_cuda(o, d, t_min, t_max, tree, *, admit=None,
                    any_hit=False, max_outer=512, stats=False):
    """octree_walk.walk_cuda's outputs by the plain walk on the card
    (ops/octree_traverse._walk over the admitted rays compacted, as the
    octree route ran before the kernel): the kernel's reference and the
    frame before it.  Returns (outputs, None)."""
    import torch
    from voxelray_torch.ops.octree_traverse import _walk
    from voxelray_torch.ops.traverse import _per_ray
    n, dev = o.shape[0], o.device
    tmn, tmx = _per_ray(t_min, n, dev), _per_ray(t_max, n, dev)
    sel = None if admit is None else torch.nonzero(admit).squeeze(1)
    if sel is not None:
        o, d, tmn, tmx = o[sel], d[sel], tmn[sel], tmx[sel]
    t, lin, _, _, _ = _walk(o, d, tree, tmn, tmx, max_outer)
    if sel is not None:
        t_all = torch.full((n,), float("inf"), device=dev)
        lin_all = torch.full((n,), -1, dtype=torch.int32, device=dev)
        t_all[sel], lin_all[sel] = t, lin
        t, lin = t_all, lin_all
    return ((torch.isfinite(t),) if any_hit else (t, lin)), None


@contextlib.contextmanager
def plain_octree():
    """The octree route's traces by plain_walk_cuda in the kernel's place
    (the frame before the kernel)."""
    from voxelray_torch.ops.kernels import octree_walk
    real = octree_walk.walk_cuda
    octree_walk.walk_cuda = plain_walk_cuda
    try:
        yield
    finally:
        octree_walk.walk_cuda = real


def same_fields(what, a, b):
    """Every field of two dataclasses equal (tensors bit for bit)."""
    import numpy as np
    import torch
    for k, x in vars(a).items():
        y = getattr(b, k)
        if torch.is_tensor(x):
            same = (torch.is_tensor(y) and x.dtype == y.dtype
                    and torch.equal(x, y))
        elif isinstance(x, np.ndarray):
            same = np.array_equal(x, y)
        else:
            same = x == y
        require(same, f"{what}: field {k} differs")


def run_octree(device):
    """Phase 15 (module docstring): returns octree_walk's kernel row."""
    import numpy as np
    import torch

    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridVec
    from voxelray_torch.models.octree import Octree
    from voxelray_torch.models.scene import Light, build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import _build, frame_shade, octree_walk
    from voxelray_torch.ops.octree_traverse import (any_hit_octree,
                                                    trace_octree)
    from voxelray_torch.render import pipeline
    from voxelray_torch.utils import trace

    t0 = time.time()
    smi = smi_line()
    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / OCTREE_RES
    box = dict(bb_min=bb_min, bb_max=bb_max, device=device)
    gv, gv_ms = wall_ms(lambda: GridVec.from_mesh(v, f, vs, **box))
    tree, tree_ms = wall_ms(lambda: Octree.from_grid(gv))
    want, mesh_ms = wall_ms(lambda: Octree.from_mesh(v, f, vs, **box))
    same_fields("Octree.from_grid against from_mesh", tree, want)
    del want
    log(f"octree {tree.dims}: GridVec.from_mesh {gv_ms:.1f} ms, "
        f"Octree.from_grid {tree_ms:.1f} ms (Octree.from_mesh "
        f"{mesh_ms:.1f} ms, every field equal); {tree.n_items} items, "
        f"{tree.n_nodes} nodes, bits {tree.bits_per_axis}, map_bits "
        f"{tree.map_bits} [{smi}]")
    scene = build_scene(grid=tree, aabbs=gv.get_aabbs(), octree=tree,
                        device=device)
    _, orbit = bench_camera(bb_min, bb_max)
    mats = [c.matrices(WIDTH, HEIGHT)[2:] for c in orbit]
    light = Light(position=BENCH_LIGHT[0], intensity=BENCH_LIGHT[1])
    tables = pipeline._surface_tables(scene, "octree")

    def traces(vi, pi):
        """The frame's primary rays and its shadow query."""
        o, d, _ = pipeline._frame_rays(scene, vi, pi, WIDTH, HEIGHT,
                                       "octree")
        t, lin = trace_octree(o, d, tree)
        q = frame_shade.hit_surface_cuda(o, d, t, lin, None, tables,
                                         light.position, light.intensity,
                                         light.type)
        flat = (q.world_pos.reshape(-1, 3).contiguous(),
                q.l_vec.reshape(-1, 3).contiguous(),
                q.light_dist.reshape(-1).contiguous(),
                q.admit.reshape(-1).contiguous())
        return (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
                t.reshape(-1), lin.reshape(-1)), flat

    # every orbit camera's traces against the plain walk, ray by ray
    before = trace.counters()
    trace.enable()
    apart, rays, admitted = 0, 0, 0
    try:
        for vi, pi in mats:
            (o, d, t, lin), (wp, lv, ld, adm) = traces(vi, pi)
            hit = any_hit_octree(wp, lv, tree, t_min=TMIN, t_max=ld,
                                 admit=adm)
            (tp, lp), _ = plain_walk_cuda(o, d, TMIN, TMAX, tree)
            (hp,), _ = plain_walk_cuda(wp, lv, TMIN, ld, tree, admit=adm,
                                       any_hit=True)
            apart += int(((t != tp) | (lin != lp)).sum())
            apart += int((hit != hp).sum())
            rays += o.shape[0]
            admitted += int(adm.sum())
        torch.cuda.synchronize()
    finally:
        trace.disable()
    after = trace.counters()
    got = {k: after.get(f"octree.{k}", 0) - before.get(f"octree.{k}", 0)
           for k in octree_walk.STATS[:3]}
    log(f"octree walk over {len(mats)} orbit frames ({rays} primary rays, "
        f"{admitted} admitted shadow rays): {apart} rays apart from the "
        f"plain walk on the card; counters {got}, "
        f"{got['regions'] / max(got['rays'], 1):.4f} regions a ray")
    require(apart == 0, f"octree_walk: {apart} rays apart from _walk")
    require(got["cut_rays"] == 0, "octree_walk: rays cut by max_outer")
    require(got["rays"] == rays + admitted, f"octree.rays {got['rays']}")

    # the kernel's time on the first camera's traces, beside its bound:
    # each primary ray read (24 B) and answered (t and lin, 8 B); each
    # shadow ray's admit byte read and its answer (a byte) written, the
    # admitted ones read (24 B) with their t_max (4 B)
    (o, d, _, _), (wp, lv, ld, adm) = traces(*mats[0])
    n, m = o.shape[0], int(adm.sum())
    p_ms = cuda_ms(lambda: octree_walk.walk_cuda(o, d, TMIN, TMAX, tree),
                   10)
    s_ms = cuda_ms(lambda: octree_walk.walk_cuda(
        wp, lv, TMIN, ld, tree, admit=adm, any_hit=True), 10)
    (_, st), _ = wall_ms(lambda: octree_walk.walk_cuda(o, d, TMIN, TMAX,
                                                       tree, stats=True))
    p_plain = wall_ms(lambda: plain_walk_cuda(o, d, TMIN, TMAX, tree))[1]
    s_plain = wall_ms(lambda: plain_walk_cuda(
        wp, lv, TMIN, ld, tree, admit=adm, any_hit=True))[1]
    p_bytes, s_bytes = 32 * n, 2 * n + 28 * m
    stats = dict(zip(octree_walk.STATS, st.tolist()))
    log(f"octree_walk primary ({n} rays): kernel {p_ms:.4f} ms, plain "
        f"{p_plain:.1f} ms, bound {bound(p_bytes, 0)[0]:.5f} ms; stats "
        f"{stats}; shadow ({m} admitted): kernel {s_ms:.4f} ms, plain "
        f"{s_plain:.1f} ms, bound {bound(s_bytes, 0)[0]:.5f} ms [{smi}]")

    # the frame: launches, host syncs, time with the kernel and with the
    # plain walk
    vi, pi = mats[0]

    def frame(shadows=True):
        return pipeline.render_image(scene, vi, pi, width=WIDTH,
                                     height=HEIGHT, light=light,
                                     backend="octree", shadows=shadows)

    reset(octree_walk, *FRAME_KERNELS)
    img = frame()
    torch.cuda.synchronize()
    counts = counts_of(octree_walk, *FRAME_KERNELS)
    require(counts == {"octree_walk": 2, "camera_rays": 1,
                       "hit_surface": 1, "shade_post": 1},
            f"octree frame launches {counts}")
    sites = host_syncs(frame, device)
    require(not sites, f"octree frame: host syncs at {sites}")
    with plain_octree():
        img_p = frame()
        torch.cuda.synchronize()
    require(torch.equal(img, img_p), "the octree frame differs from the "
            "frame of the plain walk")
    frame_ms = {s: wall_mean_ms(lambda: frame(s), 5) for s in (True, False)}
    with plain_octree():
        plain_ms = {s: wall_ms(lambda: frame(s))[1] for s in (True, False)}
    log(f"octree frame {WIDTH}x{HEIGHT}: launches {counts}, 0 host syncs, "
        f"equal to the plain walk's frame; ms (shadows on / off) "
        f"{frame_ms[True]:.3f} / "
        f"{frame_ms[False]:.3f}, with the plain walk {plain_ms[True]:.1f} / "
        f"{plain_ms[False]:.1f} [{smi}]")

    row = kernel_row(
        "octree_walk", "octree_walk.cu",
        "none: the host-stepped region loop of ops/octree_traverse._walk "
        "(voxelray_tpu/ops/octree_traverse.py _trace_octree_impl, XLA ops)",
        counts["octree_walk"], 0.0, p_ms, p_plain, p_bytes, 0)
    row.update(shadow={"ms": round(s_ms, 4), "plain_ms": round(s_plain, 4),
                       "bound_ms": round(bound(s_bytes, 0)[0], 5),
                       "admitted": m},
               stats=stats, frame_ms=frame_ms, plain_frame_ms=plain_ms,
               ptxas=ptxas_of(_build.build_log(), "octree_walk_kernel"))
    log(f"octree_walk: {row}")
    log(f"phase 15 (the octree walk): {time.time() - t0:.1f} s")
    return row


def frame_glue_rows(glue, vox_counts, tri_counts, build_log):
    """The kernel rows of the frame glue's kernels from phase 12's
    results: launches of the voxel frame, times on the voxel frame and,
    beside them, the triangle frame's; their few dozen operations a ray
    take far less than their bytes, so they are bound by bytes."""
    replaces = {
        "camera_rays": "voxelray_tpu/render/pipeline.py:349-353",
        "hit_surface": "voxelray_tpu/render/pipeline.py:231-279",
        "shade_post": "voxelray_tpu/render/pipeline.py:301-313,:356-362"}
    rows = []
    for name in FRAME_KERNELS:
        ms, plain_ms, nbytes, err, call_us = glue["voxel"][name]
        row = kernel_row(name, "frame_shade.cu", replaces[name],
                         vox_counts[name], err, ms, plain_ms, nbytes, 0)
        t_ms, t_plain, t_bytes, t_err, t_us = glue["triangle"][name]
        row.update(
            host_us=round(call_us, 1),
            triangle_frame={"launches": tri_counts[name], "max_abs_err":
                            t_err, "ms": round(t_ms, 4),
                            "plain_ms": round(t_plain, 4),
                            "bound_ms": round(bound(t_bytes, 0)[0], 5),
                            "host_us": round(t_us, 1)},
            ptxas=ptxas_of(build_log, name + "_kernel"))
        log(f"{name}: {row}")
        rows.append(row)
    return rows


def run(device):
    import numpy as np
    import torch

    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMIN, TMAX, make_camera_rays
    from voxelray_torch.ops.kernels import (_build, brick_fine, grid_walk,
                                            mega_trace, staged_march,
                                            tri_march, voxel_accum)
    from voxelray_torch.ops.traverse import (trace_grid_dda,
                                             trace_triangles_brute)
    from voxelray_torch.ops.traverse_fast import (any_hit_grid_fast,
                                                  trace_grid_fast)
    from voxelray_torch.ops.tri_accel import trace_triangles_grid
    from voxelray_torch.ops.voxelize import voxelize_plain, window_bounds
    from voxelray_torch.render import pipeline

    sync = torch.cuda.synchronize
    kmods = (voxel_accum, mega_trace, grid_walk, brick_fine, tri_march,
             staged_march, *FRAME_KERNELS)

    # ---- 1. device + build ---------------------------------------------
    smi = smi_line()
    log(f"device: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.load_library()
    log(f"kernel library ready in {time.time() - t0:.1f} s")
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "Compiling entry function" in ln or "registers" in ln
             or "spill" in ln]
    for ln in ptxas:
        log(f"ptxas: {ln}")

    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / GRID_RES
    cam, orbit = bench_camera(bb_min, bb_max)
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    mats = [c.matrices(WIDTH, HEIGHT)[2:] for c in orbit]
    log(f"mesh: {len(f)} triangles, voxel {vs}, dims "
        f"{geometry.grid_dims(bb_min, bb_max, vs)}")

    # ---- 2. the voxel path, counted ---------------------------------------
    reset(*kmods)
    sync()
    t0 = time.time()
    grid = GridBool.from_mesh(v, f, vs, device=device)
    scene = build_scene(grid=grid, device=device)
    img = pipeline.render_image(scene, vi, pi, width=WIDTH, height=HEIGHT,
                                backend="fast", shadows=True)
    sync()
    main_s = time.time() - t0
    vox_counts = counts_of(*kmods)
    log(f"voxel path (from_mesh -> build_scene -> render_image, first "
        f"call): {main_s:.2f} s, launches {vox_counts}")
    require(vox_counts["voxel_accum"] > 0, "K1 was not launched")
    require(vox_counts["mega_trace"] > 0, "K2 was not launched")
    require(all(vox_counts[k] == 1 for k in FRAME_KERNELS),
            "the voxel frame did not launch each frame glue kernel once")
    require(tuple(img.shape) == (HEIGHT, WIDTH, 4), f"frame {img.shape}")
    require(bool(torch.isfinite(img).all()), "frame has non-finite pixels")
    occ = grid.occupancy()
    n_occ = int(occ.sum())
    log(f"grid: {grid.dims}, {n_occ} occupied, set_calls {grid.set_calls}")
    require(n_occ > 0, "empty grid")

    # ---- 3. K1 vs its plain version --------------------------------------
    v_t = torch.as_tensor(v, device=device)
    f_t = torch.as_tensor(f, device=device)
    occ_p, calls_p = voxelize_plain(v_t, f_t, bb_min, vs, grid.dims)
    k1_err = int((occ_p.int() - occ.int()).abs().max())
    log(f"K1: plain occupied {int(occ_p.sum())}, set_calls {calls_p}")
    require(k1_err == 0, "K1 occupancy differs from the plain version")
    require(calls_p == grid.set_calls, "K1 set_calls differ from plain")
    cv, cf = meshes.cube(2.0)
    cube = GridBool.from_mesh(cv, cf, 2.0 / 64, device=device)
    n_cube = int(cube.occupancy().sum())
    log(f"K1 cube64: {n_cube} occupied, {cube.set_calls} set_calls")
    require((n_cube, cube.set_calls) == (12097, 12858), "cube64 invariants")
    k1_ms = cuda_ms(lambda: voxel_accum.voxel_accum_cuda(
        v_t, f_t, bb_min, vs, grid.dims), 5)
    # the kernel alone: no zeroed volume, no sync for its counts
    # (k1_out, the volume and counts the block points at, is held)
    k1_block, k1_out = voxel_accum.accum_args(v_t, f_t, bb_min, vs,
                                              grid.dims)
    k1_kernel_ms = cuda_ms(lambda: _build.launch(
        "voxel_accum", k1_block, v_t.device), 5)
    log(f"K1 voxelize ms: wrapper (zeroed volume, kernel, one sync) "
        f"{k1_ms:.4f}, kernel alone {k1_kernel_ms:.4f}")
    k1_plain_ms = cuda_ms(lambda: voxelize_plain(
        v_t, f_t, bb_min, vs, grid.dims), 1)
    tri = v_t[f_t.long()]
    w0, w1 = window_bounds(tri.amin(1), tri.amax(1), bb_min, vs, grid.dims)
    slots = int(torch.clamp(w1 - w0, min=0).prod(-1).sum())
    rows = [kernel_row(
        "voxel_accum", "voxel_accum.cu",
        "voxelray_tpu/ops/pallas/voxel_accum.py:236",
        vox_counts["voxel_accum"], k1_err, k1_ms, k1_plain_ms,
        v.nbytes + f.size * 4 + grid.n_cells + 8, slots * OPS_SAT)]

    # ---- 4. K2 vs its plain version: primary and shadow rays ------------
    accel = scene.accel
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=device)
    o = pipeline._tile_rays(o, HEIGHT, WIDTH).contiguous()
    d = pipeline._tile_rays(d, HEIGHT, WIDTH).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=device)
    tmx = torch.full((n,), float(TMAX), device=device)
    ones = torch.ones((n,), dtype=torch.bool, device=device)
    t_k, lin_k, alive = mega_trace.trace_grid_mega_cuda(o, d, accel, tmn,
                                                        tmx, ones)
    unresolved = int(alive.sum())
    log(f"K2 primary: unresolved {unresolved}")
    require(unresolved == 0, "K2 left rays unresolved")
    occ_flat = scene.occ_flat
    t_p, lin_p = trace_grid_dda(o, d, occ_flat, scene.grid_origin,
                                dims=scene.grid_dims, voxel_size=vs)
    occ_np = occ.cpu().numpy().astype(bool)
    _, k2_err = compare_traces("K2 primary", o, d, occ_np, grid.origin, vs,
                               t_k, lin_k, t_p, lin_p)
    k2_ms = cuda_ms(lambda: mega_trace.trace_grid_mega_cuda(
        o, d, accel, tmn, tmx, ones), 5)
    k2_plain_ms = cuda_ms(lambda: mega_trace.trace_grid_mega_plain(
        o, d, accel, tmn, tmx, ones), 1)
    log(f"K2 primary trace ms ({n} rays): kernel {k2_ms:.3f}, plain "
        f"{k2_plain_ms:.3f}")
    k2_bray, k2_cray, k2_bricks, lin_w = mega_work(o, d, tmn, tmx, accel)
    k2_bsteps, k2_csteps = int(k2_bray.sum()), int(k2_cray.sum())
    n_sb = accel.fine_sb.shape[0]
    k2_bytes = n * 45 + 4 * accel.l2.numel() + 64 * (n_sb + k2_bricks)
    n_w = int((lin_w != lin_k).sum())
    log(f"K2 primary work (plain staged walk, one brick at a time): "
        f"{k2_bsteps} brick steps, {k2_csteps} cell steps, {k2_bricks} "
        f"occupied bricks read, {n_w} rays with another cell than K2's")
    require(n_w <= MAX_DIFF_RAYS, "K2 work count: the counting walk "
            "does not follow K2")
    # K2 timed on the primary rays of each step class alone
    classes, k2_stats = k2_step_classes(k2_bray, k2_cray)
    split = {}
    for name, idx in classes.items():
        sub = (o[idx].contiguous(), d[idx].contiguous(), accel,
               tmn[idx].contiguous(), tmx[idx].contiguous(),
               ones[idx].contiguous())
        split[name] = [idx.numel(), round(cuda_ms(
            lambda: mega_trace.trace_grid_mega_cuda(*sub), 5), 4)]
    log(f"K2 primary steps per ray: {json.dumps(k2_stats)}")
    log(f"K2 primary by step class [rays, kernel ms]: {json.dumps(split)}; "
        f"all {n} rays {k2_ms:.4f} ms")

    surf = pipeline.surface_terms(scene, o, d, t_k, lin_k)
    so, sd, sdist = surf.world_pos, surf.l_vec.contiguous(), surf.light_dist
    admit = surf.hit & surf.facing
    stmn = torch.full((n,), float(TMIN), device=device)
    s_k, slin_k, s_alive = mega_trace.trace_grid_mega_cuda(
        so, sd, accel, stmn, sdist, admit)
    require(int(s_alive.sum()) == 0, "K2 shadow pass left rays unresolved")
    s_p, slin_p = trace_grid_dda(so, sd, occ_flat, scene.grid_origin,
                                 dims=scene.grid_dims, voxel_size=vs,
                                 t_min=stmn, t_max=sdist, admit=admit)
    log(f"K2 shadow: {int(admit.sum())} admitted rays, occluded kernel "
        f"{int(torch.isfinite(s_k).sum())}, plain "
        f"{int(torch.isfinite(s_p).sum())}")
    _, k2s_err = compare_traces("K2 shadow", so, sd, occ_np, grid.origin,
                                vs, s_k, slin_k, s_p, slin_p)
    k2s_ms = cuda_ms(lambda: mega_trace.trace_grid_mega_cuda(
        so, sd, accel, stmn, sdist, admit), 5)
    k2s_plain_ms = cuda_ms(lambda: mega_trace.trace_grid_mega_plain(
        so, sd, accel, stmn, sdist, admit), 1)
    log(f"K2 shadow trace ms: kernel {k2s_ms:.3f}, plain {k2s_plain_ms:.3f}")
    # the admitted shadow rays compacted on the host, against the masked
    # launch of the whole frame
    adm = torch.nonzero(admit).squeeze(1)
    cargs = (so[adm].contiguous(), sd[adm].contiguous(), accel,
             stmn[adm].contiguous(), sdist[adm].contiguous(),
             admit[adm].contiguous())
    c_t, c_lin, _ = mega_trace.trace_grid_mega_cuda(*cargs)
    require(torch.equal(c_t, s_k[adm]) and torch.equal(c_lin, slin_k[adm]),
            "K2 shadow: the compacted rays differ from the masked launch")
    k2s_c_ms = cuda_ms(lambda: mega_trace.trace_grid_mega_cuda(*cargs), 5)
    log(f"K2 shadow: {adm.numel()} admitted rays compacted {k2s_c_ms:.4f} "
        f"ms, masked launch over {n} rays {k2s_ms:.4f} ms")
    # K2's own work on the admitted shadow rays, counted as for primary
    s_bray, s_cray, s_bricks, _ = mega_work(*cargs[:2], *cargs[3:5], accel)
    s_bsteps, s_csteps = int(s_bray.sum()), int(s_cray.sum())
    k2s_bytes = n * 13 + adm.numel() * 32 + 4 * accel.l2.numel() \
        + 64 * (n_sb + s_bricks)
    k2s_b_ms, k2s_b_by = bound(k2s_bytes, s_bsteps * OPS_BRICK
                               + s_csteps * OPS_CELL)
    log(f"K2 shadow work ({adm.numel()} admitted rays): {s_bsteps} brick "
        f"steps, {s_csteps} cell steps, {s_bricks} occupied bricks read; "
        f"bound {k2s_b_ms:.5f} ms by {k2s_b_by} ({k2s_bytes / 1e6:.1f} MB); "
        f"kernel {k2s_ms:.4f} ms")
    rows.append(kernel_row(
        "mega_trace", "mega_trace.cu",
        "voxelray_tpu/ops/pallas/mega_trace.py:918",
        vox_counts["mega_trace"], max(k2_err, k2s_err), k2_ms, k2_plain_ms,
        k2_bytes, k2_bsteps * OPS_BRICK + k2_csteps * OPS_CELL))

    # ---- 5. voxel frames ---------------------------------------------------
    _, _, cvi, cpi = cam.matrices(CHECK_W, CHECK_H)
    img_k = pipeline.render_image(scene, cvi, cpi, width=CHECK_W,
                                  height=CHECK_H, backend="fast")
    img_p = pipeline.render_image(scene, cvi, cpi, width=CHECK_W,
                                  height=CHECK_H, backend="dda")
    miss = float(np.float32(0.8) ** np.float32(1 / 2.2))
    hit_k = (img_k[..., :3] != miss).any(-1)
    hit_p = (img_p[..., :3] != miss).any(-1)
    close = float(((img_k - img_p).abs() <= PIXEL_ATOL).all(-1)
                  .float().mean())
    log(f"frame {CHECK_W}x{CHECK_H} fast vs dda: hit pixels "
        f"{int(hit_k.sum())} / {int(hit_p.sum())}, share within "
        f"{PIXEL_ATOL}: {close}")
    require(bool((hit_k == hit_p).all()), "frame hit masks differ")
    require(close >= PIXEL_FRAC, f"only {close} of pixels match")
    log_frames("voxel (megakernel)", time_frames(scene, mats), smi_line())

    # ---- 6. the staged walk (K3 + K4) on the voxel frame ---------------
    (hits, cell, cont), *_ = check_walk("staged 512^3 round 1", o, d, tmn,
                                        tmx, accel, 5)
    check_fine("staged 512^3 round 1", o, d, hits, tmn, tmx, accel)
    go = torch.nonzero(cont > 0).squeeze(1)
    check_walk("staged 512^3 resume", o[go], d[go], tmn[go], tmx[go], accel,
               8, cell=cell[go].contiguous(),
               active=torch.ones_like(go, dtype=torch.int32))
    reset(*kmods)
    t_s, lin_s, unres_s = trace_grid_fast(o, d, accel, mega=False,
                                          return_stats=True)
    sync()
    trace_counts = counts_of(staged_march, grid_walk, brick_fine)
    unres_s = int(unres_s)
    log(f"staged primary trace: unresolved {unres_s}, launches "
        f"{trace_counts}")
    require(unres_s == 0, "the staged trace left rays unresolved")
    require(trace_counts == {"staged_march": 1, "grid_walk": 0,
                             "brick_fine": 0},
            "the staged trace is not one staged_march launch")
    n_vs_k2 = int((lin_s != lin_k).sum())
    log(f"staged primary vs K2: {n_vs_k2} rays with another cell")
    compare_traces("staged primary vs dda", o, d, occ_np, grid.origin, vs,
                   t_s, lin_s, t_p, lin_p)
    # as render_image's shadow pass calls it: scalar TMIN, any_hit's k 4
    ts_s, tslin_s, unres_ss = trace_grid_fast(
        so, sd, accel, t_min=float(TMIN), t_max=sdist, admit=admit,
        mega=False, k_hits=4, return_stats=True)
    require(int(unres_ss) == 0,
            "the staged shadow trace left rays unresolved")
    compare_traces("staged shadow vs dda", so, sd, occ_np, grid.origin, vs,
                   ts_s, tslin_s, s_p, slin_p)
    # the staged walk against the exhaustive DDA from the orbit cameras
    # and from inside the knot's box
    cams = mats + [close_camera(bb_min, bb_max).matrices(WIDTH, HEIGHT)[2:]]
    for ci, (cvi, cpi) in enumerate(cams):
        co, cd = make_camera_rays(WIDTH, HEIGHT, cvi, cpi, device=device)
        co = pipeline._tile_rays(co, HEIGHT, WIDTH).contiguous()
        cd = pipeline._tile_rays(cd, HEIGHT, WIDTH).contiguous()
        ct_s, clin_s, cun = trace_grid_fast(co, cd, accel, mega=False,
                                            return_stats=True)
        require(int(cun) == 0,
                f"camera {ci}: staged trace left rays unresolved")
        ct_p, clin_p = trace_grid_dda(co, cd, occ_flat, scene.grid_origin,
                                      dims=scene.grid_dims, voxel_size=vs)
        compare_traces(f"staged vs dda, camera {ci} of {len(cams)}", co, cd,
                       occ_np, grid.origin, vs, ct_s, clin_s, ct_p, clin_p)
    # staged_march against the lap loop it replaces (with the K3/K4
    # kernels and fully plain): the primary rays (k 5) and the shadow
    # pass's rays with its admit mask, as render_image calls it (k 4,
    # scalar TMIN)
    sm_ms, sm_lap_ms, sm_plain_ms, sm_bytes, sm_ops = check_staged(
        "staged primary", o, d, tmn, tmx, None, accel, 5)
    check_staged("staged shadow", so, sd, stmn, sdist, admit, accel, 4)
    # the staged trace and the shadow query queue with no host sync
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace_grid_fast(o, d, accel, t_min=tmn, t_max=tmx, mega=False)
        any_hit_grid_fast(so, sd, accel, t_min=float(TMIN), t_max=sdist,
                          admit=admit, mega=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log("staged trace and staged any-hit on the card: no host sync "
        "(torch.cuda.set_sync_debug_mode(\"error\"))")
    staged = dict(fast_opts={"mega": False}, shadow_opts={"mega": False})
    reset(*kmods)
    pipeline.render_image(scene, vi, pi, width=WIDTH, height=HEIGHT,
                          backend="fast", shadows=True, **staged)
    sync()
    staged_counts = counts_of(*kmods)
    log(f"staged voxel frame launches (shadows on): {staged_counts}")
    require(staged_counts["staged_march"] > 0,
            "staged frame: staged_march not launched")
    require(staged_counts["grid_walk"] == 0 and
            staged_counts["brick_fine"] == 0,
            "staged frame: K3 or K4 launched")
    # the lap loop the kernel replaced, counted: K3's and K4's launches
    reset(*kmods)
    with lap_loop_staged():
        pipeline.render_image(scene, vi, pi, width=WIDTH, height=HEIGHT,
                              backend="fast", shadows=True, **staged)
    sync()
    lap_counts = counts_of(*kmods)
    log(f"staged voxel frame through the lap loop (shadows on), launches: "
        f"{lap_counts}")
    require(lap_counts["grid_walk"] > 0 and lap_counts["brick_fine"] > 0
            and lap_counts["staged_march"] == 0,
            "the lap loop frame did not run K3 and K4")
    with lap_loop_staged():
        log_frames("voxel (staged, lap loop over K3+K4, before)",
                   time_frames(scene, mats, **staged), smi_line())
    log_frames("voxel (staged, staged_march, after)",
               time_frames(scene, mats, **staged), smi_line())

    # ---- 7. the triangle path, counted -------------------------------------
    model = knot_model(v, f)
    reset(*kmods)
    sync()
    t0 = time.time()
    tscene = build_scene(models=[model], device=device)
    build_s = time.time() - t0
    timg = pipeline.render_image(tscene, vi, pi, width=WIDTH, height=HEIGHT,
                                 backend="fast", shadows=True)
    sync()
    tri_s = time.time() - t0
    tri_counts = counts_of(*kmods)
    ta = tscene.tri_accel
    require(ta is not None, "build_scene built no triangle accel")
    n_nonempty = int((ta.cell_slot >= 0).sum())
    log(f"triangle path (build_scene(models) -> render_image, first call): "
        f"{tri_s:.2f} s (build {build_s:.2f} s), launches {tri_counts}")
    log(f"tri accel: dims {ta.dims}, l_width {ta.l_width}, overflow_cells "
        f"{ta.overflow_cells}, nonempty cells {n_nonempty}, brick grid "
        f"{ta.brick.bdims} ({ta.brick.coarse.shape[0]} coarse rows)")
    require(ta.overflow_cells == 0, "tri accel cells overflow")
    require(tri_counts["tri_march"] > 0, "tri_march was not launched")
    require(tri_counts["grid_walk"] == 0 and tri_counts["brick_fine"] == 0
            and tri_counts["staged_march"] == 0,
            "the triangle march launched K3, K4 or staged_march")
    require(all(tri_counts[k] == 1 for k in FRAME_KERNELS),
            "the triangle frame did not launch each frame glue kernel once")
    require(bool(torch.isfinite(timg).all()), "tri frame non-finite")

    # K3 and K4 on the march's first lap (the frame's rays, t_min = TMIN)
    tacc = ta.brick
    (thits, _, _), k3_ms, k3_plain_ms, k3_steps, k3_bytes = check_walk(
        "tri lap 1", o, d, tmn, tmx, tacc, 2)
    (_, tlin), k4_ms, k4_plain_ms, k4_steps, k4_bytes = check_fine(
        "tri lap 1", o, d, thits, tmn, tmx, tacc)

    # tri_march on the frame's rays and on its shadow rays, against the
    # lap loop over K3/K4 (with the kernels and fully plain)
    tt, tid, tu, tv, unres_t = trace_triangles_grid(o, d, ta,
                                                    return_stats=True)
    sync()
    log(f"tri trace: {int(torch.isfinite(tt).sum())} hits, unresolved "
        f"{unres_t}")
    require(unres_t == 0, "the tri march left rays unresolved")
    tm_ms, tm_lap_ms, tm_plain_ms, tm_bytes, tm_ops = check_march(
        "tri primary", o, d, tmn, tmx, ta)
    no_vox = torch.full((n,), float("inf"), device=device)
    tsurf = pipeline.surface_terms(tscene, o, d, no_vox,
                                   torch.full_like(lin_k, -1),
                                   tri=(tt, tid, tu, tv))
    sel = torch.nonzero(tsurf.hit & tsurf.facing).squeeze(1)
    tso = tsurf.world_pos[sel].contiguous()
    tsd = tsurf.l_vec[sel].contiguous()
    tsmx = tsurf.light_dist[sel].contiguous()
    tsmn = torch.full((sel.numel(),), float(TMIN), device=device)
    check_march("tri shadow", tso, tsd, tsmn, tsmx, ta)

    rng = np.random.default_rng(0)
    hit_idx = torch.nonzero(torch.isfinite(tt)).squeeze(1).cpu().numpy()
    idx = np.concatenate([rng.choice(hit_idx, N_BRUTE // 2, replace=False),
                          rng.choice(n, N_BRUTE // 2, replace=False)])
    idx_t = torch.as_tensor(idx, device=device)
    t0 = time.time()
    tb, idb, _, _ = trace_triangles_brute(o[idx_t], d[idx_t], tscene.tri_v0,
                                          tscene.tri_v1, tscene.tri_v2)
    sync()
    brute_s = time.time() - t0
    tg = tt[idx_t]
    hb, hg = torch.isfinite(tb), torch.isfinite(tg)
    same_id = float((idb[hb] == tid[idx_t][hb]).float().mean())
    t_err = float(((tg[hb] - tb[hb]).abs()
                   - (TRI_ATOL + TRI_RTOL * tb[hb].abs())).max())
    log(f"tri brute check ({N_BRUTE} rays x {len(f)} triangles, "
        f"{brute_s:.2f} s): hits grid {int(hg.sum())} brute {int(hb.sum())}"
        f", same triangle {same_id}, max |t err| - tolerance {t_err}")
    require(bool((hb == hg).all()), "tri march and brute hit masks differ")
    require(t_err <= 0.0, "tri t outside rtol 3e-6, atol 1e-7 of brute")
    with lap_loop_march():
        log_frames("triangles (lap loop over K3+K4, before)",
                   time_frames(tscene, mats), smi_line())
    log_frames("triangles (tri_march, after)", time_frames(tscene, mats),
               smi_line())

    log(f"tri_march on the triangle path: lap loop with K3/K4 "
        f"{tm_lap_ms:.4f} ms, tri_march {tm_ms:.4f} ms")

    # ---- 8. AABB extraction, the other encodings, the octree frame -------
    run_encodings(grid, v, f, vs, mats, o, d, occ_np, device)

    # ---- 9. the front end: CLI, gates, the native oracle, AOV parity ----
    run_frontend(grid, v, f, vs, scene, cam, occ_np, k1_kernel_ms, kmods,
                 device)

    # ---- 10. the multi-device layer ----------------------------------------
    zslab_counts = run_multidevice(v, f, grid, scene, vi, pi,
                                   (o, d, tmn, tmx), (t_k, lin_k), img,
                                   occ_np, k1_kernel_ms, kmods, device)

    # ---- 11. the bench and the planned voxelize ---------------------------
    rows[0]["launches"] += run_bench(v, f, grid, scene, vi, pi, kmods,
                                     device)

    # ---- 12. the frame glue's kernels against the plain glue -------------
    t0 = time.time()
    glue = {"voxel": check_frame_glue("voxel frame", scene, vi, pi, device),
            "triangle": check_frame_glue("triangle frame", tscene, vi, pi,
                                         device)}
    log(f"phase 12 (the frame glue's kernels): {time.time() - t0:.1f} s")

    # K3 and K4 launch in the lap loops the one-launch kernels are held
    # to (staged_march_plain, tri_march_plain): their launches are the
    # staged frame's through the lap loop, their times the triangle
    # march's first lap
    rows.append(kernel_row(
        "grid_walk", "grid_walk.cu",
        "voxelray_tpu/ops/pallas/grid_walk.py:496",
        lap_counts["grid_walk"], 0, k3_ms, k3_plain_ms, k3_bytes,
        k3_steps * OPS_BRICK))
    rows.append(kernel_row(
        "brick_fine", "brick_fine.cu",
        "voxelray_tpu/ops/pallas/brick_fine.py:296",
        lap_counts["brick_fine"], 0.0, k4_ms, k4_plain_ms, k4_bytes,
        k4_steps * OPS_CELL))
    # staged_march: launches of the staged voxel frame (the Z-slab
    # frame's are logged in phase 10); times on the frame's primary rays
    log(f"staged_march launches: staged voxel frame "
        f"{staged_counts['staged_march']}, Z-slab frame "
        f"{zslab_counts['staged_march']}; primary rays: kernel {sm_ms:.4f} "
        f"ms, lap loop with K3/K4 {sm_lap_ms:.4f} ms")
    rows.append(kernel_row(
        "staged_march", "staged_march.cu",
        "voxelray_tpu/ops/pallas/grid_walk.py:496,:569; "
        "voxelray_tpu/ops/pallas/brick_fine.py:296; "
        "voxelray_tpu/ops/traverse_fast.py:365",
        staged_counts["staged_march"], 0.0, sm_ms, sm_plain_ms, sm_bytes,
        sm_ops))
    # the ray schedule's settings, the shared memory and occupancy they
    # take, and ptxas's report of the kernel
    rows[-1].update(staged_march.launch_config(accel),
                    ptxas=ptxas_of(_build.build_log(),
                                   "staged_march_kernel"))
    log(f"staged_march launch: {rows[-1]}")
    rows.append(kernel_row(
        "tri_march", "tri_march.cu",
        "voxelray_tpu/ops/pallas/grid_walk.py:496,:569; "
        "voxelray_tpu/ops/pallas/brick_fine.py:296; "
        "voxelray_tpu/ops/tri_accel.py:242-320",
        tri_counts["tri_march"], 0.0, tm_ms, tm_plain_ms, tm_bytes, tm_ops))
    # the rows' staging: its chunk C, the ray schedule's settings, the
    # shared memory and occupancy they take, and ptxas's report of the
    # kernel
    rows[-1].update(tri_march.launch_config(ta),
                    ptxas=ptxas_of(_build.build_log(), "tri_march_kernel"))
    log(f"tri_march launch: {rows[-1]}")
    rows += frame_glue_rows(glue, vox_counts, tri_counts,
                            _build.build_log())

    # ---- 13. the planned triangle build --------------------------------
    rows.append(run_tri_deform(device))

    # ---- 14. the voxel scene's rebuild ---------------------------------
    rows += run_scene_build(device)

    # ---- 15. the octree walk -------------------------------------------
    rows.append(run_octree(device))
    return rows, smi_line()


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import voxelray_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: voxelray_torch is not beside this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    kernels, smi = run(torch.device("cuda", 0))
    log(f"chip_smoke: {time.time() - t0:.1f} s, the kernels' build "
        "included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
