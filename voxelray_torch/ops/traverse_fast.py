"""The brick acceleration structure and the fast traces over it.

Counterpart of voxelray_tpu/ops/traverse_fast.py.  The BrickAccel is
built once per grid: dims padded to multiples of 8, a brick-occupancy
bitmask (`coarse`), per-brick packed cell words stored word-major
(16, NB) (`fine`), an L2 superbrick (8^3 bricks) bitmask (`l2`) and the
superbrick-major tile table `fine_sb` that the megakernel K2 reads.
Every table is bit-equal to the JAX package's; words are int32 tensors
holding the uint32 bit patterns.  `build_accel_slab` builds the accel of
one Z-slab of a grid sharded over devices (parallel/comm.py
render_zslab_sharded): full-grid coordinates, bitmasks with bits only in
the slab, and a fine table that is a window of brick ids from `fine_off`
on.

`trace_grid_fast` and `any_hit_grid_fast` have two backends:

  mega=True (with fine_sb)  the megakernel K2 (ops/kernels/mega_trace.py),
                            one launch per trace;
  mega=False                the staged walk (ops/kernels/staged_march.py):
                            groups of brick steps of K3, which finds each
                            ray's next k_hits occupied bricks, and the
                            per-voxel walk K4 through them, until each ray
                            has its first accepted cell or retires.  On
                            CUDA tensors one staged_march launch per trace,
                            with no host sync; on CPU tensors the lap loop
                            over K3's and K4's plain versions.

The staged backend ports the semantics of JAX's `_trace_fast_impl`, not
its TPU scheduling (resident/fine/admit/drain buffer fractions, group
compaction, chunk sizes): each ray gets its first accepted cell along
its brick walk, and no ray is dropped.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models.grids import pack_words
from ..utils import trace
from .intersect import TMAX, TMIN
from .kernels import accel_build, staged_march
from .kernels.mega_trace import build_fine_sb, trace_grid_mega
from .traverse import _per_ray

__all__ = ["BrickAccel", "build_accel", "build_accel_slab",
           "accel_tables_plain", "trace_grid_fast", "any_hit_grid_fast"]

BRICK = 8
LANES = 128


@dataclass(frozen=True)
class BrickAccel:
    coarse: Any          # int32[ROWS, 128] brick bitmask (x-fastest lin)
    fine: Any            # int32[16, NB] cell bits of the bricks from id
                         # fine_off on, word-major
    l2: Any              # int32[SROWS, 128] superbrick bitmask
    origin: Any          # float32[3] tensor on the tables' device
    dims: tuple          # voxel dims (X, Y, Z)
    bdims: tuple         # brick dims
    voxel_size: float
    origin_key: tuple    # origin as python floats (kernel arguments)
    fine_sb: Any = None  # int32[n_sb, 72, 128] superbrick tiles (K2)
    fine_off: int = 0    # first brick id of `fine` (a slab accel's window)


def _bitmask_rows(flags):
    """Flat {0,1} flags -> (rows, 128) int32 words, >= 1 row."""
    n_words = -(-flags.shape[0] // 32)
    rows = max(1, -(-n_words // LANES))
    flat = torch.zeros(rows * LANES * 32, dtype=torch.uint8,
                       device=flags.device)
    flat[:flags.shape[0]] = flags.to(torch.uint8)
    return pack_words(flat.reshape(-1, 32)).reshape(rows, LANES)


def _bricks(occ, bdims):
    """(L*8 or fewer, Y, X) uint8 occupancy rows -> (L, by, bx, 512) cells
    brick-major, each brick's cells x-fastest; rows, y and x padded with
    empty cells to whole bricks."""
    bx, by, _ = bdims
    nz, ny, nx = occ.shape
    layers = -(-nz // BRICK)
    occp = torch.zeros((layers * BRICK, by * BRICK, bx * BRICK),
                       dtype=torch.uint8, device=occ.device)
    occp[:nz, :ny, :nx] = occ
    # (L, 8, by, 8, bx, 8) -> brick-major (L, by, bx, 8z, 8y, 8x)
    return occp.reshape(layers, BRICK, by, BRICK, bx, BRICK) \
        .permute(0, 2, 4, 1, 3, 5).reshape(layers, by, bx, BRICK ** 3)


def _fine_words(blocks):
    """(L, by, bx, 512) cells -> (16, L*by*bx) words, word-major: per
    brick, 512 cell bits (a cell any nonzero value) packed x-fastest into
    16 words."""
    n = blocks.shape[0] * blocks.shape[1] * blocks.shape[2]
    return pack_words((blocks != 0).reshape(n, 16, 32)).t().contiguous()


def _l2(bocc):
    """(bz, by, bx) brick occupancy -> the L2 superbrick (8^3 bricks)
    bitmask rows."""
    bz, by, bx = bocc.shape
    sbx, sby, sbz = -(-bx // 8), -(-by // 8), -(-bz // 8)
    boccp = torch.zeros((sbz * 8, sby * 8, sbx * 8), dtype=torch.bool,
                        device=bocc.device)
    boccp[:bz, :by, :bx] = bocc
    socc = boccp.reshape(sbz, 8, sby, 8, sbx, 8).permute(0, 2, 4, 1, 3, 5) \
        .reshape(sbz, sby, sbx, -1).any(dim=-1)
    return _bitmask_rows(socc.reshape(-1))


def accel_tables_plain(occ, bdims, fine_sb=True):
    """(fine, coarse, l2, fine_sb or None): the BrickAccel tables of occ
    (Z, Y, X), bdims its brick dims, in PyTorch ops on occ's device."""
    blocks = _bricks(occ, bdims)
    bocc = (blocks != 0).any(dim=-1)                    # (bz, by, bx)
    fine = _fine_words(blocks)
    return (fine, _bitmask_rows(bocc.reshape(-1)), _l2(bocc),
            build_fine_sb(fine, bdims) if fine_sb else None)


@functools.lru_cache(maxsize=16)
def _origin_on(key, device):
    """The origin `key` (three floats) as a float32 (3,) tensor on `device`,
    made once for each origin and device: a host-to-device copy syncs, and
    a changing scene keeps its grid's origin from step to step.  Shared,
    read-only, by the accels built over that origin."""
    return torch.tensor(key, dtype=torch.float32, device=device)


@trace.spanned("build_accel")
def build_accel(occ, origin, voxel_size, *, fine_sb=True) -> BrickAccel:
    """occ (Z, Y, X) uint8 tensor -> BrickAccel on occ's device.

    On CUDA tensors the tables come from one accel_build call (two
    kernels, no host sync); on CPU tensors from accel_tables_plain, the
    kernels' bit-for-bit reference.  fine_sb=False leaves out K2's
    superbrick tiles (an accel only the staged walk or tri_march reads)."""
    nz, ny, nx = occ.shape
    bdims = (-(-nx // BRICK), -(-ny // BRICK), -(-nz // BRICK))
    build = accel_build.accel_tables if occ.is_cuda else accel_tables_plain
    fine, coarse, l2, tiles = build(occ, bdims, fine_sb)
    org = np.asarray(origin, np.float32)
    key = (float(org[0]), float(org[1]), float(org[2]))
    return BrickAccel(
        coarse=coarse, fine=fine, l2=l2, origin=_origin_on(key, occ.device),
        dims=(nx, ny, nz), bdims=bdims, voxel_size=float(voxel_size),
        origin_key=key, fine_sb=tiles)


def build_accel_slab(occ_slab, z0, full_nz, origin, voxel_size, *,
                     below=None, above=None) -> BrickAccel:
    """BrickAccel of the Z-slab of a larger grid that one device holds
    (voxelray_tpu/ops/traverse_fast.py:152-226).

    occ_slab: (nzs, ny, nx) uint8 tensor, the grid's rows [z0, z0 + nzs),
    z0 a multiple of 8 (rows past the grid are empty).  dims, bdims and
    origin are the full grid's, so every coordinate the walks compute is
    the monolithic accel's.  `coarse` and `l2` are full size with bits
    only in the slab: K3 offers no brick outside it.  `fine` is a window
    of brick ids from `fine_off` on: the slab's contiguous block of
    brick layers, clamped to the grid, and with `below` / `above` (the
    grid's 8 rows under the slab / up to 8 rows over it) one more brick
    layer on that side, the halo.  K4's near-tie probes read cells next
    to the cell they start from, which at the slab's first or last row
    lie in the neighbouring slab; the halo gives them their true words
    (JAX's walk has no probes, so its slab fine table has no halo).  The
    halo's bricks are never walked, so the slab's trace returns the
    monolithic trace's cells in the slab, and through the probes at most
    cells of the halo, which the merge over slabs takes once.  No
    `fine_sb`: the slab accel takes the staged walk.
    """
    if z0 % BRICK:
        raise ValueError(f"slab start z0={z0} is not a multiple of {BRICK}")
    nzs, ny, nx = occ_slab.shape
    dev = occ_slab.device
    bdims = (-(-nx // BRICK), -(-ny // BRICK), -(-full_nz // BRICK))
    bx, by, bz = bdims
    z0b, bzs = z0 // BRICK, -(-nzs // BRICK)
    own = max(0, min(bzs, bz - z0b))            # slab layers in the grid
    bocc_s = (_bricks(occ_slab, bdims) != 0).any(dim=-1)[:own]
    bocc = torch.zeros((bz, by, bx), dtype=torch.bool, device=dev)
    bocc[z0b:z0b + own] = bocc_s

    # the fine window: brick layers [lo, hi) of the rows below + slab +
    # above, clamped to the grid
    lo = z0b - 1 if below is not None and z0b > 0 else min(z0b, bz)
    hi = min(z0b + bzs + (1 if above is not None else 0), bz)
    hi = max(hi, lo)
    rows = torch.zeros(((hi - lo) * BRICK, ny, nx), dtype=torch.uint8,
                       device=dev)

    def place(part, z):
        """Copy occupancy rows starting at global row z into the window."""
        a, b = max(z, lo * BRICK), min(z + part.shape[0], hi * BRICK)
        if b > a:
            rows[a - lo * BRICK:b - lo * BRICK] = part[a - z:b - z]

    if lo < z0b:
        place(below, z0 - below.shape[0])
    place(occ_slab, z0)
    if above is not None:
        place(above, z0 + nzs)
    org = np.asarray(origin, np.float32)
    return BrickAccel(
        coarse=_bitmask_rows(bocc.reshape(-1)),
        fine=_fine_words(_bricks(rows, bdims)), l2=_l2(bocc),
        origin=torch.as_tensor(org.copy(), device=dev),
        dims=(nx, ny, full_nz), bdims=bdims, voxel_size=float(voxel_size),
        origin_key=(float(org[0]), float(org[1]), float(org[2])),
        fine_off=bx * by * lo)


def trace_grid_fast(origins, dirs, accel: BrickAccel, t_min=TMIN,
                    t_max=TMAX, admit=None, return_stats=False, mega=True,
                    k_hits=5, two_level=None):
    """(t, cell_lin) nearest voxel hit; same contract as trace_grid_dda.

    mega=True with an accel that carries fine_sb runs the megakernel K2;
    mega=False (or no fine_sb) the staged walk (staged_march: one kernel
    launch on CUDA tensors, the K3 + K4 lap loop on CPU tensors; any
    other device raises).  admit: optional
    bool mask (batch shape): only admitted rays trace, the others miss.
    t_min/t_max: scalars or per-ray tensors.  k_hits (candidate bricks
    per ray in the first round) and two_level (None = the superbrick
    skip when coarse has more than 4 rows) apply to the staged walk and
    move only its cost.  return_stats=True also returns `unresolved`
    (rays left at the step bound; 0 = provably exhaustive; on CUDA
    tensors a 0-d tensor on the device).
    """
    if mega and accel.fine_sb is not None:
        return trace_grid_mega(origins, dirs, accel, t_min, t_max,
                               admit=admit, return_stats=return_stats)
    batch = origins.shape[:-1]
    dev = origins.device
    if dev.type == "cuda":
        march = staged_march.staged_march_cuda
    elif dev.type == "cpu":
        march = staged_march.staged_march_plain
    else:
        raise ValueError(f"trace_grid_fast: unsupported device {dev}")
    o = origins.reshape(-1, 3).to(torch.float32).contiguous()
    d = dirs.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    tmn = _per_ray(t_min, n, dev).contiguous()
    tmx = _per_ray(t_max, n, dev).contiguous()
    adm = None if admit is None else \
        admit.reshape(-1).to(torch.bool).contiguous()
    trace.count("rays.staged_march", n)
    with trace.span("staged_march"):
        t, lin, unresolved = march(o, d, accel, tmn, tmx, adm, k_hits,
                                   two_level)
    t, lin = t.reshape(batch), lin.reshape(batch)
    if return_stats:
        return t, lin, unresolved
    return t, lin


def any_hit_grid_fast(origins, dirs, accel: BrickAccel, t_min=TMIN,
                      t_max=TMAX, admit=None, mega=True, k_hits=4,
                      two_level=None):
    """True where some voxel accepts along the ray (shadow query).  Both
    backends stop a ray at its first accepted cell, so the nearest trace
    doubles as the any-hit query exactly."""
    t, _ = trace_grid_fast(origins, dirs, accel, t_min, t_max, admit=admit,
                           mega=mega, k_hits=k_hits, two_level=two_level)
    return torch.isfinite(t)
