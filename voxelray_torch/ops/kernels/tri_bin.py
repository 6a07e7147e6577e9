"""tri_bin: a deforming mesh's triangle table and its triangle accel's
tables, written by the binning (csrc/tri_bin.cu), and their wrapper.

Replaces no Pallas kernel (csrc/tri_bin.cu says why it exists).  The
step's triangle table, then a counting sort of every SAT hit of the
triangles' clamped windows in the tri grid (K1's window and SAT) into the
accel's rows, in three calls around the caller's one copy of the sizes:

  corners(verts, corners)
        (tri9 (F + 1, 9) float32: each face's corners v0 | v1 | v2, then a
         zero row; v0, v1, v2 (F, 3) each; flat (F, 3): the flat face
         normals; area (F,)) of (V, 3) float32 vertices and the faces'
         (3F,) int64 vertex indices
  count(tri9, n_tri, origin, vs, dims, lo, hi)
        (cell_count (X*Y*Z,) int32: each cell's hits, sizes (8,) int64:
         the sizes block, zero but its word SIZES.index("outside"), the
         triangles with a coordinate outside the box [lo, hi] or not a
         number)
  cells(cell_count, sizes, widths)
        (cell_slot (X*Y*Z + 1,) int32: each cell's row, in ascending cell
         order, -1 for an empty cell and at the end; mask (X*Y*Z,) uint8:
         1 where the cell is nonempty), and the sizes block's other words
         added (SIZES: the pairs, the nonempty cells, the widest cell, the
         cells wider than widths[0] and than widths[1], and `wide`, the
         cells longer than the rows pass's warp path, WARP_ROW)
  rows(tri9, n_tri, origin, vs, dims, cell_slot, n_rows, l_width, wide)
        cell_tris (n_rows, l_width) int32: row cell_slot[lin] holds cell
        lin's triangles in ascending id, then -1; l_width at least the
        widest cell, `wide` the sizes' word

tri9 is the accel's (F + 1, 9) float32 triangle table (row F the pad);
rows past `n_tri` are not read.  The four calls take CUDA tensors and
launch the kernels, each entry point adding 1 to its counter
`launches.<entry>` (utils/trace.py): corners `tri_corners`, count
`tri_bin_count`, cells `tri_cells`, rows `tri_bin_emit` (each hit into
its row) and `tri_rows` (the rows ordered), and `tri_rows_wide` where
`wide` (the longer rows ordered, in shared memory up to L_WIDTHS[1]
entries, else in place).  No call syncs: the caller reads the sizes block
between cells and rows.  The plain PyTorch versions, which take any
device, are the kernels' bit-for-bit reference and the path of CPU
tensors, whose callers pick them (`corners_plain`, `count_plain`,
`cells_plain`, `rows_plain` over `emit_plain`'s pairs, the serial hit
stream).  `corners_args`, `count_args`, `cells_args` and `rows_args` build
a pass's argument block on any device, so the host build of the kernels
(tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..voxelize import _window_hits, hit_stream
# K1's: the kernels index cells, triangle ids and rows in int32
from .voxel_accum import check_sizes
from ._build import F, I, P, fields, launch, need, on_cuda

__all__ = ["corners", "count", "cells", "rows", "corners_plain",
           "count_plain", "cells_plain", "rows_plain", "emit_plain",
           "sizes_plain", "corners_args", "count_args", "cells_args",
           "rows_args", "row_passes", "check_sizes", "TriBinArgs",
           "TriCornersArgs", "SIZES", "WARP_ROW"]

# the sizes block's words (csrc/tri_bin.cu's kPairs ... kWide), one int64
# each, and one spare
SIZES = ("pairs", "nonempty", "widest", "over0", "over1", "outside", "wide")
# the fewest cells of a chunk of the cells pass (csrc/tri_bin.cu's
# kLaneCells, a chunk on one-lane warps)
CHUNK_MIN = 64
# the longest row the rows pass's warp path orders (csrc/tri_bin.cu's
# kWarpRow); a longer one takes its wide path
WARP_ROW = 64


class TriBinArgs(ctypes.Structure):
    """csrc/tri_bin.cu's TriBinArgs."""
    SIZES = ("tri_bin_sizes", 0)
    _fields_ = fields((P, "tri"), (I, "n_tri"), (F, "ogx ogy ogz vs half"),
                      (I, "nx ny nz"), (F, "lox loy loz hix hiy hiz"),
                      (I, "w0 w1 n_rows l_width"),
                      (P, "cell_count sizes status cell_slot mask cursor "
                           "cell_tris"))


class TriCornersArgs(ctypes.Structure):
    """csrc/tri_bin.cu's TriCornersArgs."""
    SIZES = ("tri_bin_sizes", 1)
    _fields_ = fields((P, "verts corners"), (I, "n_tri"),
                      (P, "tri9 v0 v1 v2 flat area"))


def _tri_rows(tri9, n_tri):
    return tri9[:n_tri].reshape(n_tri, 3, 3)


def sizes_plain(tri9, n_tri, lo, hi):
    """The sizes block as the count pass leaves it: zero but its outside
    word, the triangles with a coordinate outside [lo, hi] or not a number
    (which fails both comparisons)."""
    box = [torch.as_tensor(np.asarray(b, np.float32), device=tri9.device)
           for b in (lo, hi)]
    tri = _tri_rows(tri9, n_tri)
    inside = ((tri >= box[0]) & (tri <= box[1])).flatten(1).all(dim=1)
    sizes = torch.zeros((8,), dtype=torch.int64, device=tri9.device)
    sizes[SIZES.index("outside")] = (~inside).sum()
    return sizes


def count_plain(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """The count pass in plain PyTorch on tri9's device (it syncs: the
    window slots are sized on the host)."""
    nx, ny, nz = dims
    cell_count = torch.zeros((nx * ny * nz,), dtype=torch.int64,
                             device=tri9.device)
    for _, lin, hit in _window_hits(_tri_rows(tri9, n_tri), origin,
                                    voxel_size, dims):
        cell_count += torch.bincount(lin[hit], minlength=nx * ny * nz)
    return cell_count.to(torch.int32), sizes_plain(tri9, n_tri, lo, hi)


def cells_plain(cell_count, sizes, widths):
    """The cells pass in plain PyTorch on cell_count's device: (cell_slot,
    mask), and the words of `sizes` but its outside word written."""
    nonempty = cell_count > 0
    cell_slot = torch.full((cell_count.numel() + 1,), -1, dtype=torch.int32,
                           device=cell_count.device)
    cell_slot[:-1] = torch.where(
        nonempty, torch.cumsum(nonempty, 0, dtype=torch.int32) - 1, -1)
    c = cell_count.long()
    words = {"pairs": c.sum(), "nonempty": nonempty.sum(), "widest": c.max(),
             "over0": (c > widths[0]).sum(), "over1": (c > widths[1]).sum(),
             "wide": (c > WARP_ROW).sum()}
    for name, x in words.items():
        sizes[SIZES.index(name)] = x
    return cell_slot, nonempty.view(torch.uint8)


def emit_plain(tri9, n_tri, origin, voxel_size, dims):
    """Every SAT hit the emit pass writes, as (tri_id, lin) int32 pairs in
    serial emission order (ops/voxelize.hit_stream)."""
    t, lin = hit_stream(_tri_rows(tri9, n_tri), origin, voxel_size, dims)
    return t.to(torch.int32), lin.to(torch.int32)


def rows_plain(pair_tri, pair_lin, cell_slot, n_rows, l_width):
    """The emit and rows passes in plain PyTorch on the pairs' device:
    cell_tris from the pairs sorted by (lin, tri_id), each cell's row its
    triangles up to the first l_width (its lowest ids), then -1."""
    dev = pair_lin.device
    lin = pair_lin.long()
    cell_tris = torch.full((n_rows, l_width), -1, dtype=torch.int32,
                           device=dev)
    if not lin.numel():
        return cell_tris
    # each pair's place in its cell's run
    first = torch.ones_like(lin, dtype=torch.bool)
    first[1:] = lin[1:] != lin[:-1]
    at = torch.arange(lin.numel(), device=dev)
    within = at - torch.cummax(torch.where(first, at, 0), 0).values
    keep = within < l_width
    cell_tris[cell_slot[lin[keep]].long(), within[keep]] = \
        pair_tri[keep].to(torch.int32)
    return cell_tris


def corners_plain(verts, corners):
    """The corners pass in plain PyTorch on verts' device (module
    docstring); flat and area in the numpy expressions of the loader's
    flat normals (io/objload.py: cross, norm, guarded divide) and of
    models/scene._tri_lod, the norm's square root taken in float64, which
    rounds to the IEEE float32 root on every device."""
    tri9 = torch.cat([verts[corners].reshape(-1, 9),
                      torch.zeros((1, 9), device=verts.device)])
    tri = tri9[:-1].reshape(-1, 3, 3)
    v0, v1, v2 = (tri[:, k].contiguous() for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    sq = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    norm = torch.sqrt(sq.double()).float()[:, None]
    flat = torch.where(norm > 0, n / torch.clamp(norm, min=1e-30), n)
    return tri9, v0, v1, v2, flat, 0.5 * norm[:, 0]


def corners_args(verts, corners):
    """(the corners pass's block, (tri9, v0, v1, v2, flat, area)) on verts'
    device, the outputs unwritten.  verts: a contiguous (V, 3) float32
    tensor; corners: a contiguous (3F,) int64 tensor of indices into it,
    checked by the caller."""
    dev, f32 = verts.device, torch.float32
    n_tri = corners.numel() // 3
    a = TriCornersArgs(
        verts=need("tri_bin", "verts", verts, dev, f32, (verts.shape[0], 3)),
        corners=need("tri_bin", "corners", corners, dev, torch.int64,
                     (3 * n_tri,)), n_tri=n_tri)
    outs = (torch.empty((n_tri + 1, 9), dtype=f32, device=dev),
            *(torch.empty((n_tri, 3), dtype=f32, device=dev)
              for _ in range(4)),
            torch.empty((n_tri,), dtype=f32, device=dev))
    a.tri9, a.v0, a.v1, a.v2, a.flat, a.area = (x.data_ptr() for x in outs)
    return a, outs


def _geometry(tri9, n_tri, origin, voxel_size, dims):
    """A block with the triangles and the grid filled."""
    if tri9.dim() != 2 or tri9.shape[1] != 9 or tri9.shape[0] < n_tri:
        raise ValueError(f"tri_bin: tri9 must be a contiguous (>= {n_tri}, "
                         f"9) float32 tensor, got {tuple(tri9.shape)} "
                         f"{tri9.dtype}")
    check_sizes(dims, n_tri)
    a = TriBinArgs(tri=need("tri_bin", "tri9", tri9, tri9.device,
                            torch.float32), n_tri=n_tri)
    a.ogx, a.ogy, a.ogz = (float(x) for x in np.asarray(origin, np.float32))
    a.vs = float(np.float32(voxel_size))
    a.half = float(np.float32(voxel_size * 0.5))
    a.nx, a.ny, a.nz = (int(x) for x in dims)
    return a


def count_args(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """(the count pass's block, (cell_count, sizes)) on tri9's device, the
    outputs unwritten.  tri9: a contiguous (>= n_tri, 9) float32
    tensor."""
    a = _geometry(tri9, n_tri, origin, voxel_size, dims)
    a.lox, a.loy, a.loz = (float(x) for x in np.asarray(lo, np.float32))
    a.hix, a.hiy, a.hiz = (float(x) for x in np.asarray(hi, np.float32))
    outs = (torch.empty((a.nx * a.ny * a.nz,), dtype=torch.int32,
                        device=tri9.device),
            torch.empty((8,), dtype=torch.int64, device=tri9.device))
    a.cell_count, a.sizes = (x.data_ptr() for x in outs)
    return a, outs


def cells_args(cell_count, sizes, widths):
    """(the cells pass's block, (cell_slot, mask)) on cell_count's device,
    the outputs unwritten; the chunks' status words are kept on the
    block."""
    dev, n = cell_count.device, cell_count.numel()
    a = TriBinArgs(nx=n, ny=1, nz=1, w0=int(widths[0]), w1=int(widths[1]))
    a.cell_count = need("tri_bin", "cell_count", cell_count, dev,
                        torch.int32, (n,))
    a.sizes = need("tri_bin", "sizes", sizes, dev, torch.int64, (8,))
    # scratch, kept alive by the block until its launch
    a.scratch = torch.empty((-(-n // CHUNK_MIN) + 1,), dtype=torch.int64,
                            device=dev)
    outs = (torch.empty((n + 1,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.uint8, device=dev))
    a.status = a.scratch.data_ptr()
    a.cell_slot, a.mask = (x.data_ptr() for x in outs)
    return a, outs


def rows_args(tri9, n_tri, origin, voxel_size, dims, cell_slot, n_rows,
              l_width):
    """(the emit and rows passes' block, cell_tris) on tri9's device,
    cell_tris unwritten; the rows' cursors are kept on the block."""
    a = _geometry(tri9, n_tri, origin, voxel_size, dims)
    a.cell_slot = need("tri_bin", "cell_slot", cell_slot, tri9.device,
                       torch.int32, (a.nx * a.ny * a.nz + 1,))
    a.n_rows, a.l_width = n_rows, l_width
    # scratch, kept alive by the block until its launches
    a.scratch = torch.empty((n_rows,), dtype=torch.int32, device=tri9.device)
    cell_tris = torch.empty((n_rows, l_width), dtype=torch.int32,
                            device=tri9.device)
    a.cursor, a.cell_tris = a.scratch.data_ptr(), cell_tris.data_ptr()
    return a, cell_tris


def row_passes(wide):
    """The entry points that fill the rows, in order: the emit pass, the
    rows pass and, where `wide` (the sizes block's word) is not 0, its
    wide path."""
    return ("tri_bin_emit", "tri_rows") + (("tri_rows_wide",) if wide
                                          else ())


def corners(verts, corners):
    """The corners pass on the card (module docstring)."""
    on_cuda("tri_bin.corners", verts.device)
    a, outs = corners_args(verts, corners)
    launch("tri_corners", a, verts.device)
    return outs


def count(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """The count pass on the card (module docstring)."""
    on_cuda("tri_bin.count", tri9.device)
    a, outs = count_args(tri9, n_tri, origin, voxel_size, dims, lo, hi)
    launch("tri_bin_count", a, tri9.device)
    return outs


def cells(cell_count, sizes, widths):
    """The cells pass on the card (module docstring)."""
    on_cuda("tri_bin.cells", cell_count.device)
    a, outs = cells_args(cell_count, sizes, widths)
    launch("tri_cells", a, cell_count.device)
    return outs


def rows(tri9, n_tri, origin, voxel_size, dims, cell_slot, n_rows, l_width,
         wide):
    """The emit and rows passes on the card (module docstring)."""
    on_cuda("tri_bin.rows", tri9.device)
    a, cell_tris = rows_args(tri9, n_tri, origin, voxel_size, dims,
                             cell_slot, n_rows, l_width)
    for entry in row_passes(wide):
        launch(entry, a, tri9.device)
    return cell_tris
