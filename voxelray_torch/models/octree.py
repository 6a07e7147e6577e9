"""The Morton-coded octree encoding on torch tensors.

Counterpart of voxelray_tpu/models/octree.py, after src/octTree.hpp: every
(triangle, cell) SAT hit becomes a 63-bit Morton code (21 bits per axis),
the codes are sorted, and a flat node array is built by splitting sorted
ranges on the 3-bit octant digit per level.  Semantics kept:

  * bitsPerAxis = ceil(log2(maxDim)) in double math, > 21 raises
    (octTree.hpp:578-585); maxDepth = bitsPerAxis; the root is the
    power-of-two cube bb.min + voxelSize * 2^bits (octTree.hpp:592-594);
  * one item per SAT hit, duplicates kept and sorted, re-emitted by
    get_aabbs (octTree.hpp:374-392);
  * a node is a leaf when depth >= maxDepth or count <= maxItemsPerLeaf
    (default 16, octTree.hpp:328-331, 489);
  * nodes are numbered in pre-order with children visited 0..7
    (buildNodeRecursive, octTree.hpp:319-358); INVALID child = 0xFFFFFFFF
    in build_nodes' output, -1 in the tree's children table.

Octree.from_mesh takes the hit stream on the device
(ops/voxelize.voxelize_hits), Octree.from_grid the cells of a GridVec
made from it (the same hits, no second voxelize); either encodes the
codes as int64 and sorts them with torch.sort there; build_nodes and
build_region_map (numpy copies of the JAX package's functions,
build_nodes with its pre-order renumbering vectorised) run on the host
over the sorted codes.  The
region map is the flattened descent that ops/octree_traverse.py walks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.aabbs import aabbs_from_cells
from ..ops.geometry import grid_dims, mesh_bbox
from ..ops.morton import morton_decode3, morton_encode3
from ..ops.voxelize import voxelize_hits
from ..utils.device import resolve_device

__all__ = ["Octree", "build_nodes", "build_region_map", "INVALID_INDEX",
           "LEAF_FLAG", "INTERNAL_FLAG", "REGION_MAP_MAX_BITS"]

INVALID_INDEX = np.uint32(0xFFFFFFFF)

# region_map encoding: empty region -> log2(cells per side); occupied
# leaf -> LEAF_FLAG | node_id << 5 | log2 (25-bit node id); mixed map
# cell on a COARSE map (map_bits < bits) -> INTERNAL_FLAG | node_id << 5
# | log2 with a 24-bit node id (bit 29 is the flag) — traversal resumes
# the child-link descent below that node for the remaining
# bits - map_bits levels (ops/octree_traverse.py), so grids past the
# dense-map budget (512^3+, VERDICT r3 item 9) keep the flat fast path:
# one map gather plus at most bits - map_bits chase steps per region.
LEAF_FLAG = np.int32(1 << 30)
INTERNAL_FLAG = np.int32(1 << 29)
REGION_MAP_MAX_BITS = 8      # map is side^3 i32: 64 MiB at 2^8 per axis


def build_region_map(children: np.ndarray, bits: int,
                     map_bits: int | None = None) -> np.ndarray:
    """Flatten the octree's region decomposition to a per-cell lookup.

    For every cell of the conceptual 2^map_bits cube, record the region
    the stackless descent would stop at: the deepest empty octant
    (INVALID child, octTree.hpp:271) or occupied leaf cube containing
    the cell — or, when the tree is deeper than the map (map_bits <
    bits), the INTERNAL node at depth map_bits whose subtree the cell
    falls in.  Regions at depth <= map_bits partition the cube in
    coarse-cell multiples, so the map paints each cell exactly once —
    an O(side_m^3) host sweep done once per tree.  Traversal then needs
    ONE gather per step (plus the short residual chase under INTERNAL
    entries) instead of a bits-deep child-link chase
    (ops/octree_traverse.py flat path).

    children: (M, 8) int with -1 for INVALID, pre-order numbered.
    Returns int32[side_m^3] indexed xm + side_m*(ym + side_m*zm) where
    the m coords are full-res cell coords >> (bits - map_bits).  The
    stored log2 region sizes stay in FULL-resolution cells.
    """
    if map_bits is None:
        map_bits = min(bits, REGION_MAP_MAX_BITS)
    assert 0 <= map_bits <= bits
    dshift = bits - map_bits
    side_m = 1 << map_bits
    ch = np.asarray(children, np.int64)
    m = np.empty((side_m * side_m * side_m,), np.int32)
    if len(ch) == 0:
        m[:] = np.int32(bits)      # wholly empty: one root-sized region
        return m
    is_leaf = (ch < 0).all(axis=1)
    oc = np.arange(8, dtype=np.int64)
    odx, ody, odz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1

    def paint(bases_x, bases_y, bases_z, rc, vals):
        # bases/rc in FULL-res cells; depth <= map_bits regions are
        # whole multiples of the coarse cell, so the >> is exact
        if len(bases_x) == 0:
            return
        rcm = rc >> dshift
        off = np.arange(rcm, dtype=np.int64)
        x = (bases_x >> dshift)[:, None, None, None] + off[None, None,
                                                           None, :]
        y = (bases_y >> dshift)[:, None, None, None] + off[None, None,
                                                           :, None]
        z = (bases_z >> dshift)[:, None, None, None] + off[None, :,
                                                           None, None]
        lin = (x + side_m * (y + side_m * z)).reshape(len(bases_x), -1)
        m[lin.reshape(-1)] = np.repeat(vals.astype(np.int32), rcm ** 3)

    nodes = np.array([0], np.int64)
    bx = np.array([0], np.int64)
    by = np.array([0], np.int64)
    bz = np.array([0], np.int64)
    for depth in range(map_bits + 1):
        if len(nodes) == 0:
            break
        rc = (1 << bits) >> depth
        lg = bits - depth
        leaf = is_leaf[nodes]
        paint(bx[leaf], by[leaf], bz[leaf], rc,
              LEAF_FLAG | (nodes[leaf].astype(np.int32) << 5)
              | np.int32(lg))
        pn = nodes[~leaf]
        pbx, pby, pbz = bx[~leaf], by[~leaf], bz[~leaf]
        if len(pn) == 0:
            break
        if depth == map_bits:
            # deeper structure than the map resolves: hand traversal the
            # internal node to resume the child-link descent from
            assert pn.max() < (1 << 24), "internal node id exceeds 24 bits"
            paint(pbx, pby, pbz, rc,
                  INTERNAL_FLAG | (pn.astype(np.int32) << 5)
                  | np.int32(lg))
            break
        half = rc >> 1
        sub = ch[pn]                               # (K, 8)
        cbx = (pbx[:, None] + odx[None, :] * half).reshape(-1)
        cby = (pby[:, None] + ody[None, :] * half).reshape(-1)
        cbz = (pbz[:, None] + odz[None, :] * half).reshape(-1)
        flat = sub.reshape(-1)
        empty = flat < 0
        paint(cbx[empty], cby[empty], cbz[empty], half,
              np.full(int(empty.sum()), lg - 1, np.int32))
        nodes = flat[~empty]
        bx, by, bz = cbx[~empty], cby[~empty], cbz[~empty]
    return m


def build_nodes(codes_sorted: np.ndarray, max_depth: int,
                max_items: int) -> np.ndarray:
    """Flat node array from sorted Morton codes (host, vectorized per level).

    Returns int64 array (M, 10): columns 0..7 children (INVALID as
    0xFFFFFFFF), 8 start, 9 count — pre-order numbered like the recursive
    reference build.
    """
    n = len(codes_sorted)
    if n == 0 and max_depth == 0:
        return np.zeros((0, 10), np.int64)

    # level-order construction -------------------------------------------
    # each node: (begin, end, depth); splittable nodes expand per level
    begins = [np.array([0], np.int64)]
    ends = [np.array([n], np.int64)]
    parents = [np.array([-1], np.int64)]   # parent row in previous level
    octants = [np.array([0], np.int64)]    # which child slot of the parent

    codes = codes_sorted.astype(np.uint64)
    level_rows = []  # (begin, end, parent_global_idx, octant)

    cur_b, cur_e = begins[0], ends[0]
    cur_parent = parents[0]
    cur_oct = octants[0]
    all_b, all_e, all_parent, all_oct, all_depth = [], [], [], [], []
    global_offset = 0

    for depth in range(max_depth + 1):
        k = len(cur_b)
        if k == 0:
            break
        all_b.append(cur_b)
        all_e.append(cur_e)
        all_parent.append(cur_parent)
        all_oct.append(cur_oct)
        all_depth.append(np.full(k, depth, np.int64))

        counts = cur_e - cur_b
        split = (depth < max_depth) & (counts > max_items)
        idx_split = np.flatnonzero(split)
        if len(idx_split) == 0 or depth == max_depth:
            cur_b = np.zeros(0, np.int64)
            cur_e = np.zeros(0, np.int64)
            cur_parent = np.zeros(0, np.int64)
            cur_oct = np.zeros(0, np.int64)
            global_offset += k
            continue

        shift = np.uint64(3 * (max_depth - 1 - depth))
        keys = (codes >> shift)  # sorted; low 3 bits = octant at this level
        # prefix of each splitting node (bits above this level)
        pref = (codes[cur_b[idx_split]] >> (shift + np.uint64(3)))
        # child boundaries: searchsorted for prefix*8 + c, c = 0..8
        q = (pref[:, None].astype(np.uint64) << np.uint64(3)) \
            + np.arange(9, dtype=np.uint64)[None, :]
        bounds = np.searchsorted(keys, q)  # (S, 9)
        bounds = np.clip(bounds, cur_b[idx_split][:, None],
                         cur_e[idx_split][:, None])
        cb = bounds[:, :8].reshape(-1)
        ce = bounds[:, 1:].reshape(-1)
        child_oct = np.tile(np.arange(8, dtype=np.int64), len(idx_split))
        child_parent = np.repeat(global_offset + idx_split, 8)
        keep = ce > cb  # only non-empty octants become nodes
        cur_b, cur_e = cb[keep], ce[keep]
        cur_parent, cur_oct = child_parent[keep], child_oct[keep]
        global_offset += k

    b = np.concatenate(all_b)
    e = np.concatenate(all_e)
    parent = np.concatenate(all_parent)
    octant = np.concatenate(all_oct)
    m = len(b)

    # children table in level order
    children = np.full((m, 8), np.int64(INVALID_INDEX))
    child_rows = np.flatnonzero(parent >= 0)
    children[parent[child_rows], octant[child_rows]] = child_rows

    # pre-order renumbering (children visited 0..7), level by level: the
    # JAX package walks a Python stack over every node here (~10 s at
    # the bench's 1M nodes); a node's pre-order rank is its parent's
    # plus one plus the subtree sizes of its earlier siblings, which sit
    # before it in the level order, grouped by parent in octant order
    depth = np.concatenate(all_depth)
    size = np.ones(m, np.int64)
    for dl in range(int(depth.max()), 0, -1):
        lv = np.flatnonzero(depth == dl)
        np.add.at(size, parent[lv], size[lv])
    before = np.cumsum(size) - size         # level order: siblings adjoin
    first = np.r_[True, parent[1:] != parent[:-1]]
    group_start = np.maximum.accumulate(np.where(first, np.arange(m), 0))
    offset = before - before[group_start]
    rank = np.zeros(m, np.int64)            # rank[old] = new
    for dl in range(1, int(depth.max()) + 1):
        lv = np.flatnonzero(depth == dl)
        rank[lv] = rank[parent[lv]] + 1 + offset[lv]
    order = np.empty(m, np.int64)           # order[new] = old
    order[rank] = np.arange(m)

    out = np.full((m, 10), np.int64(INVALID_INDEX))
    old_children = children[order]
    valid = old_children != np.int64(INVALID_INDEX)
    out[:, :8] = np.where(valid, rank[np.clip(old_children, 0, m - 1)],
                          np.int64(INVALID_INDEX))
    out[:, 8] = b[order]
    out[:, 9] = (e - b)[order]
    return out


def _children_table(nodes: np.ndarray) -> np.ndarray:
    """build_nodes' child columns with INVALID as -1, int32."""
    ch = nodes[:, :8]
    return np.where(ch == np.int64(INVALID_INDEX), -1, ch).astype(np.int32)


def _items4(ix, iy, iz, max_items):
    """Packed (x, y, z, 0) item rows, padded by max_items rows."""
    n = int(ix.shape[0])
    it4 = torch.zeros((max(n, 1) + max_items, 4), dtype=torch.int32,
                      device=ix.device)
    it4[:n, 0], it4[:n, 1], it4[:n, 2] = ix, iy, iz
    return it4


def _bits(dims):
    """bitsPerAxis: ceil(log2(maxDim)) in double precision, more than 21
    raises (octTree.hpp:578-585)."""
    bits = int(math.ceil(math.log2(float(max(dims)))))
    if bits > 21:
        raise ValueError("We support up to 21 bits per axis "
                         "(max 2^21 voxels per dimension)!")
    return bits


@dataclass(frozen=True)
class Octree:
    """Flat Morton octree as tensors on one device."""

    codes: Any                      # int64[N] sorted 63-bit Morton codes
    item_x: Any                     # int32[N] decoded cell coords, in
    item_y: Any                     # sorted-code order
    item_z: Any
    children: Any                   # int32[M, 8], -1 == INVALID
    node_start: Any                 # int32[M]
    node_count: Any                 # int32[M]
    root_min: np.ndarray            # float32[3] (== mesh bb.min), host
    dims: tuple
    voxel_size: float
    bits_per_axis: int
    max_items: int
    origin_key: tuple = (0.0, 0.0, 0.0)
    set_calls: int = 0
    region_map: Any = None          # int32[side_m^3] (build_region_map)
    items4: Any = None              # int32[>= N + max_items, 4] item rows
    map_bits: int = 0               # region map granularity (< bits: its
                                    # INTERNAL entries resume the descent)

    @classmethod
    def from_arrays(cls, codes, nodes, root_min, dims, voxel_size, bits,
                    max_items, set_calls, device):
        """A tree from sorted int64 codes (a tensor) and build_nodes'
        (M, 10) rows, with its region map and item rows."""
        ix, iy, iz = (c.to(torch.int32) for c in morton_decode3(codes))
        ch = _children_table(nodes)
        region_map, items4, map_bits = None, None, 0
        if bits > 0:
            map_bits = min(bits, REGION_MAP_MAX_BITS)
            region_map = torch.as_tensor(
                build_region_map(ch, bits, map_bits), device=device)
            items4 = _items4(ix, iy, iz, int(max_items))
        root_min = np.asarray(root_min, np.float32).copy()
        return cls(
            codes=codes, item_x=ix, item_y=iy, item_z=iz,
            children=torch.as_tensor(ch, device=device),
            node_start=torch.as_tensor(nodes[:, 8].astype(np.int32),
                                       device=device),
            node_count=torch.as_tensor(nodes[:, 9].astype(np.int32),
                                       device=device),
            root_min=root_min, dims=tuple(int(x) for x in dims),
            voxel_size=float(voxel_size), bits_per_axis=int(bits),
            max_items=int(max_items),
            origin_key=tuple(float(x) for x in root_min),
            set_calls=int(set_calls), region_map=region_map, items4=items4,
            map_bits=map_bits)

    @classmethod
    def from_mesh(cls, vertices, faces, voxel_size, max_items_per_leaf=16,
                  bb_min=None, bb_max=None, *, device=None):
        """Octree of a numpy mesh built on `device` (default: the card)."""
        device = resolve_device(device)
        v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        f = np.asarray(faces).reshape(-1, 3)
        if bb_min is None or bb_max is None:
            bb_min, bb_max = mesh_bbox(v)
        bb_min = np.asarray(bb_min, np.float32)
        bb_max = np.asarray(bb_max, np.float32)
        dims = grid_dims(bb_min, bb_max, voxel_size)
        max_dim = max(dims)
        empty = torch.zeros((0,), dtype=torch.int64, device=device)
        if max_dim == 0 or len(f) == 0:
            return cls.from_arrays(empty, np.zeros((0, 10), np.int64),
                                   bb_min, dims, voxel_size, 0,
                                   max_items_per_leaf, 0, device)
        bits = _bits(dims)
        r = voxelize_hits(v, f, voxel_size, bb_min=bb_min, bb_max=bb_max,
                          device=device)
        return cls._of_hits(r["lin"], bb_min, dims, voxel_size, bits,
                            max_items_per_leaf, r["set_calls"], device)

    @classmethod
    def _of_hits(cls, lin, root_min, dims, voxel_size, bits, max_items,
                 set_calls, device):
        """The tree of a hit stream's cells (int64 linear indices in dims,
        duplicates kept): their Morton codes sorted on the device, the
        nodes and the region map built on the host."""
        nx, ny, _ = dims
        codes = morton_encode3(lin % nx, (lin // nx) % ny, lin // (nx * ny))
        codes = torch.sort(codes).values
        nodes = build_nodes(codes.cpu().numpy().astype(np.uint64), bits,
                            int(max_items))
        return cls.from_arrays(codes, nodes, root_min, dims, voxel_size,
                               bits, max_items, set_calls, device)

    @classmethod
    def from_grid(cls, grid, max_items_per_leaf=16):
        """Octree of a GridVec's boxes, on its device: one item per box,
        duplicates included, from the boxes' cells (GridVec.cells), with no
        second voxelize.  At the voxel size and box the list was made with
        it equals from_mesh's tree field by field (from_mesh's items are
        the same SAT hits); a list without boxes gives the empty tree."""
        dims = tuple(int(x) for x in grid.dims)
        device = grid.aabbs.device
        root_min = np.asarray(grid.origin, np.float32)
        if max(dims) == 0 or grid.aabbs.shape[0] == 0:
            return cls.from_arrays(
                torch.zeros((0,), dtype=torch.int64, device=device),
                np.zeros((0, 10), np.int64), root_min, dims,
                grid.voxel_size, 0, max_items_per_leaf, 0, device)
        bits = _bits(dims)
        return cls._of_hits(grid.cells(), root_min, dims, grid.voxel_size,
                            bits, max_items_per_leaf, grid.set_calls, device)

    @property
    def origin(self):
        """Grid origin (== mesh bb.min), so an Octree can stand in for
        the grid encodings in scene assembly."""
        return self.root_min

    @property
    def device(self):
        return self.codes.device

    @property
    def n_items(self):
        return int(self.codes.shape[0])

    @property
    def n_nodes(self):
        return int(self.node_start.shape[0])

    @property
    def root_bounds(self):
        """Power-of-two cube [min, min + vs*2^bits] (octTree.hpp:592-594)."""
        mn = np.asarray(self.root_min, np.float32)
        extent = np.float32(self.voxel_size) * np.float32(
            np.uint32(1) << np.uint32(self.bits_per_axis))
        return mn, mn + extent

    def codes_u64(self) -> np.ndarray:
        return self.codes.cpu().numpy().astype(np.uint64)

    def get_aabbs(self):
        """One AABB per item (duplicates included) in sorted-code order,
        the DFS leaf emission of octTree.hpp:374-392."""
        return aabbs_from_cells(self.item_x, self.item_y, self.item_z,
                                self.root_min, self.voxel_size)

    def occupancy(self):
        """Dense (Z, Y, X) uint8 occupancy on the tree's device."""
        nx, ny, nz = self.dims
        occ = torch.zeros(nz * ny * nx, dtype=torch.uint8,
                          device=self.device)
        if self.n_items:
            x, y, z = (c.to(torch.int64)
                       for c in (self.item_x, self.item_y, self.item_z))
            occ[x + nx * (y + ny * z)] = 1
        return occ.reshape(nz, ny, nx)

    def memory_usage_bytes(self):
        # items * sizeof(Item{u64}) + nodes * sizeof(Node{8*u32+2*u32})
        return self.n_items * 8 + self.n_nodes * 40
