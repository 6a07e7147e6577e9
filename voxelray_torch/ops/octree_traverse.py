"""Stackless octree ray traversal.

Counterpart of voxelray_tpu/ops/octree_traverse.py.  Per step, each live
ray finds the region holding its current cell, tests it, and advances:

  lookup   one read of the tree's region map (models/octree.py
           build_region_map), then under an INTERNAL entry of a coarse
           map the child-link descent for the remaining levels; a tree
           without a map descends from the root (the JAX package's
           `_trace_octree_impl`).  Either way the region is the deepest
           empty octant (INVALID child, octTree.hpp:271) or occupied leaf
           cube holding the cell, with the octant digits of
           buildNodeRecursive (octTree.hpp:337-345).
  test     on a leaf, the slab test of its first max_items items (past
           max_items a leaf at maximum depth holds copies of one cell),
           accepting t0 where t1 > max(t0, 0), t0 > 0 and
           t_min <= t0 <= t_max; the nearest accepted item wins.
  advance  to max(region exit, t) + 1e-6; the ray ends past the root
           cube's exit or past t_max.

The map walk and the descent visit the same regions with the same float
expressions, so their results are identical.  JAX's TPU schedule (static
rounds of `steps` skips, the drain fraction) shapes when a ray is
stepped, not which regions it visits, and is not ported: here one loop
steps every live ray once per iteration and compacts the live rays
(ops/compact.py).  `max_outer` bounds the steps (regions) per ray; a ray
still live at the bound returns a miss, as in the JAX package.
return_stats=True also returns the most steps (regions) of one ray.

On CUDA tensors the walk is one launch of csrc/octree_walk.cu
(ops/kernels/octree_walk.py): one thread a ray, the same regions, probes
and float expressions, so the same results bit for bit, with no host
sync; the shadow any-hit reads an admit mask there.  CPU tensors take
`_walk`, the loop above; any other device raises.  Each call is a span
"octree_walk" (utils/trace.py) and, while recording, adds to the device
counters octree.rays (the rays walked: the admitted ones of a masked
trace), octree.regions (their region steps) and octree.cut_rays (those
cut by max_outer), from either walk.

Three faults of the JAX walk are repaired here; each loses the nearest
hit that the reference's slab test over every cell finds:
  * the 1e-6 advance jumps over a cell the ray clips for less than that
    (near a corner or an edge, and at the root cube's entry), and cell
    slab planes a few ulps off the region's let a ray clip cells the
    region's planes say it misses: the cells across the planes a
    crossing passes within a few ulps of are probed (`probe`);
  * a leaf's nearest accepted item may lie past the leaf's exit (a ray
    grazing a face): a hit pends until the walk passes it, and the
    nearest pending hit wins;
  * a ray grazing along a face floors back into the region it left and
    crawls by 1e-6 steps until max_outer cuts it: the next cell is
    stepped past every region face the ray has crossed.
Rays with no such crossing take JAX's regions and its results.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.octree import INTERNAL_FLAG, LEAF_FLAG
from ..utils import trace
from .compact import compact_mask
from .geometry import floor_cell
from .intersect import TMAX, TMIN
from .kernels import octree_walk
from .traverse import _per_ray

__all__ = ["trace_octree", "any_hit_octree"]


def _descend(children, node_leaf, node, desc, level0, bits, cx, cy, cz):
    """Child-link descent from `node` at depth level0 for the rays
    `desc` (int64 nodes, cells and children).  Returns (node, log2
    region side, found a leaf)."""
    lg = torch.zeros_like(cx)
    found = torch.zeros_like(desc)
    for level in range(level0, bits):
        shift = bits - 1 - level
        octant = (((cx >> shift) & 1) | (((cy >> shift) & 1) << 1)
                  | (((cz >> shift) & 1) << 2))
        child = children[torch.where(desc, node, 0), octant]
        hit_empty = desc & (child < 0)
        lg = torch.where(hit_empty, bits - (level + 1), lg)
        moved = desc & (child >= 0)
        node = torch.where(moved, child, node)
        hit_leaf = moved & node_leaf[torch.clamp(node, min=0)]
        lg = torch.where(hit_leaf, bits - (level + 1), lg)
        found = found | hit_leaf
        desc = moved & ~hit_leaf
    # depth == bits nodes are leaves by construction (the build splits
    # only while depth < max_depth)
    return node, torch.where(desc, 0, lg), found | desc


def _region(tree, children, node_leaf, cx, cy, cz):
    """(node, log2 region side, is an occupied leaf) of each cell; int64
    cells, children and results."""
    bits = tree.bits_per_axis
    if tree.region_map is None:
        node = torch.zeros_like(cx)
        if bool(node_leaf[0]):
            return node, torch.full_like(cx, bits), \
                torch.ones_like(cx, dtype=torch.bool)
        return _descend(children, node_leaf, node,
                        torch.ones_like(cx, dtype=torch.bool), 0, bits,
                        cx, cy, cz)
    mb = tree.map_bits or bits
    dshift = bits - mb
    side_m = 1 << mb
    lin = ((cx >> dshift) + side_m * ((cy >> dshift)
                                      + side_m * (cz >> dshift)))
    val = tree.region_map[lin].long()
    is_leaf = (val & int(LEAF_FLAG)) != 0
    lg = val & 31
    node = (val >> 5) & ((1 << 25) - 1)
    if dshift:
        # a coarse map: an INTERNAL entry stops at depth map_bits with
        # deeper structure below, so the descent resumes there
        is_int = ~is_leaf & ((val & int(INTERNAL_FLAG)) != 0)
        node_i = torch.where(is_int, (val >> 5) & ((1 << 24) - 1), 0)
        node_i, lg_i, leaf_i = _descend(children, node_leaf, node_i,
                                        is_int, mb, bits, cx, cy, cz)
        is_leaf = is_leaf | (is_int & leaf_i)
        lg = torch.where(is_int, lg_i, lg)
        node = torch.where(is_int, node_i, node)
    return node, lg, is_leaf


def _cell_at(o, d, t, og, vs, side, clamp=True):
    """The int64 cell of the point o + d * t, clamped into the root
    cube; vs a 0-dim tensor (div_scalar's true division)."""
    cell = floor_cell((o + d * t[:, None] - og) / vs).long()
    return torch.clamp(cell, 0, side - 1) if clamp else cell


def _slab(cells, o, inv, og, vs, half):
    """Reference slab t0 / t1 of item cells (raytrace.rint:46-56); cells
    (..., K, >= 3) float32 coordinates."""
    t0 = t1 = None
    for ax in range(3):
        c = og[ax] + (cells[..., ax] + 0.5) * vs
        tb = inv[:, ax:ax + 1] * ((c - half) - o[:, ax:ax + 1])
        tt = inv[:, ax:ax + 1] * ((c + half) - o[:, ax:ax + 1])
        lo, hi = torch.minimum(tb, tt), torch.maximum(tb, tt)
        t0 = lo if t0 is None else torch.maximum(t0, lo)
        t1 = hi if t1 is None else torch.minimum(t1, hi)
    return t0, t1


# the walk advances 1e-6 past each region's exit; the planes crossed
# within that step or within a window around it (TIE_ABS, plus TIE_REL of
# t and of the plane's coordinates over the direction: the few ulps by
# which the cells' own slab planes differ from the region's) bound the
# sliver cells the walk can jump over
TIE_ABS, TIE_REL = 1e-6, 2.0 ** -21
# the non-empty subsets of three axes
_SUBSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
            (0, 1, 1), (1, 1, 1))


def _walk(o, d, tree, tmn, tmx, max_outer):
    """(t, lin, rays cut by max_outer, steps, region steps of all rays)
    over flat (N, 3) rays."""
    n = o.shape[0]
    dev = o.device
    bits = tree.bits_per_axis
    side = 1 << bits
    nx, ny, _ = tree.dims
    max_items = int(tree.max_items)
    vs = float(np.float32(tree.voxel_size))
    half = float(np.float32(0.5) * np.float32(tree.voxel_size))
    og = torch.tensor(tree.origin_key, dtype=torch.float32, device=dev)
    vs_t = torch.tensor(vs, dtype=torch.float32, device=dev)
    children = tree.children.long()
    node_leaf = (children < 0).all(dim=1)
    node_sc = torch.stack([tree.node_start, tree.node_count], dim=1).long()
    items = tree.items4 if tree.items4 is not None else torch.stack(
        [tree.item_x, tree.item_y, tree.item_z], dim=1)
    n_rows = items.shape[0]
    ks = torch.arange(max_items, device=dev)
    inf = float("inf")

    def region_hits(cell, so, sinv, stmn, stmx):
        """(log2 region side, nearest accepted item (t, lin) of the
        region of each cell: inf / -1 unless it is an occupied leaf)."""
        node, lg, is_leaf = _region(tree, children, node_leaf,
                                    *cell.unbind(1))
        tb = torch.full(lg.shape, inf, device=dev)
        lin = torch.full(lg.shape, -1, dtype=torch.int32, device=dev)
        lf = torch.nonzero(is_leaf).reshape(-1)
        if lf.numel():
            sc = node_sc[node[lf]]
            it = items[torch.clamp(sc[:, :1] + ks, max=n_rows - 1)]
            t0, t1 = _slab(it.to(torch.float32), so[lf], sinv[lf], og, vs,
                           half)
            accept = ((ks < sc[:, 1:2]) & (t1 > torch.clamp(t0, min=0.0))
                      & (t0 > 0.0) & (t0 >= stmn[lf, None])
                      & (t0 <= stmx[lf, None]))
            t0m = torch.where(accept, t0, torch.full_like(t0, inf))
            arg = torch.argmin(t0m, dim=1, keepdim=True)
            tb[lf] = t0m.gather(1, arg)[:, 0]
            hit = it.gather(1, arg[..., None].expand(-1, 1, it.shape[-1]))
            hit = hit[:, 0]
            lin[lf] = (hit[:, 0] + nx * (hit[:, 1] + ny * hit[:, 2])
                       ).to(torch.int32)
        return lg, tb, lin

    def probe(base, lo, hi, t_b, so, sd, sinv, stmn, stmx, pt, pl):
        """The sliver cells of a boundary crossing.  `base` is the cell a
        ray leaves at t_b (its region [lo, hi] is left then; at the root
        cube's entry it is the cell outside).  The walk lands 1e-6 later
        and tests only the region there, so a cell the ray clips for less
        than that is jumped over; so is one that the cells' own slab
        planes, a few ulps off the region's, let the ray clip where the
        region's planes say it does not.  Those cells are base stepped
        across a plane of one of its faces that the ray crosses within the
        window around t_b, on one or more axes, outside [lo, hi]; each
        one's region is tested like the walk's, and the nearest accepted
        item pends in (pt, pl)."""
        up = (sd > 0).long()
        fwd = og + (base + up).to(torch.float32) * vs
        back = og + (base + 1 - up).to(torch.float32) * vs
        moving = sd != 0
        t_fwd = torch.where(moving, (fwd - so) * sinv,
                            torch.full_like(so, inf))
        t_back = torch.where(moving, (back - so) * sinv,
                             torch.full_like(so, -inf))
        # per axis: a few ulps of t and of the plane's crossing time, plus
        # those of the crossing at t_b (its earliest plane's)
        win = TIE_ABS + TIE_REL * (t_b.abs()[:, None]
                                   + (fwd.abs() + so.abs()) * sinv.abs())
        win = torch.where(moving, win, torch.zeros_like(win))
        first = torch.argmin((t_fwd - t_b[:, None]).abs(), dim=1,
                             keepdim=True)
        win = win + win.gather(1, first)
        step = up * 2 - 1
        off = torch.where(t_fwd <= t_b[:, None] + 1e-6 + win, step,
                          torch.where(t_back >= t_b[:, None] - win, -step, 0))
        # one crossed plane is the walk's own landing; slivers need two
        pr = torch.nonzero((off != 0).sum(dim=1) >= 2).reshape(-1)
        if pr.numel() == 0:
            return
        m = torch.tensor(_SUBSETS, dtype=torch.bool, device=dev)  # (7, 3)
        off, lo, hi = off[pr, None], lo[pr, None], hi[pr, None]
        pc = base[pr, None] + torch.where(m, off, 0)             # (P, 7, 3)
        use = (((off != 0) | ~m).all(dim=2)
               & ((pc < lo) | (pc > hi)).any(dim=2)
               & ((pc >= 0) & (pc < side)).all(dim=2))
        u = torch.nonzero(use.reshape(-1)).reshape(-1)
        if u.numel() == 0:
            return
        r = pr[u // len(_SUBSETS)]
        _, tb, lin = region_hits(pc.reshape(-1, 3)[u], so[r], sinv[r],
                                 stmn[r], stmx[r])
        # the nearest per ray: sort by t, keep each ray's first
        order = torch.argsort(tb, stable=True)
        r, tb, lin = r[order], tb[order], lin[order]
        first = torch.ones_like(r, dtype=torch.bool)
        key = torch.argsort(r, stable=True)
        rk = r[key]
        first[key[1:]] = rk[1:] != rk[:-1]
        r, tb, lin = r[first], tb[first], lin[first]
        better = tb < pt[r]
        pt[r] = torch.where(better, tb, pt[r])
        pl[r] = torch.where(better, lin, pl[r])

    inv = 1.0 / d
    grid_max = og + torch.full_like(og, float(side)) * vs
    tbot = inv * (og - o)
    ttop = inv * (grid_max - o)
    tn, tf = torch.minimum(tbot, ttop), torch.maximum(tbot, ttop)
    t_enter = torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    t_exit = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    t_cur = torch.clamp(t_enter, min=0.0) + 1e-6
    alive = (t_exit > torch.clamp(t_enter, min=0.0)) & (t_cur <= tmx)

    best_t = torch.full((n,), inf, device=dev)
    best_lin = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx = torch.nonzero(alive).reshape(-1)
    # per live ray: the ray, t_exit, t_min, t_max, t, its cell, pending
    # hit
    s = [x[idx] for x in (o, d, inv, t_exit, tmn, tmx, t_cur)]
    s += [_cell_at(s[0], s[1], s[6], og, vs_t, side), best_t[idx],
          best_lin[idx]]
    # entering the root cube: the base is the cell outside it
    so, sd, sinv, stex, stmn, stmx, st, cell, pt, pl = s
    te = t_enter[idx]
    ent = torch.nonzero(te > 0).reshape(-1)
    if ent.numel():
        base = _cell_at(so[ent], sd[ent], te[ent], og, vs_t, side)
        a_e = torch.argmax(tn[idx[ent]], dim=1, keepdim=True)
        outside = torch.where(sd[ent].gather(1, a_e) > 0, -1, side)
        base = base.scatter(1, a_e, outside)
        sub = [x[ent] for x in (so, sd, sinv, stmn, stmx, pt, pl)]
        probe(base, base, base, te[ent], *sub)
        pt[ent], pl[ent] = sub[5], sub[6]
    steps = regions = 0
    while idx.numel() and steps < max_outer:
        steps += 1
        regions += idx.numel()
        so, sd, sinv, stex, stmn, stmx, st, cell, pt, pl = s
        lg, hit_t, hit_l = region_hits(cell, so, sinv, stmn, stmx)

        # region cube exit (the octant at the stopping level)
        lgc = lg[:, None]
        lo = (cell >> lgc) << lgc
        rmin = og + lo.to(torch.float32) * vs
        ext = (1 << lgc).to(torch.float32) * vs
        t_ax = torch.maximum((rmin - so) * sinv, (rmin + ext - so) * sinv)
        t_ax = torch.where(sd != 0, t_ax, torch.full_like(t_ax, inf))
        t_rex = t_ax.amin(dim=1)
        # a hit pends until the walk passes it: the nearest accepted
        # item of a leaf may lie past the leaf's exit (a grazing ray whose
        # cell slab planes are a few ulps off the region's), and a
        # sliver cell of the crossing may lie before it
        first = hit_t < pt
        pt = torch.where(first, hit_t, pt)
        pl = torch.where(first, hit_l, pl)
        # probe the exit of rays still going and of those whose hit lies
        # within the exit plane's window (a few ulps of its crossing)
        ax0 = torch.argmin(t_ax, dim=1, keepdim=True)
        reach = ((so + sd * t_rex[:, None]).abs() + so.abs()).gather(1, ax0)
        win0 = TIE_ABS + TIE_REL * (t_rex.abs() + (
            reach * sinv.abs().gather(1, ax0))[:, 0])
        go = torch.nonzero(pt > t_rex - win0).reshape(-1)
        if go.numel():
            # the base: the cell the ray leaves its region by
            lo_m = lo[go]
            hi_m = lo_m + (1 << lgc[go]) - 1
            so_m, sd_m, tr = so[go], sd[go], t_rex[go]
            base = torch.minimum(torch.maximum(
                _cell_at(so_m, sd_m, tr, og, vs_t, side, clamp=False), lo_m),
                hi_m)
            sub = [x[go] for x in (sinv, stmn, stmx, pt, pl)]
            probe(base, lo_m, hi_m, tr, so_m, sd_m, *sub)
            pt[go], pl[go] = sub[3], sub[4]

        # a ray ends at a hit before its region's exit, at t_max, or past
        # the root cube
        st = torch.maximum(t_rex, st) + 1e-6
        keep = (pt > t_rex) & (st < stex) & (st <= stmx)
        best_t[idx] = torch.where(keep, best_t[idx], pt)
        best_lin[idx] = torch.where(keep, best_lin[idx], pl)
        # the next cell: at the new t, and past every face of the region
        # whose plane the ray has crossed by then (a ray grazing along a
        # face would otherwise floor back into the region for thousands
        # of 1e-6 steps)
        hi = lo + (1 << lgc) - 1
        crossed = t_ax <= st[:, None]
        nxt = _cell_at(so, sd, st, og, vs_t, side, clamp=False)
        nxt = torch.where(crossed & (sd > 0), torch.maximum(nxt, hi + 1),
                          torch.where(crossed & (sd < 0),
                                      torch.minimum(nxt, lo - 1), nxt))
        keep &= ~(crossed & ((nxt < 0) | (nxt >= side))).any(dim=1)
        cell = torch.clamp(nxt, 0, side - 1)
        n_live = int(keep.sum())
        s = [so, sd, sinv, stex, stmn, stmx, st, cell, pt, pl]
        if n_live < keep.shape[0]:
            sel, _, _, _ = compact_mask(keep, n_live, keep.shape[0])
            idx = idx[sel]
            s = [x[sel] for x in s]
    return best_t, best_lin, int(idx.numel()), steps, regions


def _bound(x, n, dev):
    """A t bound as the kernel takes it: a scalar as it is, else (n,)
    contiguous float32."""
    if not torch.is_tensor(x) and np.ndim(x) == 0:
        return x
    return _per_ray(x, n, dev).contiguous()


def _dispatch(origins, dirs, tree, t_min, t_max, max_outer, admit,
              any_hit, stats):
    """The walk of one call, inside the span "octree_walk": the kernel on
    CUDA tensors, `_walk` over the admitted rays on CPU tensors.  Returns
    (outputs, most region steps of one ray), walk_cuda's outputs in the
    rays' shape; the steps are None unless `stats` (a 0-dim device tensor
    from the kernel, an int from the plain walk).  While recording, adds
    the walk's counters."""
    batch = origins.shape[:-1]
    dev = origins.device
    n = batch.numel()
    if tree.n_items == 0 or tree.bits_per_axis == 0 or n == 0:
        if any_hit:
            out = (torch.zeros(batch, dtype=torch.bool, device=dev),)
        else:
            out = (torch.full(batch, float("inf"), device=dev),
                   torch.full(batch, -1, dtype=torch.int32, device=dev))
        return out, 0 if stats else None
    o = origins.reshape(-1, 3).to(torch.float32)
    d = dirs.reshape(-1, 3).to(torch.float32)
    adm = None if admit is None else admit.reshape(-1)
    with trace.span("octree_walk"):
        if o.is_cuda:
            out, block = octree_walk.walk_cuda(
                o.contiguous(), d.contiguous(), _bound(t_min, n, dev),
                _bound(t_max, n, dev), tree,
                admit=None if adm is None else adm.contiguous(),
                any_hit=any_hit, max_outer=max_outer,
                stats=stats or trace.enabled())
            steps = None if block is None else block[3]
        elif dev.type == "cpu":
            sel = (slice(None) if adm is None
                   else torch.nonzero(adm).squeeze(1))
            t, lin, cut, steps, regions = _walk(
                o[sel], d[sel], tree, _per_ray(t_min, n, dev)[sel],
                _per_ray(t_max, n, dev)[sel], max_outer)
            if any_hit:
                hit = torch.zeros(n, dtype=torch.bool, device=dev)
                hit[sel] = torch.isfinite(t)
                out = (hit,)
            else:
                out = (t, lin)
            block = torch.tensor([t.shape[0], regions, cut, steps])
        else:
            raise ValueError(f"octree walk: unsupported device {dev}")
        if block is not None:
            octree_walk.count(block)
    return (tuple(x.reshape(batch) for x in out),
            steps if stats else None)


def trace_octree(origins, dirs, tree, t_min=TMIN, t_max=TMAX,
                 max_outer=512, return_stats=False):
    """Nearest voxel hit by the octree walk: (t, cell lin), inf / -1 on a
    miss; the cells are linear indices in the tree's dims, like the grid
    backends'.  t_min / t_max are scalars or per ray.  With
    return_stats=True also the most region steps of one ray (a 0-dim
    device tensor from the kernel, an int from the plain walk)."""
    out, steps = _dispatch(origins, dirs, tree, t_min, t_max, max_outer,
                           None, False, return_stats)
    return out + (steps,) if return_stats else out


def any_hit_octree(origins, dirs, tree, t_min=TMIN, t_max=TMAX,
                   max_outer=512, admit=None):
    """Shadow predicate over the octree (bool, the shape of the rays);
    t_max may be per ray.  With an admit mask (bool, the rays' shape)
    only the admitted rays are walked, the others come back False: on
    CUDA tensors the kernel reads the mask itself, on CPU tensors the
    admitted rays are compacted."""
    (hit,), _ = _dispatch(origins, dirs, tree, t_min, t_max, max_outer,
                          admit, True, False)
    return hit
