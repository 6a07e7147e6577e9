"""The octree walk (csrc/octree_walk.cu) and its wrapper.

Replaces the host-stepped region loop of ops/octree_traverse.py `_walk`
on CUDA tensors: one launch a trace, one thread a ray, with `_walk`'s
results bit for bit.  `walk_cuda` gives the nearest hit (t, cell lin) per
ray, +inf / -1 on a miss; with `any_hit` the occlusion (bool) instead,
and with an `admit` mask only the admitted rays walk (the others come
back as misses, not occluded) with no compaction and no host sync.

The tables are the tree's own tensors (region_map, children, node_start,
node_count, items4); nothing is built a call but the outputs.  Each launch adds 1 to the
counter `launches.octree_walk` (utils/trace.py).  `walk_args` builds a
launch's argument block on any device, so the host build of the kernel
(tests/) runs the same blocks.  The plain version is `_walk` itself,
which CPU tensors take (ops/octree_traverse.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...models.octree import _items4
from ...utils import trace
from ._build import F, I, P, fields, launch, need, on_cuda

__all__ = ["walk_cuda", "walk_args", "relaunch", "count", "OctreeWalkArgs",
           "STATS"]

# the words of the stats block, in the kernel's order
STATS = ("rays", "regions", "cut_rays", "most_regions")


class OctreeWalkArgs(ctypes.Structure):
    """csrc/octree_walk.cu's OctreeWalkArgs."""
    SIZES = ("octree_walk_sizes", 0)
    _fields_ = fields((P, "o d t_min t_max admit region_map children "
                          "node_start node_count items"),
                      (I, "n bits map_bits max_items max_outer nx ny"),
                      (F, "t_lo t_hi ogx ogy ogz vs half"),
                      (P, "t_out lin_out hit_out stats"))


def walk_args(o, d, t_min, t_max, tree, *, admit=None, any_hit=False,
              max_outer=512, stats=False):
    """(the argument block, outputs, stats) of a launch.  o, d: (N, 3)
    float32; t_min, t_max: (N,) float32 tensors or scalars; admit: None
    or (N,) bool.  Outputs: (t (N,) float32, lin (N,) int32) or, with
    any_hit, (hit (N,) bool,); stats: the stats block ((4,) int64,
    zeroed, STATS' words) or None; on o's device, the outputs
    unwritten."""
    dev, n = o.device, o.shape[0]
    f32, what = torch.float32, "octree_walk"
    a = OctreeWalkArgs(n=n, max_outer=int(max_outer))
    a.o = need(what, "o", o, dev, f32, (n, 3))
    a.d = need(what, "d", d, dev, f32, (n, 3))
    for name, x in (("t_min", t_min), ("t_max", t_max)):
        if torch.is_tensor(x):
            setattr(a, name, need(what, name, x, dev, f32, (n,)))
        else:
            setattr(a, "t_lo" if name == "t_min" else "t_hi",
                    float(np.float32(x)))
    if admit is not None:
        a.admit = need(what, "admit", admit, dev, torch.bool, (n,))
    if tree.region_map is not None:
        a.region_map = need(what, "region_map", tree.region_map, dev,
                            torch.int32)
    a.children = need(what, "children", tree.children, dev, torch.int32)
    a.node_start = need(what, "node_start", tree.node_start, dev,
                        torch.int32)
    a.node_count = need(what, "node_count", tree.node_count, dev,
                        torch.int32)
    # a tree without item rows (one made field by field) gets them here
    items = tree.items4 if tree.items4 is not None else _items4(
        tree.item_x, tree.item_y, tree.item_z, int(tree.max_items))
    a.items = need(what, "items", items, dev, torch.int32)
    if n >= 2 ** 31 - 256:
        raise ValueError(f"{what}: {n} rays exceed int32 ray indexing")
    bits = tree.bits_per_axis
    a.bits, a.map_bits = bits, tree.map_bits or bits
    a.max_items = int(tree.max_items)
    a.nx, a.ny = tree.dims[0], tree.dims[1]
    vs = np.float32(tree.voxel_size)
    a.ogx, a.ogy, a.ogz = tree.origin_key
    a.vs, a.half = float(vs), float(np.float32(0.5) * vs)
    if any_hit:
        outs = (torch.empty((n,), dtype=torch.bool, device=dev),)
        a.hit_out = outs[0].data_ptr()
    else:
        outs = (torch.empty((n,), dtype=f32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev))
        a.t_out, a.lin_out = (x.data_ptr() for x in outs)
    block = torch.zeros((len(STATS),), dtype=torch.int64, device=dev) \
        if stats else None
    if block is not None:
        a.stats = block.data_ptr()
    a.keep = items      # rows packed here live as long as the block
    return a, outs, block


def walk_cuda(o, d, t_min, t_max, tree, *, admit=None, any_hit=False,
              max_outer=512, stats=False):
    """Launch the walk on CUDA tensors (walk_args' arguments).  Returns
    (outputs, stats block or None), as walk_args allocates them."""
    on_cuda("octree_walk", o.device)
    a, outs, block = walk_args(o, d, t_min, t_max, tree, admit=admit,
                               any_hit=any_hit, max_outer=max_outer,
                               stats=stats)
    if a.n:
        launch("octree_walk", a, o.device)
    return outs, block


def count(stats):
    """While recording, add a stats block's rays, regions and cut rays to
    the device counters octree.rays, octree.regions, octree.cut_rays."""
    for k, name in enumerate(STATS[:3]):
        trace.count_device(f"octree.{name}", stats[k])


def relaunch(a, device):
    """Launch once more a block that walk_args built, its rays and
    outputs still held: while recording, into a fresh stats block that
    `count` reads."""
    if trace.enabled():
        a = OctreeWalkArgs.from_buffer_copy(a)
        stats = torch.zeros((len(STATS),), dtype=torch.int64, device=device)
        a.stats = stats.data_ptr()
        launch("octree_walk", a, device)
        count(stats)
    else:
        launch("octree_walk", a, device)
