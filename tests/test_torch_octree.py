"""The port's Morton octree (codes, node build, region map, walk) and the
brute and octree render backends against the JAX package on the CPU.

Tolerances:
  * morton_*_np copies and the int64 device encode / decode: bit-equal
    to JAX's numpy functions, at the 21-bit edges too.
  * build_nodes and build_region_map (full and coarse maps): equal.
  * Octree fields on bunny_like(2) at 0.11: equal, region map and item
    rows included.
  * trace_octree / any_hit_octree against JAX on camera rays and 256
    random rays: hit mask and cell equal, t within rtol 2e-6 (JAX's
    XLA:CPU contracts the cell's faces into FMAs, and where that moves t
    further, JAX's t is held to the contracted expression exactly); the
    port's t is bit-equal to the uncontracted numpy slab expression and
    to its own DDA's.  The region-map
    walk equals the descent and a coarse map the full one, bit for bit;
    t_max clips.
  * render_image, backend "brute" (a scene of AABBs only, GridVec's list
    with its duplicates) and "octree", against JAX's render_image with
    the same backend: hit mask equal and >= 99.9% of pixels within 2e-5
    (tests/test_torch_render.py's tolerance; the count outside printed).
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.models import octree as joctree
from voxelray_tpu.models.grids import GridVec as JGridVec
from voxelray_tpu.models.scene import build_scene as jbuild_scene
from voxelray_tpu.ops import morton as jmorton
from voxelray_tpu.ops.octree_traverse import any_hit_octree as jany_hit
from voxelray_tpu.ops.octree_traverse import trace_octree as jtrace
from voxelray_tpu.render.camera import Camera
from voxelray_tpu.render.pipeline import render_image as jrender_image
from voxelray_torch.models import octree
from voxelray_torch.models.grids import GridBool, GridVec
from voxelray_torch.models.scene import build_scene
from voxelray_torch.ops import morton, octree_traverse
from voxelray_torch.ops.intersect import make_camera_rays
from voxelray_torch.ops.octree_traverse import any_hit_octree, trace_octree
from voxelray_torch.ops.traverse import trace_aabbs_brute, trace_grid_dda
from voxelray_torch.ops.voxelize import voxelize_hits
from voxelray_torch.render.pipeline import render_image
from voxelray_torch.utils import trace

torch.set_num_threads(2)
VS = 0.11
IMG_W, IMG_H = 64, 36


@contextlib.contextmanager
def _recording():
    """Record (utils/trace.py) for the block; yields a dict that holds the
    counters at its end, the walk's octree.* among them."""
    trace.disable()
    trace.clear()
    trace.enable()
    got = {}
    try:
        yield got
        got.update(trace.counters())
    finally:
        trace.disable()
        trace.clear()


def test_morton_copies_and_device_codes():
    edge = np.array([0, 1, 2, 3, 1023, 1024, (1 << 20) - 1, 1 << 20,
                     (1 << 21) - 2, (1 << 21) - 1], np.uint64)
    rng = np.random.default_rng(4)
    x = np.concatenate([edge, rng.integers(0, 1 << 21, 4000, np.uint64)])
    y = np.concatenate([edge[::-1], rng.integers(0, 1 << 21, 4000,
                                                 np.uint64)])
    z = np.concatenate([np.roll(edge, 3), rng.integers(0, 1 << 21, 4000,
                                                       np.uint64)])
    want = jmorton.morton_encode3_np(x, y, z)
    assert want.max() >> np.uint64(63) == 0
    assert np.array_equal(morton.morton_encode3_np(x, y, z), want)
    assert np.array_equal(morton.spread_bits_np(x), jmorton.spread_bits_np(x))
    for a, b in zip(morton.morton_decode3_np(want),
                    jmorton.morton_decode3_np(want)):
        assert np.array_equal(a, b)
    xt, yt, zt = (torch.from_numpy(a.astype(np.int64)) for a in (x, y, z))
    codes = morton.morton_encode3(xt, yt, zt)
    assert codes.dtype == torch.int64 and bool((codes >= 0).all())
    assert np.array_equal(codes.numpy().astype(np.uint64), want)
    for a, b in zip(morton.morton_decode3(codes), (x, y, z)):
        assert np.array_equal(a.numpy().astype(np.uint64), b)
    # torch's signed sort of the int64 codes is the uint64 order
    assert np.array_equal(torch.sort(codes).values.numpy().astype(np.uint64),
                          np.sort(want))


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("max_depth,max_items", [(5, 16), (7, 4), (3, 1)])
def test_build_nodes_matches_jax(dups, max_depth, max_items):
    rng = np.random.default_rng(max_depth * 10 + max_items + dups)
    side = 1 << max_depth
    n = 3000
    c = rng.integers(0, side, (n, 3)).astype(np.uint64)
    if dups:
        c = np.concatenate([c, c[rng.integers(0, n, n)]])
    codes = np.sort(jmorton.morton_encode3_np(c[:, 0], c[:, 1], c[:, 2]))
    want = joctree.build_nodes(codes, max_depth, max_items)
    got = octree.build_nodes(codes, max_depth, max_items)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for depth in (0, max_depth):
        assert np.array_equal(octree.build_nodes(codes[:0], depth, max_items),
                              joctree.build_nodes(codes[:0], depth,
                                                  max_items))


@pytest.fixture(scope="module")
def trees():
    v, f = jmeshes.bunny_like(2)
    jt = joctree.Octree.from_mesh(v, f, VS)
    t = octree.Octree.from_mesh(v, f, VS, device="cpu")
    return v, f, jt, t


def test_region_maps_match_jax(trees):
    _, _, jt, t = trees
    ch = t.children.numpy()
    bits = t.bits_per_axis
    assert bits >= 3
    for mb in (bits, bits - 1, 2):
        want = joctree.build_region_map(np.asarray(jt.children), bits, mb)
        assert np.array_equal(octree.build_region_map(ch, bits, mb), want)
    assert octree.LEAF_FLAG == joctree.LEAF_FLAG
    assert octree.INTERNAL_FLAG == joctree.INTERNAL_FLAG
    assert octree.REGION_MAP_MAX_BITS == joctree.REGION_MAP_MAX_BITS


def test_octree_fields_match_jax(trees):
    _, _, jt, t = trees
    codes = t.codes.numpy().astype(np.uint64)
    assert np.array_equal((codes >> np.uint64(32)).astype(np.uint32),
                          np.asarray(jt.code_hi))
    assert np.array_equal((codes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                          np.asarray(jt.code_lo))
    assert np.array_equal(t.codes_u64(), jt.codes_u64())
    for k in ("item_x", "item_y", "item_z", "children", "node_start",
              "node_count", "region_map", "items4", "root_min"):
        a, b = getattr(t, k), np.asarray(getattr(jt, k))
        a = a.numpy() if torch.is_tensor(a) else a
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("dims", "voxel_size", "bits_per_axis", "max_items",
              "origin_key", "set_calls", "map_bits", "n_items", "n_nodes"):
        assert getattr(t, k) == getattr(jt, k), k
    assert np.array_equal(t.origin, np.asarray(jt.origin))
    for a, b in zip(t.root_bounds, jt.root_bounds):
        assert np.array_equal(a, b)
    assert np.array_equal(t.get_aabbs().numpy(), np.asarray(jt.get_aabbs()))
    assert np.array_equal(t.occupancy().numpy(), np.asarray(jt.occupancy()))
    assert t.memory_usage_bytes() == jt.memory_usage_bytes()


def _slab_t(o, d, lin, tree, centre="exact"):
    """numpy float32 slab t0 of cell `lin`.  centre "exact": the
    uncontracted reference expression; "fma": the centre origin +
    (i + 0.5) * vs rounded once, as a fused multiply-add does; "fold":
    the box faces (i + 0.5) * vs + (origin -/+ half) in one FMA, the
    constants folded first (both are what XLA:CPU makes of JAX's walk)."""
    nx, ny, _ = tree.dims
    idx = np.stack([lin % nx, (lin // nx) % ny, lin // (nx * ny)], -1)
    ip = idx.astype(np.float32) + np.float32(0.5)
    vs = np.float32(tree.voxel_size)
    org = np.float32(tree.origin_key)
    half = np.float32(0.5) * vs

    def fma(add):
        return (ip.astype(np.float64) * np.float64(vs)
                + add.astype(np.float64)).astype(np.float32)

    if centre == "fold":
        lo, hi = fma(org - half), fma(org + half)
    else:
        c = fma(org) if centre == "fma" else org + ip * vs
        lo, hi = c - half, c + half
    inv = np.float32(1.0) / d
    return np.minimum(inv * (lo - o), inv * (hi - o)).max(axis=-1)


def _rays(seed, n=256):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _camera(v):
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) * 0.5
    return Camera(eye=tuple(center + np.float32([0.9, 0.55, -0.9]) * 0.85
                            * float(max(hi - lo))), center=tuple(center))


@pytest.fixture(scope="module")
def ray_sets(trees):
    """Camera rays (IMG_W x IMG_H) and 256 random rays, one batch."""
    v = trees[0]
    _, _, vi, pi = _camera(v).matrices(IMG_W, IMG_H)
    o, d = make_camera_rays(IMG_W, IMG_H, vi, pi)
    o2, d2 = _rays(11)
    return (torch.cat([o.reshape(-1, 3), torch.from_numpy(o2)]),
            torch.cat([d.reshape(-1, 3), torch.from_numpy(d2)]))


def test_trace_octree_matches_jax(trees, ray_sets):
    v, f, jt, t = trees
    o, d = ray_sets
    jt_t, jt_lin = (np.asarray(x) for x in jtrace(jnp.asarray(o.numpy()),
                                                  jnp.asarray(d.numpy()), jt))
    with _recording() as cnt:
        tt, lin, steps = trace_octree(o, d, t, return_stats=True)
    assert cnt["octree.cut_rays"] == 0 and 0 < steps < 512
    assert cnt["octree.rays"] == o.shape[0]
    assert steps * o.shape[0] >= cnt["octree.regions"] >= o.shape[0]
    tt, lin = tt.numpy(), lin.numpy()
    hit = np.isfinite(jt_t)
    assert hit.sum() > 500
    assert np.array_equal(np.isfinite(tt), hit)
    assert np.array_equal(lin, jt_lin)
    on, dn = o.numpy()[hit], d.numpy()[hit]
    assert np.array_equal(tt[hit], _slab_t(on, dn, lin[hit], t))
    # JAX's t: within rtol 2e-6, or else exactly one of its contracted
    # expressions
    near = np.isclose(tt[hit], jt_t[hit], rtol=2e-6, atol=0)
    contracted = ((jt_t[hit] == _slab_t(on, dn, lin[hit], t, "fma"))
                  | (jt_t[hit] == _slab_t(on, dn, lin[hit], t, "fold")))
    print(f"{int(hit.sum())} hits, {int((~near).sum())} past rtol 2e-6 of "
          "JAX's t, each equal to a contracted expression")
    assert (near | contracted).all()
    assert near.mean() > 0.95
    # the same cells as the port's exhaustive DDA, with its t bit for bit
    g = GridBool.from_mesh(v, f, VS, device="cpu")
    dt, dlin = trace_grid_dda(o, d, g.occupancy().reshape(-1), g.origin,
                              dims=g.dims, voxel_size=VS)
    assert np.array_equal(dlin.numpy(), lin)
    assert np.array_equal(dt.numpy()[hit], tt[hit])


def test_any_hit_octree_matches_jax(trees, ray_sets):
    _, _, jt, t = trees
    o, d = ray_sets
    tmax = np.random.default_rng(5).uniform(0.5, 5.0, o.shape[0]).astype(
        np.float32)
    want = np.asarray(jany_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                               jt, t_max=jnp.asarray(tmax)))
    got = any_hit_octree(o, d, t, t_max=torch.from_numpy(tmax)).numpy()
    assert 0 < want.sum() < len(want)
    assert np.array_equal(got, want)


def test_map_walk_equals_descent_and_coarse_maps(trees, ray_sets):
    """The region-map walk and the child-link descent give identical
    results, and so do coarse maps (map_bits < bits)."""
    _, _, _, t = trees
    o, d = ray_sets
    ref_t, ref_lin = trace_octree(o, d, t)
    nomap = dataclasses.replace(t, region_map=None, items4=None)
    for tree in [nomap] + [dataclasses.replace(
            t, region_map=torch.from_numpy(octree.build_region_map(
                t.children.numpy(), t.bits_per_axis, mb)), map_bits=mb)
            for mb in (t.bits_per_axis - 1, 2)]:
        tt, lin = trace_octree(o, d, tree)
        assert torch.equal(lin, ref_lin)
        assert torch.equal(tt, ref_t)


def test_octree_tmax_clipping_and_cut_rays(trees):
    _, _, jt, t = trees
    o = torch.tensor([[5.0, 1.0, 0.0]])
    d = torch.tensor([[-1.0, 0.0, 0.0]])
    t_full, _ = trace_octree(o, d, t)
    assert bool(torch.isfinite(t_full).all())
    j_full, _ = jtrace(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jt)
    assert np.allclose(t_full.numpy(), np.asarray(j_full), rtol=2e-6)
    t_clip, lin = trace_octree(o, d, t, t_max=float(t_full[0]) - 0.5)
    assert not bool(torch.isfinite(t_clip).any()) and int(lin[0]) == -1
    # a one-step bound cuts the rays that need more steps; they miss
    os_, ds = _rays(23, 64)
    with _recording() as cnt:
        tt, _, steps = trace_octree(torch.from_numpy(os_),
                                    torch.from_numpy(ds), t, max_outer=1,
                                    return_stats=True)
    cut = cnt["octree.cut_rays"]
    assert cut > 0 and steps == 1
    with _recording() as cnt:
        full, _ = trace_octree(torch.from_numpy(os_), torch.from_numpy(ds),
                               t)
    assert cnt["octree.cut_rays"] == 0
    lost = int(torch.isfinite(full).sum()) - int(torch.isfinite(tt).sum())
    assert 0 < lost <= cut


@pytest.fixture(scope="module")
def render_scenes(trees):
    """JAX's and the port's scenes: AABBs only (GridVec's list, duplicates
    kept) and the gate-3 octree scene (occupancy from the tree, the list,
    the tree)."""
    v, f, jt, t = trees
    jboxes = np.asarray(JGridVec.from_mesh(v, f, VS).aabbs)
    boxes = GridVec.from_mesh(v, f, VS, device="cpu").aabbs
    assert np.array_equal(boxes.numpy(), jboxes)
    return {"brute": (jbuild_scene(aabbs=jboxes),
                      build_scene(aabbs=boxes, device="cpu")),
            "octree": (jbuild_scene(grid=jt, aabbs=jboxes, octree=jt),
                       build_scene(grid=t, aabbs=boxes, octree=t,
                                   device="cpu"))}


@pytest.mark.parametrize("backend", ["brute", "octree"])
@pytest.mark.parametrize("shadows", [True, False])
def test_render_backends_match_jax(trees, render_scenes, backend, shadows):
    jscene, scene = render_scenes[backend]
    assert scene.n_voxels == jscene.n_voxels
    assert (scene.octree is None) == (backend == "brute")
    _, _, vi, pi = _camera(trees[0]).matrices(IMG_W, IMG_H)
    ref = np.asarray(jrender_image(jscene, vi, pi, width=IMG_W,
                                   height=IMG_H, backend=backend,
                                   shadows=shadows))
    img = render_image(scene, vi, pi, width=IMG_W, height=IMG_H,
                       backend=backend, shadows=shadows).numpy()
    assert img.shape == (IMG_H, IMG_W, 4) and img.dtype == np.float32
    miss = np.float32(0.8) ** np.float32(1 / 2.2)
    hit_ref = (ref[..., :3] != miss).any(-1)
    assert hit_ref.sum() > 300
    assert np.array_equal((img[..., :3] != miss).any(-1), hit_ref)
    close = (np.abs(img - ref) <= 2e-5).all(-1)
    print(f"{backend} shadows={shadows}: {int((~close).sum())} pixels "
          "outside 2e-5")
    assert close.mean() >= 0.999


# Rays where JAX's octree walk leaves the oracle (a numpy-rule float32
# slab test over every occupied cell): corner slivers jumped by the 1e-6
# advance, a leaf's nearest item taken past the leaf's exit, a sliver at
# the root cube's entry.  (origin, direction) as float32 hex.
SLIVER_RAYS = [
    (("-0x1.47ea7cp+2", "-0x1.8dd27p+0", "0x1.bbc1cep-2"),
     ("0x1.ce6304p-1", "0x1.b5fd72p-2", "0x1.3964f2p-5")),
    (("0x1.39570ep+1", "0x1.faa59ep-1", "0x1.cce376p+0"),
     ("-0x1.c6b9a8p-1", "-0x1.009594p-2", "-0x1.8a834ep-2")),
    (("0x1.297f14p-3", "0x1.5406f8p+1", "0x1.affe36p+1"),
     ("0x1.188da4p-3", "-0x1.087f5cp-3", "-0x1.f6d816p-1")),
    (("0x1.58565cp+0", "0x1.9e5514p+1", "-0x1.2af6c6p+2"),
     ("-0x1.32381p-2", "-0x1.1f0bfep-1", "0x1.8b5ae2p-1")),
    (("-0x1.781a08p+1", "-0x1.73254cp-1", "0x1.f8fd64p+0"),
     ("0x1.cd846p-1", "0x1.526012p-2", "-0x1.1e81b2p-2")),
    (("0x1.a1743ap+0", "0x1.5e12f6p+2", "-0x1.ad7f4cp+1"),
     ("-0x1.706fd6p-3", "-0x1.4de5a2p-1", "0x1.790ed4p-1")),
]


def _edge_rays(grid, n, seed):
    """Rays aimed at random edges of occupied cells, from 3 to 6 away."""
    rng = np.random.default_rng(seed)
    nx, ny, _ = grid.dims
    lin = torch.nonzero(grid.occupancy().reshape(-1)).squeeze(1).numpy()
    pick = lin[rng.integers(0, len(lin), n)]
    p = np.stack([pick % nx, (pick // nx) % ny, pick // (nx * ny)],
                 1).astype(np.float64)
    axis = rng.integers(0, 3, n)
    p += rng.integers(0, 2, (n, 3))
    p[np.arange(n), axis] += rng.uniform(-1, 0, n) * 0.8 - 0.1
    target = grid.origin + p * float(np.float32(grid.voxel_size))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - d * rng.uniform(3, 6, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _oracle_verdict(o, d, occ, grid, t, lin, t_o, lin_o):
    """Adjudicate a walk's results where they differ from the oracle's
    (utils/parity.py, the rule of chip_smoke.py's gates)."""
    from voxelray_torch.utils.parity import adjudicate_hit_diffs
    idx = np.flatnonzero((np.isfinite(t) != np.isfinite(t_o))
                         | (np.isfinite(t) & (lin != lin_o)))
    return adjudicate_hit_diffs(o, d, occ, grid.origin, grid.voxel_size,
                                idx, t, lin, t_o, lin_o)


def test_octree_walk_repairs_the_references_sliver_misses(trees):
    """The port's walk probes the cells a boundary crossing can jump and
    lets a hit pend until the walk passes it: on rays aimed at cell edges
    every result adjudicates against the oracle, where JAX's walk (the
    same regions without the probes) fails on some; on SLIVER_RAYS JAX
    misses the oracle's cell or hits a farther one, the port hits it."""
    v, f, jt, t = trees
    g = GridBool.from_mesh(v, f, VS, device="cpu")
    occ = g.occupancy().numpy().astype(bool)
    lins = torch.nonzero(g.occupancy().reshape(-1)).squeeze(1)
    o, d = _edge_rays(g, 20000, 0)
    hexed = np.float32([[[float.fromhex(x) for x in v3] for v3 in r]
                        for r in SLIVER_RAYS])
    o = np.concatenate([hexed[:, 0], o])
    d = np.concatenate([hexed[:, 1], d])
    ot_, od = torch.from_numpy(o), torch.from_numpy(d)
    bt, bid = trace_aabbs_brute(ot_, od, g.get_aabbs())
    b_lin = torch.where(bid >= 0, lins[bid.clamp(min=0).long()], -1)
    b_t, b_lin = bt.numpy(), b_lin.numpy().astype(np.int32)
    pt, pl = (x.numpy() for x in trace_octree(ot_, od, t))
    jt_t, jt_l = (np.asarray(x) for x in jtrace(jnp.asarray(o),
                                                jnp.asarray(d), jt))
    port = _oracle_verdict(o, d, occ, g, pt, pl, b_t, b_lin)
    jax = _oracle_verdict(o, d, occ, g, jt_t, jt_l, b_t, b_lin)
    print(f"{len(o)} edge rays: port {port}; JAX {jax}")
    assert port["adjudication_ok"]
    assert not jax["adjudication_ok"]
    n = len(SLIVER_RAYS)
    assert np.array_equal(pl[:n], b_lin[:n])
    assert np.array_equal(pt[:n], b_t[:n])
    assert (jt_l[:n] != b_lin[:n]).all()


def test_octree_backend_without_an_octree_shades_the_box_it_hit(trees):
    """Backend "octree" on a scene without an octree traces the brute
    AABB list, as JAX's dispatch does.  JAX then shades with the centre
    of the cell whose linear index is the box's index (its centre
    follows the backend's name); the port shades with the box it hit,
    so its frame equals its brute frame, and JAX's brute frame."""
    from voxelray_tpu.models.grids import GridBool as JGridBool
    v, f, _, _ = trees
    jscene = jbuild_scene(grid=JGridBool.from_mesh(v, f, VS))
    scene = build_scene(grid=GridBool.from_mesh(v, f, VS, device="cpu"),
                        device="cpu")
    _, _, vi, pi = _camera(v).matrices(IMG_W, IMG_H)
    args = dict(width=IMG_W, height=IMG_H)
    img = {be: render_image(scene, vi, pi, backend=be, **args).numpy()
           for be in ("octree", "brute")}
    jimg = {be: np.asarray(jrender_image(jscene, vi, pi, backend=be, **args))
            for be in ("octree", "brute")}
    assert np.array_equal(img["octree"], img["brute"])
    assert (np.abs(img["brute"] - jimg["brute"]) <= 2e-5).all(-1).mean() \
        >= 0.999
    off = int((np.abs(jimg["octree"] - jimg["brute"]) > 2e-5).any(-1).sum())
    print(f"JAX octree-without-octree frame: {off} of {IMG_W * IMG_H} "
          "pixels off its brute frame")
    assert off > 0


@pytest.mark.parametrize("mesh", ["bunny", "knot", "icosphere-box"])
def test_octree_from_grid_equals_from_mesh(mesh):
    """Octree.from_grid over GridVec.from_mesh's boxes (no second
    voxelize) equals Octree.from_mesh at the same voxel size and box,
    field by field: the codes with their duplicates, items, nodes, region
    map, item rows, set_calls.  The boxes' cells, read back from their
    centres, are the hit stream's cells in its order."""
    from voxelray_torch.io import meshes as pmeshes
    box = {}
    if mesh == "bunny":
        v, f = pmeshes.bunny_like(2)
        vs = VS
    elif mesh == "knot":
        v, f = pmeshes.torus_knot(2, 3, 128, 64)
        vs = float(np.ptp(v, axis=0).max()) / 64
    else:
        v, f = pmeshes.icosphere(3)
        vs = 0.05
        box = dict(bb_min=np.float32([-1.3, -1.1, -1.2]),
                   bb_max=np.float32([1.2, 1.25, 1.1]))
    gv = GridVec.from_mesh(v, f, vs, device="cpu", **box)
    want = octree.Octree.from_mesh(v, f, vs, device="cpu", **box)
    assert want.n_items == gv.set_calls > want.n_nodes > 1
    hits = voxelize_hits(v, f, vs, device="cpu", **box)
    assert torch.equal(gv.cells(), hits["lin"])
    tree = octree.Octree.from_grid(gv)
    assert vars(tree).keys() == vars(want).keys()
    for k, a in vars(tree).items():
        b = getattr(want, k)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert a == b, k


def test_any_hit_octree_admit_mask_walks_the_admitted_rays(trees,
                                                          ray_sets):
    """With an admit mask the shadow predicate walks the admitted rays
    alone (compacted on CPU tensors): their answers are those of the
    rays walked on their own, the others False."""
    _, _, _, t = trees
    o, d = ray_sets
    rng = np.random.default_rng(8)
    tmax = torch.from_numpy(rng.uniform(0.5, 5.0, o.shape[0])
                            .astype(np.float32))
    admit = torch.from_numpy(rng.random(o.shape[0]) < 0.3)
    got = any_hit_octree(o, d, t, t_max=tmax, admit=admit)
    want = any_hit_octree(o[admit], d[admit], t, t_max=tmax[admit])
    assert not bool(got[~admit].any())
    assert torch.equal(got[admit], want) and 0 < int(want.sum())
