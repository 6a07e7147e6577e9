"""The port's multi-device layer (voxelray_torch/parallel/comm.py, with
build_accel_slab, trace_grid_dda_zslab and the render_rays hooks) against
the JAX package on the CPU.

The port's meshes here are rehearsal meshes, make_mesh(devices=["cpu"] *
n): the shards run one after another in this process.  JAX's references
run on the conftest's 8 virtual CPU devices, in process: none of them
reaches a Pallas kernel (voxelize_dense, the dda traces, build_accel_slab
and the shard_map merges are XLA).

Tolerances: occupancy, set_calls, bitmasks, fine words, hit masks and
cell ids are bit-equal.  Traces merged over slabs are bit-equal to the
port's monolithic traces, t included.  Frames are within rtol 2e-6 /
atol 1e-7 of the port's render_image and of JAX's frames (JAX's dda t
has the cell centre contracted into an FMA on XLA:CPU; on these cameras
that stays inside the tolerance), and the largest difference is printed.
set_calls is held to JAX's where JAX equals the numpy oracle and to the
oracle otherwise, as tests/test_torch_voxelize.py holds it.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_trace import SLIVER_CORNER_RAYS, _brick_edge_rays
from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.models.scene import build_scene as jbuild_scene
from voxelray_tpu.ops.geometry import grid_dims, mesh_bbox
from voxelray_tpu.ops.intersect import make_camera_rays as jmake_camera_rays
from voxelray_tpu.ops.traverse import trace_grid_dda_zslab as jdda_zslab
from voxelray_tpu.ops.traverse_fast import build_accel_slab as jslab
from voxelray_tpu.ops.voxelize import required_window_shape
from voxelray_tpu.ops.voxelize import voxelize_mesh as jvoxelize_mesh
from voxelray_tpu.parallel import comm as jcomm
from voxelray_tpu.render.camera import Camera
from voxelray_tpu.render.pipeline import render_image as jrender_image
from voxelray_torch.io.meshes import torus_knot
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.scene import build_scene
from voxelray_torch.oracle import oracle_voxelize
from voxelray_torch.ops.traverse import trace_grid_dda, trace_grid_dda_zslab
from voxelray_torch.ops.traverse_fast import (build_accel, build_accel_slab,
                                              trace_grid_fast)
from voxelray_torch.ops.voxelize import voxelize_plain
from voxelray_torch.parallel import comm
from voxelray_torch.render.pipeline import render_image
from voxelray_torch.utils.convert import accel_from_numpy

torch.set_num_threads(2)
RTOL, ATOL = 2e-6, 1e-7
STAGED = dict(fast_opts={"mega": False}, shadow_opts={"mega": False})


def cpu_mesh(n):
    return comm.make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jcomm.make_mesh(8)


@functools.cache
def _bunny(vs):
    """(JAX scene, port scene) of bunny_like(2) at vs: the same grid."""
    v, f = jmeshes.bunny_like(2)
    jscene = jbuild_scene(models=None, grid=JGridBool.from_mesh(v, f, vs))
    scene = build_scene(grid=GridBool.from_mesh(v, f, vs, device="cpu"),
                        device="cpu")
    assert np.array_equal(np.asarray(jscene.occ_flat),
                          scene.occ_flat.numpy())
    return jscene, scene


def _camera(w, h):
    _, _, vi, pi = Camera().matrices(w, h)
    return vi, pi


def _close(what, a, b):
    err = float(np.abs(a - b).max())
    print(f"{what}: max |difference| {err}")
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=RTOL, atol=ATOL), what


@pytest.mark.parametrize("n_tri,n_shards", [(320, 8), (317, 8), (3, 8),
                                            (10, 3), (5, 1)])
def test_shard_triangles_matches_jax(n_tri, n_shards):
    """(a) +inf padding up to a multiple of the shard count, bit-equal."""
    v, f = jmeshes.icosphere(2)
    tri = v[f][:n_tri].astype(np.float32)
    got = comm.shard_triangles(tri, n_shards)
    want = jcomm.shard_triangles(tri, n_shards)
    assert got.shape[0] % n_shards == 0
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_or_reduce_semantics(mesh8):
    """(b) OR over the mesh's parts, as JAX's psum > 0 gives it, on the
    mesh's first device."""
    @partial(jax.shard_map, mesh=mesh8, in_specs=P("rays"), out_specs=P())
    def go(x):
        return jcomm.or_reduce_occupancy(x[0], "rays")

    x = np.zeros((8, 16), np.uint8)
    x[2, 5] = x[7, 5] = x[3, 9] = 1
    out = comm.or_reduce_occupancy([torch.from_numpy(r) for r in x],
                                   cpu_mesh(8))
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), np.asarray(go(x)))
    assert out.tolist() == [0] * 5 + [1] + [0] * 3 + [1] + [0] * 6


@pytest.mark.parametrize("n_tri", [320, 317, 3])
def test_voxelize_sharded_matches_jax(mesh8, n_tri):
    """(c) icosphere(2) at 0.12 over 8 shards: all 320 triangles, 317 (the
    sentinel pad), and 3 (five shards of padding alone, which add
    nothing).  Occupancy bit-equal to JAX's, to the single-device
    voxelizer and to the oracle; set_calls as the module docstring
    says."""
    v, f = jmeshes.icosphere(2)
    f = f[:n_tri]
    vs = 0.12
    single = jvoxelize_mesh(v, f, vs)
    origin, dims = single["origin"], single["dims"]
    win = required_window_shape(v, f, origin, vs, dims)
    occ_j, calls_j = jcomm.voxelize_sharded(v[f], origin, mesh8, dims=dims,
                                            voxel_size=vs, window=win,
                                            chunk=64)
    occ, calls = comm.voxelize_sharded(v[f], origin, cpu_mesh(8), dims=dims,
                                       voxel_size=vs)
    assert occ.dtype == torch.uint8 and tuple(occ.shape) == dims[::-1]
    assert np.array_equal(occ.numpy(), np.asarray(occ_j))
    ref, ref_calls = voxelize_plain(torch.from_numpy(v),
                                    torch.from_numpy(f.astype(np.int32)),
                                    origin, vs, dims)
    assert torch.equal(occ, ref) and int(calls) == ref_calls
    oracle = oracle_voxelize(v, f, vs)
    assert np.array_equal(occ.numpy().astype(bool), oracle.occupancy)
    want = int(calls_j) if int(calls_j) == oracle.set_calls \
        else oracle.set_calls
    assert int(calls) == want > 0


def test_voxelize_frames_sharded_matches_jax(mesh8):
    """(d) 5 deformed frames of icosphere(1) at 0.25 dealt over 8 devices
    (the last frame repeated up to 8, then trimmed): occupancy and
    set_calls per frame bit-equal to JAX's."""
    v, f = jmeshes.icosphere(1)
    vs, n_frames = 0.25, 5
    fv = np.stack([jmeshes.deformed(v, 2 * np.pi * i / n_frames)
                   for i in range(n_frames)])
    bb_min, bb_max = mesh_bbox(fv.reshape(-1, 3))
    dims = grid_dims(bb_min, bb_max, vs)
    occ_j, calls_j = jcomm.voxelize_frames_sharded(
        fv, f, bb_min, mesh8, dims=dims, voxel_size=vs, window=(4, 4, 4),
        chunk=32)
    occ, calls = comm.voxelize_frames_sharded(fv, f, bb_min, cpu_mesh(8),
                                              dims=dims, voxel_size=vs)
    assert tuple(occ.shape) == (n_frames,) + dims[::-1]
    assert np.array_equal(occ.numpy(), np.asarray(occ_j))
    assert calls.tolist() == np.asarray(calls_j).tolist()
    assert not torch.equal(occ[0], occ[2])


@functools.cache
def _jax_render_sharded(w, h):
    jscene, _ = _bunny(0.11)
    vi, pi = _camera(w, h)
    return np.asarray(jcomm.render_sharded(jscene, vi, pi, jcomm.make_mesh(8),
                                           width=w, height=h,
                                           backend="dda"))


@pytest.mark.parametrize("w,h", [(64, 32), (48, 30)])
@pytest.mark.parametrize("variant", ["dda", "fast", "staged"])
def test_render_sharded_matches_render_image_and_jax(w, h, variant):
    """(e) 8 row shards of bunny_like(2) at 0.11 (48x30: 4 rows a shard,
    the last row repeated twice and trimmed), backend dda, fast (K2's
    plain version) and fast through the staged walk: the frame against
    the port's render_image with the same options and against JAX's
    render_sharded dda."""
    _, scene = _bunny(0.11)
    vi, pi = _camera(w, h)
    backend = "dda" if variant == "dda" else "fast"
    opts = STAGED if variant == "staged" else {}
    img = comm.render_sharded(scene, vi, pi, cpu_mesh(8), width=w, height=h,
                              backend=backend, **opts).numpy()
    ref = render_image(scene, vi, pi, width=w, height=h, backend=backend,
                       **opts).numpy()
    assert img.shape == (h, w, 4)
    _close(f"{variant} {w}x{h} vs render_image", img, ref)
    _close(f"{variant} {w}x{h} vs JAX's render_sharded dda", img,
           _jax_render_sharded(w, h))


@functools.cache
def _slab_grid():
    """bunny_like(2) at 0.09: (occupancy (Z, Y, X) numpy, origin, vs) and
    3 slabs of nzs rows, brick-aligned."""
    v, f = jmeshes.bunny_like(2)
    g = JGridBool.from_mesh(v, f, 0.09)
    occ = np.asarray(g.occupancy()).astype(np.uint8)
    nzs = -(-(-(-occ.shape[0] // 3)) // 8) * 8
    return occ, np.asarray(g.origin, np.float32), float(g.voxel_size), nzs


def _rows(occ, a, b):
    return comm.zslab_rows(torch.from_numpy(occ), a, b)


def _port_slab(occ, i, nzs, origin, vs, halo=True):
    nz = occ.shape[0]
    z0 = i * nzs
    return build_accel_slab(
        _rows(occ, z0, z0 + nzs), z0, nz, origin, vs,
        below=_rows(occ, z0 - 8, z0) if halo and z0 else None,
        above=(_rows(occ, z0 + nzs, z0 + nzs + 8)
               if halo and z0 + nzs < nz else None))


def _words(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_build_accel_slab_matches_jax(i):
    """(f) Slab i of 3: coarse and l2 bit-equal to JAX's build_accel_slab,
    the slab's own fine columns bit-equal to JAX's, the halo columns
    equal to the monolithic accel's; and JAX's slab accel, carried over
    with its fine_off, traces as the port's slab accel without a halo."""
    occ, origin, vs, nzs = _slab_grid()
    nz = occ.shape[0]
    z0 = i * nzs
    occp = np.pad(occ, ((0, nzs * 3 - nz), (0, 0), (0, 0)))
    js = jslab(occp[z0:z0 + nzs], z0, nz, origin, vs)
    ps = _port_slab(occ, i, nzs, origin, vs)
    whole = build_accel(torch.from_numpy(occ), origin, vs)
    bx, by, bz = ps.bdims
    layer = bx * by
    assert (ps.dims, ps.bdims) == (js.dims, js.bdims)
    assert np.array_equal(ps.coarse.numpy(), _words(js.coarse))
    assert np.array_equal(ps.l2.numpy(), _words(js.l2))
    z0b = z0 // 8
    own = min(nzs // 8, bz - z0b)
    lo = ps.fine_off // layer
    assert lo == max(z0b - 1, 0)
    assert ps.fine.shape[1] == layer * (min(z0b + own + 1, bz) - lo)
    col = (z0b - lo) * layer
    assert np.array_equal(ps.fine[:, col:col + own * layer].numpy(),
                          _words(js.fine)[:, :own * layer])
    assert int(js.fine_off) == z0b * layer
    assert torch.equal(ps.fine, whole.fine[:, ps.fine_off:ps.fine_off
                                           + ps.fine.shape[1]])
    carried = accel_from_numpy(js.coarse, js.fine, js.l2, None, origin,
                               js.dims, js.bdims, vs,
                               fine_off=int(js.fine_off))
    bare = _port_slab(occ, i, nzs, origin, vs, halo=False)
    o, d = (torch.from_numpy(np.array(x).reshape(-1, 3))
            for x in jmake_camera_rays(64, 32, *_camera(64, 32)))
    t_c, lin_c = trace_grid_fast(o, d, carried)
    t_b, lin_b = trace_grid_fast(o, d, bare)
    assert torch.equal(lin_c, lin_b) and torch.equal(t_c, t_b)


@functools.cache
def _knot():
    """The 115x54x121 knot of the DDA's stress set, its camera rays
    (64x48) and the 20,000 rays aimed at brick edges and corners."""
    v, f = torus_knot(2, 3, 256, 32)
    bb_min, bb_max = mesh_bbox(v)
    ext = float(max(bb_max - bb_min))
    g = GridBool.from_mesh(v, f, ext / 120, device="cpu")
    assert g.dims == (115, 54, 121)
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * ext),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(64, 48)
    o, d = (np.array(x).reshape(-1, 3) for x in jmake_camera_rays(64, 48,
                                                                   vi, pi))
    rays = {"camera": (o, d), "brick_edge": _brick_edge_rays(g, ext, 20000,
                                                             0)}
    return g, rays


def _slab_traces(kind, g, o, d, nzs, halo=True):
    occ = g.occupancy()
    nz = occ.shape[0]
    parts = []
    for i in range(-(-nz // nzs)):
        z0 = i * nzs
        if kind == "dda":
            parts.append(trace_grid_dda_zslab(
                o, d, comm.zslab_rows(occ, z0, z0 + nzs).reshape(-1),
                g.origin, z0, dims=g.dims, nzs=nzs,
                voxel_size=g.voxel_size))
        else:
            sl = _port_slab(occ.numpy(), i, nzs, g.origin, g.voxel_size,
                            halo)
            parts.append(trace_grid_fast(o, d, sl))
    return comm.pmin_nearest(parts, cpu_mesh(len(parts)))


@pytest.mark.parametrize("rays", ["camera", "brick_edge"])
@pytest.mark.parametrize("kind", ["dda", "staged"])
def test_slab_merge_is_the_monolithic_trace(kind, rays):
    """(g) The knot in 3 slabs of 48 rows (boundaries at z 48 and 96, brick
    edges the stress rays aim at; SLIVER_CORNER_RAYS among them): the
    slab-merged trace equals the port's monolithic trace of the same kind
    bit for bit, cells and t.  The DDA needs no halo (each slab walks the
    monolithic walk from the grid's entry).  The staged walk needs the
    fine table's halo: without it, a probe across the slab boundary
    reads nothing and ray 19735 of the stress set takes another cell."""
    g, all_rays = _knot()
    o, d = (torch.from_numpy(x) for x in all_rays[rays])
    occ = g.occupancy()
    if kind == "dda":
        t_m, lin_m = trace_grid_dda(o, d, occ.reshape(-1), g.origin,
                                    dims=g.dims, voxel_size=g.voxel_size)
    else:
        t_m, lin_m = trace_grid_fast(
            o, d, build_accel(occ, g.origin, g.voxel_size), mega=False)
    t_s, lin_s = _slab_traces(kind, g, o, d, 48)
    assert (lin_m >= 0).sum() > 400
    assert torch.equal(lin_s, lin_m) and torch.equal(t_s, t_m)
    if rays == "brick_edge":
        assert (lin_m[SLIVER_CORNER_RAYS] >= 0).all()
        if kind == "staged":
            _, lin_b = _slab_traces(kind, g, o, d, 48, halo=False)
            apart = torch.nonzero(lin_b != lin_m).squeeze(1).tolist()
            print(f"staged slab merge without the halo: rays apart {apart}")
            assert 19735 in apart


def test_zslab_dda_matches_jax_shard_map(mesh8):
    """(h) bunny_like(2) at 0.11 in 8 slabs: the port's per-slab DDA merged
    on the CPU mesh against JAX's trace_grid_dda_zslab under shard_map
    with its pmin merge: cells bit-equal, t within rtol 2e-6; and bit-
    equal to the port's monolithic DDA."""
    jscene, scene = _bunny(0.11)
    nx, ny, nz = scene.grid_dims
    vs = scene.grid_voxel_size
    n = 8
    nzs = -(-nz // n)
    o, d = (np.array(x) for x in jmake_camera_rays(64, 32,
                                                   *_camera(64, 32)))
    occ3 = np.asarray(jscene.occ_flat, np.uint8).reshape(nz, ny, nx)
    occp = np.pad(occ3, ((0, nzs * n - nz), (0, 0), (0, 0)))
    imax = np.iinfo(np.int32).max

    @partial(jax.shard_map, mesh=mesh8, in_specs=(P("rays"), P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def _trace(occ_slab, oo, dd, org):
        z0 = jax.lax.axis_index("rays").astype(jnp.int32) * nzs
        t, lin = jdda_zslab(oo, dd, occ_slab.reshape(-1), org, z0,
                            dims=(nx, ny, nz), nzs=nzs,
                            voxel_size_static=vs)
        t_all = jax.lax.pmin(t, "rays")
        sel = jnp.where(jnp.isfinite(t) & (t == t_all), lin,
                        jnp.int32(imax))
        return t_all, jnp.where(jnp.isfinite(t_all),
                                jax.lax.pmin(sel, "rays"), -1)

    t_j, lin_j = (np.asarray(x) for x in _trace(
        jnp.asarray(occp.reshape(n, -1)), o, d, jscene.grid_origin))
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    occ = scene.occ_flat.reshape(nz, ny, nx)
    parts = [trace_grid_dda_zslab(
        ot, dt_, comm.zslab_rows(occ, i * nzs, (i + 1) * nzs).reshape(-1),
        scene.grid_origin, i * nzs, dims=scene.grid_dims, nzs=nzs,
        voxel_size=vs) for i in range(n)]
    t_s, lin_s = comm.pmin_nearest(parts, cpu_mesh(n))
    hit = np.isfinite(t_j)
    assert hit.sum() > 50
    assert np.array_equal(lin_s.numpy(), lin_j)
    assert np.array_equal(np.isfinite(t_s.numpy()), hit)
    assert np.allclose(t_s.numpy()[hit], t_j[hit], rtol=RTOL, atol=0)
    t_m, lin_m = trace_grid_dda(ot, dt_, scene.occ_flat, scene.grid_origin,
                                dims=scene.grid_dims, voxel_size=vs)
    assert torch.equal(lin_s, lin_m) and torch.equal(t_s, t_m)


@functools.cache
def _jax_replicated():
    jscene, _ = _bunny(0.11)
    return np.asarray(jrender_image(jscene, *_camera(64, 32), width=64,
                                    height=32, backend="dda"))


@pytest.mark.parametrize("backend", ["dda", "fast"])
def test_zslab_render_matches_replicated(backend):
    """(i) bunny_like(2) at 0.11, 64x32, shadows on, the grid in 8 slabs
    on the CPU mesh: the frame against JAX's replicated render_image dda
    and against the port's render_image (dda, or the staged walk for
    "fast", which the slab accels take)."""
    _, scene = _bunny(0.11)
    vi, pi = _camera(64, 32)
    img = comm.render_zslab_sharded(scene, vi, pi, cpu_mesh(8), width=64,
                                    height=32, backend=backend).numpy()
    opts = STAGED if backend == "fast" else {}
    ref = render_image(scene, vi, pi, width=64, height=32, backend=backend,
                       **opts).numpy()
    _close(f"zslab {backend} vs render_image", img, ref)
    _close(f"zslab {backend} vs JAX's replicated dda", img,
           _jax_replicated())


def test_make_mesh_needs_the_cards(monkeypatch):
    """(k) make_mesh() without a card raises, make_mesh(4) with fewer
    cards raises; a rehearsal mesh is only ever a listed one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 devices asked, 2"):
        comm.make_mesh(4)
    assert comm.make_mesh().devices == (torch.device("cuda", 0),
                                        torch.device("cuda", 1))
    m = comm.make_mesh(devices=["cpu"] * 3, axis="data")
    assert m.size == 3 and m.axis == "data"
    assert m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        comm.make_mesh(2, devices=["cpu"] * 3)
