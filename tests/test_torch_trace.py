"""The port's traversal (camera rays, the exhaustive DDA, and the
megakernel K2's plain version) against the JAX package's dda.

The same numpy rays go to JAX trace_grid_dda and to the port.  Hits and
cells must be bit-equal and `unresolved` 0.  For t: the port evaluates
the reference slab expression without contraction, so its t is
bit-equal to numpy's float32 evaluation of the hit cell's slab t0.
JAX's XLA:CPU build contracts the cell centre origin + (i + 0.5) * vs
into one fused multiply-add; its t equals that contracted expression
exactly, which puts it up to ~3e-5 relative off on the grazing rays of
the close camera (the PARITY.md "cross-program envelope"; the JAX
package's own megakernel test compares mega against fast, not dda, for
this reason).  Where that contraction does not reach, t is within
rtol 2e-6 of JAX's.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.ops.geometry import mesh_bbox
from voxelray_tpu.ops.intersect import make_camera_rays as jmake_camera_rays
from voxelray_tpu.ops.traverse import trace_grid_dda as jtrace_grid_dda
from voxelray_tpu.render.camera import Camera
from voxelray_torch.io.meshes import torus_knot
from voxelray_torch.models.grids import GridBool
from voxelray_torch.ops.intersect import make_camera_rays
from voxelray_torch.ops.traverse import (trace_aabbs_brute, trace_grid_dda,
                                         trace_grid_dda_chunked)
from voxelray_torch.ops.traverse_fast import (any_hit_grid_fast,
                                              build_accel, trace_grid_fast)
from voxelray_torch.ops.voxelize import voxelize_mesh
from voxelray_torch.utils.parity import adjudicate_hit_diffs

from _jax_nocache import compile_cache_off

torch.set_num_threads(2)
W, H = 128, 64


@functools.cache
def _scene(res):
    v, f = jmeshes.icosphere(3)
    bb_min, bb_max = mesh_bbox(v)
    r = voxelize_mesh(v, f, float(max(bb_max - bb_min)) / res,
                      device="cpu")
    accel = build_accel(r["occ"], r["origin"], r["voxel_size"])
    return res, bb_min, bb_max, r, accel


@pytest.fixture(scope="module", params=[64, 144])
def scene(request):
    return _scene(request.param)


def _camera(bb_min, bb_max, eye_scale):
    center = (bb_min + bb_max) * 0.5
    return Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9])
                            * eye_scale * float(max(bb_max - bb_min))),
                  center=tuple(center))


def _jax_rays(cam):
    _, _, vi, pi = cam.matrices(W, H)
    o, d = jmake_camera_rays(W, H, jnp.asarray(vi), jnp.asarray(pi))
    return np.array(o), np.array(d)


def _slab_t(o, d, lin, r, fma_centre=False):
    """numpy float32 slab t0 of cell `lin`; fma_centre rounds the centre
    origin + (i + 0.5) * vs once, as a fused multiply-add does."""
    nx, ny, _ = r["dims"]
    idx = np.stack([lin % nx, (lin // nx) % ny, lin // (nx * ny)], -1)
    ip = idx.astype(np.float32) + np.float32(0.5)
    vs = np.float32(r["voxel_size"])
    org = r["origin"].astype(np.float32)
    if fma_centre:
        c = (ip.astype(np.float64) * np.float64(vs)
             + org.astype(np.float64)).astype(np.float32)
    else:
        c = org + ip * vs
    half = np.float32(0.5) * vs
    inv = np.float32(1.0) / d
    tb = inv * ((c - half) - o)
    tt = inv * ((c + half) - o)
    return np.minimum(tb, tt).max(axis=-1)


def test_camera_rays_match_jax():
    """Origins bit-equal; directions (unit vectors) within 1e-6 of JAX's
    (the projection einsum and the norm sum in another order).  JAX's
    rays are compiled with the persistent compile cache off."""
    v, _ = jmeshes.icosphere(3)
    cam = _camera(*mesh_bbox(v), 1.0)
    _, _, vi, pi = cam.matrices(W, H)
    with compile_cache_off():
        jo, jd = _jax_rays(cam)
    o, d = make_camera_rays(W, H, vi, pi)
    assert o.shape == (H, W, 3) and d.dtype == torch.float32
    assert np.array_equal(o.numpy(), jo)
    assert np.abs(d.numpy() - jd).max() <= 1e-6


@pytest.mark.parametrize("res,eye_scale", [
    (64, 1.0),     # n_sb = 1
    (144, 1.0),    # n_sb = 27
    (144, 0.2),    # camera close: dense, grazing hits
])
def test_trace_matches_jax_dda(res, eye_scale):
    _, bb_min, bb_max, r, accel = _scene(res)
    jo, jd = _jax_rays(_camera(bb_min, bb_max, eye_scale))
    occ = r["occ"].reshape(-1)
    t_j, lin_j = jtrace_grid_dda(
        jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(occ.numpy()),
        jnp.asarray(r["origin"]), dims=r["dims"],
        voxel_size_static=r["voxel_size"])
    t_j, lin_j = np.asarray(t_j), np.asarray(lin_j)
    hit = np.isfinite(t_j)
    assert hit.sum() > 1000
    o, d = torch.from_numpy(jo), torch.from_numpy(jd)
    t_d, lin_d = trace_grid_dda(o, d, occ, r["origin"], dims=r["dims"],
                                voxel_size=r["voxel_size"])
    t_m, lin_m, unresolved = trace_grid_fast(o, d, accel,
                                             return_stats=True)
    assert int(unresolved) == 0
    exact = _slab_t(jo[hit], jd[hit], lin_j[hit], r)
    assert np.array_equal(t_j[hit], _slab_t(jo[hit], jd[hit], lin_j[hit], r,
                                            fma_centre=True))
    for t, lin in ((t_d.numpy(), lin_d.numpy()), (t_m.numpy(),
                                                  lin_m.numpy())):
        assert np.array_equal(np.isfinite(t), hit)
        assert np.array_equal(lin[hit], lin_j[hit])
        assert np.all(lin[~hit] == -1)
        assert np.array_equal(t[hit], exact)
        if eye_scale == 1.0:
            assert np.allclose(t[hit], t_j[hit], rtol=2e-6, atol=0.0)


def test_admit_mask_matches_jax(scene):
    _, bb_min, bb_max, r, accel = scene
    jo, jd = _jax_rays(_camera(bb_min, bb_max, 1.0))
    admit = np.random.default_rng(0).random((H, W)) < 0.5
    t_j, lin_j = jtrace_grid_dda(
        jnp.asarray(jo), jnp.asarray(jd),
        jnp.asarray(r["occ"].reshape(-1).numpy()), jnp.asarray(r["origin"]),
        dims=r["dims"], voxel_size_static=r["voxel_size"])
    lin_j = np.where(admit, np.asarray(lin_j), -1)
    t_m, lin_m = trace_grid_fast(torch.from_numpy(jo), torch.from_numpy(jd),
                                 accel, admit=torch.from_numpy(admit))
    assert np.array_equal(lin_m.numpy(), lin_j)
    assert np.array_equal(np.isfinite(t_m.numpy()), lin_j >= 0)
    occluded = any_hit_grid_fast(torch.from_numpy(jo), torch.from_numpy(jd),
                                 accel, admit=torch.from_numpy(admit))
    assert np.array_equal(occluded.numpy(), lin_j >= 0)


def test_per_ray_t_max_matches_jax(scene):
    """Per-ray t_max (the shadow pass's light distance) and t_min, drawn
    from a seed around the hit distances: both packages cut the same
    rays."""
    _, bb_min, bb_max, r, accel = scene
    jo, jd = _jax_rays(_camera(bb_min, bb_max, 1.0))
    occ = r["occ"].reshape(-1)
    t_full, _ = trace_grid_dda(torch.from_numpy(jo), torch.from_numpy(jd),
                               occ, r["origin"], dims=r["dims"],
                               voxel_size=r["voxel_size"])
    med = float(np.median(t_full.numpy()[np.isfinite(t_full.numpy())]))
    rng = np.random.default_rng(5)
    t_max = rng.uniform(0.8 * med, 1.2 * med, (H, W)).astype(np.float32)
    t_min = rng.uniform(0.001, 0.9 * med, (H, W)).astype(np.float32)
    t_j, lin_j = jtrace_grid_dda(
        jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(occ.numpy()),
        jnp.asarray(r["origin"]), dims=r["dims"],
        voxel_size_static=r["voxel_size"],
        t_min=jnp.asarray(t_min.reshape(-1)), t_max=jnp.asarray(t_max))
    lin_j = np.asarray(lin_j)
    t_m, lin_m = trace_grid_fast(torch.from_numpy(jo), torch.from_numpy(jd),
                                 accel, t_min=torch.from_numpy(t_min),
                                 t_max=torch.from_numpy(t_max))
    hits = lin_j >= 0
    assert 0 < hits.sum() < np.isfinite(t_full.numpy()).sum()
    assert np.array_equal(lin_m.numpy(), lin_j)
    assert np.array_equal(np.isfinite(t_m.numpy()), hits)


def test_chunked_dda_matches_monolithic(scene):
    _, bb_min, bb_max, r, _ = scene
    jo, jd = _jax_rays(_camera(bb_min, bb_max, 1.0))
    o, d = torch.from_numpy(jo), torch.from_numpy(jd)
    occ = r["occ"].reshape(-1)
    args = dict(dims=r["dims"], voxel_size=r["voxel_size"])
    t, lin = trace_grid_dda(o, d, occ, r["origin"], **args)
    t_c, lin_c = trace_grid_dda_chunked(o, d, occ, r["origin"],
                                        ray_chunk=1000, **args)
    assert np.array_equal(lin_c.numpy(), lin.numpy())
    assert np.array_equal(t_c.numpy(), t.numpy())


def test_staged_backend_matches_the_megakernel(scene):
    """The staged backend (mega=False: kernels K3 grid_walk and K4
    brick_fine) is ported now: it gives the megakernel's cells and t,
    with nothing unresolved (tests/test_torch_staged.py holds it against
    JAX)."""
    _, bb_min, bb_max, _, accel = scene
    jo, jd = _jax_rays(_camera(bb_min, bb_max, 1.0))
    o, d = torch.from_numpy(jo), torch.from_numpy(jd)
    t_s, lin_s, unresolved = trace_grid_fast(o, d, accel, mega=False,
                                             return_stats=True)
    t_m, lin_m = trace_grid_fast(o, d, accel)
    assert unresolved == 0 and (lin_s >= 0).sum() > 1000
    assert torch.equal(lin_s, lin_m) and torch.equal(t_s, t_m)


def test_zero_direction_component_is_traced():
    """A ray with an exactly-zero direction component hits what the same
    ray with a tiny non-zero component hits.  (JAX's dda misses it: its
    t_next + onehot * t_delta turns the idle axis' inf into 0 * inf = NaN
    after the first step and retires the ray.)"""
    occ = np.zeros((8, 8, 8), np.uint8)
    occ[4, 2, 3] = 1                                    # z=4, y=2, x=3
    o = np.array([[0.5, 2.5, -1.0]] * 2, np.float32)
    d = np.array([[0.3, 0.0, 0.5], [0.3, 1e-9, 0.5]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    accel = build_accel(torch.from_numpy(occ), np.zeros(3, np.float32), 1.0)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    t, lin = trace_grid_dda(*args, torch.from_numpy(occ.reshape(-1)),
                            np.zeros(3, np.float32), dims=(8, 8, 8),
                            voxel_size=1.0)
    t_m, lin_m = trace_grid_fast(*args, accel)
    expect = 3 + 8 * (2 + 8 * 4)
    for tt, ll in ((t, lin), (t_m, lin_m)):
        assert ll.tolist() == [expect, expect]
        assert tt[0] == tt[1] and np.isfinite(float(tt[0]))


def _brick_edge_rays(grid, ext, n, seed):
    """Rays aimed at brick edges and corners of `grid` (two or three
    coordinates on multiples of 8 cells; half of them with 1e-6-cell
    noise), from 0.2 to 3 extents away."""
    rng = np.random.default_rng(seed)
    dims = np.asarray(grid.dims)
    p = rng.integers(0, (dims + 7) // 8 + 1, (n, 3)).astype(np.float64) * 8
    free = rng.integers(0, 4, n)            # the edge's axis; 3: a corner
    for k in range(3):
        m = free == k
        p[m, k] = rng.uniform(0, dims[k], m.sum())
    noise = rng.random(n) < 0.5
    p[noise] += rng.uniform(-1e-6, 1e-6, (noise.sum(), 3))
    target = grid.origin.astype(np.float64) \
        + p * float(np.float32(grid.voxel_size))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - d * rng.uniform(0.2, 3.0, (n, 1)) * ext
    return o.astype(np.float32), d.astype(np.float32)


# Rays of _brick_edge_rays(seed 0) on which the DDA without the near-tie
# rule walked past a sliver corner cell the oracle hits and reported a
# cell 0.04-0.08 farther, outside the adjudication envelope.
SLIVER_CORNER_RAYS = [2151, 6142, 7914, 14444, 17126, 17464]


def test_dda_near_ties_match_the_oracle():
    """The DDA's near-tie rule (K2's: tie break by the slab test, probes
    of the tied neighbours and the cells between them) on rays aimed at
    brick edges and corners of a knot: every ray that differs from the
    brute oracle adjudicates, and on SLIVER_CORNER_RAYS the DDA hits the
    oracle's cell and t."""
    v, f = torus_knot(2, 3, 256, 32)
    bb_min, bb_max = mesh_bbox(v)
    ext = float(max(bb_max - bb_min))
    g = GridBool.from_mesh(v, f, ext / 120, device="cpu")
    assert g.dims == (115, 54, 121)
    o, d = _brick_edge_rays(g, ext, 20000, 0)
    pick = np.concatenate([np.arange(4000), SLIVER_CORNER_RAYS])
    o, d = o[pick], d[pick]
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    lins = torch.nonzero(g.occupancy().reshape(-1)).squeeze(1)
    b_t, b_id = trace_aabbs_brute(ot, dt_, g.get_aabbs())
    b_lin = torch.where(b_id >= 0, lins[b_id.clamp(min=0).long()], -1)
    b_t, b_lin = b_t.numpy(), b_lin.numpy().astype(np.int32)
    t, lin = (x.numpy() for x in trace_grid_dda(
        ot, dt_, g.occupancy().reshape(-1), g.origin, dims=g.dims,
        voxel_size=g.voxel_size))
    diff = np.flatnonzero((np.isfinite(t) != np.isfinite(b_t))
                          | (np.isfinite(t) & (lin != b_lin)))
    adj = adjudicate_hit_diffs(o, d, g.occupancy().numpy().astype(bool),
                               g.origin, g.voxel_size, diff, t, lin, b_t,
                               b_lin)
    print(f"{len(pick)} brick-edge rays: {adj}")
    assert adj["adjudication_ok"], adj
    assert np.isfinite(t).sum() > len(pick) // 4
    n = len(SLIVER_CORNER_RAYS)
    assert np.array_equal(lin[-n:], b_lin[-n:])
    assert np.array_equal(t[-n:], b_t[-n:])
