"""The port's voxelize slice (voxelray_torch) against the JAX package.

The same numpy inputs go through voxelray_tpu and voxelray_torch on the
CPU, where the port runs the plain PyTorch version of kernel K1.
Occupancy must be bit-equal to JAX's.  set_calls is held to the numpy
oracle (voxelray_tpu/oracle.py), the serial reference transcription both
packages are gated on: JAX's XLA:CPU build flips a few borderline SAT
hits on already-covered cells (on the torus knot below it counts 50644
where the oracle and the port count 50647), while the port evaluates
the SAT with the oracle's uncontracted float32 expressions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.models.grids import pack_bits as jpack_bits
from voxelray_tpu.ops.sat import tri_box_overlap as jtri_box_overlap
from voxelray_tpu.ops.voxelize import voxelize_mesh as jvoxelize_mesh
from voxelray_tpu.ops.voxelize import window_bounds as jwindow_bounds
from voxelray_tpu.oracle import oracle_voxelize
from voxelray_torch.io import meshes
from voxelray_torch.models.grids import (GridBool, build_grid, pack_bits,
                                         unpack_bits)
from voxelray_torch.ops.sat import tri_box_overlap
from voxelray_torch.ops.voxelize import voxelize_mesh, window_bounds

torch.set_num_threads(2)

MESHES = {
    "icosphere2": (lambda m: m.icosphere(2), 0.08),
    "bunny3": (lambda m: m.bunny_like(3), 0.05),
    "knot96x24": (lambda m: m.torus_knot(segments=96, tube_segments=24),
                  0.07),
}


@pytest.mark.parametrize("name,args", [
    ("cube", ()), ("plane", ()), ("icosphere", (2,)), ("bunny_like", (2,)),
    ("torus_knot", (2, 3, 64, 16)),
])
def test_mesh_generators_copy_jax(name, args):
    v, f = getattr(meshes, name)(*args)
    jv, jf = getattr(jmeshes, name)(*args)
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert v.ndim == 2 and v.shape[1] == 3 and f.ndim == 2 and f.shape[1] == 3
    assert 0 <= f.min() and f.max() < len(v)
    assert np.array_equal(v, jv) and np.array_equal(f, jf)


def test_mesh_registry_and_sizes():
    for name in ("cube", "plane", "bunny", "sphere", "knot"):
        v, f = meshes.make_scene_mesh(name)
        assert f.max() < len(v)
    assert len(meshes.icosphere(3)[1]) == 20 * 4 ** 3
    assert len(meshes.torus_knot(2, 3, 128, 64)[1]) == 128 * 64 * 2
    with pytest.raises(ValueError):
        meshes.make_scene_mesh("teapot")


def test_tri_box_overlap_bit_equal_to_jax():
    """Seeded random triangles around random cells, many of them
    borderline: the predicate is bit-equal to JAX's."""
    rng = np.random.default_rng(7)
    n = 20000
    centers = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    scale = rng.uniform(0.05, 1.0, (n, 1)).astype(np.float32)
    tri = (centers[:, None, :] + rng.normal(0.0, 1.0, (n, 3, 3))
           .astype(np.float32) * scale[:, None]).astype(np.float32)
    half = np.float32(0.25)
    ref = np.asarray(jtri_box_overlap(jnp.asarray(centers), half,
                                      jnp.asarray(tri[:, 0]),
                                      jnp.asarray(tri[:, 1]),
                                      jnp.asarray(tri[:, 2])))
    out = tri_box_overlap(torch.from_numpy(centers), float(half),
                          torch.from_numpy(tri[:, 0]),
                          torch.from_numpy(tri[:, 1]),
                          torch.from_numpy(tri[:, 2])).numpy()
    assert 0.1 < ref.mean() < 0.9  # both outcomes well represented
    assert np.array_equal(out, ref)


def test_window_bounds_equal_to_jax():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-0.2, 2.0, (5000, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 0.5, (5000, 3))).astype(np.float32)
    origin = np.array([0.0, -0.013, 0.1], np.float32)
    vs, dims = 0.07, (30, 25, 28)
    js, je = jwindow_bounds(jnp.asarray(lo), jnp.asarray(hi), origin, vs,
                            dims)
    ts, te = window_bounds(torch.from_numpy(lo), torch.from_numpy(hi),
                           origin, vs, dims)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_voxelize_mesh_matches_jax(name):
    make, vs = MESHES[name]
    v, f = make(jmeshes)
    ref = jvoxelize_mesh(v, f, vs)
    out = voxelize_mesh(v, f, vs, device="cpu")
    assert out["dims"] == ref["dims"]
    assert np.array_equal(out["origin"], ref["origin"])
    occ = out["occ"].numpy()
    assert occ.dtype == np.uint8
    assert np.array_equal(occ, np.asarray(ref["occ"])), (
        f"{int((occ != np.asarray(ref['occ'])).sum())} cells differ")
    oracle = oracle_voxelize(v, f, vs)
    assert np.array_equal(occ.astype(bool), oracle.occupancy)
    assert out["set_calls"] == oracle.set_calls
    # JAX's XLA:CPU count sits within a few borderline hits of it
    assert abs(ref["set_calls"] - oracle.set_calls) <= 8


def test_cube64_invariants():
    """cube.obj at 64^3, exact division: 12097 occupied (three
    min-boundary slabs, max faces dropped by the reference's window
    truncation) and 12858 set_calls."""
    v, f = meshes.cube(2.0)
    grid = GridBool.from_mesh(v, f, 2.0 / 64, device="cpu")
    assert grid.dims == (64, 64, 64)
    assert int(grid.occupancy().sum()) == 12097
    assert grid.set_calls == 12858


def test_gridbool_pack_round_trip_and_memory():
    rng = np.random.default_rng(1)
    bits = (rng.random(32 * 37 + 5) < 0.3).astype(np.uint8)
    words = pack_bits(torch.from_numpy(bits))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(jpack_bits(jnp.asarray(bits))))
    assert np.array_equal(unpack_bits(words, len(bits)).numpy(), bits)

    v, f = meshes.bunny_like(2)
    occ = voxelize_mesh(v, f, 0.11, device="cpu")["occ"]
    grid = GridBool.from_occupancy(occ, np.zeros(3, np.float32), 0.11)
    jgrid = JGridBool.from_occupancy(jnp.asarray(occ.numpy()),
                                     np.zeros(3, np.float32), 0.11)
    assert np.array_equal(grid.words.numpy().view(np.uint32),
                          np.asarray(jgrid.words))
    assert np.array_equal(grid.occupancy().numpy(), occ.numpy())
    assert grid.memory_usage_bytes() == jgrid.memory_usage_bytes()


def test_later_slices_raise():
    """The encodings of the later slice are built now (AABBs included,
    one per occupied cell); an unknown encoding raises, and without a
    card the default device does."""
    v, f = meshes.cube(2.0)
    grid = build_grid("bool", v, f, 0.5, device="cpu")
    n_occ = int(grid.occupancy().sum())
    assert tuple(grid.get_aabbs().shape) == (n_occ, 6)
    for enc in ("aabbstruct", "vec", "octree"):
        g = build_grid(enc, v, f, 0.5, device="cpu")
        assert torch.equal(g.occupancy(), grid.occupancy()), enc
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_grid(enc, v, f, 0.5)
    with pytest.raises(ValueError):
        build_grid("nope", v, f, 0.5, device="cpu")
