"""The port's numpy oracles and native host library against the JAX
package's and the port's own references.

oracle.py and oracle_render.py are numpy in both packages, so the port's
copies must give bit-equal results on the same inputs: any difference is
a porting slip.  The native library (voxelray_torch/native, built with
g++ at first use) must parse OBJ files as the port's loader does, and
voxelize, Morton-code, sort and build octree nodes exactly as the port's
oracle, ops/morton and models/octree do.
"""
import numpy as np
import pytest
import torch

from voxelray_tpu import oracle as joracle
from voxelray_tpu.oracle_render import oracle_render as joracle_render
from voxelray_torch import native, oracle
from voxelray_torch.io import meshes
from voxelray_torch.io.objload import Material, load_mesh, write_obj
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.octree import build_nodes
from voxelray_torch.ops.morton import morton_encode3_np
from voxelray_torch.oracle_render import oracle_render
from voxelray_torch.render.camera import Camera

torch.set_num_threads(2)

# (mesh, voxel size): bunny_like(2) as the JAX native tests take it, the
# cube at 2/16 (exact division: the max-boundary drop quirk), a small knot
ORACLE_CASES = [("bunny", 0.11), ("cube", 2.0 / 16), ("knot", 0.09)]


def _mesh(name):
    if name == "bunny":
        return meshes.bunny_like(2)
    if name == "cube":
        return meshes.cube(2.0)
    return meshes.torus_knot(2, 3, 48, 12)


@pytest.mark.parametrize("name,vs", ORACLE_CASES)
def test_oracle_voxelize_equals_jax(name, vs):
    v, f = _mesh(name)
    got = oracle.oracle_voxelize(v, f, vs)
    want = joracle.oracle_voxelize(v, f, vs)
    assert got.dims == want.dims and got.voxel_size == want.voxel_size
    assert np.array_equal(got.origin, want.origin)
    assert np.array_equal(got.occupancy, want.occupancy)
    assert got.set_calls == want.set_calls > 0
    assert np.array_equal(got.hits, want.hits)


def test_oracle_tri_box_overlap_equals_jax():
    rng = np.random.default_rng(7)
    centers = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    for _ in range(16):
        tri = rng.uniform(-1.5, 1.5, (3, 3)).astype(np.float32)
        assert np.array_equal(
            oracle.oracle_tri_box_overlap(centers, 0.5, *tri),
            joracle.oracle_tri_box_overlap(centers, 0.5, *tri))


@pytest.mark.parametrize("light_type", [0, 1])
def test_oracle_render_equals_jax(light_type):
    """Voxels and a plane, point and directional light: the image and
    (through it) every hit, normal and shadow decision are equal."""
    v, f = meshes.icosphere(1)
    aabbs = GridBool.from_mesh(v, f, 0.3, device="cpu").get_aabbs().numpy()
    pv, pf = meshes.plane(10.0, y=-1.2)
    tri = pv[pf].astype(np.float32)
    tn = np.broadcast_to(np.float32([0, 1, 0]), tri.shape).copy()
    tmat = np.stack([Material(diffuse=(0.6, 0.5, 0.4)).as_row()] * len(pf))
    cam = Camera(eye=(3.0, 2.0, -3.0), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(32, 18)
    kw = dict(tri=tri, tri_normals=tn, tri_materials=tmat,
              light_type=light_type,
              light_position=(10.0, 55.0, 8.0) if light_type == 0
              else (0.3, 1.0, -0.2),
              light_intensity=1000.0 if light_type == 0 else 0.9)
    got = oracle_render(32, 18, vi, pi, aabbs, Material().as_row(), **kw)
    want = joracle_render(32, 18, vi, pi, aabbs, Material().as_row(), **kw)
    assert got.shape == (18, 32, 4)
    assert np.array_equal(got, want)
    miss = np.float32(0.8) ** np.float32(1 / 2.2)
    assert (got[..., 0] != miss).sum() > 100


def test_parse_obj_native_matches_load_mesh(tmp_path):
    v, f = meshes.bunny_like(2)
    p = tmp_path / "b.obj"
    write_obj(str(p), v, f)
    nv, nf = native.parse_obj_native(str(p))
    raw = load_mesh(str(p))
    assert nv.dtype == np.float32 and nf.dtype == np.int32
    assert np.array_equal(nv, raw.vertices)
    assert np.array_equal(nf, raw.faces)


def test_parse_obj_native_quads_and_negative_indices(tmp_path):
    p = tmp_path / "q.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                 "f -5 -4 -3 -2\nf 1/1/1 2/2/2 5/3/3\nf 2 3 4 5 1\n")
    nv, nf = native.parse_obj_native(str(p))
    raw = load_mesh(str(p))
    assert nf.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 4], [1, 2, 3],
                           [1, 3, 4], [1, 4, 0]]
    assert np.array_equal(nf, raw.faces)
    assert np.array_equal(nv, raw.vertices)


@pytest.mark.parametrize("name,vs", ORACLE_CASES)
def test_voxelize_native_equals_oracle(name, vs):
    v, f = _mesh(name)
    ref = oracle.oracle_voxelize(v, f, vs)
    occ, calls = native.voxelize_native(v, f, vs, ref.origin, ref.dims)
    assert occ.dtype == np.uint8
    assert np.array_equal(occ.astype(bool), ref.occupancy)
    assert calls == ref.set_calls


def test_voxelize_native_rejects_out_of_range_faces():
    v, f = meshes.cube(2.0)
    with pytest.raises(ValueError):
        native.voxelize_native(v, f + len(v), 0.5, v.min(0), (4, 4, 4))


@pytest.mark.parametrize("seed,n,depth,mi", [(0, 500, 4, 8), (1, 4000, 6, 16),
                                             (2, 64, 2, 1)])
def test_native_morton_sort_and_nodes_equal_the_port(seed, n, depth, mi):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.integers(0, 1 << depth, n, dtype=np.uint32)
               for _ in range(3))
    codes = native.morton_encode_native(x, y, z)
    assert np.array_equal(codes, morton_encode3_np(x, y, z))
    srt = native.sort_codes_native(codes)
    assert np.array_equal(srt, np.sort(codes))
    assert np.array_equal(native.build_octree_nodes_native(srt, depth, mi),
                          build_nodes(srt, depth, mi))
