"""The port's AABB extraction, GridBool queries and brute AABB trace
against the JAX package on the CPU.

Tolerances:
  * aabbs_from_linear, GridBool.get_aabbs, extract_aabbs and the rows of
    both fixed extractions (from occupancy and from words) are bit-equal
    to JAX's aabbs_from_linear of the same cells and to the numpy float32
    expression (uncontracted); count and the zero tail are equal to
    JAX's extract_aabbs_fixed for every capacity case of
    tests/test_grids.py (tight, padded, undersized word, undersized
    byte, a group bound) and an empty grid.  JAX's jitted extraction
    contracts the centre into an FMA on XLA:CPU, so its rows are held
    to the port's within one float32 ulp (the count of such values is
    printed).
  * get_voxel / get_coords / IndexError: equal to JAX's.
  * trace_aabbs_brute / any_hit_aabbs_brute: hit mask and box id equal
    to JAX's (ties to the lowest index: of duplicate boxes the first
    copy), t bit-equal (the slab expression has nothing to contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.models.grids import GridVec as JGridVec
from voxelray_tpu.ops import aabbs as jaabbs
from voxelray_tpu.ops.intersect import make_camera_rays as jmake_rays
from voxelray_tpu.ops.traverse import any_hit_aabbs_brute as jany_hit
from voxelray_tpu.ops.traverse import trace_aabbs_brute as jtrace
from voxelray_tpu.render.camera import Camera
from voxelray_torch.models.grids import GridBool
from voxelray_torch.ops import aabbs
from voxelray_torch.ops.traverse import (any_hit_aabbs_brute,
                                         trace_aabbs_brute)
from voxelray_torch.utils.convert import grid_from_numpy

torch.set_num_threads(2)

ORIGIN = np.float32([-1.3, 0.7, 2.1])


def _grid(seed, shape, p):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.uint8)


# the grids of tests/test_grids.py:117-216 (seed, (Z, Y, X), density)
GRIDS = {"33x17x12": (21, (12, 17, 33), 0.2),
         "29x13x9": (5, (9, 13, 29), 0.25),
         "37x9x11": (9, (11, 9, 37), 0.3)}


def _numpy_rows(occ, origin, vs):
    """The numpy float32 aabbs_from_linear of np.flatnonzero."""
    nz, ny, nx = occ.shape
    lin = np.flatnonzero(occ.reshape(-1))
    x, y, z = lin % nx, (lin // nx) % ny, lin // (nx * ny)
    v = np.float32(vs)
    h = np.float32(0.5) * v
    c = [origin[i] + (a.astype(np.float32) + np.float32(0.5)) * v
         for i, a in enumerate((x, y, z))]
    return np.stack([c[0] - h, c[1] - h, c[2] - h, c[0] + h, c[1] + h,
                     c[2] + h], axis=-1)


def _words(occ):
    flat = occ.reshape(-1).astype(bool)
    nw = -(-flat.size // 32)
    return np.packbits(np.pad(flat, (0, nw * 32 - flat.size)).reshape(nw, 32),
                       axis=1, bitorder="little").view(np.uint32)[:, 0]


@pytest.mark.parametrize("vs,origin", [(0.25, np.zeros(3, np.float32)),
                                       (0.07, ORIGIN), (0.11, ORIGIN)])
def test_aabbs_from_linear_bit_equal(vs, origin):
    dims = (33, 17, 12)
    lin = np.arange(33 * 17 * 12, dtype=np.int32)
    want = np.asarray(jaabbs.aabbs_from_linear(jnp.asarray(lin), dims,
                                               origin, vs))
    got = aabbs.aabbs_from_linear(torch.from_numpy(lin), dims, origin,
                                  vs).numpy()
    assert got.dtype == np.float32 and got.shape == (len(lin), 6)
    assert np.array_equal(got, want)
    occ = np.ones((12, 17, 33), np.uint8)
    assert np.array_equal(got, _numpy_rows(occ, origin, vs))


def _cases():
    out = []
    for name, (seed, shape, p) in GRIDS.items():
        occ = _grid(seed, shape, p)
        nzw = jaabbs.count_nonzero_words(occ)
        nzb = jaabbs.count_nonzero_bytes(occ)
        nzg = jaabbs.count_nonzero_groups(occ)
        n = int(occ.sum())
        out += [(name, "tight", dict(capacity=n)),
                (name, "padded", dict(capacity=4096)),
                (name, "word stats", dict(capacity=4096, word_capacity=nzw)),
                (name, "word +7", dict(capacity=4096, word_capacity=nzw + 7)),
                (name, "capacity short", dict(capacity=n // 3)),
                (name, "group", dict(capacity=4096, group_capacity=nzg)),
                (name, "byte tight", dict(capacity=4096, word_capacity=nzw,
                                          byte_capacity=nzb))]
        for wc in (1, nzw // 2, nzw - 1):
            out.append((name, f"word under {wc}",
                        dict(capacity=4096, word_capacity=wc)))
        out += [(name, "byte half", dict(capacity=4096, word_capacity=nzw,
                                         byte_capacity=max(1, nzb // 2))),
                (name, "group half", dict(capacity=4096,
                                          group_capacity=max(1, nzg // 2),
                                          word_capacity=nzw))]
    return out


CASES = _cases()


@pytest.mark.parametrize("name,case,kw", CASES,
                         ids=[f"{a}-{b}" for a, b, _ in CASES])
def test_fixed_extraction_matches_jax(name, case, kw):
    """Every capacity case: count (the full popcount), the rows kept and
    the zero tail equal to JAX's; rows bit-equal to the numpy rows of the
    same cells; from the occupancy and from the packed words alike."""
    seed, shape, p = GRIDS[name]
    occ = _grid(seed, shape, p)
    dims = (shape[2], shape[1], shape[0])
    vs = 0.25
    words = _words(occ)
    assert (words >> np.uint32(31)).any()      # bit-31 words are covered
    ref = _numpy_rows(occ, ORIGIN, vs)
    ja, jc = jaabbs.extract_aabbs_fixed(jnp.asarray(occ), ORIGIN, dims=dims,
                                        voxel_size_static=vs, **kw)
    ja = np.asarray(ja)
    kept = int(np.asarray(ja).any(axis=1).sum())
    for got, count in (
            aabbs.extract_aabbs_fixed(torch.from_numpy(occ), ORIGIN,
                                      dims=dims, voxel_size=vs, **kw),
            aabbs.extract_aabbs_words(torch.from_numpy(words.view(np.int32)),
                                      ORIGIN, dims=dims, voxel_size=vs,
                                      **kw)):
        got = got.numpy()
        assert int(count) == int(jc) == len(ref)
        assert got.shape == ja.shape
        assert int(got.any(axis=1).sum()) == kept
        assert np.array_equal(got[:kept], ref[:kept])
        assert not got[kept:].any()
        # JAX's jitted rows: the FMA-contracted centre, one ulp at most
        off = got[:kept] != ja[:kept]
        ulp = np.spacing(np.abs(got[:kept]))
        assert (np.abs(got[:kept] - ja[:kept]) <= ulp).all()
    print(f"{name} {case}: {kept} rows of {len(ref)}, {int(off.sum())} "
          "values one ulp off JAX's jitted rows")
    if case in ("tight", "padded", "word stats", "byte tight"):
        assert kept == len(ref)
    if case.startswith(("word under", "byte half", "capacity short",
                        "group half")):
        assert kept < len(ref)


def test_empty_grid_and_counts():
    occ = np.zeros((4, 5, 6), np.uint8)
    got, count = aabbs.extract_aabbs_fixed(torch.from_numpy(occ), ORIGIN,
                                           capacity=8, dims=(6, 5, 4),
                                           voxel_size=0.5)
    assert int(count) == 0 and not got.any() and got.shape == (8, 6)
    got, count = aabbs.extract_aabbs_words(
        torch.zeros(0, dtype=torch.int32), ORIGIN, capacity=8,
        dims=(0, 0, 0), voxel_size=0.5)
    assert int(count) == 0 and not got.any()
    assert aabbs.extract_aabbs({"occ": torch.from_numpy(occ),
                                "dims": (6, 5, 4), "origin": ORIGIN,
                                "voxel_size": 0.5}).shape == (0, 6)
    for name, (seed, shape, p) in GRIDS.items():
        occ = _grid(seed, shape, p)
        for fn in ("count_occupied", "count_nonzero_words",
                   "count_nonzero_bytes", "count_nonzero_groups"):
            assert getattr(aabbs, fn)(torch.from_numpy(occ)) == \
                getattr(jaabbs, fn)(occ), (name, fn)


@pytest.mark.parametrize("name", list(GRIDS))
def test_gridbool_queries_match_jax(name):
    """get_voxel, get_coords, IndexError, get_aabbs and extract_aabbs."""
    seed, shape, p = GRIDS[name]
    occ = _grid(seed, shape, p)
    vs = 0.07
    grid = grid_from_numpy(occ, ORIGIN, vs)
    jgrid = JGridBool.from_occupancy(jnp.asarray(occ), ORIGIN, vs)
    nx, ny, nz = grid.dims
    rng = np.random.default_rng(seed)
    for x, y, z in zip(rng.integers(0, nx, 40), rng.integers(0, ny, 40),
                       rng.integers(0, nz, 40)):
        assert grid.get_voxel(x, y, z) == jgrid.get_voxel(x, y, z)
        assert np.array_equal(grid.get_coords(x, y, z),
                              jgrid.get_coords(x, y, z))
    # the last cell sits in a bit-31 word position
    assert grid.get_voxel(nx - 1, ny - 1, nz - 1) == \
        jgrid.get_voxel(nx - 1, ny - 1, nz - 1)
    for bad in ((nx, 0, 0), (0, ny, 0), (0, 0, nz), (-1, 0, 0)):
        for g in (grid, jgrid):
            with pytest.raises(IndexError):
                g.get_voxel(*bad)
            with pytest.raises(IndexError):
                g.get_coords(*bad)
    want = np.asarray(jgrid.get_aabbs())
    assert np.array_equal(grid.get_aabbs().numpy(), want)
    assert np.array_equal(aabbs.extract_aabbs(grid).numpy(), want)
    assert np.array_equal(want, _numpy_rows(occ, ORIGIN, vs))
    got, count = grid.get_aabbs_fixed(len(want) + 5)
    assert int(count) == len(want)
    assert np.array_equal(got.numpy()[:len(want)], want)


@pytest.fixture(scope="module")
def brute_setup():
    """A GridVec list (duplicates kept) and rays: the bench-style camera
    and 256 random rays."""
    v, f = jmeshes.bunny_like(2)
    boxes = np.array(JGridVec.from_mesh(v, f, 0.11).aabbs)
    w, h = 48, 27
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) * 0.5
    cam = Camera(eye=tuple(center + np.float32([0.9, 0.55, -0.9])
                           * 1.3 * float(max(hi - lo))),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(w, h)
    o, d = jmake_rays(w, h, vi, pi)
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    rng = np.random.default_rng(11)
    o2 = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d2 = rng.normal(size=(256, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return boxes, np.concatenate([o, o2]), np.concatenate([d, d2])


def test_brute_trace_matches_jax(brute_setup):
    boxes, o, d = brute_setup
    uniq = np.unique(boxes, axis=0)
    assert len(uniq) < len(boxes)            # duplicates are present
    jt, jid = (np.asarray(x) for x in jtrace(jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(boxes)))
    t, pid = trace_aabbs_brute(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(boxes))
    t, pid = t.numpy(), pid.numpy()
    hit = np.isfinite(jt)
    assert hit.sum() > 100
    assert np.array_equal(np.isfinite(t), hit)
    assert np.array_equal(pid, jid)
    assert np.array_equal(t[hit], jt[hit])
    # the hit id is the first copy of its box
    for i in np.flatnonzero(hit)[:200]:
        first = np.flatnonzero((boxes == boxes[pid[i]]).all(axis=1))[0]
        assert pid[i] == first


def test_brute_any_hit_matches_jax(brute_setup):
    """Per-ray t_max (a shadow pass's light distance) and an empty list."""
    boxes, o, d = brute_setup
    rng = np.random.default_rng(3)
    tmax = rng.uniform(0.5, 6.0, len(o)).astype(np.float32)
    want = np.asarray(jany_hit(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(boxes), t_max=jnp.asarray(tmax)))
    got = any_hit_aabbs_brute(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(boxes),
                              t_max=torch.from_numpy(tmax)).numpy()
    assert 0 < want.sum() < len(want)
    assert np.array_equal(got, want)
    t, pid = trace_aabbs_brute(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros((0, 6)))
    assert not torch.isfinite(t).any() and (pid == -1).all()


def test_gridbool_from_mesh_aabbs_match_jax():
    """A voxelized mesh end to end: the port's GridBool AABBs equal
    JAX's."""
    v, f = jmeshes.icosphere(2)
    g = GridBool.from_mesh(v, f, 0.08, device="cpu")
    jg = JGridBool.from_mesh(v, f, 0.08)
    want = np.asarray(jg.get_aabbs())
    assert np.array_equal(g.get_aabbs().numpy(), want)
    got, count = g.get_aabbs_fixed(1 << 12)
    assert int(count) == len(want)
    assert np.array_equal(got.numpy()[:len(want)], want)
