"""The port's planned voxelize and three small functions against the JAX
package on the CPU.

The same numpy meshes go through both packages.  plan_buckets and
required_window_shape are host numpy code and must be equal.  The
planned occupancy is bit-equal to JAX's voxelize_planned inside JAX's
plan contract (the plan-time vertices, or a deform_safe plan whose
bucket shapes no deformed triangle's reference window outgrows); beyond
it the port still equals voxelize_mesh and the numpy oracle with the
plan's bbox, because K1 (here its plain version) walks each triangle's
own window.  set_calls is held to the oracle (JAX's XLA:CPU count can be
a few SAT hits off it).
"""
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.ops import voxelize as jvox
from voxelray_tpu.ops.geometry import voxel_diameter as jvoxel_diameter
from voxelray_tpu.ops.morton import sort_codes_device as jsort_codes
from voxelray_torch import native
from voxelray_torch.ops import voxelize as tvox
from voxelray_torch.ops.geometry import grid_dims, mesh_bbox, voxel_diameter
from voxelray_torch.ops.morton import sort_codes_device
from voxelray_torch.oracle import oracle_voxelize

torch.set_num_threads(2)


def _big_triangles():
    """icosphere(1) inside the 12 large triangles of a cube around it."""
    v, f = jmeshes.icosphere(1)
    cv, cf = jmeshes.cube(size=2.4)
    return (np.concatenate([v, cv]).astype(np.float32),
            np.concatenate([f, cf + len(v)]).astype(np.int32))


MESHES = {
    "icosphere2": lambda: jmeshes.icosphere(2),
    "knot": lambda: jmeshes.torus_knot(2, 3, 48, 12),
    "big_triangles": _big_triangles,
}


def _grid(v, res=24):
    bb_min, bb_max = mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / res
    return bb_min, bb_max, vs


@pytest.mark.parametrize("name", sorted(MESHES))
def test_plan_buckets_and_window_shape_match_jax(name):
    v, f = MESHES[name]()
    bb_min, bb_max, vs = _grid(v)
    dims = grid_dims(bb_min, bb_max, vs)
    assert tvox.required_window_shape(v, f, bb_min, vs, dims) == \
        jvox.required_window_shape(v, f, bb_min, vs, dims)
    for effective in (True, False):
        for max_buckets in (6, 24):
            got = tvox.plan_buckets(v, f, bb_min, vs, dims, max_buckets,
                                    effective=effective)
            want = jvox.plan_buckets(v, f, bb_min, vs, dims, max_buckets,
                                     effective=effective)
            assert [w for w, _ in got] == [w for w, _ in want]
            for (_, a), (_, b) in zip(got, want):
                assert np.array_equal(a, b)
    plan = tvox.plan_voxelize(v, f, vs, bb_min=bb_min, bb_max=bb_max,
                              window_slack=(1, 0, 2), deform_safe=True,
                              device="cpu")
    jplan = jvox.plan_voxelize(v, f, vs, bb_min=bb_min, bb_max=bb_max,
                               window_slack=(1, 0, 2), deform_safe=True)
    assert plan.dims == jplan.dims and plan.n_triangles == jplan.n_triangles
    assert np.array_equal(plan.origin, jplan.origin)
    assert plan.voxel_size == jplan.voxel_size
    assert [w for w, _ in plan.buckets] == [w for w, _ in jplan.buckets]
    for (_, a), (_, b) in zip(plan.buckets, jplan.buckets):
        assert np.array_equal(a, np.asarray(b))
    assert plan.faces.dtype == torch.int32 and plan.faces.is_contiguous()


def _within_plan(plan, v):
    """True where no triangle's reference window over v outgrows the
    shape of the bucket its plan put it in (JAX's plan contract)."""
    start, end = tvox._np_windows(v, np.concatenate(
        [fb for _, fb in plan.buckets]), plan.origin, plan.voxel_size,
        plan.dims)
    shape = np.concatenate([np.tile(w, (len(fb), 1))
                            for w, fb in plan.buckets])
    return bool((end - start <= shape).all())


@pytest.fixture(scope="module")
def fixed_case():
    """icosphere(2): a default (effective-extent) plan, JAX's planned
    occupancy on the plan-time vertices."""
    v, f = jmeshes.icosphere(2)
    bb_min, bb_max, vs = _grid(v)
    kw = dict(bb_min=bb_min, bb_max=bb_max, max_buckets=6)
    jocc, _ = jvox.voxelize_planned(jvox.plan_voxelize(v, f, vs, **kw), v)
    return v, f, vs, kw, np.asarray(jocc)


@pytest.fixture(scope="module")
def deform_case():
    """The small knot over a 4-frame animation: a deform_safe plan (two
    slabs of slack on each axis; with one, 3 and 10 triangles of frames
    2 and 3 outgrow their buckets) from frame 0 with the animation's
    bbox, JAX's planned occupancy of every frame."""
    v, f = jmeshes.torus_knot(2, 3, 48, 12)
    frames = [jmeshes.deformed(v, 2 * np.pi * i / 4) for i in range(4)]
    bb_min, bb_max = mesh_bbox(np.concatenate(frames))
    vs = float(max(bb_max - bb_min)) / 24
    kw = dict(bb_min=bb_min, bb_max=bb_max, max_buckets=6,
              window_slack=(2, 2, 2), deform_safe=True)
    jplan = jvox.plan_voxelize(frames[0], f, vs, **kw)
    jocc = [np.asarray(jvox.voxelize_planned(jplan, fv)[0])
            for fv in frames]
    return frames, f, vs, kw, jocc


def test_voxelize_planned_matches_jax_on_plan_time_vertices(fixed_case):
    v, f, vs, kw, jocc = fixed_case
    plan = tvox.plan_voxelize(v, f, vs, device="cpu", **kw)
    occ, calls = tvox.voxelize_planned(plan, v)
    assert occ.dtype == torch.uint8 and calls.dtype == torch.int64
    assert calls.dim() == 0
    assert np.array_equal(occ.numpy(), jocc) and jocc.sum() > 500
    ref = oracle_voxelize(v, f, vs, kw["bb_min"], kw["bb_max"])
    assert int(calls) == ref.set_calls
    assert torch.equal(plan(torch.from_numpy(v))[0], occ)


def test_voxelize_planned_matches_jax_on_deformed_frames(deform_case):
    frames, f, vs, kw, jocc = deform_case
    plan = tvox.plan_voxelize(frames[0], f, vs, device="cpu", **kw)
    for i, fv in enumerate(frames):
        assert _within_plan(plan, fv), f"frame {i} outgrew the plan"
        occ, calls = tvox.voxelize_planned(plan, fv)
        assert np.array_equal(occ.numpy(), jocc[i]), f"frame {i}"
        ref = oracle_voxelize(fv, f, vs, kw["bb_min"], kw["bb_max"])
        assert int(calls) == ref.set_calls, f"frame {i}"
    assert not np.array_equal(jocc[0], jocc[2])


def test_voxelize_planned_beyond_the_plan_is_the_oracle(fixed_case):
    """Vertices stretched past the plan's buckets: equal to voxelize_mesh
    and to oracle_voxelize with the plan's bbox."""
    v, f, vs, kw, _ = fixed_case
    plan = tvox.plan_voxelize(v, f, vs, device="cpu", **kw)
    stretched = (v * np.float32([1.35, 0.8, 1.2])).astype(np.float32)
    assert not _within_plan(plan, stretched)
    occ, calls = tvox.voxelize_planned(plan, stretched)
    bb = dict(bb_min=kw["bb_min"], bb_max=kw["bb_max"])
    mesh = tvox.voxelize_mesh(stretched, f, vs, device="cpu", **bb)
    ref = oracle_voxelize(stretched, f, vs, **bb)
    assert torch.equal(occ, mesh["occ"]) and int(calls) == mesh["set_calls"]
    assert np.array_equal(occ.numpy().astype(bool), ref.occupancy)
    assert int(calls) == ref.set_calls


def test_voxelize_planned_checks_its_inputs(monkeypatch):
    v, f = jmeshes.icosphere(1)
    bad = f.copy()
    bad[3, 1] = len(v)
    with pytest.raises(ValueError, match="out of range"):
        tvox.plan_voxelize(v, bad, 0.1, device="cpu")
    plan = tvox.plan_voxelize(v, f, 0.1, device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        tvox.voxelize_planned(plan, v[:-1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvox.plan_voxelize(v, f, 0.1)


def test_voxel_diameter_matches_jax():
    for s in (0.1, 2.2 / 64, 4.3 / 512, 1.0, 7.25):
        assert voxel_diameter(s) == jvoxel_diameter(s)


def test_sort_codes_device_matches_jax():
    """Random limb pairs with repeated hi values and (0xFFFFFFFF,
    0xFFFFFFFF) sentinels: JAX's order, the sentinels last; int32 bit
    patterns of the same limbs sort alike."""
    rng = np.random.default_rng(4)
    n = 5000
    hi = rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.uint32)
    hi[::7] = hi[0]
    lo = rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)
    sentinel = rng.choice(n, 40, replace=False)
    hi[sentinel] = lo[sentinel] = 0xFFFFFFFF
    jhi, jlo = (np.asarray(x) for x in jsort_codes(hi, lo))
    got = sort_codes_device(hi, lo, device="cpu")
    assert np.array_equal(got[0].numpy().astype(np.uint32), jhi)
    assert np.array_equal(got[1].numpy().astype(np.uint32), jlo)
    assert (jhi[-40:] == 0xFFFFFFFF).all()
    as_i32 = [torch.from_numpy(x.view(np.int32)) for x in (hi, lo)]
    for a, b in zip(sort_codes_device(*as_i32), got):
        assert torch.equal(a, b)


def test_native_available(monkeypatch):
    assert native.available()

    def fail():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load_library", fail)
    assert not native.available()
