"""The planned triangle scene of a deforming mesh (models/scene.plan_scene,
build_scene_planned; ops/tri_accel.plan_tri_accel, build_tri_accel_planned)
and the binning kernels (csrc/tri_bin.cu) on the CPU.

A 1,536-triangle knot under four vertex sets of io/meshes.deformed, with
one box over all four.  With two fixed triangles at that box's corners
every set's own box is the union box, so one plan's accel of each set is
build_tri_accel's (the JAX package's build over the set's own box), table
for table, and one plan's scene of each set is build_scene(models=...)'s
of the same positions, array for array; each set's frame matches the
benchmark's plain reference (benchmark/vrbench/reference.py) within the
tri-deform cell's limits.  The kernels run built for the host with g++
(tests/test_torch_kernels_host.py's shim, one-lane warps), against their
plain versions and, through the planned build, against the plain build.
No JAX: the static build is the reference here.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelray_torch.io import meshes
from voxelray_torch.io.objload import LoadedModel, Material
from voxelray_torch.io.textures import write_png
from voxelray_torch.models.scene import (build_scene, build_scene_planned,
                                         plan_scene)
from voxelray_torch.ops import tri_accel
from voxelray_torch.ops.kernels import tri_bin
from voxelray_torch.ops.tri_accel import (build_tri_accel,
                                          build_tri_accel_planned,
                                          plan_tri_accel)
from voxelray_torch.render.pipeline import render_image
from voxelray_torch.utils import trace
from voxelray_torch.utils.convert import SCENE_ARRAYS

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "voxelray_torch" / "csrc"
SETS = 4
RES = 24
# the tri-deform cell's limits (benchmark/cells/tri-deform.json)
RTOL, ATOL, PX_PPM, HIT_PPM = 2e-5, 1e-6, 2000, 500
MATERIAL = [0.1, 0.1, 0.1, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.1, 0.0, 1.0, 1.0, 0.0, -1.0]


@pytest.fixture(scope="module")
def knot():
    """(faces, the four vertex sets, the union box)."""
    v, f = meshes.torus_knot(2, 3, 48, 16)
    sets = [meshes.deformed(v, 2.0 * np.pi * k / SETS, 0.15)
            for k in range(SETS)]
    lo = np.min([s.min(axis=0) for s in sets], axis=0)
    hi = np.max([s.max(axis=0) for s in sets], axis=0)
    return f, sets, lo, hi


@pytest.fixture(scope="module")
def anchored(knot):
    """(faces, the four sets, the box): the knot with two small triangles
    added, fixed at the corners of a box around every set, so that each
    set's own bounding box is that box."""
    f, sets, lo, hi = knot
    pad = np.float32(0.1) * (hi - lo)
    a, b = lo - pad, hi + pad
    e = np.float32(0.01)
    extra = np.stack([a, a + [e, 0, 0], a + [0, e, 0],
                      b, b - [e, 0, 0], b - [0, e, 0]]).astype(np.float32)
    n = len(sets[0])
    fa = np.concatenate([f, np.arange(n, n + 6).reshape(2, 3)])
    return fa, [np.concatenate([s, extra]) for s in sets], a, b


def _flat_model(v, f):
    """The mesh as an OBJ without normals loads: a corner a row, each with
    its triangle's flat normal (the benchmark's knot_streams)."""
    p = v[f].reshape(-1, 3, 3)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), n)
    verts = np.zeros((3 * len(f), 11), np.float32)
    verts[:, 0:3] = p.reshape(-1, 3)
    verts[:, 3:6] = np.repeat(n, 3, axis=0)
    return LoadedModel(vertices=verts,
                       indices=np.arange(3 * len(f), dtype=np.uint32),
                       materials=np.asarray(MATERIAL, np.float32)[None],
                       textures=[], mat_index=np.zeros(len(f), np.int32))


def _indexed_model(v, f):
    """The mesh with shared vertices and no normals (the plan's input)."""
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    return LoadedModel(vertices=verts,
                       indices=f.reshape(-1).astype(np.uint32),
                       materials=np.asarray(MATERIAL, np.float32)[None],
                       textures=[], mat_index=np.zeros(len(f), np.int32))


def _equal_accels(a, b):
    assert (a.dims, a.l_width, a.overflow_cells, a.voxel_size) \
        == (b.dims, b.l_width, b.overflow_cells, b.voxel_size)
    for k in ("cell_slot", "cell_tris", "tri9", "origin"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("coarse", "fine", "l2", "origin"):
        assert torch.equal(getattr(a.brick, k), getattr(b.brick, k)), k
    assert a.brick.bdims == b.brick.bdims
    assert a.brick.fine_sb is None and b.brick.fine_sb is None


def _static_accel(v, f, **kw):
    """build_tri_accel over the triangles' own box."""
    tri = v[f]
    return build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=RES,
                           device="cpu", **kw)


@pytest.mark.parametrize("k", range(SETS))
def test_planned_accel_equals_the_static_build(anchored, k):
    """build_tri_accel_planned over set k, from one plan over the union box
    for all sets: build_tri_accel's tables over set k's own box (the
    union box), bit for bit (cell_slot, rows ascending, tri9, l_width,
    the brick words); nothing outside."""
    f, sets, lo, hi = anchored
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    trace.reset_counters("tri_accel.")
    got = build_tri_accel_planned(plan, sets[k])
    c = trace.counters()
    _equal_accels(got, _static_accel(sets[k], f))
    assert c["tri_accel.outside"] == 0 and c["tri_accel.overflow_cells"] == 0
    assert c["tri_accel.nonempty_cells"] == int((got.cell_slot >= 0).sum())
    assert c["tri_accel.pairs"] == int((got.cell_tris >= 0).sum())
    assert c["tri_accel.row_slots"] == got.cell_tris.numel()


@pytest.mark.parametrize("k", range(SETS))
def test_planned_scene_equals_build_scene(anchored, k):
    """build_scene_planned over set k (one plan over the union box) against
    build_scene of the same positions as an OBJ without normals loads
    them: every array render_image reads equal, the flat normals the
    loader's, the accel table for table."""
    f, sets, lo, hi = anchored
    plan = plan_scene([_indexed_model(sets[0], f)], bb_min=lo, bb_max=hi,
                      device="cpu")
    got = build_scene_planned(plan, torch.from_numpy(sets[k]))
    want = build_scene(models=[_flat_model(sets[k], f)], device="cpu")
    for name in SCENE_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.grid_dims == want.grid_dims and got.accel is None
    _equal_accels(got.tri_accel, want.tri_accel)


def test_plan_over_the_meshs_own_box_is_build_scene(knot):
    """Without a box the plan takes the models' own: its first scene is
    build_scene's, the accel included."""
    f, sets, _, _ = knot
    plan = plan_scene([_indexed_model(sets[1], f)], device="cpu")
    got = build_scene_planned(plan, sets[1])
    want = build_scene(models=[_flat_model(sets[1], f)], device="cpu")
    _equal_accels(got.tri_accel, want.tri_accel)


def _textured_model(v, f, tex, rng):
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    verts[:, 3:6] = v / np.linalg.norm(v, axis=1, keepdims=True)
    verts[:, 9:11] = rng.uniform(-0.5, 1.5, (len(v), 2))
    plain = Material().as_row()
    textured = plain.copy()
    textured[19] = 0
    return LoadedModel(vertices=verts,
                       indices=f.reshape(-1).astype(np.uint32),
                       materials=np.stack([plain, textured]),
                       mat_index=rng.integers(0, 2, len(f)).astype(np.int32),
                       textures=[tex])


def test_textured_scene_with_normals_equals_build_scene(tmp_path):
    """A textured model with vertex normals, deformed: tri_lod (made each
    step from the step's areas) and the corner normals given to the step
    equal build_scene's of the same deformed model."""
    rng = np.random.default_rng(5)
    img = np.stack(np.meshgrid(np.linspace(0, 1, 12),
                               np.linspace(1, 0, 9)), -1)
    write_png(str(tmp_path / "tex.png"),
              np.concatenate([img, img[..., :1] * img[..., 1:]], -1))
    v, f = meshes.icosphere(2)
    model = _textured_model(v, f, str(tmp_path / "tex.png"), rng)
    plan = plan_scene([model], bb_min=v.min(0) - 0.3, bb_max=v.max(0) + 0.3,
                      device="cpu")
    moved = meshes.deformed(v, 1.3, 0.1)
    nrm = model.vertices[:, 3:6] * np.float32(0.5)
    got = build_scene_planned(plan, moved, normals=nrm)
    verts = model.vertices.copy()
    verts[:, 0:3], verts[:, 3:6] = moved, nrm
    want = build_scene(models=[LoadedModel(
        vertices=verts, indices=model.indices, materials=model.materials,
        mat_index=model.mat_index, textures=model.textures)], device="cpu")
    assert bool((want.tri_tex >= 0).any()) and bool((want.tri_lod != 0).any())
    for name in SCENE_ARRAYS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_a_set_outside_the_box_is_counted(knot):
    """Vertices that leave the plan's box: each triangle with a corner
    outside counts in tri_accel.outside (a NaN corner too); its window is
    clamped to the grid, as the box is the caller's promise."""
    f, sets, lo, hi = knot
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    out = sets[2] * np.float32(1.2)
    out[0, 0] = np.nan
    tri = out[f]
    want = int((~((tri >= lo) & (tri <= hi)).reshape(len(f), -1).all(1))
               .sum())
    trace.reset_counters("tri_accel.")
    build_tri_accel_planned(plan, out)
    assert trace.counter("tri_accel.outside") == want > 0


def test_rows_are_never_cut(anchored, monkeypatch):
    """With a first width narrower than the widest cell the rebuild
    widens to the second and keeps every row (build_tri_accel at that
    width); with the second narrower too it returns None (the brute
    trace) and counts the overflowing cells."""
    f, sets, lo, hi = anchored
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    monkeypatch.setattr(tri_accel, "L_WIDTHS", (2, 4096))
    got = build_tri_accel_planned(plan, sets[3])
    want = _static_accel(sets[3], f, max_l_width=4096)
    assert 2 < want.l_width and want.overflow_cells == 0
    _equal_accels(got, want)
    monkeypatch.setattr(tri_accel, "L_WIDTHS", (2, 3))
    trace.reset_counters("tri_accel.")
    assert build_tri_accel_planned(plan, sets[3]) is None
    overflow = trace.counter("tri_accel.overflow_cells")
    assert overflow == _static_accel(sets[3], f,
                                     l_width=3).overflow_cells > 0


def test_each_sets_frame_matches_the_benchmark_reference(knot):
    """render_image of each set's planned scene against the benchmark's
    plain reference of that set, within the tri-deform cell's limits."""
    sys.path.insert(0, str(REPO / "benchmark"))
    from vrbench import check, inputs, reference
    f, sets, lo, hi = knot
    w, h = 64, 32
    shading = {"light": {"position": [10.0, 55.0, 8.0],
                         "intensity": 1000.0, "type": 0},
               "material": MATERIAL, "clear_color": [1.0, 1.0, 1.0, 1.0]}
    center = tuple(float(c) for c in (lo + hi) * 0.5)
    vi, pi = inputs.camera_matrices((3.9, 3.1, -3.4), center, w, h)
    plan = plan_scene([_indexed_model(sets[0], f)], bb_min=lo, bb_max=hi,
                      device="cpu")
    for v in sets:
        img = render_image(build_scene_planned(plan, v), vi, pi, width=w,
                           height=h, backend="fast")
        ref = reference.render(reference.TriangleScene(v, f, 24,
                                                       torch.device("cpu")),
                               vi, pi, w, h, shading, torch.device("cpu"))
        px, hit = check.compare_frames(img, ref, shading["clear_color"],
                                       RTOL, ATOL)
        assert px * 1e6 / (w * h) <= PX_PPM and hit * 1e6 / (w * h) \
            <= HIT_PPM
        assert (ref[..., 0] != ref[0, 0, 0]).sum() > 100


# ------------------------------------------------ the kernels, host-built

@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    """(count, emit): tri_bin.count / emit with the host build of
    csrc/tri_bin.cu in the kernels' place, on CPU tensors: the wrapper's
    argument blocks through the source's own launchers; `blocks` (0: the
    launcher's) sets the grid."""
    from test_torch_kernels_host import _host_build, _launch
    lib = _host_build(tmp_path_factory.mktemp("tri_bin"), "tri_bin",
                      (CSRC / "tri_bin.cu").read_text(), "", CSRC)

    def run(name, a, outs, blocks):
        for x in outs[:2 if name == "tri_bin_emit_launch" else 1]:
            x.fill_(-7)
        lib.host_set_blocks(blocks)
        _launch(lib, a, name)
        return outs

    def count(tri9, n_tri, origin, vs, dims, lo, hi, blocks=0):
        return run("tri_bin_count_launch", *tri_bin.bin_args(
            tri9, n_tri, origin, vs, dims, lo, hi), blocks)

    def emit(tri9, n_tri, origin, vs, dims, cum, n_pairs, blocks=0):
        return run("tri_bin_emit_launch", *tri_bin.bin_args(
            tri9, n_tri, origin, vs, dims, cum=cum, n_pairs=n_pairs), blocks)

    return count, emit


def _mixed_tri9(knot):
    """The knot's set 1 with a NaN corner, a triangle outside the box, a
    degenerate one and one with a tall window, as the kernels' input."""
    f, sets, lo, hi = knot
    tri = sets[1][f].copy()
    tri[5, 1, 2] = np.nan
    tri[9] += np.float32(3.0)                      # outside, clamped
    tri[11, 1] = tri[11, 0]                        # degenerate
    tri[13] = [lo, hi, [lo[0], hi[1], lo[2]]]      # spans the grid
    return torch.cat([torch.from_numpy(tri.reshape(-1, 9)),
                      torch.zeros((1, 9))])


@pytest.mark.parametrize("blocks", [0, 1])
def test_host_tri_bin_matches_plain(knot, host_bin, blocks):
    """The count pass (each triangle's hits, each cell's, the triangles
    outside the box) and the emit pass (the pairs in serial order, at
    each triangle's offset) equal the plain versions on mixed triangles;
    with the launcher's grid and with one block striding over them."""
    f, sets, lo, hi = knot
    count, emit = host_bin
    tri9 = _mixed_tri9(knot)
    n = len(f)
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    got = count(tri9, n, origin, vs, dims, lo, hi, blocks)
    want = tri_bin.count_plain(tri9, n, origin, vs, dims, lo, hi)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[2]) == 2                         # the NaN and the moved
    cum = torch.cumsum(got[0], 0)
    pairs = emit(tri9, n, origin, vs, dims, cum, int(cum[-1]), blocks)
    for a, b in zip(pairs, tri_bin.emit_plain(tri9, n, origin, vs, dims)):
        assert torch.equal(a, b)


def test_host_kernel_path_builds_the_plain_accel(knot, host_bin,
                                                 monkeypatch):
    """build_tri_accel_planned through the kernels' path (count, the one
    sizing copy, emit, the stable sort by cell), the host-built kernels in
    the card's place: the plain path's accel, table for table, on every
    set."""
    f, sets, lo, hi = knot
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    want = [build_tri_accel_planned(plan, v) for v in sets]
    count, emit = host_bin
    calls = []

    def counting(fn):
        def wrapped(*a):
            calls.append(fn)
            return fn(*a)
        return wrapped
    monkeypatch.setattr(tri_accel, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(tri_bin, "count", counting(count))
    monkeypatch.setattr(tri_bin, "emit", counting(emit))
    for v, b in zip(sets, want):
        _equal_accels(build_tri_accel_planned(plan, v), b)
    assert calls == [count, emit] * SETS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tri_bin_matches_plain_on_cuda(knot, cuda):
    """On the card: the kernels against their plain versions on the same
    card, and the planned accel against the plain path's."""
    f, sets, lo, hi = knot
    tri9 = _mixed_tri9(knot).to(cuda)
    n = len(f)
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    got = tri_bin.count(tri9, n, origin, vs, dims, lo, hi)
    want = tri_bin.count_plain(tri9, n, origin, vs, dims, lo, hi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cum = torch.cumsum(got[0], 0)
    for a, b in zip(tri_bin.emit(tri9, n, origin, vs, dims, cum,
                                 int(cum[-1])),
                    tri_bin.emit_plain(tri9, n, origin, vs, dims)):
        assert torch.equal(a, b)
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device=cuda)
    on_cpu = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                            device="cpu")
    for v in sets:
        ta = build_tri_accel_planned(plan, torch.from_numpy(v).to(cuda))
        ref = build_tri_accel_planned(on_cpu, v)
        for k in ("cell_slot", "cell_tris", "tri9"):
            assert torch.equal(getattr(ta, k).cpu(), getattr(ref, k)), k
