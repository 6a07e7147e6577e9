"""The planned triangle scene of a deforming mesh (models/scene.plan_scene,
build_scene_planned; ops/tri_accel.plan_tri_accel, build_tri_accel_planned)
and the kernels that build its step (csrc/tri_bin.cu: the corners, count,
cells, emit and rows passes) on the CPU.

A 1,536-triangle knot under four vertex sets of io/meshes.deformed, with
one box over all four.  With two fixed triangles at that box's corners
every set's own box is the union box, so one plan's accel of each set is
build_tri_accel's (the JAX package's build over the set's own box), table
for table, and one plan's scene of each set is build_scene(models=...)'s
of the same positions, array for array; each set's frame matches the
benchmark's plain reference (benchmark/vrbench/reference.py) within the
tri-deform cell's limits.  The kernels run built for the host with g++
(tests/test_torch_kernels_host.py's shim, one-lane warps), against their
plain versions and, through the planned build, against the plain build;
the host's serial emit fills each row in order, so the rows pass is also
given shuffled rows, and CLUSTERS piles triangles into a few cells for
rows longer than the warp path.  No JAX: the static build is the
reference here.
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
    return _static_accel_of(v[f], **kw)


def _static_accel_of(tri, device="cpu", **kw):
    """build_tri_accel of (F, 3, 3) triangles over their own box."""
    return build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=RES,
                           device=device, **kw)


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

class HostBin:
    """tri_bin's count, cells and rows with the host build of
    csrc/tri_bin.cu in the kernels' place, on CPU tensors: the wrapper's
    argument blocks through the source's own launchers, each output filled
    with garbage first; `blocks` (0: the launcher's) sets the grid, and
    `entries` lists every entry point run."""

    def __init__(self, lib):
        self.lib, self.blocks, self.entries = lib, 0, []

    def run(self, entry, a):
        from test_torch_kernels_host import _launch
        self.entries.append(entry)
        self.lib.host_set_blocks(self.blocks)
        _launch(self.lib, a, entry + "_launch")

    def count(self, tri9, n_tri, origin, vs, dims, lo, hi):
        a, outs = tri_bin.count_args(tri9, n_tri, origin, vs, dims, lo, hi)
        for x in outs:
            x.fill_(-7)
        self.run("tri_bin_count", a)
        return outs

    def corners(self, verts, corners):
        a, outs = tri_bin.corners_args(verts, corners)
        for x in outs:
            x.fill_(-7.0)
        self.run("tri_corners", a)
        return outs

    def cells(self, cell_count, sizes, widths):
        a, (cell_slot, mask) = tri_bin.cells_args(cell_count, sizes, widths)
        cell_slot.fill_(-7)
        mask.fill_(7)
        self.run("tri_cells", a)
        return cell_slot, mask

    def emit(self, tri9, n_tri, origin, vs, dims, cell_slot, n_rows,
             l_width):
        """The emit pass alone: (its block, cell_tris), the rows filled but
        not ordered, the rest of each row garbage."""
        a, cell_tris = tri_bin.rows_args(tri9, n_tri, origin, vs, dims,
                                         cell_slot, n_rows, l_width)
        cell_tris.fill_(-7)
        self.run("tri_bin_emit", a)
        return a, cell_tris

    def rows(self, tri9, n_tri, origin, vs, dims, cell_slot, n_rows,
             l_width, wide):
        a, cell_tris = self.emit(tri9, n_tri, origin, vs, dims, cell_slot,
                                 n_rows, l_width)
        for entry in tri_bin.row_passes(wide)[1:]:
            self.run(entry, a)
        return cell_tris


@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    from test_torch_kernels_host import _host_build
    return HostBin(_host_build(tmp_path_factory.mktemp("tri_bin"), "tri_bin",
                               (CSRC / "tri_bin.cu").read_text(), "", CSRC))


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


# triangles piled into one cell each, near four corners of the knot's box:
# a row as wide as the warp path holds, one wider, and one much wider
CLUSTERS = (48, 64, 65, 150)
# a row longer than the wide path orders in shared memory (L_WIDTHS[1])
PILE = (4200,)


def _clustered(knot, clusters=CLUSTERS, spread=1 / 3):
    """(faces, vertices): the knot's set 1 and, in up to four cells of the
    tri grid at RES, clusters[i] small triangles each, every corner within
    `spread` cells of the cell's centre."""
    f, sets, lo, hi = knot
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    rng = np.random.default_rng(20)
    v, faces = [sets[1]], [f]
    n = len(sets[1])
    for k, m in enumerate(clusters):
        cell = np.array([1 if k & 1 else dims[0] - 2, 1 if k & 2 else
                         dims[1] - 2, 1 if k < 2 else dims[2] - 2])
        centre = origin + (cell + 0.5) * vs
        v.append((centre + rng.uniform(-vs * spread, vs * spread,
                                       (3 * m, 3)))
                 .astype(np.float32))
        faces.append(n + np.arange(3 * m).reshape(m, 3))
        n += 3 * m
    return np.concatenate(faces), np.concatenate(v)


def _plain_tables(tri9, n, origin, vs, dims, lo, hi,
                  widths=tri_accel.L_WIDTHS):
    """The plain path's (cell_count, sizes, cell_slot, mask, cell_tris) of
    the first n rows of tri9: the rows from emit_plain's serial pairs,
    sorted by cell (stably: each cell's triangles stay ascending)."""
    cell_count, sizes = tri_bin.count_plain(tri9, n, origin, vs, dims, lo,
                                            hi)
    cell_slot, mask = tri_bin.cells_plain(cell_count, sizes, widths)
    p_tri, p_lin = tri_bin.emit_plain(tri9, n, origin, vs, dims)
    p_lin, order = torch.sort(p_lin, stable=True)
    n_rows = max(1, int(sizes[tri_bin.SIZES.index("nonempty")]))
    l_width = max(1, int(sizes[tri_bin.SIZES.index("widest")]))
    cell_tris = tri_bin.rows_plain(p_tri[order], p_lin, cell_slot, n_rows,
                                   l_width)
    return cell_count, sizes, cell_slot, mask, cell_tris


def _shuffle_rows(cell_tris, seed):
    """Each row's filled entries in a random order, in place (the host
    build's serial emit leaves them ascending)."""
    rng = np.random.default_rng(seed)
    for r in range(cell_tris.shape[0]):
        n = int((cell_tris[r] >= 0).sum())
        cell_tris[r, :n] = cell_tris[r, torch.from_numpy(rng.permutation(n))]


@pytest.mark.parametrize("blocks", [0, 1])
def test_host_tri_bin_matches_plain(knot, host_bin, blocks):
    """The count pass (each cell's hits, the triangles outside the box),
    the cells pass (cell_slot, the mask, the sizes block) and the emit and
    rows passes (each row's triangles ascending, then -1) equal the plain
    versions on mixed triangles, the rows those of emit_plain's serial
    pairs; with the launcher's grid and with one block striding over
    them."""
    f, sets, lo, hi = knot
    host_bin.blocks = blocks
    tri9 = _mixed_tri9(knot)
    n = len(f)
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    want = _plain_tables(tri9, n, origin, vs, dims, lo, hi)
    cell_count, sizes = host_bin.count(tri9, n, origin, vs, dims, lo, hi)
    cell_slot, mask = host_bin.cells(cell_count, sizes, tri_accel.L_WIDTHS)
    assert int(sizes[tri_bin.SIZES.index("outside")]) == 2  # NaN, moved
    got = (cell_count, sizes, cell_slot, mask, host_bin.rows(
        tri9, n, origin, vs, dims, cell_slot, *want[4].shape, 0))
    for name, a, b in zip(("cell_count", "sizes", "cell_slot", "mask",
                           "cell_tris"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("blocks", [0, 1])
@pytest.mark.parametrize("widths", [(2, 5), tri_accel.L_WIDTHS])
def test_host_cells_pass_matches_plain(knot, host_bin, widths, blocks):
    """The cells pass over the knot's cell counts, a hundred chunks of 64
    cells on the host build's one-lane warps (each chunk's rows numbered
    after the chunks before it, by the look-back): cell_slot (-1 at the
    end), the mask and every word of the sizes block equal the plain
    version's, with widths the knot's cells outgrow and the planned
    build's."""
    f, sets, lo, hi = knot
    host_bin.blocks = blocks
    tri9 = _mixed_tri9(knot)
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    cell_count, sizes = tri_bin.count_plain(tri9, len(f), origin, vs, dims,
                                            lo, hi)
    want_sizes = sizes.clone()
    want = tri_bin.cells_plain(cell_count, want_sizes, widths)
    got = host_bin.cells(cell_count, sizes, widths)
    assert cell_count.numel() >= 100 * tri_bin.CHUNK_MIN
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(sizes, want_sizes)
    words = dict(zip(tri_bin.SIZES, sizes.tolist()))
    assert words["wide"] == 0 and (words["over0"] > words["over1"] > 0
                                   if widths == (2, 5) else
                                   words["over0"] == words["over1"] == 0)


@pytest.mark.parametrize("blocks", [0, 1])
def test_host_corners_pass_matches_plain(knot, host_bin, blocks):
    """The corners pass over the knot's set 2 with a degenerate triangle
    and one of zero area: tri9 (its pad row zero), the three corner
    arrays, the flat normals and the areas equal the plain version's bit
    for bit."""
    f, sets, lo, hi = knot
    host_bin.blocks = blocks
    v = torch.from_numpy(sets[2])
    faces = f.copy()
    faces[3, 1] = faces[3, 0]                       # degenerate
    faces[4] = faces[4, 0]                          # a point
    corners = torch.from_numpy(faces.reshape(-1).astype(np.int64))
    got = host_bin.corners(v, corners)
    want = tri_bin.corners_plain(v, corners)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
    assert not got[0][-1].any() and not got[4][4].any()


@pytest.mark.parametrize("blocks", [0, 1])
def test_host_rows_pass_orders_shuffled_rows(knot, host_bin, blocks):
    """The rows pass given each row's entries in a random order (as the
    card's atomics leave them) and garbage pads: each row ascending, then
    -1, the plain path's table."""
    f, sets, lo, hi = knot
    host_bin.blocks = blocks
    tri9 = _mixed_tri9(knot)
    n = len(f)
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    *_, cell_slot, _, want = _plain_tables(tri9, n, origin, vs, dims, lo, hi)
    a, cell_tris = host_bin.emit(tri9, n, origin, vs, dims, cell_slot,
                                 *want.shape)
    filled = cell_tris >= 0
    assert torch.equal(filled, want >= 0)
    _shuffle_rows(cell_tris, blocks)
    cell_tris[~filled] = -7
    assert not torch.equal(cell_tris, want)
    host_bin.run("tri_rows", a)
    assert torch.equal(cell_tris, want)


def test_host_wide_rows_take_the_wide_path(knot, host_bin, monkeypatch):
    """Rows longer than the warp path (tri_bin.WARP_ROW): the rows pass
    leaves them as they are, its wide path orders them; through the
    planned build with the host-built kernels, the step runs the wide path
    and counts its rows in tri_accel.wide_rows, and its tables are the
    plain path's."""
    f, sets, lo, hi = knot
    host_bin.blocks = 0
    faces, v = _clustered(knot)
    n = len(faces)
    tri9 = torch.cat([torch.from_numpy(v[faces].reshape(-1, 9)),
                      torch.zeros((1, 9))])
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    cell_count, sizes, cell_slot, _, want = _plain_tables(
        tri9, n, origin, vs, dims, lo, hi)
    wide = int((cell_count > tri_bin.WARP_ROW).sum())
    assert wide == int(sizes[tri_bin.SIZES.index("wide")]) >= 2
    assert int(((cell_count > 32) & (cell_count <= 64)).sum()) >= 2
    a, cell_tris = host_bin.emit(tri9, n, origin, vs, dims, cell_slot,
                                 *want.shape)
    _shuffle_rows(cell_tris, 3)
    host_bin.run("tri_rows", a)
    long_rows = (want >= 0).sum(dim=1) > tri_bin.WARP_ROW
    assert torch.equal(cell_tris[~long_rows], want[~long_rows])
    assert not torch.equal(cell_tris[long_rows], want[long_rows])
    host_bin.run("tri_rows_wide", a)
    assert torch.equal(cell_tris, want)

    plan = plan_tri_accel(faces, len(v), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    trace.reset_counters("tri_accel.")
    plain = build_tri_accel_planned(plan, v)
    plain_counts = trace.counters()
    monkeypatch.setattr(tri_accel, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(tri_bin, "count", host_bin.count)
    monkeypatch.setattr(tri_bin, "cells", host_bin.cells)
    monkeypatch.setattr(tri_bin, "rows", host_bin.rows)
    host_bin.entries.clear()
    trace.reset_counters("tri_accel.")
    _equal_accels(build_tri_accel_planned(plan, v), plain)
    assert trace.counters() == plain_counts
    assert plain_counts["tri_accel.wide_rows"] == wide
    assert host_bin.entries == ["tri_bin_count", "tri_cells",
                                "tri_bin_emit", "tri_rows", "tri_rows_wide"]


@pytest.mark.parametrize("blocks", [0, 1])
def test_host_rows_past_shared_memory_are_ordered_in_place(knot, host_bin,
                                                           blocks):
    """A row longer than the wide path holds in shared memory
    (tri_accel.L_WIDTHS[1] entries), shuffled: the rows pass leaves it, the
    wide path orders it where it lies; the plain path's table."""
    f, sets, lo, hi = knot
    host_bin.blocks = blocks
    faces, v = _clustered(knot, PILE)
    n = len(faces)
    tri9 = torch.cat([torch.from_numpy(v[faces].reshape(-1, 9)),
                      torch.zeros((1, 9))])
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    cell_count, sizes, cell_slot, _, want = _plain_tables(
        tri9, n, origin, vs, dims, lo, hi)
    assert int(cell_count.max()) == PILE[0] > tri_accel.L_WIDTHS[1]
    a, cell_tris = host_bin.emit(tri9, n, origin, vs, dims, cell_slot,
                                 *want.shape)
    _shuffle_rows(cell_tris, 5 + blocks)
    host_bin.run("tri_rows", a)
    assert not torch.equal(cell_tris, want)
    host_bin.run("tri_rows_wide", a)
    assert torch.equal(cell_tris, want)


# build_tri_accel's rows on the kernels' path: (the clusters beside the
# knot's set 1, its l_width option): short rows padded to a width past
# L_WIDTHS[1], short rows cut, and a row past L_WIDTHS[1] (the wide path's)
# cut to the default width
STATIC_CASES = {"padded": ((), 5000), "cut": ((), 3), "piled": (PILE, None)}


def _static_case(knot, case):
    """(triangles (F, 3, 3), build_tri_accel's options, the widest cell of
    its grid)."""
    clusters, l_width = STATIC_CASES[case]
    # piled tight, as the build's own grid is not the knot's
    faces, v = _clustered(knot, clusters, spread=0.01)
    tri = v[faces]
    corners = tri.reshape(-1, 3)
    origin, vs, dims = tri_accel._tri_grid(corners.min(axis=0),
                                           corners.max(axis=0), RES)
    _, lin = tri_bin.emit_plain(torch.from_numpy(tri.reshape(-1, 9)),
                                len(tri), origin, vs, dims)
    widest = int(torch.bincount(lin.long()).max())
    return tri, {} if l_width is None else {"l_width": l_width}, widest


def _check_static_case(case, accel, widest):
    """The case is what its name says: l_width past the widest cell (and
    past L_WIDTHS[1]), or cut below it (for "piled", a cell past
    L_WIDTHS[1] cut to the default width)."""
    if case == "padded":
        assert accel.l_width == 5000 > tri_accel.L_WIDTHS[1] > widest
        assert accel.overflow_cells == 0
    else:
        assert accel.l_width == (3 if case == "cut" else 512) < widest
        assert accel.overflow_cells > 0
        assert (widest > tri_accel.L_WIDTHS[1]) == (case == "piled")


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_host_static_build_cuts_and_pads_the_kernel_rows(knot, host_bin,
                                                         monkeypatch, case):
    """build_tri_accel (the JAX package's build, rows cut at l_width)
    through the kernels' path, the host-built kernels in the card's place:
    its rows written as wide as the widest cell, then cut or padded to
    l_width, give the plain path's accel and counters, whether l_width is
    past L_WIDTHS[1] with every row short or a row is longer than that."""
    host_bin.blocks = 0
    tri, kw, widest = _static_case(knot, case)
    wide = widest > tri_bin.WARP_ROW
    trace.reset_counters("tri_accel.")
    want = _static_accel_of(tri, **kw)
    counts = trace.counters()
    _check_static_case(case, want, widest)
    monkeypatch.setattr(tri_accel, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(tri_bin, "count", host_bin.count)
    monkeypatch.setattr(tri_bin, "cells", host_bin.cells)
    monkeypatch.setattr(tri_bin, "rows", host_bin.rows)
    host_bin.entries.clear()
    trace.reset_counters("tri_accel.")
    _equal_accels(_static_accel_of(tri, **kw), want)
    assert trace.counters() == counts
    assert (counts["tri_accel.wide_rows"] > 0) == wide
    assert host_bin.entries == ["tri_bin_count", "tri_cells",
                                "tri_bin_emit", "tri_rows"] \
        + ["tri_rows_wide"] * wide


def test_host_kernel_path_builds_the_plain_accel(knot, host_bin,
                                                 monkeypatch):
    """build_tri_accel_planned through the kernels' path (the count and
    cells passes, the one sizing copy, the emit and rows passes), the
    host-built kernels in the card's place: the plain path's accel, table
    for table, and its counters, on every set; no wide rows."""
    f, sets, lo, hi = knot
    host_bin.blocks = 0
    plan = plan_tri_accel(f, len(sets[0]), bb_min=lo, bb_max=hi, res=RES,
                          device="cpu")
    want = []
    for v in sets:
        trace.reset_counters("tri_accel.")
        want.append((build_tri_accel_planned(plan, v), trace.counters()))
    monkeypatch.setattr(tri_accel, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(tri_bin, "count", host_bin.count)
    monkeypatch.setattr(tri_bin, "cells", host_bin.cells)
    monkeypatch.setattr(tri_bin, "rows", host_bin.rows)
    host_bin.entries.clear()
    for v, (accel, counts) in zip(sets, want):
        trace.reset_counters("tri_accel.")
        _equal_accels(build_tri_accel_planned(plan, v), accel)
        assert trace.counters() == counts
        assert counts["tri_accel.wide_rows"] == 0
    assert host_bin.entries == ["tri_bin_count", "tri_cells",
                                "tri_bin_emit", "tri_rows"] * SETS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tri_bin_matches_plain_on_cuda(knot, cuda):
    """On the card: the count, cells, emit and rows passes against their
    plain versions on the same card (mixed triangles; and the clustered
    knot, whose rows take the warp path's second register and the wide
    path), the corners pass against its plain version, and the planned
    accel against the plain path's, on every set and on the clustered
    knot, with the same counters."""
    f, sets, lo, hi = knot
    origin, vs, dims = tri_accel._tri_grid(lo, hi, RES)
    faces, v = _clustered(knot)
    clustered = torch.cat([torch.from_numpy(v[faces].reshape(-1, 9)),
                           torch.zeros((1, 9))])
    for tri9, n in ((_mixed_tri9(knot), len(f)), (clustered, len(faces))):
        tri9 = tri9.to(cuda)
        want = _plain_tables(tri9, n, origin, vs, dims, lo, hi)
        cell_count, sizes = tri_bin.count(tri9, n, origin, vs, dims, lo, hi)
        cell_slot, mask = tri_bin.cells(cell_count, sizes,
                                        tri_accel.L_WIDTHS)
        wide = int(sizes[tri_bin.SIZES.index("wide")])
        got = (cell_count, sizes, cell_slot, mask, tri_bin.rows(
            tri9, n, origin, vs, dims, cell_slot, *want[4].shape, wide))
        for name, a, b in zip(("cell_count", "sizes", "cell_slot", "mask",
                               "cell_tris"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert wide >= 2
    # a last warp of triangles short of a whole one
    verts = torch.from_numpy(v).to(cuda)
    corners = torch.from_numpy(faces.reshape(-1).astype(np.int64)).to(cuda)
    assert len(faces) % 32
    for a, b in zip(tri_bin.corners(verts, corners),
                    tri_bin.corners_plain(verts, corners)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    cases = [(f, len(sets[0]), x) for x in sets] + [(faces, len(v), v)]
    for fc, n_v, x in cases:
        plan = plan_tri_accel(fc, n_v, bb_min=lo, bb_max=hi, res=RES,
                              device=cuda)
        on_cpu = plan_tri_accel(fc, n_v, bb_min=lo, bb_max=hi, res=RES,
                                device="cpu")
        trace.reset_counters("tri_accel.")
        ta = build_tri_accel_planned(plan, torch.from_numpy(x).to(cuda))
        counts = trace.counters()
        trace.reset_counters("tri_accel.")
        ref = build_tri_accel_planned(on_cpu, x)
        assert counts == trace.counters()
        for k in ("cell_slot", "cell_tris", "tri9"):
            assert torch.equal(getattr(ta, k).cpu(), getattr(ref, k)), k
        for k in ("coarse", "fine", "l2"):
            assert torch.equal(getattr(ta.brick, k).cpu(),
                               getattr(ref.brick, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_build_on_cuda_matches_cpu(knot, cuda, case):
    """On the card: build_tri_accel's rows, written by the kernels as wide
    as the widest cell and then padded past L_WIDTHS[1] or cut (for
    "piled" a row past L_WIDTHS[1], ordered in place by the wide path),
    equal the CPU build's, table for table, with the same counters; the
    wide path launched where a row is longer than the warp path's."""
    tri, kw, widest = _static_case(knot, case)
    trace.reset_counters("tri_accel.")
    want = _static_accel_of(tri, **kw)
    counts = {k: n for k, n in trace.counters().items()
              if k.startswith("tri_accel.")}
    _check_static_case(case, want, widest)
    trace.reset_counters("tri_accel.")
    trace.reset_counters("launches.")
    got = _static_accel_of(tri, device=cuda, **kw)
    assert {k: n for k, n in trace.counters().items()
            if k.startswith("tri_accel.")} == counts
    assert trace.counter("launches.tri_rows_wide") == int(
        widest > tri_bin.WARP_ROW)
    assert (got.l_width, got.overflow_cells) == (want.l_width,
                                                 want.overflow_cells)
    for k in ("cell_slot", "cell_tris", "tri9"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    for k in ("coarse", "fine", "l2"):
        assert torch.equal(getattr(got.brick, k).cpu(),
                           getattr(want.brick, k)), k
