"""The plain reference against the program's plain CPU path and the
program's numpy oracles at a tiny size, the work count against a hand
count, and the control (the reference a precision lower, in the
program's place) coming out not correct."""
import time

import numpy as np
import pytest
import torch

from vrbench import harness, inputs, reference, work

CPU = torch.device("cpu")
SHADING = {"light": {"position": [10.0, 55.0, 8.0], "intensity": 1000.0,
                     "type": 0},
           "material": [0.1, 0.1, 0.1, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0,
                        0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 1.0, 1.0, 0.0,
                        -1.0],
           "clear_color": [1.0, 1.0, 1.0, 1.0]}


def _knot(segments=32, tube=16):
    return inputs.torus_knot(2, 3, segments, tube)


@pytest.mark.parametrize("res", [24, 37])
def test_voxelize_matches_the_oracle(res):
    """Occupancy and set_calls exactly the program's numpy oracle's (the
    reference app's serial voxelizer)."""
    from voxelray_torch.oracle import oracle_voxelize
    v, f = _knot()
    bb_min, bb_max, vs, dims = inputs.grid_of(v, res)
    occ, calls = reference.voxelize(v, f, bb_min, vs, dims, CPU)
    ref = oracle_voxelize(v, f, vs, bb_min=bb_min, bb_max=bb_max)
    assert dims == ref.dims
    assert calls == ref.set_calls
    assert np.array_equal(occ.numpy(), ref.occupancy)


def _frame(w=48, h=24, eye=(3.9, 3.1, -3.4)):
    v, f = _knot()
    bb_min, bb_max = inputs.bbox(v)
    center = tuple(float(c) for c in (bb_min + bb_max) * 0.5)
    return v, f, inputs.camera_matrices(eye, center, w, h), w, h


def test_voxel_frame_matches_the_programs_plain_path():
    """The reference's frame of the voxel scene against render_image on
    the CPU (the exhaustive DDA, float32): every pixel within the cell's
    tolerance."""
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.render.pipeline import render_image
    v, f, (vi, pi), w, h = _frame()
    bb_min, _, vs, dims = inputs.grid_of(v, 24)
    occ, _ = reference.voxelize(v, f, bb_min, vs, dims, CPU)
    scene = reference.VoxelScene(occ, bb_min, vs, dims)
    ref = reference.render(scene, vi, pi, w, h, SHADING, CPU)
    grid = GridBool.from_occupancy(occ.to(torch.uint8), bb_min, vs)
    img = render_image(build_scene(grid=grid, device="cpu"), vi, pi,
                       width=w, height=h, backend="dda")
    from vrbench.check import compare_frames
    px, hit = compare_frames(img, ref, SHADING["clear_color"], 2e-5, 1e-6)
    assert (px, hit) == (0, 0)
    assert (ref[..., 0] != ref[0, 0, 0]).sum() > 100     # the knot is seen


def test_voxel_frame_matches_the_numpy_oracle():
    """...and against the program's brute-force numpy oracle renderer."""
    from voxelray_torch.oracle_render import oracle_render
    v, f, (vi, pi), w, h = _frame(16, 8, eye=(2.6, 2.3, -2.0))
    bb_min, _, vs, dims = inputs.grid_of(v, 12)
    occ, _ = reference.voxelize(v, f, bb_min, vs, dims, CPU)
    z, y, x = np.nonzero(occ.numpy())
    lo = bb_min + np.stack([x, y, z], 1).astype(np.float32) * np.float32(vs)
    boxes = np.concatenate([lo, lo + np.float32(vs)], 1).astype(np.float32)
    want = oracle_render(w, h, vi, pi, boxes, SHADING["material"])
    got = reference.render(reference.VoxelScene(occ, bb_min, vs, dims),
                           vi, pi, w, h, SHADING, CPU)
    from vrbench.check import compare_frames
    assert compare_frames(torch.as_tensor(want), got,
                          SHADING["clear_color"], 2e-5, 1e-6) == (0, 0)


def test_triangle_frame_matches_the_programs_plain_path():
    """The reference's frame of the triangle scene (its own triangle
    grid) against render_image on the CPU (the tri accel's lap loop)."""
    from voxelray_torch.io.objload import LoadedModel
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.render.pipeline import render_image
    v, f, (vi, pi), w, h = _frame()
    model = LoadedModel(vertices=inputs.knot_streams(v, f),
                        indices=np.arange(3 * len(f), dtype=np.uint32),
                        materials=np.asarray(SHADING["material"],
                                             np.float32)[None],
                        textures=[], mat_index=np.zeros(len(f), np.int32))
    scene = build_scene(models=[model], device="cpu")
    assert scene.tri_accel is not None
    img = render_image(scene, vi, pi, width=w, height=h, backend="fast")
    for res in (7, 24):
        ref = reference.render(reference.TriangleScene(v, f, res, CPU),
                               vi, pi, w, h, SHADING, CPU)
        from vrbench.check import compare_frames
        assert compare_frames(img, ref, SHADING["clear_color"], 2e-5,
                              1e-6) == (0, 0)


def test_admitted_rays_against_a_hand_count():
    """One occupied cell seen from the front, the light above and in
    front: the reference's shadow rays are the pixels whose ray meets the
    cell's front or top face, as counted by a slab test per ray here."""
    occ = torch.zeros((3, 3, 3), dtype=torch.bool)
    occ[1, 1, 1] = True
    origin, vs = np.zeros(3, np.float32), 1.0
    eye, center = (1.5, 1.9, 6.0), (1.5, 1.5, 1.5)
    w, h = 12, 8
    vi, pi = inputs.camera_matrices(eye, center, w, h, fov_deg=30.0)
    shading = dict(SHADING, light={"position": [1.5, 30.0, 40.0],
                                   "intensity": 1000.0, "type": 0})
    scene = reference.VoxelScene(occ, origin, vs, (3, 3, 3))
    got = reference.admitted(scene, vi, pi, w, h, shading, CPU)
    # by hand: each pixel's ray against the box [1, 2]^3
    o, d = reference.camera_rays(vi, pi, w, h, CPU, torch.float64)
    o, d = o.numpy(), d.numpy()
    count = 0
    for k in range(w * h):
        with np.errstate(divide="ignore"):
            ta, tb = (1.0 - o[k]) / d[k], (2.0 - o[k]) / d[k]
        t0 = np.minimum(ta, tb).max()
        t1 = np.maximum(ta, tb).min()
        if not t1 > max(t0, 0.0):
            continue
        axis = int(np.argmax(np.minimum(ta, tb)))
        normal = np.zeros(3)
        normal[axis] = -np.sign(d[k][axis])
        p = o[k] + d[k] * t0
        count += int(np.dot(normal, np.array([1.5, 30.0, 40.0]) - p) > 0)
    assert 0 < count < w * h
    assert got == count
    assert work.trace_rays(w, h, [got]) == w * h + count


@pytest.mark.parametrize("cell", ["vox512-flythrough", "tri-flythrough",
                                  "vox512-deform"])
def test_control_in_the_programs_place_is_not_correct(tiny, monkeypatch,
                                                      cell):
    """The control, the reference with its voxelize, rays and walks in
    bfloat16, put in the program's place: a run judges it not correct."""
    from control import Control
    from vrbench.program import kind_of

    spec = harness.load_spec(cell, tiny)
    kind = kind_of(spec.config)
    changes = kind.Program.changes
    monkeypatch.setattr(kind, "Program", lambda config, geo, device:
                        Control(kind, config, geo, device, changes))
    run = harness.run_cell(spec, 11, 1.0, False, CPU, time.time())
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert checks["pixels_apart_ppm"]["value"] \
        > checks["pixels_apart_ppm"]["limit"]
    if cell != "tri-flythrough":
        assert checks["occupancy_cells_apart"]["value"] > 0
