"""voxelray_torch as a package: no JAX, kernel dispatch by device, the
build command, and the GPU smoke script's refusal to run without a card.

This file imports no JAX, so its CUDA tests also run on a machine
without JAX:  python -m pytest --noconftest -m cuda tests/test_torch_package.py
(they skip where torch.cuda.is_available() is false).
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelray_torch.io import meshes
from voxelray_torch.ops import geometry
from voxelray_torch.ops.intersect import make_camera_rays
from voxelray_torch.io.objload import LoadedModel, Material
from voxelray_torch.models.scene import Light, build_scene
from voxelray_torch.ops.kernels import (_build, accel_build, brick_fine,
                                        frame_shade, grid_walk, mega_trace,
                                        tri_march, voxel_accum)
from voxelray_torch.ops.traverse_fast import build_accel, trace_grid_fast
from voxelray_torch.ops.tri_accel import build_tri_accel, trace_triangles_grid
from voxelray_torch.ops.voxelize import voxelize_plain
from voxelray_torch.render import pipeline, shading
from voxelray_torch.render.camera import Camera
from voxelray_torch.utils import trace

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "voxelray_torch"


def _launched(kernel):
    """The kernel module's launches so far (utils/trace.py's counter)."""
    return trace.counter("launches." + kernel.__name__.rsplit(".", 1)[-1])


def _modules():
    return sorted(
        "voxelray_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                     .parts).replace(".__init__", "")
        for p in PKG.rglob("*.py")
        if "_build" not in p.parts)


def test_port_imports_no_jax():
    mods = [m.rstrip(".") for m in _modules()]
    assert "voxelray_torch.ops.kernels.mega_trace" in mods
    assert "voxelray_torch.bench" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'voxelray_tpu', 'triton')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _small_scene():
    v, f = meshes.icosphere(2)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / 40
    dims = geometry.grid_dims(bb_min, bb_max, vs)
    return v, f, bb_min, bb_max, vs, dims


def test_cpu_tensors_take_the_plain_versions():
    v, f, bb_min, bb_max, vs, dims = _small_scene()
    trace.reset_counters("launches.")
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    occ, calls = voxel_accum.voxel_accum(vt, ft, bb_min, vs, dims)
    occ_p, calls_p = voxelize_plain(vt, ft, bb_min, vs, dims)
    assert torch.equal(occ, occ_p) and calls == calls_p > 0
    accel = build_accel(occ, bb_min, vs)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(64, 32)
    o, d = make_camera_rays(64, 32, vi, pi)
    t, lin, unresolved = trace_grid_fast(o, d, accel, return_stats=True)
    t_p, lin_p, _ = mega_trace.trace_grid_mega_plain(
        o.reshape(-1, 3), d.reshape(-1, 3), accel,
        torch.full((64 * 32,), 0.001), torch.full((64 * 32,), 10000.0),
        torch.ones(64 * 32, dtype=torch.bool))
    assert torch.equal(lin.reshape(-1), lin_p) and int(unresolved) == 0
    assert torch.isfinite(t).sum() > 100
    trace.reset_counters("launches.")
    t_s, lin_s = trace_grid_fast(o, d, accel, mega=False)
    assert torch.equal(lin_s, lin) and torch.equal(t_s, t)
    assert _launched(voxel_accum) == 0 and _launched(mega_trace) == 0
    assert _launched(grid_walk) == 0 and _launched(brick_fine) == 0


def test_cuda_entry_points_refuse_cpu_tensors():
    v, f, bb_min, _, vs, dims = _small_scene()
    with pytest.raises(ValueError):
        voxel_accum.voxel_accum_cuda(torch.from_numpy(v),
                                     torch.from_numpy(f), bb_min, vs, dims)
    accel = build_accel(torch.zeros((8, 8, 8), dtype=torch.uint8),
                        np.zeros(3, np.float32), 0.1)
    n = 4
    with pytest.raises(ValueError):
        mega_trace.trace_grid_mega_cuda(
            torch.zeros((n, 3)), torch.ones((n, 3)), accel, torch.zeros(n),
            torch.ones(n), torch.ones(n, dtype=torch.bool))
    meta = torch.empty((3, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        voxel_accum.voxel_accum(meta, meta.int(), bb_min, vs, dims)
    with pytest.raises(ValueError, match="unsupported device"):
        mega_trace.trace_grid_mega(meta, meta, accel, 0.001, 10000.0)
    kw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
              brick_world=0.8, k_hits=2)
    cpu = torch.zeros(n)
    with pytest.raises(ValueError):
        grid_walk.walk_cuda(torch.zeros((n, 3)), torch.ones((n, 3)), cpu,
                            cpu + 1, None, None, accel.coarse, None, **kw)
    with pytest.raises(ValueError):
        brick_fine.fine_cuda(torch.zeros((n, 3)), torch.ones((n, 3)),
                             torch.zeros((1, n), dtype=torch.int32),
                             accel.fine, cpu, cpu + 1, dims=accel.dims,
                             bdims=accel.bdims, origin_key=accel.origin_key,
                             voxel_size=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        grid_walk.coarse_walk_init(meta, meta, meta[:, 0], meta[:, 0],
                                   accel.coarse, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        trace_grid_fast(meta, meta, accel, mega=False)
    v, f, *_ = _small_scene()
    ta = build_tri_accel(v[f][:, 0], v[f][:, 1], v[f][:, 2], res=8,
                         device="cpu")
    with pytest.raises(ValueError):
        tri_march.tri_march_cuda(torch.zeros((n, 3)), torch.ones((n, 3)),
                                 cpu, cpu + 1, ta)
    with pytest.raises(ValueError, match="unsupported device"):
        trace_triangles_grid(meta, meta, ta)
    from voxelray_torch.models.octree import Octree
    from voxelray_torch.ops.kernels import octree_walk
    from voxelray_torch.ops.octree_traverse import trace_octree
    tree = Octree.from_mesh(v, f, vs, device="cpu")
    with pytest.raises(ValueError):
        octree_walk.walk_cuda(torch.zeros((n, 3)), torch.ones((n, 3)), 0.001,
                              10000.0, tree)
    with pytest.raises(ValueError, match="unsupported device"):
        trace_octree(meta, meta, tree)


def test_cpu_triangle_trace_takes_the_plain_march():
    """trace_triangles_grid on CPU tensors runs tri_march_plain (the lap
    loop over the plain K3 and K4), launching no kernel."""
    v, f, *_ = _small_scene()
    tri = v[f]
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=16,
                         device="cpu")
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(64, 32)
    o, d = make_camera_rays(64, 32, vi, pi)
    trace.reset_counters("launches.")
    t, pid, u, v_, unresolved = trace_triangles_grid(o, d, ta,
                                                     return_stats=True)
    n = 64 * 32
    want = tri_march.tri_march_plain(
        o.reshape(-1, 3), d.reshape(-1, 3), torch.full((n,), 0.001),
        torch.full((n,), 10000.0), ta)
    for a, b in zip((t, pid, u, v_), want):
        assert torch.equal(a.reshape(-1), b)
    assert unresolved == want[4] == 0 and (pid >= 0).sum() > 100
    assert _launched(tri_march) == _launched(grid_walk) == 0
    assert _launched(brick_fine) == 0


FRAME_KERNELS = ("camera_rays", "hit_surface", "shade_post")


def _frame_scene(device, triangles=False):
    """The small icosphere as voxels (a shiny material) and, with
    `triangles`, the same mesh as a triangle model beside them."""
    v, f, bb_min, bb_max, vs, dims = _small_scene()
    occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                            bb_min, vs, dims)
    grid = {"occ": occ.to(device), "dims": dims, "origin": bb_min,
            "voxel_size": vs}
    models = None
    if triangles:
        verts = np.zeros((len(v), 11), np.float32)
        verts[:, 0:3] = v * np.float32(0.6) + np.float32([0.9, 0.2, -0.8])
        verts[:, 3:6] = v / np.linalg.norm(v, axis=1, keepdims=True)
        verts[:, 9:11] = v[:, :2]
        models = [LoadedModel(
            vertices=verts, indices=f.reshape(-1).astype(np.uint32),
            materials=Material(specular=(.5, .5, .5), shininess=16.0,
                               illum=2).as_row()[None],
            textures=[], mat_index=np.zeros(len(f), np.int32))]
    return build_scene(models=models, grid=grid, device=device,
                       voxel_material=Material(shininess=8.0, illum=2))


def test_cpu_frames_take_the_plain_glue():
    """render_image and render_rays on CPU tensors run the PyTorch glue:
    none of the frame glue's kernels is launched, and the frame is the
    plain stages' (camera rays, traces, surface_terms, the shadow pass,
    the shade stage, gamma) composed by hand."""
    scene = _frame_scene("cpu", triangles=True)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 16)
    trace.reset_counters("launches.")
    img = pipeline.render_image(scene, vi, pi, width=128, height=16,
                                backend="fast")
    want = _plain_frame(scene, vi, pi, 128, 16, "fast", Light())
    assert torch.equal(img, want)
    o, d = make_camera_rays(32, 8, vi, pi)
    rgb = pipeline.render_rays(scene, o, d, backend="dda")
    assert rgb.shape == (8, 32, 3)
    assert all(trace.counter("launches." + k) == 0 for k in FRAME_KERNELS)


def test_frame_glue_refuses_other_devices():
    """The kernels' entry points take CUDA tensors only; the pipeline
    raises on a device that is neither CUDA nor CPU."""
    scene = _frame_scene("cpu")
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        frame_shade.camera_rays_cuda(16, 8, vi, pi, False, "cpu")
    o, d = make_camera_rays(16, 8, vi, pi)
    t = torch.full((8, 16), float("inf"))
    lin = torch.full((8, 16), -1, dtype=torch.int32)
    tables = pipeline._surface_tables(scene, "fast")
    light = Light()
    with pytest.raises(ValueError, match="CUDA"):
        frame_shade.hit_surface_cuda(o, d, t, lin, None, tables,
                                     light.position, light.intensity,
                                     light.type)
    a, surf = frame_shade.surface_args(o, d, t, lin, None, tables,
                                       light.position, light.intensity,
                                       light.type)
    with pytest.raises(ValueError, match="CUDA"):
        frame_shade.shade_post_cuda(surf, d, None, scene.materials,
                                    scene.voxel_material, (1, 1, 1, 1))
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.render_rays(scene, meta, meta)


def _plain_frame(scene, vi, pi, width, height, backend, light,
                 shadows=True):
    """render_image's frame from the plain stages, on the scene's
    device."""
    o, d = make_camera_rays(width, height, vi, pi, device=scene.device)
    tiled = pipeline._tiles(backend, height, width)
    if tiled:
        o = pipeline._tile_rays(o, height, width)
        d = pipeline._tile_rays(d, height, width)
    tri = (pipeline._trace_triangles(scene, o, d, 0.001, 10000.0)
           if scene.n_triangles else None)
    t_vox, vox_id = pipeline._trace_voxels(scene, o, d, 0.001, 10000.0,
                                           backend)
    s = pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                               backend)
    if shadows:
        shadowed = pipeline._occlusion(scene, s.world_pos, s.l_vec,
                                       s.light_dist, s.hit & s.facing,
                                       backend, None, None, None)
        shadowed = torch.where(s.facing, shadowed, torch.ones_like(shadowed))
    else:
        shadowed = ~s.facing
    rgb = pipeline._shade(s, d, shadowed, (1.0, 1.0, 1.0, 1.0))
    if tiled:
        rgb = pipeline._untile_rays(rgb, height, width)
    rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return shading.gamma_post(rgba)


def _rebuild_grid(device):
    """A voxel grid as a deforming step hands it to build_scene: the
    icosphere voxelized to dims that are not multiples of 8, its cells
    holding 1, 2 or 255."""
    v, f, bb_min, _, vs, dims = _small_scene()
    occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                            bb_min, vs, dims)
    values = np.random.default_rng(3).choice(np.uint8([1, 2, 255]),
                                             tuple(occ.shape))
    occ = occ * torch.from_numpy(values)
    return {"occ": occ.to(device), "dims": dims, "origin": bb_min,
            "voxel_size": vs}


def test_cpu_scene_rebuild_takes_the_plain_build():
    """build_scene(grid=...) on CPU tensors builds the accel and the boxes
    with PyTorch ops (neither kernel is launched), and the kernels' entry
    points refuse CPU tensors."""
    grid = _rebuild_grid("cpu")
    trace.reset_counters("launches.")
    scene = build_scene(grid=grid, device="cpu")
    assert trace.counter("launches.accel_build") == 0
    assert trace.counter("launches.aabb_boxes") == 0
    assert scene.n_voxels == int((grid["occ"] != 0).sum()) > 100
    assert scene.accel.fine_sb is not None
    with pytest.raises(ValueError, match="CUDA"):
        accel_build.accel_tables(grid["occ"], scene.accel.bdims, True)
    with pytest.raises(ValueError, match="CUDA"):
        accel_build.aabb_boxes(torch.zeros(3, dtype=torch.int64),
                               scene.grid_dims, grid["origin"], 0.1)


def test_nvcc_command_targets_hopper_without_fma_contraction():
    compiles, link = _build.nvcc_commands("nvcc", "/tmp/out.so")
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == \
            "-gencode"
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    for cmd in compiles:
        assert "--fmad=false" in cmd and "-c" in cmd
    assert "-shared" in link
    srcs = {Path(c).name for cmd in compiles for c in cmd if c.endswith(".cu")}
    assert srcs == {"voxel_accum.cu", "mega_trace.cu", "grid_walk.cu",
                    "brick_fine.cu", "tri_march.cu", "staged_march.cu",
                    "frame_shade.cu", "tri_bin.cu", "accel_build.cu",
                    "octree_walk.cu"}
    assert len(compiles) == len(srcs)
    # the shared header brick_walk.cuh is found through -I csrc
    for cmd in compiles:
        assert cmd[cmd.index("-I") + 1] == str(_build.CSRC_DIR)
    assert (_build.CSRC_DIR / "brick_walk.cuh") in _build.headers()


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a csrc/*.cuh header changes the library's key, so the
    next load rebuilds instead of loading a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    key = _build._key()
    assert _build._key() == key
    header = csrc / "brick_walk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._key() != key


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _no_result(proc):
    return proc.returncode != 0 and '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert _no_result(proc), proc.stdout[-2000:]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert _no_result(proc), proc.stdout[-2000:]


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "voxelray_torch" in names
    assert not names & {"jax", "jaxlib", "voxelray_tpu", "bench"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda(cuda):
    v, f, bb_min, bb_max, vs, dims = _small_scene()
    vt, ft = torch.from_numpy(v).to(cuda), torch.from_numpy(f).to(cuda)
    before = _launched(voxel_accum)
    occ, calls = voxel_accum.voxel_accum(vt, ft, bb_min, vs, dims)
    assert _launched(voxel_accum) == before + 1
    occ_p, calls_p = voxelize_plain(vt, ft, bb_min, vs, dims)
    assert torch.equal(occ, occ_p) and calls == calls_p
    accel = build_accel(occ, bb_min, vs)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 64)
    o, d = make_camera_rays(128, 64, vi, pi, device=cuda)
    n = 128 * 64
    args = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
            accel, torch.full((n,), 0.001, device=cuda),
            torch.full((n,), 10000.0, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda))
    before = _launched(mega_trace)
    t, lin, alive = mega_trace.trace_grid_mega_cuda(*args)
    torch.cuda.synchronize()
    assert _launched(mega_trace) == before + 1 and int(alive.sum()) == 0
    t_p, lin_p, _ = mega_trace.trace_grid_mega_plain(*args)
    assert torch.equal(lin, lin_p)
    same = lin >= 0
    assert torch.equal(t[same], t_p[same])
    # a sparse admit mask: the kernel writes every other ray's miss itself
    admit = torch.from_numpy(np.random.default_rng(0).random(n) < 0.05)
    args = args[:5] + (admit.to(cuda),)
    t, lin, alive = mega_trace.trace_grid_mega_cuda(*args)
    t_p, lin_p, _ = mega_trace.trace_grid_mega_plain(*args)
    assert torch.equal(lin, lin_p) and int(alive.sum()) == 0
    assert torch.equal(t[lin >= 0], t_p[lin >= 0])
    assert bool(torch.isinf(t[~args[5]]).all())


@pytest.mark.cuda
def test_voxel_accum_cuda_raises_on_an_out_of_range_face(cuda):
    """K1 checks the face indices itself; the wrapper raises on the count
    of out-of-range faces it reads back with the hit total."""
    v, f, bb_min, _, vs, dims = _small_scene()
    vt = torch.from_numpy(v).to(cuda)
    for bad in (len(v), -1):
        fb = torch.from_numpy(f).to(cuda)
        fb[len(f) // 2, 1] = bad
        with pytest.raises(ValueError, match="out of range"):
            voxel_accum.voxel_accum_cuda(vt, fb, bb_min, vs, dims)


@pytest.mark.cuda
def test_staged_kernels_match_plain_versions_on_cuda(cuda):
    """K3 (both entries, one and two levels) and K4 on the card against
    their plain versions on the same card: bit-equal."""
    v, f, bb_min, bb_max, vs, dims = _small_scene()
    occ, _ = voxelize_plain(torch.from_numpy(v).to(cuda),
                            torch.from_numpy(f).to(cuda), bb_min, vs, dims)
    accel = build_accel(occ, bb_min, vs)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 64)
    o, d = make_camera_rays(128, 64, vi, pi, device=cuda)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), 0.001, device=cuda)
    tmx = torch.full((n,), 10000.0, device=cuda)
    kw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
              brick_world=float(accel.voxel_size * 8), k_hits=5)
    for l2 in (None, accel.l2):
        before = _launched(grid_walk)
        got = grid_walk.walk_cuda(o, d, tmn, tmx, None, None, accel.coarse,
                                  l2, **kw)
        torch.cuda.synchronize()
        assert _launched(grid_walk) == before + 1
        want = grid_walk.walk_plain(o, d, tmn, tmx, None, None,
                                    accel.coarse, l2, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        got2 = grid_walk.walk_cuda(o, d, None, tmx, got[1], got[2],
                                   accel.coarse, l2, **kw)
        want2 = grid_walk.walk_plain(o, d, None, tmx, got[1], got[2],
                                     accel.coarse, l2, **kw)
        for a, b in zip(got2, want2):
            assert torch.equal(a, b)
    fkw = dict(dims=accel.dims, bdims=accel.bdims,
               origin_key=accel.origin_key, voxel_size=accel.voxel_size)
    before = _launched(brick_fine)
    t, lin = brick_fine.fine_cuda(o, d, got[0], accel.fine, tmn, tmx, **fkw)
    torch.cuda.synchronize()
    assert _launched(brick_fine) == before + 1 and (lin >= 0).sum() > 100
    t_p, lin_p = brick_fine.fine_plain(o, d, got[0], accel.fine, tmn, tmx,
                                       **fkw)
    assert torch.equal(lin, lin_p) and torch.equal(t, t_p)
    t_s, lin_s, unresolved = trace_grid_fast(o, d, accel, mega=False,
                                             return_stats=True)
    t_m, lin_m = trace_grid_fast(o, d, accel)
    assert unresolved == 0 and torch.equal(lin_s, lin_m)


@pytest.mark.cuda
def test_tri_march_matches_the_lap_loop_on_cuda(cuda):
    """The march kernel on the card against the lap loop on the same card
    (its staged walk launching K3 and K4): t and id bit-equal, u and v
    where there is a hit, one launch, unresolved 0."""
    v, f, *_ = _small_scene()
    tri = v[f]
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=24,
                         device=cuda)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 64)
    o, d = make_camera_rays(128, 64, vi, pi, device=cuda)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), 0.001, device=cuda)
    tmx = torch.full((n,), 10000.0, device=cuda)
    for two_level in (False, True):
        want = tri_march.tri_march_plain(o, d, tmn, tmx, ta,
                                         two_level=two_level)
        hit = want[1] >= 0
        assert int(hit.sum()) > 500 and want[4] == 0
        before = _launched(tri_march)
        got = tri_march.tri_march_cuda(o, d, tmn, tmx, ta,
                                       two_level=two_level)
        torch.cuda.synchronize()
        assert _launched(tri_march) == before + 1 and int(got[4]) == 0
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2][hit], want[2][hit])
        assert torch.equal(got[3][hit], want[3][hit])


@pytest.mark.cuda
def test_aabb_extraction_on_cuda_matches_cpu(cuda):
    """The word compaction on the card (bit-31 words included): rows and
    count bit-equal to the CPU run, with and without the bounds."""
    from voxelray_torch.models.grids import GridBool
    rng = np.random.default_rng(5)
    occ = torch.from_numpy((rng.random((9, 13, 29)) < 0.25).astype(np.uint8))
    origin = np.float32([-1.3, 0.7, 2.1])
    cpu = GridBool.from_occupancy(occ, origin, 0.07)
    gpu = GridBool.from_occupancy(occ.to(cuda), origin, 0.07)
    assert bool((cpu.words < 0).any())           # words with bit 31 set
    assert torch.equal(gpu.get_aabbs().cpu(), cpu.get_aabbs())
    for kw in ({}, {"word_capacity": 7}, {"group_capacity": 2},
               {"byte_capacity": 11, "word_capacity": 40}):
        a, c = cpu.get_aabbs_fixed(4096, **kw)
        b, d = gpu.get_aabbs_fixed(4096, **kw)
        assert int(c) == int(d) and torch.equal(b.cpu(), a), kw


@pytest.mark.cuda
def test_encodings_and_octree_walk_on_cuda_match_cpu(cuda):
    """The hit stream, GridVec, the octree's int64 codes sorted on the
    card, and the octree walk: equal to the CPU run."""
    from voxelray_torch.models.grids import GridVec
    from voxelray_torch.models.octree import Octree
    from voxelray_torch.ops.octree_traverse import trace_octree
    v, f = meshes.bunny_like(2)
    gv_c = GridVec.from_mesh(v, f, 0.11, device="cpu")
    gv_g = GridVec.from_mesh(v, f, 0.11, device=cuda)
    assert torch.equal(gv_g.aabbs.cpu(), gv_c.aabbs)
    t_c = Octree.from_mesh(v, f, 0.11, device="cpu")
    t_g = Octree.from_mesh(v, f, 0.11, device=cuda)
    assert t_g.codes.is_cuda and torch.equal(t_g.codes.cpu(), t_c.codes)
    assert torch.equal(t_g.region_map.cpu(), t_c.region_map)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 64)
    o, d = make_camera_rays(128, 64, vi, pi)
    want = trace_octree(o, d, t_c)
    got = trace_octree(o.to(cuda), d.to(cuda), t_g)
    assert int(torch.isfinite(want[0]).sum()) > 500
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
def test_octree_frame_on_cuda_walks_once_a_trace_without_a_sync(cuda):
    """render_image with backend "octree" on the card: one octree_walk
    launch for the primary trace and one for the shadow trace (the admit
    mask read in the kernel), no host sync, and the frame of the CPU run
    (the plain walk and the plain glue) within the frame glue's rounding;
    the shadow query's occlusion bit-equal to the CPU's."""
    import warnings
    from voxelray_torch.models.grids import GridVec
    from voxelray_torch.models.octree import Octree
    from voxelray_torch.ops.intersect import TMIN
    from voxelray_torch.ops.kernels import octree_walk
    from voxelray_torch.ops.octree_traverse import any_hit_octree
    v, f = meshes.bunny_like(2)
    scenes = {}
    for dev in ("cpu", cuda):
        gv = GridVec.from_mesh(v, f, 0.11, device=dev)
        tree = Octree.from_grid(gv)
        scenes[str(dev)] = build_scene(grid=tree, aabbs=gv.get_aabbs(),
                                       octree=tree, device=dev)
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.0, 0.0, 0.0))
    _, _, vi, pi = cam.matrices(128, 64)
    kw = dict(width=128, height=64, backend="octree",
              light=Light(position=(10.0, 55.0, 8.0), intensity=1000.0))
    want = pipeline.render_image(scenes["cpu"], vi, pi, **kw)
    scene = scenes[str(cuda)]
    pipeline.render_image(scene, vi, pi, **kw)
    torch.cuda.synchronize()
    before = _launched(octree_walk)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            img = pipeline.render_image(scene, vi, pi, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in rec
             if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs
    torch.cuda.synchronize()
    assert _launched(octree_walk) == before + 2
    assert (img.cpu() - want).abs().max() <= 1e-4
    # the shadow pass alone, from the CPU's shadow query
    o, d, _ = pipeline._frame_rays(scenes["cpu"], vi, pi, 128, 64, "octree")
    t, lin = pipeline._trace_voxels(scenes["cpu"], o, d, TMIN, 1e4,
                                    "octree")
    s = pipeline.surface_terms(scenes["cpu"], o, d, t, lin, kw["light"],
                               backend="octree")
    admit = s.hit & s.facing
    occ_c = any_hit_octree(s.world_pos, s.l_vec, scenes["cpu"].octree,
                           t_min=TMIN, t_max=s.light_dist, admit=admit)
    occ_g = any_hit_octree(s.world_pos.to(cuda), s.l_vec.to(cuda),
                           scene.octree, t_min=TMIN,
                           t_max=s.light_dist.to(cuda), admit=admit.to(cuda))
    assert 0 < int(occ_c.sum()) < int(admit.sum())
    assert torch.equal(occ_g.cpu(), occ_c)



@pytest.mark.cuda
def test_octree_frame_kept_for_its_scene_is_the_wrappers_frame(cuda):
    """render_image's kept octree frame (pipeline._OctreeFrame): bit-equal
    to the frame the wrappers make call by call (pipeline._render) from
    several cameras, with shadows on and off; kept while its arguments
    hold, made anew for another light; while recording, the wrappers'
    spans and the same counters."""
    from voxelray_torch.models.grids import GridVec
    from voxelray_torch.models.octree import Octree
    from voxelray_torch.ops.intersect import TMAX, TMIN
    v, f = meshes.bunny_like(2)
    gv = GridVec.from_mesh(v, f, 0.11, device=cuda)
    tree = Octree.from_grid(gv)
    scene = build_scene(grid=tree, aabbs=gv.get_aabbs(), octree=tree,
                        device=cuda)
    w, h = 128, 64

    def by_calls(vi, pi, light, shadows):
        o, d, _ = pipeline._frame_rays(scene, vi, pi, w, h, "octree")
        return pipeline._render(
            scene, o, d, light, (1.0, 1.0, 1.0, 1.0), (h, w, False),
            backend="octree", t_min=TMIN, t_max=TMAX, shadows=shadows,
            fast_opts=None, shadow_opts=None, trace_voxels_fn=None,
            any_hit_fn=None)

    lights = (Light(position=(10.0, 55.0, 8.0), intensity=1000.0),
              Light(position=(-3.0, 4.0, 2.0), intensity=50.0))
    eyes = ((2.5, 1.5, -2.5), (-2.0, 0.8, 2.2), (0.3, 2.6, 0.4))
    for light in lights:
        for shadows in (True, False):
            kept = None
            for eye in eyes:
                _, _, vi, pi = Camera(eye=eye, center=(0.0, 0.0, 0.0)) \
                    .matrices(w, h)
                img = pipeline.render_image(scene, vi, pi, width=w,
                                            height=h, backend="octree",
                                            light=light, shadows=shadows)
                plan = pipeline._OCTREE_FRAMES[id(scene)][2]
                assert kept is None or plan is kept
                kept = plan
                assert torch.equal(img, by_calls(vi, pi, light, shadows))
    _, _, vi, pi = Camera(eye=eyes[0], center=(0.0, 0.0, 0.0)).matrices(w, h)
    got = {}
    trace.enable()
    try:
        for how in ("kept", "calls"):
            trace.clear()
            if how == "kept":
                pipeline.render_image(scene, vi, pi, width=w, height=h,
                                      backend="octree", light=lights[0])
            else:
                by_calls(vi, pi, lights[0], True)
            torch.cuda.synchronize()
            got[how] = ([r.name for r in trace.records()],
                        trace.counters())
    finally:
        trace.disable()
        trace.clear()
    names, counts = got["kept"]
    assert names == ["render_image", "rays", "primary", "octree_walk",
                     "surface", "shadow", "octree_walk", "shade", "post"]
    assert [n for n in names if n not in ("render_image", "rays", "post")] \
        == got["calls"][0]
    assert counts == got["calls"][1]
    assert counts["octree.rays"] > w * h and counts["shadow.admitted"] > 0

def _ulps(a, b):
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
def test_frame_glue_matches_the_plain_glue_on_cuda(cuda):
    """The three frame kernels against the plain PyTorch glue on the same
    card: camera rays and the shadow query bit for bit, the frame within
    2 ulp (pow), each kernel launched once a frame, and a voxel frame
    with no host sync."""
    cam = Camera(eye=(2.5, 1.5, -2.5), center=(0.2, 0.0, -0.2))
    for triangles, backend, (w, h), light in (
            (False, "fast", (256, 64), Light()),
            (True, "fast", (256, 64), Light(position=(-3.0, 7.0, 2.0),
                                            intensity=2.5, type=1)),
            (True, "brute", (96, 54), Light())):
        scene = _frame_scene(cuda, triangles)
        _, _, vi, pi = cam.matrices(w, h)
        tiled = pipeline._tiles(backend, h, w)
        o, d = frame_shade.camera_rays_cuda(w, h, vi, pi, tiled, cuda)
        po, pd = make_camera_rays(w, h, vi, pi, device=cuda)
        if tiled:
            po = pipeline._tile_rays(po, h, w)
            pd = pipeline._tile_rays(pd, h, w)
        assert torch.equal(o, po.reshape(-1, 3))
        assert torch.equal(d, pd.reshape(-1, 3))
        tri = (pipeline._trace_triangles(scene, o, d, 0.001, 10000.0)
               if scene.n_triangles else None)
        t_vox, vox_id = pipeline._trace_voxels(scene, o, d, 0.001, 10000.0,
                                               backend)
        q = frame_shade.hit_surface_cuda(
            o, d, t_vox, vox_id, tri,
            pipeline._surface_tables(scene, backend), light.position,
            light.intensity, light.type)
        s = pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                                   backend)
        for got, want in ((q.world_pos, s.world_pos), (q.l_vec, s.l_vec),
                          (q.light_dist, s.light_dist)):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(q.admit, s.hit & s.facing)
        before = {k: trace.counter("launches." + k) for k in FRAME_KERNELS}
        img = pipeline.render_image(scene, vi, pi, width=w, height=h,
                                    backend=backend, light=light)
        torch.cuda.synchronize()
        assert all(trace.counter("launches." + k) == before[k] + 1
                   for k in FRAME_KERNELS)
        want = _plain_frame(scene, vi, pi, w, h, backend, light)
        assert int(_ulps(img, want).max()) <= 2
        if not triangles:
            torch.cuda.set_sync_debug_mode("error")
            try:
                pipeline.render_image(scene, vi, pi, width=w, height=h,
                                      backend=backend, light=light)
            finally:
                torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_scene_rebuild_on_cuda_matches_cpu(cuda):
    """build_scene(grid=...) on the card: one accel_build call and one
    aabb_boxes launch, and every BrickAccel table, every box and every
    other field bit-equal to the CPU build; the accel without fine_sb
    (the triangle accel's) too."""
    grid = _rebuild_grid("cpu")
    want = build_scene(grid=grid, device="cpu")
    before = (_launched(accel_build), trace.counter("launches.aabb_boxes"))
    got = build_scene(grid=_rebuild_grid(cuda), device=cuda)
    torch.cuda.synchronize()
    assert _launched(accel_build) == before[0] + 1
    assert trace.counter("launches.aabb_boxes") == before[1] + 1
    for name in ("fine", "coarse", "l2", "fine_sb", "origin"):
        assert torch.equal(getattr(got.accel, name).cpu(),
                           getattr(want.accel, name)), name
    assert got.accel.bdims == want.accel.bdims
    for name in ("voxel_aabbs", "occ_flat", "materials", "textures",
                 "tex_meta", "voxel_material", "grid_origin", "tri_v0",
                 "tri_lod"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.is_cuda and torch.equal(a.cpu(), b), name
    occ = _rebuild_grid(cuda)["occ"]
    a = build_accel(occ, np.float32([0.3, -0.2, 0.1]), 0.05, fine_sb=False)
    b = build_accel(occ.cpu(), np.float32([0.3, -0.2, 0.1]), 0.05,
                    fine_sb=False)
    assert a.fine_sb is None
    for name in ("fine", "coarse", "l2"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name


@pytest.mark.cuda
def test_scene_rebuild_on_cuda_syncs_once(cuda):
    """A step's build_scene of a voxel grid, after the first (which makes
    the scene's fixed tensors on the card), syncs the host once: the
    nonzero that sizes the AABB list."""
    import warnings
    grid = _rebuild_grid(cuda)
    build_scene(grid=grid, device=cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            scene = build_scene(grid=grid, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in rec
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, syncs
    assert scene.n_voxels == int((grid["occ"] != 0).sum())
