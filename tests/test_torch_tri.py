"""The triangle-mesh path of the port (Moller-Trumbore, the brute trace,
the triangle accel and its march over the staged brick walk, build_scene
with models and textures, and the triangle and hybrid renders) against
the JAX package on the CPU.

The same numpy inputs go to both packages.  hit_triangles and the brute
trace are plain XLA and run in this process; everything that reaches a
Pallas kernel (the tri-grid march runs K3 and K4 every lap) runs once in
one subprocess (`_JAX_SCRIPT`, see tests/_isolate.py for why), which
writes an .npz the parametrised cases read.

Tolerances: hit masks, accel tables and scene arrays are equal; triangle
t within rtol 3e-6, atol 1e-7 and barycentrics within rtol 1e-4, atol
1e-5 (JAX's own tests/_tri_accel_impl.py bounds: the Moller-Trumbore
sums contract differently under XLA:CPU); the hit
triangle may differ only where two triangles sharing an edge tie
(< 0.5% of hits); images: equal hit mask and >= 99.9% of pixels within
2e-5 in every channel (the voxel render tests' image tolerance).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.ops.intersect import hit_triangles as jhit_triangles
from voxelray_tpu.ops.traverse import trace_triangles_brute as jbrute
from voxelray_torch.io import meshes
from voxelray_torch.io.objload import LoadedModel
from voxelray_torch.io.textures import write_png
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.scene import build_scene
from voxelray_torch.ops.intersect import hit_triangles, make_camera_rays
from voxelray_torch.ops.traverse import (any_hit_triangles_brute,
                                         trace_triangles_brute)
from voxelray_torch.ops.tri_accel import (any_hit_triangles_grid,
                                          build_tri_accel,
                                          trace_triangles_grid)
from voxelray_torch.render.camera import Camera
from voxelray_torch.render.pipeline import render_image
from voxelray_torch.utils.convert import (SCENE_ARRAYS, accel_from_numpy,
                                          scene_from_numpy,
                                          tri_accel_from_numpy)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
W, H = 64, 48
IMG_W, IMG_H = 128, 64
TRI_RTOL, TRI_ATOL = 3e-6, 1e-7
RAYS = ("camera", "inside", "t_max")
RENDERS = [("tri", True), ("tri", False), ("hybrid", True)]

_JAX_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from voxelray_tpu.io.objload import LoadedModel
    from voxelray_tpu.models.grids import GridBool
    from voxelray_tpu.models.scene import build_scene
    from voxelray_tpu.ops.tri_accel import build_tri_accel, trace_triangles_grid
    from voxelray_tpu.models.scene import Light
    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.render.pipeline import render_rays
    from voxelray_tpu.render.shading import gamma_post

    inp = dict(np.load(sys.argv[1]))
    out = {}
    tri = inp["sphere_tri"]
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=24)
    for k in ("cell_slot", "cell_tris", "tri9", "origin"):
        out["ta_" + k] = np.asarray(getattr(ta, k))
    for k in ("coarse", "fine", "l2", "fine_sb", "origin"):
        out["tab_" + k] = np.asarray(getattr(ta.brick, k))
    out["ta_meta"] = np.asarray([*ta.dims, ta.l_width, ta.overflow_cells])
    out["ta_vs"] = np.float64(ta.voxel_size)
    for name in ("camera", "inside", "t_max"):
        t, pid, u, v, unres = trace_triangles_grid(
            jnp.asarray(inp[name + "_o"]), jnp.asarray(inp[name + "_d"]), ta,
            t_max=jnp.asarray(inp[name + "_tmax"]), return_stats=True)
        for key, val in (("t", t), ("id", pid), ("u", u), ("v", v),
                         ("unresolved", unres)):
            out[f"{name}_{key}"] = np.asarray(val)

    def model(p):
        return LoadedModel(vertices=inp[p + "verts"], indices=inp[p + "idx"],
                           materials=inp[p + "mats"],
                           mat_index=inp[p + "mat_index"],
                           textures=[str(t) for t in inp[p + "tex"]])

    models = [model("m0_"), model("m1_")]
    xfs = [None, inp["xf"]]
    grid = GridBool.from_mesh(inp["grid_v"], inp["grid_f"],
                              float(inp["grid_vs"]))
    scenes = {"tri": build_scene(models=models, transforms=xfs),
              "hybrid": build_scene(models=models, transforms=xfs,
                                    grid=grid)}
    # render_image's steps, run eagerly: its one jitted program would
    # compile the tri march once per frame, eagerly every march of the
    # same ray count shares one compile
    o, d = make_camera_rays(int(inp["w"]), int(inp["h"]), inp["view_inv"],
                            inp["proj_inv"])
    light = Light()
    for sname, sc in scenes.items():
        assert sc.tri_accel is not None
        for k in inp["scene_arrays"]:
            out[f"{sname}_scene_{k}"] = np.asarray(getattr(sc, k))
        out[f"{sname}_scene_meta"] = np.asarray(sc.grid_dims)
        for shadows in (0, 1):
            if sname == "hybrid" and not shadows:
                continue
            rgb = render_rays(sc, o, d, jnp.asarray(light.position, jnp.float32),
                              jnp.float32(light.intensity),
                              jnp.int32(light.type),
                              jnp.ones(4, jnp.float32), backend="dda",
                              shadows=bool(shadows))
            rgba = jnp.concatenate([rgb, jnp.ones(rgb.shape[:-1] + (1,))], -1)
            out[f"{sname}_img_{shadows}"] = np.asarray(gamma_post(rgba))
    out["grid_occ"] = np.asarray(grid.occupancy())
    out["grid_origin"] = np.asarray(grid.origin)
    np.savez(sys.argv[2], **out)
''')


def _cam_rays(eye, center, w=W, h=H):
    _, _, vi, pi = Camera(eye=eye, center=center).matrices(w, h)
    o, d = make_camera_rays(w, h, vi, pi)
    return o.reshape(-1, 3).numpy().copy(), d.reshape(-1, 3).numpy().copy()


def _model(v, f, rng, tex=None):
    """A LoadedModel with vertex normals, random UVs and two materials
    (one textured when `tex` is a file name)."""
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    verts[:, 3:6] = nrm
    verts[:, 9:11] = rng.uniform(-0.5, 1.5, (len(v), 2))
    mats = np.asarray([[.2, .2, .2, .7, .6, .5, 1, 1, 1, 0, 0, 0, 1, 32, 1,
                        1, 2, 0, 0, -1],
                       [.1, .1, .1, .9, .9, .9, .5, .5, .5, 0, 0, 0, 0, 8, 1,
                        1, 1, 0, 0, 0 if tex else -1]], np.float32)
    return LoadedModel(vertices=verts, indices=f.reshape(-1).astype(np.uint32),
                       materials=mats,
                       mat_index=rng.integers(0, 2, len(f)).astype(np.int32),
                       textures=[tex] if tex else [])


def _inputs(tmp, rng):
    v, f = meshes.icosphere(3)                           # 1280 triangles
    tri = v[f]
    inp = {"sphere_tri": tri}
    # one ray count for every set: JAX compiles its march once per shape
    rays = {"camera": _cam_rays((2.0, 1.3, -2.1), (0.0, 0.0, 0.0))}
    o = rng.uniform(-0.9, 0.9, (W * H, 3)).astype(np.float32)
    d = rng.normal(size=(W * H, 3)).astype(np.float32)
    rays["inside"] = (o, (d / np.linalg.norm(d, axis=1, keepdims=True))
                      .astype(np.float32))
    rays["t_max"] = _cam_rays((2.2, 1.4, -2.2), (0.0, 0.1, 0.0))
    for name, (o, d) in rays.items():
        inp[name + "_o"], inp[name + "_d"] = o, d
        inp[name + "_tmax"] = np.full(len(o), 10000.0, np.float32)
    # half the hits of the t_max rays lie beyond their bound
    t_b, _, _, _ = trace_triangles_brute(*map(torch.from_numpy, (
        rays["t_max"][0], rays["t_max"][1], tri[:, 0], tri[:, 1],
        tri[:, 2])))
    inp["t_max_tmax"][:] = np.median(t_b.numpy()[np.isfinite(t_b.numpy())])

    # the scene: a textured icosphere and a transformed knot, plus a voxel
    # grid for the hybrid scene
    tex = np.stack(np.meshgrid(np.linspace(0, 1, 12), np.linspace(1, 0, 9)),
                   -1)
    tex = np.concatenate([tex, tex[..., :1] * tex[..., 1:]], -1)
    write_png(str(tmp / "tex.png"), tex)
    kv, kf = meshes.torus_knot(2, 3, 64, 8)
    models = [_model(v, f, rng, str(tmp / "tex.png")),
              _model(kv * np.float32(0.3), kf, rng)]
    for i, m in enumerate(models):
        for k in ("verts", "idx", "mats", "mat_index", "tex"):
            attr = {"verts": "vertices", "idx": "indices",
                    "mats": "materials"}.get(k, k)
            attr = "textures" if k == "tex" else attr
            inp[f"m{i}_{k}"] = np.asarray(getattr(m, attr))
    c, s = np.cos(0.6), np.sin(0.6)
    inp["xf"] = np.asarray([[c, 0, s, 1.6], [0, 1.2, 0, 0.2], [-s, 0, c, 0.3],
                            [0, 0, 0, 1]], np.float32)
    gv, gf = meshes.bunny_like(2)
    inp["grid_v"] = (gv * np.float32(0.6)
                     + np.float32([-1.5, -0.4, 0.9])).astype(np.float32)
    inp["grid_f"], inp["grid_vs"] = gf, np.float64(0.06)
    inp["scene_arrays"] = np.asarray(SCENE_ARRAYS)
    cam = Camera(eye=(2.6, 1.7, -2.8), center=(0.4, 0.0, 0.2))
    _, _, vi, pi = cam.matrices(IMG_W, IMG_H)
    inp.update(view_inv=np.asarray(vi, np.float32),
               proj_inv=np.asarray(pi, np.float32), w=IMG_W, h=IMG_H)
    return inp, models


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, JAX outputs, port models) for the whole module."""
    tmp = tmp_path_factory.mktemp("tri")
    inp, models = _inputs(tmp, np.random.default_rng(3))
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, dict(np.load(tmp / "out.npz")), models


@pytest.fixture(scope="module")
def sphere_accel(ref):
    tri = ref[0]["sphere_tri"]
    return build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=24,
                           device="cpu")


def test_hit_triangles_matches_jax():
    """Rays aimed at points in and around mesh triangles (the icosphere's
    and a knot's) from within 55 degrees of the normal, as camera rays
    meet a surface, with per-ray bounds; degenerate triangles miss."""
    rng = np.random.default_rng(0)
    n = 8192
    v, f = meshes.icosphere(3)
    kv, kf = meshes.torus_knot(2, 3, 64, 8)
    mesh = np.concatenate([v[f], kv[kf]])
    tri = mesh[rng.integers(0, len(mesh), n)].copy()
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = nrm * rng.choice([-1.0, 1.0], (n, 1)) + rng.normal(size=(n, 3)) * 0.4
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d = np.where(np.abs((d * nrm).sum(1, keepdims=True)) > 0.57, d,
                 nrm).astype(np.float32)
    tri[:16, 2] = tri[:16, 1]                          # degenerate: miss
    uv = rng.uniform(-0.2, 0.8, (n, 2, 1)).astype(np.float32)
    p = tri[:, 0] + uv[:, 0] * (tri[:, 1] - tri[:, 0]) \
        + uv[:, 1] * (tri[:, 2] - tri[:, 0])
    o = (p - d * rng.uniform(0.2, 3.0, (n, 1))).astype(np.float32)
    tmin = rng.uniform(0, 0.5, n).astype(np.float32)
    tmax = rng.uniform(0.5, 4.0, n).astype(np.float32)
    t_j, u_j, v_j = map(np.asarray, jhit_triangles(
        *map(jnp.asarray, (o, d, tri[:, 0], tri[:, 1], tri[:, 2])),
        t_min=jnp.asarray(tmin), t_max=jnp.asarray(tmax)))
    t, u, v = hit_triangles(*map(torch.from_numpy, (
        o, d, tri[:, 0], tri[:, 1], tri[:, 2])),
        t_min=torch.from_numpy(tmin), t_max=torch.from_numpy(tmax))
    hit = np.isfinite(t_j)
    assert 1000 < hit.sum() < n and not np.isfinite(t.numpy()[:16]).any()
    assert np.array_equal(np.isfinite(t.numpy()), hit)
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=TRI_RTOL,
                               atol=TRI_ATOL)
    # barycentrics: JAX's own bound (tests/_tri_accel_impl.py:70-72)
    np.testing.assert_allclose(u.numpy()[hit], u_j[hit], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], v_j[hit], rtol=1e-4,
                               atol=1e-5)


def _check_tri(t, pid, t_ref, id_ref, min_hits):
    t, pid = np.asarray(t), np.asarray(pid)
    hit = np.isfinite(t_ref)
    assert hit.sum() >= min_hits
    assert np.array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=TRI_RTOL,
                               atol=TRI_ATOL)
    assert (pid[hit] == id_ref[hit]).mean() > 0.995
    assert np.all(pid[~hit] == -1)


@pytest.mark.parametrize("name", RAYS)
def test_brute_trace_matches_jax(ref, name):
    """Brute force over every triangle, ties to the lowest index."""
    inp = ref[0]
    tri = inp["sphere_tri"]
    args = [inp[name + "_o"], inp[name + "_d"], tri[:, 0], tri[:, 1],
            tri[:, 2]]
    t_j, id_j, _, _ = map(np.asarray, jbrute(
        *map(jnp.asarray, args), t_max=jnp.asarray(inp[name + "_tmax"])))
    t, pid, _, _ = trace_triangles_brute(
        *map(torch.from_numpy, args),
        t_max=torch.from_numpy(inp[name + "_tmax"]))
    _check_tri(t, pid, t_j, id_j, 50)
    occl = any_hit_triangles_brute(
        *map(torch.from_numpy, args),
        t_max=torch.from_numpy(inp[name + "_tmax"]))
    assert torch.equal(occl, torch.isfinite(t))


def test_build_tri_accel_matches_jax(ref, sphere_accel):
    """The tables are JAX's: cell_slot, cell_tris (rows ascending),
    l_width, overflow_cells, tri9 and the brick accel's tables tri_march
    reads; the port leaves out K2's fine_sb, which tri_march never
    reads."""
    _, out, _ = ref
    ta = sphere_accel
    nx, ny, nz, l_width, overflow = out["ta_meta"]
    assert ta.dims == (nx, ny, nz) and ta.l_width == l_width
    assert ta.overflow_cells == overflow == 0
    assert ta.voxel_size == float(out["ta_vs"])
    assert np.array_equal(ta.origin.numpy(), out["ta_origin"])
    for k in ("cell_slot", "cell_tris", "tri9"):
        assert np.array_equal(getattr(ta, k).numpy(), out["ta_" + k]), k
    for k in ("coarse", "fine", "l2"):
        assert np.array_equal(getattr(ta.brick, k).numpy().view(np.uint32),
                              out["tab_" + k]), k
    assert ta.brick.fine_sb is None


@pytest.mark.parametrize("name", RAYS)
def test_trace_triangles_grid_matches_jax_and_brute(ref, sphere_accel, name):
    """The march: unresolved 0, hit mask equal to the brute trace and to
    JAX's march, t and ids within the module's tolerances.  "inside" rays
    start inside the grid (round 0), "t_max" cuts half the hits.

    Reference fault: JAX's round 0 tests the cell holding the origin, so
    a ray whose origin lies within t_min of that cell's exit loses the
    hits of the next cell (2 of the 3072 "inside" rays here).  The port
    tests the cell holding o + d * t_min; on the rays where JAX's march
    misses a hit the brute trace finds, the port matches the brute trace.
    """
    inp, out, _ = ref
    o, d = torch.from_numpy(inp[name + "_o"]), torch.from_numpy(
        inp[name + "_d"])
    tmax = torch.from_numpy(inp[name + "_tmax"])
    t, pid, u, v, unresolved = trace_triangles_grid(
        o, d, sphere_accel, t_max=tmax, return_stats=True)
    assert unresolved == 0 and int(out[name + "_unresolved"]) == 0
    tri = torch.from_numpy(inp["sphere_tri"])
    t_b, id_b, _, _ = trace_triangles_brute(o, d, tri[:, 0], tri[:, 1],
                                            tri[:, 2], t_max=tmax)
    _check_tri(t, pid, t_b.numpy(), id_b.numpy(), 20)
    t_j, id_j = out[name + "_t"].copy(), out[name + "_id"].copy()
    fault = np.isfinite(t_j) != np.isfinite(t_b.numpy())
    assert fault.sum() <= (2 if name == "inside" else 0)
    assert not (np.isfinite(t_j) & fault).any()     # JAX only loses hits
    t_j[fault], id_j[fault] = t_b.numpy()[fault], id_b.numpy()[fault]
    _check_tri(t, pid, t_j, id_j, 20)
    occl = any_hit_triangles_grid(o, d, sphere_accel, t_max=tmax)
    assert torch.equal(occl, torch.isfinite(t))


def test_carried_tri_accel_traces_like_the_port_build(ref, sphere_accel):
    """JAX's TriAccel carried over as numpy (utils/convert.py) gives the
    port's march the same answers as the port's own build."""
    inp, out, _ = ref
    brick = accel_from_numpy(out["tab_coarse"], out["tab_fine"],
                             out["tab_l2"], out["tab_fine_sb"],
                             out["tab_origin"], sphere_accel.brick.dims,
                             sphere_accel.brick.bdims,
                             sphere_accel.brick.voxel_size)
    nx, ny, nz, l_width, overflow = out["ta_meta"]
    ta = tri_accel_from_numpy(brick, out["ta_cell_slot"],
                              out["ta_cell_tris"], out["ta_tri9"],
                              out["ta_origin"], (nx, ny, nz),
                              float(out["ta_vs"]), l_width, overflow)
    o, d = (torch.from_numpy(inp["camera_o"]),
            torch.from_numpy(inp["camera_d"]))
    for a, b in zip(trace_triangles_grid(o, d, ta),
                    trace_triangles_grid(o, d, sphere_accel)):
        assert torch.equal(a, b)


def _port_scene(inp, models, kind):
    grid = None
    if kind == "hybrid":
        grid = GridBool.from_mesh(inp["grid_v"], inp["grid_f"],
                                  float(inp["grid_vs"]), device="cpu")
    return build_scene(models=models, transforms=[None, inp["xf"]],
                       grid=grid, device="cpu")


@pytest.mark.parametrize("kind", ["tri", "hybrid"])
def test_build_scene_matches_jax(ref, kind):
    """Two models, an instance transform and a PNG texture: every scene
    array equals JAX's (the transformed normals within 1e-6: numpy's
    inverse-transpose product), the tri accel and voxel accel built."""
    inp, out, models = ref
    scene = _port_scene(inp, models, kind)
    assert scene.tri_accel is not None and scene.n_triangles == 1280 + 1024
    assert (scene.accel is not None) == (kind == "hybrid")
    assert scene.grid_dims == tuple(out[f"{kind}_scene_meta"])
    assert scene.textures.shape[0] == 1
    for k in SCENE_ARRAYS:
        ours, want = getattr(scene, k).numpy(), out[f"{kind}_scene_{k}"]
        assert ours.shape == want.shape and ours.dtype == want.dtype, k
        assert np.array_equal(ours, want), k


@pytest.mark.parametrize("kind,shadows", RENDERS)
def test_render_matches_jax(ref, kind, shadows):
    """Triangle-only and hybrid (triangles + voxels) frames: the port's
    fast backend (megakernel for the voxels, staged walk for the tri-grid
    march) against JAX's dda render, and the port's staged voxel walk
    (fast_opts {"mega": False}) and its dda render give the same frame."""
    inp, out, models = ref
    scene = _port_scene(inp, models, kind)
    vi, pi = inp["view_inv"], inp["proj_inv"]
    ref_img = out[f"{kind}_img_{int(shadows)}"]
    imgs = {be: render_image(scene, vi, pi, width=IMG_W, height=IMG_H,
                             backend=be, shadows=shadows).numpy()
            for be in ("fast", "dda")}
    imgs["staged"] = render_image(
        scene, vi, pi, width=IMG_W, height=IMG_H, backend="fast",
        shadows=shadows, fast_opts={"mega": False},
        shadow_opts={"mega": False}).numpy()
    miss = np.float32(0.8) ** np.float32(1 / 2.2)
    hit_ref = (ref_img[..., :3] != miss).any(-1)
    assert hit_ref.sum() > 800
    for name, img in imgs.items():
        hit = (img[..., :3] != miss).any(-1)
        assert np.array_equal(hit, hit_ref), name
        close = (np.abs(img - ref_img) <= 2e-5).all(-1)
        print(f"{kind} shadows={shadows} {name}: {int((~close).sum())} "
              "pixels outside 2e-5")
        assert close.mean() >= 0.999, name
    assert np.array_equal(imgs["staged"], imgs["fast"])


def test_carried_scene_renders_like_the_port_build(ref):
    """JAX's Scene arrays carried over as numpy render the same frame as
    the port's own build_scene."""
    inp, out, models = ref
    own = _port_scene(inp, models, "tri")
    carried = scene_from_numpy(
        {k: out[f"tri_scene_{k}"] for k in SCENE_ARRAYS},
        tuple(out["tri_scene_meta"]), 1.0, tri_accel=own.tri_accel)
    args = dict(width=IMG_W // 2, height=IMG_H // 2, backend="fast")
    vi, pi = inp["view_inv"], inp["proj_inv"]
    assert torch.equal(render_image(carried, vi, pi, **args),
                       render_image(own, vi, pi, **args))
