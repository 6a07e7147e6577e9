"""The port's image outputs besides the shaded frame, against the JAX
package on the CPU: render_aov (depth, normal, hit mask) on every voxel
backend, the trilinear `_sample_texture(lod=...)`, and the raster path.

render_aov: the hit mask is equal; t agrees within rtol 2e-6 on every hit
pixel (so the cells agree: a different cell moves t by far more) and the
normals within 1e-6, unit length.  The sampler: within 1e-6 on random uv
and lod over a two-texture mip atlas.  Raster: the covered pixels are
equal (an edge function within a few ulps of 0 could flip a pixel
between XLA's contracted and the port's uncontracted expressions; the
count of such pixels is asserted) and >= 99.9% of pixels within 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.io.objload import LoadedModel as JLoadedModel
from voxelray_tpu.io.objload import Material as JMaterial
from voxelray_tpu.io.objload import ObjLoader as JObjLoader
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.models.octree import Octree as JOctree
from voxelray_tpu.models.scene import build_scene as jbuild_scene
from voxelray_tpu.render.pipeline import _sample_texture as jsample
from voxelray_tpu.render.pipeline import render_aov as jrender_aov
from voxelray_tpu.render.raster import rasterize_scene as jrasterize_scene
from voxelray_torch.io.objload import LoadedModel, Material, ObjLoader
from voxelray_torch.io.objload import write_obj
from voxelray_torch.io.textures import write_png
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.octree import Octree
from voxelray_torch.models.scene import Light, build_scene
from voxelray_torch.render.camera import Camera
from voxelray_torch.render.pipeline import _sample_texture, render_aov
from voxelray_torch.render.raster import rasterize_scene

from _jax_nocache import compile_cache_off

torch.set_num_threads(2)
W, H = 96, 54
VS = 0.09


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An OBJ ground plane, an OBJ icosphere and a random 32x32 texture."""
    d = tmp_path_factory.mktemp("raster")
    pv, pf = jmeshes.plane(10.0, y=-1.05)
    write_obj(str(d / "plane.obj"), pv, pf)
    v, f = jmeshes.icosphere(1)
    write_obj(str(d / "ico.obj"), v, f)
    rng = np.random.default_rng(0)
    write_png(str(d / "tex.png"),
              (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    return d


@pytest.fixture(scope="module")
def aov_scenes(files):
    """icosphere(2) voxels with an octree, plus the plane model."""
    v, f = jmeshes.icosphere(2)
    plane = str(files / "plane.obj")
    jscene = jbuild_scene(models=[JObjLoader().load_model(plane)],
                          grid=JGridBool.from_mesh(v, f, VS),
                          octree=JOctree.from_mesh(v, f, VS))
    scene = build_scene(models=[ObjLoader().load_model(plane)],
                        grid=GridBool.from_mesh(v, f, VS, device="cpu"),
                        octree=Octree.from_mesh(v, f, VS, device="cpu"),
                        device="cpu")
    return jscene, scene


@pytest.mark.parametrize("backend", ["dda", "brute", "octree"])
def test_render_aov_matches_jax(aov_scenes, backend):
    jscene, scene = aov_scenes
    cam = Camera(eye=(2.2, 1.4, -2.6), center=(0.0, 0.0, 0.0))
    with compile_cache_off():     # JAX's reference, compiled afresh
        jd, jn, jh = (np.asarray(x) for x in jrender_aov(
            jscene, cam, width=W, height=H, backend=backend))
    d, n, h = (x.numpy() for x in render_aov(scene, cam, width=W, height=H,
                                             backend=backend))
    assert d.shape == (H, W) and n.shape == (H, W, 3) and h.dtype == bool
    assert np.array_equal(h, jh) and 1000 < h.sum() < H * W
    far = np.flatnonzero(~np.isclose(d[h], jd[h], rtol=2e-6, atol=0.0))
    assert far.tolist() == [], (far[:8], d[h][far[:8]], jd[h][far[:8]])
    assert np.isinf(d[~h]).all() and (n[~h] == 0).all()
    assert np.abs(n - jn).max() <= 1e-6
    assert np.allclose(np.linalg.norm(n[h], axis=-1), 1.0, atol=1e-6)


def test_render_aov_fast_equals_dda(aov_scenes):
    """The fast backend (K2's plain version here) in tile order gives the
    dda's buffers."""
    _, scene = aov_scenes
    cam = Camera(eye=(2.2, 1.4, -2.6), center=(0.0, 0.0, 0.0))
    fast = render_aov(scene, cam, width=128, height=16, backend="fast")
    dda = render_aov(scene, cam, width=128, height=16, backend="dda")
    for a, b in zip(fast, dda):
        assert torch.equal(a, b)


def _tri_model(cls_model, cls_mat, tex):
    """A textured quad with repeat uv, specular material."""
    verts = np.zeros((4, 11), np.float32)
    verts[:, 0:3] = [[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]]
    verts[:, 3:6] = [0, 1, 0]
    verts[:, 6:9] = 1.0
    verts[:, 9:11] = [[0, 0], [6, 0], [6, 6], [0, 6]]
    mat = cls_mat(diffuse=(1, 1, 1), specular=(0.3, 0.3, 0.3),
                  shininess=20.0, illum=2, texture_id=0).as_row()[None]
    return cls_model(vertices=verts, indices=np.asarray([0, 1, 2, 0, 2, 3],
                                                        np.uint32),
                     materials=mat, textures=[tex],
                     mat_index=np.zeros(2, np.int32))


@pytest.fixture(scope="module")
def raster_scenes(files):
    tex, ico = str(files / "tex.png"), str(files / "ico.obj")
    jscene = jbuild_scene(models=[_tri_model(JLoadedModel, JMaterial, tex),
                                  JObjLoader().load_model(ico)])
    scene = build_scene(models=[_tri_model(LoadedModel, Material, tex),
                                ObjLoader().load_model(ico)], device="cpu")
    return jscene, scene


def test_sample_texture_trilinear_matches_jax(files):
    """Random uv (repeat addressing) and lod (clamped at both ends of the
    chain) over a 32x32 and a 4x4 texture; layer -1 samples white."""
    rng = np.random.default_rng(3)
    small = str(files / "small.png")
    write_png(small, (rng.random((4, 4, 3)) * 255).astype(np.uint8))
    tex = str(files / "tex.png")
    models = [_tri_model(LoadedModel, Material, t) for t in (small, tex)]
    jmodels = [_tri_model(JLoadedModel, JMaterial, t) for t in (small, tex)]
    scene = build_scene(models=models, device="cpu")
    jscene = jbuild_scene(models=jmodels)
    n = 4096
    layer = rng.integers(-1, 2, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 7.0, n).astype(np.float32)
    want = np.asarray(jsample(jscene.textures, jscene.tex_meta,
                              jnp.asarray(layer), jnp.asarray(uv),
                              lod=jnp.asarray(lod)))
    got = _sample_texture(scene.textures, scene.tex_meta,
                          torch.from_numpy(layer), torch.from_numpy(uv),
                          lod=torch.from_numpy(lod)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert (got[layer < 0] == 1.0).all()
    base = _sample_texture(scene.textures, scene.tex_meta,
                           torch.from_numpy(layer), torch.from_numpy(uv))
    at0 = _sample_texture(scene.textures, scene.tex_meta,
                          torch.from_numpy(layer), torch.from_numpy(uv),
                          lod=torch.zeros(n))
    assert torch.equal(base, at0)


@pytest.mark.parametrize("width,height,light", [
    (96, 54, Light()),
    (97, 55, Light(position=(0.3, 1.0, -0.2), intensity=0.9, type=1)),
])
def test_rasterize_scene_matches_jax(raster_scenes, width, height, light):
    jscene, scene = raster_scenes
    cam = Camera(eye=(3.0, 2.0, -3.5), center=(0.0, -0.3, 0.0))
    kw = dict(width=width, height=height, clear_color=(0.0, 0.0, 0.0, 1.0))
    from voxelray_tpu.models.scene import Light as JLight
    jlight = JLight(position=light.position, intensity=light.intensity,
                    type=light.type)
    ref = np.asarray(jrasterize_scene(jscene, cam, light=jlight, **kw))
    got = rasterize_scene(scene, cam, light=light, **kw).numpy()
    assert got.shape == (height, width, 4)
    cov, jcov = got[..., :3].max(-1) > 0, ref[..., :3].max(-1) > 0
    flipped = int((cov != jcov).sum())
    print(f"{width}x{height}: {int(cov.sum())} covered, {flipped} flipped")
    assert flipped == 0
    assert 0.2 < cov.mean() < 0.9
    close = (np.abs(got - ref) <= 2e-5).all(axis=-1)
    assert close.mean() >= 0.999


def test_rasterize_without_triangles_is_the_clear_colour():
    scene = build_scene(device="cpu")
    img = rasterize_scene(scene, width=8, height=4,
                          clear_color=(0.25, 0.5, 1.0, 1.0)).numpy()
    want = np.float32([0.25, 0.5, 1.0, 1.0]) ** np.float32(1.0 / 2.2)
    assert np.allclose(img, want, rtol=1e-6, atol=0)
