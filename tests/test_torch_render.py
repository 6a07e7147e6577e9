"""The port's slice end to end (from_mesh -> build_scene -> render_image)
and its shading functions, against the JAX package on the CPU.

The port renders with backend="fast" (on the CPU the megakernel's plain
version); JAX renders the same scene with its exhaustive dda.  The hit
mask must be equal and at least 99.9% of pixels within 2e-5 in every
RGBA channel: shadow rays start at the hit point, whose float32 value
inherits the ray and the t of each package, so a grazing shadow ray may
flip; the count of pixels outside 2e-5 is printed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.io.objload import Material as JMaterial
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.models.scene import build_scene as jbuild_scene
from voxelray_tpu.ops.geometry import mesh_bbox
from voxelray_tpu.render import shading as jshading
from voxelray_tpu.render.camera import Camera
from voxelray_tpu.render.pipeline import render_image as jrender_image
from voxelray_torch.io.objload import Material
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.scene import Light, build_scene
from voxelray_torch.render import shading
from voxelray_torch.render.pipeline import render_image, render_scene

torch.set_num_threads(2)
VS = 0.05


@pytest.fixture(scope="module")
def scenes():
    v, f = jmeshes.bunny_like(3)
    jscene = jbuild_scene(models=None, grid=JGridBool.from_mesh(v, f, VS))
    scene = build_scene(grid=GridBool.from_mesh(v, f, VS, device="cpu"),
                        device="cpu")
    bb_min, bb_max = mesh_bbox(v)
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * 1.3
                           * float(max(bb_max - bb_min))),
                 center=tuple(center))
    return jscene, scene, cam


@pytest.mark.parametrize("width,height", [(128, 64), (96, 54)])
@pytest.mark.parametrize("shadows", [True, False])
def test_render_matches_jax(scenes, width, height, shadows):
    jscene, scene, cam = scenes
    _, _, vi, pi = cam.matrices(width, height)
    ref = np.asarray(jrender_image(jscene, vi, pi, width=width,
                                   height=height, backend="dda",
                                   shadows=shadows))
    img = render_image(scene, vi, pi, width=width, height=height,
                       backend="fast", shadows=shadows).numpy()
    assert img.shape == (height, width, 4) and img.dtype == np.float32
    miss = np.float32(0.8) ** np.float32(1 / 2.2)
    hit_ref = (ref[..., :3] != miss).any(-1)
    hit = (img[..., :3] != miss).any(-1)
    assert hit.sum() > 300
    assert np.array_equal(hit, hit_ref)
    close = (np.abs(img - ref) <= 2e-5).all(-1)
    print(f"{width}x{height} shadows={shadows}: {int((~close).sum())} "
          f"pixels outside 2e-5")
    assert close.mean() >= 0.999
    if shadows:
        dark = hit & (img[..., 0] < ref[..., 0] * 0.9)
        assert not dark.all()  # shadows actually darken only some pixels


def test_render_scene_defaults(scenes):
    """render_scene's default camera and light, dda vs fast in the port.
    Backend "octree" on a scene without an octree takes the brute trace
    over the scene's AABB list, as JAX's dispatch does: the same hits,
    and pixels within 2e-5 (the box centre (min + max) / 2 may differ
    from the cell centre by an ulp); an unknown backend raises."""
    _, scene, _ = scenes
    a = render_scene(scene, width=64, height=36, backend="dda")
    b = render_scene(scene, width=64, height=36, backend="fast")
    assert torch.equal(a, b)
    assert torch.isfinite(a).all() and float(a.min()) >= 0.0
    c = render_scene(scene, width=64, height=36, backend="octree")
    assert scene.octree is None and scene.n_voxels > 0
    close = ((c - a).abs() <= 2e-5).all(-1)
    assert float(close.float().mean()) >= 0.999
    with pytest.raises(ValueError):
        render_scene(scene, width=8, height=8, backend="raster")


def _rand_unit(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("illum,shininess", [(0, 0.0), (1, 2.0), (2, 32.0)])
def test_shading_functions_match_jax(illum, shininess):
    rng = np.random.default_rng(illum)
    n = 4096
    mat = np.broadcast_to(
        JMaterial(illum=illum, shininess=shininess).as_row(), (n, 20)).copy()
    assert np.array_equal(mat[0], Material(illum=illum,
                                           shininess=shininess).as_row())
    normal = _rand_unit(rng, n)
    light = _rand_unit(rng, n)
    view = _rand_unit(rng, n)
    t = torch.from_numpy
    np.testing.assert_allclose(
        shading.compute_diffuse(t(mat), t(light), t(normal)).numpy(),
        np.asarray(jshading.compute_diffuse(
            jnp.asarray(mat), jnp.asarray(light), jnp.asarray(normal))),
        rtol=1e-6, atol=1e-7)
    # specular is max(V.R, 0) ** s with s >= 4: its relative error is s
    # times that of the dot product, which JAX's XLA:CPU build evaluates
    # with fused multiply-adds (about one ulp off the port's)
    exponent = max(4.0, shininess)
    np.testing.assert_allclose(
        shading.compute_specular(t(mat), t(view), t(light), t(normal))
        .numpy(),
        np.asarray(jshading.compute_specular(
            jnp.asarray(mat), jnp.asarray(view), jnp.asarray(light),
            jnp.asarray(normal))),
        rtol=1e-6 * exponent, atol=1e-7)


def test_cube_normal_light_miss_gamma_match_jax():
    rng = np.random.default_rng(11)
    n = 4096
    centers = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    hits = (centers + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
    # exact three-way ties: dyadic centres and offsets round nowhere
    centers[:8] = rng.integers(-8, 8, (8, 3)) * np.float32(0.25)
    hits[:8] = centers[:8] + np.float32(0.0625)
    ours = shading.cube_normal(torch.from_numpy(hits),
                               torch.from_numpy(centers)).numpy()
    ref = np.asarray(jshading.cube_normal(jnp.asarray(hits),
                                          jnp.asarray(centers)))
    assert np.array_equal(ours, ref)
    assert np.all(np.abs(ours[:8, 0]) == 1)   # ties resolve to x
    for ltype in (shading.LIGHT_POINT, shading.LIGHT_DIRECTIONAL):
        light = Light(type=ltype)
        got = shading.light_terms(torch.from_numpy(hits), light.position,
                                  light.intensity, light.type)
        want = jshading.light_terms(jnp.asarray(hits),
                                    jnp.asarray(light.position, jnp.float32),
                                    jnp.float32(light.intensity),
                                    jnp.int32(light.type))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
    cc = (0.2, 0.5, 0.9, 1.0)
    assert np.array_equal(shading.miss_color(cc).numpy(),
                          np.asarray(jshading.miss_color(cc)))
    rgba = rng.uniform(-0.1, 2.0, (n, 4)).astype(np.float32)
    np.testing.assert_allclose(
        shading.gamma_post(torch.from_numpy(rgba)).numpy(),
        np.asarray(jshading.gamma_post(jnp.asarray(rgba))), rtol=1e-6,
        atol=0)
