"""Configuration dataclasses + the five BASELINE gate presets.

Copied from voxelray_tpu/utils/config.py so the port imports no JAX; the
presets are the same values field by field.

The reference's config surface (SURVEY.md section 5) is argv (obj path +
voxel size, main.cpp:163), compile-time template flags (encoding,
parallelism, octree leaf size), and ImGui controls (light, clear color,
ray/raster toggle).  Here it's one dataclass tree consumed by the CLI and
the benchmark harness.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["RenderSettings", "VoxelizeSettings", "JobConfig",
           "BASELINE_CONFIGS"]


@dataclass(frozen=True)
class VoxelizeSettings:
    voxel_size: float = 0.03125
    encoding: str = "bool"          # bool | aabbstruct | vec | octree
    parallel: bool = True           # multi-device sharding when available
    max_items_per_leaf: int = 16    # octree leaf budget (octTree.hpp:489)


@dataclass(frozen=True)
class RenderSettings:
    width: int = 1280               # main.cpp:72
    height: int = 720               # main.cpp:73
    backend: str = "dda"            # dda | brute
    mode: str = "ray"               # ray | raster (main.cpp:241-247)
    shadows: bool = True
    light_position: tuple = (10.0, 55.0, 8.0)
    light_intensity: float = 1000.0
    light_type: int = 0             # 0 point, 1 directional
    clear_color: tuple = (1.0, 1.0, 1.0, 1.0)
    frames: int = 1                 # >1 = orbit fly-through batch


@dataclass(frozen=True)
class JobConfig:
    mesh: str = "cube"              # registry name or .obj path
    voxelize: VoxelizeSettings = field(default_factory=VoxelizeSettings)
    render: RenderSettings = field(default_factory=RenderSettings)
    with_plane: bool = True         # the ground plane model (main.cpp:160)
    output: str | None = None       # .npy/.png framebuffer dump

    def derived(self, **kw):
        return replace(self, **kw)


def _cfg(mesh, vs, encoding, width=1280, height=720, frames=1,
         backend="dda", mode="ray", with_plane=True):
    return JobConfig(
        mesh=mesh,
        voxelize=VoxelizeSettings(voxel_size=vs, encoding=encoding),
        render=RenderSettings(width=width, height=height, frames=frames,
                              backend=backend, mode=mode),
        with_plane=with_plane,
    )


#: The five gate configs from BASELINE.json.
BASELINE_CONFIGS = {
    # 1. cube -> voxelgridBool 64^3, occupancy only
    "cube64": _cfg("cube", 2.0 / 64, "bool", with_plane=False),
    # 2. bunny -> AABB-struct 128^3 + primary-ray render, flat shading
    "bunny128": _cfg("bunny", 2.8 / 128, "aabbstruct"),
    # 3. vec encoding 256^3 + octree traversal, depth+normal output
    "vec256": _cfg("bunny", 2.8 / 256, "vec", backend="octree"),
    # 4. 1M-triangle mesh -> 512^3, 1080p, shadows, fly-through, on the
    # production traversal (backend "fast")
    "knot512": _cfg("knot1m", 4.3 / 512, "bool", width=1920, height=1080,
                    frames=8, backend="fast"),
    # 5. deforming mesh, per-frame re-voxelization of a frame batch
    "deform8": _cfg("bunny", 2.8 / 128, "bool", frames=8),
}
