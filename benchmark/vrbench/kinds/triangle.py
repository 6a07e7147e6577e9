"""A static triangle scene: the mesh as one model with flat normals,
build_scene(models=[...]) (the triangle accel built on the device)."""
from __future__ import annotations

import numpy as np
import torch

from .. import inputs, reference
from ..program import Program as _Program

__all__ = ["geometry", "Program", "reference_scene"]


def geometry(config):
    v, f = inputs.mesh_of(config)
    return inputs.Geometry(f, [v])


class Program(_Program):
    def __init__(self, config, geo, device):
        super().__init__(config, device)
        from voxelray_torch.io.objload import LoadedModel
        from voxelray_torch.models.scene import build_scene
        v, f = geo.sets[0], geo.faces
        model = LoadedModel(
            vertices=inputs.knot_streams(v, f),
            indices=np.arange(3 * len(f), dtype=np.uint32),
            materials=np.asarray(config["shading"]["material"],
                                 np.float32)[None],
            textures=[], mat_index=np.zeros(len(f), np.int32))
        self.lap("triangle streams")
        self.scene = build_scene(models=[model],
                                 voxel_material=self.material,
                                 device=device)
        self.lap("build_scene")


def reference_scene(config, geo, key, device, dtype=torch.float64,
                    vox_dtype=torch.float32):
    """The reference's own triangle grid over vertex set `key`; no
    voxelize."""
    return reference.TriangleScene(geo.sets[key], geo.faces,
                                   config["reference_grid_res"], device,
                                   dtype), None
