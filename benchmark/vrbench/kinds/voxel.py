"""A static voxel scene: the mesh voxelized once at set-up by
GridBool.from_mesh (voxelize_mesh: K1 on the card), then
build_scene(grid=...)."""
from __future__ import annotations

import torch

from .. import inputs, reference
from ..program import Program as _Program

__all__ = ["geometry", "Program", "reference_scene"]


def geometry(config):
    v, f = inputs.mesh_of(config)
    return inputs.Geometry(f, [v], inputs.grid_of(v, config["grid_res"]))


class Program(_Program):
    def __init__(self, config, geo, device):
        super().__init__(config, device)
        from voxelray_torch.models.grids import GridBool
        from voxelray_torch.models.scene import build_scene
        v, f = geo.sets[0], geo.faces
        bb_min, bb_max, vs, _ = geo.grid
        grid_bool = GridBool.from_mesh(v, f, vs, bb_min=bb_min,
                                       bb_max=bb_max, device=device)
        self.lap("GridBool.from_mesh")
        self.scene = build_scene(grid=grid_bool,
                                 voxel_material=self.material,
                                 device=device)
        self.lap("build_scene")
        # the occupancy the scene holds, unpacked from its words
        self.outputs = {"occupancy": grid_bool.occupancy(),
                        "set_calls": grid_bool.set_calls}


def reference_scene(config, geo, key, device, dtype=torch.float64,
                    vox_dtype=torch.float32):
    """The reference's voxelize of vertex set `key` and its scene."""
    bb_min, _, vs, dims = geo.grid
    occ, calls = reference.voxelize(geo.sets[key], geo.faces, bb_min, vs,
                                    dims, device, vox_dtype)
    return reference.VoxelScene(occ, bb_min, vs, dims, dtype), (occ, calls)
