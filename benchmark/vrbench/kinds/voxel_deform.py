"""A voxel scene whose mesh deforms every frame (kind `voxel-deform`): the
configuration's `deform.sets` vertex sets of one animation cycle, set k
the mesh under inputs.deformed at phase 2 pi k / sets, all on one grid of
`grid_res` cells on the longest axis of their union bounding box.

Set-up plans the voxelize once, `plan_voxelize(set 0, faces, ...,
deform_safe=True)`, and copies every set to the device.  Each step, as a
user of a deforming mesh runs it: `voxelize_planned(plan, its set)` (K1),
`build_scene(grid={"occ", "dims", "origin", "voxel_size"})` (the brick
accel and the AABB list) and then the frame; the step's occupancy and
set_calls are its answers.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import inputs
from ..program import Program as _Program
from .voxel import reference_scene

__all__ = ["geometry", "Program", "reference_scene"]


def geometry(config):
    v, f = inputs.mesh_of(config)
    n, amplitude = int(config["deform"]["sets"]), \
        float(config["deform"]["amplitude"])
    geo = inputs.Geometry(f, [inputs.deformed(v, 2.0 * np.pi * k / n,
                                              amplitude)
                              for k in range(n)])
    geo.grid = inputs.grid_of(np.stack(geo.bbox), config["grid_res"])
    return geo


class Program(_Program):
    changes = True

    def __init__(self, config, geo, device):
        super().__init__(config, device)
        from voxelray_torch.models.scene import build_scene
        from voxelray_torch.ops.voxelize import (plan_voxelize,
                                                 voxelize_planned)
        self._build, self._voxelize = build_scene, voxelize_planned
        bb_min, bb_max, vs, dims = geo.grid
        self.plan = plan_voxelize(geo.sets[0], geo.faces, vs, bb_min=bb_min,
                                  bb_max=bb_max, deform_safe=True,
                                  device=device)
        if tuple(self.plan.dims) != tuple(dims):
            raise ValueError(f"the plan's grid {self.plan.dims} is not the "
                             f"configuration's {dims}")
        self.lap("plan_voxelize")
        self.sets = torch.as_tensor(np.stack(geo.sets), device=device)
        self.key = geo.key
        self.grid = {"dims": self.plan.dims, "origin": self.plan.origin,
                     "voxel_size": self.plan.voxel_size}
        self.lap("vertex sets to the device")

    def step(self, step):
        occ, calls = self._voxelize(self.plan, self.sets[self.key(step)])
        with self.call("build_scene"):
            self.scene = self._build(grid=dict(self.grid, occ=occ),
                                     voxel_material=self.material,
                                     device=self.device)
        self.answers = {"occupancy": occ, "set_calls": calls}

    def free(self):
        super().free()
        self.plan = self.sets = None
