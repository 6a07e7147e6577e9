"""A triangle scene whose mesh deforms every frame (kind `triangle-deform`):
the configuration's `deform.sets` vertex sets of one animation cycle (set k
the mesh under inputs.deformed at phase 2 pi k / sets), ray-traced as
triangles with each set's flat normals, the triangle accel on one tri grid
over the sets' union bounding box (tri_work.tri_grid).

Set-up plans the scene once, as a user of an animated mesh does:
`plan_scene` over the mesh as one model with shared vertices and no
normals, the union box as its bb_min / bb_max; and copies every set to the
device.  Each step: `build_scene_planned(plan, its set)` (the corners, the
flat normals and the triangle accel rebuilt on the device), then the frame.
The reference's scene of a step is the triangle kind's over that step's
own set.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import inputs, tri_work
from ..program import Program as _Program
from .triangle import reference_scene

__all__ = ["geometry", "Program", "reference_scene"]


def geometry(config):
    v, f = inputs.mesh_of(config)
    n, amplitude = int(config["deform"]["sets"]), \
        float(config["deform"]["amplitude"])
    return inputs.Geometry(f, [inputs.deformed(v, 2.0 * np.pi * k / n,
                                               amplitude)
                               for k in range(n)])


class Program(_Program):
    changes = True

    def __init__(self, config, geo, device):
        super().__init__(config, device)
        from voxelray_torch.io.objload import LoadedModel
        from voxelray_torch.models.scene import (build_scene_planned,
                                                 plan_scene)
        self._build = build_scene_planned
        v, f = geo.sets[0], geo.faces
        verts = np.zeros((len(v), 11), np.float32)
        verts[:, 0:3] = v
        model = LoadedModel(
            vertices=verts, indices=f.reshape(-1).astype(np.uint32),
            materials=np.asarray(config["shading"]["material"],
                                 np.float32)[None],
            textures=[], mat_index=np.zeros(len(f), np.int32))
        lo, hi = geo.bbox
        self.plan = plan_scene([model], bb_min=lo, bb_max=hi,
                               voxel_material=self.material, device=device)
        _, _, dims = tri_work.tri_grid(geo)
        got = None if self.plan.tri is None else tuple(self.plan.tri.dims)
        if got != tuple(dims):
            raise ValueError(f"the plan's tri grid {got} is not the "
                             f"benchmark's {dims}")
        self.lap("plan_scene")
        self.sets = torch.as_tensor(np.stack(geo.sets), device=device)
        self.key = geo.key
        self.lap("vertex sets to the device")

    def step(self, step):
        with self.call("build_scene"):
            self.scene = self._build(self.plan, self.sets[self.key(step)])

    def free(self):
        super().free()
        self.plan = self.sets = None
