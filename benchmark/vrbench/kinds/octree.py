"""A static voxel scene under its Morton octree (kind `octree`, BASELINE
configs[2]): the mesh's SAT hits as the compressed grid's boxes
(GridVec.from_mesh: one box per hit, duplicates kept), the octree of
those boxes' cells (Octree.from_grid, at most `octree.max_items_per_leaf`
items a leaf), and the gate-3 scene over them, build_scene(grid=tree,
aabbs=the boxes, octree=tree); frames with backend "octree" walk the
tree.  The tree's occupancy and set_calls are set-up's answers.  The
reference knows nothing of octrees: its scene is the voxel kind's, its
own voxelize at the same box and its exhaustive cell walk."""
from __future__ import annotations

from .. import inputs
from ..program import Program as _Program
from .voxel import reference_scene

__all__ = ["geometry", "Program", "reference_scene"]


def geometry(config):
    v, f = inputs.mesh_of(config)
    return inputs.Geometry(f, [v], inputs.grid_of(v, config["grid_res"]))


class Program(_Program):
    def __init__(self, config, geo, device):
        super().__init__(config, device)
        from voxelray_torch.models.grids import GridVec
        from voxelray_torch.models.octree import Octree
        from voxelray_torch.models.scene import build_scene
        v, f = geo.sets[0], geo.faces
        bb_min, bb_max, vs, dims = geo.grid
        boxes = GridVec.from_mesh(v, f, vs, bb_min=bb_min, bb_max=bb_max,
                                  device=device)
        self.lap("GridVec.from_mesh")
        tree = Octree.from_grid(
            boxes, int(config["octree"]["max_items_per_leaf"]))
        if tuple(tree.dims) != tuple(dims):
            raise ValueError(f"the tree's grid {tree.dims} is not the "
                             f"benchmark's {dims}")
        self.lap("Octree.from_grid")
        self.scene = build_scene(grid=tree, aabbs=boxes.get_aabbs(),
                                 octree=tree, voxel_material=self.material,
                                 device=device)
        self.lap("build_scene")
        self.outputs = {"occupancy": tree.occupancy(),
                        "set_calls": tree.set_calls}
