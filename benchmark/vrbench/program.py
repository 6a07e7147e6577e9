"""The system under test: voxelray_torch, driven through its public entry
points as a user drives it.

  voxel scene      GridBool.from_mesh (voxelize_mesh: K1 on the card),
                   build_scene(grid=...)
  triangle scene   build_scene(models=[the mesh as one model]) (the
                   triangle accel built on the device)
  frame            render_image, one synced call a frame

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Program", "load_kernels"]

KINDS = ("voxel", "triangle")


def load_kernels(device):
    """Build or load the program's kernel library; seconds it took (the
    nvcc build on a checkout's first run)."""
    if device.type != "cuda":
        return 0.0
    from voxelray_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load_library()
    return time.perf_counter() - t0


def _material(row):
    from voxelray_torch.io.objload import Material
    r = [float(x) for x in row]
    return Material(ambient=tuple(r[0:3]), diffuse=tuple(r[3:6]),
                    specular=tuple(r[6:9]), transmittance=tuple(r[9:12]),
                    emission=tuple(r[12:15]), shininess=r[15], ior=r[16],
                    dissolve=r[17], illum=int(r[18]), texture_id=int(r[19]))


class Program:
    """A configuration's scene, built on `device`, and its frame.

    outputs: what set-up produced that the reference judges (the voxel
    scene's occupancy and set_calls), kept until the check.
    """

    def __init__(self, config, v, f, grid, device):
        """grid: inputs.grid_of's (bb_min, bb_max, voxel size, dims) for a
        voxel scene."""
        from voxelray_torch.models.scene import Light, build_scene
        kind = config["kind"]
        if kind not in KINDS:
            raise ValueError(f"unknown scene kind {kind!r}")
        sh = config["shading"]
        material = _material(sh["material"])
        self.outputs = {}
        self.setup_s = {}
        clock = time.perf_counter()

        def lap(what):
            nonlocal clock
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            self.setup_s[what] = now - clock
            clock = now

        if kind == "voxel":
            bb_min, bb_max, vs, _ = grid
            from voxelray_torch.models.grids import GridBool
            grid_bool = GridBool.from_mesh(v, f, vs, bb_min=bb_min,
                                           bb_max=bb_max, device=device)
            lap("GridBool.from_mesh")
            self.scene = build_scene(grid=grid_bool, voxel_material=material,
                                     device=device)
            lap("build_scene")
            # the occupancy the scene holds, unpacked from its words
            self.outputs = {"occupancy": grid_bool.occupancy(),
                            "set_calls": grid_bool.set_calls}
        else:
            from voxelray_torch.io.objload import LoadedModel
            from .inputs import knot_streams
            model = LoadedModel(
                vertices=knot_streams(v, f),
                indices=np.arange(3 * len(f), dtype=np.uint32),
                materials=np.asarray(sh["material"], np.float32)[None],
                textures=[], mat_index=np.zeros(len(f), np.int32))
            lap("triangle streams")
            self.scene = build_scene(models=[model], voxel_material=material,
                                     device=device)
            lap("build_scene")
        light = sh["light"]
        self.kw = dict(
            width=config["width"], height=config["height"],
            light=Light(position=tuple(light["position"]),
                        intensity=float(light["intensity"]),
                        type=int(light["type"])),
            clear_color=tuple(sh["clear_color"]), backend=config["backend"])

    def frame(self, view_inv, proj_inv, shadows=True):
        """One frame, (H, W, 4) float32 on the device, not synced."""
        from voxelray_torch.render.pipeline import render_image
        return render_image(self.scene, view_inv, proj_inv, shadows=shadows,
                            **self.kw)

    def free(self):
        self.scene = None
