"""Command-line entry point — the main.cpp replacement.

Counterpart of voxelray_tpu/cli.py.  Reference usage: `exe <obj-path>
<voxelSize>` (README.md:57, main.cpp:163): loads the ground plane,
voxelizes argv[1] at argv[2], renders interactively.  Here the
interactive loop becomes an offline frame batch:

  python -m voxelray_torch.cli scene.obj 0.05
  python -m voxelray_torch.cli bunny 0.02 --encoding octree --frames 8 \\
      --width 1920 --height 1080 --out frames.npy

Mesh argument is a .obj path or a procedural registry name
(cube/plane/bunny/sphere/knot/knot1m).  Prints the same build stats the
reference prints (bbox, dims, triangle count, build/extract ms, bytes).
Everything runs on the CUDA card unless --device names another device
(--device cpu runs the plain PyTorch versions); without a card and
without --device the run stops with an error.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(
        prog="voxelray", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mesh", nargs="?", default=None,
                   help=".obj path or registry name (optional with "
                        "--load-grid)")
    p.add_argument("voxel_size", nargs="?", type=float, default=None)
    p.add_argument("--encoding", default="bool",
                   choices=["bool", "aabbstruct", "vec", "octree"])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=1,
                   help=">1 renders an orbit fly-through batch")
    p.add_argument("--mode", default="ray", choices=["ray", "raster"])
    p.add_argument("--backend", default="fast",
                   choices=["fast", "dda", "brute", "octree"])
    p.add_argument("--no-shadows", action="store_true",
                   help="disable shadow rays")
    p.add_argument("--aov", action="store_true",
                   help="output depth+normal buffers instead of color")
    p.add_argument("--no-plane", action="store_true",
                   help="skip the ground-plane model (main.cpp:160)")
    p.add_argument("--light", type=float, nargs=3, default=[10.0, 55.0, 8.0])
    p.add_argument("--light-intensity", type=float, default=1000.0)
    p.add_argument("--light-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--clear-color", type=float, nargs=4,
                   default=[1.0, 1.0, 1.0, 1.0])
    p.add_argument("--out", default=None,
                   help="write frames as .npy, or .png (numbered "
                        "<stem>_NNNN.png for several frames)")
    p.add_argument("--save-grid", default=None, help="checkpoint grid .npz")
    p.add_argument("--load-grid", default=None,
                   help="resume from a grid checkpoint .npz (skips "
                        "voxelization; encoding comes from the file)")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   help="camera eye (default: auto-framed orbit start)")
    p.add_argument("--center", type=float, nargs=3, default=None,
                   help="camera look-at center")
    p.add_argument("--runs", type=int, default=1,
                   help="Benchmaker-style repeat count for build timing")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--trace-out", default=None,
                   help="record the run's spans and counters and write "
                        "them here as Chrome-trace JSON (Perfetto)")
    return p


def load_mesh_arg(name):
    from .io import meshes
    from .io.objload import load_mesh
    from .native import parse_obj_native

    if name.endswith(".obj"):
        # native parser for large scans (geometry only: the voxelize path
        # ignores materials, matching VoxelBuilder.hpp:376-395); an OBJ it
        # finds no faces in goes through the full loader, which raises on
        # malformed input
        parsed = parse_obj_native(name)
        if len(parsed[0]):
            return parsed
        raw = load_mesh(name)
        return raw.vertices, raw.faces
    return meshes.make_scene_mesh(name)


def _ground_plane():
    """The reference's ground-plane model (main.cpp:160), loaded from an
    OBJ the way the app loads it."""
    from .io import meshes
    from .io.objload import ObjLoader, write_obj

    pv, pf = meshes.plane(20.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plane.obj")
        write_obj(path, pv, pf)
        return ObjLoader().load_model(path)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.load_grid and (args.mesh is None
                               or args.voxel_size is None):
        parser.error("mesh and voxelSize are required unless --load-grid "
                     "is given")

    from .models.grids import build_grid
    from .models.scene import Light, build_scene
    from .ops.geometry import mesh_bbox
    from .render.camera import Camera, orbit_path
    from .render.pipeline import render_aov, render_scene
    from .render.raster import rasterize_scene
    from .utils.device import resolve_device
    from .utils.logging import BuildStats
    from .utils import trace
    from .utils.timing import Benchmarker

    device = resolve_device(args.device)
    if args.trace_out:
        trace.enable()
    if args.load_grid:
        # checkpoint/resume: render runs skip re-voxelization entirely
        from .utils.checkpoint import load_grid
        grid = load_grid(args.load_grid, device=device)
        enc_map = {"GridBool": "bool", "GridAabbStruct": "aabbstruct",
                   "GridVec": "vec", "Octree": "octree"}
        args.encoding = enc_map.get(type(grid).__name__, args.encoding)
        print(f"Loaded grid checkpoint {args.load_grid} "
              f"({args.encoding}, dims {grid.dims})")
    else:
        v, f = load_mesh_arg(args.mesh)
        print(f"Loaded mesh: {len(v)} vertices, {len(f)} triangles")

        # ---- voxelize (with the reference's timing prints) ------------
        bench = Benchmarker(runs=args.runs, warmup=0)
        res = bench.measure_build(
            lambda: build_grid(args.encoding, v, f, args.voxel_size,
                               device=device),
            extract_fn=lambda g: g.get_aabbs(),
        )
        grid = res.extra["grid"]
        bb_min, bb_max = mesh_bbox(v)
        print(f"Bounding box: min({bb_min[0]},{bb_min[1]},{bb_min[2]})")
        print(f"Bounding box: max({bb_max[0]},{bb_max[1]},{bb_max[2]})")
        dims = grid.dims
        print(f"Grid dimensions: {dims[0]}x{dims[1]}x{dims[2]}")
        print(f"Voxel size: {args.voxel_size}")
        print(f"Total triangles processed: {len(f)}")
        print(f"Voxel build took {res.build_ms:.2f} ms (avg of "
              f"{args.runs})")
        print(f"Aabb build took {res.aabb_ms:.2f} ms")
        print(f"Total memory usage {res.memory_bytes} bytes")
        BuildStats().bbox(bb_min, bb_max).grid(dims, args.voxel_size) \
            .triangles(len(f)).timing(res.build_ms, res.aabb_ms) \
            .memory(res.memory_bytes).emit()

        if args.save_grid:
            from .utils.checkpoint import save_grid
            save_grid(args.save_grid, grid)
            print(f"Saved grid checkpoint to {args.save_grid}")

    # ---- scene --------------------------------------------------------
    models = [] if args.no_plane else [_ground_plane()]
    aabbs = None
    occ_grid = grid
    if args.encoding in ("vec", "octree"):
        aabbs = grid.get_aabbs()
        occ_grid = {
            "occ": grid.occupancy(), "dims": grid.dims,
            "origin": (grid.root_min if args.encoding == "octree"
                       else grid.origin),
            "voxel_size": grid.voxel_size,
        }
    scene = build_scene(models=models, grid=occ_grid, aabbs=aabbs,
                        octree=grid if args.encoding == "octree" else None,
                        device=device)

    light = Light(position=tuple(args.light),
                  intensity=args.light_intensity, type=args.light_type)

    # camera: explicit --eye/--center (the reference's
    # CameraManip.setLookat, main.cpp:92), else the default pose /
    # auto orbit fly-through
    cam_kw = {}
    if args.eye is not None:
        cam_kw["eye"] = tuple(args.eye)
    if args.center is not None:
        cam_kw["center"] = tuple(args.center)
    if args.frames > 1:
        cams = orbit_path(args.frames,
                          center=cam_kw.get("center", (0.0, 1.0, 0.0)))
    else:
        cams = [Camera(**cam_kw)]
    frames = []
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        if args.mode == "raster":
            img = rasterize_scene(scene, cam, width=args.width,
                                  height=args.height, light=light,
                                  clear_color=tuple(args.clear_color))
        elif args.aov:
            depth, normal, _ = render_aov(scene, cam, width=args.width,
                                          height=args.height,
                                          backend=args.backend)
            img = torch.cat([depth[..., None], normal], dim=-1)
        else:
            img = render_scene(scene, cam, width=args.width,
                               height=args.height, light=light,
                               clear_color=tuple(args.clear_color),
                               backend=args.backend,
                               shadows=not args.no_shadows)
        img = img.cpu().numpy()
        dt = time.perf_counter() - t0
        mrays = args.width * args.height / dt / 1e6
        print(f"frame {i}: {dt*1e3:.1f} ms ({mrays:.1f} Mrays/s)")
        frames.append(img)

    if args.out:
        if args.out.endswith(".png"):
            from .io.textures import write_png
            if len(frames) > 1:
                # a numbered sequence <stem>_0000.png ...: one png cannot
                # hold the batch
                stem = args.out[: -len(".png")]
                for i, frame in enumerate(frames):
                    write_png(f"{stem}_{i:04d}.png", frame)
                print(f"Wrote {len(frames)} frames to {stem}_NNNN.png")
            else:
                write_png(args.out, frames[0])
                print(f"Wrote {args.out}")
        else:
            np.save(args.out, np.stack(frames) if len(frames) > 1
                    else frames[0])
            print(f"Wrote {args.out}")
    if args.trace_out:
        trace.disable()
        trace.dump(args.trace_out)
        print(f"Wrote {len(trace.records())} spans to {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
