"""The comparison that decides `correct`.

What is judged is what the run produced: the frames of the window that
the seed picked, at the window's size, and, in a voxel cell, the
occupancy and set_calls that set-up's voxelize produced.  The reference
(reference.py) works each of them out again from the benchmark's own
inputs, after the program's state is freed.

The numbers, each held to the limit that the cell's file (cells/<cell>.json)
gives it:

  occupancy_cells_apart  cells whose occupancy differs from the
                         reference's (voxel cells; exact)
  set_calls_apart        |set_calls - the reference's| (voxel cells; exact)
  frames_unchecked       checked frames that the window never produced
  pixels_apart_ppm       in the worst checked frame, the pixels with a
                         channel outside |a - b| <= atol + rtol * |b| of
                         the reference (the cell's pixel_rtol, pixel_atol),
                         per million pixels of the frame
  hit_pixels_apart_ppm   in the worst checked frame, the pixels that one
                         side shows as the miss colour and the other not,
                         per million pixels

A wrong hit, hit id or t, a wrong normal or a wrong shadow each moves a
pixel: the frame carries the primary and the shadow trace through the
shading.
"""
from __future__ import annotations

import time

import torch

from . import reference

__all__ = ["reference_scene", "compare_frames", "judge"]


def reference_scene(config, v, f, grid, device, dtype=torch.float64,
                    vox_dtype=torch.float32):
    """(the reference's scene, its voxelize (occ, set_calls) or None)."""
    if config["kind"] == "voxel":
        bb_min, _, vs, dims = grid
        occ, calls = reference.voxelize(v, f, bb_min, vs, dims, device,
                                        vox_dtype)
        return reference.VoxelScene(occ, bb_min, vs, dims, dtype), \
            (occ, calls)
    return reference.TriangleScene(v, f, config["reference_grid_res"],
                                   device, dtype), None


def compare_frames(img, ref, clear_color, rtol, atol):
    """(pixels apart, hit pixels apart) of a frame against the reference's."""
    ref = ref.to(torch.float64)
    img = img.to(device=ref.device, dtype=torch.float64)
    close = ((img - ref).abs() <= atol + rtol * ref.abs()).all(dim=-1)
    miss = torch.tensor([c * 0.8 for c in clear_color[:3]],
                        dtype=torch.float64, device=ref.device) ** (1 / 2.2)

    def hits(x):
        return ((x[..., :3] - miss).abs() > 1e-5).any(dim=-1)

    return int((~close).sum()), int((hits(img) != hits(ref)).sum())


def judge(config, cell, scene, vox, flight, kept, outputs, device,
          log=print):
    """({name: value} of a run's numbers, answers that failed).

    scene, vox: reference_scene's; kept: {window frame index: frame} of
    the checked frames produced; outputs: the program's set-up outputs.
    An answer is the set-up's voxelize or a checked frame."""
    limits = cell["limits"]
    numbers, failed = {}, 0
    if vox is not None:
        occ, calls = vox
        got = outputs["occupancy"].to(device=device).reshape(occ.shape) != 0
        numbers["occupancy_cells_apart"] = int((got != occ).sum())
        numbers["set_calls_apart"] = abs(int(outputs["set_calls"]) - calls)
        failed += int(numbers["occupancy_cells_apart"]
                      > limits["occupancy_cells_apart"]
                      or numbers["set_calls_apart"]
                      > limits["set_calls_apart"])
    numbers["frames_unchecked"] = sum(1 for i in flight.check
                                      if i not in kept)
    failed += numbers["frames_unchecked"]
    worst = [0, 0]
    per_million = 1e6 / (config["width"] * config["height"])
    for i in flight.check:
        if i not in kept:
            continue
        t0 = time.perf_counter()
        ref = reference.render(scene, *flight.matrices(i), config["width"],
                               config["height"], config["shading"], device)
        px, hit = compare_frames(kept[i], ref,
                                 config["shading"]["clear_color"],
                                 cell["pixel_rtol"], cell["pixel_atol"])
        log(f"check: frame {i} (camera {flight.camera(i)}): {px} pixels "
            f"apart, {hit} hit pixels apart "
            f"({time.perf_counter() - t0:.3f} s)")
        px, hit = px * per_million, hit * per_million
        failed += int(px > limits["pixels_apart_ppm"]
                      or hit > limits["hit_pixels_apart_ppm"])
        worst = [max(worst[0], px), max(worst[1], hit)]
    numbers["pixels_apart_ppm"], numbers["hit_pixels_apart_ppm"] = worst
    return numbers, failed
