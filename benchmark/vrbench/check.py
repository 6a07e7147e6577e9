"""The comparison that decides `correct`.

What is judged is what the run produced: the frames of the window that
the seed picked, at the window's size, and, in a voxel cell, the
occupancy and set_calls that set-up's voxelize produced or, where the
scene changes every step, that each checked frame's own voxelize
produced.  The reference (reference.py) works each of them out again from
the benchmark's own inputs, each checked frame against the reference's
scene of that frame's own geometry, after the program's state is freed.

The numbers, each held to the limit that the cell's file (cells/<cell>.json)
gives it:

  occupancy_cells_apart  cells whose occupancy differs from the
                         reference's (voxel cells; exact), in the worst
                         voxelize judged
  set_calls_apart        |set_calls - the reference's| (voxel cells;
                         exact), in the worst voxelize judged
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

__all__ = ["References", "compare_frames", "judge"]


class References:
    """The reference's scene of each step's geometry, and its voxelize
    (occ, set_calls) or None, built once a vertex set: refs(step).  `kind`
    is the configuration's scene kind (program.kind_of); dtype and
    vox_dtype the precision of the walks and of the voxelize."""

    def __init__(self, kind, config, geo, device, dtype=torch.float64,
                 vox_dtype=torch.float32):
        self.kind, self.config, self.geo = kind, config, geo
        self.device, self.dtype, self.vox_dtype = device, dtype, vox_dtype
        self.made = {}

    def __call__(self, step):
        key = self.geo.key(step)
        if key not in self.made:
            self.made[key] = self.kind.reference_scene(
                self.config, self.geo, key, self.device, self.dtype,
                self.vox_dtype)
        return self.made[key]


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


def judge(config, cell, refs, flight, kept, outputs, device, log=print):
    """({name: value} of a run's numbers, answers that failed).

    refs: References; kept: {window frame index: {"image": frame, and the
    step's answers}} of the checked frames produced; outputs: the
    program's set-up outputs.  An answer is a voxelize (set-up's, or a
    checked frame's) or a checked frame."""
    limits = cell["limits"]
    numbers, failed = {}, 0
    # each voxelize with the step whose geometry it voxelized (set-up's:
    # the scene's one set)
    voxelized = ([("set-up", outputs, 0)] if "occupancy" in outputs
                 else []) + [(f"frame {i}", kept[i], flight.step(i))
                             for i in flight.check
                             if i in kept and "occupancy" in kept[i]]
    if voxelized:
        worst = [0, 0]
        for what, got, step in voxelized:
            occ, calls = refs(step)[1]
            apart = int(((got["occupancy"].to(device=device)
                          .reshape(occ.shape) != 0) != occ).sum())
            calls_apart = abs(int(got["set_calls"]) - calls)
            if len(voxelized) > 1:
                log(f"check: {what} voxelize (step {step}): {apart} cells "
                    f"apart, set_calls {calls_apart} apart")
            failed += int(apart > limits["occupancy_cells_apart"]
                          or calls_apart > limits["set_calls_apart"])
            worst = [max(worst[0], apart), max(worst[1], calls_apart)]
        numbers["occupancy_cells_apart"], numbers["set_calls_apart"] = worst
    numbers["frames_unchecked"] = sum(1 for i in flight.check
                                      if i not in kept)
    failed += numbers["frames_unchecked"]
    worst = [0, 0]
    per_million = 1e6 / (config["width"] * config["height"])
    for i in flight.check:
        if i not in kept:
            continue
        t0 = time.perf_counter()
        ref = reference.render(refs(flight.step(i))[0], *flight.matrices(i),
                               config["width"], config["height"],
                               config["shading"], device)
        px, hit = compare_frames(kept[i]["image"], ref,
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
