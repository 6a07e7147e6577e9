"""The system under test: voxelray_torch, driven through its public entry
points as a user drives it.

A configuration's `kind` names the module that builds its scene
(vrbench/kinds/<kind>.py, a `-` in the name read as `_`); each holds a
subclass of Program below, its geometry (inputs.Geometry) and the
reference's scene of a step.  The frame is the same for every kind:
render_image, one synced call a frame.  This module and the kinds'
Programs are the only code of the benchmark that imports the program.
"""
from __future__ import annotations

import importlib
import time
from contextlib import contextmanager

import torch

__all__ = ["Program", "load_kernels", "kind_of"]


def kind_of(config):
    """The module of the configuration's scene kind."""
    name = config["kind"]
    try:
        return importlib.import_module(
            f"{__package__}.kinds.{name.replace('-', '_')}")
    except ModuleNotFoundError as e:
        raise ValueError(f"unknown scene kind {name!r}") from e


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
    """The configuration's material row as the program's Material."""
    from voxelray_torch.io.objload import Material
    r = [float(x) for x in row]
    return Material(ambient=tuple(r[0:3]), diffuse=tuple(r[3:6]),
                    specular=tuple(r[6:9]), transmittance=tuple(r[9:12]),
                    emission=tuple(r[12:15]), shininess=r[15], ior=r[16],
                    dissolve=r[17], illum=int(r[18]), texture_id=int(r[19]))


class Program:
    """A configuration's scene on `device`, and its frame.

    A kind's subclass builds `scene` in its constructor or, where the
    geometry changes (`changes`), in `step`.

    outputs: what set-up produced that the reference judges (a static
      voxel scene's occupancy and set_calls), kept until the check.
    answers: what the last step produced that the reference judges (a
      changing voxel scene's occupancy and set_calls); the harness copies
      them for each checked frame as it copies the image.
    setup_s: seconds of each set-up stage; call_s: host seconds of each
      call into the program that `call` spans, added up.
    """

    changes = False

    def __init__(self, config, device):
        from voxelray_torch.models.scene import Light
        sh = config["shading"]
        self.device = device
        self.material = _material(sh["material"])
        self.scene = None
        self.outputs, self.answers = {}, {}
        self.setup_s, self.call_s = {}, {}
        self._clock = time.perf_counter()
        light = sh["light"]
        self.kw = dict(
            width=config["width"], height=config["height"],
            light=Light(position=tuple(light["position"]),
                        intensity=float(light["intensity"]),
                        type=int(light["type"])),
            clear_color=tuple(sh["clear_color"]), backend=config["backend"])

    def lap(self, what):
        """Close the set-up stage `what` (synced)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.setup_s[what] = now - self._clock
        self._clock = now

    @contextmanager
    def call(self, name):
        """A call into one of the program's layers: a span of the
        benchmark's own on the profiler's host timeline (`vrbench.<name>`,
        which profile.Trace keeps off the device's operations), its host
        seconds added to call_s[name]."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function(f"vrbench.{name}"):
            yield
        self.call_s[name] = self.call_s.get(name, 0.0) \
            + time.perf_counter() - t0

    def step(self, step):
        """Make the scene that global step `step` shows (nothing where the
        geometry never changes)."""

    def frame(self, view_inv, proj_inv, shadows=True):
        """One frame of the current scene, (H, W, 4) float32 on the
        device, not synced."""
        from voxelray_torch.render.pipeline import render_image
        return render_image(self.scene, view_inv, proj_inv, shadows=shadows,
                            **self.kw)

    def frame_of(self, flight, i, shadows=True):
        """The window's frame i of `flight`: its step's scene, then the
        frame from its camera."""
        self.step(flight.step(i))
        return self.frame(*flight.matrices(i), shadows=shadows)

    def free(self):
        self.scene = None
        self.answers = {}
