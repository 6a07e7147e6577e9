"""The work of a trace, counted from the benchmark's own inputs and
reference: the yardstick of `trace_roofline_pct`.

A trace kernel has to read each ray it traces, its origin and direction
(six float32, 24 bytes), and write its answer once (the hit t as float32
and the hit id as int32, 8 bytes).  The rays of a frame are its W x H
primary rays and the shadow rays of the pixels that hit something facing
the light, as the reference (reference.py) admits them for that frame's
camera.  The count comes from the inputs and the reference and never
from the program, so it is the same work whatever implements the trace.

It is a lower bound on the bytes any trace moves: it leaves out the
scene (the grid's bricks and words, or the triangles and their cell
rows), which every ray also reads, and counts each ray once however
often a kernel re-reads it.  A share of the bandwidth peak computed from
it therefore never passes 100% unless the kernel time leaves out part of
the work.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["RAY_BYTES", "trace_rays", "trace_bytes", "peak"]

RAY_BYTES = 24 + 8
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def trace_rays(width, height, admitted):
    """Rays traced over frames of width x height with `admitted` shadow
    rays each (a list, one count a frame)."""
    return len(admitted) * width * height + sum(admitted)


def trace_bytes(width, height, admitted):
    return RAY_BYTES * trace_rays(width, height, admitted)


def peak(name):
    """A peak of the table (peaks.json): value and unit."""
    table = json.loads(PEAKS.read_text())
    return table[name]["value"]
