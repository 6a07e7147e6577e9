"""Structured logging of the quantities the reference prints ad hoc.

The reference reports bbox / grid dims / triangle count / voxel count /
node count / build ms / bytes via std::println scattered through the build
(VoxelBuilder.hpp:343-351,417; octTree.hpp:568-569,798-808;
hello_vulkan.cpp:686-688).  Here the same facts flow through one logger
with both human-readable and machine-readable (JSON-line) output.
Copied from voxelray_tpu/utils/logging.py.
"""
from __future__ import annotations

import json
import logging
import sys
import time

__all__ = ["get_logger", "log_event", "BuildStats"]

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("voxelray")
        if not _logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s voxelray %(levelname)s %(message)s"))
            _logger.addHandler(h)
            _logger.setLevel(logging.INFO)
    return _logger


def log_event(event: str, **fields):
    """One JSON line per event on the logger."""
    rec = {"event": event, "t": time.time(), **fields}
    get_logger().info(json.dumps(rec, default=str))
    return rec


class BuildStats:
    """Accumulates the reference's build printout as structured fields."""

    def __init__(self):
        self.fields = {}

    def bbox(self, bb_min, bb_max):
        self.fields["bbox_min"] = [float(x) for x in bb_min]
        self.fields["bbox_max"] = [float(x) for x in bb_max]
        return self

    def grid(self, dims, voxel_size):
        self.fields["grid_dims"] = list(dims)
        self.fields["voxel_size"] = float(voxel_size)
        return self

    def triangles(self, n):
        self.fields["triangles"] = int(n)
        return self

    def voxels(self, n_set, set_calls=None):
        self.fields["voxels_set"] = int(n_set)
        if set_calls is not None:
            self.fields["set_calls"] = int(set_calls)
        return self

    def nodes(self, n):
        self.fields["octree_nodes"] = int(n)
        return self

    def timing(self, build_ms=None, aabb_ms=None):
        if build_ms is not None:
            self.fields["build_ms"] = float(build_ms)
        if aabb_ms is not None:
            self.fields["aabb_ms"] = float(aabb_ms)
        return self

    def memory(self, n_bytes):
        self.fields["memory_bytes"] = int(n_bytes)
        return self

    def emit(self, event="voxelize"):
        return log_event(event, **self.fields)
