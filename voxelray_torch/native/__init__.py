"""ctypes bindings for the native host runtime (voxelnative.cpp).

Counterpart of voxelray_tpu/native/__init__.py.  The library is built
from this package's copy of the source with g++ at first use:

    g++ -O3 -std=c++17 -fPIC -ffp-contract=off -Wall -Wextra -shared
        -o voxelray_torch/_build/native-<hash>/libvoxelnative.so
        voxelray_torch/native/voxelnative.cpp

keyed by a hash of the source and the flags, built under a temporary
name and moved into place.  -ffp-contract=off and no -ffast-math keep
IEEE float32 semantics, which the voxelizer's bit-exactness needs.  A
machine without g++, or a failed build, raises: there is no Python
fallback behind these entry points.

  parse_obj_native(path)          fast OBJ positions+faces parse
  voxelize_native(...)            serial oracle voxelizer at native speed
  morton_encode_native(x, y, z)   63-bit Morton codes (numpy uint64)
  sort_codes_native(codes)        sorted copy of uint64 codes
  build_octree_nodes_native(...)  pre-order flat node array
  available()                     whether the library builds and loads
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["available", "load_library", "parse_obj_native", "voxelize_native",
           "morton_encode_native", "sort_codes_native",
           "build_octree_nodes_native"]

SOURCE = Path(__file__).resolve().parent / "voxelnative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libvoxelnative.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-Wall",
             "-Wextra", "-shared")


def _key() -> str:
    h = hashlib.sha256()
    for flag in CXX_FLAGS:
        h.update(flag.encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    out_dir = BUILD_DIR / f"native-{_key()}"
    lib_path = out_dir / LIB_NAME
    if not lib_path.is_file():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found: the native library cannot "
                               "be built on this machine")
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = Path(tmp) / LIB_NAME
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_lib),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (rc={proc.returncode}):\n"
                                   f"{(proc.stdout + proc.stderr)[-8000:]}")
            os.replace(tmp_lib, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    c_long, c_void = ctypes.c_long, ctypes.c_void_p
    lib.parse_obj.restype = ctypes.c_int
    lib.parse_obj.argtypes = [ctypes.c_char_p, c_long,
                              c_void, ctypes.POINTER(c_long),
                              c_void, ctypes.POINTER(c_long)]
    lib.voxelize.restype = c_long
    lib.voxelize.argtypes = [c_void, c_long, c_void, c_long,
                             ctypes.c_float, c_void,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             c_void]
    lib.morton_encode.restype = None
    lib.morton_encode.argtypes = [c_void] * 3 + [c_long, c_void]
    lib.sort_u64.restype = None
    lib.sort_u64.argtypes = [c_void, c_long]
    lib.build_octree_nodes.restype = c_long
    lib.build_octree_nodes.argtypes = [c_void, c_long, ctypes.c_int,
                                       c_long, c_void, c_long]
    return lib


def available() -> bool:
    """True if the g++ build of voxelnative.cpp loads on this machine.
    The entry points below raise where it does not; nothing falls back."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_obj_native(path: str):
    """(vertices (V, 3) float32, faces (F, 3) int32): positions and
    fan-triangulated faces, negative indices resolved."""
    lib = load_library()
    with open(path, "rb") as fh:
        text = fh.read()
    nv = ctypes.c_long(0)
    nf = ctypes.c_long(0)
    lib.parse_obj(text, len(text), None, ctypes.byref(nv), None,
                  ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.parse_obj(text, len(text), _ptr(verts), ctypes.byref(nv),
                  _ptr(faces), ctypes.byref(nf))
    return verts, faces


def voxelize_native(vertices, faces, voxel_size, bb_min, dims):
    """(occ (Z, Y, X) uint8, set_calls): the serial reference voxelizer
    over the grid at bb_min with dims (X, Y, Z)."""
    v = np.ascontiguousarray(vertices, np.float32).reshape(-1, 3)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("faces index a vertex out of range")
    bb = np.ascontiguousarray(bb_min, np.float32)
    nx, ny, nz = (int(x) for x in dims)
    occ = np.zeros((nz, ny, nx), np.uint8)
    calls = load_library().voxelize(_ptr(v), len(v), _ptr(f), len(f),
                                    ctypes.c_float(voxel_size), _ptr(bb),
                                    nx, ny, nz, _ptr(occ))
    return occ, int(calls)


def morton_encode_native(x, y, z):
    """63-bit Morton codes (numpy uint64) of 21-bit cell coordinates."""
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    if not len(x) == len(y) == len(z):
        raise ValueError("x, y and z differ in length")
    out = np.empty(len(x), np.uint64)
    load_library().morton_encode(_ptr(x), _ptr(y), _ptr(z), len(x),
                                 _ptr(out))
    return out


def sort_codes_native(codes):
    """A sorted copy of the uint64 codes."""
    c = np.ascontiguousarray(codes, np.uint64).copy()
    load_library().sort_u64(_ptr(c), len(c))
    return c


def build_octree_nodes_native(codes_sorted, max_depth, max_items):
    """(M, 10) int64 node rows (children[8], start, count) in pre-order."""
    c = np.ascontiguousarray(codes_sorted, np.uint64)
    cap = max(1, 2 * len(c) + 8)
    nodes = np.empty((cap, 10), np.int64)
    n = load_library().build_octree_nodes(_ptr(c), len(c), int(max_depth),
                                          int(max_items), _ptr(nodes), cap)
    if n < 0:
        raise RuntimeError(f"octree node build overflowed {cap} rows")
    return nodes[:n].copy()
