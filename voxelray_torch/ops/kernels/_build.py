"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

One shared library with a plain C interface, bound with ctypes (no
PyTorch headers, so a build takes seconds).  Every source compiles in
its own nvcc process, all started together, then one nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas=-v -Xcompiler -fPIC -I csrc -c -o <name>.o csrc/<name>.cu
                                                                   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
         libvoxelray_kernels.so *.o

--fmad=false keeps every `a*b+c` as a separate multiply and add, so the
kernels evaluate the same float32 expressions as their plain PyTorch
versions (whose elementwise ops never contract); no --use_fast_math, so
IEEE division, no flush-to-zero and precise sqrt stay on.

The library lands in voxelray_torch/_build/<hash>/, keyed by a hash of
the sources, the headers they share (csrc/*.cuh) and the flags.  It is
built under a temporary name and moved into place with os.replace, so two
processes never load a half-written file.
Nothing is downloaded; a machine without nvcc gets a RuntimeError.
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

from ...utils import trace

__all__ = ["NVCC_FLAGS", "nvcc_commands", "find_nvcc", "load_library",
           "build_log"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libvoxelray_kernels.so"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_commands(nvcc: str, out: str | os.PathLike):
    """(compile commands, one per source, and the link command) that build
    the library into `out`; objects go beside it."""
    out = Path(out)
    objs = [out.parent / (src.stem + ".o") for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                 str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, *ARCH, "-shared", "-o", str(out), *map(str, objs)]
    return compiles, link


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "on this machine")


def _key() -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) of the last build
    of the current sources, or '' if it was not built by this checkout."""
    log = BUILD_DIR / _key() / "nvcc.log"
    return log.read_text() if log.is_file() else ""


@functools.cache
@trace.spanned("load_library")
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    out_dir = BUILD_DIR / _key()
    lib_path = out_dir / LIB_NAME
    if not lib_path.is_file():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = Path(tmp) / LIB_NAME
            compiles, link = nvcc_commands(nvcc, tmp_lib)
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in compiles]
            logs = [proc.communicate()[0] for proc in procs]
            log = "".join(logs)
            bad = [p.returncode for p in procs if p.returncode != 0]
            if not bad:
                proc = subprocess.run(link, capture_output=True, text=True)
                log += proc.stdout + proc.stderr
                bad = [proc.returncode] if proc.returncode != 0 else []
            if bad:
                raise RuntimeError(f"nvcc failed (rc={bad[0]}):\n"
                                   f"{log[-8000:]}")
            (Path(tmp) / "nvcc.log").write_text(log)
            os.replace(Path(tmp) / "nvcc.log", out_dir / "nvcc.log")
            os.replace(tmp_lib, lib_path)
    return ctypes.CDLL(str(lib_path))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        fn = load_library().voxelray_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({fn(err).decode(errors='replace')})")
