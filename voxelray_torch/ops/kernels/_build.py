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

Every kernel's C entry point has one form,
int <kernel>_launch(const <X>Args* block, void* stream): one argument
block, a struct at file scope (a launcher with C linkage must not take a
type of internal linkage) that the wrapper (ops/kernels/<file>.py)
mirrors as a ctypes structure and fills.  `entry` binds an entry point
once and checks its block's size against the source's `<file>_sizes`;
`launch` calls it on the current stream and counts it; `need` is the
wrappers' tensor check.  The host build of the kernels (tests/) binds
and fills the same blocks.
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

import torch

from ...utils import trace

__all__ = ["NVCC_FLAGS", "nvcc_commands", "find_nvcc", "load_library",
           "build_log", "check", "P", "I", "F", "fields", "entry",
           "launch", "config", "on_cuda", "need", "need_rays"]

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
    lib = ctypes.CDLL(str(lib_path))
    lib.voxelray_error_string.argtypes = [ctypes.c_int]   # check's, bound
    lib.voxelray_error_string.restype = ctypes.c_char_p   # once
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = load_library().voxelray_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({msg.decode(errors='replace')})")


# the ctypes types of an argument block's fields: pointer, int, float
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def fields(*groups):
    """A ctypes structure's _fields_ from (type, "name name ...") pairs, in
    order."""
    return [(name, t) for t, names in groups for name in names.split()]


@functools.cache
def entry(name, struct, lib=None):
    """C entry point `name` of the kernel library (or of `lib`, another
    build of one source), bound to take a pointer to `struct` and the
    stream: int name(const struct*, void*).  `struct.SIZES` names the
    source's `<file>_sizes` and the block's place in what it reports; the
    block's size is checked against it once, when the entry point is
    bound."""
    lib = lib or load_library()
    report, k = lib[struct.SIZES[0]], struct.SIZES[1]
    report.argtypes, report.restype = [ctypes.c_void_p], None
    sizes = (ctypes.c_int * 8)()
    report(sizes)
    have, want = sizes[k], ctypes.sizeof(struct)
    if have != want:
        raise RuntimeError(f"{name}: an argument block of {have} bytes in "
                           f"the library, {want} in {struct.__name__}")
    fn = lib[name]
    fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(kernel, block, device, lib=None):
    """Launch entry point `<kernel>_launch` (of `lib`, default the kernel
    library) with `block` on the current stream of `device`, a CUDA
    device with an index, and count it in `launches.<kernel>`
    (utils/trace.py)."""
    fn = entry(kernel + "_launch", type(block), lib)
    # the stream's handle as an int: torch.cuda.current_stream() builds a
    # Stream object, ~10 us of host time a call on an H100's host
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    # the launch needs `device` current; torch.cuda.device() makes it so
    # for ~4 us of host time a call on an H100 host, so only where
    # another device is current
    if torch._C._cuda_getDevice() == device.index:
        err = fn(ctypes.byref(block), stream)
    else:
        with torch.cuda.device(device):
            err = fn(ctypes.byref(block), stream)
    check(err, kernel + "_launch")
    trace.count("launches." + kernel)


@functools.cache
def config(kernel, keys, table_words, index, lib=None):
    """{key: what `<kernel>_config(table_words, out)` of `lib` (default
    the kernel library) writes into out, in the order of `keys`, and
    "lanes": the rays CUDA device `index` holds at once}, asked once for
    each set of arguments."""
    fn = (lib or load_library())[kernel + "_config"]
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(index):
        check(fn(table_words, out), kernel + "_config")
    cfg = dict(zip(keys, out))
    cfg["lanes"] = cfg["threads"] * cfg["blocks_per_sm"] * (
        torch.cuda.get_device_properties(index).multi_processor_count)
    return cfg


def on_cuda(what, device):
    """Raise unless `device` is a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {device}")


def need(what, name, x, device, dtype, shape=None):
    """x's data pointer, once x is a contiguous `dtype` tensor on `device`
    of `shape` (None: any); else ValueError naming `what` and `name`."""
    if (x.device != device or x.dtype != dtype or not x.is_contiguous()
            or (shape is not None and x.shape != tuple(shape))):
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                         f"{'tensor' if shape is None else tuple(shape)} "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.data_ptr()


def need_rays(a, what, o, d, t_min, t_max):
    """Fill block a's rays o, d (N, 3) and t_min (None: not read), t_max
    (N,), each float32 on o's device (checked by need)."""
    dev, n, f32 = o.device, o.shape[0], torch.float32
    a.o = need(what, "o", o, dev, f32, (n, 3))
    a.d = need(what, "d", d, dev, f32, (n, 3))
    if t_min is not None:
        a.t_min = need(what, "t_min", t_min, dev, f32, (n,))
    a.t_max = need(what, "t_max", t_max, dev, f32, (n,))
