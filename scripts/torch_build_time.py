#!/usr/bin/env python3
"""Wall time of the two ways to build the port's kernel library.

    python3 scripts/torch_build_time.py

Builds voxelray_torch/csrc/*.cu four times into a temporary directory,
with the flags of ops/kernels/_build.py: as one nvcc command over every
source (compile and link in one process), and as _build.load_library
does it (one nvcc per source, all started together, then a link), in
the order one, parallel, parallel, one.  Prints the four times in
seconds and the card's name and power limit.  Needs nvcc; does not
touch voxelray_torch/_build/.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from voxelray_torch.ops.kernels import _build  # noqa: E402


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    nvcc = _build.find_nvcc()
    srcs = [str(s) for s in _build.sources()]
    with tempfile.TemporaryDirectory() as tmp:
        one = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
               str(Path(tmp) / "one.so"), *srcs]
        compiles, link = _build.nvcc_commands(nvcc, Path(tmp) / "par.so")

        def serial():
            subprocess.run(one, check=True, capture_output=True)

        def parallel():
            procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
                     for c in compiles]
            if any(p.wait() for p in procs):
                raise RuntimeError("nvcc failed")
            subprocess.run(link, check=True, capture_output=True)
        # one, parallel, parallel, one: neither form goes first only
        t = [timed(fn) for fn in (serial, parallel, parallel, serial)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{len(srcs)} sources: one nvcc command {t[0]:.2f}, {t[3]:.2f} s;"
          f" one nvcc per source in parallel + link {t[1]:.2f}, {t[2]:.2f} s"
          f" [{smi}]")


if __name__ == "__main__":
    main()
