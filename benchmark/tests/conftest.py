"""Tests of the benchmark's harness and reference, on the CPU.

    python -m pytest benchmark/tests -q

They import the harness (benchmark/vrbench) and, where a test compares the
reference with the program's plain CPU path, voxelray_torch; never JAX.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

# the cells at a size a test can hold: a knot of 1,024 triangles, a grid of
# 24 cells, 64 x 32 frames, two cameras a revolution, both checked and
# traced twice over; a deforming knot over four vertex sets
TINY_MESH = {"segments": 32, "tube_segments": 16}
TINY = {"width": 64, "height": 32}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


def shrink(root):
    """Cut the copy of the benchmark under `root` to the tiny size."""
    for cfg in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        c["mesh"].update(TINY_MESH)
        c.update(TINY)
        if "grid_res" in c:
            c["grid_res"] = 24
        if "reference_grid_res" in c:
            c["reference_grid_res"] = 24
        if "deform" in c:
            # four vertex sets a quarter cycle apart: each step's grid
            # differs from the last at this size
            c["deform"]["sets"] = 4
        cfg.write_text(json.dumps(c))
    for tr in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(tr.read_text())
        t.update(cameras=2, check_frames=2, trace_frames=2, trace_rounds=2,
                 host_trace_frames=1,
                 sync_frames=1)
        tr.write_text(json.dumps(t))


@pytest.fixture
def tiny(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ at the tiny size; returns
    the copy's benchmark directory."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path / "benchmark"
