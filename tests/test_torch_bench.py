"""The port's bench (`python -m voxelray_torch.bench`) on the CPU, with
its presets and the parity gate's scene shrunk.

Its JSON line carries bench.py's keys (read from bench.py's source, not
imported: bench.py imports JAX) less voxelize_scatter_ms and
vs_baseline, plus gpu, power_limit and launches.  Every gate passes on
the plain versions; a gate made to fail prints parity_ok false and
exits 1; without a card the bench raises.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from voxelray_torch import bench

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _bench_py_keys():
    """The keys of the dict bench.py prints with json.dumps."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print" and node.args
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].func, ast.Attribute)
                and node.args[0].func.attr == "dumps"):
            return {k.value for k in node.args[0].args[0].keys}
    raise AssertionError("bench.py prints no json.dumps dict")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(bench.PRESETS, "small",
                        ((2, 3, 32, 12), 24, 128, 64))
    monkeypatch.setattr(bench, "PARITY_MESH", 1)
    monkeypatch.setattr(bench, "PARITY_VS", 2.2 / 16)
    monkeypatch.setattr(bench, "PARITY_W", 48)
    monkeypatch.setattr(bench, "PARITY_H", 27)


def test_bench_line_has_bench_py_keys_and_passes_its_gates(small):
    res = bench.run("cpu", preset="small", runs=1)
    want = _bench_py_keys()
    assert {"voxelize_scatter_ms", "vs_baseline", "value"} <= want
    want = want - {"voxelize_scatter_ms", "vs_baseline"} \
        | {"gpu", "power_limit", "launches"}
    assert set(res) == want
    json.dumps(res)
    assert res["parity_ok"] is True, res["parity"]
    p = res["parity"]
    assert p["voxelize_plain_exact"] and p["exhaustive_ok"]
    assert p["unresolved"] == 0 and p["fast_hits"] > 500
    assert res["voxelize_path"] == "k1" and res["mega"] is True
    assert res["occupied_voxels"] > 1000 and res["pipelined_frames"] == 4
    assert res["gpu"] is None and res["power_limit"] is None
    assert set(res["launches"]) == {"voxel_accum", "mega_trace",
                                    "grid_walk", "brick_fine", "tri_march",
                                    "staged_march", "camera_rays",
                                    "hit_surface", "shade_post"}
    assert not any(res["launches"].values())     # plain versions only


def test_bench_exits_1_when_a_gate_fails(small, monkeypatch, capsys):
    plain = bench.voxelize_plain

    def off_by_one_cell(*a):
        occ, calls = plain(*a)
        occ.view(-1)[0] ^= 1
        return occ, calls

    monkeypatch.setattr(bench, "voxelize_plain", off_by_one_cell)
    for k, x in (("BENCH_PRESET", "small"), ("BENCH_RUNS", "1"),
                 ("BENCH_SKIP_PARITY", "1")):
        monkeypatch.setenv(k, x)
    assert bench.main(device="cpu") == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["parity_ok"] is False
    assert res["parity"] == {"voxelize_plain_exact": False}


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
