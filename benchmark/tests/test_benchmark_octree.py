"""The octree-flythrough cell at the tiny size: a sound run is correct,
its faults are not, the control is not, a traced run reads the walk's
regions a ray, and its run loads no JAX; and a sound run of
vox512-closeup is correct."""
import dataclasses
import functools
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from conftest import BENCH, REPO
from vrbench import harness

CELL = "octree-flythrough"
CPU = torch.device("cpu")


def _run(spec, trace=False, seed=2 ** 31 + 4243):
    from test_benchmark_harness import _run as run
    return run(spec, trace, seed)


@pytest.mark.parametrize("cell", [CELL, "vox512-closeup"])
def test_sound_run_is_correct(tiny, cell):
    """The octree cell, and the voxel scene under the close-up orbit:
    every checked frame equal to the reference's, the voxelize exact."""
    spec = harness.load_spec(cell, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert correct, checks
    assert checks["pixels_apart_ppm"]["value"] == 0
    assert checks["hit_pixels_apart_ppm"]["value"] == 0
    assert checks["occupancy_cells_apart"]["value"] == 0
    assert checks["set_calls_apart"]["value"] == 0
    assert checks["frames_unchecked"]["value"] == 0 and run.failed == 0


def _items_dropped(real):
    """The program's set-up with the last item of every leaf of its tree
    dropped (each leaf's count one less)."""
    def init(self, config, geo, device):
        real(self, config, geo, device)
        tree = self.scene.octree
        leaf = (tree.children < 0).all(dim=1)
        count = torch.where(leaf & (tree.node_count > 0),
                            tree.node_count - 1, tree.node_count)
        self.scene = dataclasses.replace(
            self.scene, octree=dataclasses.replace(tree, node_count=count))
    return init


@pytest.mark.parametrize("fault", ["leaf_item_dropped", "max_outer_1",
                                   "shadow_pass_skipped"])
def test_faults_are_not_correct(tiny, monkeypatch, fault):
    """A leaf's item dropped (the last of every leaf), the walk cut after
    one region, the shadow pass skipped (no shadow ray occluded): each
    comes out not correct."""
    from voxelray_torch.ops import octree_traverse
    from voxelray_torch.render import pipeline
    from vrbench.kinds import octree
    if fault == "leaf_item_dropped":
        monkeypatch.setattr(octree.Program, "__init__",
                            _items_dropped(octree.Program.__init__))
    elif fault == "max_outer_1":
        for name in ("trace_octree", "any_hit_octree"):
            monkeypatch.setattr(pipeline, name, functools.partial(
                getattr(octree_traverse, name), max_outer=1))
    else:
        monkeypatch.setattr(
            pipeline, "any_hit_octree",
            lambda o, *a, **k: torch.zeros(o.shape[:-1], dtype=torch.bool))
    spec = harness.load_spec(CELL, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert run.failed > 0
    assert checks["pixels_apart_ppm"]["value"] \
        > checks["pixels_apart_ppm"]["limit"]
    assert checks["occupancy_cells_apart"]["value"] == 0


def test_control_in_the_programs_place_is_not_correct(tiny, monkeypatch):
    """The control, the reference with its voxelize, rays and walks in
    bfloat16, in the program's place: not correct."""
    from control import Control
    from vrbench.program import kind_of
    spec = harness.load_spec(CELL, tiny)
    kind = kind_of(spec.config)
    monkeypatch.setattr(kind, "Program", lambda config, geo, device:
                        Control(kind, config, geo, device, False))
    run = harness.run_cell(spec, 11, 1.0, False, CPU, time.time())
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert checks["pixels_apart_ppm"]["value"] \
        > checks["pixels_apart_ppm"]["limit"]


def test_traced_run_reads_the_regions_a_ray(tiny):
    """A traced run checks its frames and reads octree_regions_per_ray
    from the program's counters (region steps over the rays walked, at
    least one a ray), shadow_useful_pct from the octree shadow route's
    counters, and kernel_call_host_ms from the octree_walk spans; on the
    CPU no device metric reports."""
    spec = harness.load_spec(CELL, tiny)
    run = _run(spec, trace=True)
    correct, checks = harness.verdict(run)
    assert correct, checks
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    assert 1.0 <= got["octree_regions_per_ray"] < 100
    assert 0 < got["shadow_useful_pct"] < 100
    assert got["glue_host_ms"] > 0 and got["kernel_call_host_ms"] > 0
    for name in ("trace_kernel_ms", "trace_roofline_pct",
                 "frame_kernels_ms"):
        assert name not in got


def test_traced_run_loads_no_jax(tiny):
    """A traced run of the cell, in a process of its own, its per-layer
    metrics read, loads no module whose top-level name is jax, jaxlib,
    flax or voxelray_tpu."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]
        import torch
        from vrbench import harness
        import run as entry
        spec = harness.load_spec({CELL!r}, {str(tiny)!r})
        r = harness.run_cell(spec, 7, 0.05, True, torch.device("cpu"),
                             time.time())
        got = harness.read_metrics(r, spec.per_layer)
        assert harness.verdict(r)[0] and "octree_regions_per_ray" in got
        print("FORBIDDEN", entry.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
