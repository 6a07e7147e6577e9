"""The tri-deform cell at the tiny size: a sound run is correct, its
faults are not, its per-layer readers read what they should, and its run
loads no JAX."""
import dataclasses
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO
from vrbench import harness, profile, tri_work, work

CELL = "tri-deform"
CPU = torch.device("cpu")


def _run(spec, trace=False, seed=2 ** 31 + 4242):
    from test_benchmark_harness import _run as run
    return run(spec, trace, seed)


def test_sound_run_is_correct(tiny):
    spec = harness.load_spec(CELL, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert correct, checks
    assert checks["pixels_apart_ppm"]["value"] == 0
    assert checks["hit_pixels_apart_ppm"]["value"] == 0
    assert checks["frames_unchecked"]["value"] == 0 and run.failed == 0
    assert "occupancy_cells_apart" not in checks
    geo = run.geometry
    assert len(geo.sets) == 4 and geo.grid is None


def _step_fault(fault):
    """A step of the deforming triangle scene broken underneath."""
    from vrbench.kinds import triangle_deform
    real = triangle_deform.Program.step

    def step(self, step):
        if fault == "scene_frozen":
            # every step builds the first vertex set's scene
            real(self, step - self.key(step))
        else:
            real(self, step)
            if not hasattr(self, "_first"):
                self._first = self._build(self.plan, self.sets[0])
            f = self._first
            self.scene = dataclasses.replace(
                self.scene, tri_n0=f.tri_n0, tri_n1=f.tri_n1,
                tri_n2=f.tri_n2)
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "scene_frozen",
                                   "normals_of_the_first_set"])
def test_faults_are_not_correct(tiny, monkeypatch, fault):
    """The frame returned unchanged from the first, half of its rows left
    out, the triangle trace's t altered where it is produced, every step
    the first set's scene, the first set's normals on every step's
    triangles: each comes out not correct."""
    from test_benchmark_harness import _altered, _half, _stale
    from vrbench.kinds import triangle_deform
    from vrbench.program import Program
    if fault == "state_unchanged":
        monkeypatch.setattr(Program, "frame", _stale(Program.frame))
    elif fault == "half_left_out":
        monkeypatch.setattr(Program, "frame", _half(Program.frame))
    elif fault == "answer_altered":
        _altered(monkeypatch)
    else:
        monkeypatch.setattr(triangle_deform.Program, "step",
                            _step_fault(fault))
    spec = harness.load_spec(CELL, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert run.failed > 0
    assert checks["pixels_apart_ppm"]["value"] \
        > checks["pixels_apart_ppm"]["limit"]


def test_control_in_the_programs_place_is_not_correct(tiny, monkeypatch):
    """The control, the reference with its rays and walks in bfloat16, in
    the program's place: not correct."""
    from control import Control
    from vrbench.program import kind_of
    spec = harness.load_spec(CELL, tiny)
    kind = kind_of(spec.config)
    monkeypatch.setattr(kind, "Program", lambda config, geo, device:
                        Control(kind, config, geo, device, True))
    run = harness.run_cell(spec, 11, 1.0, False, CPU, time.time())
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert checks["pixels_apart_ppm"]["value"] \
        > checks["pixels_apart_ppm"]["limit"]


def test_traced_run_reads_the_row_fill(tiny):
    """A traced run checks its frames and reads tri_row_fill_pct from the
    program's counters (pairs over row slots), and glue_host_ms and
    kernel_call_host_ms from the spans inside render_image (the rebuild
    before each frame outside them); on the CPU no device metric
    reports."""
    spec = harness.load_spec(CELL, tiny)
    run = _run(spec, trace=True)
    correct, checks = harness.verdict(run)
    assert correct, checks
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    assert 0 < got["tri_row_fill_pct"] < 100
    assert got["scene_build_host_ms"] > 0
    assert got["glue_host_ms"] > 0 and got["kernel_call_host_ms"] > 0
    for name in ("tri_bin_kernel_ms", "tri_bin_roofline_pct",
                 "trace_kernel_ms", "scene_build_ms"):
        assert name not in got


def test_bin_work_count_reads_no_program(tiny, monkeypatch):
    """tri_bin_kernel_ms from the binning kernels' names, and
    tri_bin_roofline_pct against a hand count in numpy of each traced
    frame's windows and hits over the tri grid, with the program made
    unimportable."""
    from test_benchmark_harness import _FakeEvent, _FakeProf
    from vrbench import reference
    from vrbench.program import kind_of
    spec = harness.load_spec(CELL, tiny)
    geo = kind_of(spec.config).geometry(spec.config)
    monkeypatch.setitem(sys.modules, "voxelray_torch", None)
    ev = [_FakeEvent(profile.WINDOW_SPAN, 0, 1000, False),
          _FakeEvent("tri_bin_count_kernel(BinArgs)", 100, 130, True),
          _FakeEvent("tri_bin_emit_kernel(BinArgs)", 130, 150, True),
          _FakeEvent("tri_march_kernel(MarchArgs)", 150, 400, True)]
    steps = [1, 2, 6]
    run = harness.Run(spec=spec, trace=profile.Trace(_FakeProf(ev)),
                      traced_frames=3, steps=steps, geometry=geo)
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    assert got["tri_bin_kernel_ms"] == pytest.approx(50e-3 / 3)
    origin, vs, dims = tri_work.tri_grid(geo)
    assert tri_work.tri_res(len(geo.faces)) == 23
    lo, hi = geo.bbox
    assert (origin < lo).all() \
        and (origin + np.float32(vs) * np.asarray(dims) > hi).all()
    bound = 0.0
    for step in steps:
        v = geo.sets[geo.key(step)]
        tri = v[geo.faces]
        a = ((tri.min(axis=1) - origin) / np.float32(vs)).astype(np.int64)
        b = ((tri.max(axis=1) - origin) / np.float32(vs)).astype(np.int64)
        w = np.clip(np.minimum(b + 2, dims) - np.maximum(a, 0), 0, None)
        tests = int(w.prod(axis=1).sum())
        pairs = reference.voxelize(v, geo.faces, origin, vs, dims, CPU)[1]
        assert len(geo.faces) < pairs < tests
        nbytes = 12 * len(v) + 12 * len(geo.faces) + 8 * pairs \
            + 4 * dims[0] * dims[1] * dims[2]
        bound += max(nbytes / 3.35e12, tests * work.SAT_OPS / 67e12)
    assert got["tri_bin_roofline_pct"] == pytest.approx(
        100 * bound / 50e-6, rel=1e-9)


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
        assert harness.verdict(r)[0] and "tri_row_fill_pct" in got
        print("FORBIDDEN", entry.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
