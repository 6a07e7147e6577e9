"""The harness: found by name, metrics as defined, the trace's arithmetic,
the runs' faults caught, no JAX loaded."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO
from vrbench import harness, profile, work

CPU = torch.device("cpu")


class _Clock:
    """The harness's clock, advancing one second a reading, so that a
    window of 5 s is three frames on any machine."""

    def __init__(self):
        import time
        self.now, self.time = 0.0, time.time

    def perf_counter(self):
        self.now += 1.0
        return self.now

    def thread_time(self):
        return self.now


def _run(spec, trace=False, seed=2 ** 31 + 12345):
    import time
    clock = _Clock()
    real = harness.time
    harness.time = clock
    try:
        return harness.run_cell(spec, seed, 5.0, trace, torch.device("cpu"),
                                time.time())
    finally:
        harness.time = real


def test_additions_are_found_by_name(tiny):
    """A configuration, a traffic mix, a cell and a metric dropped in as
    files of their own, with their BENCHMARK.json entries, and no file of
    the harness edited."""
    root = tiny.parent
    bj = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny / "configs" / "knot1m-vox512.json").read_text())
    cfg["name"] = "knot-small"
    cfg["grid_res"] = 16
    (tiny / "configs" / "knot-small.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny / "traffic" / "flythrough.json").read_text())
    tr["cameras"] = 3
    (tiny / "traffic" / "slow-orbit.json").write_text(json.dumps(tr))
    cell = json.loads((tiny / "cells" / "vox512-flythrough.json")
                      .read_text())
    (tiny / "cells" / "small-orbit.json").write_text(json.dumps(cell))
    (tiny / "metrics" / "frames_done.py").write_text(textwrap.dedent('''
        def read(run):
            return len(run.frame_s) or None
    '''))
    bj["configs"].append({"name": "knot-small", "source": "test",
                          "file": "benchmark/configs/knot-small.json",
                          "reduced": []})
    bj["workloads"].append({"name": "small-orbit", "config": "knot-small",
                            "traffic": "slow-orbit", "chips": 1,
                            "why": "test"})
    bj["end_to_end"].append({"name": "frames_done", "unit": "frames",
                             "better": "higher", "bound": 0.1,
                             "source": "host_clock",
                             "workloads": ["small-orbit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))

    spec = harness.load_spec("small-orbit", tiny)
    assert spec.config["grid_res"] == 16 and spec.traffic["cameras"] == 3
    assert "frames_done" in [m["name"] for m in spec.end_to_end]
    assert "frames_done" not in [
        m["name"] for m in harness.load_spec("vox512-flythrough",
                                             tiny).end_to_end]
    run = _run(spec)
    got = harness.read_metrics(run, spec.end_to_end)
    assert got["frames_done"]["value"] == len(run.frame_s) > 0
    assert set(got) == {"frame_ms", "frame_p95_ms", "setup_s",
                        "frames_done"}
    correct, checks = harness.verdict(run)
    assert correct, checks
    with pytest.raises(KeyError):
        harness.load_spec("no-such-cell", tiny)


def test_frame_metrics_take_every_frame(tiny):
    """frame_ms is all the window's time over all its frames; frame_p95_ms
    the 95th percentile of every frame, not of chunk medians."""
    spec = harness.load_spec("vox512-flythrough", tiny)
    rng = np.random.default_rng(5)
    frames = list(rng.gamma(4.0, 1e-3, size=997))
    frames[10:20] = [0.05] * 10                 # a slow stretch
    run = harness.Run(spec=spec, frame_s=frames, window_s=sum(frames) + 0.01)
    got = harness.read_metrics(run, spec.end_to_end)
    assert got["frame_ms"]["value"] == pytest.approx(
        (sum(frames) + 0.01) / 997 * 1e3, rel=1e-12)
    assert got["frame_p95_ms"]["value"] == pytest.approx(
        np.percentile(frames, 95) * 1e3, rel=1e-12)
    chunks = [np.median(frames[i:i + 50]) for i in range(0, 997, 50)]
    assert got["frame_p95_ms"]["value"] != pytest.approx(
        np.percentile(chunks, 95) * 1e3, rel=1e-3)


class _FakeEvent:
    def __init__(self, name, start, end, cuda, id=0):
        self.name, self.id = name, id
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()


class _FakeProf:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_busy_union_and_idle_arithmetic():
    """Busy time is the union of the device intervals inside the window;
    the idle gaps are what is left, named by the host's innermost op."""
    assert profile.busy_seconds([(0, 10), (5, 20), (30, 40)]) \
        == pytest.approx(30e-6)
    assert profile.busy_seconds([(0, 10), (5, 20), (30, 40)], 8, 35) \
        == pytest.approx(17e-6)
    ev = [_FakeEvent(profile.WINDOW_SPAN, 100, 200, False),
          _FakeEvent(profile.WINDOW_SPAN, 100, 200, True),   # annotation
          _FakeEvent("Activity Buffer Request", 100, 200, False),
          _FakeEvent("aten::nonzero", 130, 160, False),
          _FakeEvent("cudaMemcpyAsync", 140, 158, False),
          _FakeEvent("mega_trace_kernel(TraceArgs)", 90, 120, True),
          _FakeEvent("void at::native::elementwise_kernel<128, 2>()", 110,
                     125, True),
          _FakeEvent("ProfilerStep#1", 100, 200, True),      # annotation
          _FakeEvent("Memcpy DtoH (Device -> Pageable)", 160, 162, True),
          _FakeEvent("tri_march_kernel(MarchArgs)", 170, 195, True)]
    tr = profile.Trace(_FakeProf(ev))
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [100, 125] + [160, 162] + [170, 195] inside the window
    assert tr.busy_s == pytest.approx(52e-6)
    assert len(tr.kernels()) == 3
    assert tr.seconds_of(["mega_trace_kernel"]) == pytest.approx(30e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::nonzero > cudaMemcpyAsync"] == pytest.approx(35e-6)
    assert sum(gaps.values()) == pytest.approx(48e-6)
    top = tr.top_ops()
    assert top[0][0].startswith("tri_march_kernel")
    # a trace of the device alone: the window is its host-clock length
    dev = profile.Trace(_FakeProf([e for e in ev if e.device_type ==
                                   torch.autograd.DeviceType.CUDA]),
                        window_s=200e-6)
    assert dev.window_s == pytest.approx(200e-6)
    assert dev.busy_s == pytest.approx(35e-6 + 2e-6 + 25e-6)


@pytest.mark.parametrize("name, glue", [
    ("(anonymous namespace)::mega_trace_kernel((anonymous namespace)::"
     "TraceArgs)", False),
    ("(anonymous namespace)::tri_march_kernel((anonymous namespace)::"
     "MarchArgs)", False),
    ("new_fused_shading_kernel(float const*, int)", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
     "alignedK_contig<at::native::(anonymous namespace)::OpaqueType<4u> >",
     True),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::arange_cuda_out(at::Tensor&)::{lambda(long)#1}>", True),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>()",
     True),
    ("void cub::CUB_200200_900_NS::DeviceSelectSweepKernel<long>()", True),
    ("Memcpy HtoD (Pageable -> Device)", True),
    ("Memset (Device)", True)])
def test_glue_is_told_by_where_a_kernel_comes_from(name, glue):
    """PyTorch's kernels, copies and fills are glue; any other kernel,
    one that a later change adds too, is the program's own."""
    assert profile.is_glue(name) is glue


def test_per_layer_readers(tiny):
    spec = harness.load_spec("vox512-flythrough", tiny)
    ev = [_FakeEvent(profile.WINDOW_SPAN, 0, 1000, False),
          _FakeEvent("mega_trace_kernel(TraceArgs)", 100, 300, True),
          _FakeEvent("mega_trace_kernel(TraceArgs)", 600, 700, True),
          _FakeEvent("void at::native::elementwise_kernel<128, 2>()", 300,
                     500, True),
          _FakeEvent("Memset (Device)", 500, 510, True)]
    run = harness.Run(spec=spec, trace=profile.Trace(_FakeProf(ev)),
                      traced_frames=2, admitted=[10, 30],
                      sync_sites=["a.py:1"] * 7, sync_frames=2,
                      plain_s=800e-6)
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    w, h = spec.config["width"], spec.config["height"]
    # busy 510 us of the same frames' 800 us untraced
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 510 / 800))
    assert got["launches_per_frame"] == 1.5
    assert got["frame_glue_ms"] == pytest.approx(0.21 / 2)
    assert got["host_syncs_per_frame"] == 3.5
    assert got["trace_kernel_ms"] == pytest.approx(0.15)
    rays = 2 * w * h + 40
    assert got["trace_roofline_pct"] == pytest.approx(
        100 * 32 * rays / 3.35e12 / 300e-6)


def test_readers_leave_out_what_they_cannot_read(tiny):
    """A run without a trace reports no per-layer metric, and a trace in
    which no trace kernel ran reports no kernel time and no roofline
    (never 0)."""
    spec = harness.load_spec("tri-flythrough", tiny)
    assert harness.read_metrics(harness.Run(spec=spec), spec.per_layer) \
        == {}
    ev = [_FakeEvent(profile.WINDOW_SPAN, 0, 1000, False),
          _FakeEvent("void at::native::elementwise_kernel<128, 2>()", 300,
                     500, True)]
    run = harness.Run(spec=spec, trace=profile.Trace(_FakeProf(ev)),
                      traced_frames=1, admitted=[5], sync_frames=1)
    got = harness.read_metrics(run, spec.per_layer)
    assert "trace_kernel_ms" not in got and "trace_roofline_pct" not in got
    assert got["frame_glue_ms"]["value"] == pytest.approx(0.2)


def test_work_count():
    assert work.RAY_BYTES == 32
    assert work.trace_rays(4, 2, [3, 0, 5]) == 3 * 8 + 8
    assert work.trace_bytes(4, 2, [3]) == 32 * 11
    assert work.peak("hbm_bytes_per_s") == 3.35e12


@pytest.mark.parametrize("cell", ["vox512-flythrough", "tri-flythrough",
                                  "vox512-deform"])
def test_sound_run_is_correct(tiny, cell):
    spec = harness.load_spec(cell, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert correct, checks
    assert checks["pixels_apart_ppm"]["value"] == 0
    assert run.failed == 0
    assert checks["frames_unchecked"]["value"] == 0


def _stale(real):
    first = []

    def frame(self, vi, pi, shadows=True):
        img = real(self, vi, pi, shadows)
        if not first:
            first.append(img.clone())
        return first[0]
    return frame


def _half(real):
    def frame(self, vi, pi, shadows=True):
        img = real(self, vi, pi, shadows).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return frame


def _altered(monkeypatch):
    """The nearest-hit trace's t altered where the trace produces it."""
    from voxelray_torch.render import pipeline
    vox, tri = pipeline._trace_voxels, pipeline._trace_triangles

    def trace_voxels(*a, **k):
        t, i = vox(*a, **k)
        return t * 1.001, i

    def trace_triangles(*a, **k):
        t, i, u, v = tri(*a, **k)
        return t * 1.001, i, u, v
    monkeypatch.setattr(pipeline, "_trace_voxels", trace_voxels)
    monkeypatch.setattr(pipeline, "_trace_triangles", trace_triangles)


@pytest.mark.parametrize("cell", ["vox512-flythrough", "tri-flythrough",
                                  "vox512-deform"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_faults_are_not_correct(tiny, monkeypatch, cell, fault):
    """A run with the timed path broken underneath comes out not correct:
    the frame returned unchanged from the first, half of its rows left
    out, the trace's answer altered where it is produced."""
    from vrbench.program import Program
    if fault == "state_unchanged":
        monkeypatch.setattr(Program, "frame", _stale(Program.frame))
    elif fault == "half_left_out":
        monkeypatch.setattr(Program, "frame", _half(Program.frame))
    else:
        _altered(monkeypatch)
    spec = harness.load_spec(cell, tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert run.failed > 0


def _deform_fault(fault):
    """A step of the deforming scene broken underneath."""
    from vrbench.kinds import voxel_deform
    real = voxel_deform.Program.step

    def step(self, step):
        if fault == "grid_frozen":
            # every step voxelizes the first vertex set
            real(self, step - self.key(step))
        elif fault == "accel_not_rebuilt":
            # the new voxelize, and the scene of the first step kept
            scene = self.scene
            real(self, step)
            self.scene = scene or self.scene
        elif fault == "occupancy_of_another_step":
            before = self.answers.get("occupancy")
            real(self, step)
            if before is not None:
                self.answers["occupancy"] = before
        else:
            real(self, step)
            self.answers["set_calls"] = self.answers["set_calls"] + 1
    return step


@pytest.mark.parametrize("fault", ["grid_frozen", "accel_not_rebuilt",
                                   "occupancy_of_another_step",
                                   "set_calls_wrong"])
def test_deform_faults_are_not_correct(tiny, monkeypatch, fault):
    """A deforming scene's step broken underneath comes out not correct:
    the grid frozen at the first vertex set, the scene not rebuilt after
    the voxelize, a checked frame's occupancy from another step, a wrong
    set_calls."""
    from vrbench.kinds import voxel_deform
    monkeypatch.setattr(voxel_deform.Program, "step", _deform_fault(fault))
    spec = harness.load_spec("vox512-deform", tiny)
    run = _run(spec)
    correct, checks = harness.verdict(run)
    assert not correct, checks
    assert run.failed > 0
    if fault in ("grid_frozen", "occupancy_of_another_step"):
        assert checks["occupancy_cells_apart"]["value"] > 0
    elif fault == "set_calls_wrong":
        assert checks["set_calls_apart"]["value"] == 1
    else:
        assert checks["occupancy_cells_apart"]["value"] == 0
        assert checks["pixels_apart_ppm"]["value"] \
            > checks["pixels_apart_ppm"]["limit"]


def test_deform_steps_take_their_own_geometry(tiny):
    """Window frame i is step start + i: camera step mod cameras, vertex
    set step mod sets; the program's voxelize and each checked frame's are
    judged against the reference of that step's own set."""
    spec = harness.load_spec("vox512-deform", tiny)
    run = _run(spec)
    geo = run.geometry
    assert len(geo.sets) == 4 and geo.key(5) == 1
    assert not np.array_equal(geo.sets[0], geo.sets[1])
    lo, hi = geo.bbox
    for v in geo.sets:
        assert (v >= lo).all() and (v <= hi).all()
    correct, checks = harness.verdict(run)
    assert correct, checks
    assert checks["occupancy_cells_apart"]["value"] == 0
    assert checks["set_calls_apart"]["value"] == 0
    from vrbench import inputs
    fl = inputs.Flight(spec.traffic, lo, hi, 64, 32, 7)
    assert [fl.step(i) for i in range(3)] == [fl.start + i for i in range(3)]
    assert fl.camera(2) == (fl.start + 2) % fl.n


def test_unknown_kind_is_refused():
    from vrbench.program import kind_of
    assert kind_of({"kind": "voxel-deform"}).Program.changes
    assert not kind_of({"kind": "voxel"}).Program.changes
    with pytest.raises(ValueError):
        kind_of({"kind": "no-such-kind"})


def test_traced_run_checks_too(tiny):
    spec = harness.load_spec("vox512-flythrough", tiny)
    run = _run(spec, trace=True)
    correct, checks = harness.verdict(run)
    assert correct, checks
    rounds = spec.traffic["trace_rounds"]
    assert run.traced_frames == 2 * rounds == len(run.admitted)


def test_deform_traced_run(tiny):
    """A traced run of the deforming cell checks its traced frames, counts
    each traced frame's shadow rays from its own geometry and reads the
    scene build's host time; on the CPU no device metric reports."""
    from vrbench import check, reference
    from vrbench.program import kind_of
    spec = harness.load_spec("vox512-deform", tiny)
    run = _run(spec, trace=True)
    correct, checks = harness.verdict(run)
    assert correct, checks
    rounds = spec.traffic["trace_rounds"]
    assert run.traced_frames == 2 * rounds == len(run.steps)
    refs = check.References(kind_of(spec.config), spec.config,
                            run.geometry, CPU)
    w, h = spec.config["width"], spec.config["height"]
    from vrbench import inputs
    fl = inputs.Flight(spec.traffic, *run.geometry.bbox, w, h, 0)
    want = []
    for step in run.steps:
        fl.start = step
        want.append(reference.admitted(refs(step)[0], *fl.matrices(0), w,
                                       h, spec.config["shading"], CPU))
    assert run.admitted == want
    got = harness.read_metrics(run, spec.per_layer)
    assert got["scene_build_host_ms"]["value"] > 0
    for name in ("voxelize_kernel_ms", "voxelize_roofline_pct",
                 "scene_build_ms", "frame_kernels_ms", "trace_kernel_ms"):
        assert name not in got


def test_voxelize_work_count_reads_no_program(tiny, monkeypatch):
    """voxelize_roofline_pct counts each traced frame's SAT tests from the
    benchmark's geometry and reference (the cells of every triangle's
    clamped window over that frame's vertex set, counted here in numpy),
    with the program made unimportable."""
    from vrbench.program import kind_of
    spec = harness.load_spec("vox512-deform", tiny)
    geo = kind_of(spec.config).geometry(spec.config)
    monkeypatch.setitem(sys.modules, "voxelray_torch", None)
    ev = [_FakeEvent(profile.WINDOW_SPAN, 0, 1000, False),
          _FakeEvent("voxel_accum_kernel(VoxelArgs)", 100, 150, True),
          _FakeEvent("voxel_accum_kernel(VoxelArgs)", 300, 330, True)]
    steps = [1, 2, 5]
    run = harness.Run(spec=spec, trace=profile.Trace(_FakeProf(ev)),
                      traced_frames=3, steps=steps, geometry=geo)
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    assert got["voxelize_kernel_ms"] == pytest.approx(80e-3 / 3)
    bb_min, _, vs, dims = geo.grid
    bound = 0.0
    for step in steps:
        tri = geo.sets[geo.key(step)][geo.faces]
        lo = ((tri.min(axis=1) - bb_min) / np.float32(vs)).astype(np.int64)
        hi = ((tri.max(axis=1) - bb_min) / np.float32(vs)).astype(np.int64)
        w = np.clip(np.minimum(hi + 2, dims) - np.maximum(lo, 0), 0, None)
        tests = int(w.prod(axis=1).sum())
        assert tests > len(geo.faces)
        nbytes = 12 * len(geo.sets[0]) + 12 * len(geo.faces) \
            + dims[0] * dims[1] * dims[2]
        bound += max(nbytes / 3.35e12, tests * 270 / 67e12)
    assert work.SAT_OPS == 270
    assert got["voxelize_roofline_pct"] == pytest.approx(
        100 * bound / 80e-6, rel=1e-9)


def test_scene_build_ms_links_launches_by_correlation(tiny):
    """scene_build_ms: the device operations whose runtime call began
    inside the benchmark's build_scene span, linked by correlation id,
    over the host-traced frames; frame_kernels_ms: the frame glue's
    kernels by name."""
    spec = harness.load_spec("vox512-deform", tiny)
    ev = [_FakeEvent(profile.WINDOW_SPAN, 0, 1000, False),
          _FakeEvent("vrbench.build_scene", 100, 200, False, id=1),
          _FakeEvent("vrbench.build_scene", 100, 200, True, id=1),
          _FakeEvent("cudaLaunchKernel", 110, 112, False, id=7),
          _FakeEvent("cudaMemcpyAsync", 150, 152, False, id=8),
          _FakeEvent("cudaLaunchKernel", 250, 252, False, id=9),
          _FakeEvent("void at::native::reduce_kernel<512>()", 300, 320,
                     True, id=7),
          _FakeEvent("Memcpy HtoD (Pageable -> Device)", 320, 330, True,
                     id=8),
          _FakeEvent("camera_rays_kernel(RaysArgs)", 400, 450, True,
                     id=9)]
    tr = profile.Trace(_FakeProf(ev))
    # the annotation on the device's timeline is no operation
    assert tr.busy_s == pytest.approx(80e-6)
    assert tr.launched_in("build_scene") == pytest.approx(30e-6)
    assert tr.launched_in("voxelize") is None
    run = harness.Run(spec=spec, trace=tr, host_trace=tr, traced_frames=2)
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    m = spec.traffic["host_trace_frames"]
    assert got["scene_build_ms"] == pytest.approx(30e-3 / m)
    assert got["frame_kernels_ms"] == pytest.approx(50e-3 / 2)
    run = harness.Run(spec=spec, call_s={"build_scene": 0.006},
                      traced_frames=3)
    assert harness.read_metrics(run, spec.per_layer)[
        "scene_build_host_ms"]["value"] == pytest.approx(2.0)


def test_cpu_run_loads_no_jax(tiny):
    """A run of the harness, in a process of its own, loads no module
    whose top-level name is jax, jaxlib, flax or voxelray_tpu."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]
        import torch
        from vrbench import harness
        import run as entry
        spec = harness.load_spec("vox512-flythrough", {str(tiny)!r})
        r = harness.run_cell(spec, 7, 0.05, True, torch.device("cpu"),
                             time.time())
        harness.read_metrics(r, spec.per_layer + spec.end_to_end)
        assert harness.verdict(r)[0]
        print("FORBIDDEN", entry.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    from run import forbidden_modules
    sys.modules["jaxlib.fake_for_test"] = sys.modules["json"]
    try:
        assert forbidden_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib.fake_for_test"]
