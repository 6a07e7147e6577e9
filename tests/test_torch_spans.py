"""voxelray_torch.utils.trace: spans and counters, and where the program
records them.

Off, nothing is recorded; on, spans nest with their parent's index and
their request's id, within a bound that counts what it drops; a frame of
render_image is one span with its six stages as children and a trace
kernel's call under the primary and the shadow stage; the shadow counters
agree with the frame's admit mask; the spans' clock is the profiler's and
no span shows among the profiler's events; dump() and the CLI's
--trace-out write Chrome-trace JSON holding the same tree.
"""
import json

import numpy as np
import pytest
import torch

from voxelray_torch import cli
from voxelray_torch.io import meshes
from voxelray_torch.io.objload import LoadedModel
from voxelray_torch.models.grids import GridBool
from voxelray_torch.models.scene import Light, build_scene
from voxelray_torch.ops.intersect import TMAX, TMIN
from voxelray_torch.render import pipeline
from voxelray_torch.render.camera import Camera
from voxelray_torch.utils import trace

torch.set_num_threads(2)
W, H = 128, 16          # one row of 8 x 128 tiles: the fast backend tiles
STAGES = ["rays", "primary", "surface", "shadow", "shade", "post"]
KERNEL_CALLS = {"vox": "mega_trace", "tri": "tri_march"}


@pytest.fixture(autouse=True)
def _recorder():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _scene(kind):
    v, f = meshes.icosphere(2)                   # 320 triangles
    if kind == "vox":
        grid = GridBool.from_mesh(v, f, 0.1, device="cpu")
        return build_scene(grid=grid, device="cpu")
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    verts[:, 3:6] = v / np.linalg.norm(v, axis=1, keepdims=True)
    mats = np.asarray([[.1, .1, .1, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, .1, 0,
                        1, 1, 0, -1]], np.float32)
    model = LoadedModel(vertices=verts,
                        indices=f.reshape(-1).astype(np.uint32),
                        materials=mats, textures=[],
                        mat_index=np.zeros(len(f), np.int32))
    scene = build_scene(models=[model], device="cpu")
    assert scene.tri_accel is not None
    return scene


def _frame(scene):
    _, _, vi, pi = Camera(eye=(2.0, 1.3, -2.1),
                          center=(0.0, 0.0, 0.0)).matrices(W, H)
    return vi, pi, dict(width=W, height=H, backend="fast", shadows=True)


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def test_off_records_nothing_and_leaves_counters_at_rest():
    scene = _scene("vox")
    vi, pi, kw = _frame(scene)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")    # one shared object
    with trace.span("a"):
        trace.count_device("x", torch.ones(4, dtype=torch.bool))
    pipeline.render_image(scene, vi, pi, **kw)
    assert trace.records() == [] and trace.dropped() == 0
    assert not any(k.startswith(("shadow.", "x")) for k in trace.counters())


def test_spans_nest_with_parent_frame_and_self_time():
    trace.enable()
    with trace.span("root"):
        with trace.span("a"):
            with trace.span("a1"):
                pass
        with trace.span("b"):
            pass
    with trace.span("next"):
        pass
    recs = trace.records()
    assert [r.name for r in recs] == ["root", "a", "a1", "b", "next"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert recs[0].frame == recs[1].frame == recs[2].frame == recs[3].frame
    assert recs[4].frame == recs[0].frame + 1
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[0].start_ns <= recs[1].start_ns <= recs[2].start_ns
    assert recs[2].end_ns <= recs[1].end_ns <= recs[3].start_ns
    # a span's self time, its length less its children's, is never < 0
    dur = [r.end_ns - r.start_ns for r in recs]
    own = [d - sum(dur[j] for j, c in enumerate(recs) if c.parent == i)
           for i, d in enumerate(dur)]
    assert own[0] == dur[0] - dur[1] - dur[3] and own[2] == dur[2]
    assert min(own) >= 0 and sum(own[:4]) == dur[0]


def test_the_bound_drops_and_counts():
    trace.enable(capacity=3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [r.name for r in trace.records()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0
    with trace.span("after"):
        pass
    assert [r.name for r in trace.records()] == ["after"]


def test_counters_count_and_reset():
    trace.count("unit.a")
    trace.count("unit.a", 4)
    trace.count("unit.b", 2)
    assert trace.counter("unit.a") == 5 and trace.counter("unit.c") == 0
    trace.enable()
    trace.count_device("unit.d", torch.tensor([True, False, True]))
    trace.count_device("unit.d", torch.tensor(3))
    got = trace.counters()
    assert got["unit.a"] == 5 and got["unit.b"] == 2 and got["unit.d"] == 5
    trace.reset_counters("unit.a")
    got = trace.counters()
    assert "unit.a" not in got and got["unit.b"] == 2 and got["unit.d"] == 5
    trace.clear()
    assert trace.counters() == {}


@pytest.mark.parametrize("kind", ["vox", "tri"])
def test_a_frame_is_one_span_with_its_stages(kind):
    scene = _scene(kind)
    vi, pi, kw = _frame(scene)
    trace.enable()
    pipeline.render_image(scene, vi, pi, **kw)
    recs = trace.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in roots] == ["render_image"]
    stages = _children(recs, roots[0])
    assert [r.name for r in stages] == STAGES
    assert len({r.frame for r in recs}) == 1
    call = KERNEL_CALLS[kind]
    for stage in ("primary", "shadow"):
        i = [j for j, r in enumerate(recs) if r.name == stage][0]
        assert call in [r.name for r in _children(recs, i)]
    assert trace.counter(f"rays.{call}") > 0


@pytest.mark.parametrize("kind", ["vox", "tri"])
def test_shadow_admitted_is_the_frames_admit_mask(kind):
    scene = _scene(kind)
    vi, pi, kw = _frame(scene)
    light = Light()
    o, d, _ = pipeline._frame_rays(scene, vi, pi, W, H, "fast")
    tri = (pipeline._trace_triangles(scene, o, d, TMIN, TMAX)
           if scene.n_triangles else None)
    t_vox, vox_id = pipeline._trace_voxels(scene, o, d, TMIN, TMAX, "fast")
    s = pipeline.surface_terms(scene, o, d, t_vox, vox_id, light, tri,
                               "fast")
    want = int((s.hit & s.facing).sum())
    assert 0 < want < W * H
    trace.enable()
    pipeline.render_image(scene, vi, pi, light=light, **kw)
    got = trace.counters()
    assert got["shadow.admitted"] == want
    # the voxel frame hands K2 every ray with the mask; the triangle frame
    # hands tri_march the admitted rays compacted
    assert got["shadow.rays"] == (W * H if kind == "vox" else want)


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable()
        with trace.span("op"):
            (x * 3.0).sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    span = trace.records()[0]
    ops = [e for e in prof.events() if e.name == "aten::sum"]
    assert len(ops) == 1
    lo = start + ops[0].time_range.start * 1e3
    hi = start + ops[0].time_range.end * 1e3
    assert span.start_ns <= lo <= hi <= span.end_ns
    assert span.end_ns - span.start_ns < 1e9


def test_spans_are_not_profiler_events():
    from torch.profiler import ProfilerActivity, profile
    scene = _scene("vox")
    vi, pi, kw = _frame(scene)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.render_image(scene, vi, pi, **kw)
    names = {r.name for r in trace.records()}
    assert {"render_image", "mega_trace"} <= names
    assert not names & {e.name for e in prof.events()}


def _tree(path):
    data = json.loads(path.read_text())
    return [(e["name"], e["args"]["parent"], e["args"]["frame"])
            for e in data["traceEvents"] if e["ph"] == "X"], data


def test_dump_writes_chrome_trace_json(tmp_path):
    trace.enable()
    with trace.span("frame"):
        with trace.span("stage"):
            trace.count("unit.dumped", 1)
    with trace.span("frame"):
        pass
    recs = trace.records()
    trace.dump(tmp_path / "spans.json")
    tree, data = _tree(tmp_path / "spans.json")
    assert tree == [(r.name, r.parent, r.frame) for r in recs]
    ev = data["traceEvents"][1]
    assert ev["ts"] == pytest.approx(recs[1].start_ns / 1e3, abs=1)
    assert ev["dur"] == pytest.approx(
        (recs[1].end_ns - recs[1].start_ns) / 1e3, abs=1)
    assert data["otherData"]["counters"] == {"unit.dumped": 1}


def test_cli_trace_out_writes_one_frame_tree_a_frame(tmp_path, capsys):
    out = tmp_path / "spans.json"
    assert cli.main(["sphere", "0.3", "--no-plane", "--backend", "fast",
                     "--device", "cpu", "--width", str(W), "--height",
                     str(H), "--frames", "2", "--out",
                     str(tmp_path / "f.npy"), "--trace-out", str(out)]) == 0
    assert not trace.enabled()
    tree, _ = _tree(out)
    frames = [i for i, (name, parent, _) in enumerate(tree)
              if name == "render_image"]
    assert len(frames) == 2
    for i in frames:
        assert tree[i][1] == -1
        assert [n for n, p, _ in tree if p == i] == STAGES
    assert tree[frames[0]][2] != tree[frames[1]][2]
    assert "voxelize_mesh" in [n for n, _, _ in tree]
