"""vrbench/spans.py: the program's spans read back: self times, idle gaps
put down to the innermost span, the clock check, and the readers of the
span metrics."""
from collections import namedtuple

import pytest

from vrbench import harness, spans

R = namedtuple("R", "name parent frame start_ns end_ns")
NEW = ("glue_host_ms", "kernel_call_host_ms", "glue_idle_ms",
       "shadow_useful_pct")


def _frame(t0=0, frame=1, first=0):
    """One frame's spans from t0: the six stages, a kernel call under
    primary and one under shadow; `first`, the index of its first
    record."""
    f = first
    return [R("render_image", -1, frame, t0, t0 + 1000),
            R("rays", f, frame, t0, t0 + 100),
            R("primary", f, frame, t0 + 100, t0 + 400),
            R("mega_trace", f + 2, frame, t0 + 150, t0 + 350),
            R("surface", f, frame, t0 + 400, t0 + 500),
            R("shadow", f, frame, t0 + 500, t0 + 800),
            R("mega_trace", f + 5, frame, t0 + 550, t0 + 750),
            R("shade", f, frame, t0 + 800, t0 + 900),
            R("post", f, frame, t0 + 900, t0 + 1000)]


def _two_frames():
    return _frame() + _frame(t0=2000, frame=2, first=9)


def test_self_times_and_kernel_calls():
    recs = _two_frames() + [R("build_scene", -1, 3, 5000, 9000)]
    own = spans.host_self_ns(recs)
    assert own["render_image"] == 0 and own["rays"] == 200
    assert own["primary"] == 2 * 100 and own["shadow"] == 2 * 100
    assert own["mega_trace"] == 4 * 200 and "build_scene" not in own
    assert spans.glue_host_ns(recs) == 2 * 600
    assert spans.kernel_call_ns(recs) == 2 * 400


def test_idle_gaps_go_to_the_innermost_span():
    recs = _frame()
    ops = [("elementwise", 0, 50), ("mega_trace_kernel(A)", 160, 340),
           ("mega_trace_kernel(A)", 560, 740), ("cat", 990, 1100)]
    idle = spans.idle_by_span(recs, ops, 0, 1200)
    # gaps [50, 160] (mid 105: primary), [340, 560] (450: surface),
    # [740, 990] (865: shade), [1100, 1200] (after the frame)
    assert idle == {"primary": 110, "surface": 220, "shade": 250,
                    spans.OUTSIDE: 100}
    # a gap whose midpoint falls in a kernel call's span is the call's
    idle = spans.idle_by_span(recs, [("x", 0, 200), ("y", 300, 1000)], 0,
                              1000)
    assert idle == {"mega_trace": 100}


def test_clock_check_matches_launches_frame_by_frame():
    recs = _two_frames()
    ops = [("(anonymous namespace)::mega_trace_kernel(A)", s, s + 50)
           for s in (160, 560, 2170, 2555)] + [("cat", 0, 10)]
    marks = [0, 1500, 3000]
    assert spans.clock_offsets(recs, ops, marks) == {
        "mega_trace": [10, 10, 20, 5]}
    # a launch the profiler lost: that frame is left out, not misread
    assert spans.clock_offsets(recs, ops[1:], marks) == {
        "mega_trace": [20, 5]}


def test_device_times_are_mapped_onto_the_marks():
    """Markers 1.5 ms off their stamps and drifting 1 us a frame, one of
    them lost: each kept marker lands on its own stamp, and a device time
    between two kept ones in proportion."""
    marks = [0, 5_000_000, 11_000_000, 15_000_000, 21_000_000]
    dev = [m + 1_500_000 + 1000 * k for k, m in enumerate(marks)]
    ops = [(spans.MARK + "(long)", d, d + 2000) for k, d in enumerate(dev)
           if k != 2]
    ops += [("cat", dev[0] + 100_000, dev[0] + 200_000),
            ("mul", dev[2] + 4_000_000, dev[3] - 1)]
    got, skew = spans.align(sorted(ops, key=lambda o: o[1]), marks)
    assert skew == [1_500_000, 1_501_000, 1_503_000, 1_504_000]
    assert got[0] == ("cat", 100_000 - 20, 200_000 - 40)

    def onto(t):        # between the kept marks 1 and 3
        return marks[1] + (t - dev[1]) * (marks[3] - marks[1]) \
            / (dev[3] - dev[1])
    assert got[1][0] == "mul"
    assert got[1][1] == pytest.approx(onto(dev[2] + 4_000_000), abs=1)
    assert got[1][2] == pytest.approx(onto(dev[3] - 1), abs=1)
    assert spans.align(ops[:1], marks) == (None, [])


def _spans(**kw):
    recs = _two_frames()
    ops = [("mega_trace_kernel(A)", s, s + 180) for s in (160, 560, 2160,
                                                          2560)]
    base = dict(frames=2, on_s=4e-6, off_s=3.9e-6, recs=recs,
                counters={"shadow.rays": 400, "shadow.admitted": 30},
                dev_recs=recs, ops=ops, marks=[0, 1500, 3000], lo=0,
                hi=3000)
    base.update(kw)
    return spans.Spans(**base)


def test_readers_of_a_run_with_spans(tiny):
    spec = harness.load_spec("vox512-flythrough", tiny)
    run = harness.Run(spec=spec)
    run.spans = _spans()
    got = {k: v["value"] for k, v in
           harness.read_metrics(run, spec.per_layer).items()}
    assert got["glue_host_ms"] == pytest.approx(600 / 1e6)
    assert got["kernel_call_host_ms"] == pytest.approx(400 / 1e6)
    assert got["shadow_useful_pct"] == pytest.approx(7.5)
    # busy 4 x 180 ns of the 3000: idle 2280 ns, of which 860 in the
    # glue's self time and 1420 between the frames; pass (a)'s idle
    # 4000 - 720 ns, over two frames
    idle = spans.idle_by_span(run.spans.dev_recs, run.spans.ops, 0, 3000)
    assert idle == {"rays": 160, "surface": 440, "shade": 260,
                    spans.OUTSIDE: 1420}
    assert got["glue_idle_ms"] == pytest.approx(
        860 / 2280 * (4000 - 720) / 2 / 1e6)
    # off the card: no device trace, no idle
    run.spans = _spans(ops=[], dev_recs=[], lo=0, hi=0)
    got = harness.read_metrics(run, spec.per_layer)
    assert "glue_idle_ms" not in got and "glue_host_ms" in got


def test_new_readers_read_nothing_without_spans(tiny, monkeypatch):
    """A run that traced nothing, and a program that records no spans (a
    tree before the recorder), report none of the span metrics."""
    spec = harness.load_spec("vox512-flythrough", tiny)
    assert {m["name"] for m in spec.per_layer} >= set(NEW)
    assert harness.read_metrics(harness.Run(spec=spec), spec.per_layer) \
        == {}
    monkeypatch.setattr(spans, "recorder", lambda: None)
    run = harness.Run(spec=spec, trace=object(), host_trace=object())
    for name in NEW:
        got = harness.read_metrics(run, [m for m in spec.per_layer
                                         if m["name"] == name])
        assert got == {}, name


@pytest.mark.parametrize("cell", ["vox512-flythrough", "tri-flythrough"])
def test_cpu_traced_run_reports_the_span_metrics(tiny, cell):
    """On the CPU the spans window flies the cell's program again (no
    device trace): the host metrics report, the idle one does not; the
    shadow counters hold the voxel frame's admit mask against every ray.
    (A whole traced run on the CPU reads them too: test_harness's
    test_cpu_run_loads_no_jax.)"""
    spec = harness.load_spec(cell, tiny)
    run = harness.Run(spec=spec, trace=object(), host_trace=object())
    new = [m for m in spec.per_layer if m["name"] in NEW]
    got = {k: v["value"] for k, v in harness.read_metrics(run, new).items()}
    assert got["glue_host_ms"] > 0 and got["kernel_call_host_ms"] > 0
    assert "glue_idle_ms" not in got
    s = run.spans
    assert s.frames == spec.traffic["trace_frames"] \
        * spec.traffic["trace_rounds"]
    assert [r.name for r in s.recs].count("render_image") == s.frames
    assert s.on_s > 0 and s.off_s > 0 and not s.traced
    if cell == "vox512-flythrough":
        w, h = spec.config["width"], spec.config["height"]
        assert s.counters["shadow.rays"] == s.frames * w * h
        assert 0 < got["shadow_useful_pct"] < 100
    else:
        assert "shadow_useful_pct" not in got
