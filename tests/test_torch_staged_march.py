"""The staged trace's dispatch and its plain version
(ops/kernels/staged_march.py) on the CPU, and on the card the kernel
against that plain version.

`staged_march_plain` is the lap loop over K3 and K4 that
`trace_grid_fast(mega=False)` ran before the kernel; it is held here to
the JAX package's staged trace on the inputs and JAX outputs of
tests/test_torch_staged.py (its `ref` fixture: one JAX subprocess a
session).  Tolerances: hit cells bit-equal; t bit-equal to numpy's
float32 slab expression of the hit cell, and JAX's t to the constant-
folded one (the docstring of tests/test_torch_staged.py says why they
differ by an ulp).
"""
import numpy as np
import pytest
import torch
from test_torch_staged import (GRIDS, TRACES, _check_t,  # noqa: F401
                               _trace_args, ref)

from voxelray_torch.io import meshes
from voxelray_torch.ops.intersect import TMAX, TMIN
from voxelray_torch.ops.kernels import (_build, brick_fine, grid_walk,
                                        staged_march, tri_march)
from voxelray_torch.ops.traverse import _per_ray
from voxelray_torch.ops.traverse_fast import (any_hit_grid_fast, build_accel,
                                              trace_grid_fast)
from voxelray_torch.ops.tri_accel import build_tri_accel
from voxelray_torch.utils import trace

torch.set_num_threads(2)


def _launched(kernel):
    """The kernel module's launches so far (utils/trace.py's counter)."""
    return trace.counter("launches." + kernel.__name__.rsplit(".", 1)[-1])


def _bounds(o, kw):
    n = o.reshape(-1, 3).shape[0]
    return (_per_ray(kw.get("t_min", TMIN), n, o.device),
            _per_ray(kw.get("t_max", TMAX), n, o.device))


def _small_accel(device="cpu"):
    rng = np.random.default_rng(5)
    occ = (rng.random((24, 20, 28)) < 0.02).astype(np.uint8)
    accel = build_accel(torch.from_numpy(occ).to(device),
                        np.asarray([-0.4, 0.1, -0.2], np.float32), 0.05)
    n = 3000
    o = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (accel, torch.from_numpy(o).to(device),
            torch.from_numpy(d).to(device))


def test_cpu_tensors_take_the_plain_loop(monkeypatch):
    """On the CPU trace_grid_fast(mega=False) and any_hit_grid_fast run
    staged_march_plain once per call, and no kernel launch is counted;
    another device raises."""
    accel, o, d = _small_accel()
    calls = []
    plain = staged_march.staged_march_plain

    def counted(*a):
        calls.append(a[6])
        return plain(*a)

    monkeypatch.setattr(staged_march, "staged_march_plain", counted)
    counts = [_launched(m) for m in (staged_march, grid_walk, brick_fine)]
    t, lin, unresolved = trace_grid_fast(o, d, accel, mega=False,
                                         return_stats=True)
    occl = any_hit_grid_fast(o, d, accel, mega=False)
    assert calls == [5, 4] and unresolved == 0
    assert [_launched(m) for m in (staged_march, grid_walk,
                                 brick_fine)] == counts
    assert torch.equal(occl, lin >= 0) and int((lin >= 0).sum()) > 100
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trace_grid_fast(meta, meta, accel, mega=False)
    with pytest.raises(ValueError, match="unsupported device"):
        any_hit_grid_fast(meta, meta, accel, mega=False)


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("name", TRACES)
def test_plain_loop_matches_jax(ref, g, name):  # noqa: F811
    """staged_march_plain called directly gives JAX's staged trace (hit
    cells, unresolved 0, t as the module docstring says) and what
    trace_grid_fast(mega=False) gives, bit for bit."""
    inp, out, accels = ref
    acc = accels[g]
    o, d, kw = _trace_args(inp, g, name)
    tmn, tmx = _bounds(o, kw)
    admit = kw.get("admit")
    t, lin, unresolved = staged_march.staged_march_plain(
        o.reshape(-1, 3), d.reshape(-1, 3), acc, tmn, tmx, admit, 5, None)
    assert unresolved == 0
    lin_j = out[f"{g}_trace_{name}_lin"]
    assert np.array_equal(lin.numpy(), lin_j)
    _check_t(o, d, t.numpy(), out[f"{g}_trace_{name}_t"], lin_j, acc)
    t_f, lin_f = trace_grid_fast(o, d, acc, mega=False, **kw)
    assert torch.equal(lin_f, lin)
    assert torch.equal(t_f.view(torch.int32), t.view(torch.int32))


@pytest.mark.parametrize("g", GRIDS)
def test_plain_loop_any_hit_matches_jax(ref, g):  # noqa: F811
    """The shadow query's form (k 4, per-ray bounds, an admit mask)."""
    inp, out, accels = ref
    t = torch.from_numpy
    admit = t(inp[f"{g}_admit_rays"])
    tt, _, unresolved = staged_march.staged_march_plain(
        t(inp[f"{g}_o"]), t(inp[f"{g}_d"]), accels[g], t(inp[f"{g}_tmin"]),
        t(inp[f"{g}_tmax"]), admit, 4, None)
    assert unresolved == 0
    assert np.array_equal(torch.isfinite(tt).numpy(), out[f"{g}_anyhit"])


@pytest.mark.parametrize("kind", ["camera", "grazing"])
def test_tri_march_plain_is_unchanged(monkeypatch, kind):
    """tri_march_plain calls staged_march_plain directly; through
    trace_grid_fast(mega=False), as it did before, its (t, id, u, v) are
    the same bits."""
    from test_torch_kernels_host import _tri_rays
    v, f = meshes.torus_knot(2, 3, 64, 8)
    tri = v[f]
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=32,
                         device="cpu")
    rays = [torch.from_numpy(x) for x in _tri_rays(
        kind, tri, ta, np.random.default_rng(32))]
    now = tri_march.tri_march_plain(*rays, ta)

    def old_route(o, d, accel, tmn, tmx, admit, k_hits, two_level):
        return trace_grid_fast(o, d, accel, t_min=tmn, t_max=tmx,
                               mega=False, k_hits=k_hits,
                               two_level=two_level, return_stats=True)

    monkeypatch.setattr(tri_march, "staged_march_plain", old_route)
    before = tri_march.tri_march_plain(*rays, ta)
    assert now[4] == before[4] == 0 and int((now[1] >= 0).sum()) > 100
    for a, b in zip(now[:4], before[:4]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_the_plain_loop_on_cuda(cuda):
    """On the card trace_grid_fast(mega=False) is one staged_march launch
    and no K3/K4 launch, with no host sync; its (t bits, lin) equal the
    lap loop's with the K3/K4 kernels and on the CPU, with and without an
    admit mask, unresolved 0."""
    accel, o, d = _small_accel(cuda)
    accel_cpu = _small_accel()[0]
    n = o.shape[0]
    tmn = torch.full((n,), 0.01, device=cuda)
    tmx = torch.full((n,), 2.5, device=cuda)
    admit = torch.from_numpy(np.random.default_rng(1).random(n) < 0.05) \
        .to(cuda)
    for adm, k in ((None, 5), (admit, 4)):
        counts = [_launched(m) for m in (staged_march, grid_walk, brick_fine)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t, lin, unresolved = trace_grid_fast(
                o, d, accel, t_min=tmn, t_max=tmx, admit=adm, mega=False,
                k_hits=k, return_stats=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [_launched(m) for m in (staged_march, grid_walk, brick_fine)] \
            == [counts[0] + 1, counts[1], counts[2]]
        assert int(unresolved) == 0
        args = (o, d, accel, tmn, tmx, adm, k, None)
        want = staged_march.staged_march_plain(*args)
        on_cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
        on_cpu[2] = accel_cpu
        cpu = staged_march.staged_march_plain(*on_cpu)
        assert want[2] == cpu[2] == 0
        for ref_t, ref_lin in ((want[0], want[1]),
                               (cpu[0].to(cuda), cpu[1].to(cuda))):
            assert torch.equal(lin, ref_lin)
            assert torch.equal(t.view(torch.int32), ref_t.view(torch.int32))
        assert int((lin >= 0).sum()) > (5 if adm is not None else 100)



@pytest.mark.cuda
def test_kernel_defers_long_rays_on_cuda(cuda):
    """With more rays than the card's lanes and no admit mask, the kernel
    defers the rays still walking after its group budget and takes them
    back: (t bits, lin) equal the lap loop's with the K3/K4 kernels,
    unresolved 0, and every deferred ray got a ticket.  (The rays are the
    small accel's, repeated past the lanes the launch holds.)"""
    accel, o, d = _small_accel(cuda)
    cfg = staged_march.launch_config(accel)
    assert cfg["group_budget"] > 0 and cfg["blocks_per_sm"] >= 1
    reps = cfg["lanes"] // o.shape[0] + 2
    o, d = o.repeat(reps, 1).contiguous(), d.repeat(reps, 1).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), 0.01, device=cuda)
    tmx = torch.full((n,), 2.5, device=cuda)
    a, outs = staged_march.staged_args(o, d, accel, tmn, tmx, None, 5, True,
                                       cfg["lanes"])
    sched, slots = a.keep["sched"], a.keep["deferred"]
    assert slots.shape == (n, 4)
    _build.launch("staged_march", a, o.device)
    want = staged_march.staged_march_plain(o, d, accel, tmn, tmx, None, 5,
                                           True)
    torch.cuda.synchronize()
    assert int(outs[2]) == want[2] == 0
    assert torch.equal(outs[1], want[1])
    assert torch.equal(outs[0].view(torch.int32), want[0].view(torch.int32))
    deferred, tickets = int(sched[0]), int(sched[32])
    assert deferred > 0 and tickets >= deferred
