"""The staged voxel walk of the port (K3 grid_walk, K4 brick_fine and
trace_grid_fast(mega=False)) against the JAX package on the CPU.

The same numpy inputs (two grids, rays from outside and inside them,
per-ray t_min / t_max drawn from a seed) go to both packages.  XLA:CPU
crashes on these Pallas modules in a long-lived process (tests/_isolate.py),
so every JAX result is computed once, in one subprocess (`_JAX_SCRIPT`),
and written to an .npz that the parametrised cases below read (and those
of tests/test_torch_staged_march.py, through `jax_reference`).

Tolerances: candidate bricks, `cont`, resume cells, hit masks and hit
cells are bit-equal.  t: K4 evaluates the reference slab expression
((origin + (i + 0.5) * vs) -+ half - o) / d without reassociation, so the
port's t is bit-equal to numpy's float32 evaluation of that expression
for the hit cell (and to the port's exhaustive DDA).  XLA:CPU folds the
two constants of JAX's kernel into one, (i + 0.5) * vs + (origin -+ half),
and JAX's t is bit-equal to numpy's evaluation of that folded expression
instead; the two differ by an ulp of the box face over |d|.
"""
import fcntl
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelray_torch.io import meshes
from voxelray_torch.ops import geometry
from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
from voxelray_torch.ops.kernels import brick_fine, grid_walk
from voxelray_torch.ops.traverse import trace_grid_dda
from voxelray_torch.ops.traverse_fast import (any_hit_grid_fast, build_accel,
                                              trace_grid_fast)
from voxelray_torch.ops.voxelize import voxelize_plain
from voxelray_torch.render.camera import Camera

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
W, H = 64, 48
GRIDS = ("a", "b")
WALKS = [(g, l2, k, init) for g in GRIDS for l2 in (False, True)
         for k in (1, 5) for init in (False, True)]
TRACES = ("primary", "admit", "bounds", "inside")

_JAX_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from voxelray_tpu.ops.pallas.brick_fine import fine_walk_multi
    from voxelray_tpu.ops.pallas.grid_walk import coarse_walk, coarse_walk_init
    from voxelray_tpu.ops.traverse_fast import (_init_state, any_hit_grid_fast,
                                                build_accel, trace_grid_fast)

    inp = dict(np.load(sys.argv[1]))
    out = {}
    for g in ("a", "b"):
        acc = build_accel(jnp.asarray(inp[g + "_occ"]), inp[g + "_origin"],
                          float(inp[g + "_vs"]))
        o, d = jnp.asarray(inp[g + "_o"]), jnp.asarray(inp[g + "_d"])
        tmn, tmx = jnp.asarray(inp[g + "_tmin"]), jnp.asarray(inp[g + "_tmax"])
        rays = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
        kw = dict(bdims=acc.bdims, origin_key=acc.origin_key,
                  brick_world=float(acc.voxel_size * 8))
        cx, cy, cz, ok = _init_state(o, d, acc, tmx, tmn)
        out[g + "_init_cell"] = np.stack([cx, cy, cz], 1)
        out[g + "_init_ok"] = np.asarray(ok)
        for l2 in (0, 1):
            tab = acc.l2 if l2 else None
            for k in (1, 5):
                for init in (0, 1):
                    if init:
                        r = coarse_walk_init(*rays, tmn, tmx, acc.coarse, tab,
                                             k_hits=k, **kw)
                    else:
                        r = coarse_walk(*rays, cx, cy, cz, ok.astype(jnp.int32),
                                        tmx, acc.coarse, tab, k_hits=k, **kw)
                    key = f"{g}_walk_{l2}_{k}_{init}"
                    out[key + "_hits"] = np.asarray(r[0])
                    out[key + "_cell"] = np.stack([r[1], r[2], r[3]], 1)
                    out[key + "_cont"] = np.asarray(r[4])
        bricks5 = jnp.asarray(out[g + "_walk_1_5_1_hits"])
        n = o.shape[0]
        for kk in (1, 2, 5):
            b = bricks5[:kk]
            words = jnp.take(acc.fine, jnp.maximum(b, 0).reshape(-1), axis=1)
            words = words.reshape(16, kk, n).transpose(1, 0, 2)
            t, lin = fine_walk_multi(*rays, b, words, tmn, tmx, dims=acc.dims,
                                     bdims=acc.bdims, origin_key=acc.origin_key,
                                     voxel_size=acc.voxel_size)
            out[f"{g}_fine_{kk}_t"] = np.asarray(t)
            out[f"{g}_fine_{kk}_lin"] = np.asarray(lin)
        cam_o = jnp.asarray(inp[g + "_cam_o"])
        cam_d = jnp.asarray(inp[g + "_cam_d"])
        calls = {
            "primary": (cam_o, cam_d, {}),
            "admit": (cam_o, cam_d, dict(admit=jnp.asarray(inp[g + "_admit"]))),
            "bounds": (o, d, dict(t_min=tmn, t_max=tmx)),
            "inside": (jnp.asarray(inp[g + "_in_o"]),
                       jnp.asarray(inp[g + "_in_d"]), {}),
        }
        for name, (co, cd, ckw) in calls.items():
            t, lin, unres = trace_grid_fast(co, cd, acc, mega=False,
                                            return_stats=True, **ckw)
            out[f"{g}_trace_{name}_t"] = np.asarray(t)
            out[f"{g}_trace_{name}_lin"] = np.asarray(lin)
            out[f"{g}_trace_{name}_unresolved"] = np.asarray(unres)
        out[g + "_anyhit"] = np.asarray(any_hit_grid_fast(
            o, d, acc, t_min=tmn, t_max=tmx,
            admit=jnp.asarray(inp[g + "_admit_rays"]), mega=False))
    np.savez(sys.argv[2], **out)
''')


def _camera_rays(eye, center, w=W, h=H):
    _, _, vi, pi = Camera(eye=tuple(eye), center=tuple(center)).matrices(w, h)
    o, d = make_camera_rays(w, h, vi, pi)
    return o.reshape(-1, 3).numpy().copy(), d.reshape(-1, 3).numpy().copy()


def _grid_a():
    """icosphere shell at 48 cells: one coarse row (single level)."""
    v, f = meshes.icosphere(3)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / 48
    dims = geometry.grid_dims(bb_min, bb_max, vs)
    occ, _ = voxelize_plain(torch.from_numpy(v), torch.from_numpy(f),
                            bb_min, vs, dims)
    return occ.numpy(), bb_min, vs


def _grid_b(rng):
    """Random boxes in a 216x208x192 grid: 16848 bricks, five coarse rows,
    so the default walk is the two-level one."""
    nx, ny, nz = 216, 208, 192
    occ = np.zeros((nz, ny, nx), np.uint8)
    for _ in range(70):
        lo = rng.integers(0, [nz - 8, ny - 8, nx - 8])
        ext = rng.integers(2, 24, 3)
        hi = np.minimum(lo + ext, [nz, ny, nx])
        occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
    return occ, np.asarray([-1.3, 0.2, -0.7], np.float32), 0.0125


def _inputs(rng):
    inp = {}
    for g in GRIDS:
        occ, origin, vs = _grid_a() if g == "a" else _grid_b(rng)
        nz, ny, nx = occ.shape
        lo = origin.astype(np.float64)
        ext = np.asarray([nx, ny, nz]) * vs
        center = lo + ext / 2
        cam_o, cam_d = _camera_rays(center + np.asarray([0.9, 0.55, -0.9])
                                    * 1.3 * ext.max(), center)
        in_o, in_d = _camera_rays(center + np.asarray([0.05, 0.02, -0.03])
                                  * ext.max(), center
                                  + np.asarray([0.3, 0.1, 0.2]) * ext.max())
        # rays from outside and from inside the grid, per-ray bounds
        m = 2048
        o_in = (lo + rng.uniform(0.1, 0.9, (m, 3)) * ext).astype(np.float32)
        d_r = rng.normal(size=(m, 3))
        d_r = (d_r / np.linalg.norm(d_r, axis=1, keepdims=True)) \
            .astype(np.float32)
        o = np.concatenate([cam_o, o_in])
        d = np.concatenate([cam_d, d_r])
        n = len(o)
        tmin = np.where(rng.random(n) < 0.5, TMIN,
                        rng.uniform(0.001, 0.4 * ext.max(), n)) \
            .astype(np.float32)
        tmax = np.where(rng.random(n) < 0.6, TMAX,
                        tmin + rng.uniform(0.0, 2.0 * ext.max(), n)) \
            .astype(np.float32)
        inp.update({
            f"{g}_occ": occ, f"{g}_origin": origin, f"{g}_vs": np.float64(vs),
            f"{g}_o": o, f"{g}_d": d, f"{g}_tmin": tmin, f"{g}_tmax": tmax,
            f"{g}_cam_o": cam_o, f"{g}_cam_d": cam_d,
            f"{g}_admit": rng.random(len(cam_o)) < 0.5,
            f"{g}_admit_rays": rng.random(n) < 0.7,
            f"{g}_in_o": in_o, f"{g}_in_d": in_d})
    return inp


def jax_reference(tmp_path_factory):
    """(inputs, JAX outputs), computed once per pytest session: the first
    module to ask runs `_JAX_SCRIPT` in a subprocess and leaves its .npz in
    a directory every worker of the session shares (pytest-xdist gives
    each worker its own base temp directory under the session's); the
    others wait on the lock file and read it (tests/test_torch_staged_march.py
    uses this module's `ref` too)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "staged_jax_reference"
    tmp.mkdir(exist_ok=True)
    inp = _inputs(np.random.default_rng(7))
    with open(tmp / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (tmp / "out.npz").is_file():
            np.savez(tmp / "in.npz", **inp)
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            proc = subprocess.run(
                [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
                 str(tmp / "part.npz")], cwd=REPO, env=env,
                capture_output=True, text=True, timeout=900)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(tmp / "part.npz", tmp / "out.npz")
    return inp, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, JAX outputs, port accels) for the whole module."""
    inp, out = jax_reference(tmp_path_factory)
    accels = {g: build_accel(torch.from_numpy(inp[f"{g}_occ"]),
                             inp[f"{g}_origin"], float(inp[f"{g}_vs"]))
              for g in GRIDS}
    return inp, out, accels


def _slab_t(o, d, lin, accel, folded=False):
    """numpy float32 slab t0 of cell `lin`; folded evaluates each face as
    (i + 0.5) * vs + (origin -+ half), the constant folding of XLA:CPU."""
    nx, ny, _ = accel.dims
    idx = np.stack([lin % nx, (lin // nx) % ny, lin // (nx * ny)], -1)
    ip = idx.astype(np.float32) + np.float32(0.5)
    vs = np.float32(accel.voxel_size)
    org = np.asarray(accel.origin_key, np.float32)
    half = np.float32(0.5) * vs
    if folded:
        lo, hi = ip * vs + (org - half), ip * vs + (org + half)
    else:
        c = org + ip * vs
        lo, hi = c - half, c + half
    inv = np.float32(1.0) / d
    tb = inv * (lo - o)
    tt = inv * (hi - o)
    return np.minimum(tb, tt).max(axis=-1)


def _check_t(o, d, t, t_j, lin, accel):
    """Port t = the slab t0 as written, JAX t = the folded one."""
    hit = lin >= 0
    o, d, lin = np.asarray(o)[hit], np.asarray(d)[hit], lin[hit]
    assert np.array_equal(t[hit], _slab_t(o, d, lin, accel))
    assert np.array_equal(t_j[hit], _slab_t(o, d, lin, accel, folded=True))


def _rays(inp, g):
    t = torch.from_numpy
    return (t(inp[f"{g}_o"]), t(inp[f"{g}_d"]), t(inp[f"{g}_tmin"]),
            t(inp[f"{g}_tmax"]))


def _walk_kw(accel):
    return dict(bdims=accel.bdims, origin_key=accel.origin_key,
                brick_world=float(accel.voxel_size * 8))


def test_grids_take_the_intended_walks(ref):
    _, _, accels = ref
    assert accels["a"].coarse.shape[0] <= 4 < accels["b"].coarse.shape[0]


def _jax_init(out, g):
    """JAX's `_init_state` (bbox clip, per-ray t_min fast-forward): the
    entry brick and active mask its coarse_walk resumed from."""
    return (torch.from_numpy(out[f"{g}_init_cell"]),
            torch.from_numpy(out[f"{g}_init_ok"]))


@pytest.mark.parametrize("g", GRIDS)
def test_init_state_matches_jax(ref, g):
    """K3's fused init seeds the walk where JAX's `_init_state` does:
    coarse_walk_init gives every output of coarse_walk resumed from JAX's
    entry state, finished walks included."""
    inp, out, accels = ref
    acc = accels[g]
    o, d, tmn, tmx = _rays(inp, g)
    cell0, ok = _jax_init(out, g)
    assert 0 < ok.sum() < len(ok)
    for k in (1, 5):
        fused = grid_walk.coarse_walk_init(o, d, tmn, tmx, acc.coarse, None,
                                           k_hits=k, **_walk_kw(acc))
        seeded = grid_walk.coarse_walk(o, d, cell0, ok, tmx, acc.coarse, None,
                                       k_hits=k, **_walk_kw(acc))
        for a, b in zip(fused, seeded):
            assert torch.equal(a, b)


@pytest.mark.parametrize("g,l2,k,init", WALKS)
def test_coarse_walk_matches_jax(ref, g, l2, k, init):
    """Candidate bricks, `cont` and resume cell bit-equal, for the walk
    seeded in the kernel (coarse_walk_init, per-ray t_min) and resumed
    from JAX's entry state (coarse_walk), single- and two-level.

    Reference fault: on grid b (27x26x24 bricks, superbricks sticking out
    of the grid) JAX's two-level walk lands some rays outside the grid
    and reports the brick at the aliased linear index, a brick its
    single-level walk never visits.  The port treats cells outside the
    grid as empty; on those rays it is held to JAX's single-level walk.
    """
    inp, out, accels = ref
    acc = accels[g]
    o, d, tmn, tmx = _rays(inp, g)
    tab = acc.l2 if l2 else None
    if init:
        hits, cell, cont = grid_walk.coarse_walk_init(
            o, d, tmn, tmx, acc.coarse, tab, k_hits=k, **_walk_kw(acc))
    else:
        cell0, ok = _jax_init(out, g)
        hits, cell, cont = grid_walk.coarse_walk(
            o, d, cell0, ok, tmx, acc.coarse, tab, k_hits=k, **_walk_kw(acc))
    key = f"{g}_walk_{int(l2)}_{k}_{int(init)}"
    one = f"{g}_walk_0_{k}_{int(init)}"
    h_j, c_j, cell_j = (out[key + "_hits"], out[key + "_cont"],
                        out[key + "_cell"])
    fault = (h_j != out[one + "_hits"]).any(0)
    assert fault.sum() == 0 if (g == "a" or not l2) else fault.mean() < 0.01
    h_j = np.where(fault[None], out[one + "_hits"], h_j)
    c_j = np.where(fault, out[one + "_cont"], c_j)
    cell_j = np.where(fault[:, None], out[one + "_cell"], cell_j)
    assert np.array_equal(hits.numpy(), h_j)
    assert np.array_equal(cont.numpy(), c_j)
    live = c_j > 0
    assert np.array_equal(cell.numpy()[live], cell_j[live])
    # A ray that leaves the grid or its t_max from an empty superbrick
    # ends one landing away: XLA:CPU contracts the landing point
    # o + d * t_exit into a fused multiply-add (a float64 emulation of
    # that contraction reproduces JAX's cell, the uncontracted one the
    # port's).  Its walk is over (cont 0), so that cell is never read.
    dead_diff = (cell.numpy() != cell_j).any(1)
    assert dead_diff.sum() == 0 if not l2 else dead_diff.mean() < 0.01
    assert (hits >= 0).sum() > 100


@pytest.mark.parametrize("g", GRIDS)
def test_two_level_walk_visits_the_same_bricks(ref, g):
    inp, _, accels = ref
    acc = accels[g]
    o, d, tmn, tmx = _rays(inp, g)
    one = grid_walk.coarse_walk_init(o, d, tmn, tmx, acc.coarse, None,
                                     k_hits=5, **_walk_kw(acc))
    two = grid_walk.coarse_walk_init(o, d, tmn, tmx, acc.coarse, acc.l2,
                                     k_hits=5, **_walk_kw(acc))
    assert torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])
    live = one[2] > 0       # the cell a finished walk ends in is unused
    assert torch.equal(one[1][live], two[1][live])


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("kk", [1, 2, 5])
def test_fine_walk_multi_matches_jax(ref, g, kk):
    """K slots in order, first accepted cell: hits and cells bit-equal,
    t as the module docstring says; the single-slot form agrees."""
    inp, out, accels = ref
    acc = accels[g]
    o, d, tmn, tmx = _rays(inp, g)
    bricks = torch.from_numpy(out[f"{g}_walk_1_5_1_hits"][:kk])
    t, lin = brick_fine.fine_walk_multi(
        o, d, bricks, acc.fine, tmn, tmx, dims=acc.dims, bdims=acc.bdims,
        origin_key=acc.origin_key, voxel_size=acc.voxel_size)
    t_j, lin_j = out[f"{g}_fine_{kk}_t"], out[f"{g}_fine_{kk}_lin"]
    hit = np.isfinite(t_j)
    assert hit.sum() > 50
    assert np.array_equal(np.isfinite(t.numpy()), hit)
    assert np.array_equal(lin.numpy(), lin_j)
    _check_t(o, d, t.numpy(), t_j, lin_j, acc)
    if kk == 1:
        t1, lin1 = brick_fine.fine_walk(
            o, d, bricks[0], acc.fine, tmn, tmx, dims=acc.dims,
            bdims=acc.bdims, origin_key=acc.origin_key,
            voxel_size=acc.voxel_size)
        assert torch.equal(lin1, lin) and torch.equal(t1, t)


def _trace_args(inp, g, name):
    t = torch.from_numpy
    if name == "primary":
        return t(inp[f"{g}_cam_o"]), t(inp[f"{g}_cam_d"]), {}
    if name == "admit":
        return (t(inp[f"{g}_cam_o"]), t(inp[f"{g}_cam_d"]),
                dict(admit=t(inp[f"{g}_admit"])))
    if name == "bounds":
        o, d, tmn, tmx = _rays(inp, g)
        return o, d, dict(t_min=tmn, t_max=tmx)
    return t(inp[f"{g}_in_o"]), t(inp[f"{g}_in_d"]), {}


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("name", TRACES)
def test_staged_trace_matches_jax_and_dda(ref, g, name):
    """trace_grid_fast(mega=False): unresolved 0, hits and cells equal to
    JAX's staged trace and to the port's exhaustive DDA, t bit-equal to
    the DDA's and as the module docstring says.  "inside" puts the camera
    inside the grid, where every ray has candidates from its first
    brick on."""
    inp, out, accels = ref
    acc = accels[g]
    o, d, kw = _trace_args(inp, g, name)
    t, lin, unresolved = trace_grid_fast(o, d, acc, mega=False,
                                         return_stats=True, **kw)
    assert unresolved == 0
    assert int(out[f"{g}_trace_{name}_unresolved"]) == 0
    t_j, lin_j = out[f"{g}_trace_{name}_t"], out[f"{g}_trace_{name}_lin"]
    hit = np.isfinite(t_j)
    assert hit.sum() > 50
    assert np.array_equal(lin.numpy(), lin_j)
    assert np.array_equal(np.isfinite(t.numpy()), hit)
    _check_t(o, d, t.numpy(), t_j, lin_j, acc)
    dkw = {k: v for k, v in kw.items()}
    t_d, lin_d = trace_grid_dda(o, d, torch.from_numpy(inp[f"{g}_occ"])
                                .reshape(-1), acc.origin, dims=acc.dims,
                                voxel_size=acc.voxel_size, **dkw)
    assert torch.equal(lin_d, lin)
    assert torch.equal(t_d[lin >= 0], t[lin >= 0])
    # the two-level walk and a shallow first round change only the cost
    t2, lin2 = trace_grid_fast(o, d, acc, mega=False, two_level=True,
                               k_hits=1, **kw)
    assert torch.equal(lin2, lin) and torch.equal(t2, t)


@pytest.mark.parametrize("g", GRIDS)
def test_staged_any_hit_matches_jax(ref, g):
    inp, out, accels = ref
    o, d, tmn, tmx = _rays(inp, g)
    admit = torch.from_numpy(inp[f"{g}_admit_rays"])
    occl = any_hit_grid_fast(o, d, accels[g], t_min=tmn, t_max=tmx,
                             admit=admit, mega=False)
    assert np.array_equal(occl.numpy(), out[f"{g}_anyhit"])
    assert not occl[~admit].any() and occl.sum() > 100
