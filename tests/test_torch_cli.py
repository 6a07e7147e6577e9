"""The port's command-line entry point and utils against the JAX package's.

`voxelray_torch.cli.main` and `voxelray_tpu.cli.main` run on the same
arguments (the port with --device cpu): the printed grid dims are equal,
and the images meet the render tolerance (equal hit mask, >= 99.9% of
pixels within 2e-5), the AOV buffers the AOV tolerance (equal hit mask,
depth within rtol 2e-6, normals within 1e-6).  A grid checkpoint saved
by either CLI loads in the other.  The utils are held to
tests/test_aux.py's checks, and BASELINE_CONFIGS to JAX's field by
field.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelray_tpu import cli as jcli
from voxelray_tpu.utils.config import BASELINE_CONFIGS as JCONFIGS
from voxelray_torch import cli
from voxelray_torch.utils import logging as vlogging
from voxelray_torch.utils.config import BASELINE_CONFIGS
from voxelray_torch.utils.timing import Benchmarker, time_fn

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SMALL = ["sphere", "0.3", "--width", "48", "--height", "27"]


def _run(main, args, capsys):
    assert main(args) == 0
    return capsys.readouterr().out


def _dims_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("Grid dim")]


def _images_close(img, ref):
    hit, jhit = img[..., 0] != img[0, 0, 0], ref[..., 0] != ref[0, 0, 0]
    assert np.array_equal(hit, jhit) and hit.any()
    close = (np.abs(img - ref) <= 2e-5).all(axis=-1)
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("extra", [
    ["--no-plane", "--backend", "dda"],
    ["--mode", "raster"],
])
def test_cli_frame_matches_jax(tmp_path, capsys, extra):
    out, jout = tmp_path / "p.npy", tmp_path / "j.npy"
    text = _run(cli.main, SMALL + extra + ["--device", "cpu", "--out",
                                           str(out)], capsys)
    jtext = _run(jcli.main, SMALL + extra + ["--out", str(jout)], capsys)
    assert _dims_line(text) == _dims_line(jtext) == ["Grid dimensions: "
                                                      "7x7x7"]
    assert "Voxel build took" in text and "frame 0:" in text
    img, ref = np.load(out), np.load(jout)
    assert img.shape == ref.shape == (27, 48, 4)
    _images_close(img, ref)


def test_cli_octree_aov_matches_jax(tmp_path, capsys):
    args = SMALL + ["--no-plane", "--encoding", "octree", "--backend",
                    "octree", "--aov"]
    out, jout = tmp_path / "p.npy", tmp_path / "j.npy"
    text = _run(cli.main, args + ["--device", "cpu", "--out", str(out)],
                capsys)
    jtext = _run(jcli.main, args + ["--out", str(jout)], capsys)
    assert _dims_line(text) == _dims_line(jtext)
    aov, ref = np.load(out), np.load(jout)
    assert aov.shape == ref.shape == (27, 48, 4)
    hit = np.isfinite(aov[..., 0])
    assert np.array_equal(hit, np.isfinite(ref[..., 0])) and hit.any()
    assert np.allclose(aov[hit, 0], ref[hit, 0], rtol=2e-6, atol=0.0)
    assert np.abs(aov[..., 1:] - ref[..., 1:]).max() <= 1e-6


def test_grid_checkpoints_load_across_the_clis(tmp_path, capsys):
    """A GridBool saved by the JAX CLI renders in the port's CLI from the
    file, and one saved by the port's CLI in JAX's, to the same images as
    the saving runs."""
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    render = ["--width", "48", "--height", "27", "--no-plane",
              "--backend", "dda"]
    outs = {k: str(tmp_path / f"{k}.npy")
            for k in ("jsave", "psave", "pload", "jload")}
    _run(jcli.main, ["sphere", "0.3", "--save-grid", a, "--out",
                     outs["jsave"]] + render, capsys)
    _run(cli.main, ["sphere", "0.3", "--save-grid", b, "--device", "cpu",
                    "--out", outs["psave"]] + render, capsys)
    text = _run(cli.main, ["--load-grid", a, "--device", "cpu", "--out",
                           outs["pload"]] + render, capsys)
    assert "(bool, dims (7, 7, 7))" in text
    _run(jcli.main, ["--load-grid", b, "--out", outs["jload"]] + render,
         capsys)
    img = {k: np.load(v) for k, v in outs.items()}
    assert np.array_equal(img["pload"], img["psave"])
    _images_close(img["jload"], img["jsave"])
    _images_close(img["pload"], img["jsave"])


def test_cli_reads_obj_files_with_the_native_parser(tmp_path, capsys):
    """An .obj argument goes through parse_obj_native: the sphere written
    as OBJ renders as the registry's sphere does."""
    from voxelray_torch.io.meshes import make_scene_mesh
    from voxelray_torch.io.objload import write_obj
    path = str(tmp_path / "sphere.obj")
    write_obj(path, *make_scene_mesh("sphere"))
    args = SMALL[2:] + ["--no-plane", "--backend", "dda", "--device", "cpu"]
    outs = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]
    _run(cli.main, ["sphere", "0.3", "--out", outs[0]] + args, capsys)
    text = _run(cli.main, [path, "0.3", "--out", outs[1]] + args, capsys)
    assert "Loaded mesh: 2562 vertices, 5120 triangles" in text
    assert np.array_equal(np.load(outs[0]), np.load(outs[1]))


def test_cli_writes_numbered_pngs(tmp_path, capsys):
    out = tmp_path / "f.png"
    text = _run(cli.main, SMALL + ["--no-plane", "--backend", "dda",
                                   "--frames", "2", "--no-shadows",
                                   "--device", "cpu", "--out", str(out)],
                capsys)
    assert "Wrote 2 frames" in text
    assert sorted(p.name for p in tmp_path.glob("f_*.png")) == [
        "f_0000.png", "f_0001.png"]


def test_cli_runs_on_the_card_by_default():
    """Without --device the CLI takes the CUDA card; on a machine without
    one it stops with the entry points' error instead of using the CPU.
    `python -m voxelray_torch.cli` is the entry."""
    proc = subprocess.run(
        [sys.executable, "-m", "voxelray_torch.cli", "sphere", "0.3",
         "--width", "8", "--height", "8", "--no-plane"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-2000:]
    else:
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr


def test_baseline_configs_equal_jax():
    assert BASELINE_CONFIGS.keys() == JCONFIGS.keys()
    for name, cfg in BASELINE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JCONFIGS[name])
    cfg = BASELINE_CONFIGS["knot512"].derived(with_plane=False)
    assert not cfg.with_plane and cfg.render.frames == 8


def test_build_stats_emit_the_reference_fields(caplog):
    with caplog.at_level("INFO", logger="voxelray"):
        rec = vlogging.BuildStats().bbox([0, 0, 0], [1, 2, 3]) \
            .grid((4, 5, 6), 0.25).triangles(12).voxels(7, 9).nodes(3) \
            .timing(1.5, 0.5).memory(64).emit()
    assert rec["grid_dims"] == [4, 5, 6] and rec["set_calls"] == 9
    assert rec["event"] == "voxelize" and rec["memory_bytes"] == 64


def test_benchmarker_render_metric():
    b = Benchmarker(runs=2, warmup=0)
    res = b.measure_render(lambda: torch.ones((8, 8, 4)), 8, 8)
    assert res.render_ms >= 0
    assert res.mrays_per_s > 0
    dt, out = time_fn(lambda: {"a": [torch.zeros(2)]}, iters=3)
    assert dt >= 0 and torch.equal(out["a"][0], torch.zeros(2))
