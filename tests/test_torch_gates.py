"""The five BASELINE gates of the port against the JAX package's, at the
JAX gate tests' scales (tests/test_gates.py), on the CPU.

dims, counts, flags and node counts are equal; image means within 1e-5.
Gate 4 runs through each package's `gate4_flythrough` with backend
"dda" (JAX's "fast" would reach its Pallas kernels) on the `sphere`
registry mesh: knot512's million-triangle knot takes JAX minutes to
voxelize on a CPU at any scale.  Gate 5 deals its frames over one
device, and over 8 (the port's rehearsal mesh of 8 CPU entries, JAX's 8
virtual CPU devices).
"""
import dataclasses

import numpy as np
import pytest
import torch

from voxelray_tpu.utils import gates as jgates
from voxelray_torch.io import meshes
from voxelray_torch.native import voxelize_native
from voxelray_torch.utils import gates
from voxelray_torch.utils.config import BASELINE_CONFIGS

torch.set_num_threads(2)


def test_gate1_cube_occupancy():
    out = gates.run_gate("cube64", scale=0.25, device="cpu")
    want = jgates.run_gate("cube64", scale=0.25)
    assert out == want
    assert out["bit_exact"] and out["set_calls_match"] and out["occupied"]


def test_gate2_bunny_render():
    out = gates.run_gate("bunny128", scale=0.1, device="cpu")
    want = jgates.run_gate("bunny128", scale=0.1)
    assert out["dims"] == want["dims"]
    assert out["image_shape"] == want["image_shape"]
    assert out["hit_fraction"] == want["hit_fraction"] > 0.01
    assert abs(out["image_mean"] - want["image_mean"]) <= 1e-5


def test_gate3_vec_octree_aov():
    out = gates.run_gate("vec256", scale=0.08, device="cpu")
    want = jgates.run_gate("vec256", scale=0.08)
    assert out["backend"] == "octree"
    for k in ("vec_aabbs", "octree_nodes", "hit_pixels", "normals_unit"):
        assert out[k] == want[k], k
    assert out["hit_pixels"] > 0 and out["normals_unit"]
    assert out["depth_min"] == pytest.approx(want["depth_min"], rel=2e-6)
    with pytest.raises(ValueError):
        cfg = BASELINE_CONFIGS["vec256"]
        gates.gate3_vec_octree_aov(cfg.derived(
            render=dataclasses.replace(cfg.render, backend="dda")),
            scale=0.08, device="cpu")


def _dda(cfg):
    return cfg.derived(mesh="sphere",
                       render=dataclasses.replace(cfg.render, backend="dda"))


def test_gate4_flythrough():
    from voxelray_tpu.utils.config import BASELINE_CONFIGS as JCONFIGS
    out = gates.gate4_flythrough(_dda(BASELINE_CONFIGS["knot512"]),
                                 scale=0.02, frames=2, device="cpu")
    want = jgates.gate4_flythrough(_dda(JCONFIGS["knot512"]), scale=0.02,
                                   frames=2)
    assert out["dims"] == want["dims"] and out["frames"] == 2
    assert all(np.isfinite(m) for m in out["frame_means"])
    assert np.allclose(out["frame_means"], want["frame_means"], rtol=0,
                       atol=1e-5)


def test_gate5_deforming_one_device():
    out = gates.run_gate("deform8", scale=0.25, frames=2, device="cpu")
    want = jgates.run_gate("deform8", scale=0.25, frames=2, n_devices=1)
    assert out["devices"] == 1 and out["frames"] == 2
    assert out["dims"] == want["dims"]
    assert out["occupied_per_frame"] == want["occupied_per_frame"]
    assert out["occupied_per_frame"][0] != out["occupied_per_frame"][1]
    # each frame is the serial voxelizer's grid of that deformed mesh
    v, f = meshes.make_scene_mesh("bunny")
    for i in range(2):
        vi = meshes.deformed(v, 2 * np.pi * i / 2)
        occ, calls = voxelize_native(vi, f, out["voxel_size"],
                                     out["origin"], out["dims"])
        assert np.array_equal(out["occupancy"][i].numpy(), occ)
        assert out["set_calls_per_frame"][i] == calls


def test_gate5_deforming_sharded():
    """2 frames over 8 devices, the frame count padded to 8 and trimmed:
    the same counts as JAX's gate on its 8-device mesh, and the same
    occupancy as on one device."""
    out = gates.run_gate("deform8", scale=0.25, frames=2, n_devices=8,
                         device="cpu")
    want = jgates.run_gate("deform8", scale=0.25, frames=2, n_devices=8)
    one = gates.run_gate("deform8", scale=0.25, frames=2, device="cpu")
    assert out["devices"] == want["devices"] == 8 and out["frames"] == 2
    assert out["dims"] == want["dims"]
    assert out["occupied_per_frame"] == want["occupied_per_frame"]
    assert torch.equal(out["occupancy"], one["occupancy"])
    assert out["set_calls_per_frame"] == one["set_calls_per_frame"]
