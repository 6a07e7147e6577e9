"""The port's brick accel (BrickAccel, build_fine_sb) against the JAX
package, and the numpy bridge of utils/convert.py.

Every integer table must be bit-equal: the port keeps the JAX layouts
and stores the uint32 words as int32 bit patterns.  Two grids: res 64
(one superbrick) voxelized by JAX, and res 144 (27 superbricks) whose
occupancy comes from the port's voxelizer, which test_torch_voxelize
holds bit-equal to JAX's (JAX's XLA:CPU voxelize at 144^3 alone takes
most of a minute here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelray_tpu.io import meshes as jmeshes
from voxelray_tpu.models.grids import GridBool as JGridBool
from voxelray_tpu.ops.geometry import mesh_bbox
from voxelray_tpu.ops.pallas.mega_trace import build_fine_sb as jbuild_fine_sb
from voxelray_tpu.ops.traverse_fast import build_accel as jbuild_accel
from voxelray_torch.ops.kernels.mega_trace import (accel_occupancy,
                                                   build_fine_sb)
from voxelray_torch.ops.traverse_fast import build_accel
from voxelray_torch.ops.voxelize import voxelize_mesh
from voxelray_torch.utils.convert import (accel_from_numpy, grid_from_numpy,
                                          words_to_tensor)

torch.set_num_threads(2)

TABLES = ("coarse", "fine", "l2", "fine_sb")


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module", params=[64, 144])
def grids(request):
    res = request.param
    v, f = jmeshes.icosphere(3)
    bb_min, bb_max = mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / res
    if res == 64:
        jgrid = JGridBool.from_mesh(v, f, vs)
        occ = np.asarray(jgrid.occupancy()).astype(np.uint8)
        origin, set_calls = np.asarray(jgrid.origin), jgrid.set_calls
        jwords = np.asarray(jgrid.words)
    else:
        r = voxelize_mesh(v, f, vs, device="cpu")
        occ, origin, set_calls = r["occ"].numpy(), r["origin"], \
            r["set_calls"]
        jwords = None
    jaccel = jbuild_accel(jnp.asarray(occ), origin, vs)
    return res, occ, origin, vs, set_calls, jwords, jaccel


def test_build_accel_bit_equal_to_jax(grids):
    res, occ, origin, vs, _, _, jaccel = grids
    accel = build_accel(torch.from_numpy(occ), origin, vs)
    assert accel.dims == jaccel.dims and accel.bdims == jaccel.bdims
    assert accel.origin_key == jaccel.origin_key
    n_sb = {64: 1, 144: 27}[res]
    assert tuple(accel.fine_sb.shape) == (n_sb, 72, 128)
    for name in TABLES:
        ours, ref = _u32(getattr(accel, name)), np.asarray(getattr(jaccel,
                                                                  name))
        assert ours.shape == ref.shape, name
        assert np.array_equal(ours, ref), name
    # build_fine_sb alone, from the JAX fine table
    fsb = build_fine_sb(words_to_tensor(np.asarray(jaccel.fine)),
                        jaccel.bdims)
    assert np.array_equal(_u32(fsb), np.asarray(
        jbuild_fine_sb(jaccel.fine, jaccel.bdims)))
    # the plain K2 decodes exactly this occupancy from the fine words
    assert np.array_equal(accel_occupancy(accel).numpy(), occ.reshape(-1))


def test_convert_round_trip(grids):
    res, occ, origin, vs, set_calls, jwords, jaccel = grids
    grid = grid_from_numpy(occ, origin, vs, set_calls)
    assert grid.dims == (occ.shape[2], occ.shape[1], occ.shape[0])
    assert grid.set_calls == set_calls
    assert np.array_equal(grid.occupancy().numpy(), occ)
    if jwords is not None:
        assert np.array_equal(_u32(grid.words), jwords)
    carried = accel_from_numpy(
        *(np.asarray(getattr(jaccel, k)) for k in TABLES),
        np.asarray(jaccel.origin), jaccel.dims, jaccel.bdims,
        jaccel.voxel_size)
    own = build_accel(grid.occupancy(), grid.origin, grid.voxel_size)
    for name in TABLES:
        assert np.array_equal(getattr(carried, name).numpy(),
                              getattr(own, name).numpy()), name
        # and back to the JAX package's uint32 arrays
        assert np.array_equal(_u32(getattr(carried, name)),
                              np.asarray(getattr(jaccel, name))), name
    assert carried.dims == own.dims and carried.bdims == own.bdims
    assert carried.origin_key == own.origin_key
    assert carried.voxel_size == own.voxel_size
    with pytest.raises(ValueError):
        words_to_tensor(np.zeros(4, np.float32))
