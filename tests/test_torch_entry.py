"""The port's single-device entry hook (``simpleslam_tpu_torch/entry.py``)
against the reference package's (``__graft_entry__.entry``).

Both hooks build the same plane world from the same numpy draws and run
``loam.scan2map`` on it from the identity: against the sorted voxel table
(the reference hook's own fixture) and against the dense voxel map (its
``_tiny_fixture(dense=True)``). On the CPU the port runs K3's plain version;
the JAX package runs its ``lax.while_loop`` under ``jax.jit``. The poses are
held within ``POSE_T_TOL`` / ``POSE_R_TOL`` with equal iteration, gather and
valid-row counts (measured on the CPU: 1.59e-07 m on the table, 1.66e-07 m
on the dense map, rotations within 1.1e-08 rad).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from simpleslam_tpu.ops import loam as jloam
from simpleslam_tpu_torch import entry as tentry
from simpleslam_tpu_torch.ops import loam as tloam

POSE_T_TOL = 1e-4   # metres
POSE_R_TOL = 1e-5   # radians


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers on a few cores: two torch threads a
    worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_hook(dense: bool):
    """The reference hook's (fn, args); the dense case from its fixture."""
    if not dense:
        return graft.entry()
    src, vm = graft._tiny_fixture(dense=True)

    def fn(src, vm, init_pose):
        return jloam.scan2map(src, vm, init_pose).pose

    return fn, (src, vm, jnp.eye(4, dtype=jnp.float32))


def _rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("dense", [False, True], ids=["table", "dense"])
def test_entry_pose_matches_the_jax_hook(dense):
    jfn, jargs = _jax_hook(dense)
    jpose = np.asarray(jax.jit(jfn)(*jargs), np.float64)
    jres = jax.jit(jloam.scan2map)(*jargs)

    fn, args = tentry.entry(device="cpu", dense=dense)
    assert all(a.device.type == "cpu" for a in (args[0].xyz, args[2]))
    pose = fn(*args).numpy().astype(np.float64)
    res = tloam.scan2map(*args)

    assert np.isfinite(pose).all()
    dt = float(np.linalg.norm(pose[:3, 3] - jpose[:3, 3]))
    dr = _rot_angle(pose[:3, :3], jpose[:3, :3])
    print(f"entry hook ({'dense' if dense else 'table'}): port against the "
          f"JAX hook {dt:.3e} m, {dr:.3e} rad; iterations {int(res.iters)}, "
          f"gathers {int(res.n_gathers)}, n_valid {int(res.n_valid)}")
    assert dt < POSE_T_TOL, dt
    assert dr < POSE_R_TOL, dr
    assert bool(res.converged) == bool(jres.converged)
    assert int(res.iters) == int(jres.iters)
    assert int(res.n_gathers) == int(jres.n_gathers)
    assert int(res.n_valid) == int(jres.n_valid)
    # the hook registers something: the identity start is not the answer
    assert float(np.abs(pose[:3, 3]).max()) > 1e-3


def test_entry_fixture_is_the_reference_one_bit_for_bit():
    """The port's fixture draws the reference's numpy arrays, and both
    packages build the same clouds, table and dense map from them."""
    map_xyz, src_xyz = tentry.fixture_arrays()
    assert map_xyz.dtype == src_xyz.dtype == np.float32
    assert map_xyz.shape == (3 * 2048, 3) and src_xyz.shape == (256, 3)

    jsrc, jtable = graft._tiny_fixture()
    tsrc, ttable = tentry._tiny_fixture(device="cpu")
    np.testing.assert_array_equal(tsrc.xyz.numpy(), np.asarray(jsrc.xyz))
    np.testing.assert_array_equal(tsrc.xyz.numpy(), src_xyz)
    np.testing.assert_array_equal(tsrc.mask.numpy(), np.asarray(jsrc.mask))
    for name in ("keys", "slab", "counts", "origin", "grid"):
        np.testing.assert_array_equal(getattr(ttable, name).numpy(),
                                      np.asarray(getattr(jtable, name)))

    _, jdense = graft._tiny_fixture(dense=True)
    _, tdense = tentry._tiny_fixture(dense=True, device="cpu")
    assert tdense.dims == tuple(jdense.dims) == (16, 16, 8)
    lanes = 3 * tdense.slab_pts
    np.testing.assert_array_equal(tdense.slab.numpy(),
                                  np.asarray(jdense.slab)[:, :lanes])
    np.testing.assert_array_equal(tdense.counts.numpy(),
                                  np.asarray(jdense.counts))
    np.testing.assert_array_equal(tdense.corner.numpy(),
                                  np.asarray(jdense.corner))


def test_entry_defaults_to_the_card():
    """``entry()`` puts its tensors on ``cuda`` unless the caller asks for
    the CPU, as the config's ``torch.device`` does: without a card it
    raises, it never falls back to the CPU."""
    if torch.cuda.is_available():
        _, args = tentry.entry()
        assert args[0].xyz.is_cuda and args[2].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tentry.entry()
