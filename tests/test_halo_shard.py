"""Explicit shard_map halo-exchange path vs GSPMD vs single device.

conftest forces an 8-device CPU mesh; the halo path (parallel/halo.py)
must agree with the automatically partitioned path and the single-device
solve at f32 tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import opt_tpu
from opt_tpu import energies
from opt_tpu.parallel import halo as phalo
from opt_tpu.parallel import mesh as pmesh


def _warp_inputs(W, H, seed=0):
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    cons[0, : W // 4] = ur[0, : W // 4] + 0.5
    cons[-1, -W // 4:] = ur[-1, -W // 4:] - 0.3
    return {
        "Offset": np.zeros((H, W, 2), np.float32),
        "Angle": np.zeros((H, W, 1), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": np.zeros((H, W, 1), np.float32),
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def _poisson_inputs(W, H, seed=1):
    rng = np.random.RandomState(seed)
    t0 = rng.rand(H, W, 4).astype(np.float32)
    t1 = rng.rand(H, W, 4).astype(np.float32)
    mask = np.ones((H, W, 1), np.float32)
    mask[H // 4: -H // 4, W // 4: -W // 4] = 0
    return {"X": t0.copy(), "T": t1, "M": mask}


def _mesh1d():
    devs = np.array(jax.devices()[:8])
    return jax.sharding.Mesh(devs, ("shard",))


def _plan(energy, dims, kind="gaussNewtonGPU"):
    state = opt_tpu.NewState()
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 15)
    return plan


def _single(energy, dims, inputs, kind="gaussNewtonGPU"):
    plan = _plan(energy, dims, kind)
    x, data = plan.bind(inputs)
    sp = plan._sp_device()
    sp["nIterations"] = jnp.asarray(2, jnp.int32)
    st = plan._full_solve_fn(x, data, sp)
    return float(st["prev_cost"])


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_halo_matches_single_and_gspmd_image_warping(kind):
    W, H = 40, 48  # 6 rows/device, radius 1 -> halo 2
    inputs = _warp_inputs(W, H)
    mesh = _mesh1d()
    ref = _single(energies.image_warping, [W, H], inputs, kind)
    halo_cost = phalo.solve_sharded_halo(
        _plan(energies.image_warping, [W, H], kind), inputs, mesh)
    gspmd_cost = pmesh.solve_sharded(
        _plan(energies.image_warping, [W, H], kind), inputs, mesh)
    assert halo_cost == pytest.approx(ref, rel=2e-5), (halo_cost, ref)
    assert halo_cost == pytest.approx(gspmd_cost, rel=2e-5)


def test_halo_matches_single_poisson_exclude():
    """Exclude() masks + UsePreconditioner(False) through the halo path."""
    W, H = 32, 48
    inputs = _poisson_inputs(W, H)
    mesh = _mesh1d()
    ref = _single(energies.poisson_image_editing, [W, H], inputs)
    halo_cost = phalo.solve_sharded_halo(
        _plan(energies.poisson_image_editing, [W, H]), inputs, mesh)
    assert halo_cost == pytest.approx(ref, rel=2e-5), (halo_cost, ref)


def test_halo_unknowns_match_single():
    """Not just the cost: the solved unknowns agree rowwise."""
    W, H = 40, 48
    inputs = _warp_inputs(W, H)
    mesh = _mesh1d()
    p1 = _plan(energies.image_warping, [W, H])
    x, data = p1.bind(inputs)
    sp = p1._sp_device()
    sp["nIterations"] = jnp.asarray(2, jnp.int32)
    st = p1._full_solve_fn(x, data, sp)
    x_ref = np.asarray(st["x"]["Offset"])

    p2 = _plan(energies.image_warping, [W, H])
    phalo.solve_sharded_halo(p2, inputs, mesh)
    x_halo = np.asarray(p2._state["x"]["Offset"])
    np.testing.assert_allclose(x_halo, x_ref, rtol=2e-4, atol=2e-5)


def test_halo_rejects_sampled_image():
    W, H = 32, 48
    mesh = _mesh1d()
    plan = _plan(energies.optical_flow, [W, H])
    with pytest.raises(AssertionError, match="SampledImage"):
        phalo.make_halo_solver(plan, mesh)
