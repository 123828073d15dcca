"""Unified mesh-aware dispatch: Plan.solve(inputs, mesh=m).

The reference selects its whole backend with one flag (Opt.h:23-25,
API/src/config.t:22); parallel/dispatch.py gives the multi-chip side the
same single entry point.  These tests pin the routing table (pure logic,
no solves) and end-to-end parity through Plan.solve for each route on
the 8-device CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import opt_tpu
from opt_tpu import energies
from opt_tpu.parallel.dispatch import pick_sharded_engine
from tests.test_halo_shard import _mesh1d, _plan, _single, _warp_inputs
from tests.test_solver_dense import arap_graph_energy, arap_inputs


def test_pick_small_grid_gspmd():
    plan = _plan(energies.image_warping, [40, 48])
    assert pick_sharded_engine(plan, _mesh1d()) == "gspmd"


@pytest.mark.parametrize("kind,dims", [
    ("gaussNewtonGPU", [2048, 8 * 2048]),
    ("LMGPU", [512, 8 * 512]),
    ("gaussNewtonGPU", [128, 64, 8 * 32]),
])
def test_pick_large_grid_gspmd(kind, dims):
    """Large grids and volumes route to GSPMD too: no size switches to a
    device-specific sharded engine."""
    energy = (energies.image_warping if len(dims) == 2
              else energies.ALL_ENERGIES["volumetric_mesh_deformation"])
    plan = _plan(energy, dims, kind)
    assert pick_sharded_engine(plan, _mesh1d()) == "gspmd"


def test_pick_2d_mesh_gspmd():
    from opt_tpu.parallel import mesh as pmesh

    m2 = pmesh.make_mesh(8, shape=(2, 4))
    plan = _plan(energies.image_warping, [2048, 8 * 2048])
    assert pick_sharded_engine(plan, m2) == "gspmd"


def test_pick_graph_gspmd():
    plan = _plan(arap_graph_energy, [16, 32])
    assert pick_sharded_engine(plan, _mesh1d()) == "gspmd"


def test_pick_aliases_and_vmem_rejection():
    plan = _plan(energies.image_warping, [128, 64])
    m = _mesh1d()
    assert pick_sharded_engine(plan, m) == "gspmd"
    assert pick_sharded_engine(plan, m, engine="xla") == "gspmd"
    assert pick_sharded_engine(plan, m, engine="gspmd") == "gspmd"
    assert pick_sharded_engine(plan, m, engine="halo") == "halo"
    with pytest.raises(ValueError, match="removed"):
        pick_sharded_engine(plan, m, engine="vmem")
    with pytest.raises(ValueError, match="unknown"):
        pick_sharded_engine(plan, m, engine="warpspeed")


@pytest.mark.parametrize(
    "engine", ["stream", "stream3d", "stream_hbm", "stream_shard"])
def test_pick_removed_sharded_engines(engine):
    plan = _plan(energies.image_warping, [128, 64])
    with pytest.raises(ValueError, match="removed"):
        pick_sharded_engine(plan, _mesh1d(), engine=engine)


def test_pick_env_override(monkeypatch):
    """The OPT_TPU_SHARD_ENGINE escape hatch is gone: the environment
    does not change the route."""
    monkeypatch.setenv("OPT_TPU_SHARD_ENGINE", "halo")
    plan = _plan(energies.image_warping, [128, 64])
    assert pick_sharded_engine(plan, _mesh1d()) == "gspmd"


def test_plan_solve_mesh_grid_parity():
    """plan.solve(inputs, mesh=m) on a small grid routes GSPMD and
    matches the single-device solve."""
    W, H = 40, 48
    inputs = _warp_inputs(W, H)
    ref = _single(energies.image_warping, [W, H], inputs)
    plan = _plan(energies.image_warping, [W, H])
    cost = plan.solve(inputs, mesh=_mesh1d())
    assert cost == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("engine", ["xla", "gspmd", "halo"])
def test_plan_solve_mesh_explicit_engines(engine):
    """Explicit engine selection through the unified entry: single-chip
    alias 'xla' -> GSPMD; 'halo' -> explicit ppermute."""
    W, H = 128, 64
    inputs = _warp_inputs(W, H)
    ref = _single(energies.image_warping, [W, H], inputs)
    plan = _plan(energies.image_warping, [W, H])
    cost = plan.solve(inputs, mesh=_mesh1d(), engine=engine)
    assert cost == pytest.approx(ref, rel=1e-5)


def test_plan_solve_mesh_graph_parity():
    N, E = 16, 32
    inputs = arap_inputs(N, seed=4)
    plan = _plan(arap_graph_energy, [N, E])
    plan.init(inputs)
    while plan.step():
        pass
    ref = plan.final_cost()

    plan2 = _plan(arap_graph_energy, [N, E])
    cost = plan2.solve(inputs, mesh=_mesh1d())
    assert cost == pytest.approx(ref, rel=1e-5)
