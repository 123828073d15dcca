"""Batched multi-problem solve (Plan.solve_many): N independent problem
instances in ONE vmapped dispatch, optionally data-parallel over a mesh.

Contract: each lane's final cost matches solving that instance alone at
f32 tolerance -- including LM, whose per-lane early exits must keep
single-problem semantics under vmap's while_loop masking.
"""

import numpy as np
import pytest

import opt_tpu
from tests.test_solver_dense import warp_energy, warp_inputs


def _solo_costs(kind, inputs_list, W, H, n, l):
    costs = []
    for inp in inputs_list:
        state = opt_tpu.NewState()
        plan = state.problem_plan(
            state.problem_define(warp_energy, kind), [W, H]
        )
        plan.set_solver_parameter("nIterations", n)
        plan.set_solver_parameter("lIterations", l)
        costs.append(plan.solve(inp))
    return costs


@pytest.mark.parametrize("kind,n,l", [
    ("gaussNewtonGPU", 3, 7),
    ("LMGPU", 6, 5),     # long enough that lanes exit at different iters
])
def test_solve_many_matches_solo(kind, n, l):
    W, H = 9, 7
    inputs_list = [warp_inputs(W, H, seed=s) for s in (0, 1, 2)]
    # make lane 1 converge much earlier (LM: exercises per-lane done)
    inputs_list[1]["Offset"] = 1e-4 * inputs_list[1]["Offset"]
    inputs_list[1]["Angle"] = 1e-4 * inputs_list[1]["Angle"]
    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(warp_energy, kind), [W, H]
    )
    plan.set_solver_parameter("nIterations", n)
    plan.set_solver_parameter("lIterations", l)
    costs = plan.solve_many(inputs_list)
    solo = _solo_costs(kind, inputs_list, W, H, n, l)
    np.testing.assert_allclose(costs, solo, rtol=2e-5)
    # batched unknowns are retrievable per lane and finite
    x0 = plan.batch_unknowns(0)
    assert set(x0) == {"Offset", "Angle"}
    assert all(np.isfinite(v).all() for v in x0.values())


def test_solve_many_sharded_mesh():
    """Data-parallel serving: batch axis sharded over the 8-device CPU
    mesh; parity with the unsharded batch."""
    from opt_tpu.parallel import mesh as pmesh

    W, H = 9, 7
    inputs_list = [warp_inputs(W, H, seed=s) for s in range(8)]
    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(warp_energy, "gaussNewtonGPU"), [W, H]
    )
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 6)
    m = pmesh.make_mesh(8)
    costs = plan.solve_many(inputs_list, mesh=m)
    solo = _solo_costs("gaussNewtonGPU", inputs_list, W, H, 2, 6)
    np.testing.assert_allclose(costs, solo, rtol=2e-5)


def test_solve_many_rejects_bad_batch():
    from opt_tpu.parallel import mesh as pmesh

    W, H = 9, 7
    plan2 = opt_tpu.NewState().problem_plan(
        opt_tpu.NewState().problem_define(warp_energy, "gaussNewtonGPU"),
        [W, H],
    )
    with pytest.raises(ValueError):
        plan2.solve_many(
            [warp_inputs(W, H, seed=s) for s in range(3)],
            mesh=pmesh.make_mesh(8),
        )
    with pytest.raises(ValueError, match="mode"):
        plan2.solve_many([warp_inputs(W, H)], mode="warp9")


def test_solve_many_graphs_take_mode():
    """Graph batches vmap in take-mode -- lanes may even have DIFFERENT
    edge topologies (per-lane graph_indices are batched data)."""
    from tests.test_solver_dense import arap_graph_energy, arap_inputs

    N, E = 6, 12
    inputs_list = [arap_inputs(N, seed=s) for s in (0, 1, 2)]
    # give lane 2 a different topology: reverse its edge list
    g2 = dict(inputs_list[2]["G"])
    g2["v0"], g2["v1"] = g2["v1"], g2["v0"]
    inputs_list[2] = {**inputs_list[2], "G": g2}

    solo = []
    for inp in inputs_list:
        st = opt_tpu.NewState()
        p = st.problem_plan(
            st.problem_define(arap_graph_energy, "gaussNewtonGPU"),
            [N, E])
        p.set_solver_parameter("nIterations", 3)
        p.set_solver_parameter("lIterations", 7)
        solo.append(p.solve(inp, engine="xla"))

    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(arap_graph_energy, "gaussNewtonGPU"),
        [N, E])
    plan.set_solver_parameter("nIterations", 3)
    plan.set_solver_parameter("lIterations", 7)
    costs = plan.solve_many(inputs_list)
    np.testing.assert_allclose(costs, solo, rtol=2e-5)


def test_solve_many_auto_guardrail(monkeypatch):
    """auto mode must route batches past SOLVE_MANY_AUTO_MAX_PIXELS
    (batch x pixels) to the sequential solo loop -- same costs, same
    _batched_state contract; mode='batched' forces the vmap path."""
    import opt_tpu.runtime.api as api

    W, H = 9, 7
    inputs_list = [warp_inputs(W, H, seed=s) for s in (0, 1, 2)]
    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(warp_energy, "gaussNewtonGPU"), [W, H]
    )
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 6)
    batched = plan.solve_many(inputs_list, mode="batched")

    # shrink the guardrail so this tiny batch trips it
    monkeypatch.setattr(api, "SOLVE_MANY_AUTO_MAX_PIXELS", W * H * 2)
    assert getattr(plan, "_solve_many_fn", None) is not None
    plan._solve_many_fn = None  # auto must NOT need the vmapped program
    routed = plan.solve_many(inputs_list)  # auto -> solo
    assert plan._solve_many_fn is None, "auto did not route to solo"
    np.testing.assert_allclose(routed, batched, rtol=2e-5)
    x0 = plan.batch_unknowns(0)
    assert set(x0) == {"Offset", "Angle"}


def test_solve_many_mesh_guardrail_per_device(monkeypatch):
    """With a mesh the guardrail applies to the PER-DEVICE share
    (the solve_many docstring's contract):
    a batch over the threshold in total but under it per device stays
    on the batched path; one over it even per device routes to solo."""
    import opt_tpu.runtime.api as api
    from opt_tpu.parallel import mesh as pmesh

    W, H = 9, 7
    inputs_list = [warp_inputs(W, H, seed=s) for s in range(8)]
    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(warp_energy, "gaussNewtonGPU"), [W, H]
    )
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 6)
    m = pmesh.make_mesh(8)

    # threshold fits 2 problems per device: 8 problems total would trip
    # an unsharded guardrail, but over 8 devices it's 1/lane -> batched
    monkeypatch.setattr(api, "SOLVE_MANY_AUTO_MAX_PIXELS", W * H * 2)
    plan._solve_many_fn = None
    costs = plan.solve_many(inputs_list, mesh=m)
    assert plan._solve_many_fn is not None, (
        "per-device share under threshold must stay batched")
    solo = _solo_costs("gaussNewtonGPU", inputs_list, W, H, 2, 6)
    np.testing.assert_allclose(costs, solo, rtol=2e-5)

    # threshold under ONE problem per device: even sharded, route solo
    monkeypatch.setattr(api, "SOLVE_MANY_AUTO_MAX_PIXELS", W * H - 1)
    plan._solve_many_fn = None
    routed = plan.solve_many(inputs_list, mesh=m)
    assert plan._solve_many_fn is None, (
        "oversized per-device share must route to solo")
    np.testing.assert_allclose(routed, solo, rtol=2e-5)
