"""End-to-end solver validation against the dense-matrix oracle.

The oracle (tests/oracle.py) materializes J with jax.jacfwd and re-runs the
reference algorithm in numpy; matching it validates linearize/transpose,
diag(J^T J), exclusion masking, the PCG loop, and LM trust-region logic.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import opt_tpu
from tests.oracle import oracle_step


def warp_energy(O):
    """Miniature image_warping (reference:
    examples/image_warping/image_warping.t): 2D ARAP with rotation,
    masks, exclusion, fit term."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    Offset = O.Unknown("Offset", O.opt_float2, (W, H), 0)
    Angle = O.Unknown("Angle", O.opt_float, (W, H), 1)
    UrShape = O.Array("UrShape", O.opt_float2, (W, H), 2)
    Constraints = O.Array("Constraints", O.opt_float2, (W, H), 3)
    Mask = O.Array("Mask", O.opt_float, (W, H), 4)
    w_fit = O.Param("w_fitSqrt", 5)
    w_reg = O.Param("w_regSqrt", 6)
    O.UsePreconditioner(True)
    O.Exclude(O.Not(O.eq(Mask(0, 0), 0)))
    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e_reg = w_reg * (
            (Offset(0, 0) - Offset(x, y))
            - O.Rotate2D(Angle(0, 0), UrShape(0, 0) - UrShape(x, y))
        )
        valid = O.InBounds(x, y) * O.eq(Mask(x, y), 0) * O.eq(Mask(0, 0), 0)
        O.Energy(O.Select(valid, e_reg, 0))
    e_fit = Offset(0, 0) - Constraints(0, 0)
    valid = O.All(O.greatereq(Constraints(0, 0), 0))
    O.Energy(w_fit * O.Select(valid, e_fit, 0.0))


def warp_inputs(W, H, seed=0):
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float64)
    cons = np.full((H, W, 2), -1.0)
    cons[0, 0] = ur[0, 0] + 0.5
    cons[H - 1, W - 1] = ur[H - 1, W - 1] - 0.3
    mask = np.zeros((H, W, 1))
    mask[H // 2, W // 2] = 1.0  # one excluded pixel
    return {
        "Offset": 0.1 * rng.randn(H, W, 2),
        "Angle": 0.05 * rng.randn(H, W, 1),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def arap_graph_energy(O):
    """Miniature arap_mesh_deformation (reference:
    examples/arap_mesh_deformation/arap_mesh_deformation.t)."""
    N = O.Dim("N", 0)
    E = O.Dim("E", 1)
    w_fit = O.Param("w_fitSqrt", 0)
    w_reg = O.Param("w_regSqrt", 1)
    Offset = O.Unknown("Offset", O.opt_float3, (N,), 2)
    Angle = O.Unknown("Angle", O.opt_float3, (N,), 3)
    UrShape = O.Array("UrShape", O.opt_float3, (N,), 4)
    Constraints = O.Array("Constraints", O.opt_float3, (N,), 5)
    G = O.Graph("G", (E,), "v0", (N,), 7, "v1", (N,), 8)
    O.UsePreconditioner(True)
    e_fit = Offset(0) - Constraints(0)
    valid = O.greatereq(Constraints(0)(0), -999999.9)
    O.Energy(O.Select(valid, w_fit * e_fit, 0))
    arap = (Offset(G.v0) - Offset(G.v1)) - O.Rotate3D(
        Angle(G.v0), UrShape(G.v0) - UrShape(G.v1)
    )
    O.Energy(w_reg * arap)


def arap_inputs(N, seed=3):
    rng = np.random.RandomState(seed)
    ur = rng.randn(N, 3)
    cons = np.full((N, 3), -1e7)
    cons[0] = ur[0] + 0.2
    cons[N - 1] = ur[N - 1] - 0.1
    # chain + one long edge, both directions
    v0 = list(range(N - 1)) + [0]
    v1 = list(range(1, N)) + [N - 1]
    return {
        "Offset": ur + 0.05 * rng.randn(N, 3),
        "Angle": 0.02 * rng.randn(N, 3),
        "UrShape": ur,
        "Constraints": cons,
        "w_fitSqrt": 1.3,
        "w_regSqrt": 0.8,
        "G": {"v0": np.array(v0 + v1), "v1": np.array(v1 + v0)},
    }


def run_compare(energy, inputs, dims, kind, n_steps, l_iters, rtol=1e-9,
                x_rtol=1e-7, **state_kwargs):
    """Step the plan (float64) and the dense oracle side by side; the
    oracle runs under the highest matmul precision."""
    state = opt_tpu.NewState(double_precision=True, verbosity=0,
                             **state_kwargs)
    problem = state.problem_define(energy, kind)
    plan = state.problem_plan(problem, dims)
    plan.set_solver_parameter("lIterations", l_iters)
    plan.set_solver_parameter("nIterations", n_steps)
    plan.init(inputs)

    # oracle side
    x, data = plan.bind(inputs)
    sp = {k: float(v) if k not in ("lIterations", "residual_reset_period",
                                   "nIterations") else int(v)
          for k, v in plan.solver_params.items()}
    prev_cost = float(plan.funcs.cost(x, data))
    assert prev_cost == pytest.approx(plan.final_cost(), rel=1e-12)

    radius = sp["trust_region_radius"]
    decrease_f = sp["radius_decrease_factor"]
    ssq = None
    for it in range(n_steps):
        with jax.default_matmul_precision("highest"):
            o = oracle_step(
                plan.funcs, x, data, sp, plan.config,
                prev_cost, radius, decrease_f, ssq, it,
            )
        x = o["x"]
        prev_cost = o["prev_cost"]
        radius = o["radius"]
        decrease_f = o["decrease_f"]
        ssq = o["ssq"]
        assert plan.step() in (0, 1)
        got = plan.final_cost()
        assert got == pytest.approx(prev_cost, rel=rtol), (
            f"outer iter {it}: plan cost {got} vs oracle {prev_cost}"
        )
        if o["done"]:
            break
    # unknowns match too
    for name, arr in plan.unknowns().items():
        np.testing.assert_allclose(
            arr, np.asarray(x[name]), rtol=x_rtol, atol=1e-9,
            err_msg=f"unknown {name} mismatch",
        )


def test_gn_warp_matches_dense_oracle():
    run_compare(warp_energy, warp_inputs(5, 4), [5, 4],
                "gaussNewtonGPU", n_steps=3, l_iters=7)


def test_lm_warp_matches_dense_oracle():
    run_compare(warp_energy, warp_inputs(5, 4, seed=7), [5, 4],
                "LMGPU", n_steps=4, l_iters=12)


def test_gn_graph_arap_matches_dense_oracle():
    run_compare(arap_graph_energy, arap_inputs(6), [6, 12],
                "gaussNewtonGPU", n_steps=3, l_iters=9)


def test_lm_graph_arap_matches_dense_oracle():
    run_compare(arap_graph_energy, arap_inputs(6, seed=11), [6, 12],
                "LMGPU", n_steps=4, l_iters=9)


def test_exclude_semantics_explicit():
    """Exclusion contract (o.t:3238-3241): excluded unknowns are frozen,
    and residual ROWS centered at excluded pixels are dropped from the
    COST (though their neighbors' stencil rows still reference them)."""
    import opt_tpu

    def energy(O):
        W, H = O.Dim("W", 0), O.Dim("H", 1)
        X = O.Unknown("X", O.opt_float, (W, H), 0)
        T = O.Array("T", O.opt_float, (W, H), 1)
        M = O.Array("M", O.opt_float, (W, H), 2)
        O.Exclude(O.Not(O.eq(M(0, 0), 0)))
        O.Energy(X(0, 0) - T(0, 0))

    W, H = 6, 5
    rng = np.random.RandomState(4)
    x0 = rng.rand(H, W, 1).astype(np.float32)
    t = rng.rand(H, W, 1).astype(np.float32)
    m = np.zeros((H, W, 1), np.float32)
    m[2, 3] = 1.0  # exclude one pixel

    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(energy, "gaussNewtonGPU"), [W, H])
    plan.set_solver_parameter("nIterations", 1)
    plan.set_solver_parameter("lIterations", 20)
    plan.init({"X": x0.copy(), "T": t, "M": m})
    init_cost = plan.current_cost()
    # cost drops the excluded row: 0.5 * sum over non-excluded pixels
    r = (x0 - t)[..., 0]
    r[2, 3] = 0.0
    assert init_cost == pytest.approx(0.5 * float((r ** 2).sum()), rel=1e-6)
    while plan.step():
        pass
    got = np.asarray(plan.unknowns()["X"])
    # excluded unknown frozen at its initial value
    assert got[2, 3, 0] == pytest.approx(float(x0[2, 3, 0]), abs=1e-7)
    # all other pixels solved to T exactly (pure fit term)
    mask = np.ones((H, W), bool)
    mask[2, 3] = False
    np.testing.assert_allclose(
        got[..., 0][mask], t[..., 0][mask], rtol=1e-5, atol=1e-6)
