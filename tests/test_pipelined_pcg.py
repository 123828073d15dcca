"""Pipelined PCG variant (Ghysels-Vanroose recurrences; PAPERS.md):
algebraically identical to classic PCG, so costs must match closely."""

import numpy as np
import pytest

import opt_tpu
from opt_tpu import energies
from tests.test_solver_dense import warp_energy, warp_inputs


def poisson_inputs(W, H, seed=0):
    """Poisson image editing with an interior free box (M != 0 means
    excluded)."""
    rng = np.random.RandomState(seed)
    base = (255 * rng.rand(H, W, 4)).astype(np.float32)
    base[..., 3] = 255.0
    target = (255 * rng.rand(H, W, 4)).astype(np.float32)
    target[..., 3] = 255.0
    m = np.full((H, W, 1), 255.0, np.float32)
    m[3 : H - 3, 4 : W - 4] = 0.0
    return {"X": base, "T": target, "M": m}


def run(energy, dims, inputs, variant, n, l):
    state = opt_tpu.NewState(pcg_variant=variant)
    plan = state.problem_plan(
        state.problem_define(energy, "gaussNewtonGPU"), dims
    )
    plan.set_solver_parameter("nIterations", n)
    plan.set_solver_parameter("lIterations", l)
    plan.init(inputs)
    while plan.step():
        pass
    return plan.final_cost()


def test_pipelined_matches_classic_linear():
    inputs = poisson_inputs(32, 20)
    c = run(energies.poisson_image_editing, [32, 20], inputs, "classic",
            1, 30)
    p = run(energies.poisson_image_editing, [32, 20], inputs, "pipelined",
            1, 30)
    assert p == pytest.approx(c, rel=1e-4)


def test_pipelined_matches_classic_nonlinear():
    inputs = warp_inputs(8, 6, seed=41)
    c = run(warp_energy, [8, 6], inputs, "classic", 3, 10)
    p = run(warp_energy, [8, 6], inputs, "pipelined", 3, 10)
    assert p == pytest.approx(c, rel=1e-3)
