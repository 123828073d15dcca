"""API-surface tests: exec-style energy files, double precision,
timing-report contract, CamelCase parity aliases."""

import os

import numpy as np
import pytest

import opt_tpu


ENERGY_FILE_SRC = '''
# exec-style energy: reference .t files port to this form by dropping
# the `local` keywords (problemSpecFromFile parity)
W, H = Dim("W", 0), Dim("H", 1)
X = Unknown("X", opt_float2, (W, H), 0)
A = Array("A", opt_float2, (W, H), 1)
w = Param("w", float, 2)
UsePreconditioner(True)
for x, y in Stencil([(1, 0), (0, 1)]):
    Energy(Select(InBounds(x, y), w * (X(0, 0) - X(x, y)), 0))
Energy(X(0, 0) - A(0, 0))
'''


def _inputs(W, H, rng):
    return {
        "X": rng.randn(H, W, 2),
        "A": rng.randn(H, W, 2),
        "w": 0.5,
    }


def test_energy_from_file(tmp_path):
    path = tmp_path / "my_energy.py"
    path.write_text(ENERGY_FILE_SRC)
    rng = np.random.RandomState(0)
    state = opt_tpu.NewState()
    plan = state.ProblemPlan(
        state.ProblemDefine(str(path), "gaussNewtonGPU"), [6, 5]
    )
    plan.SetSolverParameter("nIterations", 2)
    plan.SetSolverParameter("lIterations", 5)
    plan.Init(_inputs(6, 5, rng))
    c0 = plan.final_cost()
    while plan.Step():
        pass
    assert plan.final_cost() < c0
    assert np.isfinite(plan.CurrentCost())


def test_double_precision_matches_float_loosely():
    from tests.test_solver_dense import warp_energy, warp_inputs

    inputs = warp_inputs(6, 5, seed=12)
    costs = {}
    for dbl in (False, True):
        state = opt_tpu.NewState(double_precision=dbl)
        plan = state.problem_plan(
            state.problem_define(warp_energy, "gaussNewtonGPU"), [6, 5]
        )
        plan.set_solver_parameter("nIterations", 2)
        plan.set_solver_parameter("lIterations", 5)
        plan.init(inputs)
        while plan.step():
            pass
        costs[dbl] = plan.final_cost()
        assert plan.unknowns()["Offset"].dtype == (
            np.float64 if dbl else np.float32
        )
    assert costs[True] == pytest.approx(costs[False], rel=1e-4)


def test_timing_report_contract(capsys):
    """Per-kernel table + TIMING line (backend_cpu.t:245-312 contract)."""
    from tests.test_solver_dense import warp_energy, warp_inputs

    state = opt_tpu.NewState(collect_kernel_timing=True, verbosity=1)
    plan = state.problem_plan(
        state.problem_define(warp_energy, "gaussNewtonGPU"), [6, 5]
    )
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 3)
    plan.init(warp_inputs(6, 5, seed=1))
    while plan.step():
        pass
    out = capsys.readouterr().out
    assert "final cost=" in out
    assert "Kernel" in out and "Count" in out and "Average" in out
    assert "TIMING " in out
    assert "step_0" in out and "step_1" in out


def test_checkpoint_resume(tmp_path):
    """Solver state round-trips through .npz; resumed steps match an
    uninterrupted run exactly."""
    from tests.test_solver_dense import warp_energy, warp_inputs

    inputs = warp_inputs(6, 5, seed=20)

    def make_plan():
        state = opt_tpu.NewState()
        plan = state.problem_plan(
            state.problem_define(warp_energy, "LMGPU"), [6, 5]
        )
        plan.set_solver_parameter("nIterations", 4)
        plan.set_solver_parameter("lIterations", 5)
        return plan

    ref = make_plan()
    ref.init(inputs)
    for _ in range(4):
        ref.step()
    want = ref.final_cost()

    a = make_plan()
    a.init(inputs)
    a.step()
    a.step()
    ckpt = tmp_path / "solve.npz"
    a.save_state(ckpt)

    b = make_plan()
    b.init(inputs)  # binds data
    b.load_state(ckpt)
    b.step()
    b.step()
    assert b.final_cost() == pytest.approx(want, rel=1e-7)


def test_print_allocation_info():
    """printAllocationInfo parity (o.t:375-405): per-param bytes, alias
    lines, graph index bytes, work-vector footprint."""
    import opt_tpu
    from opt_tpu import energies

    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(energies.intrinsic_image_decomposition,
                             "gaussNewtonGPU"), [16, 12])
    lines = []
    total = plan.print_allocation_info(out=lines.append)
    text = "\n".join(lines)
    assert "Param r needs 2304 bytes" in text
    assert "r_const aliases r" in text
    assert f"total usage of ProblemParameters is {total} bytes" in text
    assert "6 x" in text  # GN keeps 6 work vectors

    plan_lm = state.problem_plan(
        state.problem_define(energies.arap_mesh_deformation, "LMGPU"),
        [10, 24])
    lines = []
    plan_lm.print_allocation_info(out=lines.append)
    text = "\n".join(lines)
    assert "Param G needs 192 bytes (24 edges x 2 index arrays)" in text
    assert "8 x" in text  # LM keeps 8


def test_set_niter_resumes_solve():
    """nIter is the 13th settable SolverParameters entry
    (solverGPUGaussNewton.t:186-201): resetting the live counter runs
    extra nonlinear iterations on a finished plan."""
    import opt_tpu

    def energy(O):
        W, H = O.Dim("W", 0), O.Dim("H", 1)
        X = O.Unknown("X", O.opt_float, (W, H), 0)
        T = O.Array("T", O.opt_float, (W, H), 1)
        O.Energy(0.1 * (X(0, 0) * X(0, 0) * X(0, 0) - T(0, 0)))
        for x, y in O.Stencil([(1, 0), (0, 1)]):
            O.Energy(O.Select(O.InBounds(x, y), X(0, 0) - X(x, y), 0))

    rng = np.random.RandomState(2)
    inputs = {"X": 1 + rng.rand(8, 10, 1).astype(np.float32),
              "T": rng.rand(8, 10, 1).astype(np.float32)}
    state = opt_tpu.NewState()
    plan = state.problem_plan(
        state.problem_define(energy, "gaussNewtonGPU"), [10, 8])
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 5)
    with pytest.raises(RuntimeError):
        plan.set_solver_parameter("nIter", 0)  # only live after init
    plan.init(inputs)
    while plan.step():
        pass
    c2 = plan.final_cost()
    plan.set_solver_parameter("nIter", 0)
    steps = 0
    while plan.step():
        steps += 1
    assert steps == 2
    assert plan.final_cost() < c2


def test_public_api_surface_stability():
    """Pin the Opt.h-parity public surface (Opt.h:3-76): top-level names
    and the lifecycle methods apps depend on."""
    import opt_tpu

    for name in ("NewState", "OptState", "Problem", "Plan",
                 "SolverConfig", "SOLVER_PARAMETER_DEFAULTS", "EnergyEnv",
                 "ProblemSpec"):
        assert hasattr(opt_tpu, name), name

    state_methods = ("problem_define", "problem_plan", "problem_delete")
    for m in state_methods:
        assert callable(getattr(opt_tpu.OptState, m)), m

    plan_methods = (
        "init", "step", "Step", "solve", "set_solver_parameter",
        "SetSolverParameter", "current_cost", "final_cost", "unknowns",
        "bind", "save_state", "load_state", "print_allocation_info",
        "free",
    )
    for m in plan_methods:
        assert callable(getattr(opt_tpu.Plan, m)), m


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_compilation_cache(env_set, tmp_path, monkeypatch):
    """The one compile-cache rule: with JAX_COMPILATION_CACHE_DIR set,
    JAX's own setting stands and OptState sets no directory; without it
    the cache goes to a fixed path in the checkout (never a temporary
    name)."""
    import jax
    from opt_tpu.runtime import api

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "xla_cache"))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        opt_tpu.NewState()
        got = jax.config.jax_compilation_cache_dir
        if env_set:
            assert got is None
        else:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert got == api.DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_removed_state_options_rejected():
    """The removed device-specific OptState options raise instead of
    being silently ignored."""
    for kw in ("use_pallas", "plane_mode", "compilation_cache_dir"):
        with pytest.raises(TypeError):
            opt_tpu.NewState(**{kw: True})
