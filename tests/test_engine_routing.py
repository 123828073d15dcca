"""Single-device engine routing: every plan runs the fused XLA program.

engine= accepts "auto" and "xla"; the names of the removed device
engines raise instead of silently running something else, and the
graph engine's "auto" means take/segment_sum.
"""

import numpy as np
import pytest

import opt_tpu
from opt_tpu import energies
from opt_tpu.runtime.api import ENGINES, check_engine
from tests.test_solver_dense import warp_energy, warp_inputs


def _plan(energy, dims, kind="gaussNewtonGPU", **state_kwargs):
    state = opt_tpu.NewState(**state_kwargs)
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", 2)
    plan.set_solver_parameter("lIterations", 5)
    return plan


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_names_resolve_to_xla(engine):
    assert check_engine(engine) == "xla"


@pytest.mark.parametrize("engine", [
    "vmem", "stream_hbm", "stream3d", "stream", "pallas"])
def test_removed_engines_raise(engine):
    """At the sizes the removed engines used to take (LM 512^2), naming
    one fails before any data is bound."""
    plan = _plan(energies.image_warping, [512, 512], "LMGPU")
    with pytest.raises(ValueError, match="removed"):
        plan.solve({}, engine=engine)


def test_solve_paths_agree():
    """auto, xla and the host-stepped loop run the same program."""
    inputs = warp_inputs(7, 5, seed=8)
    plan = _plan(warp_energy, [7, 5])
    auto = plan.solve(inputs)
    assert plan.solve(inputs, engine="xla") == auto
    stepped = plan.solve(inputs, on_device=False)
    assert stepped == pytest.approx(auto, rel=1e-5)


def test_engine_env_var_ignored(monkeypatch):
    """The old OPT_TPU_ENGINE override is gone with its engines."""
    monkeypatch.setenv("OPT_TPU_ENGINE", "vmem")
    inputs = warp_inputs(7, 5, seed=8)
    assert np.isfinite(_plan(warp_energy, [7, 5]).solve(inputs))


def _band_graph(n=600, deg=6, band=20, seed=5):
    rng = np.random.RandomState(seed)
    v0 = np.repeat(np.arange(n), deg)
    v1 = np.clip(v0 + rng.randint(-band, band + 1, size=len(v0)), 0, n - 1)
    ur = rng.randn(n, 3).astype(np.float32)
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, 3), np.float32),
        "UrShape": ur, "Constraints": np.full((n, 3), -1e7, np.float32),
        "w_fitSqrt": 1.0, "w_regSqrt": 1.0, "G": {"v0": v0, "v1": v1},
    }


@pytest.mark.parametrize("mode,banded", [
    ("auto", False), ("take", False), ("banded", True)])
def test_graph_mode_auto_is_take(mode, banded):
    """A large, bandable graph binds take-mode indices unless the banded
    engine is asked for by name."""
    inputs = _band_graph()
    dims = [len(inputs["Offset"]), len(inputs["G"]["v0"])]
    plan = _plan(energies.arap_mesh_deformation, dims, graph_mode=mode)
    _, data = plan.bind(inputs)
    assert bool(data.get("graph_banding")) == banded
