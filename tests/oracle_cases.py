"""Seeded small inputs for every reference energy, and the dense-oracle
parity matrix run over them (tests/test_oracle_*.py).

The grid generators are tests/test_energies.py's; graph constraints pin
whole vertices (all three channels valid or none), and volumes start
near their rest shape, so every case is a well-posed least-squares
problem whose float64 trajectory the dense oracle can follow.
"""

import numpy as np
import pytest

from opt_tpu import energies
from tests.test_energies import grid_inputs
from tests.test_solver_dense import run_compare

W, H = 8, 6
N, E = 10, 24

GN, LM = "gaussNewtonGPU", "LMGPU"

MODES = {
    "matfree": {},
    "materialized": {"use_materialized_jacobian": True},
    "fused": {"use_materialized_jacobian": True, "use_fused_jtj": True},
    "pipelined": {"pcg_variant": "pipelined"},
}


def _graph_inputs(name, rng):
    v0 = rng.randint(0, N, size=E)
    v1 = (v0 + 1 + rng.randint(0, N - 3, size=E)) % N
    ur = rng.randn(N, 3)
    pinned = rng.rand(N, 1) > 0.6
    cons = np.where(pinned, ur + 0.3 * rng.randn(N, 3), -1e7)
    base = {"UrShape": ur, "Constraints": cons, "G": {"v0": v0, "v1": v1},
            "Offset": ur + 0.1 * rng.randn(N, 3)}
    if name == "arap_mesh_deformation":
        return {**base, "Angle": 0.05 * rng.randn(N, 3),
                "w_fitSqrt": 1.0, "w_regSqrt": 0.8}
    if name == "embedded_mesh_deformation":
        return {**base,
                "RotMatrix": np.tile(np.eye(3).reshape(9), (N, 1))
                + 0.01 * rng.randn(N, 9),
                "w_fitSqrt": 1.0, "w_regSqrt": 0.8, "w_rotSqrt": 0.5}
    if name == "robust_nonrigid_alignment":
        return {**base, "Angle": 0.05 * rng.randn(N, 3),
                "RobustWeights": rng.rand(N, 1),
                "ConstraintNormals": rng.randn(N, 3),
                "w_fitSqrt": 1.0, "w_regSqrt": 0.8}
    assert name == "cotangent_mesh_smoothing", name
    i = np.arange(E)
    return {"X": rng.randn(N, 3), "A": rng.randn(N, 3),
            "w_fit": 1.0, "w_reg": 0.9,
            "G": {"v0": i % N, "v1": (i + 1) % N, "v2": (i - 1) % N,
                  "v3": (i + 2) % N}}


def _volume_inputs(rng, D=3, Hv=4, Wv=5):
    kk, jj, ii = np.meshgrid(np.arange(D), np.arange(Hv), np.arange(Wv),
                             indexing="ij")
    grid = np.stack([ii, jj, kk], -1).astype(np.float64)
    cons = np.full_like(grid, -1e7)
    cons[:, 0] = grid[:, 0] + 0.2 * rng.randn(D, Wv, 3)
    return {"Offset": grid + 0.05 * rng.randn(*grid.shape),
            "Angle": 0.02 * rng.randn(*grid.shape),
            "UrShape": grid, "Constraints": cons,
            "w_fitSqrt": 1.0, "w_regSqrt": 0.8}


def case(name, seed=0):
    """(inputs, dims) of one energy at its small seeded size."""
    rng = np.random.RandomState(seed)
    if name == "volumetric_mesh_deformation":
        return _volume_inputs(rng), [5, 4, 3]
    grids = grid_inputs(W, H, rng)
    if name in grids:
        return grids[name](), [W, H]
    return _graph_inputs(name, rng), [N, E]


def matrix_params(modes, kinds=(GN, LM)):
    """pytest params: every energy x kind x mode (pipelined PCG is GN
    only -- LM's residual reset and Q-sequence are defined on the
    classic loop)."""
    return [
        pytest.param(name, kind, mode, id=f"{name}-{kind}-{mode}")
        for name in sorted(energies.ALL_ENERGIES)
        for kind in kinds
        for mode in modes
        if not (mode == "pipelined" and kind == LM)
    ]


def check(name, kind, mode):
    inputs, dims = case(name, seed=len(name))
    run_compare(energies.ALL_ENERGIES[name], inputs, dims, kind,
                n_steps=2, l_iters=6, **MODES[mode])
