"""Many-iteration example runs (reference: examples/test_example_output.py):
exercise realistic iteration counts, multi-outer constraint interpolation,
and the LM solver on real example data.  Catches paths the tiny golden
configs never reach.  Gated behind OPT_TPU_RUN_SLOW (several minutes).
"""

import os
import sys

import numpy as np
import pytest

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"
)
sys.path.insert(0, EXAMPLES_DIR)

import common  # noqa: E402

pytestmark = [
    pytest.mark.skipif(
        not common.has_data(), reason="reference datasets not available"
    ),
    pytest.mark.skipif(
        not os.environ.get("OPT_TPU_RUN_SLOW"),
        reason="slow full-output runs; set OPT_TPU_RUN_SLOW=1",
    ),
]


def _run(name, argv):
    mod = __import__(name)
    return mod.run(argv + ["--noOutput", "true"])


def test_image_warping_lm_full():
    s = _run(
        "image_warping",
        ["--useOpt", "false", "--useOptLM", "true", "--stride", "4",
         "--nIterations", "4", "--lIterations", "40"],
    )
    assert np.isfinite(s.get_cost("Opt(LM)"))


def test_image_warping_multi_outer():
    # oIterations > 1 drives constraint re-interpolation (alpha schedule)
    s = _run(
        "image_warping",
        ["--stride", "4", "--oIterations", "3", "--nIterations", "2",
         "--lIterations", "20"],
    )
    assert np.isfinite(s.get_cost("Opt(GN)"))


def test_optical_flow_both_levels_many_iters():
    s = _run(
        "optical_flow",
        ["--stride", "8", "--nIterations", "2", "--lIterations", "30"],
    )
    assert np.isfinite(s.get_cost("Opt(GN)"))
    assert np.isfinite(s.first_solve_cost)


def test_arap_lm_many_iters():
    s = _run(
        "arap_mesh_deformation",
        ["--useOpt", "false", "--useOptLM", "true", "--nIterations", "5",
         "--lIterations", "30"],
    )
    assert np.isfinite(s.get_cost("Opt(LM)"))


def test_shape_from_shading_lm():
    s = _run(
        "shape_from_shading",
        ["--useOpt", "false", "--useOptLM", "true", "--nIterations", "3",
         "--lIterations", "20"],
    )
    assert np.isfinite(s.get_cost("Opt(LM)"))


def test_volumetric_many_iters_decreases():
    s = _run(
        "volumetric_mesh_deformation",
        ["--nIterations", "5", "--lIterations", "30"],
    )
    c = s.get_cost("Opt(GN)")
    assert np.isfinite(c) and c < 189.74081  # below the (1,1,1) golden


def test_poisson_cuda_solver_slot():
    """--useCUDA is parsed for CLI parity with the reference's
    per-example CUDA-solver slot (CombinedSolverBase.h:67-81) but
    registers no hand-written solver: only Opt(GN) runs."""
    solver = _run("poisson_image_editing",
                  ["--stride", "4", "--useCUDA", "true"])
    assert [s["name"] for s in solver.m_solverInfo] == ["Opt(GN)"]
    assert np.isfinite(solver.get_cost("Opt(GN)"))
