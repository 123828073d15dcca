"""Golden final-cost parity suite.

The analogue of the reference's primary harness (reference:
examples/test_final_cost.py): run every example at the reference's tiny
configuration (defaults: oIterations=nIterations=lIterations=1, documented
strides) and compare 'final cost' to the CUDA-derived golden values at
rtol 1e-5 (test_final_cost.py:122).

Where the reference's backend x threads x materialization matrix checked
cross-backend consistency, the analogue here is float32 vs float64 and
(in test_sharding.py) single- vs multi-device consistency.

Two reference goldens are NOT reproducible and are locked to self-measured
values instead:
 * poisson_image_editing: the reference main.cpp double-strides an
   already-strided mask, reading out of bounds (heap garbage) for stride>1
   (examples/poisson_image_editing/src/main.cpp:88-97, mLib asserts
   disabled);
 * intrinsic_image_decomposition: the published golden equals the INITIAL
   cost (verified independently: init 3.31054e6 vs golden 3.31053e6); a
   correct GN step reduces it to ~1.22e6 (the checked-in fork cannot even
   complete a step -- unconditional C.exit(0) mid-step,
   API/src/solverGPUGaussNewton.t:2069-2070).
robust_nonrigid_alignment's golden is flaky in the reference itself
(test_final_cost.py:41-43) and depends on libstdc++ RNG internals; it is
exercised in a gated slow test.
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

pytestmark = pytest.mark.skipif(
    not common.has_data(), reason="reference datasets not available"
)

RTOL = 1e-5

# (module, argv, golden, source-of-golden)
GOLDEN_CASES = {
    "image_warping": ([], 1774.3405, "reference CUDA"),
    "arap_mesh_deformation": ([], 7183.464843, "reference CUDA"),
    "cotangent_mesh_smoothing": ([], 2091.86303, "reference CUDA"),
    "embedded_mesh_deformation": ([], 0.367129057645, "reference CUDA"),
    "volumetric_mesh_deformation": ([], 189.74081, "reference CUDA"),
    # self-goldens (see module docstring):
    "poisson_image_editing": (["--stride", "4"], 2975554.25, "self"),
    "intrinsic_image_decomposition": (["--stride", "12"], 1225761.25,
                                      "self"),
}


def _run(name, argv):
    mod = __import__(name)
    return mod.run(argv + ["--noOutput", "true"])


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_cost(name):
    argv, golden, _src = GOLDEN_CASES[name]
    solver = _run(name, list(argv))
    got = solver.get_cost("Opt(GN)")
    rel = abs(got - golden) / abs(golden)
    assert rel < RTOL, f"{name}: final cost {got} vs golden {golden} " \
                       f"(rel err {rel:.3g})"


def test_golden_optical_flow_first_level():
    """Golden is the FIRST (coarse) level's final cost
    (test_final_cost.py:63)."""
    solver = _run("optical_flow", ["--stride", "16"])
    golden = 0.52119255
    rel = abs(solver.first_solve_cost - golden) / golden
    assert rel < RTOL, f"optical_flow: {solver.first_solve_cost} vs {golden}"


def test_shape_from_shading_runs():
    """No reference golden (-1 placeholder); lock a self-golden."""
    solver = _run("shape_from_shading", [])
    got = solver.get_cost("Opt(GN)")
    assert np.isfinite(got)
    golden = 109.12959289550781  # self-measured regression value
    assert abs(got - golden) / golden < 1e-4


def test_robust_nonrigid_alignment_self_golden():
    """Deterministic self-golden: the spurious-correspondence RNG is
    pinned (MT19937(230948), robust_nonrigid_alignment.py:96), so the
    first solve is reproducible at rtol 1e-5 even though the REFERENCE
    golden is flaky (libstdc++ RNG internals, test_final_cost.py:41-43).
    The gated slow test below keeps the ~10% check against the reference
    value."""
    import robust_nonrigid_alignment as R

    solver = R.run(["--noOutput", "true"], max_targets=1)
    golden = 65.11915588378906  # self-measured, pinned RNG
    rel = abs(solver.first_solve_cost - golden) / golden
    assert rel < RTOL, f"robust self-golden: {solver.first_solve_cost} " \
                       f"vs {golden} (rel {rel:.3g})"


@pytest.mark.skipif(
    not os.environ.get("OPT_TPU_RUN_SLOW"),
    reason="slow; flaky golden in the reference itself",
)
def test_robust_nonrigid_alignment_runs():
    import robust_nonrigid_alignment as R

    solver = R.run(["--noOutput", "true"], max_targets=1)
    assert np.isfinite(solver.first_solve_cost)
    # reference flaky golden 66.784683; RNG-dependent, ~2% agreement seen
    assert abs(solver.first_solve_cost - 66.784683) / 66.784683 < 0.1


def test_golden_image_warping_double_precision():
    """float64 unknowns must land on the same golden at the float32
    tolerance (Opt.h:14 double-precision switch parity)."""
    mod = __import__("image_warping")
    solver = mod.run(["--noOutput", "true", "--double", "true"])
    got = solver.get_cost("Opt(GN)")
    rel = abs(got - 1774.3405) / 1774.3405
    assert rel < 1e-5, f"double-precision image_warping: {got} (rel {rel})"


LM_SELF_GOLDENS = {
    # LM at the golden configs (the reference's golden matrix is GN-only);
    # self-measured regression values, cross-checked float32 CPU
    "image_warping": ([], 1774.36279296875),
    "arap_mesh_deformation": ([], 6975.05419921875),
}


@pytest.mark.parametrize("name", sorted(LM_SELF_GOLDENS))
def test_lm_self_golden(name):
    argv, golden = LM_SELF_GOLDENS[name]
    mod = __import__(name)
    solver = mod.run(
        list(argv) + ["--useOpt", "false", "--useOptLM", "true",
                      "--noOutput", "true"]
    )
    got = solver.get_cost("Opt(LM)")
    assert abs(got - golden) / abs(golden) < 1e-5, (name, got, golden)


def test_golden_arap_double_precision():
    """float64 unknowns on the GRAPH path must land on the same golden
    (Opt.h:14 double-precision switch; grid path covered above)."""
    mod = __import__("arap_mesh_deformation")
    solver = mod.run(["--noOutput", "true", "--double", "true"])
    got = solver.get_cost("Opt(GN)")
    rel = abs(got - 7183.464843) / 7183.464843
    assert rel < 1e-5, f"double-precision arap: {got} (rel {rel})"


@pytest.mark.parametrize(
    "name", ["arap_mesh_deformation", "cotangent_mesh_smoothing"]
)
def test_golden_banded_graph_engine(name, monkeypatch):
    """Graph goldens through the banded one-hot gather/scatter engine
    (ops/graph_banded.py), forced on despite the small test meshes: the
    banded path must satisfy the same reference-CUDA golden contract as
    take/segment_sum."""
    monkeypatch.setenv("OPT_TPU_GRAPH_MODE", "banded")
    argv, golden, _src = GOLDEN_CASES[name]
    solver = _run(name, list(argv))
    got = solver.get_cost("Opt(GN)")
    rel = abs(got - golden) / abs(golden)
    assert rel < RTOL, f"{name} banded: {got} vs {golden} (rel {rel:.3g})"
