"""Shared example-app infrastructure.

Python equivalents of the reference's C++ harness (reference:
examples/shared/): ArgParser flags (ArgParser.h:19-75), the
CombinedSolverBase solveAll structure (CombinedSolverBase.h:22-131),
launchProfiledSolve (OptUtils.h:47-64), and SolverIteration CSV recording
(SolverIteration.h:28-65).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def data_dir():
    """Reference datasets (override with OPT_TPU_DATA)."""
    return os.environ.get(
        "OPT_TPU_DATA", "/root/reference/examples/data"
    )


def data_path(name):
    return os.path.join(data_dir(), name)


def has_data():
    return os.path.isdir(data_dir())


def _apply_args_config(parser):
    """args.config fallback (ArgParser.h:60-69): key=value lines become
    defaults; explicit command-line flags take precedence."""
    path = os.path.join(os.getcwd(), "args.config")
    if not os.path.exists(path):
        return
    overrides = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            overrides[k] = v
    for action in parser._actions:
        if action.dest in overrides:
            v = overrides[action.dest]
            if action.type is not None:
                v = action.type(v)
            action.default = v


def make_arg_parser():
    """Flag set of the reference CLI (ArgParser.h:19-50)."""
    p = argparse.ArgumentParser()
    str2bool = lambda s: s.lower() in ("1", "true", "yes")
    p.add_argument("--backend", default="backend_cpu")
    p.add_argument("--numthreads", type=int, default=1)
    p.add_argument("--oIterations", type=int, default=1)
    p.add_argument("--nIterations", type=int, default=1)
    p.add_argument("--lIterations", type=int, default=1)
    p.add_argument("--useOpt", type=str2bool, nargs="?", const=True,
                   default=True)
    p.add_argument("--useOptLM", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--useCeres", type=str2bool, nargs="?", const=True,
                   default=False)
    # the reference's per-example hand-written CUDA solver slot
    # (CombinedSolverBase.h:67-81); parsed for CLI parity, no hand-written
    # solver is registered
    p.add_argument("--useCUDA", "--usePallas", dest="useCUDA",
                   type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--stride_x", type=int, default=1)
    p.add_argument("--stride_y", type=int, default=1)
    p.add_argument("--numvertices", type=int, default=-1)
    p.add_argument("--numSubdivides", type=int, default=0)
    p.add_argument("--useMaterializedJTJ", type=str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--useFusedJTJ", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--noOutput", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--file", type=int, default=1)
    p.add_argument("--double", type=str2bool, nargs="?", const=True,
                   default=False, help="double-precision unknowns")
    _apply_args_config(p)
    return p


class CombinedSolverParameters:
    """CombinedSolverParameters.h parity."""

    def __init__(self):
        self.useCUDA = False
        self.useOpt = True
        self.useOptLM = False
        self.useCeres = False
        self.earlyOut = False
        self.numIter = 1
        self.nonLinearIter = 3
        self.linearIter = 200
        self.profileSolve = True
        self.optDoublePrecision = False
        self.useMaterializedJTJ = False
        self.useFusedJTJ = False

    @classmethod
    def from_args(cls, args):
        p = cls()
        p.nonLinearIter = args.nIterations
        p.linearIter = args.lIterations
        p.numIter = args.oIterations
        p.useOpt = args.useOpt
        p.useOptLM = args.useOptLM
        p.useCeres = args.useCeres
        p.useCUDA = getattr(args, "useCUDA", False)
        p.useMaterializedJTJ = args.useMaterializedJTJ
        p.useFusedJTJ = args.useFusedJTJ
        p.optDoublePrecision = getattr(args, "double", False)
        return p


class SolverIteration:
    def __init__(self, cost, time_ms):
        self.cost = cost
        self.time_ms = time_ms


def save_solver_results(directory, suffix, iters_by_name,
                        double_precision=False):
    """CSV of per-iteration (cost, ms) per solver (SolverIteration.h:28-65)."""
    os.makedirs(directory, exist_ok=True)
    names = [n for n, it in iters_by_name.items() if it]
    if not names:
        return
    rows = max(len(iters_by_name[n]) for n in names)
    path = os.path.join(directory, f"results{suffix}.csv")
    with open(path, "w") as f:
        f.write(",".join(f"{n} cost,{n} ms" for n in names) + "\n")
        for i in range(rows):
            cells = []
            for n in names:
                it = iters_by_name[n]
                if i < len(it):
                    cells += [f"{it[i].cost:.16g}", f"{it[i].time_ms:.6f}"]
                else:
                    cells += ["", ""]
            f.write(",".join(cells) + "\n")
    return path


def report_final_costs(name, params, gn_cost, lm_cost, ceres_cost=None):
    """reportFinalCosts parity (SolverIteration.h:68-86)."""
    print(f"{name} final costs:")
    if params.useOpt:
        print(f"Opt(GN): {gn_cost}")
    if params.useOptLM:
        print(f"Opt(LM): {lm_cost}")
    if params.useCeres and ceres_cost is not None:
        print(f"Ceres: {ceres_cost}")


class CombinedSolver:
    """CombinedSolverBase.h parity: override the hooks, call solve_all().

    Subclasses set self.m_problemParams (dict name->array) in
    combined_solve_init and may mutate it in pre/post hooks; updated
    unknowns are written back after every solve (the reference mutates
    device buffers in place).
    """

    def __init__(self, params: CombinedSolverParameters, backend=None,
                 numthreads=1):
        import opt_tpu

        self.m_combinedSolverParameters = params
        self.m_problemParams = {}
        self.m_solverParams = {}
        self.m_solverInfo = []
        self.m_endSolveEarly = False
        self.state = opt_tpu.NewState(
            backend=backend,
            numthreads=numthreads,
            double_precision=params.optDoublePrecision,
            use_materialized_jacobian=params.useMaterializedJTJ,
            use_fused_jtj=params.useFusedJTJ,
            # profileSolve -> collectPerKernelTimingInfo (OptSolver.h:46-70)
            collect_kernel_timing=params.profileSolve,
        )

    # -- hooks ---------------------------------------------------------------
    def combined_solve_init(self):
        raise NotImplementedError

    def combined_solve_finalize(self):
        pass

    def pre_single_solve(self):
        pass

    def post_single_solve(self):
        pass

    def pre_nonlinear_solve(self, iteration):
        pass

    def post_nonlinear_solve(self, iteration):
        pass

    # -- registration ----------------------------------------------------------
    def add_opt_solvers(self, dims, energy):
        p = self.m_combinedSolverParameters
        if p.useOpt:
            self._add(dims, energy, "gaussNewtonGPU", "Opt(GN)")
        if p.useOptLM:
            self._add(dims, energy, "LMGPU", "Opt(LM)")
        if p.useCUDA:
            # the reference's hand-written CUDA solver slot
            # (CombinedSolverBase.h:67-81)
            print("useCUDA: no hand-written solver is registered; "
                  "Opt solvers only")
        if p.useCeres:
            # outside baseline in the Ceres role (CeresSolverBase parity):
            # generic scipy TRF/LSMR over the same residual program
            problem = self.state.problem_define(energy, "gaussNewtonGPU")
            plan = self.state.problem_plan(problem, dims)
            self.m_solverInfo.append(
                {"plan": plan, "name": "Ceres", "iters": [],
                 "baseline": True}
            )

    def _add(self, dims, energy, kind, name):
        problem = self.state.problem_define(energy, kind)
        plan = self.state.problem_plan(problem, dims)
        self.m_solverInfo.append(
            {"plan": plan, "name": name, "iters": []}
        )

    # -- driver -------------------------------------------------------------------
    def solve_all(self):
        self.combined_solve_init()
        for s in self.m_solverInfo:
            self._single_solve(s)
        self.combined_solve_finalize()

    def _single_solve(self, s):
        p = self.m_combinedSolverParameters
        self.pre_single_solve()
        for i in range(p.numIter):
            print(f"//////////// ITERATION {i}  ({s['name']}) ////////////")
            self.pre_nonlinear_solve(i)
            self._launch_profiled_solve(s)
            self.post_nonlinear_solve(i)
            if p.earlyOut or self.m_endSolveEarly:
                self.m_endSolveEarly = False
                break
        self.post_single_solve()

    def _launch_profiled_solve(self, s):
        """launchProfiledSolve parity (OptUtils.h:47-64): Init + Step loop,
        recording per-iteration (cost, ms)."""
        plan = s["plan"]
        p = self.m_combinedSolverParameters
        if s.get("baseline"):
            from opt_tpu.runtime.baseline import ScipyBaselineSolver

            t0 = time.perf_counter()
            out = ScipyBaselineSolver(plan).solve(
                self.m_problemParams, max_nfev=p.nonLinearIter * p.numIter
            )
            ms = (time.perf_counter() - t0) * 1e3
            s["iters"].append(SolverIteration(out["final_cost"], ms))
            s["final_cost"] = self.final_cost = out["final_cost"]
            print(f"final cost={out['final_cost']:.16f}")
            for n, v in out["x"].items():
                if n in self.m_problemParams:
                    self.m_problemParams[n] = v
            return
        plan.set_solver_parameter("nIterations", p.nonLinearIter)
        plan.set_solver_parameter("lIterations", p.linearIter)
        for k, v in self.m_solverParams.items():
            plan.set_solver_parameter(k, v)
        plan.init(self.m_problemParams)
        while True:
            t0 = time.perf_counter()
            more = plan.step()
            ms = (time.perf_counter() - t0) * 1e3
            if not more:
                break
            s["iters"].append(SolverIteration(plan.final_cost(), ms))
        self.final_cost = plan.final_cost()
        print(f"final cost={self.final_cost:.16f}")
        # write updated unknowns back (reference mutates buffers in place)
        for n, v in plan.unknowns().items():
            if n in self.m_problemParams:
                self.m_problemParams[n] = v
        s["final_cost"] = self.final_cost

    def get_cost(self, name):
        for s in self.m_solverInfo:
            if s["name"] == name:
                return s.get("final_cost", float("nan"))
        return float("nan")

    def get_iteration_info(self, name):
        for s in self.m_solverInfo:
            if s["name"] == name:
                return s["iters"]
        return []

    def ceres_iteration_comparison(self, name, double_precision=False):
        suffix = "_double" if double_precision else "_float"
        save_solver_results(
            "results/", suffix,
            {
                "Opt(GN)": self.get_iteration_info("Opt(GN)"),
                "Opt(LM)": self.get_iteration_info("Opt(LM)"),
                "Ceres": self.get_iteration_info("Ceres"),
            },
            double_precision,
        )
        report_final_costs(
            name, self.m_combinedSolverParameters,
            self.get_cost("Opt(GN)"), self.get_cost("Opt(LM)"),
            self.get_cost("Ceres"),
        )
