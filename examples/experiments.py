"""Benchmark sweep driver.

The analogue of the reference's thesis experiment pipeline
(examples/exp00NN.py + myTimings/myInfos/outParse): sweeps problems over
{sizes} x {solver configurations} and writes a CSV of wall-clock and final
cost per cell.  Timing discipline: compile outside the timed reps, host
fetch of the final cost inside, min of reps.

Usage:
  python experiments.py [--reps 3] [--out results/sweep.csv]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402  (sets repo root on sys.path)

import jax.numpy as jnp  # noqa: E402
import opt_tpu  # noqa: E402
from opt_tpu import energies  # noqa: E402


def warp_inputs(W, H, seed=0):
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    cons[::20, :] = np.abs(rng.randn(H, W, 2).astype(np.float32))[::20, :]
    return {
        "Offset": np.zeros((H, W, 2), np.float32),
        "Angle": np.zeros((H, W, 1), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": np.zeros((H, W, 1), np.float32),
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def arap_inputs(N, E, seed=0):
    rng = np.random.RandomState(seed)
    i = np.arange(E)
    ur = rng.randn(N, 3).astype(np.float32)
    cons = np.full((N, 3), -1e7, np.float32)
    sel = rng.choice(N, max(10, N // 50), replace=False)
    cons[sel] = ur[sel] + 0.1
    return {
        "Offset": ur.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "w_fitSqrt": 2.0,
        "w_regSqrt": 1.0,
        "G": {"v0": i % N, "v1": (i * 7 + 1) % N},
    }


def time_solve(plan, x, data, sp, reps):
    st = plan._full_solve_fn(x, data, sp)
    cost = float(st["prev_cost"])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        st = plan._full_solve_fn(x, data, sp)
        _ = float(st["prev_cost"])
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), cost


def run_cell(energy, dims, inputs, kind, mode, n_outer, n_lin, reps):
    mat = mode in ("materialized", "fused")
    fused = mode == "fused"
    state = opt_tpu.NewState(
        use_materialized_jacobian=mat, use_fused_jtj=fused
    )
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_lin)
    x, data = plan.bind(inputs)
    sp = plan._sp_device()
    sp["nIterations"] = jnp.asarray(n_outer, jnp.int32)
    return time_solve(plan, x, data, sp, reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="results/sweep.csv")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes only")
    args = ap.parse_args()

    cells = []
    sizes = [64, 128, 256] if args.quick else [64, 128, 256, 512]
    for s in sizes:
        for mode in ("matfree", "materialized", "fused"):
            cells.append(
                ("image_warping", energies.image_warping, [s, s],
                 warp_inputs(s, s), "gaussNewtonGPU", mode, 8, 100)
            )
    for n in ([1000, 10000] if args.quick else [1000, 10000, 50000]):
        cells.append(
            ("arap", energies.arap_mesh_deformation, [n, 6 * n],
             arap_inputs(n, 6 * n), "gaussNewtonGPU", "matfree",
             8, 100)
        )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = ["problem,size,mode,kind,n_outer,n_linear,ms,final_cost"]
    for (name, energy, dims, inputs, kind, mode, n_o, n_l) in cells:
        try:
            ms, cost = run_cell(
                energy, dims, inputs, kind, mode, n_o, n_l, args.reps
            )
        except Exception as e:  # record failures, keep sweeping
            print(f"{name} {dims} {mode}: FAILED {e!r:.120}")
            ms, cost = None, None
        if ms is None:
            print(f"{name} {dims} {mode}: skipped")
            continue
        print(f"{name:14s} {str(dims):14s} {mode:12s} "
              f"{ms:9.1f} ms  cost={cost:.4g}")
        rows.append(
            f"{name},{dims[0]},{mode},{kind},{n_o},{n_l},{ms:.2f},{cost}"
        )
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
