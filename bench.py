"""Benchmark: image_warping at 512x512 (the reference's canonical perf
config, BASELINE.md: cat512, nonLinearIter=8, linearIter=400) through
Plan.solve on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "ms", "device": {...}, "card": ...}

value: wall-clock ms of Plan.solve for the full solve (8 GN outer
iterations x 400 PCG iterations, matrix-free, one fused XLA program),
inputs already on the device, after one compiling call; the final-cost
fetch to the host is inside the timed window.  "card" is the name and
power limit nvidia-smi reports, since a card set below its maximum
power runs slower.

Auxiliary lines on stderr: arap 10k vertices, SFS (when the reference
dataset is present), image_warping 2048^2 GN and LM, volumetric 128^3,
and solve_many 128^2 x 64 batched against the solo loop.

Needs a GPU: without one it exits non-zero and prints no result.

The reference's only in-repo absolute anchor -- image_warping PCGStep1
averaging ~24 ms on the fork author's CPU
(reference: API/src/solverGPUGaussNewton.t:1926-1933), i.e. a
whole-solve floor of 8*400*24 = 76800 ms there -- is reported as a
stderr comment (cpu_anchor_vs): it extrapolates across machines and
must not be read as a GPU comparison.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def require_gpu():
    """JAX's first device, which must be a GPU: no CPU fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); nothing measured"
        )
    return dev


def card_name_and_power():
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_record(devices):
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def warp_inputs(W, H, seed=0):
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    # constraint band: ~5% of pixels pinned to mutually inconsistent targets
    # (keeps the optimum nonzero so divergence would be visible in the cost)
    cons[::20, :] = np.abs(rng.randn(H, W, 2).astype(np.float32))[::20, :]
    mask = np.zeros((H, W, 1), np.float32)
    return {
        "Offset": np.zeros((H, W, 2), np.float32),
        "Angle": np.zeros((H, W, 1), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def tri_grid_graph(w, h, wrap=False):
    """Triangulated-grid mesh edges, both orientations (deterministic
    stand-in for the reference's PLY meshes -- same ~6-neighbor topology
    real arap workloads have).  wrap=True closes the grid into a torus:
    6*w*h edges, so vertex and edge counts shard evenly over a mesh
    whose size divides w*h."""
    vid = np.arange(w * h).reshape(h, w)
    if wrap:
        right, down = np.roll(vid, -1, 1), np.roll(vid, -1, 0)
        diag = np.roll(down, -1, 1)
        pairs = [(vid.ravel(), nb.ravel()) for nb in (right, down, diag)]
    else:
        pairs = [
            (vid[:, :-1].ravel(), vid[:, 1:].ravel()),
            (vid[:-1, :].ravel(), vid[1:, :].ravel()),
            (vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()),
        ]
    v0 = np.concatenate([a for a, b in pairs] + [b for a, b in pairs])
    v1 = np.concatenate([b for a, b in pairs] + [a for a, b in pairs])
    return v0.astype(np.int32), v1.astype(np.int32)


def arap_inputs(w, h, seed=0, wrap=False):
    """arap_mesh_deformation on the w x h triangulated grid (a torus with
    wrap=True): 2% of the vertices pinned to independently jittered
    targets, so the optimum cost stays well above zero."""
    v0, v1 = tri_grid_graph(w, h, wrap)
    n = w * h
    rng = np.random.RandomState(seed)
    ur = rng.randn(n, 3).astype(np.float32)
    cons = np.full((n, 3), -1e7, np.float32)
    sel = rng.choice(n, max(2, n // 50), replace=False)
    cons[sel] = ur[sel] + 0.5 * rng.randn(len(sel), 3).astype(np.float32)
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, 3), np.float32),
        "UrShape": ur, "Constraints": cons,
        "w_fitSqrt": 2.0, "w_regSqrt": 1.0,
        "G": {"v0": v0, "v1": v1},
    }


def volume_inputs(side, seed=0):
    """volumetric_mesh_deformation on a side^3 lattice: one face pinned,
    the opposite face pulled sideways."""
    rng = np.random.RandomState(seed)
    ax = np.arange(side, dtype=np.float32)
    ii, jj, kk = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = np.stack([ii, jj, kk], axis=-1)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, side - 1] = grid[:, side - 1] + np.array(
        [2.5, -2.5, 0.0], np.float32)
    return {
        "Offset": grid + 0.01 * rng.randn(*grid.shape).astype(np.float32),
        "UrShape": grid.copy(),
        "Angle": np.zeros_like(grid),
        "Constraints": cons.astype(np.float32),
        "w_fitSqrt": np.sqrt(1.0),
        "w_regSqrt": np.sqrt(0.05),
    }


def to_device(inputs, device=None):
    """Arrays onto the device; scalars and graph index dicts (validated
    and planned on the host by Plan.bind) stay as they are."""
    import jax

    return {k: (jax.device_put(v, device) if isinstance(v, np.ndarray)
                else v)
            for k, v in inputs.items()}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def make_plan(energy, dims, kind, n_outer, n_lin, **state_kwargs):
    import opt_tpu

    state = opt_tpu.NewState(**state_kwargs)
    plan = state.problem_plan(state.problem_define(energy, kind), dims)
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_lin)
    return plan


def time_solve(plan, inputs, reps=3, **solve_kwargs):
    """(first-call s, best steady ms, final cost) of Plan.solve.  The
    first call compiles; each timed call ends with the final-cost fetch
    to the host."""
    t0 = time.perf_counter()
    plan.solve(inputs, **solve_kwargs)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cost = plan.solve(inputs, **solve_kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
    return first_s, min(times), cost


def main():
    dev = require_gpu()
    import jax
    from opt_tpu import energies
    from opt_tpu.runtime.api import configure_compilation_cache

    configure_compilation_cache()
    card = card_name_and_power()
    print(f"# card: {card}", file=sys.stderr)
    W = H = 512
    n_outer, n_lin = 8, 400
    plan = make_plan(energies.image_warping, [W, H], "gaussNewtonGPU",
                     n_outer, n_lin)
    _, ms, final_cost = time_solve(plan, to_device(warp_inputs(W, H), dev))
    assert np.isfinite(final_cost), f"bench diverged: {final_cost}"

    print(json.dumps({
        "metric": "image_warping_512_gn_solve(8x400)",
        "value": round(ms, 3),
        "unit": "ms",
        "device": device_record(jax.devices()),
        "card": card,
    }))
    cpu_anchor_ms = 8 * 400 * 24.0  # see module docstring
    print(
        f"# final_cost={final_cost:.6f} "
        f"cpu_anchor_vs={cpu_anchor_ms / ms:.0f}x (reference author's "
        f"CPU extrapolation, solverGPUGaussNewton.t:1926-1933 -- NOT a "
        f"GPU comparison)",
        file=sys.stderr,
    )
    for aux in (aux_arap, aux_sfs, aux_large_grid, aux_volumetric,
                aux_solve_many):
        aux(dev, sys.stderr)


def aux_arap(dev, err):
    """Graph-domain line: arap ~10k vertices / ~62k mesh edges, GN 8x100."""
    from opt_tpu import energies

    inputs = arap_inputs(102, 102)
    n, e = len(inputs["Offset"]), len(inputs["G"]["v0"])
    plan = make_plan(energies.arap_mesh_deformation, [n, e],
                     "gaussNewtonGPU", 8, 100)
    _, ms, c = time_solve(plan, to_device(inputs, dev))
    print(f"# aux arap_10k_gn_solve(8x100): {ms:.3f} ms "
          f"final_cost={c:.6g}", file=err)


def aux_large_grid(dev, err):
    """2048^2 image_warping 8x100, GN and LM."""
    from opt_tpu import energies

    inputs = to_device(warp_inputs(2048, 2048), dev)
    for kind in ("gaussNewtonGPU", "LMGPU"):
        plan = make_plan(energies.image_warping, [2048, 2048], kind, 8, 100)
        _, ms, c = time_solve(plan, inputs, reps=2)
        print(f"# aux image_warping_2048_{kind}(8x100): {ms:.3f} ms "
              f"final_cost={c:.6g}", file=err)


def aux_volumetric(dev, err):
    """128^3 volumetric ARAP, GN 8x100."""
    from opt_tpu import energies

    side = 128
    plan = make_plan(energies.ALL_ENERGIES["volumetric_mesh_deformation"],
                     [side] * 3, "gaussNewtonGPU", 8, 100)
    _, ms, c = time_solve(plan, to_device(volume_inputs(side), dev),
                          reps=2)
    print(f"# aux volumetric_128_gn_solve(8x100): {ms:.3f} ms "
          f"final_cost={c:.6g}", file=err)


def aux_sfs(dev, err):
    """shape_from_shading at the reference perf config (nonLinearIter=60,
    linearIter=10, examples/shape_from_shading/src/main.cpp:64-65) on the
    reference dataset (directory in OPT_TPU_DATA) -- the second north-star
    workload (BASELINE.md)."""
    from opt_tpu import energies
    from opt_tpu.io.imagedump import read_imagedump

    prefix = os.path.join(os.environ.get("OPT_TPU_DATA", ""),
                          "shape_from_shading", "default")
    if not os.path.exists(prefix + "_initialUnknown.imagedump"):
        print("# aux sfs: dataset not found; skipped", file=err)
        return
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "examples"))
    from shape_from_shading import load_sfs_parameters

    init_unknown = read_imagedump(prefix + "_initialUnknown.imagedump")
    target_depth = read_imagedump(prefix + "_targetDepth.imagedump")
    target_intensity = read_imagedump(
        prefix + "_targetIntensity.imagedump")
    edge_masks = read_imagedump(prefix + "_maskEdgeMap.imagedump")
    H, W = init_unknown.shape[:2]
    inputs = {
        "X": init_unknown.copy(),
        "D_i": target_depth,
        "Im": target_intensity,
        "edgeMaskR": edge_masks[:H, :, 0].astype(np.float32)[..., None],
        "edgeMaskC": edge_masks[H:, :, 0].astype(np.float32)[..., None],
        **load_sfs_parameters(prefix + ".SFSSolverParameters"),
    }
    plan = make_plan(energies.shape_from_shading, [W, H], "gaussNewtonGPU",
                     60, 10)
    _, ms, c = time_solve(plan, to_device(inputs, dev))
    print(f"# aux sfs_{W}x{H}_gn_solve(60x10): {ms:.3f} ms "
          f"final_cost={c:.6g}", file=err)


def aux_solve_many(dev, err):
    """Batched serving mode (Plan.solve_many): 64 independent 128^2
    image_warping solves in ONE vmapped dispatch vs the solo loop of 64
    fused solves."""
    from opt_tpu import energies

    S, N = 128, 64
    plan = make_plan(energies.image_warping, [S, S], "gaussNewtonGPU",
                     8, 100)
    batch = [to_device(warp_inputs(S, S, seed=s), dev) for s in range(N)]
    walls = {}
    for mode in ("solo", "batched"):
        plan.solve_many(batch, mode=mode)  # compile
        t0 = time.perf_counter()
        costs = plan.solve_many(batch, mode=mode)
        walls[mode] = (time.perf_counter() - t0) * 1e3
    print(f"# aux solve_many_128x64(8x100): batched={walls['batched']:.3f}"
          f" ms solo_loop={walls['solo']:.3f} ms "
          f"speedup={walls['solo'] / walls['batched']:.2f}x "
          f"cost0={costs[0]:.6g}", file=err)


if __name__ == "__main__":
    main()
