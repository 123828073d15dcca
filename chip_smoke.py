"""Smoke run of the solver's public path on the GPU, with parity checks.

    python chip_smoke.py                  # one card: every single-card phase
    python chip_smoke.py --chips 4        # four cards: the sharded paths only
    python chip_smoke.py --memory-analysis  # memory plan, 8192^2 / 256^3

Every phase runs at the full width of a configuration the repository
supports, through Plan.solve / Plan.solve_many / Plan.solve(mesh=...),
with inputs generated from --seed and placed on the device first:

  1. image_warping 512^2 GN 8x400 (the reference's canonical config)
  2. image_warping 512^2 LM 8x400
  3. image_warping 2048^2 GN 8x100
  4. volumetric_mesh_deformation 128^3 GN 8x100
  5. arap_mesh_deformation, 102x102 triangulated grid (10,404 vertices)
     GN 8x100, graph_mode "banded" and "take"
  6. image_warping 512^2 GN 8x400, materialized J and fused J^T J
  7. solve_many: 64 problems of 128^2 GN 8x100, batched vs the solo loop

Each phase times the full budget on the GPU (the first call compiles and
counts as set-up) and asserts the cost is finite and no higher than the
initial cost; then it solves the same plan with a short budget
(PARITY_OUTER x PARITY_LIN) on the GPU and on the host CPU backend of
this process (float32 under jax.default_matmul_precision("highest")) and
asserts the final costs agree.  Phase 5 also asserts that a
banded gather equals jnp.take bit for bit on the card.

The last line of stdout is one JSON object naming the device.  Without a
GPU the script exits non-zero before printing any result; a failed
assertion or exception anywhere ends the run with a non-zero exit code.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

# short budget of the GPU-vs-CPU parity solves
PARITY_OUTER, PARITY_LIN = 2, 20

# Cost tolerances, each with its reason:
# - the GPU and CPU runs are the same float32 program; only the order of
#   the reductions (dot products, cost sums, graph segment_sums) differs
RTOL_F32 = 1e-4
# - the CPU backend's own float32 sums over a 128^3 volume are off by
#   ~5e-4: against a float64 solve on an H100 host, its initial cost is
#   4.6e-4 and its 2x20 cost 9e-4 away, where the GPU's float32 is
#   within 1.2e-8.  The bound covers the reference's rounding.
RTOL_VOLUME = 2e-3
# - the banded engine sums its scatters in another order than
#   segment_sum (tests/test_graph_banded.py pins the same bound)
RTOL_BANDED = 1e-3


def _repo_helpers():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench

    return bench


def _allclose(name, got, want, rtol):
    assert np.isfinite(got) and np.isfinite(want), (name, got, want)
    rel = abs(got - want) / max(abs(want), 1e-30)
    assert rel <= rtol, (
        f"{name}: {got!r} vs {want!r} (rel {rel:.3g} > rtol {rtol})")
    return rel


class Smoke:
    """Runs phases on `device`, with references on `ref_device`; prints
    one line per check and per timing."""

    def __init__(self, device, ref_device, seed, out=print):
        self.dev = device
        self.ref = ref_device
        self.seed = seed
        self.out = out
        self.bench = _repo_helpers()

    @contextlib.contextmanager
    def on_reference(self):
        """Run on the reference device, float32 at the highest matmul
        precision."""
        import jax

        with jax.default_device(self.ref), \
                jax.default_matmul_precision("highest"):
            yield

    def parity(self, name, plan, host_inputs, dev_inputs, rtol):
        """Short-budget cost on the device vs the reference device."""
        plan.set_solver_parameter("nIterations", PARITY_OUTER)
        plan.set_solver_parameter("lIterations", PARITY_LIN)
        got = plan.solve(dev_inputs)
        with self.on_reference():
            want = plan.solve(host_inputs)
        rel = _allclose(name, got, want, rtol)
        self.out(f"{name}: parity {PARITY_OUTER}x{PARITY_LIN} "
                 f"device={got!r} reference={want!r} rel={rel:.3g} "
                 f"rtol={rtol}")
        return got

    def timed(self, name, plan, dev_inputs, n_outer, n_lin, reps=3):
        """Full-budget timing on the device; returns the final cost."""
        plan.set_solver_parameter("nIterations", n_outer)
        plan.set_solver_parameter("lIterations", n_lin)
        plan.init(dev_inputs)
        cost0 = plan.final_cost()
        first_s, ms, cost = self.bench.time_solve(plan, dev_inputs, reps)
        assert np.isfinite(cost), f"{name}: final cost {cost!r}"
        assert cost <= cost0, f"{name}: cost rose {cost0!r} -> {cost!r}"
        self.report(name, ms, first_s, n_outer * n_lin, cost0, cost)
        return cost

    def report(self, name, ms, first_s, n_iters, cost0, cost):
        stats = self.dev.memory_stats() or {}
        self.out(
            f"{name}: wall_ms={ms:.3f} "
            f"compile_s={first_s - ms / 1e3:.2f} "
            f"us_per_pcg_iter={ms * 1e3 / n_iters:.3f} "
            f"peak_bytes={stats.get('peak_bytes_in_use')} "
            f"initial_cost={cost0!r} final_cost={cost!r}"
        )

    # -- phases ---------------------------------------------------------

    def warp(self, side=512, kind="gaussNewtonGPU", n_outer=8, n_lin=400,
             **state_kwargs):
        from opt_tpu import energies

        mode = ("fused_jtj" if state_kwargs.get("use_fused_jtj") else
                "materialized" if state_kwargs.get(
                    "use_materialized_jacobian") else "matfree")
        name = f"image_warping_{side}_{kind}_{mode}({n_outer}x{n_lin})"
        host = self.bench.warp_inputs(side, side, seed=self.seed)
        dev = self.bench.to_device(host, self.dev)
        plan = self.bench.make_plan(energies.image_warping, [side, side], kind,
                                    n_outer, n_lin, **state_kwargs)
        cost = self.timed(name, plan, dev, n_outer, n_lin)
        self.parity(name, plan, host, dev, RTOL_F32)
        return cost

    def volume(self, side=128, n_outer=8, n_lin=100):
        from opt_tpu import energies

        name = f"volumetric_{side}_gn({n_outer}x{n_lin})"
        host = self.bench.volume_inputs(side, seed=self.seed)
        dev = self.bench.to_device(host, self.dev)
        plan = self.bench.make_plan(
            energies.ALL_ENERGIES["volumetric_mesh_deformation"],
            [side] * 3, "gaussNewtonGPU", n_outer, n_lin)
        cost = self.timed(name, plan, dev, n_outer, n_lin)
        self.parity(name, plan, host, dev, RTOL_VOLUME)
        return cost

    def arap(self, side=102, n_outer=8, n_lin=100):
        """Banded and take graph engines: each against the reference, a
        banded gather against jnp.take bit for bit, and banded against
        take."""
        from opt_tpu import energies

        host = self.bench.arap_inputs(side, side, seed=self.seed)
        dev = self.bench.to_device(host, self.dev)
        dims = [side * side, len(host["G"]["v0"])]
        costs = {}
        for mode in ("banded", "take"):
            name = f"arap_{dims[0]}_gn_{mode}({n_outer}x{n_lin})"
            plan = self.bench.make_plan(energies.arap_mesh_deformation, dims,
                                        "gaussNewtonGPU", n_outer, n_lin,
                                        graph_mode=mode)
            costs[mode] = self.timed(name, plan, dev, n_outer, n_lin)
            self.parity(name, plan, host, dev, RTOL_F32)
            if mode == "banded":
                self.banded_gather_exact(plan, dev)
        rel = _allclose("arap banded vs take", costs["banded"],
                        costs["take"], RTOL_BANDED)
        self.out(f"arap banded vs take: rel={rel:.3g} rtol={RTOL_BANDED}")
        return costs

    def banded_gather_exact(self, plan, dev_inputs):
        """slots_gather of the bound unknowns equals jnp.take of the same
        rows, bit for bit, on the device."""
        import jax
        import jax.numpy as jnp
        from opt_tpu.ops import graph_banded as gb

        x, data = plan.bind(dev_inputs, graph_mode="banded")
        band = data["graph_banding"]["G"]
        idx = data["graph_indices"]["G"]
        vals = x["Offset"]
        rows = jax.jit(lambda v: gb.slots_gather(band, list(idx), v))(vals)
        real = np.asarray(band.pad_mask).reshape(-1)
        for slot, flat in idx.items():
            got = np.asarray(rows[slot]).reshape(-1, vals.shape[-1])[real]
            want = np.asarray(
                jax.jit(lambda v, i: jnp.take(v, i, axis=0))(vals, flat)
            )[real]
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)), (
                f"banded gather slot {slot} differs from jnp.take")
        self.out(f"arap banded gather == jnp.take bit for bit "
                 f"({int(real.sum())} edges x {len(idx)} slots)")

    def solve_many(self, side=128, n=64, n_outer=8, n_lin=100):
        from opt_tpu import energies

        name = f"solve_many_{side}x{n}_gn({n_outer}x{n_lin})"
        hosts = [self.bench.warp_inputs(side, side, seed=self.seed + s)
                 for s in range(n)]
        devs = [self.bench.to_device(h, self.dev) for h in hosts]
        plan = self.bench.make_plan(energies.image_warping, [side, side],
                                    "gaussNewtonGPU", n_outer, n_lin)
        walls, costs = {}, {}
        for mode in ("solo", "batched"):
            t0 = time.perf_counter()
            plan.solve_many(devs, mode=mode)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            costs[mode] = plan.solve_many(devs, mode=mode)
            walls[mode] = (time.perf_counter() - t0) * 1e3
            assert all(np.isfinite(costs[mode])), (name, mode)
            self.report(f"{name} {mode}", walls[mode], first_s,
                        n * n_outer * n_lin, float("nan"),
                        costs[mode][0])
        worst = max(_allclose(f"{name} batched vs solo lane {i}", b, s,
                              RTOL_F32)
                    for i, (b, s) in enumerate(zip(costs["batched"],
                                                   costs["solo"])))
        self.out(f"{name}: batched/solo speedup="
                 f"{walls['solo'] / walls['batched']:.3f}x "
                 f"worst lane rel={worst:.3g}")
        plan.set_solver_parameter("nIterations", PARITY_OUTER)
        plan.set_solver_parameter("lIterations", PARITY_LIN)
        got = plan.solve_many(devs, mode="batched")
        with self.on_reference():
            want = plan.solve_many(hosts, mode="batched")
        worst = max(_allclose(f"{name} lane {i}", g, w, RTOL_F32)
                    for i, (g, w) in enumerate(zip(got, want)))
        self.out(f"{name}: parity {PARITY_OUTER}x{PARITY_LIN} {n} lanes "
                 f"worst rel={worst:.3g} rtol={RTOL_F32}")
        return costs

    def single_card(self, scale=None):
        """Every single-card phase; `scale` overrides sizes (tests)."""
        s = scale or {}
        self.warp(side=s.get("warp", 512), n_lin=s.get("lin", 400))
        self.warp(side=s.get("warp", 512), kind="LMGPU",
                  n_lin=s.get("lin", 400))
        self.warp(side=s.get("large", 2048), n_lin=s.get("lin", 100))
        self.volume(side=s.get("volume", 128), n_lin=s.get("lin", 100))
        self.arap(side=s.get("arap", 102), n_lin=s.get("lin", 100))
        self.warp(side=s.get("warp", 512), n_lin=s.get("lin", 400),
                  use_materialized_jacobian=True)
        self.warp(side=s.get("warp", 512), n_lin=s.get("lin", 400),
                  use_materialized_jacobian=True, use_fused_jtj=True)
        self.solve_many(side=s.get("many", 128), n=s.get("lanes", 64),
                        n_lin=s.get("lin", 100))

    # -- four cards -----------------------------------------------------

    def sharded(self, name, plan, dev_inputs, ref_cost, mesh, n_iters,
                engine="auto"):
        """Time plan.solve(mesh=...) and compare with the single-card
        cost; every unknown must end up spread over the whole mesh."""
        first_s, ms, cost = self.bench.time_solve(
            plan, dev_inputs, reps=2, mesh=mesh, engine=engine)
        rel = _allclose(name, cost, ref_cost, RTOL_F32)
        n_dev = mesh.devices.size
        for k, v in plan.x.items():
            assert len(v.sharding.device_set) == n_dev, (
                f"{name}: {k} on {v.sharding.device_set}")
        self.report(name, ms, first_s, n_iters, float("nan"), cost)
        self.out(f"{name}: vs single card rel={rel:.3g} rtol={RTOL_F32} "
                 f"shards={n_dev}")

    def four_card(self, n_dev=4, scale=None):
        """The sharded paths on n_dev devices, each against one card."""
        from opt_tpu import energies
        from opt_tpu.parallel import mesh as pmesh

        s = scale or {}
        mesh2d = pmesh.make_mesh(n_dev)
        mesh1d = pmesh.make_mesh(n_dev, shape=(n_dev,),
                                 axis_names=("shard",))
        n_outer, n_lin = 8, s.get("lin", 100)

        side = s.get("warp", 4096)
        host = self.bench.warp_inputs(side, side, seed=self.seed)
        dev = self.bench.to_device(host, self.dev)
        name = f"image_warping_{side}_gn({n_outer}x{n_lin})"
        plan = self.bench.make_plan(energies.image_warping, [side, side],
                                    "gaussNewtonGPU", n_outer, n_lin)
        ref = self.timed(f"{name} single", plan, dev, n_outer, n_lin,
                         reps=2)
        for engine, mesh in (("gspmd", mesh2d), ("halo", mesh1d)):
            self.sharded(f"{name} {engine}", plan, dev, ref, mesh,
                         n_outer * n_lin, engine=engine)

        side = s.get("torus", 100)
        host = self.bench.arap_inputs(side, side, seed=self.seed,
                                      wrap=True)
        dev = self.bench.to_device(host, self.dev)
        dims = [side * side, len(host["G"]["v0"])]
        name = f"arap_torus_{dims[0]}_gn({n_outer}x{n_lin})"
        plan = self.bench.make_plan(energies.arap_mesh_deformation, dims,
                                    "gaussNewtonGPU", n_outer, n_lin)
        ref = self.timed(f"{name} single", plan, dev, n_outer, n_lin,
                         reps=2)
        self.sharded(f"{name} gspmd", plan, dev, ref, mesh2d,
                     n_outer * n_lin)

        side, n = s.get("many", 128), s.get("lanes", 64)
        name = f"solve_many_{side}x{n}_gn({n_outer}x{n_lin})"
        devs = [self.bench.to_device(
            self.bench.warp_inputs(side, side, seed=self.seed + i),
            self.dev) for i in range(n)]
        plan = self.bench.make_plan(energies.image_warping, [side, side],
                                    "gaussNewtonGPU", n_outer, n_lin)
        walls, costs = {}, {}
        for key, mesh in (("single", None), ("sharded", mesh2d)):
            plan.solve_many(devs, mesh=mesh, mode="batched")  # compile
            t0 = time.perf_counter()
            costs[key] = plan.solve_many(devs, mesh=mesh, mode="batched")
            walls[key] = (time.perf_counter() - t0) * 1e3
        worst = max(_allclose(f"{name} lane {i}", c, r, RTOL_F32)
                    for i, (c, r) in enumerate(zip(costs["sharded"],
                                                   costs["single"])))
        self.out(f"{name}: single_ms={walls['single']:.3f} "
                 f"sharded_ms={walls['sharded']:.3f} "
                 f"worst lane rel={worst:.3g} rtol={RTOL_F32}")

    # -- memory plan at the largest sizes --------------------------------

    def memory_analysis(self):
        """XLA's memory plan for the fused solve at the sizes that needed
        a strip-mined engine before, and one timed run of each."""
        import jax.numpy as jnp
        from opt_tpu import energies

        cases = (
            ("image_warping_8192_gn(8x100)", energies.image_warping,
             [8192, 8192], self.bench.warp_inputs(8192, 8192)),
            ("volumetric_256_gn(8x100)",
             energies.ALL_ENERGIES["volumetric_mesh_deformation"],
             [256] * 3, self.bench.volume_inputs(256)),
        )
        for name, energy, dims, host in cases:
            plan = self.bench.make_plan(energy, dims, "gaussNewtonGPU", 8, 100)
            x, data = plan.bind(self.bench.to_device(host, self.dev))
            sp = plan._sp_device()
            sp["nIterations"] = jnp.asarray(8, jnp.int32)
            t0 = time.perf_counter()
            compiled = plan._full_solve_fn.lower(x, data, sp).compile()
            compile_s = time.perf_counter() - t0
            ma = compiled.memory_analysis()
            self.out(
                f"{name}: memory_analysis argument_bytes="
                f"{ma.argument_size_in_bytes} output_bytes="
                f"{ma.output_size_in_bytes} temp_bytes="
                f"{ma.temp_size_in_bytes} alias_bytes="
                f"{ma.alias_size_in_bytes} compile_s={compile_s:.2f}")
            t0 = time.perf_counter()
            cost = float(compiled(x, data, sp)["prev_cost"])
            ms = (time.perf_counter() - t0) * 1e3
            assert np.isfinite(cost), (name, cost)
            self.report(name, ms, compile_s + ms / 1e3, 800,
                        float("nan"), cost)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths on four cards")
    ap.add_argument("--memory-analysis", action="store_true",
                    help="only XLA's memory plan at 8192^2 and 256^3")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX's first device is "
            f"{devices[0].platform!r}); nothing measured")
    if len(devices) < args.chips:
        raise SystemExit(
            f"chip_smoke: --chips {args.chips} but JAX sees "
            f"{len(devices)} GPU(s)")
    bench = _repo_helpers()
    from opt_tpu.runtime.api import configure_compilation_cache

    configure_compilation_cache()
    print(f"card: {bench.card_name_and_power()}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}"
          f"; devices={[d.device_kind for d in devices]}")
    sys.stdout.flush()

    smoke = Smoke(devices[0], jax.devices("cpu")[0], args.seed,
                  out=lambda s: print(s, flush=True))
    t0 = time.perf_counter()
    if args.memory_analysis:
        smoke.memory_analysis()
    elif args.chips == 4:
        smoke.four_card(4)
    else:
        smoke.single_card()
    print(f"total_s={time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True,
                      "device": bench.device_record(devices)}))


if __name__ == "__main__":
    main()
