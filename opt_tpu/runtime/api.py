"""Public API: the JAX analogue of the reference's C API.

Parity with reference: API/release/include/Opt.h:40-76 --
  Opt_NewState            -> OptState(...)
  Opt_ProblemDefine       -> state.problem_define(energy, kind)
  Opt_ProblemPlan         -> state.problem_plan(problem, dims)
  Opt_SetSolverParameter  -> plan.set_solver_parameter(name, value)
  Opt_ProblemInit/Step    -> plan.init(inputs) / plan.step()
  Opt_ProblemSolve        -> plan.solve(inputs)  (also fully on-device)
  Opt_ProblemCurrentCost  -> plan.current_cost()

Where the reference JIT-compiles Terra->PTX per (problem, dims, backend)
at plan time (o.t:1351-1528), a plan here holds jitted XLA executables
specialized to the same static information (dims are baked into traced
shapes).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..dsl.env import EnergyEnv
from ..dsl.spec import ProblemSpec
from ..compile.plan_fns import ProblemFunctions
from ..solver.core import (
    SOLVER_PARAMETER_DEFAULTS,
    SolverConfig,
    make_solver,
)
from .timing import KernelTimer

GN_KINDS = ("gaussNewtonGPU", "gauss_newton", "gaussNewton", "GN")
LM_KINDS = ("LMGPU", "levenberg_marquardt", "levenbergMarquardt", "LM")

# solve_many auto-mode guardrail: grid batches past this many batch x
# pixels (per device) run as a loop of solo solves.  Not yet measured on
# this card; the batch/solo crossover is an open benchmark question.
SOLVE_MANY_AUTO_MAX_PIXELS = 1 << 20

ENGINES = ("auto", "xla")

# persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is not
# set: a fixed path in the checkout (the path is part of the cache key,
# so it never moves)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compilation_cache():
    """The one compile-cache rule: when JAX_COMPILATION_CACHE_DIR (or
    jax.config's jax_compilation_cache_dir) is set, JAX's own setting is
    used and nothing is changed here; otherwise the cache goes to
    DEFAULT_CACHE_DIR.  Warm restarts then skip plan compiles (the
    reference caches compiled plans in-process only, o.t makePlan)."""
    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir):
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


def check_engine(engine):
    """Validate a single-device engine name; every plan runs the fused
    XLA program."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine {engine!r} is unknown or was removed: every plan runs "
            f"the fused XLA program; use one of {ENGINES}"
        )
    return "xla"


class Problem:
    def __init__(self, energy, kind):
        self.energy = energy
        self.kind = kind
        if kind in GN_KINDS:
            self.uses_lambda = False
        elif kind in LM_KINDS:
            self.uses_lambda = True
        else:
            raise ValueError(f"unknown solver kind {kind!r}")


class OptState:
    """Opt_NewState parity (Opt_InitializationParameters, Opt.h:8-35).

    backend / numthreads are accepted for API parity; execution targets
    JAX's default backend (jax.default_backend(): the GPU when JAX finds
    one) -- the reference's backend_cpu/backend_cuda split collapses into
    one XLA program.
    """

    def __init__(
        self,
        backend=None,
        numthreads=1,
        double_precision=False,
        verbosity=0,
        collect_kernel_timing=False,
        use_materialized_jacobian=False,
        use_fused_jtj=False,
        pcg_variant="classic",
        guarded_invert_type="CERES",
        jacobi_scaling="ONCE_PER_SOLVE",
        graph_mode=None,
    ):
        if double_precision:
            jax.config.update("jax_enable_x64", True)
        configure_compilation_cache()
        self.backend = backend
        self.numthreads = numthreads
        self.double_precision = double_precision
        self.verbosity = verbosity
        self.collect_kernel_timing = collect_kernel_timing
        self.use_materialized_jacobian = use_materialized_jacobian
        self.use_fused_jtj = use_fused_jtj
        if pcg_variant not in ("classic", "pipelined"):
            raise ValueError(
                f"pcg_variant must be 'classic' or 'pipelined', "
                f"got {pcg_variant!r}"
            )
        self.pcg_variant = pcg_variant
        self.guarded_invert_type = guarded_invert_type
        self.jacobi_scaling = jacobi_scaling
        if graph_mode is None:
            graph_mode = os.environ.get("OPT_TPU_GRAPH_MODE", "auto")
        if graph_mode not in ("auto", "banded", "take"):
            raise ValueError(
                f"graph_mode must be 'auto', 'banded' or 'take', "
                f"got {graph_mode!r}"
            )
        # graph gather/scatter engine: 'take' is XLA take/segment_sum,
        # 'banded' the one-hot matmul engine (ops/graph_banded.py).
        # 'auto' means take: it measured faster than banded on the GPU
        # (PERF.md).
        self.graph_mode = graph_mode
        self.dtype = jnp.float64 if double_precision else jnp.float32

    def problem_define(self, energy, kind="gaussNewtonGPU"):
        return Problem(energy, kind)

    def problem_plan(self, problem, dims, **kwargs):
        return Plan(self, problem, dims, **kwargs)

    def problem_solve(self, plan, inputs):
        plan.init(inputs)
        while plan.step():
            pass
        return plan.current_cost()

    def problem_delete(self, problem):
        """Opt_ProblemDelete parity (Opt.h:56): lifetimes are Python-managed;
        kept for drop-in compatibility."""

    def plan_free(self, plan):
        """Opt_PlanFree parity (Opt.h:54): releases device buffers held by
        the plan's bound state."""
        plan.free()

    # CamelCase aliases for reference-API parity
    ProblemDefine = problem_define
    ProblemPlan = problem_plan
    ProblemSolve = problem_solve
    ProblemDelete = problem_delete
    PlanFree = plan_free


def NewState(**kwargs):
    return OptState(**kwargs)


def _run_energy(energy, env):
    """Run a user energy definition: a callable taking the env, or a path
    to a Python file executed with the DSL names as globals (the analogue
    of problemSpecFromFile, o.t:1295-1348)."""
    if callable(energy):
        energy(env)
        return
    path = str(energy)
    with open(path) as f:
        src = f.read()
    ns = env.namespace()
    ns["__name__"] = "<energy>"
    exec(compile(src, path, "exec"), ns)


class Plan:
    """A shape-specialized, jitted solver (opt.Plan, o.t:158-164)."""

    def __init__(self, state: OptState, problem: Problem, dims, jit=True):
        self.state = state
        self.problem = problem
        self.dims = dims
        self.spec = ProblemSpec()
        env = EnergyEnv(self.spec, dims)
        _run_energy(problem.energy, env)
        if not self.spec.terms:
            raise ValueError("energy defined no residual terms")

        self.funcs = ProblemFunctions(self.spec, state.dtype)
        self.config = SolverConfig(
            uses_lambda=problem.uses_lambda,
            guarded_invert_type=state.guarded_invert_type,
            jacobi_scaling=state.jacobi_scaling,
            use_materialized_jacobian=state.use_materialized_jacobian,
            use_fused_jtj=state.use_fused_jtj,
            pcg_variant=state.pcg_variant,
        )
        init_fn, step_fn, cost_fn, solve_fn, full_solve_fn = (
            make_solver(self.funcs, self.config)
        )
        if self.spec.graphs:
            # deterministic HLO: the banded engine's one-hot tag counter
            # restarts at each top-level trace so identical programs
            # retrace to identical HLO (persistent-cache friendly)
            from ..ops.graph_banded import reset_onehot_tags

            def _det(fn):
                def wrapped(*a, **k):
                    reset_onehot_tags()
                    return fn(*a, **k)
                return wrapped

            init_fn, step_fn, cost_fn, solve_fn, full_solve_fn = (
                _det(init_fn), _det(step_fn), _det(cost_fn),
                _det(solve_fn), _det(full_solve_fn),
            )
        # raw (unjitted) versions, e.g. for the driver's compile checks
        self.raw_init_fn = init_fn
        self.raw_step_fn = step_fn
        self.raw_cost_fn = cost_fn
        self.raw_solve_fn = solve_fn
        self.raw_full_solve_fn = full_solve_fn
        if jit:
            self._init_fn = jax.jit(init_fn)
            self._step_fn = jax.jit(step_fn)
            self._cost_fn = jax.jit(cost_fn)
            self._solve_fn = jax.jit(solve_fn)
            self._full_solve_fn = jax.jit(full_solve_fn)
        else:
            self._init_fn = init_fn
            self._step_fn = step_fn
            self._cost_fn = cost_fn
            self._solve_fn = solve_fn
            self._full_solve_fn = full_solve_fn

        self.solver_params = dict(SOLVER_PARAMETER_DEFAULTS)
        self._state = None
        self._data = None
        self._cleaned = False
        self._banding_cache = {}
        self._active_banding = {}
        self.timer = KernelTimer(enabled=state.collect_kernel_timing)
        if state.verbosity > 1:
            self.print_allocation_info()

    # -- parameters -----------------------------------------------------------

    def set_solver_parameter(self, name, value):
        if name == "nIter":
            # the current nonlinear-iteration counter is itself a settable
            # SolverParameters entry in the reference (the setSolverParameter
            # if-chain iterates ALL struct fields,
            # solverGPUGaussNewton.t:186-201,2382-2398); resetting it lets
            # the host run extra iterations on a finished plan
            if self._state is None:
                raise RuntimeError(
                    "nIter is the live iteration counter; set it after init"
                )
            self._state = dict(self._state)
            self._state["n_iter"] = jnp.asarray(int(value), jnp.int32)
            self._state["done"] = jnp.asarray(False)
            return
        if name not in self.solver_params:
            raise KeyError(f"unknown solver parameter {name!r}")
        self.solver_params[name] = value

    SetSolverParameter = set_solver_parameter

    def _sp_device(self):
        sp = {}
        for k, v in self.solver_params.items():
            if k in ("nIterations",):
                continue
            if k in ("lIterations", "residual_reset_period"):
                sp[k] = jnp.asarray(int(v), jnp.int32)
            else:
                sp[k] = jnp.asarray(float(v), self.state.dtype)
        return sp

    def print_allocation_info(self, out=print):
        """Memory-layout report (printAllocationInfo parity, o.t:375-405,
        solverGPUGaussNewton.t:284-335): per-image bytes plus the solver's
        work-vector footprint."""
        import math

        dtype_bytes = jnp.dtype(self.state.dtype).itemsize
        out("Layout of ProblemParameters:")
        total = 0
        unk_bytes = 0
        for name, im in self.spec.images.items():
            if name in self.funcs.aliases:
                out(f"Param {name} aliases {self.funcs.aliases[name]} "
                    f"(0 bytes)")
                continue
            n = math.prod(im.ispace.shape) * im.channels * dtype_bytes
            total += n
            if im.is_unknown:
                unk_bytes += n
            out(f"Param {name} needs {n} bytes")
        for g in self.spec.graphs.values():
            nedges = g.edge_dim.size
            n = nedges * len(g.slots) * 4
            total += n
            out(f"Param {g.name} needs {n} bytes ({nedges} edges x "
                f"{len(g.slots)} index arrays)")
        out(f"total usage of ProblemParameters is {total} bytes")
        # solver work vectors over the unknowns (PlanData analogue,
        # solverGPUGaussNewton.t:208-272): GN keeps 6, LM 8
        n_vec = 8 if self.config.uses_lambda else 6
        out(f"solver work vectors: {n_vec} x {unk_bytes} = "
            f"{n_vec * unk_bytes} bytes")
        return total

    # -- data binding (util.initParameters parity, util.t:677-721) ------------

    def bind(self, inputs, graph_mode=None):
        """Bind runtime arrays.  graph_mode overrides the state-level
        graph engine choice for this bind (runtime/baseline.py and the
        sharded path force 'take': the materialized-J export and GSPMD
        partitioning expect original-order flat indices)."""
        dtype = self.state.dtype
        images = {}
        unknowns = {}
        params = {}
        graph_indices = {}

        def canon_image(im, arr):
            arr = jnp.asarray(arr)
            spatial = im.ispace.shape
            if arr.shape == spatial:
                if im.channels != 1:
                    raise ValueError(
                        f"{im.name}: expected {im.channels} channels"
                    )
                arr = arr[..., None]
            expect = spatial + (im.channels,)
            if arr.shape != expect:
                raise ValueError(
                    f"{im.name}: shape {arr.shape} != expected {expect} "
                    f"(note layout: dims ({', '.join(d.name for d in im.ispace.dims)}) "
                    f"-> array shape {expect})"
                )
            return arr.astype(dtype)

        for name, im in self.spec.images.items():
            if name in self.funcs.aliases:
                continue  # const view of an unknown; reads its live buffer
            if name not in inputs:
                raise KeyError(f"missing image input {name!r}")
            arr = canon_image(im, inputs[name])
            if im.is_unknown:
                unknowns[name] = arr
            else:
                images[name] = arr

        for name in self.spec.params:
            if name not in inputs:
                raise KeyError(f"missing param input {name!r}")
            params[name] = jnp.asarray(float(inputs[name]), dtype)

        slots_np = {}
        for gname, g in self.spec.graphs.items():
            slots = {}
            gin = inputs.get(gname)
            for sname in g.slots:
                if gin is not None and sname in gin:
                    v = gin[sname]
                elif f"{gname}.{sname}" in inputs:
                    v = inputs[f"{gname}.{sname}"]
                else:
                    raise KeyError(
                        f"missing graph indices {gname}.{sname}"
                    )
                vnp = np.asarray(v)
                n_verts = g.slots[sname].ispace.shape[0]
                if vnp.size and (
                    vnp.min() < 0 or vnp.max() >= n_verts
                ):
                    # jnp.take/segment_sum silently clamp/drop OOB indices
                    # on device; fail fast at bind time instead.
                    raise ValueError(
                        f"graph {gname}.{sname}: vertex index out of "
                        f"range [0, {n_verts}): min={vnp.min()}, "
                        f"max={vnp.max()}"
                    )
                slots[sname] = vnp.astype(np.int32)
            n = {s.shape for s in slots.values()}
            if len(n) != 1:
                raise ValueError(f"graph {gname}: slot length mismatch")
            slots_np[gname] = slots

        banding, graph_banding = self._plan_banding(slots_np, graph_mode)
        self._active_banding = banding
        if banding:
            for key, vb in banding.items():
                perm = jnp.asarray(vb.perm, jnp.int32)
                for store in (unknowns, images):
                    for name, arr in store.items():
                        im = self.spec.images[name]
                        if im.ispace.key() == key:
                            store[name] = jnp.take(arr, perm, axis=0)

        for gname, slots in slots_np.items():
            g = self.spec.graphs[gname]
            key = next(iter(g.slots.values())).ispace.key()
            vb = banding.get(key) if banding else None
            gplan = vb.graphs.get(gname) if vb is not None else None
            if gplan is not None:
                # padded flat indices in the permuted vertex order; pad
                # rows point at vertex 0 and are masked/dropped everywhere
                flat = {}
                for sname, lc in gplan.loc.items():
                    lc64 = lc.astype(np.int64)
                    if gplan.layout == "tiled":
                        # loc = window_pos*vb + offset; window_pos keys
                        # the per-tile block list wblk
                        wb = gplan.wblk.astype(np.int64)
                        gidx = (
                            np.take_along_axis(
                                wb, np.clip(lc64, 0, None) // gplan.vb,
                                axis=1,
                            ) * gplan.vb + lc64 % gplan.vb
                        )
                    else:
                        blk = np.arange(
                            gplan.n_eblk, dtype=np.int64)[:, None]
                        gidx = lc64 + (blk - 1) * gplan.vb
                    gidx[lc < 0] = 0
                    flat[sname] = jnp.asarray(
                        gidx.reshape(-1), jnp.int32
                    )
                graph_indices[gname] = flat
            else:
                # not banded itself, but remap any slot whose vertex
                # space WAS banded (arrays are in RCM-permuted order)
                flat = {}
                for sname, a in slots.items():
                    skey = g.slots[sname].ispace.key()
                    svb = banding.get(skey) if banding else None
                    idx = np.asarray(a, np.int64)
                    if svb is not None:
                        idx = svb.inv_perm[idx]
                    flat[sname] = jnp.asarray(idx, jnp.int32)
                graph_indices[gname] = flat

        data = {
            "images": images,
            "params": params,
            "graph_indices": graph_indices,
        }
        if graph_banding:
            data["graph_banding"] = graph_banding
        return unknowns, data

    def _plan_banding(self, slots_np, graph_mode=None):
        """Decide/plan the banded graph engine for this bind.

        Returns ({ispace_key: VertexBanding}, {gname: device banding dict})
        -- both empty when disabled."""
        mode = graph_mode or self.state.graph_mode
        cfg = self.config
        if (
            not slots_np
            or mode != "banded"
            # float64 graphs run the take/segment_sum path: the banded
            # engine's split-bf16 one-hot dots reconstruct f32 exactly
            # but not f64
            or self.state.dtype != jnp.float32
            or cfg.use_materialized_jacobian
            or cfg.use_fused_jtj
        ):
            return {}, {}
        from ..ops import graph_banded as gb

        # group graphs by vertex ispace; skip graphs with mixed spaces
        by_space = {}
        for gname, g in self.spec.graphs.items():
            keys = {s.ispace.key() for s in g.slots.values()}
            if len(keys) != 1:
                continue
            by_space.setdefault(keys.pop(), {})[gname] = slots_np[gname]

        cache_key_parts = [mode]
        for key, graphs in sorted(by_space.items()):
            for gname, slots in sorted(graphs.items()):
                for sname, arr in sorted(slots.items()):
                    cache_key_parts.append(
                        (key, gname, sname, arr.tobytes())
                    )
        cache_key = hash(tuple(cache_key_parts))
        if cache_key in self._banding_cache:
            banding = self._banding_cache[cache_key]
        else:
            banding = {}
            for key, graphs in by_space.items():
                n_verts = None
                for gname in graphs:
                    g = self.spec.graphs[gname]
                    n_verts = next(iter(g.slots.values())).ispace.shape[0]
                vb = gb.plan_vertex_banding(graphs, n_verts, force=True)
                if vb is not None:
                    banding[key] = vb
            self._banding_cache[cache_key] = banding

        graph_banding = {}
        for key, vb in banding.items():
            for gname, gplan in vb.graphs.items():
                graph_banding[gname] = gb.DeviceBanding(
                    loc={
                        s: jnp.asarray(lc) for s, lc in gplan.loc.items()
                    },
                    pad_mask=jnp.asarray(
                        gplan.pad_mask.reshape(gplan.n_eblk, gplan.eb)
                    ),
                    vb=gplan.vb,
                    n_vblk=gplan.n_vblk,
                    eb=gplan.eb,
                    n_verts=vb.n_verts,
                    layout=gplan.layout,
                    primary_slot=gplan.primary_slot,
                    deg=gplan.deg,
                    wblk=(jnp.asarray(gplan.wblk)
                          if gplan.wblk is not None else None),
                )
        return banding, graph_banding

    # -- lifecycle --------------------------------------------------------------

    def _profiled(self):
        """Per-kernel profiled stepper (collect_kernel_timing mode):
        reference kernel names, one dispatch per kernel
        (opt_tpu/solver/profiled.py)."""
        if getattr(self, "_profiled_stepper", None) is None:
            from ..solver.profiled import ProfiledStepper

            self._profiled_stepper = ProfiledStepper(
                self.funcs, self.config
            )
        return self._profiled_stepper

    def init(self, inputs):
        """Opt_ProblemInit: bind data, compute initial cost."""
        x, data = self.bind(inputs)
        self._data = data
        self._cleaned = False
        with self.timer.event("init"):
            if self.state.collect_kernel_timing:
                self._state = self._profiled().init(
                    x, data, self.solver_params, self.timer
                )
            else:
                self._state = self._init_fn(x, data, self._sp_device())
            jax.block_until_ready(self._state)
        return self

    Init = init

    def step(self):
        """Opt_ProblemStep: one outer iteration; returns 1 while running
        (plan.step contract, solverGPUGaussNewton.t:1913-2349)."""
        assert self._state is not None, "call init() first"
        s = self._state
        if int(s["n_iter"]) >= int(self.solver_params["nIterations"]):
            self._cleanup()
            return 0
        if bool(s["done"]):
            self._cleanup()
            return 0
        with self.timer.event(f"step_{int(s['n_iter'])}"):
            if self.state.collect_kernel_timing:
                self._state = self._profiled().step(
                    s, self._data, self.solver_params, self.timer
                )
            else:
                self._state = self._step_fn(
                    s, self._data, self._sp_device()
                )
            jax.block_until_ready(self._state)
        if self.state.verbosity > 1:
            print(
                f"--cost after step {int(s['n_iter'])}: "
                f"{float(self._state['prev_cost']):.16f}"
            )
        return 1

    def free(self):
        """Opt_PlanFree parity (Opt.h:54): release device buffers held by
        the plan's bound state (the jitted programs stay cached on the
        OptState for re-binding)."""
        self._state = None
        self._data = None
        self._batched_state = None

    def _cleanup(self):
        """Solver cleanup contract (solverGPUGaussNewton.t:1902-1910):
        print 'final cost=' and the aggregated per-kernel timing table."""
        if self._cleaned:
            return
        self._cleaned = True
        if self.state.verbosity > 0:
            print(f"final cost={self.final_cost():.16f}")
        if self.state.collect_kernel_timing:
            self.timer.evaluate()

    Step = step

    def solve(self, inputs, on_device=True, engine="auto", mesh=None):
        """Opt_ProblemSolve: full solve.  on_device=True runs the whole
        outer loop inside one XLA program (no per-iteration host sync --
        the reference cannot do this; solverGPUGaussNewton.t syncs every
        reduction read).

        engine: "auto" or "xla" -- every plan runs the fused XLA program.

        mesh: optional jax.sharding.Mesh -- the solve shards over it
        (parallel/dispatch.py): GSPMD by default, or the explicit
        ppermute halo path with engine="halo"; the one-flag backend
        selection of the reference (Opt.h:23-25) applied to meshes."""
        if mesh is not None:
            from ..parallel.dispatch import solve_sharded_auto

            with self.timer.event("solve"):
                cost = solve_sharded_auto(self, inputs, mesh,
                                          engine=engine)
            if self.state.verbosity > 0:
                print(f"final cost={cost:.16f}")
            return cost
        check_engine(engine)
        x, data = self.bind(inputs)
        self._data = data
        sp = self._sp_device()
        if on_device:
            with self.timer.event("solve"):
                sp_full = dict(sp)
                sp_full["nIterations"] = jnp.asarray(
                    int(self.solver_params["nIterations"]), jnp.int32
                )
                self._state = self._full_solve_fn(x, data, sp_full)
                jax.block_until_ready(self._state)
        else:
            self.init(inputs)
            while self.step():
                pass
        if self.state.verbosity > 0:
            print(f"final cost={self.final_cost():.16f}")
        return self.final_cost()

    Solve = solve

    def solve_many(self, inputs_list, mesh=None, mode="auto"):
        """Batched multi-problem solve: N instances of this plan's
        problem (same shapes, independent data) solved in ONE dispatch
        via jax.vmap over the whole jitted outer loop.

        A throughput mode with no reference equivalent: the
        reference launches one kernel sequence per Opt_ProblemSolve call
        (Opt.h:58), so N problems pay N dispatch sequences; here one
        program solves the whole batch, amortizing the fixed dispatch
        cost and filling the chip for small grids.  lax.while_loop under
        vmap masks per-lane carries, so LM's per-problem early exits
        (done flag / trust-region state) keep their exact
        single-problem semantics per lane.

        mode: "auto" (default) routes grid batches whose batch x pixels
        exceeds SOLVE_MANY_AUTO_MAX_PIXELS to the sequential solo loop
        of fused XLA solves.  "batched"/"solo" force a path.  Both paths
        return the same list of costs and leave the same stacked
        _batched_state.

        mesh: optional jax.sharding.Mesh -- the batch axis is sharded
        across every mesh axis (data-parallel serving: each device
        solves its share of problems with no cross-chip communication).
        N must be a multiple of the mesh size.  With a mesh the
        guardrail applies to the PER-DEVICE share (N/mesh-size x
        pixels).  A batch whose
        per-device share still exceeds the threshold falls back to the
        sequential solo loop (on the default device -- the mesh is not
        used there); force mode="batched" to override.

        Graph problems batch in take-mode (gathers/segment_sums vmap
        over per-lane edge indices, so lanes may have DIFFERENT
        topologies); banding is plan-level, so the banded engine is
        never used here -- for one big graph, shard it spatially via
        plan.solve(mesh=...) instead.  Returns a list of final costs;
        the batched unknowns stay on device in self._batched_state
        ("x" has a leading batch axis; use batch_unknowns(i) to fetch
        one problem's solution).
        """
        if mode not in ("auto", "batched", "solo"):
            raise ValueError(f"mode must be auto/batched/solo: {mode!r}")
        if not inputs_list:
            return []
        sp = dict(self._sp_device())
        sp["nIterations"] = jnp.asarray(
            int(self.solver_params["nIterations"]), jnp.int32
        )
        if mode == "auto" and self.spec.images:
            px = int(np.prod(
                next(iter(self.spec.images.values())).ispace.shape))
            n_dev = (int(np.prod(list(mesh.shape.values())))
                     if mesh is not None else 1)
            per_dev = -(-len(inputs_list) // n_dev)
            if per_dev * px > SOLVE_MANY_AUTO_MAX_PIXELS:
                mode = "solo"
        if mode == "solo":
            stack = lambda *ls: jnp.stack([jnp.asarray(l) for l in ls])
            sts = []
            with self.timer.event("solve_many"):
                for i in inputs_list:
                    x, d = self.bind(i, graph_mode="take")
                    sts.append(self._full_solve_fn(x, d, sp))
                jax.block_until_ready(sts)
            st = jax.tree_util.tree_map(stack, *sts)
            self._batched_state = st
            costs = [float(c) for c in np.asarray(st["prev_cost"])]
            if self.state.verbosity > 0:
                for c in costs:
                    print(f"final cost={c:.16f}")
            return costs
        # take-mode binds: graph_indices are per-lane data (vmapped
        # gathers), so lanes may differ in topology; banded layouts are
        # plan-level and cannot batch
        binds = [self.bind(i, graph_mode="take") for i in inputs_list]
        stack = lambda *ls: jnp.stack([jnp.asarray(l) for l in ls])
        xs = jax.tree_util.tree_map(stack, *[b[0] for b in binds])
        ds = jax.tree_util.tree_map(stack, *[b[1] for b in binds])
        if getattr(self, "_solve_many_fn", None) is None:
            self._solve_many_fn = jax.jit(
                jax.vmap(self.raw_full_solve_fn, in_axes=(0, 0, None))
            )
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = int(np.prod(list(mesh.shape.values())))
            if len(inputs_list) % n_dev:
                raise ValueError(
                    f"solve_many batch ({len(inputs_list)}) must be a "
                    f"multiple of the mesh size ({n_dev})"
                )
            sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
            put = lambda a: jax.device_put(a, sh)
            xs = jax.tree_util.tree_map(put, xs)
            ds = jax.tree_util.tree_map(put, ds)
        with self.timer.event("solve_many"):
            st = self._solve_many_fn(xs, ds, sp)
            jax.block_until_ready(st)
        self._batched_state = st
        costs = [float(c) for c in np.asarray(st["prev_cost"])]
        if self.state.verbosity > 0:
            for c in costs:
                print(f"final cost={c:.16f}")
        return costs

    def batch_unknowns(self, i):
        """Unknowns of problem i from the last solve_many batch."""
        st = getattr(self, "_batched_state", None)
        assert st is not None, "call solve_many() first"
        return {
            name: np.asarray(v[i]) for name, v in st["x"].items()
        }

    # -- results ------------------------------------------------------------------

    def current_cost(self):
        assert self._state is not None
        return float(self._cost_fn(self._state, self._data))

    CurrentCost = current_cost

    def final_cost(self):
        """The cost the reference prints as 'final cost=' (prevCost,
        solverGPUGaussNewton.t:1903): cost after the last accepted update."""
        assert self._state is not None
        return float(self._state["prev_cost"])

    def unknowns(self):
        assert self._state is not None
        out = {}
        for k, v in self._state["x"].items():
            arr = np.asarray(v)
            if self._active_banding:
                # banded binds permute vertex arrays (RCM); undo at the
                # user-facing boundary
                vb = self._active_banding.get(
                    self.spec.images[k].ispace.key()
                )
                if vb is not None:
                    arr = arr[vb.inv_perm]
            out[k] = arr
        return out

    # -- checkpoint / resume ----------------------------------------------------
    # The reference's only resumability is the Init/Step split plus LM's
    # prevX rollback (SURVEY §5); here the full solver state (unknowns,
    # published cost, trust region, SSq, iteration counter) round-trips
    # through a single .npz, so a solve can resume across processes.

    def save_state(self, path):
        assert self._state is not None, "nothing to save; call init() first"
        flat = {}
        for k, v in self._state.items():
            if isinstance(v, dict):
                for n, arr in v.items():
                    flat[f"{k}.{n}"] = np.asarray(arr)
            else:
                flat[k] = np.asarray(v)
        np.savez(path, **flat)

    def load_state(self, path):
        assert self._data is not None, (
            "bind data first (init or solve)")
        loaded = np.load(path)
        dtype = self.funcs.dtype
        state = {"x": {}, "ssq": {}}
        for key in loaded.files:
            arr = loaded[key]
            if np.issubdtype(arr.dtype, np.floating):
                # Cast to the plan precision so a checkpoint written by a
                # float64 plan loads cleanly into a float32 plan (and vice
                # versa) instead of recompiling the step with mixed dtypes.
                arr = arr.astype(dtype)
            if "." in key:
                group, name = key.split(".", 1)
                state.setdefault(group, {})[name] = jnp.asarray(arr)
            else:
                state[key] = jnp.asarray(arr)
        for name, shape in self.funcs.unknown_shapes.items():
            got = state["x"].get(name)
            if got is None:
                raise ValueError(
                    f"{path}: checkpoint missing unknown {name!r}"
                )
            if tuple(got.shape) != tuple(shape):
                raise ValueError(
                    f"{path}: unknown {name!r} shape {tuple(got.shape)} "
                    f"does not match plan shape {tuple(shape)} -- "
                    "checkpoint is from a different problem size"
                )
        for key in ("prev_cost", "n_iter", "done"):
            if key not in state:
                raise ValueError(f"{path}: checkpoint missing {key!r}")
        self._state = state
        self._cleaned = False
        return self

    @property
    def x(self):
        return self._state["x"]
