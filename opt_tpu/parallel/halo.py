"""Explicit shard_map halo-exchange execution of grid solves.

The default multi-chip path (parallel/mesh.py) hands GSPMD the whole
solver program and trusts its automatic halo scheduling.  This module is
the explicit alternative -- the analogue of the reference CPU-MT
backend's shadow-buffer row exchange (reference: API/src/
backend_cpu_mt.t:863-930, SURVEY §2.4): each device owns a contiguous
row block, every operator evaluation runs on a locally materialized
(rows + 2*halo) window filled by `lax.ppermute` neighbor exchanges, and
the five PCG scalars and the cost reduce with `lax.psum`
(SolverConfig.psum_axis).

Correctness structure:

* `ext` (halo exchange) is linear and built from ppermute/slice/concat,
  all with exact transpose rules -- `jax.linear_transpose` of the
  residual map therefore sends J^T cotangents back through the REVERSE
  permutes, accumulating halo contributions to their owners.
* Bounds tests, Index() coordinates and real-domain masks evaluate at
  GLOBAL positions via ProblemFunctions.coord_offsets (the device's row
  offset, a traced axis_index expression).
* halo = 2 * stencil radius: residual rows centered up to `radius` rows
  outside the owned block are recomputed locally (they read up to
  2*radius away), which makes diag(J^T J) exact without a second
  exchange -- the same redundant-compute choice the reference makes for
  its boundary rows.

Device 0's top halo (and the last device's bottom halo) stays zero --
ppermute drops edge transfers -- which is exactly the zero-fill
semantics of shift_read at the global boundary.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..compile.plan_fns import ProblemFunctions
from ..dsl import expr as E
from ..dsl.env import EnergyEnv
from ..dsl.spec import ProblemSpec
from ..solver.core import make_solver


def stencil_radius(spec, axis0_dim_index):
    """Max |offset| along the sharded array axis over every image access
    (ComputedArray accesses expanded to their defining taps)."""
    radius = 0

    def on_node(a, seen=None):
        nonlocal radius
        if isinstance(a, E.ImageAccess) and isinstance(a.index, E.Offset):
            off = a.index.data
            if axis0_dim_index < len(off):
                radius = max(radius, abs(int(off[axis0_dim_index])))
        elif isinstance(a, E.ComputedAccess):
            E.visit(a.expanded(), on_node)

    for exp in list(spec.terms) + list(spec.excludes):
        E.visit(exp, on_node)
    return radius


class ShardedGridFuncs:
    """ProblemFunctions facade over halo-extended local row blocks.

    Presents the same method surface the solver consumes, with arrays
    that are LOCAL row blocks; internally evaluates on (local + 2*halo)
    windows via a ProblemFunctions built for the extended shape.  All
    reductions return LOCAL partial sums -- make_solver's psum_axis
    wrapping makes them global.
    """

    def __init__(self, base, halo, n_local, axis_name, n_dev):
        self.base = base  # ProblemFunctions on the extended local shape
        self.halo = halo
        self.n_local = n_local
        self.axis_name = axis_name
        self.n_dev = n_dev
        self.dtype = base.dtype
        self.use_preconditioner = base.use_preconditioner
        self.unknowns = base.unknowns

    # -- halo plumbing -----------------------------------------------------

    def set_offsets(self):
        """Install this device's global row offset (call inside the
        shard_map-traced function, before any evaluation)."""
        idx = jax.lax.axis_index(self.axis_name)
        row0 = idx.astype(jnp.int32) * self.n_local - self.halo
        nd = None
        for im in self.base.spec.images.values():
            nd = im.ispace.ndims
            break
        self.base.coord_offsets = (row0,) + (0,) * (nd - 1)

    def _ext(self, arr):
        """(local, ...) -> (local + 2*halo, ...) with neighbor rows."""
        h = self.halo
        ax = self.axis_name
        n = self.n_dev
        if h == 0:
            return arr
        up = jax.lax.ppermute(
            arr[-h:], ax, perm=[(i, i + 1) for i in range(n - 1)]
        )
        dn = jax.lax.ppermute(
            arr[:h], ax, perm=[(i + 1, i) for i in range(n - 1)]
        )
        return jnp.concatenate([up, arr, dn], axis=0)

    def _ext_tree(self, tree):
        return {k: self._ext(v) for k, v in tree.items()}

    def _ext_data(self, data):
        return {
            "images": self._ext_tree(data["images"]),
            "params": data["params"],
            "graph_indices": {},
        }

    def _crop(self, arr, axis):
        h = self.halo
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(h, h + self.n_local)
        return arr[tuple(idx)]

    def _crop_fields(self, fields):
        # stacked (n_channels, h_ext, ...) per group -> crop row axis 1
        return [self._crop(f, 1) for f in fields]

    # -- funcs surface -------------------------------------------------------

    def _fields(self, x, data, masked):
        self.set_offsets()
        fields = self.base.residual_fields(
            self._ext_tree(x), self._ext_data(data), masked
        )
        return self._crop_fields(fields)

    def residuals_solve(self, x, data):
        return self._fields(x, data, masked=False)

    def cost(self, x, data):
        """LOCAL half-sum of squares (psum'd by the solver)."""
        total = jnp.zeros((), dtype=self.dtype)
        for f in jax.tree_util.tree_leaves(self._fields(x, data, True)):
            total = total + 0.5 * jnp.sum(f * f)
        return total

    def linearize(self, x, data):
        fn = lambda xx: self.residuals_solve(xx, data)
        r0, jvp_fn = jax.linearize(fn, x)
        jt_fn = jax.linear_transpose(jvp_fn, x)

        def jt(cotangents):
            (g,) = jt_fn(cotangents)
            return g

        return r0, jvp_fn, jt

    def jtf(self, r0, jt):
        return jt(r0)

    def diag_jtj(self, x, data):
        self.set_offsets()
        diag_ext = self.base.diag_jtj(
            self._ext_tree(x), self._ext_data(data)
        )
        return {n: self._crop(v, 0) for n, v in diag_ext.items()}

    def unknown_masks(self, x, data):
        self.set_offsets()
        masks = self.base.unknown_masks(
            self._ext_tree(x), self._ext_data(data)
        )
        return {
            n: (None if m is None else self._crop(m, 0))
            for n, m in masks.items()
        }

    def mask_unknown_tree(self, tree, masks):
        return self.base.mask_unknown_tree(tree, masks)

    def model_cost(self, r0, jvp_fn, delta, x, data):
        """LOCAL masked model cost 0.5*sum((r + J delta)^2)."""
        self.set_offsets()
        jd = jvp_fn(delta)
        x_ext = self._ext_tree(x)
        data_ext = self._ext_data(data)
        total = jnp.zeros((), dtype=self.dtype)
        for g, f0, fd in zip(self.base.groups, r0, jd):
            f = jax.tree_util.tree_map(jnp.add, f0, fd)
            m = self.base.exclude_mask(g.ispace.key(), x_ext, data_ext)
            if m is not None:
                mc = self._crop(m, 0)[None]
                f = jnp.where(mc, 0.0, f)
            total = total + 0.5 * jnp.sum(f * f)
        return total


def make_halo_solver(plan, mesh):
    """Build (full_solve_sharded, n_local, halo) for a grid plan on a
    1-D mesh; full_solve_sharded(x, data, sp) runs under shard_map."""
    assert not plan.spec.graphs, "halo path is for grid problems"
    has_sampled = [False]

    def _check(a):
        if isinstance(a, E.SampledAccess):
            has_sampled[0] = True

    for exp in plan.spec.terms:
        E.visit(exp, _check)
    assert not has_sampled[0], (
        "SampledImage reads at dynamic coordinates cannot be halo-bounded; "
        "use the GSPMD path (parallel/mesh.py) for this energy"
    )
    axis_name = mesh.axis_names[0]
    n_dev = mesh.devices.size
    dims = list(plan.dims)
    # array axis 0 = last declared dim (layout contract, dsl/spec.py)
    shard_dim = len(dims) - 1
    H_global = dims[shard_dim]
    assert H_global % n_dev == 0, (
        f"sharded dim {H_global} not divisible by {n_dev} devices"
    )
    n_local = H_global // n_dev
    radius = stencil_radius(plan.spec, shard_dim)
    halo = min(2 * radius, n_local)
    assert 2 * radius <= n_local, (
        f"halo {2*radius} exceeds local rows {n_local}"
    )

    # ProblemFunctions on the extended local shape, with GLOBAL real
    # shapes so bounds/Index/real-domain tests use global coordinates
    dims_ext = list(dims)
    dims_ext[shard_dim] = n_local + 2 * halo
    spec = ProblemSpec()
    env = EnergyEnv(spec, dims_ext)
    from ..runtime.api import _run_energy

    _run_energy(plan.problem.energy, env)
    real_shapes = {}
    for im in plan.spec.images.values():
        real_shapes[im.ispace.key()] = im.ispace.shape
    base = ProblemFunctions(spec, plan.funcs.dtype, real_shapes=real_shapes)
    sharded = ShardedGridFuncs(base, halo, n_local, axis_name, n_dev)

    import copy

    cfg = copy.copy(plan.config)
    cfg.psum_axis = axis_name
    _, _, _, _, full_solve = make_solver(sharded, cfg)

    def body(x, data, sp):
        sharded.set_offsets()
        return full_solve(x, data, sp)

    nd = None
    for im in plan.spec.images.values():
        nd = im.ispace.ndims
        break
    img_spec = P(axis_name, *([None] * nd))  # (rows, ..., C)
    state_x_spec = img_spec
    scal = P()

    def specs_of_data(data):
        return {
            "images": {n: img_spec for n in data["images"]},
            "params": {n: scal for n in data["params"]},
            "graph_indices": {},
        }

    def solve(x, data, sp):
        in_specs = (
            {n: state_x_spec for n in x},
            specs_of_data(data),
            {n: scal for n in sp},
        )
        out_specs = {
            "x": {n: state_x_spec for n in x},
            "prev_cost": scal,
            "radius": scal,
            "decrease_f": scal,
            "ssq": (
                {n: state_x_spec for n in x}
                if plan.config.uses_lambda
                else scal
            ),
            "n_iter": scal,
            "done": scal,
        }
        fn = jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        return fn(x, data, sp)

    return solve, n_local, halo


def solve_sharded_halo(plan, inputs, mesh, n_iterations=None):
    """Full solve through the explicit halo-exchange path; returns the
    final cost (replicated scalar).  Counterpart of
    parallel.mesh.solve_sharded (the GSPMD path)."""
    from . import mesh as pmesh

    x, data = plan.bind(inputs, graph_mode="take")
    solve, _, _ = make_halo_solver(plan, mesh)
    x, data = pmesh.shard_problem(plan, x, data, mesh)
    sp = plan._sp_device()
    sp["nIterations"] = jnp.asarray(
        int(n_iterations or plan.solver_params["nIterations"]), jnp.int32
    )
    with mesh:
        st = jax.jit(solve)(x, data, sp)
        jax.block_until_ready(st)
    plan._state = st
    plan._data = data
    return float(st["prev_cost"])
