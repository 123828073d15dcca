"""Gauss-Newton / Levenberg-Marquardt solver with a PCG inner loop.

Faithful JAX re-expression of the reference solver engine
(reference: API/src/solverGPUGaussNewton.t).  Where the reference launches
~26 per-ispace kernels with host syncs at every reduction read
(ReduceVar memcpyDevice2Host), the whole outer iteration here is a single
jitted JAX program: the PCG loop is a lax.while_loop, the five PCG scalars
live on device, and LM's trust-region accept/reject is branchless
(jnp.where) -- no host round-trips inside an outer step.

Numerics kept bit-for-bit-in-structure with the reference:
 * guardedInvert (CERES / MODIFIED_CERES / EPSILON_ADD),
   solverGPUGaussNewton.t:478-507;
 * PCGInit1: r = -J^T F, pre = 1/guard(diag(J^T J)), p = M^-1 r,
   alpha_num = r.p (:521-598);
 * PCGStep1/2/3 (:607-852) incl. LM q = 0.5*delta.(r+b) (:713-719);
 * LM residual re-computation every residual_reset_period iterations
   (PCGStep2_1stHalf + computeAdelta + PCGStep2_2ndHalf, :738-813, 2128-2139);
 * PCGComputeCtC (diag/radius, o.t:2996-3057), PCGSaveSSq,
   PCGFinalizeDiagonal (Jacobi scaling ONCE_PER_SOLVE, clamping,
   pre = 1/(CtC_clamped + radius*CtC_raw)) (:1042-1103);
 * Q-based zeta early exit: zeta = (i+1)(Q1-Q0)/Q1 < q_tolerance (:2211-2220);
 * trust-region accept/reject exactly as Ceres' StepAccepted (:2247-2292).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# pytree vector helpers (the 12 work vectors of PlanData, dict-of-arrays here)
# ---------------------------------------------------------------------------

tmap = jax.tree_util.tree_map


def tzeros_like(t):
    return tmap(jnp.zeros_like, t)


def tdot(a, b):
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    tot = None
    for x, y in zip(leaves_a, leaves_b):
        s = jnp.sum(x * y)
        tot = s if tot is None else tot + s
    return tot


def tadd(a, b):
    return tmap(jnp.add, a, b)


def tsub(a, b):
    return tmap(jnp.subtract, a, b)


def tscale(s, a):
    return tmap(lambda x: s * x, a)


def taxpy(s, a, b):
    """b + s*a"""
    return tmap(lambda x, y: y + s * x, a, b)


def tmul(a, b):
    return tmap(jnp.multiply, a, b)


def _safe_div(a, b):
    return jnp.where(b != 0, a / jnp.where(b != 0, b, 1.0), 0.0)


# ---------------------------------------------------------------------------
# solver parameter defaults (solverGPUGaussNewton.t:41-55)
# ---------------------------------------------------------------------------

SOLVER_PARAMETER_DEFAULTS = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 0.0001,
    "function_tolerance": 0.000001,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
    "nIterations": 10,
    "lIterations": 10,
}

GUARDED_INVERT_TYPES = ("CERES", "MODIFIED_CERES", "EPSILON_ADD")
JACOBI_SCALING_TYPES = ("NONE", "ONCE_PER_SOLVE", "EVERY_ITERATION")


def guarded_invert(d, kind, dtype):
    """solverGPUGaussNewton.t:478-507."""
    one = jnp.asarray(1.0, dtype)
    if kind == "CERES":
        g = one / jnp.square(one + jnp.sqrt(jnp.maximum(d, 0.0)))
    elif kind == "MODIFIED_CERES":
        g = one / (one + d)
    elif kind == "EPSILON_ADD":
        eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
        g = one / (eps + d)
    else:
        raise ValueError(kind)
    return g


class SolverConfig:
    """Compile-time knobs (initialization_parameters,
    solverGPUGaussNewton.t:29-39)."""

    def __init__(
        self,
        uses_lambda=False,
        guarded_invert_type="CERES",
        jacobi_scaling="ONCE_PER_SOLVE",
        use_materialized_jacobian=False,
        use_fused_jtj=False,
        pcg_variant="classic",
        psum_axis=None,
    ):
        assert guarded_invert_type in GUARDED_INVERT_TYPES
        assert jacobi_scaling in JACOBI_SCALING_TYPES
        self.uses_lambda = uses_lambda
        self.guarded_invert_type = guarded_invert_type
        self.jacobi_scaling = jacobi_scaling
        self.use_materialized_jacobian = use_materialized_jacobian
        self.use_fused_jtj = use_fused_jtj
        assert pcg_variant in ("classic", "pipelined")
        self.pcg_variant = pcg_variant
        # mesh axis name for cross-device reductions: set by the explicit
        # shard_map halo path (parallel/halo.py) so the 5 PCG scalars and
        # the cost psum over the mesh (everything else stays local)
        self.psum_axis = psum_axis


def make_solver(funcs, config: SolverConfig):
    """Build (init_fn, step_fn, cost_fn) over ProblemFunctions.

    State pytree:
      x            dict name -> unknown array
      prev_cost    scalar (the published cost, printed as 'final cost=')
      radius       LM trust-region radius
      decrease_f   LM radius decrease factor
      ssq          pytree: saved guarded-invert diag at nIter==0 (PCGSaveSSq)
      n_iter       int32
      done         bool (LM early exits)
    """
    dtype = funcs.dtype
    uses_lambda = config.uses_lambda
    ginv = functools.partial(
        guarded_invert, kind=config.guarded_invert_type, dtype=dtype
    )
    if config.psum_axis is not None:
        ax = config.psum_axis
        gdot = lambda a, b: jax.lax.psum(tdot(a, b), ax)
        gsum = lambda v: jax.lax.psum(v, ax)
    else:
        gdot = tdot
        gsum = lambda v: v

    def init_fn(x, data, sp):
        cost0 = gsum(funcs.cost(x, data))
        state = {
            "x": x,
            "prev_cost": cost0,
            "radius": jnp.asarray(sp["trust_region_radius"], dtype),
            "decrease_f": jnp.asarray(sp["radius_decrease_factor"], dtype),
            # SSq (PCGSaveSSq) only exists for LM; GN carries a scalar
            # placeholder so the loop state stays small
            "ssq": tmap(jnp.ones_like, x) if uses_lambda
                   else jnp.zeros((), dtype),
            "n_iter": jnp.asarray(0, jnp.int32),
            "done": jnp.asarray(False),
        }
        return state

    def pcg_pipelined(A, pre, r_init, sp, masks_apply):
        """Pipelined PCG (Ghysels & Vanroose 2014; see PAPERS.md).

        Algebraically identical to classic PCG but with recurrences for
        s = A p, q = M^-1 s, z = A q, so the two reductions per iteration
        are independent of the A-apply -- on a multi-chip mesh the psum
        latency overlaps the halo-exchanged operator.  GN only (LM's
        residual reset and Q-sequence are defined on the classic loop).
        """
        L = jnp.asarray(sp["lIterations"], jnp.int32)
        M = lambda v: masks_apply(tmul(pre, v))

        r0 = r_init
        u0 = M(r0)
        w0 = A(u0)
        zl = tzeros_like(r0)
        carry0 = {
            "delta": tzeros_like(r0),
            "r": r0, "u": u0, "w": w0,
            "z": zl, "q": zl, "s": zl, "p": zl,
            "gamma": jnp.asarray(0.0, dtype),
            "alpha": jnp.asarray(1.0, dtype),
            "i": jnp.asarray(0, jnp.int32),
        }

        def cond(c):
            return c["i"] < L

        def body(c):
            i = c["i"]
            gamma = gdot(c["r"], c["u"])
            delta_d = gdot(c["w"], c["u"])
            m = M(c["w"])
            n = A(m)
            first = i == 0
            beta = jnp.where(first, 0.0, _safe_div(gamma, c["gamma"]))
            denom = delta_d - beta * _safe_div(gamma, c["alpha"])
            alpha = jnp.where(
                first, _safe_div(gamma, delta_d), _safe_div(gamma, denom)
            )
            z = taxpy(beta, c["z"], n)
            q = taxpy(beta, c["q"], m)
            s = taxpy(beta, c["s"], c["w"])
            p = taxpy(beta, c["p"], c["u"])
            return {
                "delta": taxpy(alpha, p, c["delta"]),
                "r": taxpy(-alpha, s, c["r"]),
                "u": taxpy(-alpha, q, c["u"]),
                "w": taxpy(-alpha, z, c["w"]),
                "z": z, "q": q, "s": s, "p": p,
                "gamma": gamma, "alpha": alpha,
                "i": i + 1,
            }

        out = jax.lax.while_loop(cond, body, carry0)
        return out["delta"]

    def pcg_loop(A, pre, r_init, b, sp, masks_apply):
        """The PCG inner loop.  A: p -> (J^T J + CtC) p, pre: M^-1 diag."""
        if config.pcg_variant == "pipelined" and not uses_lambda:
            return pcg_pipelined(A, pre, r_init, sp, masks_apply)

        L = jnp.asarray(sp["lIterations"], jnp.int32)
        period = jnp.asarray(sp["residual_reset_period"], jnp.int32)
        q_tol = jnp.asarray(sp["q_tolerance"], dtype)

        p0 = masks_apply(tmul(pre, r_init))
        an0 = gdot(r_init, p0)
        delta0 = tzeros_like(r_init)
        q0 = jnp.asarray(0.0, dtype)  # Q0: delta=0 -> q=0 (:1092-1096)

        carry0 = {
            "delta": delta0,
            "r": r_init,
            "p": p0,
            "an": an0,
            "Q0": q0,
            "i": jnp.asarray(0, jnp.int32),
            "brk": jnp.asarray(False),
        }

        def cond(c):
            return (c["i"] < L) & (~c["brk"])

        def body(c):
            i = c["i"]
            with jax.named_scope("PCGStep1_applyJTJ"):
                Ap = A(c["p"])
            ad = gdot(c["p"], Ap)
            alpha = _safe_div(c["an"], ad)
            delta = taxpy(alpha, c["p"], c["delta"])

            if uses_lambda:
                def reset_branch(_):
                    # recompute r = b - A delta exactly (:2128-2139)
                    Ad = A(delta)
                    return tsub(b, Ad)

                def normal_branch(_):
                    return taxpy(-alpha, Ap, c["r"])

                do_reset = ((i + 1) % period) == 0
                r = jax.lax.cond(do_reset, reset_branch, normal_branch, None)
            else:
                r = taxpy(-alpha, Ap, c["r"])

            z = masks_apply(tmul(pre, r))
            bn = gdot(z, r)
            beta = _safe_div(bn, c["an"])
            p = taxpy(beta, c["p"], z)

            brk = c["brk"]
            Q0 = c["Q0"]
            if uses_lambda:
                q = 0.5 * gdot(delta, tadd(r, b))
                Q1 = q
                zeta = (i + 1).astype(dtype) * _safe_div(Q1 - Q0, Q1)
                brk = zeta < q_tol
                Q0 = Q1

            return {
                "delta": delta,
                "r": r,
                "p": p,
                "an": bn,
                "Q0": Q0,
                "i": i + 1,
                "brk": brk,
            }

        out = jax.lax.while_loop(cond, body, carry0)
        return out["delta"]

    def step_fn(state, data, sp):
        """One nonlinear (outer) iteration; solverGPUGaussNewton.t:1913-2349."""
        x = state["x"]
        masks = funcs.unknown_masks(x, data)

        def masks_apply(tree):
            return funcs.mask_unknown_tree(tree, masks)

        scope = jax.named_scope
        if config.use_materialized_jacobian:
            # CSR analogue: materialize the per-leaf partial
            # fields once per outer iteration (saveJToCRS parity,
            # solverGPUGaussNewton.t:1532-1657) and reuse them in every
            # PCG step.
            from ..sparse.materialize import MaterializedJacobian

            mat = MaterializedJacobian(funcs, x, data)
            if config.use_fused_jtj:
                mat.fuse()
            r0 = funcs.residuals_solve(x, data)
            jvp_fn = mat.apply_J
            jt_fn = mat.apply_JT
            raw_diag = mat.diag()
            if config.use_fused_jtj:
                jtj_apply = mat.apply_fused_JTJ
            else:
                jtj_apply = mat.apply_JTJ
        else:
            r0, jvp_fn, jt_fn = funcs.linearize(x, data)
            raw_diag = funcs.diag_jtj(x, data)
            jtj_apply = lambda p: jt_fn(jvp_fn(p))

        neg_jtf = masks_apply(tmap(lambda v: -v, funcs.jtf(r0, jt_fn)))
        diag = masks_apply(raw_diag)

        if funcs.use_preconditioner:
            pre = tmap(ginv, diag)
        else:
            pre = tmap(jnp.ones_like, diag)
        pre = masks_apply(pre)

        r = neg_jtf  # residuum = -J^T F (PCGInit1, :530-560)

        if uses_lambda:
            radius = state["radius"]
            # PCGSaveSSq at nIter==0 stores the *guarded-inverted* diag
            is_first = state["n_iter"] == 0
            ssq = tmap(
                lambda s, p_: jnp.where(is_first, p_, s), state["ssq"], pre
            )
            ctc_raw = tscale(1.0 / radius, diag)  # computeCtC (o.t:3019)
            if config.jacobi_scaling == "ONCE_PER_SOLVE":
                inv_s_sq = tmap(lambda s: _safe_div(jnp.ones_like(s), s), ssq)
            elif config.jacobi_scaling == "EVERY_ITERATION":
                inv_s_sq = tmap(lambda p_: _safe_div(jnp.ones_like(p_), p_), pre)
            else:
                inv_s_sq = tmap(jnp.ones_like, diag)
            min_d = jnp.asarray(sp["min_lm_diagonal"], dtype)
            max_d = jnp.asarray(sp["max_lm_diagonal"], dtype)
            ctc = tmap(
                lambda c, isq: jnp.clip(
                    c, min_d * isq / radius, max_d * isq / radius
                ),
                ctc_raw,
                inv_s_sq,
            )
            # true preconditioner: 1/(CtC + radius*CtC_raw) = 1/(CtC + diag)
            pre = tmap(
                lambda c, d_: _safe_div(jnp.ones_like(c), c + d_), ctc, diag
            )
            pre = masks_apply(pre)
            b = r  # pd.b = residuum (:1087)

            def A(p):
                out = jtj_apply(p)
                out = tmap(lambda o, c, p_: o + c * p_, out, ctc, p)
                return masks_apply(out)

        else:
            ssq = state["ssq"]
            b = r

            def A(p):
                return masks_apply(jtj_apply(p))

        with scope("pcg_loop"):
            delta = pcg_loop(A, pre, r, b, sp, masks_apply)

        with scope("linear_update_and_cost"):
            x_new = tadd(x, masks_apply(delta))
            new_cost = gsum(funcs.cost(x_new, data))

        if not uses_lambda:
            return {
                "x": x_new,
                "prev_cost": new_cost,
                "radius": state["radius"],
                "decrease_f": state["decrease_f"],
                "ssq": ssq,
                "n_iter": state["n_iter"] + 1,
                "done": state["done"],
            }

        # ---- LM trust-region accept / reject (:2247-2292) ----
        model_cost = gsum(funcs.model_cost(r0, jvp_fn, delta, x, data))
        model_cost_change = state["prev_cost"] - model_cost
        cost_change = state["prev_cost"] - new_cost
        relative_decrease = _safe_div(cost_change, model_cost_change)
        min_rel = jnp.asarray(sp["min_relative_decrease"], dtype)
        accept = (cost_change >= 0) & (relative_decrease > min_rel)

        # accepted branch
        ftol = jnp.asarray(sp["function_tolerance"], dtype)
        ftol_reached = cost_change <= state["prev_cost"] * ftol
        step_quality = relative_decrease
        # powf(2q-1, 3) as an explicit cube (XLA expands constant
        # integer powers to the same multiplies)
        tmp_base = 2.0 * step_quality - 1.0
        tmp_factor = 1.0 - tmp_base * tmp_base * tmp_base
        radius_acc = state["radius"] / jnp.maximum(1.0 / 3.0, tmp_factor)
        radius_acc = jnp.minimum(
            radius_acc, jnp.asarray(sp["max_trust_region_radius"], dtype)
        )

        # rejected branch
        radius_rej = state["radius"] / state["decrease_f"]
        min_radius = jnp.asarray(sp["min_trust_region_radius"], dtype)
        radius_too_small = radius_rej <= min_radius

        # On the function-tolerance exit the reference returns *before*
        # updating radius/decrease_factor/prevCost (:2254-2259), so the
        # printed final cost is the pre-step cost; replicate that.
        take_acc = accept & (~ftol_reached)
        radius = jnp.where(
            take_acc, radius_acc, jnp.where(accept, state["radius"], radius_rej)
        )
        decrease_f = jnp.where(
            take_acc,
            2.0,
            jnp.where(accept, state["decrease_f"], 2.0 * state["decrease_f"]),
        )
        done = state["done"] | jnp.where(
            accept, ftol_reached, radius_too_small
        )
        x_out = tmap(
            lambda new, old: jnp.where(accept, new, old), x_new, x
        )
        prev_cost = jnp.where(take_acc, new_cost, state["prev_cost"])

        return {
            "x": x_out,
            "prev_cost": prev_cost,
            "radius": radius.astype(dtype),
            "decrease_f": decrease_f.astype(dtype),
            "ssq": ssq,
            "n_iter": state["n_iter"] + 1,
            "done": done,
        }

    def cost_fn(state, data):
        return funcs.cost(state["x"], data)

    def full_solve_fn(x, data, sp):
        """init + whole outer loop in one program (single dispatch)."""
        return solve_fn(init_fn(x, data, sp), data, sp)

    def solve_fn(state, data, sp):
        """Whole solve on device: while n_iter < nIterations and not done."""
        n_max = jnp.asarray(sp["nIterations"], jnp.int32)

        def cond(s):
            return (s["n_iter"] < n_max) & (~s["done"])

        def body(s):
            return step_fn(s, data, sp)

        return jax.lax.while_loop(cond, body, state)

    return init_fn, step_fn, cost_fn, solve_fn, full_solve_fn
