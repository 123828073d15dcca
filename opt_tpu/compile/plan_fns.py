"""ProblemFunctions: the pure-JAX callables a plan's solver runs on.

This layer replaces the reference's derivative synthesizers + generated
kernels (reference: API/src/o.t:2770-3129 createcost/createjtf*/createjtj*/
computeCtC*/createmodelcost*):

  residuals(x, data)   -> list of per-group residual fields (UNMASKED -- the
                          reference's J includes rows whose center pixel is
                          excluded; only the *cost* kernels gate on exclusion,
                          solverGPUGaussNewton.t:530-560 vs :971-1000)
  cost(x, data)        -> 0.5 * sum of squared *masked* fields (createcost,
                          o.t:3119-3129)
  jtf / jtjp           -> via jax.linearize + jax.linear_transpose (replacing
                          createjtfcentered o.t:2870 / createjtjcentered
                          o.t:2770 and the graph scatter variants)
  diag_jtj(x, data)    -> structural gather of squared per-leaf partials
                          (the Jacobi preconditioner, o.t:2894-2903)

Exclusion masks zero the *unknown-side* of every operator (excluded unknowns
never move: PCGLinearUpdate gate, solverGPUGaussNewton.t:855-862).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..dsl import expr as E
from . import evaluate as ev
from .terms import classify_terms, classify_excludes


class ProblemFunctions:
    def __init__(self, spec, dtype, real_shapes=None):
        self.spec = spec
        self.dtype = dtype
        # ispace key -> real (global) spatial shape, when the spec's dims
        # are a halo-extended local window (parallel/halo.py)
        self.real_shapes = real_shapes or {}
        # per-axis GLOBAL coordinate of local array [0,..] (possibly
        # traced), set by the shard_map halo path (parallel/halo.py) so
        # bounds/Index/real-domain tests use global positions
        self.coord_offsets = None
        self.groups = classify_terms(spec)
        self.excludes = classify_excludes(spec)  # ispace key -> exprs
        self.use_preconditioner = spec.use_preconditioner
        self.unknowns = spec.unknowns  # name -> Image handle
        self.unknown_shapes = {
            n: im.ispace.shape + (im.channels,)
            for n, im in self.unknowns.items()
        }
        # const views of unknowns: a non-unknown Array declared at the same
        # bind index as an Unknown aliases its buffer in the reference's
        # by-index binding (e.g. r_const in
        # intrinsic_image_decomposition.t:7).  Values track the unknown;
        # gradients are blocked (the reference classifies them as constant).
        self.aliases = {}
        unknown_idx = {
            im.idx: n for n, im in self.unknowns.items() if im.idx is not None
        }
        for n, im in spec.images.items():
            if not im.is_unknown and im.idx is not None:
                target = unknown_idx.get(im.idx)
                if target is not None:
                    self.aliases[n] = target

    # -- contexts ------------------------------------------------------------

    def _group_shape(self, group, data):
        if group.kind == "centered":
            return group.ispace.shape
        band = (data.get("graph_banding") or {}).get(group.graph.name)
        if band is not None:
            # banded engine: edge domain stays in the blocked 2-D tiling
            # (n_eblk, eb) end-to-end (see ops/graph_banded.banded_gather)
            return (band.n_eblk, band.eb)
        any_slot = next(iter(group.graph.slots))
        return data["graph_indices"][group.graph.name][any_slot].shape

    def _images(self, x, data):
        images = dict(data["images"])
        images.update(x)
        for alias, target in self.aliases.items():
            images[alias] = jax.lax.stop_gradient(x[target])
        return images

    def _ctx(self, group, x, data):
        images = self._images(x, data)
        real = None
        if group.kind == "centered":
            real = self.real_shapes.get(group.ispace.key())
        return ev.EvalContext(
            domain="grid" if group.kind == "centered" else "graph",
            shape=self._group_shape(group, data),
            images=images,
            params=data["params"],
            graph_indices=data.get("graph_indices", {}),
            dtype=self.dtype,
            real_shape=real,
            graph_banding=data.get("graph_banding"),
            coord_offset=self.coord_offsets,
            unknown_names=self.unknowns,
        )

    def exclude_mask(self, ispace_key, x, data):
        """Boolean 'excluded' mask over one index space, or None."""
        exprs = self.excludes.get(ispace_key)
        if not exprs and ispace_key not in self.real_shapes:
            return None
        exprs = exprs or []
        shape = None
        for im in self.spec.images.values():
            if im.ispace.key() == ispace_key:
                shape = im.ispace.shape
                break
        images = self._images(x, data)
        ctx = ev.EvalContext(
            domain="grid",
            shape=shape,
            images=images,
            params=data["params"],
            graph_indices=data.get("graph_indices", {}),
            dtype=self.dtype,
            real_shape=self.real_shapes.get(ispace_key),
            coord_offset=self.coord_offsets,
        )
        m = None
        for e in exprs:
            v = ctx.eval(e)
            v = v if v.dtype == jnp.bool_ else (v != 0)
            v = jnp.broadcast_to(v, shape)
            m = v if m is None else (m | v)
        real = self.real_shapes.get(ispace_key)
        if real is not None:
            rm = ev.real_domain_mask(shape, real, self.coord_offsets)
            if rm is not None:
                m = (~rm) if m is None else (m | (~rm))
        return m

    def unknown_masks(self, x, data):
        """Per-unknown 'excluded' masks of shape (*spatial, 1), or None."""
        cache = {}
        out = {}
        for n, im in self.unknowns.items():
            k = im.ispace.key()
            if k not in cache:
                cache[k] = self.exclude_mask(k, x, data)
            m = cache[k]
            if m is None:
                out[n] = None
            else:
                out[n] = m[..., None]
        return out

    def mask_unknown_tree(self, tree, masks):
        def apply(m, v):
            if m is None:
                return v
            return jnp.where(m, 0.0, v)

        return {n: apply(masks[n], v) for n, v in tree.items()}

    # -- residual fields -------------------------------------------------------

    def residual_fields(self, x, data, masked):
        """List over groups of (n_channels, *domain) stacked fields."""
        out = []
        for g in self.groups:
            ctx = self._ctx(g, x, data)
            fields = [ev.eval_field(e, ctx) for e in g.exprs]
            if g.kind == "centered" and ctx.real_shape is not None:
                rm = ev.real_domain_mask(ctx.shape, ctx.real_shape,
                                         self.coord_offsets)
                if rm is not None:
                    fields = [jnp.where(rm, f, 0.0) for f in fields]
            if g.kind == "graph":
                # banded layout pads edge rows; padded rows are not real
                # residuals (their J rows are structurally zero, but the
                # residual value itself can be nonzero for energies with
                # constant terms) -- zero them like real_domain_mask
                band = ctx.graph_banding.get(g.graph.name)
                if band is not None:
                    pm = band.pad_mask
                    fields = [jnp.where(pm, f, 0.0) for f in fields]
            if masked and g.kind == "centered":
                m = self.exclude_mask(g.ispace.key(), x, data)
                if m is not None:
                    fields = [jnp.where(m, 0.0, f) for f in fields]
            out.append(jnp.stack(fields))
        return out

    def residuals_solve(self, x, data):
        return self.residual_fields(x, data, masked=False)

    def cost(self, x, data):
        fields = self.residual_fields(x, data, masked=True)
        total = jnp.zeros((), dtype=self.dtype)
        for f in jax.tree_util.tree_leaves(fields):
            total = total + 0.5 * jnp.sum(f * f)
        return total

    def model_cost(self, r0, jvp_fn, delta, x, data):
        """0.5 * sum of masked (r + J delta)^2 (createmodelcost, o.t:2915)."""
        jd = jvp_fn(delta)
        total = jnp.zeros((), dtype=self.dtype)
        for g, f0, fd in zip(self.groups, r0, jd):
            f = jax.tree_util.tree_map(jnp.add, f0, fd)
            if g.kind == "centered":
                m = self.exclude_mask(g.ispace.key(), x, data)
                if m is not None:
                    f = jax.tree_util.tree_map(
                        lambda v: jnp.where(m[None], 0.0, v), f
                    )
            for leaf in jax.tree_util.tree_leaves(f):
                total = total + 0.5 * jnp.sum(leaf * leaf)
        return total

    # -- linearization ---------------------------------------------------------

    def linearize(self, x, data):
        """(r0, jvp, jt): matrix-free J and J^T at the current point."""
        fn = lambda xx: self.residuals_solve(xx, data)
        r0, jvp_fn = jax.linearize(fn, x)
        jt_fn = jax.linear_transpose(jvp_fn, x)

        def jt(cotangents):
            (g,) = jt_fn(cotangents)
            return g

        return r0, jvp_fn, jt

    def jtf(self, r0, jt):
        """J^T F -- gradient of the (unmasked) half-sum-of-squares."""
        return jt(r0)

    # -- diag(J^T J) ------------------------------------------------------------

    def _computed_structure(self, g):
        """Distinct ComputedArray taps + direct unknown leaves of a
        centered group, for the chain-rule leaf-partials path.

        Returns (taps, direct, cimages, buf_leaves) or None when the
        group has no computed reads or uses structure the chain rule
        does not cover (nested ComputedArrays, SampledImage)."""
        if g.kind != "centered":
            return None
        taps, direct, cimages = {}, {}, {}
        ok = [True]

        def on(a):
            if isinstance(a, E.ComputedAccess):
                taps.setdefault(a.key(), a)
                cimages[a.cimage.name] = a.cimage
            elif isinstance(a, E.ImageAccess) and a.image.is_unknown:
                direct.setdefault(a.key(), a)
            elif isinstance(a, E.SampledAccess):
                ok[0] = False

        for exp in g.exprs:
            E.visit(exp, on)
        if not taps or not ok[0]:
            return None
        buf_leaves = {}
        for cname, ci in cimages.items():
            d = {}

            def onb(a):
                if isinstance(a, (E.ComputedAccess, E.SampledAccess)):
                    ok[0] = False
                elif isinstance(a, E.ImageAccess) and a.image.is_unknown:
                    if not isinstance(a.index, E.Offset):
                        ok[0] = False
                    d.setdefault(a.key(), a)

            for ch_expr in ci.exprs:
                E.visit(ch_expr, onb)
            buf_leaves[cname] = d
        if not ok[0]:
            return None
        return taps, direct, cimages, buf_leaves

    def _leaf_partials_computed(self, g, x, data):
        """Chain-rule leaf partials for a ComputedArray-using group.

        The inline path re-expands the computed expression at EVERY tap
        and differentiates the expansion per composed leaf -- for SFS
        that evaluates the shading expression once per (tap x leaf).
        Here the buffer stays materialized (the production residual
        path, o.t:3131-3153) and the chain rule composes two small
        linearizations instead:

            dB_w   = d(buffer)/d(unknown at w)      (per buffer leaf)
            G_p    = d(residual)/d(buffer tap p)    (taps as pseudo-
            G_a    = d(residual)/d(direct leaf a)    leaves, via
                                                     computed_overrides)
            dr/d(u at p+w) = G_a[p+w] + sum_p G_p * shift_p(dB_w)

        Boundary semantics actually IMPROVE on the inline view: the
        shifted dB fields zero-fill exactly like the production buffer
        reads, where inline expansion differentiated through values the
        solve path never uses (both are masked by the energies' bounds
        guards in practice).  Returns (g, leaves, D) matching the inline
        contract, or None to fall back."""
        st = self._computed_structure(g)
        if st is None:
            return None
        taps, direct, cimages, buf_leaves = st
        read_ctx = self._ctx(g, x, data)

        def one_hots(vals):
            for i in range(len(vals)):
                yield tuple(
                    jnp.ones_like(v) if j == i else jnp.zeros_like(v)
                    for j, v in enumerate(vals)
                )

        # -- buffer partials: dB/d(leaf) per computed channel ----------
        dB = {}
        for cname, ci in cimages.items():
            bl = list(buf_leaves[cname].values())
            if not bl:
                continue
            bkeys = [a.key() for a in bl]
            bvals = tuple(read_ctx.read_image(a) for a in bl)

            def bfun(vals, ci=ci, bkeys=bkeys):
                ctx = self._ctx(g, x, data)
                ctx.leaf_overrides = dict(zip(bkeys, vals))
                outs = []
                for ch_expr in ci.exprs:
                    v = jnp.asarray(ctx.eval(ch_expr))
                    if v.dtype != self.dtype:
                        v = v.astype(self.dtype)
                    outs.append(jnp.broadcast_to(v, ctx.shape))
                return outs

            _, bjvp = jax.linearize(bfun, bvals)
            for a, tangents in zip(bl, one_hots(bvals)):
                for ch, fld in enumerate(bjvp(tangents)):
                    dB[(cname, ch, a.key())] = fld

        # -- residual partials w.r.t. direct leaves + buffer taps ------
        dl = list(direct.values())
        dkeys = [a.key() for a in dl]
        tap_list = list(taps.items())
        dvals = tuple(read_ctx.read_image(a) for a in dl)
        tvals = tuple(read_ctx.eval(node) for _, node in tap_list)
        n_d = len(dl)

        def gfun(all_vals):
            ctx = self._ctx(g, x, data)
            ctx.leaf_overrides = dict(zip(dkeys, all_vals[:n_d]))
            ctx.computed_overrides = {
                tkey: v
                for (tkey, _), v in zip(tap_list, all_vals[n_d:])
            }
            fields = [ev.eval_field(e, ctx) for e in g.exprs]
            if ctx.real_shape is not None:
                rm = ev.real_domain_mask(ctx.shape, ctx.real_shape,
                                         self.coord_offsets)
                if rm is not None:
                    fields = [jnp.where(rm, f, 0.0) for f in fields]
            return jnp.stack(fields)

        all_vals = dvals + tvals
        _, jvp_fn = jax.linearize(gfun, all_vals)
        partials = [jvp_fn(t) for t in one_hots(all_vals)]

        totals = {}
        for k, fld in zip(dkeys, partials[:n_d]):
            totals[k] = totals[k] + fld if k in totals else fld
        for ((_tag, cname, ch, p), _node), gt in zip(
                tap_list, partials[n_d:]):
            for a in buf_leaves[cname].values():
                # tap offset p composes with the buffer leaf offset w:
                # dr/d(u at p+w) accumulates G_p * shift_p(dB_w)
                dfld = dB[(cname, ch, a.key())]
                if any(p):
                    dfld = ev.shift_read(dfld, p)
                ckey = (a.image.name, a.index.shift(p), a.channel)
                contrib = gt * dfld
                totals[ckey] = (
                    totals[ckey] + contrib if ckey in totals else contrib
                )
        if any(a.key() not in totals for a in g.unknown_leaves):
            return None  # structure mismatch: fall back to inline
        D = [totals[a.key()] for a in g.unknown_leaves]
        return g, list(g.unknown_leaves), D

    def leaf_partials(self, x, data):
        """Per-group elementwise partial fields dr/da for every unknown leaf.

        Each term group's residual fields depend on their gathered unknown
        leaves pointwise, so a one-hot-ones JVP yields the elementwise
        partial field dr/da.  This is the structured, dense form of J --
        used for diag(J^T J) (the Jacobi preconditioner,
        createjtfcentered o.t:2894-2903), for the materialized-Jacobian mode
        (opt_tpu/sparse/materialize.py), and for CSR export (dumpJ parity).

        ComputedArray-using centered groups route through the chain-rule
        path (_leaf_partials_computed) so the buffer is differentiated
        once instead of once per tap; same yielded contract.

        Yields (group, leaves, [D_a fields of shape (n_channels, *domain)]).
        """
        gidx = data.get("graph_indices", {})
        for g in self.groups:
            leaves = g.unknown_leaves
            if not leaves:
                continue
            res = self._leaf_partials_computed(g, x, data)
            if res is not None:
                yield res
                continue
            keys = [a.key() for a in leaves]
            # read leaf values through a context so graph reads share one
            # batched gather per vertex slot (EvalContext._slot_gather)
            read_ctx = self._ctx(g, x, data)
            leaf_vals = tuple(read_ctx.read_image(a) for a in leaves)

            def gfun(vals, g=g, keys=keys):
                ctx = self._ctx(g, x, data)
                ctx.leaf_overrides = dict(zip(keys, vals))
                fields = [ev.eval_field(e, ctx) for e in g.exprs]
                if g.kind == "centered" and ctx.real_shape is not None:
                    # rows centered in the padding do not exist in the
                    # real problem (their InBounds guards test neighbors,
                    # not the center) -- zero them like residual_fields
                    rm = ev.real_domain_mask(ctx.shape, ctx.real_shape,
                                             self.coord_offsets)
                    if rm is not None:
                        fields = [jnp.where(rm, f, 0.0) for f in fields]
                if g.kind == "graph":
                    # banded-layout pad rows are not real residuals; their
                    # partials must be zero BEFORE the diag scatter (the
                    # ELL row-sum scatter has no structural pad drop)
                    band = ctx.graph_banding.get(g.graph.name)
                    if band is not None:
                        pm = band.pad_mask
                        fields = [jnp.where(pm, f, 0.0) for f in fields]
                return jnp.stack(fields)

            _, jvp_fn = jax.linearize(gfun, leaf_vals)
            # one sequential jvp per leaf: XLA folds the zero-tangent
            # terms of each one-hot call, where a vmapped batch over basis
            # tangents would materialize the stacked basis
            D = []
            for i in range(len(leaves)):
                tangents = tuple(
                    jnp.ones_like(v) if j == i else jnp.zeros_like(v)
                    for j, v in enumerate(leaf_vals)
                )
                D.append(jvp_fn(tangents))  # (n_channels, *domain)
            yield g, leaves, D

    def diag_jtj(self, x, data):
        """Exact diag(J^T J): squared leaf partials gathered back onto the
        unknowns (inverse shift for grids / index-add for graphs).

        Channel accumulation uses per-channel lists + a final stack rather
        than .at[..., c].add so the centered path contains no scatter ops."""
        acc = {
            n: [jnp.zeros(s[:-1], dtype=self.dtype) for _ in range(s[-1])]
            for n, s in self.unknown_shapes.items()
        }
        gidx = data.get("graph_indices", {})
        # graph-side squared partials are batched per (graph, slot): all
        # leaf channels sharing a vertex slot stack into one (E, K) column
        # block scattered in ONE banded_scatter / segment_sum, instead of
        # K separate C=1 scatters
        pending = {}  # (gname, slot) -> list of (img_name, channel, d2)
        for g, leaves, D in self.leaf_partials(x, data):
            for a, d in zip(leaves, D):
                d2 = jnp.sum(d * d, axis=0)
                img = a.image
                if isinstance(a.index, E.Offset):
                    contrib = ev.scatter_shift(d2, a.index.data)
                    acc[img.name][a.channel] = (
                        acc[img.name][a.channel] + contrib
                    )
                else:
                    key = (a.index.graph.name, a.index.slot)
                    pending.setdefault(key, []).append(
                        (img.name, a.channel, d2)
                    )
        for (gname, slot), items in pending.items():
            stacked = jnp.stack([d2 for _, _, d2 in items], axis=-1)
            band = (data.get("graph_banding") or {}).get(gname)
            if band is not None:
                from ..ops.graph_banded import slot_scatter

                out = slot_scatter(band, slot, stacked)
            else:
                vidx = gidx[gname][slot]
                n_verts = self.unknown_shapes[items[0][0]][0]
                out = jax.ops.segment_sum(
                    stacked, vidx, num_segments=n_verts
                )
            for k, (img_name, chan, _) in enumerate(items):
                acc[img_name][chan] = acc[img_name][chan] + out[:, k]
        return {
            n: jnp.stack(chans, axis=-1) for n, chans in acc.items()
        }
