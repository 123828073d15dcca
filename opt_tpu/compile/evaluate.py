"""Expression -> JAX evaluation.

Replaces the reference's IR builder / scheduler / Terra codegen
(reference: API/src/o.t createfunction o.t:1949-2616).  Each scalar residual
expression evaluates to a whole-domain JAX array:

* centered terms -> one array shaped like the index space (stencil reads are
  zero-padded shifted slices, so XLA fuses the whole residual into one
  stencil kernel);
* graph terms -> one array per edge (image reads through graph slots are
  gathers; their transpose under jax.linear_transpose is the scatter-add the
  reference emits as atomicAddChannel scatters, o.t:2586-2600).

The reference's bounds-check elision, CSE, condition scheduling and register
minimization (o.t:2074-2295) are all delegated to XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..dsl import expr as E

# ---------------------------------------------------------------------------
# NaN-safe derivatives.
#
# The reference evaluates partials inside condition-factored branches
# (ad.splitcondition, ad.t:1027), so guarded expressions like
# Select(greater(x,0), sqrt(x), 0) never evaluate sqrt'(x) at x<=0.  JAX's
# jnp.where computes both branches, and a non-finite partial in the dead
# branch would poison gradients (inf * 0 = nan).  These custom-JVP wrappers
# keep values exact and clamp only the *derivative* away from singular
# points, which is equivalent to the reference wherever the user guarded the
# expression.
# ---------------------------------------------------------------------------

_TINY = 1e-30


@jax.custom_jvp
def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,) = primals
    (t,) = tangents
    y = safe_sqrt(x)
    d = 0.5 / jnp.sqrt(jnp.maximum(x, _TINY))
    return y, d * t


def _div_tiny(dtype):
    """Clamp floor for denominators, chosen so that 1/b, 1/b^2, and a/b^2
    all stay finite in the working dtype: a transpose pass multiplies zero
    cotangents by *individual primitive coefficients*, so each coefficient
    must be finite for dead select branches to stay inert (0 * finite = 0,
    but 0 * inf = nan)."""
    return 1e-10 if jnp.dtype(dtype).itemsize <= 4 else 1e-60


def _clamp_denominator(b):
    """Sign-preserving clamp away from zero.

    Keeps division results finite so that a NaN/inf inside a *dead* select
    branch cannot poison the transpose pass (the reference never evaluates
    dead-branch partials thanks to condition factoring, ad.splitcondition
    ad.t:1027; with jnp.where both branches run, and transpose rules
    multiply stored forward values by zero cotangents -- 0 * inf = nan).
    For any denominator a real energy produces this is exact."""
    mag = jnp.maximum(jnp.abs(b), _div_tiny(jnp.result_type(b)))
    return jnp.where(b < 0, -mag, mag)


@jax.custom_jvp
def safe_div(a, b):
    return a / _clamp_denominator(b)


@safe_div.defjvp
def _safe_div_jvp(primals, tangents):
    a, b = primals
    ta, tb = tangents
    inv = 1.0 / _clamp_denominator(b)
    y = a * inv
    return y, ta * inv - a * inv * inv * tb


@jax.custom_jvp
def safe_log(x):
    return jnp.log(x)


@safe_log.defjvp
def _safe_log_jvp(primals, tangents):
    (x,) = primals
    (t,) = tangents
    return jnp.log(x), t / jnp.maximum(x, _div_tiny(jnp.result_type(x)))


@jax.custom_jvp
def safe_pow(x, y):
    return jnp.power(x, y)


@safe_pow.defjvp
def _safe_pow_jvp(primals, tangents):
    x, y = primals
    tx, ty = tangents
    v = jnp.power(x, y)
    # generous floor: keeps y*x^(y-1) finite in float32 for |y| <= ~8
    tiny = 1e-4 if jnp.result_type(x).itemsize <= 4 else 1e-30
    xs = jnp.where(jnp.abs(x) < tiny, tiny, x)
    dx = y * jnp.power(xs, y - 1.0)
    dy = v * jnp.log(jnp.maximum(jnp.abs(xs), tiny))
    return v, dx * tx + dy * ty


# ---------------------------------------------------------------------------
# domain helpers
# ---------------------------------------------------------------------------


def shift_read(a, offsets):
    """out[p] = a[p + offset], zero outside bounds.

    ``a`` has spatial axes only (one channel); ``offsets`` is in DSL dim
    order (x fastest), i.e. offsets[i] shifts axis (ndim-1-i).  Matches the
    reference's guarded vector loads (o.t:2445-2468) whose OOB value is
    never observed thanks to the bbox guard (o.t:2704-2708).
    """
    nd = a.ndim
    pads = []
    starts = []
    for axis in range(nd):
        o = int(offsets[nd - 1 - axis])
        pads.append((max(0, -o), max(0, o)))
        starts.append(max(0, o))
    if all(p == (0, 0) for p in pads):
        return a
    padded = jnp.pad(a, pads)
    slices = tuple(
        slice(s, s + n) for s, n in zip(starts, a.shape)
    )
    return padded[slices]


def scatter_shift(a, offsets):
    """Adjoint of shift_read: out[p] = a[p - offset], zero outside.

    Used to gather per-residual quantities back onto the unknown grid
    (the gradient gather of o.t:3100-3116 / diag of o.t:2894-2903)."""
    return shift_read(a, tuple(-int(o) for o in offsets))


def bounds_mask(shape, mins, maxs, real_shape=None, coord_offset=None):
    """InBounds mask over the grid (genbounds, o.t:585-607).

    Computed with iota + compares (no materialized constants), so it works
    identically under jit and inside lax loops.
    real_shape: when arrays are a window of a larger domain (the halo
    path's extended local blocks), bounds semantics follow the REAL
    domain sizes.
    coord_offset: per-axis GLOBAL coordinate of the array's [0,...] corner
    (possibly traced, e.g. shard_map row offsets); bounds then test global
    positions against the real (global) sizes."""
    nd = len(shape)
    real = tuple(real_shape) if real_shape is not None else tuple(shape)
    m = None
    for i in range(len(mins)):
        axis = nd - 1 - i
        coord = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), axis)
        if coord_offset is not None:
            coord = coord + coord_offset[axis]
        mi = (coord >= -int(mins[i])) & (coord < real[axis] - int(maxs[i]))
        m = mi if m is None else (m & mi)
    if m is None:
        m = jnp.ones(shape, bool)
    return m


def real_domain_mask(shape, real_shape, coord_offset=None):
    """True inside the real (unpadded, global) domain."""
    nd = len(shape)
    m = None
    for axis in range(nd):
        if coord_offset is None and shape[axis] == real_shape[axis]:
            continue
        coord = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), axis)
        if coord_offset is not None:
            coord = coord + coord_offset[axis]
            mi = (coord >= 0) & (coord < real_shape[axis])
        else:
            mi = coord < int(real_shape[axis])
        m = mi if m is None else (m & mi)
    return m


def index_coords(shape, dim, shift, dtype, coord_offset=None):
    nd = len(shape)
    axis = nd - 1 - dim
    size = shape[axis]
    # integer iota + convert: identical values in f32/f64 for any size
    coord = (jnp.arange(size, dtype=jnp.int32).astype(dtype)
             + jnp.asarray(shift, dtype))
    if coord_offset is not None:
        coord = coord + jnp.asarray(coord_offset[axis], dtype)
    return coord.reshape((1,) * axis + (size,) + (1,) * (nd - axis - 1))


def bilinear_sample(img, x, y):
    """Image:sample parity (o.t:858-877): floor/ceil corners, OOB reads 0."""
    H, W = img.shape
    x0 = jnp.floor(x)
    x1 = jnp.ceil(x)
    y0 = jnp.floor(y)
    y1 = jnp.ceil(y)
    xn = x - x0
    yn = y - y0

    def get(xi, yi):
        xi_i = xi.astype(jnp.int32)
        yi_i = yi.astype(jnp.int32)
        valid = (xi_i >= 0) & (xi_i < W) & (yi_i >= 0) & (yi_i < H)
        xi_c = jnp.clip(xi_i, 0, W - 1)
        yi_c = jnp.clip(yi_i, 0, H - 1)
        return jnp.where(valid, img[yi_c, xi_c], 0.0)

    top = (1.0 - xn) * get(x0, y0) + xn * get(x1, y0)
    bot = (1.0 - xn) * get(x0, y1) + xn * get(x1, y1)
    return (1.0 - yn) * top + yn * bot


def make_sampled_read(img2d, dx2d, dy2d):
    """Bilinear sample whose coordinate-derivatives come from user-supplied
    derivative images (ad.sampledimage partials, o.t:3276-3280)."""

    @jax.custom_jvp
    def sample(x, y):
        return bilinear_sample(img2d, x, y)

    @sample.defjvp
    def _jvp(primals, tangents):
        x, y = primals
        tx, ty = tangents
        v = bilinear_sample(img2d, x, y)
        if dx2d is None or dy2d is None:
            raise ValueError(
                "image derivatives are not defined for this SampledImage "
                "and cannot be used in autodiff"
            )
        gx = bilinear_sample(dx2d, x, y)
        gy = bilinear_sample(dy2d, x, y)
        return v, gx * tx + gy * ty

    return sample


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------


def _as_float(v, dtype):
    if v.dtype == jnp.bool_:
        return v.astype(dtype)
    return v


def _as_bool(v):
    if v.dtype == jnp.bool_:
        return v
    return v != 0


class EvalContext:
    """Carries the runtime arrays an expression evaluates against.

    domain: ('grid', shape_tuple) or ('graph', graph_name, num_edges)
    images: name -> channel-major spatial array (..., C)
    params: name -> 0-d array
    graph_indices: graph_name -> slot_name -> (E,) int32 array
    """

    def __init__(self, domain, shape, images, params, graph_indices, dtype,
                 real_shape=None, graph_banding=None,
                 coord_offset=None, unknown_names=None):
        self.domain = domain
        self.shape = shape  # grid spatial shape, or (E,) for graphs
        self.real_shape = real_shape  # real sizes when arrays are padded
        # per-axis global coordinate of array [0,..] (shard_map halo path)
        self.coord_offset = coord_offset
        self.images = images
        self.params = params
        self.graph_indices = graph_indices
        # gname -> banded-engine device arrays (ops/graph_banded.py);
        # when set for a graph, slot gathers run as one-hot matmuls over
        # the padded (n_vblk*eb,) edge layout
        self.graph_banding = graph_banding or {}
        # names of unknown images: slot gathers keep unknowns in their own
        # block so the tangent/transpose gathers under jax.linearize touch
        # only unknown channels (see _slot_gather)
        self.unknown_names = frozenset(unknown_names or ())
        self.dtype = dtype
        self.memo = {}
        # optional override table: leaf key -> array, used by the structural
        # diag(J^T J) computation to re-route unknown reads through explicit
        # leaf inputs (see plan.py).
        self.leaf_overrides = None
        # optional override table: ComputedAccess.key() -> array.  The
        # chain-rule leaf-partials path (plan_fns._leaf_partials_computed)
        # treats ComputedArray taps as pseudo-leaves: with an override
        # present the tap returns it directly (no expansion, no buffer),
        # so jax.linearize sees d(residual)/d(tap) separately from the
        # buffer's own unknown partials.
        self.computed_overrides = None
        # ComputedArray buffers: name -> [channel arrays], materialized on
        # first access (the reference's precompute, o.t:3131-3153) and
        # shared across every shifted read in this context
        self._computed_cache = {}
        # per-(graph, slot) batched gathers: one wide take per slot instead
        # of one per (image, channel) read, so one gather (and one scatter
        # in the transpose) per vertex slot.
        self._slot_cache = {}

    def _slot_gather(self, gname, slot, n_verts):
        """name -> (per-slot gathered rows, column offset) for one graph.

        Vertex arrays concatenate into TWO blocks -- unknowns and
        constants -- gathered separately.  Per (image, channel) reads are
        cheap slices of a gathered block.  The split matters under
        jax.linearize: with one mixed block the tangent/transpose gathers
        inside the PCG loop carry materialized zero channels for every
        constant (2x gather work); split, the constant block has no
        tangent at all.

        Banded mode gathers ALL slots eagerly in one stacked one-hot dot
        (ops/graph_banded.slots_gather) -- its transpose is likewise one
        stacked scatter dot; take mode stays lazy per slot."""
        band = self.graph_banding.get(gname)
        key = (gname, n_verts) if band is not None else (
            gname, slot, n_verts
        )
        hit = self._slot_cache.get(key)
        if hit is not None:
            return {n: (rows[slot], off) for n, (rows, off) in hit.items()}
        blocks = {}  # is_unknown -> (parts list, name -> column offset)
        for n in sorted(self.images):
            arr = self.images[n]
            if arr.ndim != 2 or arr.shape[0] != n_verts:
                continue
            parts, offsets = blocks.setdefault(
                n in self.unknown_names, ([], {})
            )
            offsets[n] = sum(p.shape[-1] for p in parts)
            parts.append(arr)
        out = {}
        for parts, offsets in blocks.values():
            big = (
                jnp.concatenate(parts, axis=-1) if len(parts) > 1
                else parts[0]
            )
            if band is not None:
                from ..ops.graph_banded import slots_gather

                rows = slots_gather(
                    band, list(self.graph_indices[gname]), big
                )
            else:
                vidx = self.graph_indices[gname][slot]
                rows = {slot: jnp.take(big, vidx, axis=0)}
            for n, off in offsets.items():
                out[n] = (rows, off)
        self._slot_cache[key] = out
        return {n: (rows[slot], off) for n, (rows, off) in out.items()}

    # -- leaf reads --

    def read_image(self, access: E.ImageAccess):
        if self.leaf_overrides is not None:
            ov = self.leaf_overrides.get(access.key())
            if ov is not None:
                return ov
        img = self.images[access.image.name]
        chan = img[..., access.channel]
        idx = access.index
        if isinstance(idx, E.Offset):
            return shift_read(chan, idx.data)
        # graph gather: one batched take per slot block, then slice the
        # channel.  Banded rows are BLOCKED (n_vblk, eb, C) -- the whole
        # graph residual evaluation runs in that 2-D tiling (matching
        # ctx.shape) so no flat<->blocked relayouts occur; take-mode rows
        # are flat (E, C).
        gathered, off = self._slot_gather(
            idx.graph.name, idx.slot, img.shape[0]
        )[access.image.name]
        return gathered[..., off + access.channel]

    def eval(self, e):
        # memo entries hold the expression object itself: id() keys are
        # only unique while the object is alive, and callers may pass
        # temporaries (a freed node's id can be reused by a new node)
        hit = self.memo.get(id(e))
        if hit is not None:
            return hit[1]
        r = self._eval(e)
        self.memo[id(e)] = (e, r)
        return r

    def _eval(self, e):
        dtype = self.dtype
        if isinstance(e, E.Const):
            return jnp.asarray(e.value, dtype=dtype)
        if isinstance(e, E.ImageAccess):
            return self.read_image(e)
        if isinstance(e, E.ParamValue):
            return jnp.asarray(self.params[e.param.name], dtype=dtype)
        if isinstance(e, E.BoundsAccess):
            if self.domain != "grid":
                raise ValueError("InBounds used in a graph residual")
            return bounds_mask(self.shape, e.mins, e.maxs, self.real_shape,
                               self.coord_offset)
        if isinstance(e, E.IndexValue):
            if self.domain != "grid":
                raise ValueError("Index used in a graph residual")
            return index_coords(self.shape, e.dim, e.shift_, dtype,
                                self.coord_offset)
        if isinstance(e, E.SampledAccess):
            return self._eval_sampled(e)
        if isinstance(e, E.ComputedAccess):
            return self._eval_computed(e)
        if isinstance(e, E.Apply):
            return self._eval_apply(e)
        raise TypeError(f"cannot evaluate {e!r}")

    def _eval_computed(self, e: E.ComputedAccess):
        """ComputedArray read: materialized buffer + shifted view.

        On the leaf-partials path (leaf_overrides set), the inline view is
        evaluated instead so per-leaf overrides reach the unknown reads at
        their COMPOSED offsets (diag(J^T J) / materialized-J correctness);
        everywhere else the buffer is computed once per context --
        evaluating e.g. the SFS shading expression once instead of once
        per stencil tap (the reference's precompute,
        solverGPUGaussNewton.t:1876,2242)."""
        if self.computed_overrides is not None:
            ov = self.computed_overrides.get(e.key())
            if ov is not None:
                return ov
        if self.leaf_overrides is not None:
            return self.eval(e.expanded())
        bufs = self._computed_cache.get(e.cimage.name)
        if bufs is None:
            bufs = [self.eval(x) for x in e.cimage.exprs]
            bufs = [
                jnp.broadcast_to(_as_float(b, self.dtype), self.shape)
                for b in bufs
            ]
            self._computed_cache[e.cimage.name] = bufs
        buf = bufs[e.channel]
        if all(o == 0 for o in e.offset):
            return buf
        return shift_read(buf, e.offset)

    def _eval_sampled(self, e: E.SampledAccess):
        sim = e.simage
        img = self.images[sim.image.name][..., e.channel]
        dx = (
            self.images[sim.dx.name][..., e.channel]
            if sim.dx is not None
            else None
        )
        dy = (
            self.images[sim.dy.name][..., e.channel]
            if sim.dy is not None
            else None
        )
        x = _as_float(self.eval(e.coords[0]), self.dtype)
        y = _as_float(self.eval(e.coords[1]), self.dtype)
        x, y = jnp.broadcast_arrays(
            jnp.asarray(x, self.dtype), jnp.asarray(y, self.dtype)
        )
        return make_sampled_read(img, dx, dy)(x, y)

    def _eval_apply(self, e: E.Apply):
        op = e.op
        args = [self.eval(a) for a in e.args]
        dt = self.dtype
        f = lambda v: _as_float(jnp.asarray(v), dt)

        if op == "add":
            return f(args[0]) + f(args[1])
        if op == "sub":
            return f(args[0]) - f(args[1])
        if op == "mul":
            a, b = args
            if a.dtype == jnp.bool_ and b.dtype == jnp.bool_:
                return a & b  # boolean product == AND (ad.and_, ad.t:873)
            return f(a) * f(b)
        if op == "div":
            return safe_div(f(args[0]), f(args[1]))
        if op == "neg":
            return -f(args[0])
        if op == "pow":
            b = e.args[1]
            if isinstance(b, E.Const):
                c = b.value
                if c == int(c) and abs(c) <= 4:
                    # powc fast path (ad.t:806-835)
                    n = int(c)
                    x = f(args[0])
                    r = x
                    for _ in range(abs(n) - 1):
                        r = r * x
                    if n == 0:
                        return jnp.ones_like(x)
                    return r if n > 0 else 1.0 / r
            return safe_pow(f(args[0]), f(args[1]))
        if op == "select":
            c = _as_bool(args[0])
            a, b = f(args[1]), f(args[2])
            return jnp.where(c, a, b)
        if op == "and_":
            return _as_bool(args[0]) & _as_bool(args[1])
        if op == "or_":
            return _as_bool(args[0]) | _as_bool(args[1])
        if op == "not_":
            return ~_as_bool(args[0])
        if op in ("less", "greater", "lesseq", "greatereq", "eq"):
            a, b = f(args[0]), f(args[1])
            return {
                "less": jnp.less,
                "greater": jnp.greater,
                "lesseq": jnp.less_equal,
                "greatereq": jnp.greater_equal,
                "eq": jnp.equal,
            }[op](a, b)
        if op == "sqrt":
            return safe_sqrt(f(args[0]))
        if op == "log":
            return safe_log(f(args[0]))
        if op == "abs":
            return jnp.abs(f(args[0]))
        unary = {
            "sin": jnp.sin,
            "cos": jnp.cos,
            "tan": jnp.tan,
            "asin": jnp.arcsin,
            "acos": jnp.arccos,
            "atan": jnp.arctan,
            "sinh": jnp.sinh,
            "cosh": jnp.cosh,
            "tanh": jnp.tanh,
            "asinh": jnp.arcsinh,
            "acosh": jnp.arccosh,
            "exp": jnp.exp,
            "log10": jnp.log10,
        }
        if op in unary:
            return unary[op](f(args[0]))
        if op == "atan2":
            return jnp.arctan2(f(args[0]), f(args[1]))
        raise NotImplementedError(f"op {op}")


def eval_field(exp, ctx):
    """Evaluate a scalar residual expression to a full-domain float array."""
    v = jnp.asarray(ctx.eval(exp))
    if v.dtype != ctx.dtype:
        v = v.astype(ctx.dtype)
    return jnp.broadcast_to(v, ctx.shape)
