"""Banded one-hot graph gather/scatter engine (opt-in, graph_mode="banded").

Replaces the take/segment_sum graph gathers and scatters with dense block
matmuls, in the role of the reference's hand-written atomic scatter
kernels (reference: API/src/backend_cuda.t:366-445 and
examples/arap_mesh_deformation/src/WarpingSolver.cu).  The default
graph_mode="auto" does not select it: XLA's native gather and
segment_sum are faster on a GPU (PERF.md).

Scheme
------
1. Reverse-Cuthill-McKee reorder the vertices so every edge's endpoints
   are within a small bandwidth `bw` of each other.
2. Sort edges by slot-0 vertex and tile them into per-vertex-block groups
   of EB edges (padded).  With block size VB >= bw, every endpoint of an
   edge in block b lies in the 3-block window [(b-1)VB, (b+2)VB).
3. Gather = (EB x 3VB) one-hot  @  (3VB x C) window, generated on the fly
   from an iota comparison; scatter is the transposed matmul, with the
   3-block window overlap-added back.  Both are bf16 matmuls.
4. Exactness: bf16 matmuls would round the values, so each f32 operand is
   split into three scaled bf16 planes packed along the channel axis
   (hi + mid/2^8 + lo/2^16) and recombined after the matmul -- gathers are
   bit-exact, scatters accumulate in the matmul's f32 accumulator (same
   error class as f32 atomics).  The split truncates through integer bits
   (_trunc_bf16) so XLA's excess-precision pass cannot fold the
   f32->bf16->f32 round-trips away.

`linear_call` pairs gather/scatter as each other's transposes, so the
solver's `jax.linearize` / `jax.linear_transpose` J/J^T machinery routes
through the banded kernels in both directions.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.custom_derivatives import linear_call

VERTEX_BLOCK = 128
EDGE_ALIGN = 8

# env knobs read ONCE at import: a trace-time read would bake the value
# into cached jitted programs, so later changes would be silently ignored
# anyway -- reading here makes that explicit and keeps
# retraces of identical programs producing identical HLO
_ONEHOT_TAG_MODE = os.environ.get("OPT_TPU_ONEHOT_TAG", "static")


def _roundup(v, m):
    return ((v + m - 1) // m) * m


# ---------------------------------------------------------------------------
# host-side planning
# ---------------------------------------------------------------------------


class GraphBandPlan:
    """Per-graph edge tiling (shared vertex permutation lives in
    VertexBanding).

    Two layouts:
      'balanced' -- edges sorted by slot-0 vertex, tiled into per-vertex-
        block groups of eb edges; every slot gathers/scatters via one-hot
        matmuls.
      'ell' -- edges stored at row v*deg + k keyed by their PRIMARY slot's
        vertex v (fixed-degree ELL padding).  The primary slot's gather is
        then a pure broadcast and its scatter a dense row-sum (no one-hot
        at all); only the other slots pay the one-hot matmul.  Chosen when
        (n_slots-1) * n_verts * deg one-hot rows beat the balanced
        n_slots * n_vblk * eb (true for near-regular meshes: for a
        symmetrized triangle mesh it halves the one-hot work of a 2-slot
        J^T J apply).
    """

    __slots__ = ("name", "vb", "n_vblk", "eb", "ep", "n_edges",
                 "loc", "pad_mask", "edge_perm", "layout", "primary_slot",
                 "deg", "n_eblk", "wblk")

    def __init__(self, name, vb, n_vblk, eb, n_edges, loc, pad_mask,
                 edge_perm, layout="balanced", primary_slot=None, deg=0,
                 n_eblk=None, wblk=None):
        self.name = name
        self.vb = vb
        self.n_vblk = n_vblk
        self.n_eblk = n_vblk if n_eblk is None else n_eblk
        self.eb = eb
        self.ep = self.n_eblk * eb
        self.n_edges = n_edges
        self.loc = loc              # slot -> (n_eblk, eb) int32, -1 = pad
        self.pad_mask = pad_mask    # (ep,) bool, True = real edge
        self.edge_perm = edge_perm  # (n_edges,) position of edge i in ep
        self.layout = layout
        self.primary_slot = primary_slot  # 'ell': the broadcast/sum slot
        self.deg = deg                    # 'ell': rows per vertex
        self.wblk = wblk  # 'tiled': (n_eblk, K) window vertex-block ids


class VertexBanding:
    """RCM vertex permutation + per-graph edge tilings for one vertex
    index space."""

    __slots__ = ("n_verts", "perm", "inv_perm", "vb", "bandwidth", "graphs")

    def __init__(self, n_verts, perm, inv_perm, vb, bandwidth, graphs):
        self.n_verts = n_verts
        self.perm = perm          # new position i holds old vertex perm[i]
        self.inv_perm = inv_perm  # old vertex v now sits at inv_perm[v]
        self.vb = vb
        self.bandwidth = bandwidth
        self.graphs = graphs      # gname -> GraphBandPlan


def plan_vertex_banding(graphs_np, n_verts, max_bandwidth=2048,
                        min_edges=2048, force=False):
    """Plan banding for one vertex space, or None if unprofitable.

    graphs_np: gname -> {slot: (E,) int index array} (all on this space).
    force: skip the profitability thresholds (tests / explicit opt-in).
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    total_edges = sum(
        len(next(iter(slots.values()))) for slots in graphs_np.values()
    )
    if not force and (total_edges < min_edges or n_verts < 256):
        return None

    # union adjacency over every slot pair of every graph
    rows, cols = [], []
    for slots in graphs_np.values():
        arrs = [np.asarray(a, np.int64) for a in slots.values()]
        for i in range(len(arrs)):
            for j in range(i + 1, len(arrs)):
                rows.append(arrs[i])
                cols.append(arrs[j])
    if not rows:
        return None
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    adj = csr_matrix(
        (np.ones(len(r), np.float32), (r, c)), shape=(n_verts, n_verts)
    )
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=False),
                      np.int64)
    inv = np.empty(n_verts, np.int64)
    inv[perm] = np.arange(n_verts)
    bw = int(np.abs(inv[r] - inv[c]).max()) if len(r) else 0

    import os

    forced = os.environ.get("OPT_TPU_GRAPH_LAYOUT", "auto")

    def plan_for_perm(perm_, inv_, bw_, allow_window):
        plans_, total = {}, 0
        for gname, slots in graphs_np.items():
            n_slots = len(slots)
            n_e = len(next(iter(slots.values())))
            # take/segment_sum cost of this graph in one-hot-equivalent
            # units: charged when the graph falls back, so
            # RCM-vs-identity totals compare like for like even when each
            # ordering bands a different subset (comparing banded-only
            # work could prefer the ordering that simply banded fewer
            # graphs)
            take_work = MAX_ONEHOT_PER_EDGE * n_slots * n_e
            cands = []
            if allow_window and bw_ <= max_bandwidth and forced != "tiled":
                vb_w = max(VERTEX_BLOCK, _roundup(max(bw_, 1), VERTEX_BLOCK))
                n_vblk_w = (n_verts + vb_w - 1) // vb_w
                p = _plan_graph_layout(
                    gname, slots, inv_, n_verts, vb_w, n_vblk_w, forced
                )
                cands.append((_onehot_work(p), p))
            if forced in ("auto", "tiled"):
                pt = _plan_graph_tiled(gname, slots, inv_, n_verts)
                if pt is not None:
                    cands.append((_onehot_work(pt), pt))
            if not cands:
                total += take_work
                continue
            work, best = min(cands, key=lambda c: c[0])
            # beyond ~MAX_ONEHOT_PER_EDGE one-hot elements per
            # (edge, slot) one-hot generation costs more than
            # take/segment_sum; skip unless forced
            if not force and work > take_work:
                total += take_work
                continue
            plans_[gname] = best
            total += work
        return plans_, total

    plans, total = plan_for_perm(perm, inv, bw, allow_window=True)
    if bw > max_bandwidth:
        # RCM failed to band the graph; its BFS ordering can also scatter
        # whatever locality the ORIGINAL vertex order had (e.g. a local
        # mesh plus a few random chords), exploding the tiled windows.
        # Try tiled layouts on the identity permutation and keep the
        # cheaper of the two orderings.
        ident = np.arange(n_verts, dtype=np.int64)
        plans_id, total_id = plan_for_perm(
            ident, ident, bw, allow_window=False
        )
        if plans_id and (not plans or total_id < total):
            plans, perm, inv = plans_id, ident, ident
    if not plans:
        return None
    return VertexBanding(n_verts, perm, inv, VERTEX_BLOCK, bw, plans)


# max vertex blocks per edge-tile window -- a MEMORY bound on the take'd
# (n_eblk, K*vb, C) window arrays, not a work heuristic: the _onehot_work
# comparison in plan_vertex_banding decides tiled-vs-window-vs-nothing
MAX_WINDOW_BLOCKS = 64

# one-hot elements per (edge, slot) past which the planner prefers take
# (a work-model bound, not measured on the current device)
MAX_ONEHOT_PER_EDGE = 2048


# one-hot-equivalent cost units per COARSE window element of the tiled
# layout's take'd K-block windows (per sweep direction): a window element
# is a multi-channel f32 row-chunk materialized to device memory and read
# back, plus the sparse-row take
WINDOW_COST_PER_ELEM = 40


def _onehot_work(p):
    """One-hot-equivalent work units per full gather+scatter sweep (one-hot
    iota-compare generation bounds each fusion).  The tiled layout
    additionally charges its coarse K-block window memory traffic (take +
    materialize + read-back, once per direction; slots share the window
    via slots_gather)."""
    n_slots = len(p.loc)
    if p.layout == "ell":
        window = 3 * p.vb
        return (n_slots - 1) * p.n_eblk * p.eb * window
    if p.layout == "tiled":
        K = p.wblk.shape[1]
        onehot = n_slots * p.n_eblk * p.eb * K * p.vb
        window = 2 * WINDOW_COST_PER_ELEM * p.n_eblk * K * p.vb
        return onehot + window
    return n_slots * p.n_eblk * p.eb * 3 * p.vb


def _plan_graph_tiled(gname, slots, inv, n_verts):
    """Two-level layout for graphs whose RCM bandwidth defeats 3-block
    windows (mostly-local meshes with long-range edges).  Edges sort by
    slot-0 vertex into per-vertex-block tiles as in 'balanced', but each
    tile carries an explicit LIST of the vertex blocks its endpoints
    touch (wblk): the gather first `take`s those whole blocks (coarse,
    amortized) and then one-hots within the K-block window (fine).
    Returns None when some tile touches more than MAX_WINDOW_BLOCKS
    blocks (take/segment_sum or a window layout wins there).  Meant for
    block-local graphs (cluster + sparse inter-cluster links) where K
    stays small."""
    vb = VERTEX_BLOCK
    n_vblk = (n_verts + vb - 1) // vb
    snames = list(slots)
    perm_slots = {sn: inv[np.asarray(slots[sn], np.int64)]
                  for sn in snames}
    n_edges = len(perm_slots[snames[0]])
    s0 = perm_slots[snames[0]]
    order = np.argsort(s0 // vb, kind="stable")
    sorted_slots = {sn: perm_slots[sn][order] for sn in snames}
    key_blk = sorted_slots[snames[0]] // vb
    starts = np.searchsorted(key_blk, np.arange(n_vblk))
    ends = np.searchsorted(key_blk, np.arange(1, n_vblk + 1))
    eb = int(_roundup(max(int((ends - starts).max()), 1), EDGE_ALIGN))

    # per-tile union of touched vertex blocks (all slots)
    windows = []
    for b in range(n_vblk):
        s, e = starts[b], ends[b]
        blks = np.unique(np.concatenate(
            [sorted_slots[sn][s:e] // vb for sn in snames]
        )) if e > s else np.zeros(1, np.int64)
        windows.append(blks)
    K = max(1, max(len(w) for w in windows))
    if K > MAX_WINDOW_BLOCKS:
        return None
    wblk = np.zeros((n_vblk, K), np.int32)
    loc = {sn: np.full((n_vblk, eb), -1, np.int32) for sn in snames}
    for b in range(n_vblk):
        blks = windows[b]
        wblk[b, : len(blks)] = blks
        wpos = {int(bk): i for i, bk in enumerate(blks)}
        s, e = starts[b], ends[b]
        for sn in snames:
            vs = sorted_slots[sn][s:e]
            pos = np.fromiter(
                (wpos[int(v // vb)] for v in vs), np.int64, e - s
            )
            loc[sn][b, : e - s] = (
                pos * vb + (vs - (vs // vb) * vb)
            ).astype(np.int32)
    pad = np.zeros((n_vblk, eb), bool)
    for b in range(n_vblk):
        pad[b, : ends[b] - starts[b]] = True
    edge_perm = np.empty(n_edges, np.int64)
    edge_perm[order] = np.flatnonzero(pad.reshape(-1))
    return GraphBandPlan(
        gname, vb, n_vblk, eb, n_edges, loc, pad.reshape(-1),
        edge_perm, layout="tiled", n_eblk=n_vblk, wblk=wblk,
    )


def _plan_graph_layout(gname, slots, inv, n_verts, vb, n_vblk,
                       forced="auto"):
    """Pick balanced vs ELL layout for one graph and build its tiling."""
    snames = list(slots)
    perm_slots = {sn: inv[np.asarray(slots[sn], np.int64)] for sn in snames}
    n_edges = len(perm_slots[snames[0]])

    # balanced layout geometry (sorted by slot 0, per-vertex-block tiles)
    s0 = perm_slots[snames[0]]
    order_bal = np.argsort(s0, kind="stable")
    key0 = s0[order_bal]
    starts = np.searchsorted(key0, np.arange(n_vblk) * vb)
    ends = np.searchsorted(key0, np.arange(1, n_vblk + 1) * vb)
    eb_bal = int(_roundup(max(int((ends - starts).max()), 1), EDGE_ALIGN))
    work_bal = len(snames) * n_vblk * eb_bal

    # best ELL candidate: one-hot work = (n_slots-1) * n_vblk * vb * deg
    ell_sn, ell_deg = None, 0
    for sn in snames:
        deg = int(np.bincount(perm_slots[sn], minlength=n_verts).max()) \
            if n_edges else 1
        deg = max(deg, 1)
        if ell_sn is None or deg < ell_deg:
            ell_sn, ell_deg = sn, deg
    work_ell = (len(snames) - 1) * n_vblk * vb * ell_deg

    use_ell = work_ell < work_bal if forced == "auto" else forced == "ell"
    if use_ell:
        eb = vb * ell_deg
        sp = perm_slots[ell_sn]
        order = np.argsort(sp, kind="stable")
        sv = sp[order]
        vstarts = np.searchsorted(sv, np.arange(n_verts))
        k = np.arange(n_edges, dtype=np.int64) - vstarts[sv]
        rows = sv * ell_deg + k  # global padded row of each sorted edge
        loc = {}
        for sn in snames:
            lc = np.full(n_vblk * eb, -1, np.int32)
            vals = perm_slots[sn][order]
            blk = rows // eb
            lc[rows] = (vals - (blk - 1) * vb).astype(np.int32)
            loc[sn] = lc.reshape(n_vblk, eb)
        pad = np.zeros(n_vblk * eb, bool)
        pad[rows] = True
        edge_perm = np.empty(n_edges, np.int64)
        edge_perm[order] = rows
        return GraphBandPlan(
            gname, vb, n_vblk, eb, n_edges, loc, pad, edge_perm,
            layout="ell", primary_slot=ell_sn, deg=ell_deg,
        )

    eb = eb_bal
    loc = {}
    for sn in snames:
        lc = np.full((n_vblk, eb), -1, np.int32)
        vals = perm_slots[sn][order_bal]
        for b in range(n_vblk):
            s, e = starts[b], ends[b]
            lc[b, : e - s] = vals[s:e] - (b - 1) * vb
        loc[sn] = lc
    pad = np.zeros((n_vblk, eb), bool)
    for b in range(n_vblk):
        pad[b, : ends[b] - starts[b]] = True
    # where each original edge landed in the padded layout
    edge_perm = np.empty(n_edges, np.int64)
    pos = np.flatnonzero(pad.reshape(-1))
    edge_perm[order_bal] = pos
    return GraphBandPlan(
        gname, vb, n_vblk, eb, n_edges, loc, pad.reshape(-1), edge_perm
    )


@jax.tree_util.register_pytree_node_class
class DeviceBanding:
    """Device-side banding for one graph: loc index arrays + pad mask are
    pytree leaves; the tiling geometry is static aux data (so it stays a
    Python int under jit instead of being traced)."""

    def __init__(self, loc, pad_mask, vb, n_vblk, eb, n_verts,
                 layout="balanced", primary_slot=None, deg=0, wblk=None):
        self.loc = loc            # slot -> (n_eblk, eb) int32
        self.pad_mask = pad_mask  # (n_eblk, eb) bool
        self.vb = vb
        self.n_vblk = n_vblk
        self.eb = eb
        self.n_verts = n_verts
        self.layout = layout
        self.primary_slot = primary_slot
        self.deg = deg
        self.wblk = wblk          # 'tiled': (n_eblk, K) int32 block ids

    @property
    def n_eblk(self):
        return (self.wblk.shape[0] if self.layout == "tiled"
                else self.n_vblk)

    def meta(self):
        return dict(vb=self.vb, n_vblk=self.n_vblk, eb=self.eb,
                    n_verts=self.n_verts)

    def tree_flatten(self):
        return (
            (self.loc, self.pad_mask, self.wblk),
            (self.vb, self.n_vblk, self.eb, self.n_verts,
             self.layout, self.primary_slot, self.deg),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux, wblk=children[2])


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

_BAR = jax.lax.optimization_barrier


def _trunc_bf16(x):
    """Truncate f32 to bf16 via integer bits (the top 16 bits of an f32
    ARE its bf16 truncation, for any sign/subnormal).  Pure bit ops: the
    XLA excess-precision pass cannot fold this back to f32 the way it
    folds convert(f32->bf16->f32) round-trips, so no optimization_barrier
    is needed -- and without barriers the whole split fuses into the
    one-hot dot's operand instead of materializing three planes."""
    xi = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return jax.lax.bitcast_convert_type(
        (xi >> jnp.uint32(16)).astype(jnp.uint16), jnp.bfloat16
    )


def _split3(x):
    """f32 -> three scaled bf16 planes on the channel axis; exact:
    x == hi + mid/2^8 + lo/2^16 bit-for-bit (truncating Dekker-style
    split, 8 mantissa bits per plane) for all normal f32 and zeros;
    f32 subnormals (<1.2e-38) lose their last mantissa-field bit."""
    hi = _trunc_bf16(x)
    r1 = x - hi.astype(jnp.float32)
    mid = _trunc_bf16(r1 * 256.0)
    r2 = r1 - mid.astype(jnp.float32) * (1.0 / 256.0)
    lo = _trunc_bf16(r2 * 65536.0)
    return jnp.concatenate([hi, mid, lo], axis=-1)


def _recomb(out, c):
    return (out[..., :c] + out[..., c:2 * c] * (1.0 / 256.0)
            + out[..., 2 * c:] * (1.0 / 65536.0))


def _windows(pb):
    """(n_vblk, VB, C) -> (n_vblk, 3VB, C) neighbor-block windows."""
    z = jnp.zeros_like(pb[:1])
    up = jnp.concatenate([pb[1:], z], 0)
    dn = jnp.concatenate([z, pb[:-1]], 0)
    return jnp.concatenate([dn, pb, up], 1)


_ONEHOT_TAG = [0]


def reset_onehot_tags():
    """Reset the one-hot tag counter.  Called at the top of every
    top-level traced solver program (runtime/api.py wraps the plan fns)
    so identical programs trace to identical tag sequences -> identical
    HLO, keeping XLA's persistent compilation cache effective (an
    ever-advancing global counter would make every retrace unique)."""
    _ONEHOT_TAG[0] = 0


def _next_tag(operand):
    """Tag making each one-hot generation structurally unique AND
    data-dependent on its dot's other operand.

    XLA CSEs identical one-hot subexpressions; a one-hot with two fusion
    consumers (a gather dot and a scatter dot on the same loc, or the
    primal and tangent gathers sharing one linear_call trace) gets
    MATERIALIZED to device memory, and every banded op then pays a read
    of the whole one-hot instead of fusing its own iota-compare.
    Comparing (loc - tag) == (iota - tag) is the same
    one-hot but a distinct expression; deriving tag from the operand
    (0 * operand[0,0] behind an optimization_barrier, so it cannot fold
    to a shared constant) keeps it unique per invocation.  The counter
    restarts per top-level trace (reset_onehot_tags)."""
    if _ONEHOT_TAG_MODE == "none":
        return 0
    _ONEHOT_TAG[0] = (_ONEHOT_TAG[0] + 1) % 1024
    if _ONEHOT_TAG_MODE == "dynamic":
        first = operand.reshape(-1)[0]
        dyn = _BAR(first * 0).astype(jnp.int32)
        return _ONEHOT_TAG[0] + dyn
    return _ONEHOT_TAG[0]


def _gather_impl(loc, values, *, vb, n_vblk, eb, n_verts):
    c = values.shape[-1]
    pb = jnp.pad(values, ((0, n_vblk * vb - n_verts), (0, 0)))
    pb = pb.reshape(n_vblk, vb, c)
    ws = _split3(_windows(pb))
    t = _next_tag(values)

    def blk(locb, wb):
        oh = ((locb[:, None] - t) ==
              (jax.lax.broadcasted_iota(jnp.int32, (eb, 3 * vb), 1) - t)
              ).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            oh, wb, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return _recomb(out, c)

    return jax.vmap(blk)(loc, ws)


def _scatter_impl(loc, edges, *, vb, n_vblk, eb, n_verts):
    c = edges.shape[-1]
    es = _split3(edges)
    t = _next_tag(edges)

    def blk(locb, ebk):
        oh = ((locb[:, None] - t) ==
              (jax.lax.broadcasted_iota(jnp.int32, (eb, 3 * vb), 1) - t)
              ).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            oh, ebk, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return _recomb(out, c)

    w = jax.vmap(blk)(loc, es)  # (n_vblk, 3VB, C) window contributions
    z = jnp.zeros_like(w[:1, :vb])
    mid = w[:, vb:2 * vb]
    from_up = jnp.concatenate([w[1:, :vb], z], 0)
    from_dn = jnp.concatenate([z, w[:-1, 2 * vb:]], 0)
    return (mid + from_up + from_dn).reshape(-1, c)[:n_verts]


def banded_gather(loc, values, *, vb, n_vblk, eb, n_verts):
    """values (n_verts, C) f32 -> BLOCKED padded edge rows (n_vblk, eb, C).

    Edge-domain arrays stay in the blocked 2-D tiling everywhere (the
    evaluator computes graph residual fields as (n_vblk, eb)); flattening
    to (n_vblk*eb, C) would force a relayout copy per gather.

    Bit-exact vs jnp.take; pad rows (loc == -1) come back zero.  Linear in
    `values`, transposing to `banded_scatter`."""
    meta = dict(vb=vb, n_vblk=n_vblk, eb=eb, n_verts=n_verts)

    def fwd(res, v):
        return _gather_impl(res, v, **meta)

    def bwd(res, ct):
        return _scatter_impl(res, ct, **meta)

    return linear_call(fwd, bwd, loc, values)


def banded_scatter(loc, edges, *, vb, n_vblk, eb, n_verts):
    """BLOCKED padded edge rows (n_vblk, eb, C) f32 -> summed (n_verts, C).

    Duplicate targets accumulate in the matmul's f32 accumulator (same error
    class as f32 atomic adds).  Pad rows are dropped (one-hot of -1 is the
    zero row).  Linear in `edges`, transposing to `banded_gather`."""
    meta = dict(vb=vb, n_vblk=n_vblk, eb=eb, n_verts=n_verts)

    def fwd(res, e):
        return _scatter_impl(res, e, **meta)

    def bwd(res, ct):
        return _gather_impl(res, ct, **meta)

    return linear_call(fwd, bwd, loc, edges)


# ---------------------------------------------------------------------------
# ELL primary-slot ops: gather = broadcast, scatter = row-sum (no one-hot)
# ---------------------------------------------------------------------------


def _ell_gather_impl(values, *, vb, n_vblk, deg, n_verts):
    c = values.shape[-1]
    pb = jnp.pad(values, ((0, n_vblk * vb - n_verts), (0, 0)))
    out = jnp.broadcast_to(
        pb.reshape(n_vblk, vb, 1, c), (n_vblk, vb, deg, c)
    )
    return out.reshape(n_vblk, vb * deg, c)


def _ell_scatter_impl(edges, *, vb, n_vblk, deg, n_verts):
    c = edges.shape[-1]
    s = edges.reshape(n_vblk, vb, deg, c).sum(axis=2)
    return s.reshape(n_vblk * vb, c)[:n_verts]


def ell_gather(values, *, vb, n_vblk, deg, n_verts):
    """Primary-slot ELL gather: vertex values (n_verts, C) broadcast to
    their deg BLOCKED edge rows (n_vblk, vb*deg, C).  NOTE: unlike
    banded_gather, PAD rows receive the vertex VALUE, not zero -- residual
    evaluation masks pad rows via GraphBandPlan.pad_mask, so nothing real
    flows from them.  Linear; transposes to ell_scatter (row-sum)."""
    meta = dict(vb=vb, n_vblk=n_vblk, deg=deg, n_verts=n_verts)

    def fwd(_, v):
        return _ell_gather_impl(v, **meta)

    def bwd(_, ct):
        return _ell_scatter_impl(ct, **meta)

    return linear_call(fwd, bwd, (), values)


def ell_scatter(edges, *, vb, n_vblk, deg, n_verts):
    """Primary-slot ELL scatter: per-vertex dense sum over the deg edge
    rows (the per-thread shadow-buffer reduction of backend_cpu_mt.t,
    without any indexed writes).  Callers must have zeroed pad rows
    (everything scattered is derived from pad-masked residual fields).
    Linear; transposes to ell_gather."""
    meta = dict(vb=vb, n_vblk=n_vblk, deg=deg, n_verts=n_verts)

    def fwd(_, e):
        return _ell_scatter_impl(e, **meta)

    def bwd(_, ct):
        return _ell_gather_impl(ct, **meta)

    return linear_call(fwd, bwd, (), edges)


# ---------------------------------------------------------------------------
# tiled two-level ops: coarse block take + fine one-hot within K-block
# windows (graphs whose RCM bandwidth exceeds the 3-block-window limit)
# ---------------------------------------------------------------------------


def _tiled_gather_impl(wblk, loc, values, *, vb, n_vblk, eb, n_verts):
    c = values.shape[-1]
    n_eblk, K = wblk.shape
    pb = jnp.pad(values, ((0, n_vblk * vb - n_verts), (0, 0)))
    # coarse: take whole (vb, c) blocks -- one row per (tile, window slot),
    # vb*c elements each, so the per-row sparse-gather overhead amortizes
    win = jnp.take(pb.reshape(n_vblk, vb * c), wblk.reshape(-1), axis=0)
    ws = _split3(win.reshape(n_eblk, K * vb, c))
    t = _next_tag(values)

    def blk(locb, wb):
        oh = ((locb[:, None] - t) ==
              (jax.lax.broadcasted_iota(jnp.int32, (eb, K * vb), 1) - t)
              ).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            oh, wb, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return _recomb(out, c)

    return jax.vmap(blk)(loc, ws)


def _tiled_scatter_impl(wblk, loc, edges, *, vb, n_vblk, eb, n_verts):
    c = edges.shape[-1]
    n_eblk, K = wblk.shape
    es = _split3(edges)
    t = _next_tag(edges)

    def blk(locb, ebk):
        oh = ((locb[:, None] - t) ==
              (jax.lax.broadcasted_iota(jnp.int32, (eb, K * vb), 1) - t)
              ).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            oh, ebk, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return _recomb(out, c)

    w = jax.vmap(blk)(loc, es)  # (n_eblk, K*vb, c) window contributions
    # coarse: sum whole-block contributions back by window block id (pad
    # window slots carry zeros -- one-hot of -1 is the zero row -- so the
    # duplicate wblk=0 padding is harmless)
    contrib = w.reshape(n_eblk * K, vb * c)
    out = jax.ops.segment_sum(
        contrib, wblk.reshape(-1), num_segments=n_vblk
    )
    return out.reshape(n_vblk * vb, c)[:n_verts]


def tiled_gather(wblk, loc, values, *, vb, n_vblk, eb, n_verts):
    """values (n_verts, C) f32 -> blocked edge rows (n_eblk, eb, C) via
    per-tile K-block windows.  Bit-exact vs jnp.take; pad rows zero.
    Linear in `values`, transposing to `tiled_scatter`."""
    meta = dict(vb=vb, n_vblk=n_vblk, eb=eb, n_verts=n_verts)

    def fwd(res, v):
        return _tiled_gather_impl(res[0], res[1], v, **meta)

    def bwd(res, ct):
        return _tiled_scatter_impl(res[0], res[1], ct, **meta)

    return linear_call(fwd, bwd, (wblk, loc), values)


def tiled_scatter(wblk, loc, edges, *, vb, n_vblk, eb, n_verts):
    """Blocked edge rows (n_eblk, eb, C) -> summed (n_verts, C) via the
    transposed window one-hot + coarse segment_sum of whole blocks.
    Linear in `edges`, transposing to `tiled_gather`."""
    meta = dict(vb=vb, n_vblk=n_vblk, eb=eb, n_verts=n_verts)

    def fwd(res, e):
        return _tiled_scatter_impl(res[0], res[1], e, **meta)

    def bwd(res, ct):
        return _tiled_gather_impl(res[0], res[1], ct, **meta)

    return linear_call(fwd, bwd, (wblk, loc), edges)


# ---------------------------------------------------------------------------
# slot dispatch (the only entry points solvers/evaluators should use)
# ---------------------------------------------------------------------------


def slot_gather(band, slot, values):
    """Gather vertex `values` (n_verts, C) to this graph's padded edge
    rows for `slot`, choosing the layout-appropriate engine."""
    if band.layout == "ell" and slot == band.primary_slot:
        return ell_gather(
            values, vb=band.vb, n_vblk=band.n_vblk, deg=band.deg,
            n_verts=band.n_verts,
        )
    if band.layout == "tiled":
        return tiled_gather(band.wblk, band.loc[slot], values,
                            **band.meta())
    return banded_gather(band.loc[slot], values, **band.meta())


def slots_gather(band, slots, values):
    """Gather `values` (n_verts, C) to edge rows for EVERY slot at once:
    all one-hot slots share ONE stacked dot (their locs concatenated
    along the row axis against the same 3-block window), so a 2-slot
    J^T J apply costs one gather dot + one scatter dot per iteration
    instead of two of each (same MACs, half the dot/fusion count).
    Returns {slot: (n_vblk, eb, C) blocked rows}."""
    oh_slots = [
        s for s in slots
        if not (band.layout == "ell" and s == band.primary_slot)
    ]
    out = {}
    if band.layout == "ell" and band.primary_slot in slots:
        out[band.primary_slot] = ell_gather(
            values, vb=band.vb, n_vblk=band.n_vblk, deg=band.deg,
            n_verts=band.n_verts,
        )
    if len(oh_slots) == 1:
        out[oh_slots[0]] = slot_gather(band, oh_slots[0], values)
    elif oh_slots:
        loc_stack = jnp.concatenate(
            [band.loc[s] for s in oh_slots], axis=1
        )
        meta = band.meta()
        meta["eb"] = band.eb * len(oh_slots)
        if band.layout == "tiled":
            # slots share the per-tile window, so they stack into one
            # dot against the same take'd K-block window
            rows = tiled_gather(band.wblk, loc_stack, values, **meta)
        else:
            rows = banded_gather(loc_stack, values, **meta)
        for i, s in enumerate(oh_slots):
            out[s] = rows[:, i * band.eb:(i + 1) * band.eb]
    return out


def slot_scatter(band, slot, edges):
    """Sum blocked edge rows (n_eblk, eb, C) onto their `slot` vertices."""
    if band.layout == "ell" and slot == band.primary_slot:
        return ell_scatter(
            edges, vb=band.vb, n_vblk=band.n_vblk, deg=band.deg,
            n_verts=band.n_verts,
        )
    if band.layout == "tiled":
        return tiled_scatter(band.wblk, band.loc[slot], edges,
                             **band.meta())
    return banded_scatter(band.loc[slot], edges, **band.meta())
