"""Materialized-Jacobian mode.

The reference's useMaterializedJTJ explicitly assembles J in CSR once per
outer iteration (saveJToCRS) and runs SpMV per PCG step, optionally fusing
J^T J with a sparse GEMM (reference: Opt.h:33-34,
solverGPUGaussNewton.t:1532-1757, backend_cuda.t:540-655, linalg_cpu*.t).

Here CSR SpMV is the wrong representation: J's sparsity is *structured*
(per residual row, one entry per unknown stencil/graph leaf), so J
materializes as dense per-leaf partial fields D_a with shape
(n_channels, *domain) -- exactly the quantities the diag(J^T J) pass
computes.  Then

    (J p)   = sum_a D_a * gather_a(p)          (dense elementwise + shifts)
    (J^T v) = sum_a scatter_a(D_a * v)
    J^T J p = J^T (J p)

with gather/scatter = zero-padded shifts for grids and index take/add for
graphs.  "Fused J^T J" precomputes, per group, the offset-difference /
vertex-pair weight products W_ab = D_a * D_b summed over residual channels,
so each PCG step touches only the weight tensors (no re-walk of J twice).

Both modes give bit-identical math to the matrix-free path; they trade
memory for avoiding recomputation of the energy's nonlinearities inside
the PCG loop -- the same trade the reference's CSR mode makes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..dsl import expr as E
from ..compile import evaluate as ev


def _gather(p_tree, access, graph_indices):
    img = access.image
    chan = p_tree[img.name][..., access.channel]
    idx = access.index
    if isinstance(idx, E.Offset):
        return ev.shift_read(chan, idx.data)
    vidx = graph_indices[idx.graph.name][idx.slot]
    return jnp.take(chan, vidx, axis=0)


def _scatter_add(out_tree, access, field, graph_indices):
    img = access.image
    idx = access.index
    if isinstance(idx, E.Offset):
        contrib = ev.scatter_shift(field, idx.data)
        out_tree[img.name] = out_tree[img.name].at[..., access.channel].add(
            contrib
        )
    else:
        vidx = graph_indices[idx.graph.name][idx.slot]
        out_tree[img.name] = out_tree[img.name].at[
            vidx, access.channel
        ].add(field)
    return out_tree


class MaterializedJacobian:
    """Per-group leaf partial fields; the structured 'CSR J'."""

    def __init__(self, funcs, x, data):
        self.funcs = funcs
        self.gidx = data.get("graph_indices", {})
        self.groups = []  # (group, leaves, D list [(C,*domain)])
        for g, leaves, D in funcs.leaf_partials(x, data):
            self.groups.append((g, leaves, D))

    # -- J / J^T --------------------------------------------------------------

    def apply_J(self, p_tree):
        out = []
        for g, leaves, D in self.groups:
            acc = None
            for a, Da in zip(leaves, D):
                t = Da * _gather(p_tree, a, self.gidx)[None]
                acc = t if acc is None else acc + t
            out.append(acc)
        return out

    def apply_JT(self, fields):
        out = {
            n: jnp.zeros(s, dtype=self.funcs.dtype)
            for n, s in self.funcs.unknown_shapes.items()
        }
        for (g, leaves, D), v in zip(self.groups, fields):
            for a, Da in zip(leaves, D):
                f = jnp.sum(Da * v, axis=0)
                out = _scatter_add(out, a, f, self.gidx)
        return out

    def apply_JTJ(self, p_tree):
        return self.apply_JT(self.apply_J(p_tree))

    def diag(self):
        """diag(J^T J) from the stored partials (PCGSaveSSq source)."""
        out = {
            n: jnp.zeros(s, dtype=self.funcs.dtype)
            for n, s in self.funcs.unknown_shapes.items()
        }
        for g, leaves, D in self.groups:
            for a, Da in zip(leaves, D):
                out = _scatter_add(out, a, jnp.sum(Da * Da, axis=0),
                                   self.gidx)
        return out

    # -- fused J^T J -----------------------------------------------------------

    def fuse(self):
        """Precompute the Gram weights W_ab = sum_c D_a[c] D_b[c]
        (the reference's csrgemm J^T J, backend_cuda.t:581-597)."""
        self.fused = []
        for g, leaves, D in self.groups:
            k = len(leaves)
            W = [[None] * k for _ in range(k)]
            for i in range(k):
                for j in range(k):
                    W[i][j] = jnp.sum(D[i] * D[j], axis=0)
            self.fused.append((g, leaves, W))
        return self

    def apply_fused_JTJ(self, p_tree):
        """J^T J p via the precomputed Gram weights: for each leaf pair
        (a, b): scatter_a(W_ab * gather_b(p))."""
        out = {
            n: jnp.zeros(s, dtype=self.funcs.dtype)
            for n, s in self.funcs.unknown_shapes.items()
        }
        for g, leaves, W in self.fused:
            gathers = [_gather(p_tree, b, self.gidx) for b in leaves]
            k = len(leaves)
            for i in range(k):
                acc = None
                for j in range(k):
                    t = W[i][j] * gathers[j]
                    acc = t if acc is None else acc + t
                out = _scatter_add(out, leaves[i], acc, self.gidx)
        return out

    # -- export (dumpJ / saveJToCRS parity) -------------------------------------

    def to_scipy_csr(self, data):
        """Export J as a scipy CSR matrix over flattened (residuals x
        unknowns) -- the analogue of the reference's dumpJ/saveJToCRS CSR
        export (o.t:3059-3085, solverGPUGaussNewton.t:1532-1657), for
        inspection and tests."""
        from scipy.sparse import coo_matrix

        # unknown flattening offsets; sorted by name to match
        # jax.flatten_util.ravel_pytree's dict ordering
        offsets = {}
        total_u = 0
        for n in sorted(self.funcs.unknown_shapes):
            s = self.funcs.unknown_shapes[n]
            offsets[n] = total_u
            total_u += int(np.prod(s))

        rows, cols, vals = [], [], []
        row0 = 0
        for g, leaves, D in self.groups:
            Dnp = [np.asarray(d) for d in D]
            C = Dnp[0].shape[0]
            dom = Dnp[0].shape[1:]
            ndom = int(np.prod(dom))
            nrows = C * ndom
            for a, d in zip(leaves, Dnp):
                img = a.image
                ush = self.funcs.unknown_shapes[img.name]
                idx = a.index
                if isinstance(idx, E.Offset):
                    # residual at pixel q reads unknown at q+offset
                    grid = np.indices(dom).reshape(len(dom), -1)
                    tgt = grid.copy()
                    nd = len(dom)
                    for i, o in enumerate(idx.data):
                        tgt[nd - 1 - i] += o
                    valid = np.all(
                        (tgt >= 0)
                        & (tgt < np.array(dom).reshape(-1, 1)),
                        axis=0,
                    )
                    spatial = np.ravel_multi_index(
                        tgt[:, valid], dom
                    )
                    ucol = (
                        offsets[img.name]
                        + spatial * ush[-1]
                        + a.channel
                    )
                    for c in range(C):
                        rows.append(
                            row0 + c * ndom + np.nonzero(valid)[0]
                        )
                        cols.append(ucol)
                        vals.append(d[c].reshape(-1)[valid])
                else:
                    vidx = np.asarray(
                        data["graph_indices"][idx.graph.name][idx.slot]
                    )
                    ucol = offsets[img.name] + vidx * ush[-1] + a.channel
                    for c in range(C):
                        rows.append(row0 + c * ndom + np.arange(ndom))
                        cols.append(ucol)
                        vals.append(d[c].reshape(-1))
            row0 += nrows
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
        m = coo_matrix((vals, (rows, cols)), shape=(row0, total_u))
        return m.tocsr()


def validate_csr(mat):
    """CSR validity check (debug-dump parity,
    solverGPUGaussNewton.t:1679-1701): rowPtr monotonicity and range,
    colInd range and strict per-row sortedness.  Returns a list of error
    strings; empty means valid."""
    errors = []
    indptr = np.asarray(mat.indptr)
    indices = np.asarray(mat.indices)
    nrows, ncols = mat.shape
    nnz = len(indices)
    if len(indptr) != nrows + 1:
        errors.append(f"rowPtr length {len(indptr)} != nrows+1 {nrows + 1}")
        return errors
    if indptr[0] != 0 or indptr[-1] != nnz:
        errors.append(
            f"rowPtr bounds [{indptr[0]}, {indptr[-1]}] != [0, {nnz}]"
        )
    bad = np.nonzero(np.diff(indptr) < 0)[0]
    for i in bad[:10]:
        errors.append(
            f"rowPtr not monotone at row {i}: {indptr[i]} > {indptr[i + 1]}"
        )
    if nnz and (indices.min() < 0 or indices.max() >= ncols):
        errors.append(
            f"colInd out of range [0, {ncols}): "
            f"min {indices.min()}, max {indices.max()}"
        )
    for i in range(nrows):
        row = indices[indptr[i] : indptr[i + 1]]
        if len(row) > 1 and not np.all(np.diff(row) > 0):
            errors.append(f"colInd not strictly sorted in row {i}")
            if len(errors) >= 20:
                errors.append("... (truncated)")
                return errors
    return errors
