"""Multi-chip execution: spatial domain decomposition over a device mesh.

The reference is single-device; its closest analogue is the CPU_MT backend's
outermost-dimension block partition over a pthread pool (reference:
API/src/backend_cpu_mt.t:698-944).  Here that role is played by SPMD
partitioning over a device mesh:

* grid unknowns/arrays shard their leading spatial axes (H, or D and H for
  3D) across mesh axes -- the analogue of splitting the outermost loop dim
  across threads (backend_cpu_mt.t:712-740);
* XLA GSPMD inserts the halo exchanges for stencil shifts and all-reduces
  for the five PCG scalars (the reference's ReduceVar + atomicAdd two-stage
  reductions, backend_cuda.t:447-495);
* graph problems shard edges and vertices; edge gathers/scatter-adds that
  cross shard boundaries become collectives -- the analogue of the
  per-thread shadow-buffer merge (backend_cpu_mt.t:863-930).

Everything is sharding annotations on the *inputs*; the solver program is
unchanged (one jitted XLA program, partitioned by the compiler).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, shape=None, axis_names=None, devices=None):
    """Build a 1-D or 2-D device mesh.

    shape: explicit mesh shape tuple; default factors n_devices as close to
    square as possible into ('dy', 'dx').
    """
    devices = list(devices if devices is not None else jax.devices())
    n = n_devices or len(devices)
    devices = devices[:n]
    if shape is None:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (a, n // a)
    if axis_names is None:
        axis_names = ("dy", "dx")[: len(shape)]
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def _grid_spec(mesh, spatial_ndim):
    """PartitionSpec for a (spatial..., C) grid array: shard the leading
    spatial axes over the mesh axes (outermost dims first)."""
    names = list(mesh.axis_names)
    spec = [None] * (spatial_ndim + 1)
    for i, ax in enumerate(names[: spatial_ndim]):
        spec[i] = ax
    return P(*spec)


def _vector_spec(mesh):
    """1-D domains (mesh vertices / graph edges) shard over every mesh axis
    jointly when the mesh is 2-D."""
    names = tuple(mesh.axis_names)
    if len(names) == 1:
        return P(names[0])
    return P(names)


def shard_problem(plan, x, data, mesh):
    """Place bound problem data onto the mesh.

    Returns (x, data) with NamedShardings applied:
      grid images   -> leading spatial axes over mesh axes
      vertex/edge   -> axis 0 over the whole mesh
      params        -> replicated
      graph banding -> loc / pad_mask block-rows (n_vblk) over the mesh,
                       so each device owns a contiguous run of vertex
                       blocks; the 3-block gather windows make GSPMD
                       exchange one vb-row halo per neighbor (the
                       shadow-buffer merge of backend_cpu_mt.t:863-930
                       becomes a collective-permute of boundary blocks)
    """

    def put(arr, spec):
        return jax.device_put(arr, NamedSharding(mesh, spec))

    def shard_image(name, arr):
        im = plan.spec.images[name]
        nd = im.ispace.ndims
        if nd == 1:
            names = tuple(mesh.axis_names)
            axis0 = names if len(names) > 1 else names[0]
            return put(arr, P(axis0, None))
        return put(arr, _grid_spec(mesh, nd))

    x2 = {n: shard_image(n, a) for n, a in x.items()}
    images2 = {n: shard_image(n, a) for n, a in data["images"].items()}
    params2 = {n: put(a, P()) for n, a in data["params"].items()}
    graphs2 = {
        g: {s: put(a, _vector_spec(mesh)) for s, a in slots.items()}
        for g, slots in data["graph_indices"].items()
    }
    data2 = {
        "images": images2,
        "params": params2,
        "graph_indices": graphs2,
    }
    if data.get("graph_banding"):
        blk_spec = _vector_spec(mesh)

        def put_band(band):
            return type(band)(
                loc={s: put(a, P(*blk_spec, None))
                     for s, a in band.loc.items()},
                pad_mask=put(band.pad_mask, P(*blk_spec, None)),
                vb=band.vb, n_vblk=band.n_vblk, eb=band.eb,
                n_verts=band.n_verts, layout=band.layout,
                primary_slot=band.primary_slot, deg=band.deg,
                wblk=(put(band.wblk, P(*blk_spec, None))
                      if band.wblk is not None else None),
            )

        data2["graph_banding"] = {
            g: put_band(b) for g, b in data["graph_banding"].items()
        }
    return x2, data2


def solve_sharded(plan, inputs, mesh, n_iterations=None, graph_mode=None):
    """Full solve with inputs sharded over the mesh.

    The jitted solver program is identical to the single-chip one; GSPMD
    partitions it.  Returns the final cost (replicated scalar).

    graph_mode: None/'take' shards flat original-order edge/vertex axes;
    'banded' runs the banded one-hot engine under SPMD -- vertex arrays and
    blocked edge arrays shard by vertex-block rows and GSPMD exchanges
    the one-block gather-window halos."""
    import jax.numpy as jnp

    x, data = plan.bind(inputs, graph_mode=graph_mode or "take")
    x, data = shard_problem(plan, x, data, mesh)
    plan._data = data
    sp = plan._sp_device()
    sp["nIterations"] = jnp.asarray(
        int(n_iterations or plan.solver_params["nIterations"]), jnp.int32
    )
    with mesh:
        st = plan._init_fn(x, data, sp)
        st = plan._solve_fn(st, data, sp)
        jax.block_until_ready(st)
    plan._state = st
    return float(st["prev_cost"])
