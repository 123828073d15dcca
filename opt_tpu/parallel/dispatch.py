"""Unified mesh-aware engine dispatch: one entry point for multi-chip.

The reference selects its entire execution backend with ONE flag
(reference: Opt.h:23-25 `backend = "backend_cuda"|"backend_cpu"|
"backend_cpu_mt"`, resolved in API/src/config.t:22); the user never
picks per-kernel machinery by hand.  This module gives the multi-chip
side the same shape: `plan.solve(inputs, mesh=m)` routes every plan to
GSPMD (parallel/mesh.py: sharding annotations on the inputs, XLA
inserts halos and all-reduces; the only path that supports every
energy).

The explicit ppermute halo path (parallel/halo.py) stays opt-in
(engine="halo"): it computes the same thing as GSPMD with hand-rolled
collectives.
"""

from __future__ import annotations

SHARDED_ENGINES = ("gspmd", "halo")

# single-chip engine names accepted as aliases so `plan.solve(...,
# engine=..., mesh=m)` keeps meaning "the same engine, sharded"
_ALIASES = {"auto": "gspmd", "xla": "gspmd"}


def pick_sharded_engine(plan, mesh, engine="auto"):
    """Resolve engine to the sharded path: "gspmd" or "halo"."""
    engine = _ALIASES.get(engine, engine)
    if engine not in SHARDED_ENGINES:
        raise ValueError(
            f"unknown or removed sharded engine {engine!r}; use 'auto', "
            f"'xla', 'gspmd' or 'halo'"
        )
    return engine


def solve_sharded_auto(plan, inputs, mesh, engine="auto",
                       n_iterations=None, graph_mode=None):
    """Full solve over a mesh through the selected sharded path; returns
    the final cost (replicated scalar).  Backs
    `Plan.solve(inputs, mesh=...)`."""
    if pick_sharded_engine(plan, mesh, engine) == "halo":
        from .halo import solve_sharded_halo

        return solve_sharded_halo(plan, inputs, mesh,
                                  n_iterations=n_iterations)
    from . import mesh as pmesh

    return pmesh.solve_sharded(
        plan, inputs, mesh, n_iterations=n_iterations,
        graph_mode=graph_mode or plan.state.graph_mode,
    )
