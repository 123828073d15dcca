"""Banded one-hot graph engine: planning, exactness, transpose pairing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from opt_tpu.ops import graph_banded as gb


def _mesh_graph(seed=0, n=400, deg=6, band=37):
    """Synthetic mesh-like graph: endpoints within `band` of each other."""
    rng = np.random.RandomState(seed)
    v0 = np.repeat(np.arange(n), deg).astype(np.int64)
    v1 = np.clip(v0 + rng.randint(-band, band + 1, size=len(v0)), 0, n - 1)
    return {"v0": v0, "v1": v1.astype(np.int64)}, n


@pytest.fixture(scope="module")
def banding():
    slots, n = _mesh_graph()
    vb = gb.plan_vertex_banding({"G": slots}, n, force=True)
    assert vb is not None
    return vb, slots, n


def _meta(plan_g, n):
    return dict(vb=plan_g.vb, n_vblk=plan_g.n_vblk, eb=plan_g.eb,
                n_verts=n)


def test_plan_shapes(banding):
    vb, slots, n = banding
    g = vb.graphs["G"]
    assert g.ep == g.n_vblk * g.eb
    assert g.pad_mask.sum() == len(slots["v0"])
    assert sorted(vb.perm) == list(range(n))
    # window-locality invariant: every non-pad loc is inside [0, 3VB)
    for lc in g.loc.values():
        real = lc[lc >= 0]
        assert real.min() >= 0 and real.max() < 3 * g.vb


def test_gather_exact(banding):
    vb, slots, n = banding
    g = vb.graphs["G"]
    p = np.random.RandomState(1).randn(n, 5).astype(np.float32)
    p_perm = p[vb.perm]
    for sname in ("v0", "v1"):
        got = np.asarray(
            jax.jit(
                lambda v: gb.banded_gather(
                    jnp.asarray(g.loc[sname]), v, **_meta(g, n))
            )(jnp.asarray(p_perm))
        ).reshape(g.ep, -1)
        # padded row e_perm[i] must equal p[slot[i]] exactly
        want = p[slots[sname]]
        np.testing.assert_array_equal(got[g.edge_perm], want)
        # pad rows are zero
        assert np.all(got[~g.pad_mask] == 0)


def test_scatter_matches_segment_sum(banding):
    vb, slots, n = banding
    g = vb.graphs["G"]
    e = np.zeros((g.ep, 3), np.float32)
    rng = np.random.RandomState(2)
    e[g.pad_mask] = rng.randn(int(g.pad_mask.sum()), 3)
    got = np.asarray(
        jax.jit(
            lambda v: gb.banded_scatter(
                jnp.asarray(g.loc["v1"]), v, **_meta(g, n))
        )(jnp.asarray(e.reshape(g.n_vblk, g.eb, -1)))
    )
    want = np.zeros((n, 3), np.float64)
    # scatter target v1, in the permuted vertex order
    tgt = vb.inv_perm[slots["v1"]]
    np.add.at(want, tgt, e[g.edge_perm].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_transpose_pairing(banding):
    """linear_transpose of gather is scatter (so J^T routes correctly)."""
    vb, slots, n = banding
    g = vb.graphs["G"]
    loc = jnp.asarray(g.loc["v0"])
    meta = _meta(g, n)

    def fn(v):
        return gb.banded_gather(loc, v, **meta) * 2.0

    v0 = jnp.zeros((n, 2), jnp.float32)
    _, jvp = jax.linearize(fn, v0)
    jt = jax.linear_transpose(jvp, v0)
    ct = jnp.asarray(np.random.RandomState(3).randn(
        g.n_vblk, g.eb, 2).astype(np.float32))
    (got,) = jt(ct)
    want = 2.0 * gb.banded_scatter(loc, ct, **meta)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_planning_rejects_unbandable():
    rng = np.random.RandomState(4)
    n, e = 4000, 30000
    slots = {"v0": rng.randint(0, n, e), "v1": rng.randint(0, n, e)}
    assert gb.plan_vertex_banding({"G": slots}, n, max_bandwidth=256) is None
    # and tiny graphs are skipped without force
    s2, n2 = _mesh_graph(n=100)
    assert gb.plan_vertex_banding({"G": s2}, n2) is None


# ---------------------------------------------------------------------------
# layout variants: ELL primary slot, stacked slots_gather, forced layouts
# ---------------------------------------------------------------------------


def _plan_layout(layout, monkeypatch, **kw):
    monkeypatch.setenv("OPT_TPU_GRAPH_LAYOUT", layout)
    slots, n = _mesh_graph(**kw)
    vb = gb.plan_vertex_banding({"G": slots}, n, force=True)
    return vb, slots, n


@pytest.mark.parametrize("layout", ["balanced", "ell"])
def test_forced_layout_gather_exact(layout, monkeypatch):
    vb, slots, n = _plan_layout(layout, monkeypatch)
    g = vb.graphs["G"]
    assert g.layout == layout
    band = gb.DeviceBanding(
        {s: jnp.asarray(lc) for s, lc in g.loc.items()},
        jnp.asarray(g.pad_mask), g.vb, g.n_vblk, g.eb, n,
        layout=g.layout, primary_slot=g.primary_slot, deg=g.deg,
    )
    p = np.random.RandomState(11).randn(n, 4).astype(np.float32)
    p_perm = jnp.asarray(p[vb.perm])
    for sname in ("v0", "v1"):
        got = np.asarray(
            jax.jit(lambda v: gb.slot_gather(band, sname, v))(p_perm)
        ).reshape(g.ep, -1)
        np.testing.assert_array_equal(
            got[g.edge_perm], p[slots[sname]]
        )
        if not (layout == "ell" and sname == g.primary_slot):
            # one-hot paths zero pad rows; ELL primary broadcasts values
            assert np.all(got[~g.pad_mask] == 0)


@pytest.mark.parametrize("layout", ["balanced", "ell"])
def test_slots_gather_matches_per_slot(layout, monkeypatch):
    """The stacked all-slots gather equals per-slot gathers."""
    vb, slots, n = _plan_layout(layout, monkeypatch, seed=9)
    g = vb.graphs["G"]
    band = gb.DeviceBanding(
        {s: jnp.asarray(lc) for s, lc in g.loc.items()},
        jnp.asarray(g.pad_mask), g.vb, g.n_vblk, g.eb, n,
        layout=g.layout, primary_slot=g.primary_slot, deg=g.deg,
    )
    p = jnp.asarray(
        np.random.RandomState(12).randn(n, 3).astype(np.float32))
    rows = jax.jit(
        lambda v: gb.slots_gather(band, ["v0", "v1"], v))(p)
    for sname in ("v0", "v1"):
        want = jax.jit(lambda v: gb.slot_gather(band, sname, v))(p)
        np.testing.assert_array_equal(
            np.asarray(rows[sname]), np.asarray(want))


@pytest.mark.parametrize("layout", ["balanced", "ell"])
def test_slot_scatter_matches_segment_sum(layout, monkeypatch):
    vb, slots, n = _plan_layout(layout, monkeypatch, seed=13)
    g = vb.graphs["G"]
    band = gb.DeviceBanding(
        {s: jnp.asarray(lc) for s, lc in g.loc.items()},
        jnp.asarray(g.pad_mask), g.vb, g.n_vblk, g.eb, n,
        layout=g.layout, primary_slot=g.primary_slot, deg=g.deg,
    )
    e = np.zeros((g.ep, 2), np.float32)
    rng = np.random.RandomState(14)
    e[g.pad_mask] = rng.randn(int(g.pad_mask.sum()), 2)
    for sname in ("v0", "v1"):
        got = np.asarray(
            jax.jit(lambda v: gb.slot_scatter(band, sname, v))(
                jnp.asarray(e.reshape(g.n_vblk, g.eb, -1)))
        )
        want = np.zeros((n, 2), np.float64)
        np.add.at(want, vb.inv_perm[slots[sname]],
                  e[g.edge_perm].astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ell_transpose_pairing(monkeypatch):
    """linear_transpose of ell_gather is ell_scatter."""
    vb, slots, n = _plan_layout("ell", monkeypatch, seed=15)
    g = vb.graphs["G"]
    meta = dict(vb=g.vb, n_vblk=g.n_vblk, deg=g.deg, n_verts=n)

    def fn(v):
        return gb.ell_gather(v, **meta) * 3.0

    v0 = jnp.zeros((n, 2), jnp.float32)
    _, jvp = jax.linearize(fn, v0)
    jt = jax.linear_transpose(jvp, v0)
    ct = jnp.asarray(np.random.RandomState(16).randn(
        g.n_vblk, g.eb, 2).astype(np.float32))
    (got,) = jt(ct)
    want = 3.0 * gb.ell_scatter(ct, **meta)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# tiled two-level layout: high-bandwidth graphs (local + long-range edges)
# ---------------------------------------------------------------------------


def _longrange_graph(seed=21, n=3000, deg=4, band=20, n_far=40):
    """Mostly-local graph plus a few random long-range chords: RCM
    bandwidth blows past the 3-block-window limit but every edge tile
    touches few blocks."""
    rng = np.random.RandomState(seed)
    v0 = np.repeat(np.arange(n), deg).astype(np.int64)
    v1 = np.clip(v0 + rng.randint(-band, band + 1, size=len(v0)), 0, n - 1)
    far0 = rng.randint(0, n, n_far)
    far1 = rng.randint(0, n, n_far)
    v0 = np.concatenate([v0, far0, far1])
    v1 = np.concatenate([v1, far1, far0])
    return {"v0": v0, "v1": v1.astype(np.int64)}, n


@pytest.fixture(scope="module")
def tiled_banding():
    slots, n = _longrange_graph()
    vb = gb.plan_vertex_banding({"G": slots}, n, max_bandwidth=256,
                                force=True)
    assert vb is not None
    assert vb.graphs["G"].layout == "tiled"
    return vb, slots, n


def test_tiled_plan_shapes(tiled_banding):
    vb, slots, n = tiled_banding
    g = vb.graphs["G"]
    assert g.wblk is not None and g.wblk.shape[0] == g.n_eblk
    assert g.wblk.shape[1] <= gb.MAX_WINDOW_BLOCKS
    assert g.pad_mask.sum() == len(slots["v0"])
    K = g.wblk.shape[1]
    for lc in g.loc.values():
        real = lc[lc >= 0]
        assert real.min() >= 0 and real.max() < K * g.vb


def test_tiled_gather_scatter_exact(tiled_banding):
    vb, slots, n = tiled_banding
    g = vb.graphs["G"]
    band = gb.DeviceBanding(
        {s: jnp.asarray(lc) for s, lc in g.loc.items()},
        jnp.asarray(g.pad_mask.reshape(g.n_eblk, g.eb)),
        g.vb, g.n_vblk, g.eb, n, layout="tiled",
        wblk=jnp.asarray(g.wblk),
    )
    p = np.random.RandomState(22).randn(n, 3).astype(np.float32)
    p_perm = jnp.asarray(p[vb.perm])
    for sname in ("v0", "v1"):
        got = np.asarray(
            jax.jit(lambda v: gb.slot_gather(band, sname, v))(p_perm)
        ).reshape(g.ep, -1)
        np.testing.assert_array_equal(got[g.edge_perm], p[slots[sname]])
        assert np.all(got[~g.pad_mask] == 0)
    # stacked slots_gather agrees
    rows = jax.jit(
        lambda v: gb.slots_gather(band, ["v0", "v1"], v))(p_perm)
    for sname in ("v0", "v1"):
        want = jax.jit(lambda v: gb.slot_gather(band, sname, v))(p_perm)
        np.testing.assert_array_equal(
            np.asarray(rows[sname]), np.asarray(want))
    # scatter matches segment_sum
    e = np.zeros((g.ep, 2), np.float32)
    e[g.pad_mask] = np.random.RandomState(23).randn(
        int(g.pad_mask.sum()), 2)
    got = np.asarray(
        jax.jit(lambda v: gb.slot_scatter(band, "v1", v))(
            jnp.asarray(e.reshape(g.n_eblk, g.eb, -1)))
    )
    want = np.zeros((n, 2), np.float64)
    np.add.at(want, vb.inv_perm[slots["v1"]],
              e[g.edge_perm].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tiled_transpose_pairing(tiled_banding):
    vb, slots, n = tiled_banding
    g = vb.graphs["G"]
    wblk = jnp.asarray(g.wblk)
    loc = jnp.asarray(g.loc["v1"])
    meta = _meta(g, n)

    def fn(v):
        return gb.tiled_gather(wblk, loc, v, **meta) * 2.0

    v0 = jnp.zeros((n, 2), jnp.float32)
    _, jvp = jax.linearize(fn, v0)
    jt = jax.linear_transpose(jvp, v0)
    ct = jnp.asarray(np.random.RandomState(24).randn(
        g.n_eblk, g.eb, 2).astype(np.float32))
    (got,) = jt(ct)
    want = 2.0 * gb.tiled_scatter(wblk, loc, ct, **meta)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_arap_tiled_matches_take():
    """End-to-end solve on a long-range graph: the tiled engine matches
    take/segment_sum."""
    import opt_tpu
    from opt_tpu import energies

    # enough random chords that the post-RCM bandwidth makes 3-block
    # windows more one-hot work than K-block tiled windows (the
    # _onehot_work comparison picks tiled)
    slots, n = _longrange_graph(seed=25, n=6000, deg=4, band=15,
                                n_far=120)
    e = len(slots["v0"])
    inputs = _arap_inputs(n, slots)
    results = {}
    for mode in ("take", "banded"):
        state = opt_tpu.NewState(graph_mode=mode)
        plan = state.problem_plan(
            state.problem_define(energies.arap_mesh_deformation,
                                 "gaussNewtonGPU"), [n, e],
        )
        plan.set_solver_parameter("nIterations", 3)
        plan.set_solver_parameter("lIterations", 15)
        plan.init(inputs)
        if mode == "banded":
            bandplan = plan._active_banding
            key = next(iter(bandplan))
            assert bandplan[key].graphs["G"].layout == "tiled", (
                "test graph unexpectedly bandable; raise n_far/band")
        init_cost = plan.current_cost()
        while plan.step():
            pass
        results[mode] = (init_cost, plan.final_cost())
    ic_t, fc_t = results["take"]
    ic_b, fc_b = results["banded"]
    assert ic_b == pytest.approx(ic_t, rel=1e-6)
    assert fc_b == pytest.approx(fc_t, rel=1e-3)


# ---------------------------------------------------------------------------
# end-to-end: banded engine inside a full solve
# ---------------------------------------------------------------------------


def _arap_inputs(n, slots, seed=5):
    rng = np.random.RandomState(seed)
    ur = rng.randn(n, 3).astype(np.float32)
    cons = np.full((n, 3), -1e7, np.float32)
    sel = rng.choice(n, max(4, n // 20), replace=False)
    cons[sel] = ur[sel] + 0.1
    return {
        "Offset": ur.copy(),
        "Angle": np.zeros((n, 3), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "w_fitSqrt": 2.0,
        "w_regSqrt": 1.0,
        "G": {"v0": slots["v0"], "v1": slots["v1"]},
    }


@pytest.mark.parametrize("kind,layout", [
    ("gaussNewtonGPU", "ell"),
    ("LMGPU", "ell"),
    ("gaussNewtonGPU", "balanced"),
])
def test_arap_banded_matches_take(kind, layout, monkeypatch):
    import opt_tpu
    from opt_tpu import energies

    monkeypatch.setenv("OPT_TPU_GRAPH_LAYOUT", layout)
    slots, n = _mesh_graph(seed=7, n=300, deg=6, band=29)
    e = len(slots["v0"])
    inputs = _arap_inputs(n, slots)

    results = {}
    for mode in ("take", "banded"):
        state = opt_tpu.NewState(graph_mode=mode)
        plan = state.problem_plan(
            state.problem_define(energies.arap_mesh_deformation, kind),
            [n, e],
        )
        plan.set_solver_parameter("nIterations", 4)
        plan.set_solver_parameter("lIterations", 20)
        plan.init(inputs)
        init_cost = plan.current_cost()
        while plan.step():
            pass
        results[mode] = (init_cost, plan.final_cost(), plan.unknowns())

    ic_t, fc_t, x_t = results["take"]
    ic_b, fc_b, x_b = results["banded"]
    assert ic_b == pytest.approx(ic_t, rel=1e-6)
    # scatters sum in a different f32 order than segment_sum, so iterate
    # trajectories drift slightly; the near-zero optimum (cost ~3e-5 from
    # ~1e3 initial) amplifies the relative difference
    assert fc_b == pytest.approx(fc_t, rel=1e-3)
    # unknowns come back in the ORIGINAL vertex order despite the internal
    # RCM permutation
    np.testing.assert_allclose(
        x_b["Offset"], x_t["Offset"], rtol=1e-3, atol=1e-4
    )


def test_retrace_hlo_deterministic():
    """Tracing the same banded program twice yields identical jaxprs:
    the one-hot tag counter resets per top-level trace (advisor r2 --
    an ever-advancing counter defeated the persistent compile cache)."""
    import jax

    import opt_tpu
    from opt_tpu import energies

    slots, n = _mesh_graph(seed=3, n=300, deg=6, band=29)
    e = len(slots["v0"])
    inputs = _arap_inputs(n, slots)
    state = opt_tpu.NewState(graph_mode="banded")
    plan = state.problem_plan(
        state.problem_define(energies.arap_mesh_deformation,
                             "gaussNewtonGPU"), [n, e],
    )
    x, data = plan.bind(inputs)
    assert plan._active_banding, "banded engine should be active"
    sp = plan._sp_device()
    j1 = str(jax.make_jaxpr(plan.raw_init_fn)(x, data, sp))
    j2 = str(jax.make_jaxpr(plan.raw_init_fn)(x, data, sp))
    assert j1 == j2
    s1 = str(jax.make_jaxpr(plan.raw_step_fn)(
        plan.raw_init_fn(x, data, sp), data, sp))
    s2 = str(jax.make_jaxpr(plan.raw_step_fn)(
        plan.raw_init_fn(x, data, sp), data, sp))
    assert s1 == s2
