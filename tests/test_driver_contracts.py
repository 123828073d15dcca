"""The driver entry points must stay importable and runnable."""

import json
import subprocess
import sys

import jax
import pytest


def test_entry_compiles_single_device():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert float(out["prev_cost"]) > 0


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (conftest provides them on CPU)")
    g.dryrun_multichip(8)  # asserts internally


def test_bench_prints_one_json_line():
    # static contract check (no GPU in tests): parse the print format
    import bench

    assert callable(bench.main)
    assert "json.dumps" in open(bench.__file__).read()
