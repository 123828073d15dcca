"""chip_smoke.py and bench.py on the CPU: the phase code at tiny sizes
(device and reference both the host CPU), and the refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke

TINY = dict(warp=16, large=24, volume=6, arap=8, many=8, lanes=4, lin=10)


@pytest.fixture
def smoke():
    cpu = jax.devices("cpu")[0]
    lines = []
    sm = chip_smoke.Smoke(cpu, cpu, seed=0, out=lines.append)
    sm.lines = lines
    return sm


def test_main_exits_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_bench_exits_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_script_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("phase,kwargs", [
    ("warp", dict(side=16, n_lin=10)),
    ("warp", dict(side=16, n_lin=10, kind="LMGPU")),
    ("warp", dict(side=16, n_lin=10, use_materialized_jacobian=True)),
    ("warp", dict(side=16, n_lin=10, use_materialized_jacobian=True,
                  use_fused_jtj=True)),
    ("volume", dict(side=6, n_lin=10)),
    ("arap", dict(side=8, n_lin=10)),
    ("solve_many", dict(side=8, n=4, n_lin=10)),
], ids=["gn", "lm", "materialized", "fused", "volume", "arap", "many"])
def test_phase_tiny(smoke, phase, kwargs):
    getattr(smoke, phase)(**kwargs)
    assert any("parity" in ln for ln in smoke.lines), smoke.lines
    assert any("wall_ms=" in ln for ln in smoke.lines), smoke.lines


def test_arap_phase_checks_banded_gather(smoke):
    smoke.arap(side=8, n_lin=10)
    assert any("bit for bit" in ln for ln in smoke.lines)
    assert any("banded vs take" in ln for ln in smoke.lines)


def test_four_card_phase_tiny(smoke):
    """The --chips 4 path on four of the virtual CPU devices: GSPMD and
    halo grids, a GSPMD graph, and sharded solve_many, each against one
    device."""
    smoke.four_card(4, scale=dict(warp=16, torus=8, many=8, lanes=8,
                                  lin=10))
    shards = [ln for ln in smoke.lines if "shards=4" in ln]
    assert len(shards) == 3, smoke.lines
    assert any("sharded_ms=" in ln for ln in smoke.lines)


@pytest.mark.parametrize("w,h", [(8, 8), (6, 10)])
def test_torus_graph_shards_evenly(w, h):
    v0, v1 = bench.tri_grid_graph(w, h, wrap=True)
    assert len(v0) == len(v1) == 6 * w * h
    # every vertex has exactly six incident directed edges per slot side
    assert np.all(np.bincount(v0, minlength=w * h) == 6)
    assert np.all(np.bincount(v1, minlength=w * h) == 6)
    assert not np.any(v0 == v1)
