"""chip_smoke.py's phases at a tiny size on the CPU (kernels in interpret
mode), and its refusal to run without a GPU."""

import importlib.util
import os
import sys

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


cs = _load()
TINY = cs.Sizes(n=65536, dim=16, clusters=256, batch=32, partitions=64,
                subspaces=8, small_n=6000, small_partitions=24,
                f64_queries=8)


@pytest.fixture(scope="module")
def world():
    db, q = cs.clustered(3, TINY.n, TINY.dim, TINY.clusters, TINY.batch)
    ref = cs.phase_reference(db, q, TINY)
    return db, q, ref


def test_reference_matches_float64(world, capsys):
    db, q, ref = world
    assert ref["gt_i"].shape == (TINY.batch, cs.K)
    assert np.all(np.diff(ref["gt_d"], axis=1) >= 0)
    d_full = ((q[:, None, :].astype(np.float64) - db[None]) ** 2).sum(-1)
    np.testing.assert_allclose(
        ref["gt_d"], np.sort(d_full, axis=1)[:, :cs.K], rtol=1e-5, atol=1e-4)


def test_phase_brute_force(world, capsys):
    db, q, ref = world
    cs.phase_brute_force(db, q, ref)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "brute_force"' in line


def test_phase_block_sweep(world, capsys):
    db, q, ref = world
    cs.phase_block_sweep(db, q, ref, seed=1, interpret=True)
    out = capsys.readouterr().out
    for phase in ("block_sweep", "block_sweep_allow_mask",
                  "block_sweep_parity", "block_sweep_top2",
                  "block_sweep_int8"):
        assert f'"phase": "{phase}"' in out


def test_phase_tree(world, capsys):
    db, q, ref = world
    cs.phase_tree(db, q, ref, TINY, seed=1, interpret=True)
    out = capsys.readouterr().out
    for phase in ("tree_ah", "tree_ah_parity", "tree_ah_soar_adversarial"):
        assert f'"phase": "{phase}"' in out


def test_phase_auto_and_harness(world, capsys):
    db, q, ref = world
    cs.phase_auto_and_harness(db, q, ref, TINY, seed=1)
    out = capsys.readouterr().out
    assert '"phase": "scann_auto"' in out
    assert '"phase": "harness_tree_ah"' in out


def test_phase_xla_paths(world, capsys):
    db, q, _ = world
    cs.phase_xla_paths(db, q, TINY)
    out = capsys.readouterr().out
    for phase in ("xla_lut16_hasher_reorder", "xla_int8_scalar_quantized",
                  "xla_dynamic_searcher", "native_host_library"):
        assert f'"phase": "{phase}"' in out


def test_require_raises():
    with pytest.raises(cs.SmokeFailure):
        cs.require(False, "threshold")


def test_main_refuses_non_gpu_platform(capsys):
    assert cs.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err


def test_phase_four_cards(capsys):
    """The --four-cards path on four of the tests' virtual CPU devices."""
    small = cs.Sizes(n=16384, dim=16, clusters=64, batch=32, partitions=16,
                     subspaces=8)
    cs.phase_four_cards(5, small)
    out = capsys.readouterr().out
    for phase in ("four_cards_reference", "sharded_block_sweep",
                  "sharded_tree_ah", "sharded_tree_ah_build"):
        assert f'"phase": "{phase}"' in out
