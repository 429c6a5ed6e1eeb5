"""The one device dispatch (types.platform), where the compile cache goes,
and the per-device profiles behind Scann.auto()."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import scann_tpu
from scann_tpu import types
from scann_tpu.errors import ScannError
from scann_tpu.ops import sweep_pallas

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "scann_tpu"


class _FakeDevice:
    def __init__(self, platform, device_kind="fake"):
        self.platform = platform
        self.device_kind = device_kind


def test_cpu_platform_serves_plain_formulations():
    assert types.platform() == "cpu"
    assert types.use_gpu_kernels() is False


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_unknown_platform_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(backend)])
    with pytest.raises(ScannError, match=backend):
        types.platform()


def _sweep_case():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(512, 12)).astype(np.float32)
    aug = jnp.asarray(sweep_pallas.build_augmented_db(
        db, 500, sweep_pallas.DistanceMeasure.SQUARED_L2, tile_n=256))
    qa = sweep_pallas._augment_queries(
        jnp.asarray(rng.normal(size=(8, 12)).astype(np.float32)),
        sweep_pallas.DistanceMeasure.SQUARED_L2, aug.shape[1])
    return qa, aug


def test_sweep_uses_plain_minima_on_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel must not serve on the CPU")

    monkeypatch.setattr(sweep_pallas, "block_minima_pallas", refuse)
    qa, aug = _sweep_case()
    pv, cand = sweep_pallas.sweep_block_candidates(qa, aug, pre_k=4, r=8)
    assert pv.shape == cand.shape == (8, 4)


def test_sweep_uses_kernel_on_gpu(monkeypatch):
    """On the GPU the kernel serves, called without interpret mode."""
    calls = []

    def spy(q, db, pen=None, *, r, top2=False, **kw):
        calls.append(kw)
        return sweep_pallas.block_minima_xla(q, db, pen, r=r, top2=top2)

    monkeypatch.setattr(sweep_pallas, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(sweep_pallas, "block_minima_pallas", spy)
    qa, aug = _sweep_case()
    sweep_pallas.sweep_block_candidates(qa, aug, pre_k=4, r=8)
    assert calls == [{}]


def test_tree_leaf_scorer_follows_platform(monkeypatch):
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models import tree_x_hybrid as tx

    db = np.random.default_rng(1).normal(size=(300, 8)).astype(np.float32)
    s = tx.TreeXHybridSearcher(tx.TreeXHybridConfig(
        num_partitions=4, partitions_to_search=2,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4,
                                           seed=0, max_iterations=2),
    )).build(DenseDataset(db))
    assert s._leaf_scorer() == "pairs"
    monkeypatch.setattr(tx, "use_gpu_kernels", lambda: True)
    assert s._leaf_scorer() == "grouped"


def _package_trees():
    for path in sorted(PACKAGE.rglob("*.py")):
        yield path, ast.parse(path.read_text(), filename=str(path))


def test_every_pallas_call_names_a_gpu_route():
    found = 0
    for path, tree in _package_trees():
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "pallas_call"):
                found += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert isinstance(kw.get("backend"), ast.Constant), path
                assert kw["backend"].value in ("triton", "mosaic_gpu"), path
    assert found >= 2


def test_no_interpret_mode_reachable_from_a_searcher():
    """Interpret mode runs only when a caller passes interpret=True: no
    package code passes anything but its own ``interpret`` parameter, and
    every such parameter defaults to False."""
    for path, tree in _package_trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.keyword) and node.arg == "interpret":
                assert (isinstance(node.value, ast.Name)
                        and node.value.id == "interpret"), \
                    (path, ast.unparse(node.value))
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                args = node.args
                names = [a.arg for a in args.kwonlyargs]
                for name, default in zip(names, args.kw_defaults):
                    if name == "interpret":
                        assert isinstance(default, ast.Constant) \
                            and default.value is False, path
                pos = args.posonlyargs + args.args
                for a, default in zip(pos[len(pos) - len(args.defaults):],
                                      args.defaults):
                    if a.arg == "interpret":
                        assert isinstance(default, ast.Constant) \
                            and default.value is False, path


# -- compile cache ------------------------------------------------------------

def test_compile_cache_left_to_jax_when_its_variable_is_set(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.delenv("SCANN_TPU_COMPILE_CACHE", raising=False)
    assert scann_tpu.compile_cache_dir() is None


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("SCANN_TPU_COMPILE_CACHE", raising=False)
    assert scann_tpu.compile_cache_dir() == str(REPO / ".jax_cache")


def test_compile_cache_opt_out(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("SCANN_TPU_COMPILE_CACHE", "0")
    assert scann_tpu.compile_cache_dir() is None


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement_at_import(tmp_path, env_dir):
    """What a fresh process that imports the package ends up with."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "SCANN_TPU_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    want = str(REPO / ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, scann_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == want


# -- device profiles ----------------------------------------------------------

def test_unknown_device_kind_names_calibrate(monkeypatch):
    from scann_tpu.utils import chip_profile

    monkeypatch.delenv("SCANN_TPU_CHIP_PROFILE", raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice("gpu", "Unprofiled GPU")])
    with pytest.raises(ScannError, match=r"calibrate\(\)"):
        chip_profile.load_profile()


def test_committed_profiles(monkeypatch):
    from scann_tpu.utils.chip_profile import PROFILES, load_profile

    monkeypatch.delenv("SCANN_TPU_CHIP_PROFILE", raising=False)
    h100 = PROFILES["NVIDIA H100 80GB HBM3"]
    assert "700.00 W" in h100.source and "calibrate()" in h100.source
    assert "test-only" in PROFILES["cpu"].source
    assert load_profile() is PROFILES["cpu"]
