"""SOAR spilling tests (partitioning/tree_partitioner.py soar_select_kernel).

Extension beyond the reference: the reference declares spilling config
but never implements any spilling (src/config.rs:151-155); this framework
implements both the threshold rule and SOAR (Sun, Guo & Kumar, NeurIPS
2023) — orthogonality-amplified secondary assignments.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
from scann_tpu.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
    soar_select_kernel,
)


@pytest.fixture(scope="module")
def skewed():
    return generate_adversarial_dataset(20000, 64, 32, 10, seed=11)


def _soar_loss_np(x, c, r1_hat, lam):
    r2 = x - c
    return float(r2 @ r2 + lam * (r2 @ r1_hat) ** 2)


def test_soar_kernel_matches_numpy():
    """Kernel argmin == brute-force numpy argmin of the SOAR loss over the
    r nearest candidates (primary excluded)."""
    rng = np.random.default_rng(0)
    k, d, b, r, lam = 32, 16, 64, 8, 1.5
    centers = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    d_all = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    primary = np.argmin(d_all, axis=1).astype(np.int32)

    sec = np.asarray(soar_select_kernel(
        jnp.asarray(centers), jnp.asarray(x), jnp.asarray(primary),
        jnp.float32(lam), r=r))

    for i in range(b):
        cand = np.argsort(d_all[i])[:r]
        r1 = x[i] - centers[primary[i]]
        r1h = r1 / max(np.linalg.norm(r1), 1e-30)
        losses = [np.inf if j == primary[i]
                  else _soar_loss_np(x[i], centers[j], r1h, lam)
                  for j in cand]
        expect = cand[int(np.argmin(losses))]
        assert sec[i] == expect, f"row {i}: {sec[i]} != {expect}"
    assert (sec != primary).all()


def test_soar_prefers_orthogonal_secondary():
    """With a candidate equidistant pair, SOAR must pick the one whose
    residual is orthogonal to the primary residual."""
    # primary at origin; point at (1, 0): r1 = x - c0 = (1, 0)
    # c_par at (3, 0): r2 = (-2, 0) parallel -> loss 4 + lam*4
    # c_orth at (1, 2): r2 = (0, -2) orthogonal -> loss 4
    centers = np.array([[0.0, 0.0], [3.0, 0.0], [1.0, 2.0]], np.float32)
    x = np.array([[1.0, 0.0]], np.float32)
    primary = np.array([0], np.int32)
    sec = np.asarray(soar_select_kernel(
        jnp.asarray(centers), jnp.asarray(x), jnp.asarray(primary),
        jnp.float32(1.0), r=3))
    assert sec[0] == 2


def test_soar_spills_every_point(skewed):
    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=64, seed=3, spilling=True, spilling_mode="soar",
        soar_lambda=1.0)).build(skewed.train)
    tk = tp.tokenization
    n = len(skewed.train)
    assert len(tk.point_indices) == 2 * n  # exactly one secondary each
    # each point appears exactly twice, in two distinct partitions
    counts = np.bincount(tk.point_indices, minlength=n)
    assert (counts == 2).all()


def test_soar_tree_ah_recall_beats_no_spill(skewed):
    """End to end on skewed data: SOAR at p leaves beats no-spill at p
    (the overquery its 2x memory buys)."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher

    ds = DenseDataset(skewed.train)

    def recall(spilling_mode):
        cfg = TreeXHybridConfig(
            num_partitions=128, partitions_to_search=4,
            spilling=spilling_mode is not None,
            spilling_mode=spilling_mode or "distance", soar_lambda=1.0,
            hash_config=AsymmetricHasherConfig(
                num_codes=16, num_subspaces=16, seed=1, max_iterations=8))
        s = TreeXHybridSearcher(cfg).build(ds)
        idx, _ = s.search_batched_arrays(
            skewed.test, 10, params=SearchParameters(
                num_leaves_to_search=4, pre_reordering_num_neighbors=80))
        return float(np.mean([len(set(a) & set(g)) / 10
                              for a, g in zip(idx, skewed.gt)]))

    r_none, r_soar = recall(None), recall("soar")
    assert r_soar > r_none + 0.01, f"soar {r_soar} vs none {r_none}"


def test_soar_composes_with_sharded_tree_ah(skewed):
    """A SOAR-spilled index served through the db-sharded flagship wrapper:
    the spilling dedup merge must hold across shard boundaries."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

    train = skewed.train[:8000]
    ds = DenseDataset(train)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=64, partitions_to_search=8,
        spilling=True, spilling_mode="soar", soar_lambda=1.0,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=16, seed=1, max_iterations=8))).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(num_leaves_to_search=8,
                              pre_reordering_num_neighbors=80)
    i1, d1 = s.search_batched_arrays(skewed.test, 10, params)
    i2, d2 = sh.search_batched_arrays(skewed.test, 10, params)
    for row in i2:
        live = [i for i in row if i >= 0]
        assert len(set(live)) == len(live)  # no duplicate across shards
    # sharded serves full local pre_k per shard: no worse than single-device
    gt = skewed.gt
    r1 = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                  for a, g in zip(i1, gt)])
    r2 = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                  for a, g in zip(i2, gt)])
    assert r2 >= r1 - 0.02


def test_facade_threads_soar(skewed):
    from scann_tpu.config import ScannConfig
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.models.scann import Scann

    cfg = ScannConfig(num_neighbors=10).with_partitioning().with_hashing()
    cfg.partitioning.num_partitions = 64
    cfg.partitioning.num_partitions_to_search = 8
    cfg.partitioning.with_soar(1.5)
    cfg.hash.num_buckets = 16
    cfg.hash.num_blocks = 16
    # JSON round-trip preserves the knobs
    cfg2 = ScannConfig.from_json(cfg.to_json())
    assert cfg2.partitioning.spilling_mode == "soar"
    assert cfg2.partitioning.soar_lambda == pytest.approx(1.5)
    s = Scann(DenseDataset(skewed.train[:4000]), cfg)
    tk = s._impl.partitioner.tokenization
    # nearly every point spills; a few secondaries may be dropped by the
    # per-partition cap (total size bounded by 2x the balance cap — see
    # TreePartitioner._cap_secondaries), which is the point of the cap
    assert 1.9 * 4000 <= len(tk.point_indices) <= 2 * 4000
    idx, _ = s.search_batched_arrays(skewed.test[:8], 10)
    assert idx.shape == (8, 10)
    # spilled duplicates must never surface twice in one result list
    for row in idx:
        live = [i for i in row if i >= 0]
        assert len(set(live)) == len(live)
