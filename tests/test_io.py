"""Index save/load round-trips: identical results without retraining."""

import numpy as np
import pytest

from scann_tpu import (
    BruteForceSearcher,
    DenseDataset,
    DistanceMeasure,
    ScalarQuantizedBruteForceSearcher,
    SearchParameters,
)
from scann_tpu.hashes import AsymmetricHasher, AsymmetricHasherConfig
from scann_tpu.io import load_index, save_index
from scann_tpu.models.partitioned import PartitionedSearcher
from scann_tpu.models.scann import Scann
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.partitioning import TreePartitionerConfig


@pytest.fixture
def db(rng):
    return rng.normal(size=(400, 16)).astype(np.float32)


def _same_results(a, b, q, k=5, params=None):
    ia, da = a.search_batched_arrays(q, k, params)
    ib, db_ = b.search_batched_arrays(q, k, params)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db_, rtol=1e-5)


def test_brute_force_round_trip(tmp_path, db, rng):
    s = BruteForceSearcher(DenseDataset(db), DistanceMeasure.COSINE)
    p = str(tmp_path / "bf.npz")
    save_index(p, s)
    s2 = load_index(p)
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))


def test_scalar_quantized_round_trip(tmp_path, db, rng):
    s = ScalarQuantizedBruteForceSearcher(DenseDataset(db))
    p = str(tmp_path / "sq.npz")
    save_index(p, s)
    s2 = load_index(p)
    # byte-identical codes and calibration
    np.testing.assert_array_equal(s.quantized_dataset.codes, s2.quantized_dataset.codes)
    assert s2.quantized_dataset.quantizer.scale == pytest.approx(
        s.quantized_dataset.quantizer.scale)
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))


def test_partitioned_round_trip(tmp_path, db, rng):
    s = PartitionedSearcher(DenseDataset(db),
                            config=TreePartitionerConfig(num_partitions=8, seed=42),
                            num_partitions_to_search=4)
    p = str(tmp_path / "part.npz")
    save_index(p, s)
    s2 = load_index(p)
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))


def test_hashed_round_trip(tmp_path, db, rng):
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=4, seed=42)).build(DenseDataset(db))
    p = str(tmp_path / "ah.npz")
    save_index(p, h)
    h2 = load_index(p)
    np.testing.assert_array_equal(h.codes, h2.codes)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    _same_results(h, h2, q)
    # reordering path survives (dataset stored)
    _same_results(h, h2, q, params=SearchParameters(pre_reordering_num_neighbors=50))


def test_tree_ah_round_trip(tmp_path, db, rng):
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=8, partitions_to_search=4,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4, seed=42),
    )).build(DenseDataset(db))
    p = str(tmp_path / "tah.npz")
    save_index(p, s)
    s2 = load_index(p)
    np.testing.assert_array_equal(s.codes, s2.codes)
    np.testing.assert_allclose(s.partitioner.centers, s2.partitioner.centers)
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))


def test_facade_round_trip(tmp_path, db, rng):
    s = Scann.brute_force(DenseDataset(db))
    p = str(tmp_path / "facade.npz")
    save_index(p, s)
    s2 = load_index(p)  # loads the inner searcher
    _same_results(s.impl, s2, rng.normal(size=(2, 16)).astype(np.float32))


def test_partitioned_round_trip_with_spilling(tmp_path, db, rng):
    tp_cfg = TreePartitionerConfig(num_partitions=8, seed=42, spilling=True,
                                   spilling_threshold=0.5)
    from scann_tpu.partitioning import TreePartitioner
    tp = TreePartitioner(tp_cfg).build(DenseDataset(db))
    s = PartitionedSearcher(DenseDataset(db), partitioner=tp,
                            num_partitions_to_search=4)
    p = str(tmp_path / "spill.npz")
    save_index(p, s)
    s2 = load_index(p)
    # spilled multi-assignments preserved exactly
    np.testing.assert_array_equal(
        s.partitioner.tokenization.point_indices,
        s2.partitioner.tokenization.point_indices)
    np.testing.assert_array_equal(
        s.partitioner.tokenization.offsets, s2.partitioner.tokenization.offsets)
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))


def test_block_sweep_round_trip(tmp_path, rng):
    from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher

    db = rng.normal(size=(1024, 16)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=64, block_r=8, tile_n=128, top2=True))
    p = str(tmp_path / "bs.npz")
    save_index(p, s)
    s2 = load_index(p)
    assert isinstance(s2, BlockSweepSearcher)
    assert s2._config.top2 and s2._config.block_r == 8
    q = db[:6]
    i1, d1 = s.search_batched_arrays(q, 5)
    i2, d2 = s2.search_batched_arrays(q, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


# -- sharded serving-layout warm start ------------------


def test_sharded_tree_layout_round_trip(tmp_path):
    """save_layout/load_layout: the restored sharded tree-AH serves the
    same answers without recomputing the per-shard re-shard + re-encode."""
    import time

    from scann_tpu import SearchParameters
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel import sharded_flagship as sf
    from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

    rng = np.random.default_rng(9)
    db = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    inner = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=16, partitions_to_search=8, rerank_dtype="bfloat16",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4,
                                           seed=0, max_iterations=4),
    )).build(DenseDataset(db))
    mesh = make_mesh(8, axis_names=("db",))
    sh = ShardedTreeXHybridSearcher(inner, mesh)
    path = str(tmp_path / "layout.npz")
    sh.save_layout(path)

    params = SearchParameters(pre_reordering_num_neighbors=64)
    i1, d1 = sh.search_batched_arrays(q, 5, params)

    # loading must NOT recompute the layout (the warm start's whole point)
    calls = {"n": 0}
    orig = sf._compute_tree_shard_layout

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    sf._compute_tree_shard_layout = counting
    try:
        sh2 = ShardedTreeXHybridSearcher.load_layout(path, mesh)
    finally:
        sf._compute_tree_shard_layout = orig
    assert calls["n"] == 0
    i2, d2 = sh2.search_batched_arrays(q, 5, params)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_sharded_sweep_layout_round_trip(tmp_path):
    from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel import sharded_flagship as sf
    from scann_tpu.parallel.sharded_flagship import ShardedBlockSweepSearcher

    rng = np.random.default_rng(9)
    db = rng.normal(size=(3000, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    inner = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        tile_n=256, block_r=8, pre_reorder_k=48, sweep_dtype="int8",
        rerank_dtype="int8"))
    mesh = make_mesh(8, axis_names=("db",))
    sh = ShardedBlockSweepSearcher(inner, mesh)
    path = str(tmp_path / "sweep_layout.npz")
    sh.save_layout(path)
    i1, d1 = sh.search_batched_arrays(q, 5)

    calls = {"n": 0}
    orig = sf._compute_sweep_shard_layout

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    sf._compute_sweep_shard_layout = counting
    try:
        sh2 = ShardedBlockSweepSearcher.load_layout(path, mesh)
    finally:
        sf._compute_sweep_shard_layout = orig
    assert calls["n"] == 0
    i2, d2 = sh2.search_batched_arrays(q, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_sharded_tree_layout_round_trip_custom_l_tile(tmp_path):
    """Warm start: a saved sharded layout (l_cap aligned to the leaf
    scorer's L-tile at save time) restores and serves bit-identically."""
    from scann_tpu import SearchParameters
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
    from scann_tpu.ops.tree_ah_grouped import L_TILE
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

    rng = np.random.default_rng(4)
    db = rng.normal(size=(1500, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    inner = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=12, partitions_to_search=6,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4,
                                           seed=0, max_iterations=4),
    )).build(DenseDataset(db))
    mesh = make_mesh(4, axis_names=("db",))
    sh = ShardedTreeXHybridSearcher(inner, mesh)
    assert sh._l_cap % L_TILE == 0
    path = str(tmp_path / "layout128.npz")
    sh.save_layout(path)
    params = SearchParameters(pre_reordering_num_neighbors=48)
    i1, d1 = sh.search_batched_arrays(q, 5, params)
    sh2 = ShardedTreeXHybridSearcher.load_layout(path, mesh)
    assert sh2._l_cap == sh._l_cap
    i2, d2 = sh2.search_batched_arrays(q, 5, params)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_load_index_rejects_sharded_layout_file(tmp_path, db, rng):
    """A sharded-layout .npz must fail load_index() with a clear pointer to
    load_sharded_layout, not a raw KeyError (advisor r4 finding)."""
    from scann_tpu.errors import ScannError
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

    inner = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=8, partitions_to_search=4,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4,
                                           seed=0, max_iterations=3),
    )).build(DenseDataset(db))
    sh = ShardedTreeXHybridSearcher(inner, make_mesh(8, axis_names=("db",)))
    path = str(tmp_path / "layout.npz")
    sh.save_layout(path)
    with pytest.raises(ScannError) as exc:
        load_index(path)
    assert "load_sharded_layout" in str(exc.value)


def test_tree_ah_legacy_save_serving_knob_defaults(tmp_path, db, rng):
    """Indexes saved with the retired kernel-shape keys (score_l_tile,
    group_q_cap, pack_codes) reload and serve identically: the slab layout
    now follows the platform's leaf scorer, so the keys are ignored."""
    import json as _json

    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=8, partitions_to_search=4,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=4,
                                           seed=42),
    )).build(DenseDataset(db))
    p = str(tmp_path / "legacy.npz")
    save_index(p, s)
    with np.load(p, allow_pickle=False) as z:
        meta = _json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    assert "score_l_tile" not in meta
    meta.update(score_l_tile=512, group_q_cap=8, pack_codes=False)
    np.savez_compressed(p, __meta__=np.frombuffer(
        _json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    s2 = load_index(p)
    assert not hasattr(s2.config, "score_l_tile")
    _same_results(s, s2, rng.normal(size=(4, 16)).astype(np.float32))
