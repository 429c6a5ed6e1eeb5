"""Recall-targeted autotuning: cheapest grid point meeting the target."""

import numpy as np
import pytest

from scann_tpu import (
    BlockSweepConfig,
    BlockSweepSearcher,
    BruteForceSearcher,
    DenseDataset,
    DistanceMeasure,
    TreeXHybridConfig,
    TreeXHybridSearcher,
    autotune,
)
from scann_tpu.hashes.hasher import AsymmetricHasherConfig


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(32, 24)).astype(np.float32) * 3.0
    assign = rng.integers(0, 32, size=4000)
    db = (centers[assign] + rng.normal(size=(4000, 24)) * 0.4).astype(np.float32)
    q = (centers[rng.integers(0, 32, size=32)]
         + rng.normal(size=(32, 24)) * 0.4).astype(np.float32)
    return db, q


def test_autotune_tree_ah_meets_target(clustered):
    db, q = clustered
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=4,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=1, max_iterations=5),
    )).build(DenseDataset(db))
    res = autotune(s, q, k=10, target_recall=0.95,
                   p_grid=(2, 4, 8, 16), pre_k_grid=(20, 50, 100))
    assert res.target_met
    assert res.recall >= 0.95
    # re-measure independently with the returned params
    gt, _ = BruteForceSearcher(DenseDataset(db)).search_batched_arrays(q, 10)
    idx, _ = s.search_batched_arrays(q, 10, res.params)
    rec = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                   for a, g in zip(idx, gt)])
    assert rec >= 0.95
    # cheapest: no other passing grid point has lower cost
    passing = [e for e in res.table if e.recall >= 0.95]
    assert all(e.cost >= min(x.cost for x in passing) for e in passing)
    best_cost = (res.params.num_leaves_to_search,
                 res.params.pre_reordering_num_neighbors)
    assert best_cost[0] in (2, 4, 8, 16) and best_cost[1] in (20, 50, 100)


def test_autotune_block_sweep_pre_k_only(clustered):
    db, q = clustered
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        block_r=8, tile_n=256, pre_reorder_k=16))
    res = autotune(s, q, k=10, target_recall=0.98,
                   pre_k_grid=(16, 32, 64, 128))
    assert res.target_met and res.recall >= 0.98
    assert res.params.num_leaves_to_search is None
    # the sweep's cost proxy is pre_k alone: the result is the smallest
    # passing pre_k
    passing = sorted(e.params.pre_reordering_num_neighbors
                     for e in res.table if e.recall >= 0.98)
    assert res.params.pre_reordering_num_neighbors == passing[0]


def test_autotune_unreachable_target_reports_best(clustered):
    db, q = clustered
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=2,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=1, max_iterations=5),
    )).build(DenseDataset(db))
    res = autotune(s, q, k=10, target_recall=1.01,  # impossible
                   p_grid=(1, 2), pre_k_grid=(10, 20))
    assert not res.target_met
    assert res.recall == max(e.recall for e in res.table)


def test_autotune_cosine_measure(clustered):
    """GT is computed in the searcher's own measure."""
    db, q = clustered
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        distance_measure=DistanceMeasure.COSINE,
        block_r=8, tile_n=256, pre_reorder_k=16))
    res = autotune(s, q, k=10, target_recall=0.9,
                   pre_k_grid=(32, 128))
    assert res.target_met
    gt, _ = BruteForceSearcher(
        DenseDataset(db), DistanceMeasure.COSINE).search_batched_arrays(q, 10)
    idx, _ = s.search_batched_arrays(q, 10, res.params)
    rec = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                   for a, g in zip(idx, gt)])
    assert rec >= 0.9


# -- build-knob autotuning + advisor --------------------


def test_autotune_block_sweep_build_knobs(clustered):
    """autotune_block_sweep sweeps (r, sweep_dtype, top2, pre_k) and
    returns a BUILD config + serving params meeting the target."""
    from scann_tpu.utils.autotune import autotune_block_sweep

    db, q = clustered
    ds = DenseDataset(db)
    res = autotune_block_sweep(
        ds, q, k=10, target_recall=0.95,
        r_grid=(8,), dtype_grid=("bfloat16", "int8"),
        top2_options=(False, True), pre_k_grid=(20, 60))
    assert res.target_met
    assert res.recall >= 0.95
    # the chosen config really reaches the reported recall when rebuilt
    s = BlockSweepSearcher(ds, res.config)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    idx, _ = s.search_batched_arrays(q, 10, res.params)
    rec = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                   for a, g in zip(idx, gt)])
    assert rec >= 0.95 - 0.02
    # the table covered the whole grid
    assert len(res.table) == 2 * 2 * 2


def test_advisor_detects_skew():
    """Zipf-mass samples trigger SOAR; uniform clustered samples don't."""
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
    from scann_tpu.utils.advisor import advise_build, dataset_stats

    rng = np.random.default_rng(3)
    adv = generate_adversarial_dataset(6000, 8, 24, 10, seed=3)
    stats_skew = dataset_stats(adv.train)
    assert stats_skew.skewed, vars(stats_skew)

    centers = rng.normal(size=(32, 24)).astype(np.float32) * 3.0
    assign = rng.integers(0, 32, size=6000)  # uniform mass
    friendly = (centers[assign]
                + rng.normal(size=(6000, 24)) * 0.4).astype(np.float32)
    stats_flat = dataset_stats(friendly)
    assert not stats_flat.skewed, vars(stats_flat)

    a_skew = advise_build(1_000_000, 24, adv.train)
    assert a_skew.spilling and a_skew.spilling_mode == "soar"
    assert a_skew.partitions_to_search >= 20
    a_flat = advise_build(1_000_000, 24, friendly)
    assert not a_flat.spilling
    # a 0.99 target forces SOAR even on friendly data
    a_99 = advise_build(1_000_000, 24, friendly, target_recall=0.99)
    assert a_99.spilling


def test_advisor_p_scales_with_partition_count():
    """On skewed data partitions_to_search tracks the probe FRACTION, not
    a constant: recall at matched fraction is scale-invariant (1.5% ->
    0.9909 at 1.18M/2000 parts, 0.9892 at 10M/16k; constant p=30 at 16k
    probes 0.19% and caps at 0.927)."""
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
    from scann_tpu.utils.advisor import advise_build

    adv = generate_adversarial_dataset(6000, 8, 24, 10, seed=3)
    small = advise_build(1_180_000, 24, adv.train, target_recall=0.99)
    big = advise_build(10_000_000, 24, adv.train, target_recall=0.99)
    assert small.partitions_to_search >= 30
    assert big.num_partitions > small.num_partitions
    # ~1.5% of the partition count at 0.99, so p grows with the tree
    assert big.partitions_to_search >= 0.014 * big.num_partitions
    assert big.pre_reorder_k >= big.partitions_to_search * 3
    # lower targets probe a smaller fraction (the measured 0.95/0.97 rows)
    mid = advise_build(10_000_000, 24, adv.train, target_recall=0.95)
    assert mid.partitions_to_search < big.partitions_to_search


def test_chip_profile_round_trip_and_override(tmp_path, monkeypatch):
    from scann_tpu.models.scann import auto_config
    from scann_tpu.utils.chip_profile import ChipProfile, load_profile, save_profile

    prof = ChipProfile(sweep_max_n=1000, f32_rerank_max_bytes=123,
                       source="test")
    path = str(tmp_path / "chip.json")
    save_profile(prof, path)
    loaded = load_profile(path)
    assert loaded == prof

    # auto_config honors the overridden crossover: 5000 > 1000 -> tree-AH
    monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", path)
    cfg = auto_config(5000, 24)
    assert cfg.partitioning is not None and cfg.hash is not None
    monkeypatch.delenv("SCANN_TPU_CHIP_PROFILE")
    cfg2 = auto_config(5000, 24)
    assert cfg2.brute_force is not None  # default profile: sweep regime


def test_scann_auto_meets_target_on_adversarial(monkeypatch):
    """Scann.auto(target_recall=0.99) on (small-scale) adversarial data:
    no hand-set knobs, serving recall meets the target (pinned at test
    scale)."""
    from scann_tpu import Scann
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset

    data = generate_adversarial_dataset(8000, 64, 24, 10, seed=5)
    ds = DenseDataset(data.train)
    s = Scann.auto(ds, target_recall=0.99, tune_queries=data.test)
    assert s.autotune_result.target_met
    idx, _ = s.search_batched_arrays(data.test, 10)  # no explicit params
    rec = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                   for a, g in zip(idx, data.gt)])
    assert rec >= 0.99 - 0.01


def test_advise_config_skew_routes_to_sweep(monkeypatch, tmp_path):
    """Skewed data between sweep_max_n and the sweep's device-memory
    ceiling routes to the skew-immune sweep with compact copies."""
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
    from scann_tpu.utils.advisor import advise_config
    from scann_tpu.utils.chip_profile import ChipProfile, save_profile

    path = str(tmp_path / "chip.json")
    save_profile(ChipProfile(sweep_max_n=1000, source="test"), path)
    monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", path)
    data = generate_adversarial_dataset(6000, 8, 24, 10, seed=5)
    cfg = advise_config(6000, 24, data.train, target_recall=0.99)
    assert cfg.brute_force is not None and cfg.brute_force.block_sweep
    assert cfg.brute_force.block_sweep_dtype == "int8"
    assert cfg.exact_reordering.rerank_dtype == "bfloat16"
    # friendly data past the crossover still takes the tree
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(32, 24)).astype(np.float32) * 3.0
    friendly = (centers[rng.integers(0, 32, 6000)]
                + rng.normal(size=(6000, 24)) * 0.4).astype(np.float32)
    cfg2 = advise_config(6000, 24, friendly, target_recall=0.9)
    assert cfg2.brute_force is None and cfg2.partitioning is not None


def test_scann_auto_tree_regime_uses_advisor(monkeypatch, tmp_path):
    """With the chip profile's crossover forced below N, Scann.auto with a
    target routes through the advisor -> SOAR tree-AH on skewed data."""
    from scann_tpu.models.scann import Scann, SearchMode
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
    from scann_tpu.utils.chip_profile import ChipProfile, save_profile

    path = str(tmp_path / "chip.json")
    # f32_rerank_max_bytes tiny too: skewed data below the sweep's memory
    # ceiling (correctly) routes back to the skew-immune sweep, so
    # exercising the advisor's TREE path requires the capacity-mandated
    # regime (ceiling = 0.5*3*f32_bytes / (64 + 2*32) bytes per row at
    # d=32 must sit below N)
    save_profile(ChipProfile(sweep_max_n=1000, partition_density=300,
                             f32_rerank_max_bytes=300_000,
                             source="test"), path)
    monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", path)
    data = generate_adversarial_dataset(6000, 32, 24, 10, seed=5)
    s = Scann.auto(DenseDataset(data.train), target_recall=0.95,
                   tune_queries=data.test)
    assert s.search_mode == SearchMode.TREE_AH
    assert s.config.partitioning.spilling  # skew -> SOAR
    idx, _ = s.search_batched_arrays(data.test, 10)
    rec = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                   for a, g in zip(idx, data.gt)])
    assert rec >= 0.9
