"""Unified Scann facade + builder + harness (reference test analog:
tests/unit_tests.rs scann_tests, ann_benchmark.rs:481-492)."""

import numpy as np
import pytest

from scann_tpu import DenseDataset, ScannConfig, ScannError
from scann_tpu.config import HashConfig, PartitioningConfig
from scann_tpu.harness.ann_benchmark import (
    average_recall_at_k,
    generate_synthetic_dataset,
    load_json_dataset,
    make_parser,
    run_benchmark,
)
from scann_tpu.models.scann import Scann, ScannBuilder, SearchMode


@pytest.fixture(scope="module")
def small_db():
    rng = np.random.default_rng(42)
    return rng.normal(size=(600, 16)).astype(np.float32)


def test_default_is_brute_force(small_db):
    s = Scann(DenseDataset(small_db))
    assert s.search_mode == SearchMode.BRUTE_FORCE
    res = s.search(small_db[5], 3)
    assert res.neighbors[0].index == 5


def test_mode_selection(small_db):
    ds = DenseDataset(small_db)
    assert Scann(ds, ScannConfig().with_partitioning(
        PartitioningConfig(num_partitions=8))).search_mode == SearchMode.PARTITIONED
    assert Scann(ds, ScannConfig().with_hashing(
        HashConfig(num_blocks=4, num_buckets=16))).search_mode == SearchMode.HASHED
    cfg = (ScannConfig()
           .with_partitioning(PartitioningConfig(num_partitions=8))
           .with_hashing(HashConfig(num_blocks=4, num_buckets=16)))
    assert Scann(ds, cfg).search_mode == SearchMode.TREE_AH


def test_builder(small_db):
    s = (ScannBuilder()
         .num_neighbors(5)
         .tree(num_partitions=8, partitions_to_search=4)
         .hash(num_blocks=4, num_buckets=16)
         .reorder(50)
         .build(DenseDataset(small_db)))
    assert s.search_mode == SearchMode.TREE_AH
    idx, dist = s.search_batched_arrays(small_db[:4])
    assert idx.shape == (4, 5)
    assert (idx[:, 0] == np.arange(4)).all()


def test_scalar_quantized_mode(small_db):
    from scann_tpu.config import BruteForceConfig
    s = Scann(DenseDataset(small_db),
              ScannConfig().with_brute_force(BruteForceConfig().with_scalar_quantization(8)))
    res = s.search(small_db[10], 1)
    assert res.neighbors[0].index == 10


def test_empty_dataset_rejected():
    with pytest.raises(ScannError):
        Scann(DenseDataset.empty(8))


# -------------------------------------------------------------- harness


def test_recall_math():
    got = np.array([[0, 1, 2], [3, 4, 5]])
    gt = np.array([[0, 1, 9], [3, 4, 5]])
    assert average_recall_at_k(got, gt) == pytest.approx((2 / 3 + 1.0) / 2)


def test_harness_brute_force_end_to_end():
    args = make_parser().parse_args(
        ["--algorithm", "brute-force", "--synthetic-train", "500",
         "--synthetic-test", "20", "--dim", "8", "--batch-size", "20"])
    data = generate_synthetic_dataset(500, 20, 8, 10, 42)
    report = run_benchmark("brute-force", data, args)
    assert report.recall_at_k == pytest.approx(1.0)
    assert report.qps > 0
    assert report.train_size == 500


def test_harness_pipelined_serving_matches_serial():
    """--pipeline N overlaps in-flight batches on worker threads; results
    (and therefore recall) must be identical to the serial loop."""
    args = make_parser().parse_args(
        ["--algorithm", "brute-force", "--batch-size", "8", "--pipeline", "4"])
    data = generate_synthetic_dataset(500, 40, 8, 10, 42)
    report = run_benchmark("brute-force", data, args)
    assert report.recall_at_k == pytest.approx(1.0)
    assert report.timing_mode == "wall_clock_pipelined_x4"


def test_harness_tree_ah_end_to_end():
    args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "10",
         "--partitions-to-search", "10", "--num-blocks", "4",
         "--reorder", "50", "--batch-size", "20"])
    data = generate_synthetic_dataset(400, 20, 16, 10, 42)
    report = run_benchmark("tree-ah", data, args)
    assert report.recall_at_k >= 0.9  # all partitions searched + reorder
    assert report.index_device_bytes is not None


def test_harness_block_sweep_end_to_end():
    # pre_k covers every 32-point block, so the only recall loss is
    # same-block collisions (one candidate per block survives the sweep)
    args = make_parser().parse_args(
        ["--algorithm", "block-sweep", "--reorder", "100",
         "--batch-size", "20"])
    data = generate_synthetic_dataset(3000, 20, 16, 10, 42)
    report = run_benchmark("block-sweep", data, args)
    assert report.recall_at_k >= 0.9
    assert report.qps > 0


def test_harness_save_load_index_round_trip(tmp_path):
    """--save-index persists the trained index; --load-index serves from it
    without retraining, at identical recall, stamping provenance in both
    reports (build-once / serve-many — the reference binary retrains every
    run, ann_benchmark.rs:329-355)."""
    path = str(tmp_path / "idx.npz")
    data = generate_synthetic_dataset(800, 24, 16, 10, 3, clustered=True)
    build_args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "8",
         "--partitions-to-search", "8", "--num-blocks", "4",
         "--reorder", "40", "--batch-size", "24", "--save-index", path])
    built = run_benchmark("tree-ah", data, build_args)
    assert built.index_saved_to == path
    assert built.index_save_seconds is not None
    assert built.index_loaded_from is None

    serve_args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--batch-size", "24",
         "--load-index", path])
    served = run_benchmark("tree-ah", data, serve_args)
    assert served.index_loaded_from == path
    assert served.algorithm == "tree-ah"
    assert served.recall_at_k == pytest.approx(built.recall_at_k)
    # load is a deserialization, not a training run (generous bound: a tiny
    # build can race a cold-filesystem load, so don't compare raw wall-clocks)
    assert served.build_seconds < max(1.0, built.build_seconds)


def test_harness_load_index_rejects_mismatched_dataset(tmp_path):
    """--load-index against a dataset the index never indexed must fail loudly
    instead of silently scoring recall against foreign ground truth."""
    path = str(tmp_path / "idx.npz")
    data = generate_synthetic_dataset(500, 24, 8, 10, 3, clustered=True)
    build_args = make_parser().parse_args(
        ["--algorithm", "brute-force", "--batch-size", "8",
         "--save-index", path])
    run_benchmark("brute-force", data, build_args)

    serve_args = make_parser().parse_args(
        ["--algorithm", "brute-force", "--batch-size", "8",
         "--load-index", path])
    other_n = generate_synthetic_dataset(600, 24, 8, 10, 3, clustered=True)
    with pytest.raises(ValueError, match="does not match"):
        run_benchmark("brute-force", other_n, serve_args)
    other_d = generate_synthetic_dataset(500, 24, 16, 10, 3, clustered=True)
    with pytest.raises(ValueError, match="does not match"):
        run_benchmark("brute-force", other_d, serve_args)


def test_harness_autotune_target():
    """--autotune-target picks SearchParameters meeting the recall target on
    a sample, serves with them, and stamps the provenance in the report."""
    args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "16",
         "--partitions-to-search", "2", "--num-blocks", "4",
         "--reorder", "20", "--batch-size", "32",
         "--autotune-target", "0.95", "--autotune-leaves", "4,8,16",
         "--autotune-prek", "30,60"])
    data = generate_synthetic_dataset(2000, 32, 16, 10, 7, clustered=True)
    report = run_benchmark("tree-ah", data, args)
    assert report.autotune_target == pytest.approx(0.95)
    assert report.autotune_target_met
    assert report.autotune_sample_recall >= 0.95
    assert report.autotuned_num_leaves_to_search in (4, 8, 16)
    assert report.autotuned_pre_reordering_num_neighbors in (30, 60)
    # the whole run is served with the tuned params: full-set recall holds
    assert report.recall_at_k >= 0.9

    # untuned baseline at the deliberately-starved defaults scores lower
    base_args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "16",
         "--partitions-to-search", "2", "--num-blocks", "4",
         "--reorder", "20", "--batch-size", "32"])
    base = run_benchmark("tree-ah", data, base_args)
    assert base.autotune_target is None
    assert base.recall_at_k < report.recall_at_k


def test_block_sweep_facade_mode(small_db):
    cfg = ScannConfig(num_neighbors=5).with_brute_force()
    cfg.brute_force.with_block_sweep(pre_k=64)
    s = Scann(DenseDataset(small_db), cfg)
    from scann_tpu.models.block_sweep import BlockSweepSearcher

    assert isinstance(s.impl, BlockSweepSearcher)
    idx, dist = s.search_batched_arrays(small_db[:4], 5)
    assert idx.shape == (4, 5)
    # each query's own row must be its nearest neighbor
    assert all(idx[i, 0] == i for i in range(4))


def test_harness_json_round_trip(tmp_path):
    import json
    data = generate_synthetic_dataset(100, 5, 4, 3, 1)
    p = tmp_path / "ds.json"
    p.write_text(json.dumps({
        "train": data.train.tolist(),
        "test": data.test.tolist(),
        "neighbors": data.gt.tolist(),
    }))
    loaded = load_json_dataset(str(p), 3)
    np.testing.assert_allclose(loaded.train, data.train)
    np.testing.assert_array_equal(loaded.gt, data.gt)
    with pytest.raises(ValueError):
        load_json_dataset(str(p), 10)  # k larger than provided neighbors


def test_harness_hdf5_round_trip(tmp_path):
    import h5py
    from scann_tpu.harness.ann_benchmark import load_hdf5_dataset

    data = generate_synthetic_dataset(80, 5, 4, 3, 1)
    p = str(tmp_path / "ds.hdf5")
    with h5py.File(p, "w") as f:
        f.create_dataset("train", data=data.train)
        f.create_dataset("test", data=data.test)
        f.create_dataset("neighbors", data=data.gt)
    loaded = load_hdf5_dataset(p, 3)
    np.testing.assert_allclose(loaded.train, data.train)
    np.testing.assert_array_equal(loaded.gt, data.gt)
    loaded2 = load_hdf5_dataset(p, 3, limit_train=50, limit_test=2)
    assert loaded2.train.shape[0] == 50 and loaded2.test.shape[0] == 2


def test_adversarial_generator_is_skewed():
    """The GloVe-shaped generator must actually produce heavy-tailed
    structure: varying point norms and correlated dims."""
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset

    data = generate_adversarial_dataset(4000, 20, 16, 10, seed=3)
    norms = np.linalg.norm(data.train, axis=1)
    # heavy-tailed norms: top decile well above median
    assert np.percentile(norms, 90) / np.median(norms) > 1.3
    # correlated dims: off-diagonal correlation mass is non-trivial
    c = np.corrcoef(data.train.T)
    off = np.abs(c[~np.eye(16, dtype=bool)])
    assert off.mean() > 0.05
    # ground truth is exact and ids are in range
    assert data.gt.shape == (20, 10)
    assert data.gt.min() >= 0 and data.gt.max() < 4000


def test_harness_tree_ah_adversarial_end_to_end():
    """Tree-AH must still reach high recall on skewed (power-law,
    anisotropic) data with enough leaves searched + reorder."""
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset

    args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "16",
         "--partitions-to-search", "8", "--num-blocks", "4",
         "--reorder", "80", "--batch-size", "20"])
    data = generate_adversarial_dataset(2000, 20, 16, 10, seed=7)
    report = run_benchmark("tree-ah", data, args)
    assert report.recall_at_k >= 0.85, report.recall_at_k
    assert report.dispatch_bound_fraction is not None
    assert report.timing_mode == "wall_clock_per_batch_dispatch"


def test_auto_mode_small_picks_block_sweep(small_db):
    """auto() at small N = bf16 block-min sweep + exact re-rank, and exact
    results (recall 1.0 at trivial scale)."""
    from scann_tpu.models.block_sweep import BlockSweepSearcher

    s = Scann.auto(DenseDataset(small_db))
    assert s.search_mode == SearchMode.BRUTE_FORCE
    assert isinstance(s.impl, BlockSweepSearcher)
    idx, _ = s.search_batched_arrays(small_db[:8], 5)
    assert all(int(idx[i, 0]) == i for i in range(8))


def test_auto_config_large_picks_tree_ah():
    """The decision function (testable without building a 10M index):
    past the measured sweep/tree crossover it configures LUT16 tree-AH
    with ~600-point partitions and exact re-ranking."""
    from scann_tpu.models.scann import AUTO_SWEEP_MAX_N, auto_config

    cfg = auto_config(10_000_000, 100)
    assert cfg.partitioning is not None and cfg.hash is not None
    assert cfg.hash.num_buckets == 16          # LUT16
    assert cfg.hash.num_blocks == 50
    assert cfg.exact_reordering is not None
    parts = cfg.partitioning.num_partitions
    assert 10_000_000 / 1000 <= parts <= 10_000_000 / 400
    assert parts % 256 == 0                    # stable compiled shapes
    # below the crossover: one sweep copy, no tree
    small = auto_config(AUTO_SWEEP_MAX_N, 100)
    assert small.brute_force is not None and small.brute_force.block_sweep
    assert small.partitioning is None


def test_auto_builder_threads_k(small_db):
    s = ScannBuilder().num_neighbors(7).auto().build(DenseDataset(small_db))
    idx, _ = s.search_batched_arrays(small_db[:3])
    assert idx.shape == (3, 7)


def test_query_config_honored():
    """QueryConfig (config.rs:322-336) is declared-but-unused in the
    reference; here it maps onto SearchParameters through the facade."""
    import numpy as np

    from scann_tpu import DenseDataset
    from scann_tpu.config import (
        HashConfig,
        PartitioningConfig,
        QueryConfig,
        ScannConfig,
    )
    from scann_tpu.models.scann import Scann

    rng = np.random.default_rng(9)
    centers = rng.normal(size=(16, 24)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 16, 2000)]
          + rng.normal(size=(2000, 24)).astype(np.float32))
    q = (centers[rng.integers(0, 16, 8)]
         + rng.normal(size=(8, 24)).astype(np.float32))
    s = Scann(DenseDataset(db), ScannConfig(
        num_neighbors=5,
        partitioning=PartitioningConfig(num_partitions=16,
                                        num_partitions_to_search=2),
        hash=HashConfig(num_blocks=6, num_buckets=16)))
    # num_neighbors override: returns 3 columns, not the config's 5
    i3, _ = s.search_batched_arrays(q, query_config=QueryConfig(
        num_neighbors=3))
    assert i3.shape == (8, 3)
    # widening the searched partitions via QueryConfig must not lose
    # recall vs the narrow default
    i_narrow, _ = s.search_batched_arrays(q, 5)
    i_wide, _ = s.search_batched_arrays(q, 5, query_config=QueryConfig(
        num_partitions_to_search=16, reordering_num_candidates=100))
    from scann_tpu import BruteForceSearcher

    gt, _ = BruteForceSearcher(DenseDataset(db)).search_batched_arrays(q, 5)
    r_n = np.mean([len(set(a) & set(g)) / 5 for a, g in zip(i_narrow, gt)])
    r_w = np.mean([len(set(a) & set(g)) / 5 for a, g in zip(i_wide, gt)])
    assert r_w >= r_n - 1e-9
    assert r_w >= 0.9
    # explicit params win over query_config
    from scann_tpu import SearchParameters

    i_p, _ = s.search_batched_arrays(
        q, 4, params=SearchParameters(num_leaves_to_search=16,
                                      pre_reordering_num_neighbors=100),
        query_config=QueryConfig(num_neighbors=2))
    assert i_p.shape == (8, 4)


def test_auto_config_selects_bf16_rerank_at_scale():
    from scann_tpu.models.scann import auto_config

    small = auto_config(8_000_000, 100)
    big = auto_config(20_000_000, 100)
    assert small.exact_reordering.rerank_dtype == "float32"
    assert big.exact_reordering.rerank_dtype == "bfloat16"


def test_auto_config_prime_dims_get_per_dim_subspaces():
    """Prime dims must not fall back to ONE whole-vector 16-code subspace
    (an information-free index); they get dim subspaces of 1 dim each."""
    from scann_tpu.models.scann import auto_config

    assert auto_config(10_000_000, 101).hash.num_blocks == 101
    assert auto_config(10_000_000, 100).hash.num_blocks == 50


def test_query_config_keeps_configured_reordering(small_db):
    """A per-query override that leaves the reordering depth unset must
    not disable HASHED mode's configured exact reordering (the default
    pre_k previously only applied when params was None entirely)."""
    from scann_tpu.config import ExactReorderingConfig, QueryConfig

    q = small_db[:6]
    s = Scann(DenseDataset(small_db), ScannConfig(
        hash=HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=ExactReorderingConfig(num_candidates=100)))
    i_plain, d_plain = s.search_batched_arrays(q, 5)
    i_qc, d_qc = s.search_batched_arrays(
        q, 5, query_config=QueryConfig(num_neighbors=5))
    np.testing.assert_array_equal(i_plain, i_qc)
    np.testing.assert_allclose(d_plain, d_qc, rtol=1e-6)
    # reordered distances are exact: re-derive them from the raw rows
    exact = ((q[:, None, :] - small_db[i_qc]) ** 2).sum(-1)
    np.testing.assert_allclose(d_qc, exact, rtol=1e-4, atol=1e-4)


def test_query_config_epsilon_filters_final_distances(small_db):
    """QueryConfig.epsilon means the same thing in every mode: results
    whose FINAL (reported) distance exceeds it are dropped."""
    from scann_tpu.config import ExactReorderingConfig, QueryConfig

    q = small_db[:4]
    s = Scann(DenseDataset(small_db), ScannConfig(
        hash=HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=ExactReorderingConfig(num_candidates=100)))
    _, d_all = s.search_batched_arrays(q, 5)
    eps = float(np.sort(d_all, axis=1)[:, 2].max())  # keeps ~3 of 5
    idx, dists = s.search_batched_arrays(
        q, 5, query_config=QueryConfig(epsilon=eps))
    kept = idx >= 0
    assert kept.any() and (~kept).any()
    assert np.all(dists[kept] <= eps + 1e-6)
    np.testing.assert_array_equal(idx[~kept], -1)


def test_hashed_mode_threads_rerank_dtype(small_db):
    """ExactReorderingConfig.quantized / rerank_dtype reach the standalone
    AsymmetricHasher (previously silently dropped in HASHED mode)."""
    from scann_tpu.config import ExactReorderingConfig

    s = Scann(DenseDataset(small_db), ScannConfig(
        hash=HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=ExactReorderingConfig(num_candidates=60,
                                               quantized=True)))
    assert s.search_mode == SearchMode.HASHED
    assert s.impl.config.rerank_dtype == "int8"
    q = small_db[:4]
    idx, dists = s.search_batched_arrays(q, 3)
    assert idx.shape == (4, 3)
    assert (idx >= 0).all()


def test_block_sweep_honors_reordering_depth(small_db):
    """ExactReorderingConfig.num_candidates sets the block sweep's rerank
    depth, same precedence as the HASHED branch."""
    from scann_tpu.config import ExactReorderingConfig

    cfg = ScannConfig(exact_reordering=ExactReorderingConfig(
        num_candidates=77))
    cfg.with_brute_force()
    cfg.brute_force.block_sweep = True
    s = Scann(DenseDataset(small_db), cfg)
    assert s.impl._config.pre_reorder_k == 77


def test_limit_train_recomputes_ground_truth(tmp_path):
    """--limit-train truncates the indexable rows, so the file's neighbor
    ids (computed over the FULL train set) are invalid: the loader must
    recompute exact GT over the truncated set (regression: stale GT
    silently corrupted every reported recall)."""
    import json

    from scann_tpu.harness.ann_benchmark import load_json_dataset

    data = generate_synthetic_dataset(200, 6, 4, 3, 1)
    p = tmp_path / "ds.json"
    p.write_text(json.dumps({
        "train": data.train.tolist(),
        "test": data.test.tolist(),
        "neighbors": data.gt.tolist(),
    }))
    loaded = load_json_dataset(str(p), 3, limit_train=50)
    assert len(loaded.train) == 50
    assert loaded.gt.max() < 50  # ids index the truncated set
    # and the GT is the true exact answer over those 50 rows
    exact = np.argsort(((data.test[:, None, :] - data.train[None, :50, :])
                        ** 2).sum(-1), axis=1)[:, :3]
    # distance-level check (robust to ties)
    d_loaded = np.take_along_axis(
        ((data.test[:, None, :] - data.train[None, :50, :]) ** 2).sum(-1),
        loaded.gt.astype(np.int64), axis=1)
    d_exact = np.take_along_axis(
        ((data.test[:, None, :] - data.train[None, :50, :]) ** 2).sum(-1),
        exact, axis=1)
    np.testing.assert_allclose(np.sort(d_loaded, axis=1),
                               np.sort(d_exact, axis=1), rtol=1e-5)


def test_harness_shards_serving():
    """--shards N serves through the database-sharded wrappers on the
    (virtual 8-device) mesh, at recall >= single-device equal knobs."""
    data = generate_synthetic_dataset(2000, 32, 16, 10, 7, clustered=True)
    for algo, extra in (
        ("tree-ah", ["--num-partitions", "16", "--partitions-to-search", "16",
                     "--num-blocks", "4", "--reorder", "100"]),
        ("block-sweep", ["--reorder", "60"]),
        ("brute-force", []),
    ):
        args = make_parser().parse_args(
            ["--algorithm", algo, "--batch-size", "32", "--shards", "8",
             *extra])
        report = run_benchmark(algo, data, args)
        assert report.shards == 8
        assert report.recall_at_k >= (0.999 if algo == "brute-force"
                                      else 0.9), (algo, report.recall_at_k)


def test_harness_shards_with_save_and_autotune(tmp_path):
    """--shards composes with --save-index (saves the single-device index
    BEFORE sharding) and --autotune-target (the tuner sees the inner
    searcher's partition structure through the sharded wrapper)."""
    path = str(tmp_path / "sh.npz")
    data = generate_synthetic_dataset(2000, 32, 16, 10, 7, clustered=True)
    args = make_parser().parse_args(
        ["--algorithm", "tree-ah", "--num-partitions", "16",
         "--partitions-to-search", "4", "--num-blocks", "4",
         "--reorder", "40", "--batch-size", "32", "--shards", "8",
         "--save-index", path,
         "--autotune-target", "0.95", "--autotune-leaves", "4,8,16",
         "--autotune-prek", "40,100"])
    report = run_benchmark("tree-ah", data, args)
    assert report.shards == 8
    assert report.index_saved_to == path
    # the leaves grid WAS swept (regression: sharded wrappers hid the
    # partitioner and p silently stayed at the config default)
    assert report.autotuned_num_leaves_to_search is not None
    assert report.recall_at_k >= 0.9

    # the saved npz holds the single-device index and reloads fine
    from scann_tpu.io import load_index

    loaded = load_index(path)
    assert loaded.dataset_size() == 2000


def test_auto_mesh_aware_sharded_build(tmp_path, monkeypatch):
    """Mesh-aware Scann.auto(): with a mesh and a
    dataset past the (profile-scaled) one-chip serving budget, auto()
    must route to the sharded end-to-end build, return the sharded
    wrapper, stamp the decision, and still meet the recall target."""
    import json

    from scann_tpu.models.scann import Scann
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

    # a profile whose budget this little dataset exceeds (the real default
    # is GBs; the decision logic is budget-relative either way)
    prof = {"sweep_max_n": 2000, "f32_rerank_max_bytes": 100_000,
            "partition_density": 600, "source": "test"}
    prof_path = tmp_path / "prof.json"
    prof_path.write_text(json.dumps(prof))
    monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", str(prof_path))

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(32, 16)).astype(np.float32) * 3.0
    assign = rng.integers(0, 32, size=5000)
    db = (centers[assign] + rng.normal(size=(5000, 16)) * 0.5).astype(np.float32)
    q = (centers[rng.integers(0, 32, size=30)]
         + rng.normal(size=(30, 16)) * 0.5).astype(np.float32)
    ds = DenseDataset(db)
    gt = np.argsort(((q[:, None, :] - db[None]) ** 2).sum(-1),
                    axis=1)[:, :10]

    mesh = make_mesh(8, axis_names=("db",))
    s = Scann.auto(ds, target_recall=0.9, mesh=mesh, seed=0)
    assert isinstance(s.impl, ShardedTreeXHybridSearcher)
    desc = s.describe()
    assert desc["auto"]["sharded"] is True
    assert desc["auto"]["shards_needed"] > 1
    idx, _ = s.search_batched_arrays(q, 10)
    rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10.0
                   for a, b in zip(idx, gt)])
    assert rec >= 0.9, rec

    # under-budget with a mesh: single-chip build kept, decision stamped
    prof["f32_rerank_max_bytes"] = 10**12
    prof_path.write_text(json.dumps(prof))
    s2 = Scann.auto(ds, mesh=mesh, seed=0)
    assert not isinstance(s2.impl, ShardedTreeXHybridSearcher)
    assert s2.describe()["auto"]["sharded"] is False
