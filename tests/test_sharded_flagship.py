"""Sharded flagship searchers on the 8-virtual-device CPU mesh: parity with
the single-device searchers at equal knobs."""

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, SearchParameters
from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.parallel.mesh import make_mesh
from scann_tpu.parallel.sharded_flagship import (
    ShardedAsymmetricHasher,
    ShardedTreeXHybridSearcher,
)


def _recall(idx, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                    for a, b in zip(idx, gt)])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(24, 32)).astype(np.float32) * 3.0
    assign = rng.integers(0, 24, size=3000)
    db = (centers[assign] + rng.normal(size=(3000, 32)) * 0.5).astype(np.float32)
    q = (centers[rng.integers(0, 24, size=16)]
         + rng.normal(size=(16, 32)) * 0.5).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    return db, q, ds, gt


def test_sharded_ah_sweep_matches_single_device(data):
    db, q, ds, gt = data
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=5)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=100)
    i1, d1 = h.search_batched_arrays(q, 10, params)
    i2, d2 = sh.search_batched_arrays(q, 10, params)
    # sharded keeps a full local pre_k per shard: recall >= single device
    assert _recall(i2, gt) >= _recall(i1, gt) - 1e-9
    assert _recall(i2, gt) >= 0.9
    # exact distances for returned ids
    de = ((q[:, None, :] - db[np.maximum(i2, 0)]) ** 2).sum(-1)
    m = i2 >= 0
    np.testing.assert_allclose(d2[m], de[m], rtol=1e-3, atol=1e-3)


def test_sharded_tree_ah_matches_single_device(data):
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=5),
    )).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i1, _ = s.search_batched_arrays(q, 10, params)
    i2, d2 = sh.search_batched_arrays(q, 10, params)
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9
    de = ((q[:, None, :] - db[np.maximum(i2, 0)]) ** 2).sum(-1)
    m = i2 >= 0
    np.testing.assert_allclose(d2[m], de[m], rtol=1e-3, atol=1e-3)


def test_sharded_tree_ah_spilling_unique(data):
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=8,
        spilling=True, spilling_threshold=0.6,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=5),
    )).build(ds)
    assert s.partitioner.tokenization.max_multiplicity > 1
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i1, _ = s.search_batched_arrays(q, 10, params)
    i2, _ = sh.search_batched_arrays(q, 10, params)
    for row in i2:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real), row
    # pre_k must be multiplicity-inflated like the single-device searcher,
    # or spilled copies halve the unique candidate depth
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9


def test_sharded_tree_ah_uneven_mesh(data):
    """3 shards: bin packing with a partition count not divisible by it."""
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=5),
    )).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(3, axis_names=("db",)))
    i2, _ = sh.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(i2, gt) >= 0.9


# ---------------------------------------------------------------------------
# non-L2 measures: the sharded wrappers must serve the
# wrapped searcher's configured measure — cosine (normalized queries + L2
# LUTs) and MIPS (-dot LUTs) — not hardcoded squared-L2.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("measure", [DistanceMeasure.COSINE,
                                     DistanceMeasure.DOT_PRODUCT])
def test_sharded_ah_sweep_non_l2(data, measure):
    db, q, ds, gt_l2 = data
    gt, gt_dist = BruteForceSearcher(ds, measure).search_batched_arrays(q, 10)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=5,
        distance_measure=measure)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=100)
    i1, d1 = h.search_batched_arrays(q, 10, params)
    i2, d2 = sh.search_batched_arrays(q, 10, params)
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 1e-9, (measure, r1, r2)
    assert r2 >= 0.9, (measure, r2)
    # returned distances are exact in the measure's own units
    bf_all = BruteForceSearcher(ds, measure).distances_to_all(q)
    m = i2 >= 0
    np.testing.assert_allclose(
        d2[m], np.take_along_axis(bf_all, np.maximum(i2, 0), axis=1)[m],
        rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("measure", [DistanceMeasure.COSINE,
                                     DistanceMeasure.DOT_PRODUCT])
def test_sharded_tree_ah_non_l2(data, measure):
    db, q, ds, gt_l2 = data
    gt, _ = BruteForceSearcher(ds, measure).search_batched_arrays(q, 10)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        distance_measure=measure,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=5))).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i1, _ = s.search_batched_arrays(q, 10, params)
    i2, d2 = sh.search_batched_arrays(q, 10, params)
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 0.02, (measure, r1, r2)
    assert r2 >= 0.85, (measure, r2)
    bf_all = BruteForceSearcher(ds, measure).distances_to_all(q)
    m = i2 >= 0
    np.testing.assert_allclose(
        d2[m], np.take_along_axis(bf_all, np.maximum(i2, 0), axis=1)[m],
        rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# restricts + epsilons on the sharded kernels
# ---------------------------------------------------------------------------


def test_sharded_ah_sweep_allow_mask(data):
    db, q, ds, gt = data
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=5)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    allow = np.zeros(len(db), dtype=bool)
    allow[::2] = True
    i2, d2 = sh.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=100),
        allow_mask=allow)
    assert np.all(i2[i2 >= 0] % 2 == 0)
    # parity with a filtered exact search
    gt_f, _ = BruteForceSearcher(ds).search_batched_arrays(
        q, 10, allow_mask=allow)
    assert _recall(i2, gt_f) >= 0.85


def test_sharded_tree_ah_allow_mask_and_epsilons(data):
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=5))).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    allow = np.zeros(len(db), dtype=bool)
    allow[::2] = True
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i2, d2 = sh.search_batched_arrays(q, 10, params, allow_mask=allow)
    assert np.all(i2[i2 >= 0] % 2 == 0)
    gt_f, _ = BruteForceSearcher(ds).search_batched_arrays(
        q, 10, allow_mask=allow)
    assert _recall(i2, gt_f) >= 0.85

    # post-eps filters exactly the searcher's own > eps results
    base_i, base_d = sh.search_batched_arrays(q, 10, params)
    eps = float(np.median(base_d[:, 4]))
    i3, d3 = sh.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120,
                                post_reordering_epsilon=eps))
    valid = i3 >= 0
    assert np.all(d3[valid] <= eps + 1e-5)
    np.testing.assert_array_equal(valid, base_d <= eps + 1e-6)

    # hostile pre-eps masks everything
    i4, d4 = sh.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120,
                                pre_reordering_epsilon=-1.0))
    assert np.all(i4 == -1) and np.all(np.isinf(d4))


def test_sharded_cosine_pre_epsilon_units(data):
    """Cosine pre-eps just above the true top-k distances must not filter
    (the sharded analog of the advisor r2 units finding)."""
    db, q, ds, _ = data
    gt, gt_dist = BruteForceSearcher(
        ds, DistanceMeasure.COSINE).search_batched_arrays(q, 10)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=256, num_subspaces=16, seed=5,
        distance_measure=DistanceMeasure.COSINE)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    eps = float(gt_dist[:, 9].max()) * 1.3
    i2, d2 = sh.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=100,
                                pre_reordering_epsilon=eps))
    assert np.all(i2 >= 0)
    assert np.all(d2 <= eps + 1e-4)


# ---------------------------------------------------------------------------
# The shard_map bodies serve through the single-device searcher's own leaf
# scorer (the grouped kernel on a GPU, the per-pair gather on the CPU).
# ---------------------------------------------------------------------------


def test_sharded_tree_ah_grouped_kernel_parity(data):
    """The sharded wrapper takes the inner searcher's leaf scorer and slab
    layout, and answers like the single-device searcher."""
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=5))).build(ds)
    mesh = make_mesh(8, axis_names=("db",))
    sh = ShardedTreeXHybridSearcher(s, mesh)
    assert sh._scorer == s._leaf_scorer() == "pairs"
    assert sh._codes.shape[2] == 8           # row-major shard slabs
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i_1, d_1 = s.search_batched_arrays(q, 10, params)
    i_s, d_s = sh.search_batched_arrays(q, 10, params)
    assert _recall(i_s, gt) >= _recall(i_1, gt) - 0.02
    assert _recall(i_s, gt) >= 0.9
    m = (i_1 >= 0) & (i_s >= 0) & (i_1 == i_s)
    np.testing.assert_allclose(d_s[m], d_1[m], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_sharded_tree_ah_low_precision_rerank(data, rdt):
    """The sharded wrapper honors the wrapped searcher's rerank_dtype: the
    [Sh, L_sh, D] rerank slab is stored low-precision (the dominant
    per-shard allocation) and results still match the single-device
    searcher at the same dtype."""
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=8, rerank_dtype=rdt,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=5),
    )).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    assert str(sh._db.dtype) == ("bfloat16" if rdt == "bfloat16" else "uint8")
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i1, d1 = s.search_batched_arrays(q, 10, params)
    i2, d2 = sh.search_batched_arrays(q, 10, params)
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9
    # distances agree with the single-device low-precision rerank values
    # wherever the same id was returned (same rounded rows, same math)
    for b in range(len(q)):
        common = set(i1[b][i1[b] >= 0].tolist()) & set(i2[b][i2[b] >= 0].tolist())
        for cid in common:
            v1 = d1[b][list(i1[b]).index(cid)]
            v2 = d2[b][list(i2[b]).index(cid)]
            np.testing.assert_allclose(v1, v2, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_sharded_ah_sweep_low_precision_rerank(data, rdt):
    """ShardedAsymmetricHasher honors the wrapped hasher's rerank_dtype on
    its per-shard raw-row slab."""
    db, q, ds, gt = data
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=5, rerank_dtype=rdt)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    assert str(sh._db.dtype) == ("bfloat16" if rdt == "bfloat16" else "uint8")
    params = SearchParameters(pre_reordering_num_neighbors=100)
    i1, _ = h.search_batched_arrays(q, 10, params)
    i2, _ = sh.search_batched_arrays(q, 10, params)
    r1, r2 = _recall(i1, gt), _recall(i2, gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9


def test_sharded_ah_k_wider_than_shard_block(data):
    """k larger than the per-shard block: local partials are only blk wide,
    but the merged output must still carry the requested k columns (the
    all_gather supplies n_shards*blk >= n >= k candidates). Regression: the
    merge previously truncated to min(k, blk)."""
    db, q, ds, gt = data
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=5)).build(ds)
    sh = ShardedAsymmetricHasher(h, make_mesh(8, axis_names=("db",)))
    k = 2000
    assert k > sh._blk, "fixture must exercise k > per-shard block"
    idx, dists = sh.search_batched_arrays(q, k)
    assert idx.shape == (len(q), k)
    assert (idx >= 0).all()  # 3000 valid rows cover k=2000 everywhere
    # pre_k clamps to blk = every local row: the pipeline degenerates to
    # an exact search, so distances must match the exact top-k
    exact = np.sort(((q[:, None, :] - db[None, :, :]) ** 2).sum(-1),
                    axis=1)[:, :k]
    np.testing.assert_allclose(dists, exact, rtol=1e-3, atol=1e-3)


def test_sharded_tree_ah_k_beyond_candidate_ceiling(data):
    """k beyond n_shards * per-shard candidate ceiling must pad to the
    [B, k] contract instead of crashing the cross-device merge's top-k."""
    db, q, ds, gt = data
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=2,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=5),
    )).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    k = 2500  # > 8 shards * (p=2 * l_cap) reachable candidates
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the pre_k clamp warning is expected
        idx, dists = sh.search_batched_arrays(q, k)
    assert idx.shape == (len(q), k)
    assert (idx[:, 0] >= 0).all()
    pad = idx < 0
    assert pad.any() and np.all(np.isinf(dists[pad]))


def test_sharded_tree_ah_crowding(data):
    """Crowding composes with the sharded flagship via the base-class
    over-fetch wrapper (reference crowding semantics: crowding.rs:81-104):
    per-group caps hold on the merged multi-chip results and match the
    single-device searcher's crowded output on the same index."""
    from scann_tpu.restricts.crowding import CrowdingConfig, CrowdingConstraint

    db, q, ds, gt = data
    attrs = (np.arange(len(db)) % 7).astype(np.int64)
    c = CrowdingConstraint(attrs, CrowdingConfig(per_crowd_limit=2, enabled=True))
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=5))).build(ds)
    sh = ShardedTreeXHybridSearcher(s, make_mesh(8, axis_names=("db",)))
    params = SearchParameters(pre_reordering_num_neighbors=120)
    res_sh = sh.search_with_crowding(q, 10, c, params)
    res_1d = s.search_with_crowding(q, 10, c, params)
    for r_sh, r_1d in zip(res_sh, res_1d):
        ids = [n.index for n in r_sh.neighbors if n.index >= 0]
        # per-group cap holds on the merged sharded results
        groups, counts = np.unique(attrs[ids], return_counts=True)
        assert counts.max() <= 2
        assert len(ids) == 10
        # parity with the single-device crowded search
        ids_1d = [n.index for n in r_1d.neighbors if n.index >= 0]
        assert len(set(ids) & set(ids_1d)) >= 8


# -- sharded block sweep ------------------------------------------------------

def _block_sweep_pair(ds, **cfg_kw):
    from scann_tpu.models.block_sweep import (
        BlockSweepConfig,
        BlockSweepSearcher,
    )
    from scann_tpu.parallel.sharded_flagship import ShardedBlockSweepSearcher

    cfg = BlockSweepConfig(tile_n=256, block_r=8, pre_reorder_k=48, **cfg_kw)
    single = BlockSweepSearcher(ds, cfg)
    sharded = ShardedBlockSweepSearcher(single,
                                        make_mesh(8, axis_names=("db",)))
    return single, sharded


def test_sharded_block_sweep_matches_single_device(data):
    db, q, ds, gt = data
    single, sharded = _block_sweep_pair(ds)
    i1, d1 = single.search_batched_arrays(q, 10)
    i2, d2 = sharded.search_batched_arrays(q, 10)
    # every shard keeps a full local pre_k, so sharded recall >= single
    assert _recall(i2, gt) >= _recall(i1, gt) - 1e-9
    assert _recall(i2, gt) >= 0.9
    assert i2.max() < ds.size and np.all(np.isfinite(d2))


@pytest.mark.parametrize("measure", [DistanceMeasure.COSINE,
                                     DistanceMeasure.DOT_PRODUCT])
def test_sharded_block_sweep_measures(data, measure):
    db, q, ds, gt = data
    gt_m, _ = BruteForceSearcher(
        ds, distance_measure=measure).search_batched_arrays(q, 10)
    single, sharded = _block_sweep_pair(ds, distance_measure=measure)
    i2, d2 = sharded.search_batched_arrays(q, 10)
    assert _recall(i2, gt_m) >= 0.9
    # distances are exact values in the measure's units
    i1, d1 = single.search_batched_arrays(q, 10)
    assert abs(np.median(d1) - np.median(d2)) < 0.05 * (abs(np.median(d1)) + 1)


def test_sharded_block_sweep_int8_and_rerank_dtype(data):
    db, q, ds, gt = data
    single, sharded = _block_sweep_pair(ds, sweep_dtype="int8",
                                        rerank_dtype="bfloat16")
    i2, d2 = sharded.search_batched_arrays(q, 10)
    assert _recall(i2, gt) >= 0.9


def test_sharded_block_sweep_epsilons(data):
    db, q, ds, gt = data
    single, sharded = _block_sweep_pair(ds)
    base_i, base_d = sharded.search_batched_arrays(q, 10)
    cut = float(np.median(base_d))
    idx, dists = sharded.search_batched_arrays(
        q, 10, params=SearchParameters(post_reordering_epsilon=cut))
    kept = dists[np.isfinite(dists)]
    assert np.all(kept <= cut + 1e-5)
    assert (idx >= 0).sum() < (base_i >= 0).sum()


def test_sharded_block_sweep_top2(data):
    """top2 through the sharded sweep: the tournament kernel runs inside
    each shard body (it is shard-local), so sharded top2 must match the
    single-device top2 path and beat the top1 collision ceiling."""
    db, q, ds, gt = data
    single, sharded = _block_sweep_pair(ds, top2=True)
    i1, d1 = single.search_batched_arrays(q, 10)
    i2, d2 = sharded.search_batched_arrays(q, 10)
    assert _recall(i2, gt) >= _recall(i1, gt) - 1e-9
    assert _recall(i2, gt) >= 0.9
    # exact reranked distances match GT distances for returned ids
    de = ((q[:, None, :] - db[i2.clip(0)]) ** 2).sum(-1)
    m = i2 >= 0
    np.testing.assert_allclose(d2[m], de[m], rtol=1e-4, atol=1e-4)


def test_sharded_block_sweep_top2_narrow_prek(data):
    """With pre_k too small for top1 to cover k block-collisions, top2's
    second survivor per block recovers recall the top1 sweep cannot."""
    db, q, ds, gt = data
    s1, sh1 = _block_sweep_pair(ds)
    s2, sh2 = _block_sweep_pair(ds, top2=True)
    p = SearchParameters(pre_reordering_num_neighbors=12)
    i1, _ = sh1.search_batched_arrays(q, 10, p)
    i2, _ = sh2.search_batched_arrays(q, 10, p)
    assert _recall(i2, gt) >= _recall(i1, gt) - 1e-9


def test_sharded_block_sweep_no_shuffle(data):
    db, q, ds, gt = data
    single, sharded = _block_sweep_pair(ds, shuffle=False)
    i2, _ = sharded.search_batched_arrays(q, 10)
    assert _recall(i2, gt) >= 0.9


def test_sharded_block_sweep_allow_mask(data):
    """Restrict allowlist fused into every shard's sweep: only allowed ids
    surface and results match the single-device fused-mask searcher."""
    db, q, ds, gt = data
    rng = np.random.default_rng(3)
    mask = rng.random(ds.size) < 0.05
    mask[:50] = True
    single, sharded = _block_sweep_pair(ds)
    i1, d1 = single.search_batched_arrays(q, 10, allow_mask=mask)
    i2, d2 = sharded.search_batched_arrays(q, 10, allow_mask=mask)
    v2 = i2 >= 0
    assert v2.any()
    assert np.all(mask[i2[v2]])
    # masked ground truth parity
    allowed = np.where(mask)[0]
    de = ((q[:, None, :] - db[None, allowed, :]) ** 2).sum(-1)
    gt_m = allowed[np.argsort(de, axis=1)[:, :10]]
    r1 = _recall(np.where(i1 >= 0, i1, -1), gt_m)
    r2 = _recall(np.where(i2 >= 0, i2, -1), gt_m)
    # every shard keeps a full local pre_k: sharded recall >= single device
    assert r2 >= r1 - 1e-9
    assert r2 >= 0.9


# -- sharded build ------------------------------------------------------------

def test_sharded_build_end_to_end(data):
    """ShardedTreeXHybridSearcher.build: k-means + assignment + PQ encode
    all run with the database row-sharded. The built
    index must (a) reach the recall a single-device build reaches at equal
    knobs, and (b) serve answers identical to a single-device searcher
    holding the SAME trained artifacts (serving equivalence isolated from
    training-float-order drift)."""
    db, q, ds, gt = data
    cfg = TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12, spilling=False,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42, max_iterations=8))
    mesh = make_mesh(8, axis_names=("db",))
    sharded = ShardedTreeXHybridSearcher.build(ds, cfg, mesh)
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i_sh, d_sh = sharded.search_batched_arrays(q, 10, params)
    assert _recall(i_sh, gt) >= 0.9

    # build-quality parity with the SINGLE-DEVICE build (regression: the
    # sharded build skipped the LBG balance rounds and measured ~2x the
    # assignment inertia / −10pp recall on real hardware — catch that
    # class here, not just a recall floor)
    s_single = TreeXHybridSearcher(cfg).build(ds)
    def _inertia(tp):
        toks = tp.tokenization.tokens
        return float(((db - tp.centers[toks]) ** 2).sum())
    in_sh = _inertia(sharded._inner.partitioner)
    in_1 = _inertia(s_single.partitioner)
    assert in_sh <= in_1 * 1.25, (in_sh, in_1)
    i_1b, _ = s_single.search_batched_arrays(q, 10, params)
    assert _recall(i_sh, gt) >= _recall(i_1b, gt) - 0.03

    # serving equivalence: single-device searcher over the same artifacts
    single = sharded._inner
    i_1, d_1 = single.search_batched_arrays(q, 10, params)
    assert _recall(i_sh, i_1) >= 0.9
    m = i_sh == i_1
    np.testing.assert_allclose(d_sh[m], d_1[m], rtol=1e-4, atol=1e-4)

    # codes really are per-shard encodes of the residuals: spot-check one
    # point's code against the codebook argmin on host
    tk = single.partitioner.tokenization
    pt = int(tk.point_indices[0])
    resid = db[pt] - single.partitioner.centers[tk.tokens[pt]]
    cb = single.codebook
    sub = resid.reshape(cb.num_subspaces, cb.dims_per_subspace)
    want = np.argmin(((sub[:, None, :] - cb.centroids) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(single.codes[0], want.astype(np.uint8))


def test_sharded_build_soar_parity(data):
    """Sharded SOAR build: secondary assignments and
    per-assignment residual codes computed per shard must match the
    single-device SOAR build's quality — inertia parity, recall parity,
    and a spot-check that secondary CSR rows encode the residual against
    THEIR partition's centroid (not the primary's)."""
    db, q, ds, gt = data
    cfg = TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        spilling=True, spilling_mode="soar",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42, max_iterations=8))
    mesh = make_mesh(8, axis_names=("db",))
    sharded = ShardedTreeXHybridSearcher.build(ds, cfg, mesh)
    tkz = sharded._inner.partitioner.tokenization
    assert tkz.max_multiplicity > 1  # every point got a secondary
    params = SearchParameters(pre_reordering_num_neighbors=120)
    i_sh, d_sh = sharded.search_batched_arrays(q, 10, params)
    assert _recall(i_sh, gt) >= 0.9
    for row in i_sh:  # dedup across spilled copies survives the merge
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)

    s_single = TreeXHybridSearcher(cfg).build(ds)
    i_1, _ = s_single.search_batched_arrays(q, 10, params)
    assert _recall(i_sh, gt) >= _recall(i_1, gt) - 0.03

    def _inertia(tp):
        toks = tp.tokenization.tokens
        return float(((db - tp.centers[toks]) ** 2).sum())

    assert _inertia(sharded._inner.partitioner) <= \
        _inertia(s_single.partitioner) * 1.25

    # spot-check a SECONDARY assignment's code: find a CSR row whose
    # partition is not its point's primary token
    single = sharded._inner
    tk = single.partitioner.tokenization
    row_tokens = np.repeat(np.arange(tk.num_partitions), tk.partition_sizes)
    sec_rows = np.nonzero(row_tokens != tk.tokens[tk.point_indices])[0]
    assert len(sec_rows) > 0
    r = int(sec_rows[0])
    pt, t = int(tk.point_indices[r]), int(row_tokens[r])
    resid = db[pt] - single.partitioner.centers[t]
    cb = single.codebook
    sub = resid.reshape(cb.num_subspaces, cb.dims_per_subspace)
    want = np.argmin(((sub[:, None, :] - cb.centroids) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(single.codes[r], want.astype(np.uint8))


def test_sharded_build_distance_spilling(data):
    """Distance-rule spilling through the sharded build: threshold
    secondaries from the per-shard top-2, per-assignment codes, unique
    serving results."""
    db, q, ds, gt = data
    cfg = TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        spilling=True, spilling_mode="distance", spilling_threshold=0.5,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42, max_iterations=8))
    mesh = make_mesh(8, axis_names=("db",))
    sharded = ShardedTreeXHybridSearcher.build(ds, cfg, mesh)
    tkz = sharded._inner.partitioner.tokenization
    assert len(tkz.point_indices) > len(db)  # some points spilled
    i_sh, _ = sharded.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(i_sh, gt) >= 0.9
    for row in i_sh:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_sharded_build_hierarchical(data):
    """num_levels=2 through the sharded build: k-means-tree leaves seed
    the full-data sharded Lloyd refinement; serving works end-to-end."""
    db, q, ds, gt = data
    cfg = TreeXHybridConfig(
        num_partitions=25, partitions_to_search=12,
        partition_num_levels=2,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42, max_iterations=8))
    mesh = make_mesh(8, axis_names=("db",))
    sharded = ShardedTreeXHybridSearcher.build(ds, cfg, mesh)
    assert sharded._inner.partitioner.num_partitions >= 16
    i_sh, _ = sharded.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(i_sh, gt) >= 0.9


def test_sharded_build_avq_encode(data):
    """anisotropic_threshold through the sharded build must use the AVQ
    coordinate-descent encode (advisor r4 medium): per-shard codes match
    the single-device AVQ encode of the same residuals bit-for-bit."""
    db, q, ds, gt = data
    cfg = TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=8, seed=42, max_iterations=8,
            anisotropic_threshold=0.2))
    mesh = make_mesh(8, axis_names=("db",))
    sharded = ShardedTreeXHybridSearcher.build(ds, cfg, mesh)
    single = sharded._inner
    assert single.codebook.eta is not None
    tk = single.partitioner.tokenization
    # re-encode a slice on host through the codebook's own AVQ path with
    # the raw rows as directions — the sharded pass must agree
    pts = tk.point_indices[:64]
    toks = np.repeat(np.arange(tk.num_partitions),
                     tk.partition_sizes)[:64]
    resid = db[pts] - single.partitioner.centers[toks]
    want = single.codebook.encode_dataset(resid, directions=db[pts])
    np.testing.assert_array_equal(single.codes[:64], want)
    i_sh, _ = sharded.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(i_sh, gt) >= 0.9


def test_sharded_build_cosine(data):
    db, q, ds, gt = data
    gt_c, _ = BruteForceSearcher(
        ds, distance_measure=DistanceMeasure.COSINE
    ).search_batched_arrays(q, 10)
    cfg = TreeXHybridConfig(
        num_partitions=24, partitions_to_search=12,
        distance_measure=DistanceMeasure.COSINE,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42, max_iterations=8))
    sharded = ShardedTreeXHybridSearcher.build(
        ds, cfg, make_mesh(8, axis_names=("db",)))
    i_sh, d_sh = sharded.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(i_sh, gt_c) >= 0.9


def test_sharded_build_balance_cap():
    """Skewed data: the sharded build's per-shard top-r + host demote loop
    caps partition sizes (same lever as the single-device LBG cap)."""
    rng = np.random.default_rng(13)
    # one giant cluster + a tail: uncapped, the giant partition dominates
    big = rng.normal(size=(2400, 16)).astype(np.float32) * 0.3
    tail = rng.normal(size=(800, 16)).astype(np.float32) * 4.0 + 8.0
    db = np.concatenate([big, tail])
    ds = DenseDataset(db)
    mesh = make_mesh(8, axis_names=("db",))
    hc = AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=1,
                                max_iterations=5)
    uncapped = ShardedTreeXHybridSearcher.build(
        ds, TreeXHybridConfig(num_partitions=16, partitions_to_search=16,
                              max_partition_size=None, hash_config=hc), mesh)
    capped = ShardedTreeXHybridSearcher.build(
        ds, TreeXHybridConfig(num_partitions=16, partitions_to_search=16,
                              max_partition_size="auto", hash_config=hc),
        mesh)
    mx_un = uncapped._inner.partitioner.tokenization.partition_sizes.max()
    mx_cap = capped._inner.partitioner.tokenization.partition_sizes.max()
    cap = max(int(1.5 * 3200 / 16), 8)  # 300
    assert mx_cap <= mx_un
    assert mx_cap <= cap + 64  # best-effort: bounded slack, no livelock
    # recall survives the cap (compare against the uncapped build with
    # each searching a proportional share of its own partition count —
    # the LBG rounds grow K, so a fixed p covers a smaller fraction)
    q = db[rng.integers(0, len(db), size=16)]
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    i_c, _ = capped.search_batched_arrays(q, 10, SearchParameters(
        pre_reordering_num_neighbors=400,
        num_leaves_to_search=capped._inner.partitioner.num_partitions))
    i_u, _ = uncapped.search_batched_arrays(q, 10, SearchParameters(
        pre_reordering_num_neighbors=400,
        num_leaves_to_search=uncapped._inner.partitioner.num_partitions))
    assert _recall(i_c, gt) >= _recall(i_u, gt) - 0.05
    assert _recall(i_c, gt) >= 0.85


def test_row_chunked_shard_selection_matches_whole():
    """The per-shard build selections (top-r centers, SOAR) run over row
    chunks sized for K; chunking (with a padded tail) must not change any
    row's answer."""
    import jax.numpy as jnp

    from scann_tpu.parallel.sharded_flagship import _map_row_chunks
    from scann_tpu.partitioning.tree_partitioner import (
        select_partitions_kernel,
    )

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(10_000, 6)).astype(np.float32))
    prim = jnp.asarray(rng.integers(0, 9, size=10_000).astype(np.int32))
    c = jnp.asarray(rng.normal(size=(40, 6)).astype(np.float32))
    # k = 10^5 forces 4096-row chunks: three of them, the last padded
    got = _map_row_chunks(
        lambda xx, pp: select_partitions_kernel(
            c, xx, measure=DistanceMeasure.SQUARED_L2, p=3) + (pp * 2,),
        100_000, x, prim)
    want = select_partitions_kernel(c, x, measure=DistanceMeasure.SQUARED_L2,
                                    p=3) + (prim * 2,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
