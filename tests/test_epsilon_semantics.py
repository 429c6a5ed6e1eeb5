"""Epsilon-threshold semantics across ALL searcher kinds.

The reference applies the epsilon threshold to every search through
``FastTopNeighbors`` (reference: src/brute_force/top_k.rs:263-393): any
neighbor whose distance exceeds the threshold is excluded. Here that
surfaces as (index=-1, distance=inf) result slots. These tests assert the
unit-consistency contract: epsilons are expressed in the measure's own
distance units (the units of the returned exact distances), on every
searcher — including the COSINE approximate paths, whose
raw LUT scores are 2x the cosine distance (advisor r2 medium finding).
"""

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, SearchParameters
from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher
from scann_tpu.models.partitioned import PartitionedSearcher
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.ops.distances import DistanceMeasure

K = 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(16, 32)).astype(np.float32) * 3.0
    assign = rng.integers(0, 16, size=2000)
    db = (centers[assign] + rng.normal(size=(2000, 32)) * 0.5).astype(np.float32)
    q = (centers[rng.integers(0, 16, size=8)]
         + rng.normal(size=(8, 32)) * 0.5).astype(np.float32)
    return db, q


def _make_searchers(db):
    from scann_tpu.mutator import DynamicSearcher

    ds = DenseDataset(db)
    hasher = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=42)).build(ds)
    tree = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=16, partitions_to_search=16,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=8, seed=42))).build(ds)
    # a mutable index mid-epoch: pending adds + an update + a remove, so the
    # epsilon path covers the delta-slab merge too
    dyn = DynamicSearcher(ds, lambda d: BruteForceSearcher(d),
                          rebuild_threshold=10_000)
    rng = np.random.default_rng(11)
    for _ in range(5):
        dyn.add(db[rng.integers(0, len(db))] + 0.01)
    dyn.update(3, db[3] + 0.005)
    dyn.remove(7)
    return {
        "brute_force": BruteForceSearcher(ds),
        "scalar_quantized_int8": ScalarQuantizedBruteForceSearcher(
            ds, ScalarQuantizedConfig(storage="int8")),
        "scalar_quantized_bf16": ScalarQuantizedBruteForceSearcher(
            ds, ScalarQuantizedConfig(storage="bf16")),
        "partitioned": PartitionedSearcher(ds, num_partitions_to_search=16),
        "block_sweep": BlockSweepSearcher(ds, BlockSweepConfig(block_r=8,
                                                               tile_n=256)),
        "asymmetric_hasher": hasher,
        "tree_x_hybrid": tree,
        "dynamic": dyn,
    }


SEARCHER_KINDS = [
    "brute_force", "scalar_quantized_int8", "scalar_quantized_bf16",
    "partitioned", "block_sweep", "asymmetric_hasher", "tree_x_hybrid",
    "dynamic",
]


@pytest.fixture(scope="module")
def searchers(data):
    db, _ = data
    return _make_searchers(db)


@pytest.mark.parametrize("kind", SEARCHER_KINDS)
def test_post_epsilon_filters_by_own_distances(searchers, data, kind):
    """With a finite threshold, exactly the results the searcher itself
    scored <= eps survive; the rest become (-1, inf)."""
    _, q = data
    s = searchers[kind]
    params0 = SearchParameters(pre_reordering_num_neighbors=60)
    base_idx, base_dist = s.search_batched_arrays(q, K, params0)
    assert np.all(np.isfinite(base_dist)), kind

    # per-batch scalar threshold: the median of the per-query 5th distances
    eps = float(np.median(base_dist[:, 4]))
    params = SearchParameters(pre_reordering_num_neighbors=60,
                              post_reordering_epsilon=eps)
    idx, dist = s.search_batched_arrays(q, K, params)

    valid = idx >= 0
    assert np.all(dist[valid] <= eps + 1e-5), kind
    assert np.all(np.isinf(dist[~valid])), kind
    # the surviving results are the baseline's own <= eps prefix
    expect_valid = base_dist <= eps + 1e-6
    np.testing.assert_array_equal(valid, expect_valid, err_msg=kind)
    np.testing.assert_array_equal(idx[valid], base_idx[expect_valid],
                                  err_msg=kind)


@pytest.mark.parametrize("kind", SEARCHER_KINDS)
def test_epsilon_extremes(searchers, data, kind):
    """eps=+inf-ish keeps everything; eps below every distance masks all."""
    _, q = data
    s = searchers[kind]
    params0 = SearchParameters(pre_reordering_num_neighbors=60)
    base_idx, base_dist = s.search_batched_arrays(q, K, params0)

    generous = SearchParameters(pre_reordering_num_neighbors=60,
                                pre_reordering_epsilon=1e9,
                                post_reordering_epsilon=1e9)
    idx, dist = s.search_batched_arrays(q, K, generous)
    np.testing.assert_array_equal(idx, base_idx, err_msg=kind)

    hostile = SearchParameters(pre_reordering_num_neighbors=60,
                               post_reordering_epsilon=-1.0)
    idx, dist = s.search_batched_arrays(q, K, hostile)
    assert np.all(idx == -1), kind
    assert np.all(np.isinf(dist)), kind


# ---------------------------------------------------------------------------
# COSINE unit consistency (advisor r2 medium finding): approximate scores are
# squared-L2 on unit vectors = 2x the cosine distance; epsilons and returned
# values must be in cosine-distance units.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cosine_setup(data):
    db, q = data
    ds = DenseDataset(db)
    gt_searcher = BruteForceSearcher(ds, DistanceMeasure.COSINE)
    gt_idx, gt_dist = gt_searcher.search_batched_arrays(q, K)
    return db, q, gt_idx, gt_dist


def test_cosine_hasher_pre_epsilon_units(cosine_setup):
    """A pre-eps comfortably above every true top-k cosine distance must not
    filter the true neighbors (before the fix, approx scores were 2x the
    cosine distance, so this exact configuration returned nothing)."""
    db, q, gt_idx, gt_dist = cosine_setup
    # fine quantization so approximate ~= exact
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=256, num_subspaces=16, seed=42,
        distance_measure=DistanceMeasure.COSINE)).build(DenseDataset(db))

    kth = float(gt_dist[:, K - 1].max())
    # window that discriminates: above every true distance, but below 2x
    # the smallest one would be if doubled
    eps = kth * 1.3
    params = SearchParameters(pre_reordering_num_neighbors=60,
                              pre_reordering_epsilon=eps)
    idx, dist = h.search_batched_arrays(q, K, params)
    # every true neighbor is within eps, so nothing should be filtered
    assert np.all(idx >= 0)
    assert np.all(dist <= eps + 1e-4)


def test_cosine_hasher_nonreorder_returns_cosine_units(cosine_setup):
    """The approximate-only path's returned distances must be in cosine
    units (1 - sim), matching the re-ranked path's scale."""
    db, q, gt_idx, gt_dist = cosine_setup
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=256, num_subspaces=16, seed=42,
        distance_measure=DistanceMeasure.COSINE)).build(DenseDataset(db))
    idx, dist = h.search_batched_arrays(q, K)  # approximate-only path
    # exact cosine distances of the returned points
    qs = q / np.linalg.norm(q, axis=1, keepdims=True)
    ds_n = db / np.linalg.norm(db, axis=1, keepdims=True)
    exact = 1.0 - np.einsum("bd,bkd->bk", qs, ds_n[np.maximum(idx, 0)])
    # fine PQ: approximate cosine distance within a loose absolute band of
    # the exact value (pre-fix values were ~2x, far outside this band)
    assert np.abs(dist - exact).mean() < 0.05
    assert np.abs(dist - exact).max() < 0.25


def test_cosine_tree_ah_pre_epsilon_units(cosine_setup):
    db, q, gt_idx, gt_dist = cosine_setup
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=16, partitions_to_search=16,
        distance_measure=DistanceMeasure.COSINE,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=16, seed=42))).build(DenseDataset(db))
    kth = float(gt_dist[:, K - 1].max())
    eps = kth * 1.3
    params = SearchParameters(pre_reordering_num_neighbors=60,
                              pre_reordering_epsilon=eps)
    idx, dist = s.search_batched_arrays(q, K, params)
    # recall stays high: the generous (in cosine units) pre-eps filters none
    # of the true neighbors
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(idx, gt_idx)])
    assert recall >= 0.9
    assert np.all(dist[idx >= 0] <= eps + 1e-4)


def test_hasher_approx_only_path_honors_post_epsilon():
    """The approximate-only hasher path (no pre_k) is a single-stage
    search: min(pre_eps, post_eps) applies, like every exact searcher
    (SearchParameters.effective_epsilon; reference FastTopNeighbors
    applies its epsilon to every pushed neighbor, top_k.rs:263-279)."""
    from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig

    rng = np.random.default_rng(4)
    db = rng.normal(size=(1500, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=4, seed=0)).build(DenseDataset(db))
    base_i, base_d = h.search_batched_arrays(q, 10)  # approx-only path
    cutoff = float(np.median(base_d[np.isfinite(base_d)]))
    idx, dist = h.search_batched_arrays(
        q, 10, SearchParameters(post_reordering_epsilon=cutoff))
    m = idx >= 0
    assert (dist[m] <= cutoff + 1e-5).all()
    want_masked = np.isfinite(base_d) & (base_d > cutoff + 1e-5)
    assert (idx[want_masked] == -1).all()
    assert np.isinf(dist[want_masked]).all()


def test_partitioned_k_beyond_candidate_ceiling_pads():
    """p * leaf_cap can cap reachable candidates below k: the searcher
    must keep the [B, k] contract by padding, and the base-class filtered
    fallback must tolerate the narrower real width (regression: it
    previously indexed out of bounds)."""
    rng = np.random.default_rng(5)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    s = PartitionedSearcher(DenseDataset(db), num_partitions_to_search=2)
    k = 400
    idx, dists = s.search_batched_arrays(q, k)
    assert idx.shape == (4, k)
    assert (idx[:, 0] >= 0).all()
    pad = idx < 0
    assert np.all(np.isinf(dists[pad]))
    # filtered fallback over the capped searcher must not crash
    from scann_tpu.restricts.filters import PredicateFilter

    res = s.search_batched_with_filter(
        q, 300, PredicateFilter(lambda i: i % 2 == 1))
    for r in res:
        for nn in r.neighbors:
            assert nn.index % 2 == 1
