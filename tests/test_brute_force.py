"""Brute-force searcher: exactness vs numpy ground truth, batching, radius
search, padding invariants (reference test analog: tests/unit_tests.rs
brute_force_tests, tests/stress_tests.rs recall verification)."""

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, DistanceMeasure, ScannError


def brute_force_gt(queries, db, k):
    d = ((queries[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


def test_exact_matches_numpy(rng):
    db = rng.normal(size=(200, 16)).astype(np.float32)
    q = rng.normal(size=(11, 16)).astype(np.float32)
    s = BruteForceSearcher(DenseDataset(db))
    idx, dist = s.search_batched_arrays(q, 5)
    gt_idx, gt_dist = brute_force_gt(q, db, 5)
    np.testing.assert_allclose(dist, gt_dist, rtol=1e-4, atol=1e-4)
    # indices may tie-swap; compare distances at returned indices
    d_at = ((q[:, None, :] - db[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(d_at, gt_dist, rtol=1e-4, atol=1e-4)


def test_sorted_ascending(rng):
    db = rng.normal(size=(100, 8)).astype(np.float32)
    s = BruteForceSearcher(DenseDataset(db))
    _, dist = s.search_batched_arrays(rng.normal(size=(4, 8)).astype(np.float32), 10)
    assert (np.diff(dist, axis=1) >= -1e-6).all()


def test_k_clamped_to_dataset_size(rng):
    db = rng.normal(size=(5, 4)).astype(np.float32)
    s = BruteForceSearcher(DenseDataset(db))
    res = s.search(db[0], k=50)
    assert len(res) == 5
    assert res.neighbors[0].index == 0
    assert res.neighbors[0].distance == pytest.approx(0.0, abs=1e-5)


def test_padding_rows_never_returned(rng):
    # 9 rows -> padded to 16; padded rows are zero vectors, query near zero
    db = rng.normal(size=(9, 4)).astype(np.float32) + 10.0
    s = BruteForceSearcher(DenseDataset(db))
    res = s.search(np.zeros(4, dtype=np.float32), k=9)
    assert all(0 <= n.index < 9 for n in res.neighbors)


def test_single_query_object_api(rng):
    db = rng.normal(size=(64, 8)).astype(np.float32)
    docids = [f"doc{i}" for i in range(64)]
    s = BruteForceSearcher(DenseDataset(db, docids=docids))
    res = s.search(db[7], k=1)
    assert res.neighbors[0].index == 7
    assert res.neighbors[0].docid == "doc7"


def test_dot_product_ranking(rng):
    db = rng.normal(size=(50, 8)).astype(np.float32)
    q = rng.normal(size=(1, 8)).astype(np.float32)
    s = BruteForceSearcher(DenseDataset(db), DistanceMeasure.DOT_PRODUCT)
    idx, dist = s.search_batched_arrays(q, 3)
    want = np.argsort(-(q @ db.T)[0])[:3]
    assert set(idx[0]) == set(want)
    np.testing.assert_allclose(dist[0], np.sort(-(q @ db.T)[0])[:3], rtol=1e-4)


def test_radius_search(rng):
    db = rng.normal(size=(100, 8)).astype(np.float32)
    q = db[3]
    s = BruteForceSearcher(DenseDataset(db))
    d_all = ((q[None] - db) ** 2).sum(-1)
    radius = float(np.sort(d_all)[10])
    res = s.radius_search(q, radius)
    assert set(res.indices()) == set(np.nonzero(d_all <= radius)[0].tolist())
    assert res.distances() == sorted(res.distances())


def test_batched_equals_sequential(rng):
    db = rng.normal(size=(128, 8)).astype(np.float32)
    q = rng.normal(size=(6, 8)).astype(np.float32)
    s = BruteForceSearcher(DenseDataset(db))
    batched = s.search_batched(q, 4)
    for i, r in enumerate(batched):
        single = s.search(q[i], 4)
        assert r.indices() == single.indices()


def test_empty_dataset_rejected():
    s = BruteForceSearcher(DenseDataset.empty(4))
    with pytest.raises(ScannError):
        s.search(np.zeros(4, dtype=np.float32), 1)


def test_dimension_mismatch_rejected(rng):
    s = BruteForceSearcher(DenseDataset(rng.normal(size=(10, 4)).astype(np.float32)))
    with pytest.raises(ScannError):
        s.search(np.zeros(5, dtype=np.float32), 1)


def test_mutation_invalidates_device_cache(rng):
    db = rng.normal(size=(10, 4)).astype(np.float32)
    ds = DenseDataset(db)
    s = BruteForceSearcher(ds)
    far = np.full(4, 100.0, dtype=np.float32)
    assert s.search(far, 1).distances()[0] > 1.0
    ds.append(far)
    res = s.search(far, 1)
    assert res.neighbors[0].index == 10
    assert res.neighbors[0].distance == pytest.approx(0.0, abs=1e-4)
