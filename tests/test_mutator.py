"""Mutator: native C++ core, mutation buffer, concurrent hammering,
DynamicSearcher correctness (reference test analog: src/mutator/mod.rs
tests :572-598 concurrent add/read, :649-748 mixed workloads)."""

import threading

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, ScannError
from scann_tpu.mutator import (
    DynamicSearcher,
    IncrementalUpdater,
    MutableDataset,
    Mutation,
    MutationBuffer,
    MutationKind,
)
from scann_tpu.native import load_native


def test_native_library_builds():
    """The C++ host runtime must compile and load in this image."""
    assert load_native() is not None


@pytest.mark.parametrize("use_native", [True, False])
def test_mutable_dataset_basic(use_native):
    m = MutableDataset(4, use_native=use_native)
    assert m.native == (use_native and load_native() is not None)
    i0 = m.add([1, 2, 3, 4])
    i1 = m.add([5, 6, 7, 8])
    assert (i0, i1) == (0, 1)
    assert m.size == 2
    np.testing.assert_array_equal(m.get(0), [1, 2, 3, 4])
    m.update(0, [9, 9, 9, 9])
    np.testing.assert_array_equal(m.get(0), [9, 9, 9, 9])
    m.remove(1)
    assert m.get(1) is None
    assert not m.exists(1) and m.exists(0)
    assert m.size == 1
    with pytest.raises(ScannError):
        m.remove(1)  # double remove
    with pytest.raises(ScannError):
        m.update(5, [0, 0, 0, 0])  # missing
    with pytest.raises(ScannError):
        m.add([1.0])  # wrong dim


@pytest.mark.parametrize("use_native", [True, False])
def test_snapshot_and_compact(use_native):
    m = MutableDataset(2, use_native=use_native)
    for i in range(10):
        m.add([i, i])
    for i in range(0, 10, 2):
        m.remove(i)
    data, deleted = m.snapshot()
    assert len(data) == 10 and deleted.sum() == 5
    rows = m.compact()
    assert rows == 5 and m.size == 5
    data2, deleted2 = m.snapshot()
    np.testing.assert_array_equal(data2[:, 0], [1, 3, 5, 7, 9])
    assert deleted2.sum() == 0


def test_growth_past_initial_capacity():
    m = MutableDataset(3)
    for i in range(500):  # native initial capacity is 64
        m.add([i, i, i])
    assert m.size == 500
    np.testing.assert_array_equal(m.get(499), [499, 499, 499])


def test_mutation_buffer():
    b = MutationBuffer(4, dim=2)
    assert b.add(0, [1.0, 2.0])
    assert b.remove(0)
    assert b.update(1, [3.0, 4.0])
    assert len(b) == 3
    assert not b.should_flush()
    assert b.add(2, [0.0, 0.0])
    assert b.should_flush()
    assert not b.add(3, [0.0, 0.0])  # full
    out = b.flush(2)
    assert [m.kind for m in out] == [MutationKind.ADD, MutationKind.REMOVE,
                                     MutationKind.UPDATE, MutationKind.ADD]
    np.testing.assert_array_equal(out[0].data, [1.0, 2.0])
    assert out[1].data is None
    assert [m.timestamp for m in out] == sorted(m.timestamp for m in out)
    assert b.is_empty


def test_concurrent_hammer():
    """8-thread mixed add/read/update workload (reference: mod.rs:649-748)."""
    m = MutableDataset(8)
    base = [m.add(np.full(8, i, np.float32)) for i in range(100)]
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(200):
                op = rng.integers(0, 3)
                if op == 0:
                    m.add(rng.normal(size=8).astype(np.float32))
                elif op == 1:
                    i = int(rng.integers(0, 100))
                    v = m.get(i)  # may be None if another thread removed
                    if v is not None:
                        assert v.shape == (8,)
                else:
                    i = int(rng.integers(0, 100))
                    try:
                        m.update(i, rng.normal(size=8).astype(np.float32))
                    except ScannError:
                        pass
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert m.size >= 100


def test_from_dataset_round_trip(rng):
    db = rng.normal(size=(20, 4)).astype(np.float32)
    m = MutableDataset.from_dataset(DenseDataset(db))
    assert m.size == 20
    dd = m.to_dense_dataset()
    np.testing.assert_allclose(dd.numpy(), db)


def test_incremental_updater():
    u = IncrementalUpdater("index-v1", rebuild_threshold=2)
    assert u.load_index() == "index-v1"
    u.queue_mutation(Mutation.add(0, [1.0]))
    assert not u.needs_rebuild()
    u.queue_mutation(Mutation.remove(0))
    assert u.needs_rebuild()
    assert len(u.get_pending_mutations()) == 2
    u.store_index("index-v2")
    u.reset_rebuild_counter()
    assert u.load_index() == "index-v2"
    assert not u.needs_rebuild()


def test_dynamic_searcher(rng):
    db = rng.normal(size=(200, 8)).astype(np.float32)
    ds = DynamicSearcher(DenseDataset(db), lambda d: BruteForceSearcher(d),
                         rebuild_threshold=1000)
    q = db[7]
    idx, dist = ds.search_batched_arrays(q, 3)
    assert idx[0, 0] == 7

    # add a closer point without rebuild -> found via delta path
    new_idx = ds.add(q + 1e-4)
    idx, dist = ds.search_batched_arrays(q, 2)
    assert set(idx[0]) == {7, new_idx}

    # remove the original -> masked out
    ds.remove(7)
    idx, _ = ds.search_batched_arrays(q, 1)
    assert idx[0, 0] == new_idx

    # update a snapshot row to be the best match -> rescored exactly
    ds.update(3, q + 5e-5)
    idx, dist = ds.search_batched_arrays(q, 1)
    assert idx[0, 0] == 3

    # rebuild folds everything in
    ds.force_rebuild()
    idx2, _ = ds.search_batched_arrays(q, 2)
    assert set(idx2[0]) == {3, new_idx}
    assert ds.size == 200  # 200 original + 1 add - 1 remove ... = 200


def test_dynamic_searcher_auto_rebuild(rng):
    db = rng.normal(size=(50, 4)).astype(np.float32)
    ds = DynamicSearcher(DenseDataset(db), lambda d: BruteForceSearcher(d),
                         rebuild_threshold=10)
    for i in range(25):
        ds.add(rng.normal(size=4).astype(np.float32))
    assert ds.size == 75
    # after auto-rebuilds the delta is small; search still exact
    q = rng.normal(size=4).astype(np.float32)
    idx, dist = ds.search_batched_arrays(q, 5)
    data, deleted = ds._mutable.snapshot()
    gt = np.argsort(((q[None] - data) ** 2).sum(-1))[:5]
    assert set(idx[0]) == set(gt.tolist())

def test_dynamic_searcher_heavy_deletes(rng):
    """90% of points deleted since build must not starve k results.

    The default over-fetch is min(2k, snap_rows); when >half the top-2k
    main-index candidates are deleted-since-build the searcher must refetch
    deeper until every query has min(k, live) valid candidates (reference
    guarantees full results via rebuild: src/mutator/mod.rs:494-546)."""
    n, d, k = 400, 8, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    ds = DynamicSearcher(DenseDataset(db), lambda dset: BruteForceSearcher(dset),
                         rebuild_threshold=10_000)
    keep = set(rng.choice(n, size=n // 10, replace=False).tolist())
    for i in range(n):
        if i not in keep:
            ds.remove(i)

    q = rng.normal(size=(4, d)).astype(np.float32)
    idx, dist = ds.search_batched_arrays(q, k)
    live = sorted(keep)
    gt_pool = db[live]
    for b in range(q.shape[0]):
        got = [int(i) for i in idx[b] if i >= 0]
        assert len(got) == k, f"query {b}: only {len(got)} of {k} results"
        assert all(i in keep for i in got)
        gt = np.argsort(((q[b][None] - gt_pool) ** 2).sum(-1))[:k]
        assert set(got) == {live[j] for j in gt}

    # degenerate: fewer live points than k -> exactly the live set returned
    ds2 = DynamicSearcher(DenseDataset(db[:20]),
                          lambda dset: BruteForceSearcher(dset),
                          rebuild_threshold=10_000)
    for i in range(20):
        if i not in (3, 11):
            ds2.remove(i)
    idx2, _ = ds2.search_batched_arrays(q[:1], 5)
    got2 = {int(i) for i in idx2[0] if i >= 0}
    assert got2 == {3, 11}


def test_dynamic_searcher_allow_mask_and_params(rng):
    """SearchParameters + allow_mask through the mutable index: epsilons filter exact distances; the allowlist
    filters main candidates AND the delta slab by point id."""
    from scann_tpu import SearchParameters

    db = rng.normal(size=(300, 8)).astype(np.float32)
    ds = DynamicSearcher(DenseDataset(db), lambda d: BruteForceSearcher(d),
                         rebuild_threshold=1000)
    q = db[7:8]
    a1 = ds.add(db[7] + 1e-4)  # delta twin of the query
    a2 = ds.add(db[7] + 2e-4)  # second delta twin

    # allowlist that denies the snapshot twin and one delta twin
    mask = np.ones(302, bool)
    mask[7] = False
    mask[a2] = False
    idx, dist = ds.search_batched_arrays(q, 3, allow_mask=mask)
    assert 7 not in idx[0] and a2 not in idx[0]
    assert idx[0, 0] == a1

    # epsilon on the merged exact distances: only near-zero hits survive
    params = SearchParameters(post_reordering_epsilon=1e-3)
    idx, dist = ds.search_batched_arrays(q, 5, params)
    valid = idx[0] >= 0
    assert set(idx[0][valid]) == {7, a1, a2}
    assert np.all(dist[0][valid] <= 1e-3)
    assert np.all(np.isinf(dist[0][~valid]))

    # epsilon + mask compose
    idx, dist = ds.search_batched_arrays(q, 5, params, allow_mask=mask)
    valid = idx[0] >= 0
    assert set(idx[0][valid]) == {a1}

    # hostile epsilon masks everything
    idx, dist = ds.search_batched_arrays(
        q, 3, SearchParameters(post_reordering_epsilon=-1.0))
    assert np.all(idx == -1) and np.all(np.isinf(dist))


def test_dynamic_searcher_delta_slab_cached_between_mutations(rng):
    """Per-search host work is O(1) when no mutations occurred: the delta
    slab is uploaded once and reused (no per-search get_batch loop)."""
    db = rng.normal(size=(100, 8)).astype(np.float32)
    ds = DynamicSearcher(DenseDataset(db), lambda d: BruteForceSearcher(d),
                         rebuild_threshold=1000)
    for i in range(20):
        ds.add(rng.normal(size=8).astype(np.float32))

    calls = {"n": 0}
    orig = ds._mutable.get_batch

    def counting(ids):
        calls["n"] += 1
        return orig(ids)

    ds._mutable.get_batch = counting
    q = rng.normal(size=(4, 8)).astype(np.float32)
    ds.search_batched_arrays(q, 5)
    assert calls["n"] == 1  # first search builds the cache
    ds.search_batched_arrays(q, 5)
    ds.search_batched_arrays(q, 5)
    assert calls["n"] == 1  # reused
    ds.add(rng.normal(size=8).astype(np.float32))  # invalidates
    ds.search_batched_arrays(q, 5)
    assert calls["n"] == 2
    # allow_mask must not rebuild the slab either (only the validity bools)
    mask = np.ones(ds._mutable.total_rows, bool)
    ds.search_batched_arrays(q, 5, allow_mask=mask)
    assert calls["n"] == 2


def test_mutation_buffer_default_dim_round_trips_payloads():
    """flush() must return the pushed vectors even when the buffer was
    constructed without an explicit dim (the native path previously sized
    its output rows from dim=0 and dropped every payload)."""
    import numpy as np

    from scann_tpu.mutator import MutationBuffer, MutationKind

    buf = MutationBuffer(64)
    buf.add(0, np.array([1.0, 2.0, 3.0], np.float32))
    buf.remove(1)
    buf.update(2, np.array([4.0, 5.0, 6.0], np.float32))
    out = buf.flush()
    assert [m.kind for m in out] == [
        MutationKind.ADD, MutationKind.REMOVE, MutationKind.UPDATE]
    np.testing.assert_allclose(out[0].data[:3], [1.0, 2.0, 3.0])
    assert out[1].data is None
    np.testing.assert_allclose(out[2].data[:3], [4.0, 5.0, 6.0])


def test_mutable_dataset_flags_log_overflow():
    """A full delta log must not pass silently: the dataset still applies
    the change but flags that incremental replay lost completeness."""
    import warnings

    import numpy as np

    from scann_tpu.mutator import MutableDataset

    m = MutableDataset(4)
    m._mutations.max_buffer_size = 2
    if m._mutations._lib is not None:
        # shrink the native buffer too
        m._mutations._lib.mbuf_destroy(m._mutations._h)
        m._mutations._h = m._mutations._lib.mbuf_create(2)
    v = np.zeros(4, np.float32)
    m.add(v); m.add(v)
    assert not m.mutation_log_overflowed
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m.add(v)
    assert m.mutation_log_overflowed
    assert any("overflowed" in str(x.message) for x in w)
    assert m.size == 3  # the dataset itself is unaffected
    m.flush_mutations()
    assert not m.mutation_log_overflowed
