"""bf16 block-min sweep: kernel parity + searcher recall/semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from scann_tpu import (
    BlockSweepConfig,
    BlockSweepSearcher,
    BruteForceSearcher,
    DenseDataset,
    DistanceMeasure,
    SearchParameters,
)
from scann_tpu.ops.sweep_pallas import (
    BLOCK_MASK_VALUE,
    _augment_queries,
    _augment_queries_int8,
    block_minima_pallas,
    block_minima_xla,
    build_allow_penalty,
    build_augmented_db,
    build_int8_augmented_db,
)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_block_min_sweep_matches_jnp(rng):
    """Plain block-minima formulation vs an exhaustive numpy reference:
    query-major minima of contiguous r-row blocks, in-block argmins."""
    n, d, b, r, tile_n = 1024, 24, 16, 8, 256
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    n_valid = n - 100
    aug = jnp.asarray(build_augmented_db(db, n_valid, DistanceMeasure.SQUARED_L2,
                                         tile_n=tile_n))
    q_aug = _augment_queries(jnp.asarray(q), DistanceMeasure.SQUARED_L2,
                             aug.shape[1])
    vals, locs = block_minima_xla(q_aug, aug, r=r)
    assert vals.shape == (b, aug.shape[0] // r)
    scores = np.asarray(jnp.dot(q_aug.astype(jnp.float32),
                                aug.astype(jnp.float32).T))
    s3 = scores.reshape(b, -1, r)
    # ULP-level accumulation-order differences between the two programs
    np.testing.assert_allclose(np.asarray(vals), s3.min(axis=2),
                               rtol=1e-5, atol=1e-5)
    # argmin comparison via achieved value
    pick = np.take_along_axis(s3, np.asarray(locs)[..., None], axis=2)[..., 0]
    np.testing.assert_allclose(pick, s3.min(axis=2), rtol=1e-5, atol=1e-5)
    # masked tail blocks carry the sentinel
    assert np.all(np.asarray(vals)[:, (n_valid // r) + 1:]
                  >= BLOCK_MASK_VALUE / 2)


def _sweep_inputs(rng, rows, n=1024, d=24, b=16, n_valid=None):
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    n_valid = n - 100 if n_valid is None else n_valid
    if rows == "bf16":
        aug = jnp.asarray(build_augmented_db(
            db, n_valid, DistanceMeasure.SQUARED_L2, tile_n=256))
        return aug, _augment_queries(q, DistanceMeasure.SQUARED_L2,
                                     aug.shape[1]), BLOCK_MASK_VALUE
    codes, scales, sn = build_int8_augmented_db(
        db, n_valid, DistanceMeasure.SQUARED_L2, tile_n=256)
    qa = _augment_queries_int8(q, DistanceMeasure.SQUARED_L2,
                               jnp.asarray(scales), sn, codes.shape[1])
    from scann_tpu.ops.sweep_pallas import INT8_NORM_DIGIT_MAX

    return jnp.asarray(codes), qa, 4.0 * INT8_NORM_DIGIT_MAX * sn


@pytest.mark.parametrize("top2", [False, True])
@pytest.mark.parametrize("pen", [False, True])
@pytest.mark.parametrize("rows", ["bf16", "int8"])
@pytest.mark.parametrize("r", [8, 32, 64])
def test_block_minima_kernel_matches_plain(rng, r, rows, pen, top2):
    """Triton-route sweep kernel (interpret mode) vs the plain formulation:
    same minima (up to f32 summation order), in-block argmins that
    achieve them, for bf16/int8 rows, with and without the allow penalty
    and the second-smallest pair."""
    aug, qa, mask_value = _sweep_inputs(rng, rows)
    penalty = None
    if pen:
        mask = rng.random(aug.shape[0]) < 0.3
        penalty = jnp.asarray(build_allow_penalty(
            mask, aug.shape[0], r, mask_value=mask_value))
    got = block_minima_pallas(qa, aug, penalty, r=r, top2=top2,
                              interpret=True)
    want = block_minima_xla(qa, aug, penalty, r=r, top2=top2)
    assert len(got) == len(want) == (4 if top2 else 2)
    scores = np.asarray(jnp.dot(qa.astype(jnp.float32),
                                aug.astype(jnp.float32).T))
    if penalty is not None:
        scores = scores + np.asarray(penalty, np.float32).reshape(-1)[None]
    s3 = scores.reshape(qa.shape[0], -1, r)
    scale = np.abs(s3).max()
    for v, loc, w in zip(got[::2], got[1::2], want[::2]):
        np.testing.assert_allclose(np.asarray(v), np.asarray(w),
                                   rtol=1e-5, atol=1e-6 * scale)
        pick = np.take_along_axis(s3, np.asarray(loc)[..., None], 2)[..., 0]
        np.testing.assert_allclose(pick, np.asarray(w),
                                   rtol=1e-5, atol=1e-6 * scale)
    if top2:
        assert np.all(np.asarray(got[1]) != np.asarray(got[3]))


@pytest.mark.parametrize("measure", [DistanceMeasure.SQUARED_L2,
                                     DistanceMeasure.DOT_PRODUCT,
                                     DistanceMeasure.COSINE])
def test_block_sweep_searcher_recall(rng, measure):
    n, d, b, k = 4096, 32, 24, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ds = DenseDataset(db)
    gt, gtd = BruteForceSearcher(ds, measure).search_batched_arrays(q, k)

    s = BlockSweepSearcher(ds, BlockSweepConfig(
        distance_measure=measure, pre_reorder_k=256, block_r=8, tile_n=256))
    idx, dist = s.search_batched_arrays(q, k)
    recall = np.mean([len(set(a) & set(g)) / k for a, g in zip(idx, gt)])
    assert recall >= 0.95, (measure, recall)
    # returned distances are exact f32 in the measure's units
    hit = idx == gt
    np.testing.assert_allclose(dist[hit], gtd[hit], rtol=1e-4, atol=1e-4)
    assert np.all(np.diff(dist, axis=1) >= -1e-6)


def test_block_sweep_padded_tail_excluded(rng):
    n, d = 1000, 16  # pads to tile_n
    db = rng.normal(size=(n, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=64, block_r=8, tile_n=256))
    idx, dist = s.search_batched_arrays(db[:5], 3)
    assert np.all(idx < n)
    assert np.all(idx >= 0)
    # self-match at distance ~0
    np.testing.assert_array_equal(idx[:, 0], np.arange(5))
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=1e-3)


def test_block_sweep_epsilons_and_params(rng):
    n, d, b, k = 2048, 16, 8, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=64, block_r=8, tile_n=256))
    idx, dist = s.search_batched_arrays(q, k)
    eps = float(np.median(dist[:, k // 2]))
    idx2, dist2 = s.search_batched_arrays(
        q, k, SearchParameters(post_reordering_epsilon=eps))
    assert np.isinf(dist2).any()
    assert np.all((dist2 <= eps) | np.isinf(dist2))
    assert np.all((idx2 >= 0) | np.isinf(dist2))
    # pre_reordering_num_neighbors widens the candidate pool
    idx3, _ = s.search_batched_arrays(
        q, k, SearchParameters(pre_reordering_num_neighbors=n // 8))
    gt, _ = BruteForceSearcher(DenseDataset(db)).search_batched_arrays(q, k)
    r3 = np.mean([len(set(a) & set(g)) / k for a, g in zip(idx3, gt)])
    assert r3 >= 0.95


def test_block_sweep_odd_batch_and_single_query(rng):
    db = rng.normal(size=(512, 8)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=32, block_r=8, tile_n=128))
    idx, dist = s.search_batched_arrays(db[:3], 2)
    assert idx.shape == (3, 2)
    res = s.search(db[7], 1)
    assert res.indices()[0] == 7


def test_block_min2_matches_exhaustive(rng):
    """Top-2 minima (v1,l1,v2,l2) vs a numpy partial sort."""
    n, d, b, r, tile_n = 512, 16, 16, 8, 128
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    aug = jnp.asarray(build_augmented_db(db, n, DistanceMeasure.SQUARED_L2,
                                         tile_n=tile_n))
    q_aug = _augment_queries(jnp.asarray(q), DistanceMeasure.SQUARED_L2,
                             aug.shape[1])
    v1, l1, v2, l2 = block_minima_xla(q_aug, aug, r=r, top2=True)
    scores = np.asarray(jnp.dot(q_aug.astype(jnp.float32),
                                aug.astype(jnp.float32).T))
    s3 = scores.reshape(b, -1, r)
    order = np.argsort(s3, axis=2, kind="stable")
    want1 = np.take_along_axis(s3, order[..., :1], axis=2)[..., 0]
    want2 = np.take_along_axis(s3, order[..., 1:2], axis=2)[..., 0]
    np.testing.assert_allclose(np.asarray(v1), want1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v2), want2, rtol=1e-5, atol=1e-5)
    # locations achieve their values and differ
    got1 = np.take_along_axis(s3, np.asarray(l1)[..., None], axis=2)[..., 0]
    got2 = np.take_along_axis(s3, np.asarray(l2)[..., None], axis=2)[..., 0]
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got2, want2, rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(l1) != np.asarray(l2))


def test_block_sweep_top2_beats_collision_ceiling(rng):
    """With few blocks, same-block GT pairs are common; top2 recovers them."""
    n, d, b, k = 2048, 16, 32, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = db[rng.integers(0, n, size=b)] + 0.05 * rng.normal(
        size=(b, d)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, k)

    kw = dict(pre_reorder_k=n // 32, block_r=32, tile_n=256)
    r1 = BlockSweepSearcher(ds, BlockSweepConfig(**kw))
    r2 = BlockSweepSearcher(ds, BlockSweepConfig(top2=True, **kw))

    def recall(s):
        idx, _ = s.search_batched_arrays(q, k)
        return np.mean([len(set(a) & set(g)) / k for a, g in zip(idx, gt)])

    rec1, rec2 = recall(r1), recall(r2)
    assert rec2 >= rec1
    assert rec2 >= 0.97, (rec1, rec2)


def test_shuffle_stride_properties():
    from scann_tpu.ops.sweep_pallas import shuffle_stride_for

    for n in (2, 7, 1000, 4096, 1_180_000):
        s = shuffle_stride_for(n)
        inv = pow(s, -1, n)
        pos = (np.arange(n, dtype=np.int64) * s) % n
        assert len(np.unique(pos)) == n  # a permutation
        back = (pos * inv) % n
        np.testing.assert_array_equal(back, np.arange(n))


def test_block_sweep_shuffle_fixes_sorted_data(rng):
    """Cluster-sorted input: a query's true neighbors are ADJACENT rows, so
    without the shuffle they collide in the same r-block and only one
    survives per block (recall caps well below 1 even with exact selection);
    the stride shuffle spreads them across blocks and restores recall. Also
    checks the permuted-position -> id arithmetic translation is exact."""
    centers = rng.normal(size=(8, 12)).astype(np.float32) * 4
    db = np.concatenate([c + 0.3 * rng.normal(size=(250, 12)).astype(np.float32)
                         for c in centers])  # sorted by cluster
    q = db[rng.integers(0, len(db), size=16)] + 0.01 * rng.normal(
        size=(16, 12)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 5)

    def recall(shuffle):
        s = BlockSweepSearcher(ds, BlockSweepConfig(
            pre_reorder_k=len(db) // 8, block_r=8, tile_n=128,
            shuffle=shuffle))
        idx, _ = s.search_batched_arrays(q, 5)
        assert np.all(idx < len(db))
        return np.mean([len(set(a) & set(g)) / 5 for a, g in zip(idx, gt)])

    rec_off, rec_on = recall(False), recall(True)
    assert rec_on >= 0.95, rec_on
    assert rec_on > rec_off, (rec_on, rec_off)


def test_block_sweep_shuffle_id_translation_full_range(rng):
    """Self-queries across the whole id range: every translated id must be
    exact. (Regression: a modular-arithmetic device translation silently
    overflowed int32 at large n — small-n tests stayed green while 1.18M
    recall collapsed to ~0.003.)"""
    n, d = 16384, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=64, block_r=8, tile_n=512, shuffle=True))
    sel = np.concatenate([np.arange(5), n // 2 + np.arange(5),
                          n - 5 + np.arange(5)])
    idx, dist = s.search_batched_arrays(db[sel], 1)
    np.testing.assert_array_equal(idx[:, 0], sel)
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=1e-3)


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_block_sweep_low_precision_rerank(rng, rdt):
    """rerank_dtype drops the f32 database from the sweep's serving
    footprint (the dominant allocation — the first pass reads only the
    bf16 augmented copy): recall holds and distances match the rounded-row
    truth. This is what keeps the sweep on one chip past ~15M points."""
    n, d, b, k = 4096, 32, 24, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, k)

    s = BlockSweepSearcher(ds, BlockSweepConfig(
        pre_reorder_k=256, block_r=8, tile_n=256, rerank_dtype=rdt))
    aug, db_repr, norms, n_valid = s._device_state()
    if rdt == "int8":
        assert isinstance(db_repr, tuple) and str(db_repr[0].dtype) == "uint8"
    else:
        assert str(db_repr.dtype) == "bfloat16"
    idx, dist = s.search_batched_arrays(q, k)
    recall = np.mean([len(set(a) & set(g)) / k for a, g in zip(idx, gt)])
    assert recall >= 0.95, (rdt, recall)
    assert np.all(np.diff(dist, axis=1) >= -1e-6)
    # io round-trip carries the dtype
    import tempfile

    from scann_tpu.io import load_index, save_index

    with tempfile.TemporaryDirectory() as td:
        save_index(td + "/s.npz", s)
        s2 = load_index(td + "/s.npz")
        assert s2._config.rerank_dtype == rdt
        i2, d2 = s2.search_batched_arrays(q, k)
        np.testing.assert_array_equal(idx, i2)
        np.testing.assert_allclose(dist, d2, rtol=1e-5, atol=1e-5)


def test_block_sweep_k_beyond_block_count_pads(rng):
    """k larger than the number of r-blocks: the kernel can only produce
    one candidate per block, so the output pads to [B, k] with (-1, inf)
    instead of crashing the final top-k (regression: Scann.auto() routes
    every small dataset here)."""
    from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher

    db = rng.normal(size=(1000, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db))
    k = 100  # > N_pad / block_r = 2048/32 = 64 blocks
    idx, dists = s.search_batched_arrays(q, k)
    assert idx.shape == (3, k)
    valid = idx >= 0
    assert valid[:, :32].all()          # plenty of real candidates up front
    assert (~valid[:, -8:]).all()       # block ceiling pads the tail
    assert np.all(np.isinf(dists[~valid]))


# -- int8 sweep copy ---------------------------------------------------------

def test_int8_norm_digits_roundtrip():
    from scann_tpu.ops.sweep_pallas import (
        INT8_NORM_DIGIT_MAX,
        _encode_norm_digits,
    )

    m = np.concatenate([np.arange(0, 2000),
                        np.array([INT8_NORM_DIGIT_MAX, 400_000, 123_457])])
    d0, d1, d2 = _encode_norm_digits(m)
    for dd in (d0, d1, d2):
        assert dd.min() >= -64 and dd.max() <= 63
    np.testing.assert_array_equal(d0 + 128 * d1 + 16384 * d2, m)


@pytest.mark.parametrize("measure", [DistanceMeasure.SQUARED_L2,
                                     DistanceMeasure.DOT_PRODUCT,
                                     DistanceMeasure.COSINE])
def test_int8_sweep_recall_matches_bf16(rng, measure):
    """int8 streamed copy reaches the bf16 copy's recall (both recover via
    the exact re-rank) on every supported measure."""
    n, d, b, k = 4096, 32, 24, 10
    db = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    q = (rng.normal(size=(b, d)) * 2.0).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds, measure).search_batched_arrays(q, k)
    recalls = {}
    for sd in ("bfloat16", "int8"):
        s = BlockSweepSearcher(ds, BlockSweepConfig(
            distance_measure=measure, sweep_dtype=sd, pre_reorder_k=64))
        idx, dists = s.search_batched_arrays(q, k)
        recalls[sd] = np.mean([len(set(a) & set(g)) / k
                               for a, g in zip(idx, gt)])
        # distances are exact re-ranked values regardless of sweep dtype
        assert np.all(np.isfinite(dists))
    assert recalls["int8"] >= recalls["bfloat16"] - 0.02
    assert recalls["int8"] >= 0.9


def test_int8_sweep_padded_tail_excluded(rng):
    """Mask digits on padded rows keep them out of results."""
    n, d, k = 300, 16, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(9, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        sweep_dtype="int8", pre_reorder_k=32))
    idx, dists = s.search_batched_arrays(q, k)
    assert idx.max() < n and idx.min() >= 0
    assert np.all(np.isfinite(dists))


def test_int8_sweep_epsilons(rng):
    """pre/post eps semantics hold with the int8 mask threshold."""
    n, d, k = 1024, 16, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(6, d)).astype(np.float32)
    ds = DenseDataset(db)
    s = BlockSweepSearcher(ds, BlockSweepConfig(
        sweep_dtype="int8", pre_reorder_k=64))
    base_i, base_d = s.search_batched_arrays(q, k)
    cut = float(np.median(base_d))
    idx, dists = s.search_batched_arrays(
        q, k, params=SearchParameters(post_reordering_epsilon=cut))
    kept = dists[np.isfinite(dists)]
    assert np.all(kept <= cut + 1e-5)
    assert (idx >= 0).sum() < (base_i >= 0).sum()


def test_int8_sweep_top2_and_shuffle(rng):
    """int8 composes with top2 and the stride shuffle."""
    n, d, k = 2048, 24, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(12, d)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, k)
    s = BlockSweepSearcher(ds, BlockSweepConfig(
        sweep_dtype="int8", top2=True, shuffle=True, pre_reorder_k=64))
    idx, _ = s.search_batched_arrays(q, k)
    rec = np.mean([len(set(a) & set(g)) / k for a, g in zip(idx, gt)])
    assert rec >= 0.95


def test_int8_sweep_io_roundtrip(rng, tmp_path):
    from scann_tpu.io import load_index, save_index

    n, d, k = 512, 16, 5
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(4, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        sweep_dtype="int8", pre_reorder_k=32))
    i0, d0 = s.search_batched_arrays(q, k)
    path = tmp_path / "sweep_i8.npz"
    save_index(path, s)
    s2 = load_index(path)
    assert s2._config.sweep_dtype == "int8"
    i1, d1 = s2.search_batched_arrays(q, k)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-6)


# -- fused restrict allowlist (penalty stream) --------------------------------

def _masked_gt(db, q, mask, k):
    allowed = np.where(mask)[0]
    d2 = ((q[:, None, :] - db[None, allowed, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return allowed[order], np.take_along_axis(d2, order, axis=1)


def test_block_sweep_fused_allow_mask(rng):
    """Selective restrict fused into the sweep (penalty stream): only
    allowed rows surface, distances are exact, recall vs the masked brute
    force stays high even at 2% selectivity — where the base-class host
    over-fetch fallback cannot recover rows shadowed by denied minima."""
    n, d, b, k = 4096, 24, 16, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    mask = rng.random(n) < 0.02
    mask[:2 * k] = True
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=256, block_r=8, tile_n=256))
    idx, dist = s.search_batched_arrays(q, k, allow_mask=mask)
    gt, gtd = _masked_gt(db, q, mask, k)
    valid = idx >= 0
    assert valid.any()
    assert np.all(mask[idx[valid]])  # every returned id is allowed
    hit = (idx == gt) & valid
    np.testing.assert_allclose(dist[hit],
                               gtd[(idx == gt) & valid], rtol=1e-4, atol=1e-4)
    recall = np.mean([len(set(a[a >= 0].tolist()) & set(g.tolist())) / k
                      for a, g in zip(idx, gt)])
    assert recall >= 0.9, recall


def test_block_sweep_allow_mask_exact_one_per_block(rng):
    """With at most one allowed row per block (shuffle off) the fused mask
    is EXACT: results equal the masked brute force bit-for-bit in ids."""
    n, d, b, k = 4096, 16, 8, 10
    r = 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    mask = np.zeros(n, dtype=bool)
    mask[::64] = True  # one allowed row per 8-row block
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=n // r, block_r=r, tile_n=256, shuffle=False))
    idx, dist = s.search_batched_arrays(q, k, allow_mask=mask)
    gt, gtd = _masked_gt(db, q, mask, k)
    np.testing.assert_array_equal(idx, gt)
    np.testing.assert_allclose(dist, gtd, rtol=1e-4, atol=1e-4)


def test_block_sweep_filter_dispatch_uses_fused_mask(rng):
    """search_batched_with_filter lowers to the fused allow_mask path
    (supports_allow_mask) and returns only allowed ids."""
    from scann_tpu.restricts.filters import PredicateFilter

    n, d, k = 2048, 16, 5
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(4, d)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        pre_reorder_k=128, block_r=8, tile_n=256))
    assert s.supports_allow_mask()
    flt = PredicateFilter(lambda i: i % 3 == 0)
    res = s.search_batched_with_filter(q, k, flt)
    for row in res:
        ids = row.indices()
        assert ids and all(i % 3 == 0 for i in ids)


def test_block_sweep_allow_mask_int8_and_top2(rng):
    """The penalty stream composes with the int8 sweep layout (scaled mask
    value) and with the top2 tournament kernel."""
    n, d, b, k = 2048, 16, 8, 5
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    mask = rng.random(n) < 0.05
    mask[: 2 * k] = True
    gt, _ = _masked_gt(db, q, mask, k)
    for cfg in (BlockSweepConfig(pre_reorder_k=128, block_r=8, tile_n=256,
                                 sweep_dtype="int8"),
                BlockSweepConfig(pre_reorder_k=128, block_r=8, tile_n=256,
                                 top2=True)):
        s = BlockSweepSearcher(DenseDataset(db), cfg)
        idx, dist = s.search_batched_arrays(q, k, allow_mask=mask)
        valid = idx >= 0
        assert valid.any()
        assert np.all(mask[idx[valid]])
        recall = np.mean([len(set(a[a >= 0].tolist()) & set(g.tolist())) / k
                          for a, g in zip(idx, gt)])
        assert recall >= 0.9, (cfg.sweep_dtype, cfg.top2, recall)
