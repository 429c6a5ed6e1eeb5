"""Tree-×-AH hybrid: recall with re-ranking, residuals on/off, restricts
mask, self-query (reference test analog: tests/stress_tests.rs recall
verification for tree-ah)."""

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, ScannError, SearchParameters
from scann_tpu.hashes.hasher import AsymmetricHasherConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher


def _recall(idx, gt):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(idx, gt)])


@pytest.fixture(scope="module")
def hybrid_setup():
    rng = np.random.default_rng(42)
    # clustered data: the realistic regime for partitioned search
    centers = rng.normal(size=(32, 32)).astype(np.float32) * 3.0
    assign = rng.integers(0, 32, size=4000)
    db = (centers[assign] + rng.normal(size=(4000, 32)) * 0.5).astype(np.float32)
    q = (centers[rng.integers(0, 32, size=25)]
         + rng.normal(size=(25, 32)) * 0.5).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    return db, q, ds, gt, s


def test_recall_with_reranking(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    idx, dist = s.search_batched_arrays(q, 10,
                                        SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(idx, gt) >= 0.9
    # distances are exact (re-ranked)
    d_at = ((q[:, None, :] - db[np.maximum(idx, 0)]) ** 2).sum(-1)
    m = idx >= 0
    np.testing.assert_allclose(dist[m], d_at[m], rtol=1e-3, atol=1e-3)


def test_self_query(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    idx, dist = s.search_batched_arrays(db[:10], 1)
    assert (idx[:, 0] == np.arange(10)).mean() >= 0.9


def test_more_partitions_searched_higher_recall(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    r = []
    for p in (1, 8, 32):
        idx, _ = s.search_batched_arrays(
            q, 10, SearchParameters(num_leaves_to_search=p,
                                    pre_reordering_num_neighbors=120))
        r.append(_recall(idx, gt))
    assert r[0] <= r[1] <= r[2] + 1e-9
    assert r[2] >= 0.95


def test_no_residuals_mode(hybrid_setup):
    db, q, ds, gt, _ = hybrid_setup
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, use_residuals=False,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    idx, _ = s.search_batched_arrays(q, 10,
                                     SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(idx, gt) >= 0.8  # residuals usually help; raw PQ still decent


def test_residuals_beat_raw_pq():
    """Residual encoding should reduce quantization error (the whole point:
    tree_x_hybrid/mod.rs:212-237)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16)).astype(np.float32) * 5.0
    assign = rng.integers(0, 16, size=2000)
    db = (centers[assign] + rng.normal(size=(2000, 16)) * 0.3).astype(np.float32)
    ds = DenseDataset(db)
    cfgs = [TreeXHybridConfig(num_partitions=16, partitions_to_search=16,
                              use_residuals=u,
                              hash_config=AsymmetricHasherConfig(
                                  num_codes=16, num_subspaces=4, seed=1))
            for u in (True, False)]
    errs = []
    for cfg in cfgs:
        s = TreeXHybridSearcher(cfg).build(ds)
        tk = s.partitioner.tokenization
        # codes are per-assignment rows in CSR order: row r encodes
        # db[point_indices[r]] (minus its partition's centroid)
        row_tokens = np.repeat(np.arange(tk.num_partitions), tk.partition_sizes)
        base = s.partitioner.centers[row_tokens] if cfg.use_residuals else 0.0
        rec = base + s.codebook.decode(s.codes)
        errs.append(((rec - db[tk.point_indices]) ** 2).sum(-1).mean())
    assert errs[0] < errs[1]


def test_allowlist_mask(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    allow = np.zeros(len(db), dtype=bool)
    allow[: len(db) // 2] = True
    idx, _ = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120), allow_mask=allow)
    valid = idx[idx >= 0]
    assert len(valid) > 0
    assert (valid < len(db) // 2).all()


def test_missing_marked_minus_one(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    allow = np.zeros(len(db), dtype=bool)
    allow[:3] = True  # only 3 allowed points in the whole db
    idx, dist = s.search_batched_arrays(q, 10, allow_mask=allow)
    assert (idx == -1).any()
    assert np.isinf(dist[idx == -1]).all()
    assert ((idx >= 0) <= (idx < 3)).all() if (idx >= 0).any() else True


def test_unbuilt_rejected():
    with pytest.raises(ScannError):
        TreeXHybridSearcher().search(np.zeros(8, np.float32), 1)


def test_memory_usage(hybrid_setup):
    _, _, _, _, s = hybrid_setup
    # the REAL serving slab: s_pad=align_up(8,32)=32 u8 code bytes plus 4
    # int32 perm bytes per CSR row (not the theoretical packed-int4 size,
    # which understated what the kernels actually read by 8x+), plus
    # 128-aligned partition gaps, centroids, and the codebook
    assert s.memory_usage() >= 4000 * (32 + 4)
    assert s.memory_usage() < 3 * 4000 * (32 + 4) + 1_000_000


def test_spilling_unique_results_and_recall():
    """Spilled points appear in several leaves; results must stay unique and
    residual codes must match the probed partition (per-assignment codes)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(16, 16)).astype(np.float32) * 3.0
    assign = rng.integers(0, 16, size=2000)
    db = (centers[assign] + rng.normal(size=(2000, 16)) * 0.6).astype(np.float32)
    q = (centers[rng.integers(0, 16, size=20)]
         + rng.normal(size=(20, 16)) * 0.6).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=16, partitions_to_search=6,
        spilling=True, spilling_threshold=0.5,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=3),
    )).build(ds)
    assert s.partitioner.tokenization.max_multiplicity > 1
    idx, dist = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    for row in idx:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real), row
    assert _recall(idx, gt) >= 0.9
    # distances ascending per row
    for row in dist:
        fin = row[np.isfinite(row)]
        assert (np.diff(fin) >= -1e-5).all()


def test_epsilon_thresholds(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    base_idx, base_dist = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    cutoff = float(np.median(base_dist[np.isfinite(base_dist)]))
    # post-reordering epsilon: exact distances beyond it become (-1, inf)
    idx, dist = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120,
                                post_reordering_epsilon=cutoff))
    m = idx >= 0
    assert (dist[m] <= cutoff + 1e-5).all()
    want_masked = np.isfinite(base_dist) & (base_dist > cutoff + 1e-5)
    assert (idx[want_masked] == -1).all()
    assert np.isinf(dist[want_masked]).all()
    # a generous pre-reordering epsilon keeps everything
    idx2, dist2 = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120,
                                pre_reordering_epsilon=1e9))
    np.testing.assert_array_equal(idx2, base_idx)
    # a tiny pre epsilon masks everything
    idx3, dist3 = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120,
                                pre_reordering_epsilon=-1.0))
    assert (idx3 == -1).all()


def test_tree_ah_cosine_normalized_pipeline(rng):
    """Cosine tree-AH: the build L2-normalizes rows and search normalizes
    queries, so partition selection and residual-PQ scores rank identically
    to cosine (regression: unnormalized candidate generation measured
    recall@10 0.24 on out-of-cluster queries)."""
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.ops.distances import DistanceMeasure

    centers = rng.normal(size=(20, 24)).astype(np.float32) * 3
    db = np.concatenate(
        [c + rng.normal(size=(200, 24)).astype(np.float32) for c in centers])
    rng.shuffle(db)
    q = rng.normal(size=(24, 24)).astype(np.float32) * 2
    ds = DenseDataset(db)
    gt, gtd = BruteForceSearcher(
        ds, DistanceMeasure.COSINE).search_batched_arrays(q, 10)

    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=12,
        distance_measure=DistanceMeasure.COSINE,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=8, seed=0, max_iterations=8),
    )).build(ds)
    idx, dist = s.search_batched_arrays(
        q, 10, params=SearchParameters(pre_reordering_num_neighbors=200))
    recall = np.mean([len(set(a) & set(g)) / 10
                      for a, g in zip(np.asarray(idx), np.asarray(gt))])
    assert recall >= 0.9, recall
    hit = np.asarray(idx) == np.asarray(gt)
    np.testing.assert_allclose(np.asarray(dist)[hit], np.asarray(gtd)[hit],
                               rtol=1e-4, atol=1e-4)


def test_tree_ah_dot_product_mips_pipeline(rng):
    """MIPS tree-AH: partition selection by largest dot and -dot LUTs with
    the per-partition bias folded in (regression: L2-based candidate
    generation under DOT_PRODUCT measured recall@10 = 0.0 on varying-norm
    data; the reference has the same defect — lut.rs:47-70 builds L2 tables
    unconditionally)."""
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.ops.distances import DistanceMeasure

    centers = rng.normal(size=(20, 24)).astype(np.float32) * 3
    db = np.concatenate(
        [c + rng.normal(size=(200, 24)).astype(np.float32) for c in centers])
    db *= rng.uniform(0.5, 2.0, size=(len(db), 1)).astype(np.float32)
    rng.shuffle(db)
    q = rng.normal(size=(24, 24)).astype(np.float32) * 2
    ds = DenseDataset(db)
    gt, gtd = BruteForceSearcher(
        ds, DistanceMeasure.DOT_PRODUCT).search_batched_arrays(q, 10)

    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=12,
        distance_measure=DistanceMeasure.DOT_PRODUCT,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=8, seed=0, max_iterations=8),
    )).build(ds)
    idx, dist = s.search_batched_arrays(
        q, 10, params=SearchParameters(pre_reordering_num_neighbors=200))
    recall = np.mean([len(set(a) & set(g)) / 10
                      for a, g in zip(np.asarray(idx), np.asarray(gt))])
    assert recall >= 0.9, recall
    hit = np.asarray(idx) == np.asarray(gt)
    np.testing.assert_allclose(np.asarray(dist)[hit], np.asarray(gtd)[hit],
                               rtol=1e-3, atol=1e-3)


def test_chunked_residual_encode_matches_single_chunk(monkeypatch):
    """The build streams residuals through bounded device chunks (the full
    [M, D] tensor OOMed 10M x 100d); codes must be identical regardless of
    chunking."""
    import scann_tpu.models.tree_x_hybrid as txh

    rng = np.random.default_rng(0)
    db = rng.normal(size=(20_000, 16)).astype(np.float32)
    cfg = dict(num_partitions=32, partitions_to_search=8)

    def build():
        c = TreeXHybridConfig(
            **cfg, hash_config=AsymmetricHasherConfig(
                num_codes=16, num_subspaces=8, seed=1, max_iterations=4))
        return TreeXHybridSearcher(c).build(DenseDataset(db))

    one = build()                                   # single chunk (default)
    monkeypatch.setattr(txh, "_ENCODE_CHUNK_ELEMS", 1)  # floor -> 8192 rows
    many = build()                                  # 3 chunks
    np.testing.assert_array_equal(one.codes, many.codes)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    i1, d1 = one.search_batched_arrays(q, 5)
    i2, d2 = many.search_batched_arrays(q, 5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_bf16_rerank_matches_f32(hybrid_setup):
    """rerank_dtype='bfloat16' halves the rerank copy; ranking among pre_k
    candidates must be essentially unchanged and distances accurate to bf16
    rounding (~3 decimal digits)."""
    db, q, ds, gt, _ = hybrid_setup
    s16 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="bfloat16",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    db_dev, norms, n = s16._device_state()
    assert str(db_dev.dtype) == "bfloat16"
    assert n == len(db)
    idx, dist = s16.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(idx, gt) >= 0.9
    # distances track the exact f32 values within bf16 relative error
    d_at = ((q[:, None, :] - db[np.maximum(idx, 0)]) ** 2).sum(-1)
    m = idx >= 0
    np.testing.assert_allclose(dist[m], d_at[m], rtol=2e-2, atol=2e-2)


def test_bf16_rerank_io_roundtrip(hybrid_setup, tmp_path):
    from scann_tpu.io import load_index, save_index

    db, q, ds, gt, _ = hybrid_setup
    s16 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="bfloat16",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    path = str(tmp_path / "tree_bf16.npz")
    save_index(path, s16)
    s2 = load_index(path)
    assert s2.config.rerank_dtype == "bfloat16"
    i1, d1 = s16.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i2, d2 = s2.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_rerank_dtype_validated():
    with pytest.raises(ScannError):
        TreeXHybridSearcher(TreeXHybridConfig(rerank_dtype="float16"))


def test_int8_rerank_matches_f32(hybrid_setup):
    """rerank_dtype='int8' quarters the rerank copy (the reference's
    declared-but-unimplemented quantized reordering, config.rs:290-318);
    ranking among pre_k candidates survives the calibrated u8 codec."""
    db, q, ds, gt, _ = hybrid_setup
    s8 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="int8",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    dev, norms, n = s8._device_state()
    assert isinstance(dev, tuple) and str(dev[0].dtype) == "uint8"
    assert n == len(db)
    idx, dist = s8.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(idx, gt) >= 0.9
    # returned distances equal the codec-consistent truth: exact distances
    # to the quantize->dequantize'd rows under the RESIDUAL-ANCHORED
    # per-dim codec the tree serves with (utils/reordering.
    # residual_rerank_codec — comparing against unquantized f32 rows would
    # conflate codec error with kernel error)
    from scann_tpu.utils.reordering import residual_rerank_codec

    toks = s8.partitioner.tokenization.tokens
    cents = s8.partitioner.centers
    encode, (scale, mn) = residual_rerank_codec(db, len(db), toks, cents)
    deq = encode(db, toks).astype(np.float32) * scale + mn + cents[toks]
    d_q = ((q[:, None, :] - deq[np.maximum(idx, 0)]) ** 2).sum(-1)
    m = idx >= 0
    np.testing.assert_allclose(dist[m], d_q[m], rtol=1e-3, atol=1e-3)


def test_int8_residual_codec_survives_cluster_spread(rng):
    """Clustered data with cluster spread >> within-cluster noise — the
    production ≥10M shape, and the mechanism behind the measured 3.5pp
    recall@10 loss at 20M: an absolute-step codec
    spends its 256 levels on the cluster SPREAD, so the noise scale that
    separates near-neighbors falls below one quantization step. The
    residual-anchored codec quantizes row - center[token] and must keep
    rerank ranking where the affine codec measurably cannot."""
    from scann_tpu.utils.reordering import rerank_codec, residual_rerank_codec
    from scann_tpu.trees.kmeans import KMeans, KMeansConfig

    n_cl, per, d = 32, 128, 16
    cents = (rng.normal(size=(n_cl, d)) * 100.0).astype(np.float32)
    db = (np.repeat(cents, per, axis=0)
          + rng.normal(size=(n_cl * per, d)).astype(np.float32))
    q = db[rng.choice(len(db), 50, replace=False)] \
        + 0.1 * rng.normal(size=(50, d)).astype(np.float32)

    def rank_fidelity(deq):
        """recall@10 of exact ranking on dequantized rows vs the truth —
        exactly what the rerank stage computes over its candidates."""
        d_est = ((q[:, None, :] - deq[None]) ** 2).sum(-1)
        d_true = ((q[:, None, :] - db[None]) ** 2).sum(-1)
        top_est = np.argsort(d_est, axis=1)[:, :10]
        top_true = np.argsort(d_true, axis=1)[:, :10]
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10.0
                        for a, b in zip(top_est, top_true)])

    res = KMeans(KMeansConfig(num_clusters=n_cl, max_iterations=20,
                              seed=0)).fit(db)
    toks = np.asarray(res.assignments, np.int32)
    encode_r, (sc, mn) = residual_rerank_codec(db, len(db), toks,
                                               res.centers)
    deq_resid = (encode_r(db, toks).astype(np.float32) * sc + mn
                 + res.centers[toks])
    _, encode_a, (sa, ma) = rerank_codec(db, len(db), "int8")
    deq_affine = encode_a(db).astype(np.float32) * sa + ma
    fid_r, fid_a = rank_fidelity(deq_resid), rank_fidelity(deq_affine)
    assert fid_r >= 0.95, f"residual codec fidelity {fid_r}"
    assert fid_r > fid_a + 0.1, (fid_r, fid_a)


def test_int8_rerank_io_roundtrip(hybrid_setup, tmp_path):
    from scann_tpu.io import load_index, save_index

    db, q, ds, gt, _ = hybrid_setup
    s8 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="int8",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(ds)
    path = str(tmp_path / "tree_q8.npz")
    save_index(path, s8)
    s2 = load_index(path)
    assert s2.config.rerank_dtype == "int8"
    i1, d1 = s8.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i2, d2 = s2.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_quantized_reordering_via_facade(hybrid_setup):
    """ExactReorderingConfig.with_quantized() on the Scann facade selects
    the int8 rerank copy (reference declares the knob at config.rs:290-318
    but always re-ranks f32)."""
    from scann_tpu.config import (
        ExactReorderingConfig,
        HashConfig,
        PartitioningConfig,
        ScannConfig,
    )
    from scann_tpu.models.scann import Scann

    db, q, ds, gt, _ = hybrid_setup
    cfg = ScannConfig(
        num_neighbors=10,
        partitioning=PartitioningConfig(num_partitions=32,
                                        num_partitions_to_search=8),
        hash=HashConfig(num_blocks=8, num_buckets=16),
        exact_reordering=ExactReorderingConfig(
            num_candidates=120).with_quantized(),
    )
    s = Scann(ds, cfg)
    assert s._impl.config.rerank_dtype == "int8"
    idx, _ = s.search_batched_arrays(q, 10)
    assert _recall(idx, gt) >= 0.85


def test_build_rerank_store_unaligned_n():
    """Regression: the chunked int8 quantize wrote host[i:i+cs] whose tail
    slice (padding rows) could be longer than the data slice — broadcast
    error whenever n is not a multiple of the row alignment."""
    from scann_tpu.utils.reordering import build_rerank_store

    rng = np.random.default_rng(0)
    data = rng.normal(size=(13, 5)).astype(np.float32)
    (codes, scale, mn), norms = build_rerank_store(data, 13, "int8", 8)
    assert codes.shape[0] == 16  # padded
    # per-dim codec: scale/mn are [D] vectors broadcasting over rows
    deq = (np.asarray(codes[:13]).astype(np.float32) * np.asarray(scale)
           + np.asarray(mn))
    np.testing.assert_allclose(
        np.asarray(norms)[:13], (deq ** 2).sum(-1), rtol=1e-5, atol=1e-5)
    rep16, norms16 = build_rerank_store(data, 13, "bfloat16", 8)
    assert rep16.shape[0] == 16 and str(rep16.dtype) == "bfloat16"


def test_host_gather_build_matches_device_gather(hybrid_setup, monkeypatch):
    """Past _HOST_GATHER_BYTES the build gathers encode chunks on host
    (whole-database device gathers force a full padded-layout copy);
    results must be identical to the device-gather build."""
    import scann_tpu.models.tree_x_hybrid as tx

    db, q, ds, gt, s_dev = hybrid_setup
    monkeypatch.setattr(tx, "_HOST_GATHER_BYTES", 0)
    s_host = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42),
    )).build(DenseDataset(db))
    np.testing.assert_array_equal(s_host.codes, s_dev.codes)
    i1, d1 = s_dev.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i2, d2 = s_host.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(i1, i2)


def test_packed_slab_serving_matches_xla_path(hybrid_setup, monkeypatch):
    """The GPU serving layout (grouped scorer, packed-int4 slab at
    num_codes <= 16, reference layout lut16.rs:43-61) scores the same leaf
    candidates as the CPU's row-major per-pair path (grouped kernel in
    interpret mode), at half the slab bytes, and memory_usage reports the
    packed slab."""
    import jax.numpy as jnp

    from scann_tpu.models import tree_x_hybrid as tx

    db, q, ds, gt, _ = hybrid_setup
    cfg = TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))
    s = TreeXHybridSearcher(cfg).build(DenseDataset(db))
    rows, offs, sizes, _, l_cap = s._csr_state()
    assert rows.shape[1] == 8
    monkeypatch.setattr(s, "_leaf_scorer", lambda: "grouped")
    s._csr_cache = None
    slab, *_ = s._csr_state()
    assert slab.shape == (4, rows.shape[0])     # ceil(8/2) bytes per row
    n_slab = slab.shape[1]
    fixed = (n_slab * 4 + s.partitioner.centers.nbytes
             + s.codebook.centroids.nbytes)
    assert s.memory_usage() == n_slab * 4 + fixed
    qd = jnp.asarray(q[:16])
    cent = s.partitioner.centers_device()
    parts = tx._select_partitions(cent, qd, p=8, approx_min=10 ** 9)
    luts = tx._residual_luts(qd, cent, parts, s.codebook.centroids_device(),
                             s_pad=8, use_residuals=True)
    got, _ = tx.leaf_scores_grouped(luts, parts, slab, offs, sizes, p=8,
                                    l_cap=l_cap, c=16, interpret=True)
    want, _ = tx.leaf_scores_xla(luts.astype(jnp.bfloat16).astype(jnp.float32),
                                 parts, rows, offs, sizes, p=8, l_cap=l_cap,
                                 c=16)
    got = np.asarray(got.astype(jnp.float32))
    want = np.asarray(want)
    m = want < 1e37
    assert np.array_equal(m, got < 1e37)
    np.testing.assert_allclose(got[m], want[m], rtol=2 ** -7, atol=1e-2)


def test_code_slab_unpacked_when_codes_exceed_4_bits(hybrid_setup):
    """code_slab packs only codebooks of at most 16 codes: 256-code
    (8-bit) slabs serve transposed but unpacked, S padded to even, even
    when every stored code happens to fit a nibble."""
    from scann_tpu.models.tree_x_hybrid import code_slab

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(300, 7)).astype(np.uint8)
    slab = code_slab(codes, "grouped", 256)
    assert slab.shape == (8, 300) and slab.dtype == np.uint8
    np.testing.assert_array_equal(slab[:7].T, codes)
    assert not slab[7].any()
    rows = code_slab(codes, "pairs", 256)
    assert rows.shape == (300, 8)
    np.testing.assert_array_equal(rows[:, :7], codes)
    small = (codes % 16).astype(np.uint8)
    assert code_slab(small, "grouped", 256).shape == (8, 300)
    assert code_slab(small, "grouped", 16).shape == (4, 300)


def test_packed_slab_roundtrip_to_row_major(hybrid_setup, monkeypatch):
    """The packed transposed slab reconstructs the exact row-major codes
    the CPU path serves (low nibble = even subspace)."""
    db, q, ds, gt, _ = hybrid_setup
    cfg = TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))
    s = TreeXHybridSearcher(cfg).build(DenseDataset(db))
    rows_want = np.asarray(s._csr_state()[0])
    monkeypatch.setattr(s, "_leaf_scorer", lambda: "grouped")
    s._csr_cache = None
    ct = np.asarray(s._csr_state()[0])
    rows_got = np.empty((ct.shape[1], 2 * ct.shape[0]), np.uint8)
    rows_got[:, 0::2] = (ct & 0xF).T
    rows_got[:, 1::2] = (ct >> 4).T
    np.testing.assert_array_equal(rows_got, rows_want)


def test_keep_best_per_id_unit(rng):
    """Sort-based keep-best-per-id vs a host oracle, including masked
    entries and a payload."""
    import jax.numpy as jnp

    from scann_tpu.ops.topk import keep_best_per_id
    from scann_tpu.types import MASKED_DISTANCE

    b, kp, out_k = 5, 24, 8
    ids = rng.integers(0, 10, size=(b, kp)).astype(np.int32)
    vals = np.sort(rng.random(size=(b, kp)).astype(np.float32), axis=1)
    # mask a few entries the way _finalize does
    mask = rng.random(size=(b, kp)) < 0.2
    vals = np.where(mask, MASKED_DISTANCE, vals).astype(np.float32)
    rows = rng.integers(0, 1000, size=(b, kp)).astype(np.int32)
    v, i, r = keep_best_per_id(jnp.asarray(vals), jnp.asarray(ids), out_k,
                               payload=jnp.asarray(rows))
    v, i, r = np.asarray(v), np.asarray(i), np.asarray(r)
    for row in range(b):
        best = {}
        for j in range(kp):
            if vals[row, j] >= MASKED_DISTANCE / 2:
                continue
            t = int(ids[row, j])
            if t not in best or vals[row, j] < best[t][0]:
                best[t] = (vals[row, j], rows[row, j])
        want = sorted((val, t, pay) for t, (val, pay) in best.items())[:out_k]
        got_valid = [(v[row, j], i[row, j], r[row, j])
                     for j in range(out_k) if i[row, j] >= 0]
        assert len(got_valid) == len(want)
        for (gv, gi, gr), (wv, wi, wr) in zip(got_valid, want):
            assert gi == wi and gr == wr
            np.testing.assert_allclose(gv, wv, rtol=1e-6)
    # missing slots are (MASKED, -1)
    assert ((i >= 0) | (v >= MASKED_DISTANCE / 2)).all()


def test_spill_dedup_matches_legacy_inflation():
    """spill_dedup=True (dedup before the rerank gather) must return the
    same neighbors as the legacy pre_k*multiplicity inflated gather — the
    optimization changes gather width, not results."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(16, 16)).astype(np.float32) * 3.0
    assign = rng.integers(0, 16, size=3000)
    db = (centers[assign] + rng.normal(size=(3000, 16)) * 0.6).astype(np.float32)
    q = (centers[rng.integers(0, 16, size=25)]
         + rng.normal(size=(25, 16)) * 0.6).astype(np.float32)
    ds = DenseDataset(db)

    def build(dedup):
        return TreeXHybridSearcher(TreeXHybridConfig(
            num_partitions=16, partitions_to_search=8,
            spilling=True, spilling_mode="soar", spill_dedup=dedup,
            hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                               seed=3),
        )).build(ds)

    s_new, s_old = build(True), build(False)
    assert s_new.partitioner.tokenization.max_multiplicity > 1
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)

    # at full candidate depth (window covers every probed leaf) both paths
    # rerank the same unique set -> identical results
    deep = SearchParameters(pre_reordering_num_neighbors=10_000)
    i_new, d_new = s_new.search_batched_arrays(q, 10, deep)
    i_old, d_old = s_old.search_batched_arrays(q, 10, deep)
    np.testing.assert_array_equal(i_new, i_old)
    np.testing.assert_allclose(d_new, d_old, rtol=1e-5, atol=1e-5)

    # the dedup path reranks EXACTLY pre_k unique candidates; the legacy
    # path gathers pre_k*mult slots whose unique depth floats between
    # pre_k and pre_k*mult. At EQUAL GATHER WIDTH (new pre_k = legacy
    # pre_k * mult rows gathered) the dedup path must match or beat the
    # legacy recall — every gathered row is a distinct candidate
    i_new, _ = s_new.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i_old, _ = s_old.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=60))
    r_new, r_old = _recall(i_new, gt), _recall(i_old, gt)
    assert r_new >= r_old - 1e-9, (r_new, r_old)
    for row in i_new:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_csr_rerank_store_decode_unit():
    """Id-embedded store digits round-trip ids past the 16- and 24-bit
    digit boundaries exactly (base-256 lanes, bf16-exact)."""
    import jax.numpy as jnp

    from scann_tpu.utils.reordering import (
        build_csr_rerank_store,
        gather_csr_rerank_rows,
    )

    rng = np.random.default_rng(0)
    data = rng.normal(size=(64, 12)).astype(np.float32)
    # perm with ids that exercise multiple digit lanes (simulated: the
    # store encodes data[perm[j]] with id perm[j]; use small data but
    # large FAKE ids by padding the data table index modulo)
    perm = np.array([0, 1, 63, 255, 256, 300] + list(range(6, 64)),
                    np.int32)[:64]
    for dtype in ("float32", "bfloat16"):
        store = build_csr_rerank_store(data, np.clip(perm, 0, 63), dtype)
        rows, ids = gather_csr_rerank_rows(
            store, jnp.arange(64, dtype=jnp.int32)[None, :], data.shape[1])
        np.testing.assert_array_equal(np.asarray(ids)[0],
                                      np.clip(perm, 0, 63))
        np.testing.assert_allclose(
            np.asarray(rows)[0], data[np.clip(perm, 0, 63)],
            rtol=1e-2 if dtype == "bfloat16" else 1e-6, atol=1e-2)

    # digit-lane exactness for large ids, independent of the data table:
    # encode the digits directly through the store builder on a 1-col table
    big = np.array([65535, 65536, 16_777_215, 16_777_216, 2**28 + 12345],
                   np.int64)
    for v in big:
        digits = [(v >> (8 * j)) & 0xFF for j in range(4)]
        back = digits[0] | (digits[1] << 8) | (digits[2] << 16) | (digits[3] << 24)
        assert back == v


def test_csr_rerank_layout_matches_id_layout(hybrid_setup):
    """rerank_layout='csr' (id-embedded store, no perm gather) must return
    IDENTICAL results to the id layout at mult=1 — same codec, same
    candidate sequence, only the gather addressing changes."""
    db, q, ds, gt, _ = hybrid_setup
    for dtype in ("float32", "bfloat16", "int8", "int16"):
        res = {}
        for layout in ("id", "csr"):
            s = TreeXHybridSearcher(TreeXHybridConfig(
                num_partitions=32, partitions_to_search=8,
                rerank_dtype=dtype, rerank_layout=layout,
                hash_config=AsymmetricHasherConfig(
                    num_codes=16, num_subspaces=8, seed=42),
            )).build(ds)
            assert s._rerank_layout() == layout
            res[layout] = s.search_batched_arrays(
                q, 10, SearchParameters(pre_reordering_num_neighbors=120))
        np.testing.assert_array_equal(res["id"][0], res["csr"][0])
        np.testing.assert_allclose(res["id"][1], res["csr"][1],
                                   rtol=1e-5, atol=1e-5)


def test_csr_rerank_layout_auto_policy(hybrid_setup):
    db, q, ds, gt, s = hybrid_setup
    # mult=1: auto takes the csr layout for every dtype (pure win; the
    # anchored codecs reconstruct their centroid from the selection
    # position, no anchor-token gather)
    assert s._rerank_layout() == "csr"
    s8 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="int8",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))).build(ds)
    assert s8._rerank_layout() == "csr"
    with pytest.raises(ScannError):
        TreeXHybridSearcher(TreeXHybridConfig(rerank_layout="banana"))
    # anchored csr store demands its anchor context
    from scann_tpu.utils.reordering import build_csr_rerank_store

    with pytest.raises(ValueError):
        build_csr_rerank_store(db, np.arange(8, dtype=np.int32), "int8")


def test_csr_rerank_layout_soar_spilling():
    """Explicit 'csr' under SOAR: per-assignment store rows, dedup after
    the exact scores — same unique-result invariant, same results as 'id'
    at full candidate depth, auto stays 'id'."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(16, 16)).astype(np.float32) * 3.0
    assign = rng.integers(0, 16, size=3000)
    db = (centers[assign] + rng.normal(size=(3000, 16)) * 0.6).astype(np.float32)
    q = (centers[rng.integers(0, 16, size=25)]
         + rng.normal(size=(25, 16)) * 0.6).astype(np.float32)
    ds = DenseDataset(db)

    def build(layout):
        return TreeXHybridSearcher(TreeXHybridConfig(
            num_partitions=16, partitions_to_search=8,
            spilling=True, spilling_mode="soar", rerank_layout=layout,
            hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                               seed=3),
        )).build(ds)

    s_auto = build(None)
    assert s_auto.partitioner.tokenization.max_multiplicity > 1
    assert s_auto._rerank_layout() == "id"

    s_csr, s_id = build("csr"), build("id")
    deep = SearchParameters(pre_reordering_num_neighbors=10_000)
    i_c, d_c = s_csr.search_batched_arrays(q, 10, deep)
    i_i, d_i = s_id.search_batched_arrays(q, 10, deep)
    np.testing.assert_array_equal(i_c, i_i)
    np.testing.assert_allclose(d_c, d_i, rtol=1e-5, atol=1e-5)
    # results stay unique at normal width
    i_c, _ = s_csr.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    for row in i_c:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_csr_rerank_layout_io_roundtrip(hybrid_setup, tmp_path):
    from scann_tpu.io import load_index, save_index

    db, q, ds, gt, _ = hybrid_setup
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_layout="csr",
        rerank_dtype="bfloat16",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))).build(ds)
    path = str(tmp_path / "tree_csr.npz")
    save_index(path, s)
    s2 = load_index(path)
    assert s2.config.rerank_layout == "csr"
    i1, d1 = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i2, d2 = s2.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_csr_rerank_layout_with_restricts(hybrid_setup):
    """allow_mask queries fall back to the id layout transparently —
    filtered results must honor the mask and match the id-layout build."""
    db, q, ds, gt, s = hybrid_setup
    mask = np.zeros(len(db), dtype=bool)
    mask[: len(db) // 2] = True
    assert s._rerank_layout() == "csr"
    idx, _ = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120),
        allow_mask=mask)
    assert ((idx < len(db) // 2) | (idx == -1)).all()
    s_id = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_layout="id",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))).build(ds)
    idx2, _ = s_id.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120),
        allow_mask=mask)
    np.testing.assert_array_equal(idx, idx2)


def test_int16_rerank_matches_f32(hybrid_setup):
    """rerank_dtype='int16': bf16's byte cost, residual-anchored 65536
    levels — distances must track exact f32 TIGHTER than bf16 (the
    round-5 fidelity study's motivation: bf16 loses 0.55pp in-pool at
    20M, int16's residual step is ~256x finer)."""
    db, q, ds, gt, _ = hybrid_setup
    s16 = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="int16",
        rerank_layout="id",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))).build(ds)
    db_repr, norms, n = s16._device_state()
    assert isinstance(db_repr, tuple) and len(db_repr) == 5
    assert str(db_repr[0].dtype) == "uint16"
    idx, dist = s16.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    assert _recall(idx, gt) >= 0.9
    d_at = ((q[:, None, :] - db[np.maximum(idx, 0)]) ** 2).sum(-1)
    m = idx >= 0
    # tighter than the bf16 test's 2e-2 tolerance by an order of magnitude
    np.testing.assert_allclose(dist[m], d_at[m], rtol=2e-3, atol=2e-3)


def test_int16_rerank_io_roundtrip(hybrid_setup, tmp_path):
    from scann_tpu.io import load_index, save_index

    db, q, ds, gt, _ = hybrid_setup
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8, rerank_dtype="int16",
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=42))).build(ds)
    path = str(tmp_path / "tree_i16.npz")
    save_index(path, s)
    s2 = load_index(path)
    assert s2.config.rerank_dtype == "int16"
    i1, d1 = s.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    i2, d2 = s2.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
