"""PQ codebook, LUT semantics, LUT16 packing byte-compat, hasher search
(reference test analogs: src/hashes/codebook.rs tests, lut16.rs:312-366
packing round-trip, lut16_simd.rs:377-411 SIMD-vs-scalar parity)."""

import numpy as np
import pytest

from scann_tpu import BruteForceSearcher, DenseDataset, ScannError, SearchParameters
from scann_tpu.hashes import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
    Codebook,
    CodebookConfig,
    LookupTable,
    Lut16SimdTables,
    PackedCodes4Bit,
)
from scann_tpu.hashes.lut16 import pack_codes_4bit, unpack_codes_4bit
from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.ops.lut16_scoring import lut_score, lut_score_gathered

import jax.numpy as jnp


# ---------------------------------------------------------------- packing


def test_pack_unpack_round_trip(rng):
    codes = rng.integers(0, 16, size=(50, 16)).astype(np.uint8)
    packed = pack_codes_4bit(codes)
    assert packed.shape == (50, 8)
    np.testing.assert_array_equal(unpack_codes_4bit(packed, 16), codes)


def test_pack_low_nibble_first():
    """byte = lo | (hi << 4) (reference: lut16.rs:43-61)."""
    codes = np.array([[0x3, 0xA]], dtype=np.uint8)
    packed = pack_codes_4bit(codes)
    assert packed[0, 0] == 0x3 | (0xA << 4) == 0xA3


def test_pack_odd_subspaces():
    codes = np.array([[1, 2, 3]], dtype=np.uint8)
    packed = pack_codes_4bit(codes)
    assert packed.shape == (1, 2)
    assert packed[0, 1] == 3  # final high nibble zero
    np.testing.assert_array_equal(unpack_codes_4bit(packed, 3), codes)


def test_packed_codes_class(rng):
    codes = rng.integers(0, 16, size=(20, 8)).astype(np.uint8)
    pc = PackedCodes4Bit.from_codes(codes)
    assert pc.bytes_per_point == 4
    np.testing.assert_array_equal(pc.get_codes(7), codes[7])
    np.testing.assert_array_equal(pc.unpack_all(), codes)


def test_pack_rejects_large_codes():
    with pytest.raises(ScannError):
        pack_codes_4bit(np.array([[16]], dtype=np.uint8))


# ---------------------------------------------------------------- codebook


def test_codebook_train_encode_decode(rng):
    data = rng.normal(size=(500, 32)).astype(np.float32)
    cb = Codebook(CodebookConfig(num_codes=16, num_subspaces=8, seed=42)).train(data)
    assert cb.centroids.shape == (8, 16, 4)
    codes = cb.encode_dataset(data)
    assert codes.shape == (500, 8) and codes.dtype == np.uint8
    assert codes.max() < 16
    rec = cb.decode(codes)
    assert rec.shape == (500, 32)
    # reconstruction beats the null model (predicting the mean)
    err = ((rec - data) ** 2).sum(-1).mean()
    null = ((data - data.mean(0)) ** 2).sum(-1).mean()
    assert err < null


def test_codebook_divisibility_check(rng):
    with pytest.raises(ScannError):
        Codebook(CodebookConfig(num_subspaces=7)).train(
            rng.normal(size=(50, 32)).astype(np.float32)
        )


def test_encode_is_nearest_centroid(rng):
    data = rng.normal(size=(100, 8)).astype(np.float32)
    cb = Codebook(CodebookConfig(num_codes=8, num_subspaces=2, seed=1)).train(data)
    codes = cb.encode_dataset(data)
    # verify argmin for subspace 0 on a few points
    sub = data[:, :4]
    d = ((sub[:, None, :] - cb.centroids[0][None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(codes[:, 0], d.argmin(1).astype(np.uint8))


# ---------------------------------------------------------------- LUTs


def test_lookup_table_matches_bruteforce_sum(rng):
    data = rng.normal(size=(200, 16)).astype(np.float32)
    cb = Codebook(CodebookConfig(num_codes=16, num_subspaces=4, seed=3)).train(data)
    q = rng.normal(size=16).astype(np.float32)
    lut = LookupTable.from_query(cb, q)
    codes = cb.encode_dataset(data)
    # LUT distance == squared L2 to the reconstruction
    rec = cb.decode(codes[:5])
    want = ((q[None, :] - rec) ** 2).sum(-1)
    got = lut.compute_distances_batch(codes[:5])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_int8_lut_quantization(rng):
    tables = rng.uniform(1.0, 9.0, size=(4, 16)).astype(np.float32)
    lut = LookupTable(tables)
    lut8 = lut.to_int8()
    codes = rng.integers(0, 16, size=4)
    exact = lut.compute_distance(codes)
    approx = lut8.compute_distance(codes)
    # u8 quantization error bounded by S * range/255
    assert abs(exact - approx) <= 4 * (9.0 - 1.0) / 255 * 1.5


def test_lut16_simd_tables_codec(rng):
    tables = rng.uniform(0.0, 5.0, size=(8, 16)).astype(np.float32)
    st = Lut16SimdTables.from_float_tables(tables)
    assert st.packed_tables.shape == (8, 16)
    codes = rng.integers(0, 16, size=(30, 8)).astype(np.uint8)
    packed = pack_codes_4bit(codes)
    got = st.compute_distances_batch(packed, 30)
    want = tables[np.arange(8)[None, :], codes.astype(int)].sum(1)
    np.testing.assert_allclose(got, want, atol=8 * 5.0 / 255 * 1.5)


# ---------------------------------------------------------------- device scoring


@pytest.mark.parametrize("num_codes", [16, 256])
def test_lut_score_matches_host(rng, num_codes):
    b, s, n = 5, 8, 300
    luts = rng.uniform(0, 4, size=(b, s, num_codes)).astype(np.float32)
    codes = rng.integers(0, num_codes, size=(n, s)).astype(np.uint8)
    got = np.asarray(lut_score(jnp.asarray(luts), jnp.asarray(codes)))
    want = luts[:, np.arange(s)[None, :], codes.astype(int)].sum(-1)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


def test_lut_score_chunked_equals_direct(rng):
    luts = rng.uniform(0, 4, size=(3, 4, 16)).astype(np.float32)
    codes = rng.integers(0, 16, size=(100, 4)).astype(np.uint8)
    a = np.asarray(lut_score(jnp.asarray(luts), jnp.asarray(codes), chunk_size=32))
    b = np.asarray(lut_score(jnp.asarray(luts), jnp.asarray(codes), chunk_size=100000))
    np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("num_codes", [16, 256])
def test_lut_score_gathered_matches_host(rng, num_codes):
    b, t, s = 4, 20, 8
    luts = rng.uniform(0, 4, size=(b, s, num_codes)).astype(np.float32)
    codes = rng.integers(0, num_codes, size=(b, t, s)).astype(np.uint8)
    got = np.asarray(lut_score_gathered(jnp.asarray(luts), jnp.asarray(codes)))
    want = np.zeros((b, t), np.float32)
    for bi in range(b):
        want[bi] = luts[bi, np.arange(s)[None, :], codes[bi].astype(int)].sum(-1)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


# ---------------------------------------------------------------- hasher


def test_hasher_search_recall(rng):
    db = rng.normal(size=(2000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    h = AsymmetricHasher(AsymmetricHasherConfig(num_codes=16, num_subspaces=16, seed=42))
    h.build(ds)
    idx, dist = h.search_batched_arrays(q, 10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, gt)])
    assert recall >= 0.5  # approximate-only; reference gets ~0.32 at 8 blocks
    assert (np.diff(dist, axis=1) >= -1e-4).all()


def test_hasher_reordering_improves_recall(rng):
    db = rng.normal(size=(2000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    h = AsymmetricHasher(AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42))
    h.build(ds)
    plain_idx, _ = h.search_batched_arrays(q, 10)
    re_idx, re_dist = h.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=300)
    )
    r_plain = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(plain_idx, gt)])
    r_re = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(re_idx, gt)])
    assert r_re > r_plain
    # iid gaussian is PQ's worst case; 300/2000 candidates re-ranked exactly
    assert r_re >= 0.85
    # re-ranked distances are exact
    d = ((q[:, None, :] - db[re_idx]) ** 2).sum(-1)
    np.testing.assert_allclose(re_dist, d, rtol=1e-3, atol=1e-3)


def test_hasher_search_with_reordering_api(rng):
    db = rng.normal(size=(500, 16)).astype(np.float32)
    ds = DenseDataset(db)
    h = AsymmetricHasher(AsymmetricHasherConfig(num_codes=16, num_subspaces=4, seed=0))
    h.build(ds)
    res = h.search_with_reordering(db[42], k=1, pre_reorder_k=50)
    assert res.neighbors[0].index == 42


def test_hasher_packed_memory(rng):
    db = rng.normal(size=(256, 16)).astype(np.float32)
    h = AsymmetricHasher(AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=0))
    h.build(DenseDataset(db))
    assert h.packed is not None
    assert h.memory_usage() == 256 * 4  # 8 subspaces packed 2/byte


def test_hasher_unbuilt_rejected():
    with pytest.raises(ScannError):
        AsymmetricHasher().search(np.zeros(8, np.float32), 1)


def test_hasher_cosine_and_mips(rng):
    """AsymmetricHasher measure support (extension — the reference
    hardcodes SquaredL2, hasher.rs:208): cosine via build/search
    normalization, MIPS via -dot LUTs."""
    n, d, b, k = 4000, 32, 24, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    db *= rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ds = DenseDataset(db)
    for measure in (DistanceMeasure.COSINE, DistanceMeasure.DOT_PRODUCT):
        gt, gtd = BruteForceSearcher(ds, measure).search_batched_arrays(q, k)
        h = AsymmetricHasher(AsymmetricHasherConfig(
            num_codes=16, num_subspaces=16, seed=0, max_iterations=8,
            distance_measure=measure)).build(ds)
        idx, dist = h.search_batched_arrays(
            q, k, SearchParameters(pre_reordering_num_neighbors=300))
        recall = np.mean([len(set(a) & set(g)) / k
                          for a, g in zip(np.asarray(idx), np.asarray(gt))])
        assert recall >= 0.9, (measure, recall)
        hit = np.asarray(idx) == np.asarray(gt)
        np.testing.assert_allclose(np.asarray(dist)[hit],
                                   np.asarray(gtd)[hit], rtol=1e-3, atol=1e-3)


def test_hasher_rejects_unsupported_measure(rng):
    db = rng.normal(size=(100, 8)).astype(np.float32)
    with pytest.raises(ScannError):
        AsymmetricHasher(AsymmetricHasherConfig(
            num_codes=16, num_subspaces=4,
            distance_measure=DistanceMeasure.L1)).build(DenseDataset(db))


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_hasher_low_precision_rerank(rng, rdt):
    """AsymmetricHasherConfig.rerank_dtype: the exact re-rank gathers from
    a low-precision copy (same HBM lever as tree-AH / block-sweep); recall
    must hold and the io round-trip must carry the dtype."""
    db = rng.normal(size=(2000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    ds = DenseDataset(db)
    gt, _ = BruteForceSearcher(ds).search_batched_arrays(q, 10)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, seed=42, rerank_dtype=rdt)).build(ds)
    rep, norms = h._rerank_state()
    if rdt == "int8":
        assert isinstance(rep, tuple) and str(rep[0].dtype) == "uint8"
    else:
        assert str(rep.dtype) == "bfloat16"
    idx, dist = h.search_batched_arrays(
        q, 10, SearchParameters(pre_reordering_num_neighbors=300))
    r = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, gt)])
    assert r >= 0.8, (rdt, r)
    import tempfile

    from scann_tpu.io import load_index, save_index

    with tempfile.TemporaryDirectory() as td:
        save_index(td + "/h.npz", h)
        h2 = load_index(td + "/h.npz")
        assert h2.config.rerank_dtype == rdt
        i2, d2 = h2.search_batched_arrays(
            q, 10, SearchParameters(pre_reordering_num_neighbors=300))
        np.testing.assert_array_equal(idx, i2)


def test_hasher_rerank_dtype_validated():
    with pytest.raises(Exception):
        AsymmetricHasher(AsymmetricHasherConfig(rerank_dtype="float16"))


def test_hasher_reordering_pre_k_below_k_clamped(rng):
    """search_with_reordering(pre_reorder_k < k) must clamp the candidate
    width up to k instead of crashing the exact stage's top-k."""
    db = rng.normal(size=(500, 16)).astype(np.float32)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=4, seed=2)).build(DenseDataset(db))
    res = h.search_with_reordering(db[7], k=50, pre_reorder_k=10)
    assert len(res.neighbors) == 50
    assert res.neighbors[0].index == 7
