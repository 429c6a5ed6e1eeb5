"""Anisotropic (score-aware) quantization tests — hashes/avq.py.

Extension beyond the reference: the reference trains plain
reconstruction-loss PQ only (src/hashes/codebook.rs:146-202). These tests
pin the AVQ math (loss monotonicity, closed-form update correctness via
loss descent) and measure the deliverable: better MIPS recall at the same
bit budget on heavy-tailed-norm data.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from scann_tpu.hashes.avq import (
    anisotropic_eta,
    avq_encode_kernel,
    avq_refine_kernel,
    unit_directions,
)
from scann_tpu.hashes.codebook import Codebook, CodebookConfig

N, D, S, C = 6000, 64, 32, 16


@pytest.fixture(scope="module")
def heavy_tailed():
    """Vectors with log-normal radial spread — the regime where parallel
    quantization error visibly perturbs inner-product ranking."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x *= np.exp(rng.standard_normal((N, 1)) * 0.5).astype(np.float32)
    q = rng.standard_normal((192, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pq_codebook(heavy_tailed):
    x, _ = heavy_tailed
    return Codebook(CodebookConfig(
        num_codes=C, num_subspaces=S, max_iterations=10, seed=1)).train(x)


def _mips_recall(x, q, centroids, codes, k=10):
    cent = np.asarray(centroids)
    codes = np.asarray(codes)
    rec = cent[np.arange(S), codes].reshape(len(codes), D)
    true = np.argsort(-(q @ x.T), axis=1)[:, :k]
    approx = np.argsort(-(q @ rec.T), axis=1)[:, :k]
    return float(np.mean([len(set(a) & set(t)) / k for a, t in zip(approx, true)]))


def test_eta_formula():
    # Guo et al. 2020: eta = (d-1) T^2 / (1 - T^2)
    assert anisotropic_eta(0.2, 100) == pytest.approx(99 * 0.04 / 0.96)
    assert anisotropic_eta(0.5, 5) == pytest.approx(4 * 0.25 / 0.75)
    # degenerate dims floor at 1 (isotropic)
    assert anisotropic_eta(0.2, 1) == 1.0
    with pytest.raises(ValueError):
        anisotropic_eta(0.0, 100)
    with pytest.raises(ValueError):
        anisotropic_eta(1.0, 100)


def test_refine_reduces_anisotropic_loss(heavy_tailed, pq_codebook):
    x, _ = heavy_tailed
    eta = anisotropic_eta(0.2, D)
    xh = unit_directions(x)
    cent0 = pq_codebook.centroids_device()
    _, _, loss0 = avq_refine_kernel(jnp.asarray(x), xh, cent0, eta, iters=0)
    _, _, loss3 = avq_refine_kernel(jnp.asarray(x), xh, cent0, eta, iters=3)
    _, _, loss8 = avq_refine_kernel(jnp.asarray(x), xh, cent0, eta, iters=8)
    assert float(loss3) < float(loss0)
    assert float(loss8) <= float(loss3) * 1.001  # no divergence


def test_mips_recall_improves(heavy_tailed, pq_codebook):
    """The deliverable: at the same (S x 4-bit) budget AVQ codes rank inner
    products better than reconstruction-loss PQ codes."""
    x, q = heavy_tailed
    eta = anisotropic_eta(0.2, D)
    xh = unit_directions(x)
    cent, codes, _ = avq_refine_kernel(
        jnp.asarray(x), xh, pq_codebook.centroids_device(), eta, iters=8)
    r_pq = _mips_recall(x, q, pq_codebook.centroids, pq_codebook.encode_dataset(x))
    r_avq = _mips_recall(x, q, cent, codes)
    assert r_avq > r_pq, f"AVQ {r_avq} should beat PQ {r_pq}"


def test_encode_matches_training_codes(heavy_tailed, pq_codebook):
    x, _ = heavy_tailed
    eta = anisotropic_eta(0.2, D)
    xh = unit_directions(x)
    cent, codes, _ = avq_refine_kernel(
        jnp.asarray(x), xh, pq_codebook.centroids_device(), eta, iters=4)
    codes_e = avq_encode_kernel(jnp.asarray(x), xh, cent, eta, passes=2)
    agree = float((np.asarray(codes_e) == np.asarray(codes)).mean())
    assert agree > 0.95


def test_encode_chunked_consistency(heavy_tailed, pq_codebook):
    """Chunked encoding (N > chunk_size) must equal single-chunk."""
    x, _ = heavy_tailed
    eta = anisotropic_eta(0.2, D)
    xh = unit_directions(x)
    cent = pq_codebook.centroids_device()
    full = avq_encode_kernel(jnp.asarray(x), xh, cent, eta, chunk_size=8192)
    chunked = avq_encode_kernel(jnp.asarray(x), xh, cent, eta, chunk_size=1024)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(chunked))


def test_zero_rows_degrade_to_plain_pq():
    """Zero-norm points contribute no anisotropic term and must not NaN."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    x[::7] = 0.0
    cb = Codebook(CodebookConfig(num_codes=8, num_subspaces=4,
                                 max_iterations=5, seed=2)).train(x)
    eta = anisotropic_eta(0.3, 16)
    xh = unit_directions(x)
    cent, codes, loss = avq_refine_kernel(
        jnp.asarray(x), xh, cb.centroids_device(), eta, iters=4)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(cent)).all()


def test_codebook_avq_config(heavy_tailed):
    """CodebookConfig.anisotropic_threshold drives both train and encode."""
    x, q = heavy_tailed
    cb = Codebook(CodebookConfig(num_codes=C, num_subspaces=S,
                                 max_iterations=10, seed=1,
                                 anisotropic_threshold=0.2)).train(x)
    assert cb.eta is not None and cb.eta > 1.0
    codes = cb.encode_dataset(x)
    assert codes.shape == (N, S) and codes.dtype == np.uint8
    plain = Codebook(CodebookConfig(num_codes=C, num_subspaces=S,
                                    max_iterations=10, seed=1)).train(x)
    r_avq = _mips_recall(x, q, cb.centroids, codes)
    r_pq = _mips_recall(x, q, plain.centroids, plain.encode_dataset(x))
    assert r_avq > r_pq


def test_hasher_mips_integration(heavy_tailed):
    """AsymmetricHasher(anisotropic_threshold=...) end to end under MIPS:
    approximate-only search (no re-rank, codes carry the ranking)."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.ops.distances import DistanceMeasure

    x, q = heavy_tailed
    ds = DenseDataset(x)
    gt, _ = BruteForceSearcher(ds, DistanceMeasure.DOT_PRODUCT).search_batched_arrays(q, 10)

    def recall(h):
        idx, _ = h.search_batched_arrays(q, 10)
        return float(np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)]))

    base = dict(num_codes=C, num_subspaces=S, seed=1, max_iterations=10,
                distance_measure=DistanceMeasure.DOT_PRODUCT)
    r_pq = recall(AsymmetricHasher(AsymmetricHasherConfig(**base)).build(ds))
    r_avq = recall(AsymmetricHasher(AsymmetricHasherConfig(
        **base, anisotropic_threshold=0.2)).build(ds))
    assert r_avq > r_pq, f"AVQ {r_avq} should beat PQ {r_pq}"


def test_tree_ah_avq_builds_and_searches(heavy_tailed):
    """Tree-×-AH with AVQ residual codes: directions come from the ORIGINAL
    points; pipeline must hold recall with exact re-rank enabled."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
    from scann_tpu.ops.distances import DistanceMeasure

    x, q = heavy_tailed
    q = q[:64]
    ds = DenseDataset(x)
    gt, _ = BruteForceSearcher(ds, DistanceMeasure.DOT_PRODUCT).search_batched_arrays(q, 10)

    def recall(threshold):
        s = TreeXHybridSearcher(TreeXHybridConfig(
            num_partitions=64, partitions_to_search=32,
            distance_measure=DistanceMeasure.DOT_PRODUCT,
            hash_config=AsymmetricHasherConfig(
                num_codes=16, num_subspaces=S, seed=1, max_iterations=8,
                distance_measure=DistanceMeasure.DOT_PRODUCT,
                anisotropic_threshold=threshold))).build(ds)
        idx, _ = s.search_batched_arrays(
            q, 10, params=SearchParameters(pre_reordering_num_neighbors=60))
        return float(np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)]))

    r_avq = recall(0.2)
    # on this data recall is capped by MIPS partition selection (large-norm
    # true neighbors scatter across L2 partitions), not code quality — AVQ
    # must not LOSE to plain PQ, and the exact re-rank floor must hold
    assert r_avq >= recall(None) - 1e-9
    assert r_avq > 0.4


def test_scann_facade_threads_anisotropic(heavy_tailed):
    """ScannConfig.hash.anisotropic_threshold reaches the trained codebook
    (facade knob parity: nothing may be silently dropped)."""
    from scann_tpu.config import ScannConfig
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.models.scann import Scann
    from scann_tpu.ops.distances import DistanceMeasure

    x, _ = heavy_tailed
    cfg = ScannConfig(num_neighbors=10,
                      distance_measure=DistanceMeasure.DOT_PRODUCT).with_hashing()
    cfg.hash.num_buckets = 16
    cfg.hash.num_blocks = S
    cfg.hash.anisotropic_threshold = 0.2
    s = Scann(DenseDataset(x[:2000]), cfg)
    assert s._impl.codebook.eta is not None and s._impl.codebook.eta > 1.0


def test_avq_io_roundtrip(tmp_path, heavy_tailed):
    """save/load preserves score-aware encoding (eta restored for future
    re-encodes)."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
    from scann_tpu.io import load_index, save_index
    from scann_tpu.ops.distances import DistanceMeasure

    x, q = heavy_tailed
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=C, num_subspaces=S, seed=1, max_iterations=8,
        distance_measure=DistanceMeasure.DOT_PRODUCT,
        anisotropic_threshold=0.2)).build(DenseDataset(x))
    path = str(tmp_path / "avq_index.npz")
    save_index(path, h)
    h2 = load_index(path)
    assert h2.codebook.eta == pytest.approx(h.codebook.eta)
    i1, d1 = h.search_batched_arrays(q[:16], 10)
    i2, d2 = h2.search_batched_arrays(q[:16], 10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
