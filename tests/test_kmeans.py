"""On-device k-means: recovers synthetic clusters, convergence, empty-cluster
reseed, restarts, determinism (reference test analog: src/trees/kmeans.rs:434-519)."""

import numpy as np
import pytest

from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit
from scann_tpu import ScannError


def test_recovers_well_separated_clusters(clustered_data):
    pts, centers, assign = clustered_data
    km = KMeans(KMeansConfig(num_clusters=8, seed=42))
    res = km.fit(pts)
    assert res.centers.shape == (8, pts.shape[1])
    assert res.converged
    # every found center should be near a true center
    d = ((res.centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assert d.min(axis=1).max() < 1.0
    # points in the same true cluster share a label
    for c in range(8):
        labels = res.assignments[assign == c]
        assert len(set(labels.tolist())) == 1


def test_inertia_decreases_with_more_clusters(rng):
    pts = rng.normal(size=(300, 16)).astype(np.float32)
    i2 = KMeans(KMeansConfig(num_clusters=2, seed=1)).fit(pts).inertia
    i20 = KMeans(KMeansConfig(num_clusters=20, seed=1)).fit(pts).inertia
    assert i20 < i2


def test_cluster_sizes_sum_to_n(rng):
    pts = rng.normal(size=(200, 8)).astype(np.float32)
    res = KMeans(KMeansConfig(num_clusters=10, seed=3)).fit(pts)
    assert res.cluster_sizes.sum() == 200
    assert res.assignments.shape == (200,)
    assert (res.assignments >= 0).all() and (res.assignments < 10).all()


def test_k_clamped_to_n(rng):
    pts = rng.normal(size=(5, 4)).astype(np.float32)
    res = KMeans(KMeansConfig(num_clusters=50, seed=0)).fit(pts)
    assert res.centers.shape[0] == 5


def test_seed_determinism(rng):
    pts = rng.normal(size=(128, 8)).astype(np.float32)
    r1 = KMeans(KMeansConfig(num_clusters=6, seed=42)).fit(pts)
    r2 = KMeans(KMeansConfig(num_clusters=6, seed=42)).fit(pts)
    np.testing.assert_array_equal(r1.assignments, r2.assignments)
    np.testing.assert_allclose(r1.centers, r2.centers, rtol=1e-6)


def test_random_init(rng):
    pts = rng.normal(size=(100, 8)).astype(np.float32)
    res = KMeans(KMeansConfig(num_clusters=5, seed=7, init_method=KMeansInit.RANDOM)).fit(pts)
    assert res.centers.shape == (5, 8)
    assert np.isfinite(res.inertia)


def test_restarts_pick_best(rng):
    pts = rng.normal(size=(150, 8)).astype(np.float32)
    r1 = KMeans(KMeansConfig(num_clusters=8, seed=5, num_restarts=1)).fit(pts)
    r5 = KMeans(KMeansConfig(num_clusters=8, seed=5, num_restarts=5)).fit(pts)
    assert r5.inertia <= r1.inertia + 1e-3


def test_duplicate_points_no_crash():
    pts = np.ones((20, 4), dtype=np.float32)
    res = KMeans(KMeansConfig(num_clusters=4, seed=0)).fit(pts)
    assert res.cluster_sizes.sum() == 20
    assert np.isfinite(res.inertia)


def test_empty_dataset_rejected():
    with pytest.raises(ScannError):
        KMeans(KMeansConfig(num_clusters=2)).fit(np.zeros((0, 4), dtype=np.float32))


def test_provided_init_requires_centers(rng):
    pts = rng.normal(size=(50, 4)).astype(np.float32)
    with pytest.raises(ScannError):
        KMeans(KMeansConfig(num_clusters=2, init_method=KMeansInit.PROVIDED)).fit(pts)
    centers = pts[:2].copy()
    res = KMeans(KMeansConfig(num_clusters=2, init_method=KMeansInit.PROVIDED, seed=0)).fit(
        pts, init_centers=centers
    )
    assert res.centers.shape == (2, 4)


def test_lloyd_step_sliced_matches_single_program(rng):
    """Host-sliced Lloyd (for device arrays whose single-program pad copy
    would not fit device memory — a ~8 GB duplicate at 20M x 100d) must be
    numerically equivalent to the one-program step."""
    import jax.numpy as jnp

    from scann_tpu.trees.kmeans import _lloyd_step, lloyd_step_sliced

    data = jnp.asarray(rng.normal(size=(5000, 24)).astype(np.float32))
    centers = jnp.asarray(rng.normal(size=(16, 24)).astype(np.float32))
    c1, i1 = _lloyd_step(data, centers, k=16)
    c2, i2 = lloyd_step_sliced(data, centers, k=16, rows=1024)  # 5 slices
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(i1), float(i2), rtol=1e-4)


def test_provided_init_centers_shape_validated():
    import numpy as np
    import pytest

    from scann_tpu.errors import ScannError
    from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit

    rng = np.random.default_rng(3)
    data = rng.normal(size=(100, 8)).astype(np.float32)
    km = KMeans(KMeansConfig(num_clusters=4, init_method=KMeansInit.PROVIDED))
    with pytest.raises(ScannError):
        km.fit(data, init_centers=rng.normal(size=(6, 8)).astype(np.float32))
    with pytest.raises(ScannError):
        km.fit(data, init_centers=rng.normal(size=(4, 7)).astype(np.float32))
    res = km.fit(data, init_centers=data[:4].copy())
    assert res.centers.shape == (4, 8)
