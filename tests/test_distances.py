"""Distance-measure semantics vs hand-computed fixtures and a numpy oracle.

Mirrors the reference's inline distance tests
(reference: src/distance_measures/one_to_one.rs:659-743) plus differential
tests of the matmul path against a straightforward numpy implementation —
the device analog of the reference's SIMD-vs-portable parity tests
(reference: src/distance_measures/one_to_many_asymmetric.rs:489-543).
"""

import numpy as np
import pytest

from scann_tpu.ops.distances import (
    DistanceMeasure,
    dice_distance_sparse,
    jaccard_distance_sparse,
    many_to_many,
    mask_padded_rows,
    non_zero_intersect_sparse,
    one_to_one,
)

A = np.array([1.0, 2.0, 3.0], dtype=np.float32)
B = np.array([4.0, 5.0, 6.0], dtype=np.float32)


def test_l1_known():
    assert abs(float(one_to_one(DistanceMeasure.L1, A, B)) - 9.0) < 1e-5


def test_squared_l2_known():
    assert abs(float(one_to_one(DistanceMeasure.SQUARED_L2, A, B)) - 27.0) < 1e-4


def test_l2_known():
    assert abs(float(one_to_one(DistanceMeasure.L2, A, B)) - np.sqrt(27.0)) < 1e-4


def test_dot_is_negated():
    # similarity search convention: lower = closer
    assert abs(float(one_to_one(DistanceMeasure.DOT_PRODUCT, A, B)) - (-32.0)) < 1e-4
    assert abs(float(one_to_one(DistanceMeasure.GENERAL_INNER_PRODUCT, A, B)) - (-32.0)) < 1e-4


def test_cosine_distance():
    sim = 32.0 / (np.linalg.norm(A) * np.linalg.norm(B))
    assert abs(float(one_to_one(DistanceMeasure.COSINE, A, B)) - (1.0 - sim)) < 1e-5


def test_cosine_zero_norm():
    z = np.zeros(3, dtype=np.float32)
    assert abs(float(one_to_one(DistanceMeasure.COSINE, z, B)) - 1.0) < 1e-6


def test_limited_inner_product():
    small_a = A / 10.0
    small_b = B / 10.0
    d = float(one_to_one(DistanceMeasure.LIMITED_INNER_PRODUCT, small_a, small_b))
    assert abs(d - (-float(np.dot(small_a, small_b)))) < 1e-5
    assert np.isinf(float(one_to_one(DistanceMeasure.LIMITED_INNER_PRODUCT, A, B)))


def test_hamming_dense():
    x = np.array([1.0, 0.0, 1.0, 1.0], dtype=np.float32)
    y = np.array([1.0, 1.0, 0.0, 1.0], dtype=np.float32)
    assert float(one_to_one(DistanceMeasure.HAMMING, x, y)) == 2.0


def test_non_zero_intersect_dense():
    x = np.array([1.0, 0.0, 2.0, 3.0], dtype=np.float32)
    y = np.array([5.0, 1.0, 0.0, 2.0], dtype=np.float32)
    assert float(one_to_one(DistanceMeasure.NON_ZERO_INTERSECT, x, y)) == -2.0


def test_sparse_set_distances():
    assert jaccard_distance_sparse([0, 1, 2], [1, 2, 3]) == pytest.approx(1 - 2 / 4)
    assert dice_distance_sparse([0, 1, 2], [1, 2, 3]) == pytest.approx(1 - 4 / 6)
    assert non_zero_intersect_sparse([0, 1, 2], [1, 2, 3]) == -2.0
    assert jaccard_distance_sparse([], []) == 0.0


@pytest.mark.parametrize(
    "measure",
    [
        DistanceMeasure.SQUARED_L2,
        DistanceMeasure.L2,
        DistanceMeasure.COSINE,
        DistanceMeasure.DOT_PRODUCT,
        DistanceMeasure.L1,
    ],
)
def test_many_to_many_vs_numpy_oracle(rng, measure):
    q = rng.normal(size=(7, 24)).astype(np.float32)
    db = rng.normal(size=(100, 24)).astype(np.float32)
    got = np.asarray(many_to_many(measure, q, db))

    if measure == DistanceMeasure.SQUARED_L2:
        want = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    elif measure == DistanceMeasure.L2:
        want = np.sqrt(((q[:, None, :] - db[None, :, :]) ** 2).sum(-1))
    elif measure == DistanceMeasure.COSINE:
        want = 1 - (q @ db.T) / (
            np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(db, axis=1)[None, :]
        )
    elif measure == DistanceMeasure.DOT_PRODUCT:
        want = -(q @ db.T)
    else:
        want = np.abs(q[:, None, :] - db[None, :, :]).sum(-1)

    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_l1_chunking_edges(rng):
    # chunk_size not dividing N exercises the padding path
    q = rng.normal(size=(3, 8)).astype(np.float32)
    db = rng.normal(size=(37, 8)).astype(np.float32)
    got = np.asarray(many_to_many(DistanceMeasure.L1, q, db, chunk_size=16))
    want = np.abs(q[:, None, :] - db[None, :, :]).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mask_padded_rows():
    d = np.zeros((2, 10), dtype=np.float32)
    out = np.asarray(mask_padded_rows(d, 7, 99.0))
    assert (out[:, :7] == 0).all() and (out[:, 7:] == 99.0).all()
