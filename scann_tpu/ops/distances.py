"""Batched distance computation as matrix-product programs.

The reference computes distances with AVX2 one-to-many loops that keep the
query in registers and stream database rows (reference:
src/simd/x86.rs:194-346, src/distance_measures/one_to_many.rs:228-255,
src/distance_measures/many_to_many.rs:301-373). On a device the same
computation is a single matrix product:

    squared_l2(Q, D) = ||q||^2 + ||d||^2 - 2 Q @ D^T

with the elementwise norm/score transforms fused by XLA. The batch dimension
is first-class — there is no separate "one-to-many" hot loop; ``one_to_many``
is ``many_to_many`` with B=1.

Distance sign conventions match the reference exactly
(reference: src/distance_measures/mod.rs:70-116, one_to_one.rs:464-469 negated
dot product, :605-612 cosine distance = 1 - similarity, :636-657 limited /
general inner product).
"""

from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp


class DistanceMeasure(enum.Enum):
    """The 11 distance measures of the reference (reference:
    src/distance_measures/mod.rs:32-66), plus its two free sparse measures
    (sparse.rs:101-196) promoted to enum members."""

    L1 = "L1"
    L2 = "L2"
    SQUARED_L2 = "SquaredL2"
    COSINE = "Cosine"
    DOT_PRODUCT = "DotProduct"
    HAMMING = "Hamming"
    LIMITED_INNER_PRODUCT = "LimitedInnerProduct"
    GENERAL_INNER_PRODUCT = "GeneralInnerProduct"
    JACCARD = "Jaccard"
    NON_ZERO_INTERSECT = "NonZeroIntersect"
    DICE = "Dice"
    # the reference also ships these two as free sparse functions OUTSIDE
    # its DistanceMeasure enum (reference: src/distance_measures/sparse.rs:
    # 101-147 weighted_jaccard_distance, :178-196 overlap_coefficient_sparse);
    # here they are first-class measures the sparse searcher serves
    WEIGHTED_JACCARD = "WeightedJaccard"
    OVERLAP = "Overlap"

    @property
    def is_matmul_friendly(self) -> bool:
        """True when the [B,N] distance matrix reduces to one matmul."""
        return self in (
            DistanceMeasure.SQUARED_L2,
            DistanceMeasure.L2,
            DistanceMeasure.COSINE,
            DistanceMeasure.DOT_PRODUCT,
            DistanceMeasure.GENERAL_INNER_PRODUCT,
            DistanceMeasure.LIMITED_INNER_PRODUCT,
            # Dense Jaccard/Dice fall back to squared L2 in the reference
            # (reference: src/distance_measures/mod.rs:85-92,108-114).
            DistanceMeasure.JACCARD,
            DistanceMeasure.DICE,
        )


def approx_to_measure_units(approx: jnp.ndarray, measure: DistanceMeasure) -> jnp.ndarray:
    """Convert approximate (LUT / sweep) scores to the measure's own units.

    COSINE approximate scoring runs as squared L2 over unit vectors, which is
    ``2 * (1 - sim)`` — exactly twice the cosine distance the exact stages
    return. Halving keeps per-query epsilon thresholds (reference:
    src/brute_force/top_k.rs:263-393, one unit system across approximate and
    exact passes) and returned approximate distances consistent with the
    exact path. Identity for every other measure (MIPS LUTs already score
    -dot; L2 LUTs are already squared-L2).

    Design note: the conversion deliberately lives HERE, at the
    output/epsilon boundary, not at LUT construction. The internal
    approximate unit is "squared L2 on normalized vectors" uniformly
    across ALL kernel families — LUT paths and the bf16 block sweep alike
    (the sweep scores -cos and converts with its own affine,
    ops/sweep_pallas.py) — so halving only the LUT tables would leave two
    kernel families in different internal units and every merge/compare
    between them wrong. One internal unit + one boundary conversion is the
    invariant; every scoring kernel must call this before comparing
    against user epsilons or returning approximate values.
    """
    if measure == DistanceMeasure.COSINE:
        return approx * 0.5
    return approx


def squared_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise squared L2 norms, f32 accumulation."""
    x = x.astype(jnp.float32)
    return jnp.sum(x * x, axis=-1)


def _cross_dot(
    queries: jnp.ndarray, db: jnp.ndarray, precision=jax.lax.Precision.HIGHEST
) -> jnp.ndarray:
    """[B,D] x [N,D] -> [B,N] dot products.

    Exact search uses HIGHEST precision (true f32: without it an NVIDIA GPU
    may run the product in TF32); approximate scoring paths pass a lower
    precision explicitly.
    """
    return jax.lax.dot_general(
        queries,
        db,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def many_to_many(
    measure: DistanceMeasure,
    queries: jnp.ndarray,
    db: jnp.ndarray,
    db_sq_norms: Optional[jnp.ndarray] = None,
    chunk_size: int = 4096,
) -> jnp.ndarray:
    """Distance matrix [B, N] between ``queries`` [B, D] and ``db`` [N, D].

    Matmul-friendly measures run as one matmul plus a fused score
    transform; L1/Hamming (no bilinear form) stream the database in chunks so
    the broadcasted [B, chunk, D] intermediate stays on-chip.
    """
    queries = queries.astype(jnp.float32)
    db = db.astype(jnp.float32)

    if measure in (DistanceMeasure.L1, DistanceMeasure.HAMMING, DistanceMeasure.NON_ZERO_INTERSECT):
        return _chunked_elementwise(measure, queries, db, chunk_size)

    dots = _cross_dot(queries, db)

    if measure in (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT):
        return -dots

    if db_sq_norms is None:
        db_sq_norms = squared_norms(db)
    q_sq_norms = squared_norms(queries)

    if measure in (DistanceMeasure.SQUARED_L2, DistanceMeasure.JACCARD, DistanceMeasure.DICE):
        d = q_sq_norms[:, None] + db_sq_norms[None, :] - 2.0 * dots
        return jnp.maximum(d, 0.0)

    if measure == DistanceMeasure.L2:
        d = q_sq_norms[:, None] + db_sq_norms[None, :] - 2.0 * dots
        return jnp.sqrt(jnp.maximum(d, 0.0))

    if measure == DistanceMeasure.COSINE:
        # 1 - dot / (|q| |d|); zero-norm rows get similarity 0 -> distance 1
        # (reference: src/distance_measures/one_to_one.rs:596-612).
        denom = jnp.sqrt(q_sq_norms)[:, None] * jnp.sqrt(db_sq_norms)[None, :]
        sim = jnp.where(denom > 0.0, dots / jnp.maximum(denom, 1e-30), 0.0)
        return 1.0 - sim

    if measure == DistanceMeasure.LIMITED_INNER_PRODUCT:
        # +inf when either vector has squared norm > 1
        # (reference: src/distance_measures/one_to_one.rs:636-648).
        bad = (q_sq_norms[:, None] > 1.0) | (db_sq_norms[None, :] > 1.0)
        return jnp.where(bad, jnp.inf, -dots)

    raise NotImplementedError(f"many_to_many for {measure}")


def _chunked_elementwise(
    measure: DistanceMeasure,
    queries: jnp.ndarray,
    db: jnp.ndarray,
    chunk_size: int,
) -> jnp.ndarray:
    """L1 / Hamming / dense NonZeroIntersect: scan over database chunks.

    These have no bilinear form, so we materialize [B, chunk, D] diffs one
    chunk at a time (VPU work, HBM traffic = one database read, like the
    matmul path).
    """
    n = db.shape[0]
    chunk_size = min(chunk_size, max(n, 1))
    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    if n_pad != n:
        db = jnp.pad(db, ((0, n_pad - n), (0, 0)))
    db_chunks = db.reshape(n_chunks, chunk_size, -1)

    if measure == DistanceMeasure.L1:
        fn = lambda c: jnp.sum(jnp.abs(queries[:, None, :] - c[None, :, :]), axis=-1)
    elif measure == DistanceMeasure.HAMMING:
        # Dense float Hamming = count of differing positions
        # (reference: src/distance_measures/one_to_one.rs:616-633).
        fn = lambda c: jnp.sum(
            (queries[:, None, :] != c[None, :, :]).astype(jnp.float32), axis=-1
        )
    else:  # NON_ZERO_INTERSECT dense: -count of co-nonzero dims
        # (reference: src/distance_measures/mod.rs:94-106).
        fn = lambda c: -jnp.sum(
            ((queries[:, None, :] != 0.0) & (c[None, :, :] != 0.0)).astype(jnp.float32),
            axis=-1,
        )

    out = jax.lax.map(fn, db_chunks)  # [n_chunks, B, chunk]
    out = jnp.moveaxis(out, 0, 1).reshape(queries.shape[0], n_pad)
    return out[:, :n]


def one_to_many(
    measure: DistanceMeasure,
    query: jnp.ndarray,
    db: jnp.ndarray,
    db_sq_norms: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Distances [N] from one query [D] to all database rows."""
    return many_to_many(measure, query[None, :], db, db_sq_norms)[0]


def pairwise_distances(measure: DistanceMeasure, data: jnp.ndarray) -> jnp.ndarray:
    """[N, N] all-pairs distance matrix within one set
    (reference: src/distance_measures/many_to_many.rs:17-76 pairwise_*)."""
    return many_to_many(measure, data, data)


def one_to_one(measure: DistanceMeasure, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Scalar distance between two dense vectors."""
    return many_to_many(measure, a[None, :], b[None, :])[0, 0]


def mask_padded_rows(dists: jnp.ndarray, n_valid, masked_value: float) -> jnp.ndarray:
    """Overwrite distances to padded database rows (col index >= n_valid)."""
    n = dists.shape[-1]
    col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, dists.ndim - 1)
    return jnp.where(col < n_valid, dists, jnp.float32(masked_value))


def gathered_distances(
    measure: DistanceMeasure,
    queries: jnp.ndarray,
    rows: jnp.ndarray,
    rows_sq_norms: Optional[jnp.ndarray] = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Per-query distances to per-query candidate rows.

    Args:
        queries: [B, D].
        rows: [B, C, D] gathered candidate vectors (query b scores rows[b]).
        rows_sq_norms: [B, C] optional precomputed squared norms.

    Returns: [B, C] distances. Used by partitioned search and exact
    re-ranking, replacing the reference's per-candidate scalar loops
    (reference: src/utils/reordering.rs:22-94, src/scann.rs:237-252).
    """
    queries = queries.astype(jnp.float32)
    rows = rows.astype(jnp.float32)
    dots = jnp.einsum("bd,bcd->bc", queries, rows, precision=precision)

    if measure in (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT):
        return -dots

    if rows_sq_norms is None:
        rows_sq_norms = jnp.sum(rows * rows, axis=-1)
    q_sq = squared_norms(queries)

    if measure in (DistanceMeasure.SQUARED_L2, DistanceMeasure.JACCARD, DistanceMeasure.DICE):
        return jnp.maximum(q_sq[:, None] + rows_sq_norms - 2.0 * dots, 0.0)
    if measure == DistanceMeasure.L2:
        return jnp.sqrt(jnp.maximum(q_sq[:, None] + rows_sq_norms - 2.0 * dots, 0.0))
    if measure == DistanceMeasure.COSINE:
        denom = jnp.sqrt(q_sq)[:, None] * jnp.sqrt(rows_sq_norms)
        sim = jnp.where(denom > 0.0, dots / jnp.maximum(denom, 1e-30), 0.0)
        return 1.0 - sim
    if measure == DistanceMeasure.L1:
        return jnp.sum(jnp.abs(queries[:, None, :] - rows), axis=-1)

    raise NotImplementedError(f"gathered_distances for {measure}")


# ---------------------------------------------------------------------------
# Sparse set distances (host-friendly, jit-compatible on padded index arrays)
# (reference: src/distance_measures/sparse.rs)
# ---------------------------------------------------------------------------


def jaccard_distance_sparse(a_indices, b_indices) -> float:
    """1 - |A∩B| / |A∪B| over sparse index sets (host path)."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    union = len(a | b)
    if union == 0:
        return 0.0
    return 1.0 - len(a & b) / union


def dice_distance_sparse(a_indices, b_indices) -> float:
    """1 - 2|A∩B| / (|A|+|B|) over sparse index sets (host path)."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    total = len(a) + len(b)
    if total == 0:
        return 0.0
    return 1.0 - 2.0 * len(a & b) / total


def non_zero_intersect_sparse(a_indices, b_indices) -> float:
    """-|A∩B| (more overlap = closer)."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    return -float(len(a & b))


def weighted_jaccard_distance_sparse(a_values, a_indices,
                                     b_values, b_indices) -> float:
    """1 - Σ min(|aᵢ|,|bᵢ|) / Σ max(|aᵢ|,|bᵢ|) over weighted sparse vectors
    (reference: src/distance_measures/sparse.rs:101-147 — values are taken
    by absolute value; 0.0 when both vectors are empty)."""
    av = {int(i): abs(float(v)) for i, v in zip(a_indices, a_values)}
    bv = {int(i): abs(float(v)) for i, v in zip(b_indices, b_values)}
    min_sum = sum(min(av[i], bv[i]) for i in av.keys() & bv.keys())
    max_sum = sum(av.values()) + sum(bv.values()) - min_sum
    if max_sum == 0.0:
        return 0.0
    return 1.0 - min_sum / max_sum


def overlap_coefficient_sparse(a_indices, b_indices) -> float:
    """|A∩B| / min(|A|,|B|) (Szymkiewicz–Simpson; reference:
    src/distance_measures/sparse.rs:178-196 — a SIMILARITY in [0,1],
    0.0 when either set is empty). The searcher serves the distance
    1 - overlap so smaller = closer."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    if not a or not b:
        return 0.0
    return len(a & b) / min(len(a), len(b))
