"""Asymmetric scoring: f32 queries against a quantized database.

Replaces the reference's AVX2 dequantize-inside-FMA loops
(reference: src/distance_measures/one_to_many_asymmetric.rs:25-51 int8,
:268-316 bf16, :327-377 fp8). The whole computation folds into one
matrix product using the affine structure of the codec:

    d' = C * scale + offset            (C = stored codes as f32)
    q . d'  = scale * (q . C) + offset * sum(q)
    ||d'||^2 is precomputed at build time from the true dequantized rows

so SquaredL2 / L2 / Dot / Cosine against the *dequantized* database need only
``Q @ C^T`` plus per-row constants — no dequantized copy of the database is
ever materialized for the norm terms. (The code cast C -> f32 for the
product is the one materialization XLA performs.)

For bf16/fp8 databases scale=1, offset=0 and the cast is a native dtype
conversion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scann_tpu.ops.distances import DistanceMeasure, squared_norms


def asymmetric_many_to_many(
    measure: DistanceMeasure,
    queries: jnp.ndarray,
    db_codes: jnp.ndarray,
    db_sq_norms: jnp.ndarray,
    scale: float = 1.0,
    offset: float = 0.0,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """[B, N] distances between f32 queries and an affine-quantized database.

    Args:
        measure: SQUARED_L2 / L2 / DOT_PRODUCT / COSINE /
            GENERAL_INNER_PRODUCT.
        queries: [B, D] f32.
        db_codes: [N, D] uint8 / bf16 / fp8 stored codes.
        db_sq_norms: [N] f32 squared norms of the *dequantized* rows.
        scale, offset: codec affine parameters (dequant = code*scale+offset).
    """
    queries = queries.astype(jnp.float32)
    raw_dots = jax.lax.dot_general(
        queries, db_codes.astype(jnp.float32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    # offset/scale may be traced scalars; keep the math branch-free.
    dots = scale * raw_dots + offset * jnp.sum(queries, axis=1, keepdims=True)

    if measure in (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT):
        return -dots

    q_sq = squared_norms(queries)

    if measure == DistanceMeasure.SQUARED_L2:
        return jnp.maximum(q_sq[:, None] + db_sq_norms[None, :] - 2.0 * dots, 0.0)

    if measure == DistanceMeasure.L2:
        return jnp.sqrt(
            jnp.maximum(q_sq[:, None] + db_sq_norms[None, :] - 2.0 * dots, 0.0)
        )

    if measure == DistanceMeasure.COSINE:
        denom = jnp.sqrt(q_sq)[:, None] * jnp.sqrt(db_sq_norms)[None, :]
        sim = jnp.where(denom > 0.0, dots / jnp.maximum(denom, 1e-30), 0.0)
        return 1.0 - sim

    raise NotImplementedError(f"asymmetric scoring for {measure}")
