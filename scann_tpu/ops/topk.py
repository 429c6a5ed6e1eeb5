"""Top-k selection.

Replaces the reference's heap structures (reference: src/brute_force/top_k.rs:
TopK BinaryHeap :20-27, FixedTopK :120-127, FastTopNeighbors :263-279) with
``jax.lax.top_k`` — distances are negated so "smallest distance" becomes
"largest score", which XLA lowers to an efficient on-device partial sort.

Also provides the shard-merge used by the multi-chip searcher: each database
shard computes a local top-k, the [n_shards, k] partials are all-gathered
across devices, and a final top-k over n_shards*k candidates yields the global result.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def top_k_smallest(dists: jnp.ndarray, k: int,
                   tile: int = 16384) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest-k selection along the last axis.

    For large N this runs EXACT two-stage selection: per-tile ``lax.top_k``
    then a merge top-k over the [n_tiles * k] partials, which keeps each
    selection segment short at database scale.

    Args:
        dists: [..., N] distances (smaller = closer).
        k: number of neighbors; must be static.

    Returns:
        (values [..., k] ascending, indices [..., k] int32).
    """
    n = dists.shape[-1]
    if k <= 16 and n >= (1 << 15):
        # exact k rounds of min + argmin + mask: ~5x faster than sort-based
        # selection at [128, 1M] (16ms vs 92ms) for small k
        col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, dists.ndim - 1)
        vals = []
        idxs = []
        d = dists
        for _ in range(k):
            m = jnp.min(d, axis=-1)
            am = jnp.min(jnp.where(d <= m[..., None], col, n), axis=-1)
            vals.append(m)
            idxs.append(am.astype(jnp.int32))
            d = jnp.where(col == am[..., None], jnp.inf, d)
        return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)
    if n > 2 * tile and k <= tile // 8:
        n_tiles = -(-n // tile)
        n_pad = n_tiles * tile
        if n_pad != n:
            pad_widths = [(0, 0)] * (dists.ndim - 1) + [(0, n_pad - n)]
            dists = jnp.pad(dists, pad_widths, constant_values=jnp.inf)
        tiled = dists.reshape(*dists.shape[:-1], n_tiles, tile)
        neg, idx = jax.lax.top_k(-tiled, k)                    # [..., T, k]
        base = (jnp.arange(n_tiles, dtype=jnp.int32) * tile)[:, None]
        idx_global = idx.astype(jnp.int32) + base
        flat_vals = (-neg).reshape(*dists.shape[:-1], n_tiles * k)
        flat_idx = idx_global.reshape(*dists.shape[:-1], n_tiles * k)
        neg2, pos = jax.lax.top_k(-flat_vals, k)
        return -neg2, jnp.take_along_axis(flat_idx, pos, axis=-1)
    neg, idx = jax.lax.top_k(-dists, k)
    return -neg, idx.astype(jnp.int32)


def approx_top_k_smallest(
    dists: jnp.ndarray, k: int, recall_target: float = 0.95
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Approximate smallest-k via ``lax.approx_min_k``.

    Use ONLY for pre-rerank candidate stages — any per-entry recall_target
    loss is recovered by the exact re-rank. (On a GPU XLA compiles it as an
    exact top-k.)
    """
    vals, idx = jax.lax.approx_min_k(dists, k, recall_target=recall_target)
    return vals, idx.astype(jnp.int32)


def top_k_with_threshold(
    dists: jnp.ndarray, k: int, epsilon: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k with an epsilon distance threshold: entries with distance
    > epsilon are reported with index -1 (reference: FastTopNeighbors epsilon,
    src/brute_force/top_k.rs:263-279).
    """
    vals, idx = top_k_smallest(dists, k)
    good = vals <= epsilon
    return jnp.where(good, vals, jnp.inf), jnp.where(good, idx, -1)


def top_k_unique(
    dists: jnp.ndarray, ids: jnp.ndarray, k: int, multiplicity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact smallest-k over candidates whose ids may repeat (partition
    spilling duplicates a point into up to ``multiplicity`` leaves).

    Over-fetches ``k * multiplicity`` — since each id appears at most
    ``multiplicity`` times, the top ``k * multiplicity`` values contain at
    least ``k`` distinct ids — then keeps the first occurrence per id.
    Duplicate and missing slots return (inf, -1).
    """
    kp = min(k * max(int(multiplicity), 1), dists.shape[-1])
    vals, pos = top_k_smallest(dists, kp)
    cand = jnp.take_along_axis(ids, pos, axis=-1)
    return dedup_top_k(vals, cand, k)


def keep_best_per_id(
    vals: jnp.ndarray, ids: jnp.ndarray, out_k: int, payload=None,
):
    """Smallest-``out_k`` over UNIQUE ids from a candidate list whose ids
    may repeat (partition spilling), keeping each id's best copy.

    Sort-based: one two-key sort by (id, value) brings copies together
    best-first, so any entry equal to its left neighbor's id is a worse
    duplicate and is masked; survivors re-select by value. O(kp log kp)
    per row vs :func:`dedup_top_k`'s O(kp²) pairwise mask — cheap at
    CANDIDATE widths, which is what lets the exact re-rank gather run at
    unique depth instead of the legacy ``pre_k × multiplicity`` inflation
    (the gather is the measured latency floor of the tree-AH pipeline;
    reference candidate-merge analog: src/tree_x_hybrid/mod.rs:240-364).
    Masked entries (``vals >= MASKED_DISTANCE/2``) sort behind real
    copies of the same id, so they never displace one.

    Returns ``(vals [..., out_k], ids [..., out_k])`` ascending with
    (MASKED_DISTANCE, -1) fill, plus the payload gathered to the same
    slots when ``payload`` is given.
    """
    from scann_tpu.types import MASKED_DISTANCE

    ops = (ids, vals) if payload is None else (ids, vals, payload)
    sorted_ops = jax.lax.sort(ops, dimension=-1, is_stable=True, num_keys=2)
    ids_s, vals_s = sorted_ops[0], sorted_ops[1]
    prev = jnp.concatenate(
        [jnp.full(ids_s.shape[:-1] + (1,), -1, ids_s.dtype),
         ids_s[..., :-1]], axis=-1)
    dup = (ids_s == prev) & (ids_s >= 0)
    vals_s = jnp.where(dup, MASKED_DISTANCE, vals_s)
    out_v, pos = top_k_smallest(vals_s, out_k)
    out_i = jnp.take_along_axis(ids_s, pos, axis=-1)
    missing = out_v >= MASKED_DISTANCE / 2
    out_i = jnp.where(missing, -1, out_i)
    if payload is None:
        return out_v, out_i
    return out_v, out_i, jnp.take_along_axis(sorted_ops[2], pos, axis=-1)


def dedup_top_k(
    vals: jnp.ndarray, cand: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep-first-occurrence dedup over an ascending candidate list, then
    truncate to k. Duplicate and missing slots return (inf, -1)."""
    kp = cand.shape[-1]
    # dup[i] = some j < i has the same id (ascending order => j is closer)
    eq = cand[..., :, None] == cand[..., None, :]
    lower = jnp.tril(jnp.ones((kp, kp), dtype=bool), k=-1)
    dup = jnp.any(eq & lower, axis=-1) & (cand >= 0)
    vals = jnp.where(dup, jnp.inf, vals)
    cand = jnp.where(dup, -1, cand)
    # stable-push dups behind the (already ascending) unique entries
    order = jnp.argsort(dup, axis=-1)
    vals = jnp.take_along_axis(vals, order, axis=-1)[..., :k]
    cand = jnp.take_along_axis(cand, order, axis=-1)[..., :k]
    return vals, cand


def merge_top_k(
    dists: jnp.ndarray, indices: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge several sorted/unsorted candidate lists into one top-k.

    Args:
        dists: [..., M] candidate distances (e.g. concatenated shard partials).
        indices: [..., M] global datapoint indices for each candidate.
        k: final neighbor count.

    Returns:
        (values [..., k], global indices [..., k]).
    """
    vals, pos = top_k_smallest(dists, k)
    return vals, jnp.take_along_axis(indices, pos, axis=-1)


def radius_search_mask(dists: jnp.ndarray, radius: float) -> jnp.ndarray:
    """Boolean mask of points within ``radius``
    (reference: src/brute_force/searcher.rs:142-167)."""
    return dists <= radius
