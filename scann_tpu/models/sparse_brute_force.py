"""Sparse-set brute force: Jaccard / Dice / NonZeroIntersect / Overlap /
WeightedJaccard over sparse datapoints.

The reference scores sparse points with sorted-index-merge loops
(reference: src/distance_measures/sparse.rs). Device formulation: a
sparse dataset with modest dimensionality densifies to a binary incidence
matrix ``M [N, D] ∈ {0,1}``; then for a query set q (binary [D]):

    intersect = M @ q            (one matmul for the whole batch)
    jaccard   = 1 - I / (|A| + |q| - I)
    dice      = 1 - 2I / (|A| + |q|)
    nzi       = -I
    overlap   = 1 - I / min(|A|, |q|)     (sparse.rs:178-196, as a distance)

so the entire sweep is one matmul + elementwise transforms. Weighted
Jaccard (sparse.rs:101-147) needs Σ min(|aᵢ|,|qᵢ|), which is not a matmul;
it reduces to an L1 distance via  Σ min(x,y) = (Σx + Σy - Σ|x-y|)/2  on the
abs-value vectors, computed as a D-chunked ``lax.scan`` so peak memory is
[B, N, chunk] instead of [B, N, D]. Weighted sparse vectors (values
attached) score real dot/L2 through the same densification.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import SparseDataset
from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import SearchParameters, Searcher
from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.ops.topk import top_k_smallest
from scann_tpu.types import MASKED_DISTANCE, SUBLANE_F32, align_up

_SET_MEASURES = (DistanceMeasure.JACCARD, DistanceMeasure.DICE,
                 DistanceMeasure.NON_ZERO_INTERSECT, DistanceMeasure.OVERLAP)


@functools.partial(jax.jit, static_argnames=("measure", "k"))
def _sparse_search_kernel(incidence, set_sizes, n_valid, q_inc, q_sizes, *,
                          measure: DistanceMeasure, k: int):
    inter = jax.lax.dot_general(
        q_inc, incidence,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [B, N]
    a = set_sizes[None, :]
    b = q_sizes[:, None]
    if measure == DistanceMeasure.JACCARD:
        union = a + b - inter
        dists = jnp.where(union > 0, 1.0 - inter / jnp.maximum(union, 1.0), 0.0)
    elif measure == DistanceMeasure.DICE:
        total = a + b
        dists = jnp.where(total > 0, 1.0 - 2.0 * inter / jnp.maximum(total, 1.0), 0.0)
    elif measure == DistanceMeasure.NON_ZERO_INTERSECT:
        dists = -inter
    elif measure == DistanceMeasure.OVERLAP:
        # reference coefficient (sparse.rs:178-196) is 0 when either set is
        # empty -> distance 1 (maximally far), matching 1 - coefficient
        m = jnp.minimum(a, b)
        dists = jnp.where(m > 0, 1.0 - inter / jnp.maximum(m, 1.0), 1.0)
    else:
        raise NotImplementedError(measure)
    col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1)
    dists = jnp.where(col < n_valid, dists, MASKED_DISTANCE)
    vals, idx = top_k_smallest(dists, k)
    missing = vals >= MASKED_DISTANCE / 2
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


@functools.partial(jax.jit, static_argnames=("k", "chunk_d"))
def _weighted_jaccard_kernel(absvals, row_sums, n_valid, q_abs, q_sums, *,
                             k: int, chunk_d: int):
    """dist = 1 - Σmin/Σmax on abs-value vectors, with Σmin recovered from
    the L1 distance (see module docstring). ``absvals``/``q_abs`` arrive
    zero-padded to a ``chunk_d`` multiple of columns (pad dims contribute
    |0-0| = 0)."""
    n, d = absvals.shape
    b = q_abs.shape[0]
    n_ch = d // chunk_d
    xv = absvals.reshape(n, n_ch, chunk_d).transpose(1, 0, 2)
    qv = q_abs.reshape(b, n_ch, chunk_d).transpose(1, 0, 2)

    def body(acc, xq):
        xc, qc = xq
        return acc + jnp.sum(jnp.abs(qc[:, None, :] - xc[None, :, :]),
                             axis=-1), None

    l1, _ = jax.lax.scan(body, jnp.zeros((b, n), jnp.float32), (xv, qv))
    min_sum = 0.5 * (q_sums[:, None] + row_sums[None, :] - l1)
    max_sum = q_sums[:, None] + row_sums[None, :] - min_sum
    dists = jnp.where(max_sum > 0,
                      1.0 - min_sum / jnp.maximum(max_sum, 1e-30), 0.0)
    col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1)
    dists = jnp.where(col < n_valid, dists, MASKED_DISTANCE)
    vals, idx = top_k_smallest(dists, k)
    missing = vals >= MASKED_DISTANCE / 2
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


class SparseBruteForceSearcher(Searcher):
    """Exact set-similarity search over a SparseDataset."""

    def __init__(self, dataset: SparseDataset,
                 distance_measure: DistanceMeasure = DistanceMeasure.JACCARD):
        if distance_measure not in (
                *_SET_MEASURES, DistanceMeasure.WEIGHTED_JACCARD):
            raise ScannError.invalid_argument(
                f"sparse searcher supports set measures, got {distance_measure}")
        if dataset.dimensionality > 65536:
            raise ScannError.invalid_argument(
                "incidence densification capped at 65536 dims")
        self._dataset = dataset
        self._measure = distance_measure
        n = max(len(dataset), 1)
        n_pad = align_up(n, SUBLANE_F32)
        if distance_measure == DistanceMeasure.WEIGHTED_JACCARD:
            # |values| matrix (the reference takes values by abs,
            # sparse.rs:108-110), column-padded to the scan chunk
            d = dataset.dimensionality
            self._chunk_d = self._pick_chunk(n_pad, d)
            d_pad = align_up(d, self._chunk_d)
            vals = np.zeros((n_pad, d_pad), dtype=np.float32)
            for i in range(len(dataset)):
                p = dataset.get(i)
                vals[i, p.indices] = np.abs(p.values)
            self._absvals = jnp.asarray(vals)
            self._row_sums = jnp.asarray(vals.sum(axis=1))
        else:
            inc = np.zeros((n_pad, dataset.dimensionality), dtype=np.float32)
            for i in range(len(dataset)):
                inc[i, dataset.get(i).indices] = 1.0
            self._incidence = jnp.asarray(inc)
            self._sizes = jnp.asarray(inc.sum(axis=1))

    @staticmethod
    def _pick_chunk(n_pad: int, d: int) -> int:
        """D-chunk for the weighted-Jaccard scan: caps the [B, N, chunk]
        broadcast at ~64M f32 elements for a 64-query tile."""
        target = max((1 << 26) // max(64 * n_pad, 1), 8)
        return int(min(align_up(d, 8), align_up(target, 8)))

    def dataset_size(self) -> int:
        return len(self._dataset)

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def search_sparse(self, indices, k: int, values=None):
        """Search with a sparse query given by its index set (and optional
        values — required information for WEIGHTED_JACCARD; absent values
        default to 1.0, matching a binary weighted set)."""
        q = np.zeros((1, self.dimensionality()), dtype=np.float32)
        idx_arr = np.asarray(indices, dtype=np.int64)
        q[0, idx_arr] = 1.0 if values is None else np.asarray(values, np.float32)
        idx, dist = self._search_incidence(q, k)
        return self._to_results(idx, dist)[0]

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """Queries as dense rows [B, D]: 0/1 incidence for the set
        measures; real values for WEIGHTED_JACCARD."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self._measure != DistanceMeasure.WEIGHTED_JACCARD:
            q = (q != 0).astype(np.float32)
        return self._search_incidence(q, k)

    def _search_incidence(self, q: np.ndarray, k: int):
        if self.dataset_size() == 0:
            raise ScannError.failed_precondition("dataset is empty")
        k = min(int(k), self.dataset_size())
        if self._measure == DistanceMeasure.WEIGHTED_JACCARD:
            q_abs = np.abs(q)
            d_pad = self._absvals.shape[1]
            if q_abs.shape[1] != d_pad:
                q_abs = np.pad(q_abs, ((0, 0), (0, d_pad - q_abs.shape[1])))
            vals, idx = _weighted_jaccard_kernel(
                self._absvals, self._row_sums, jnp.int32(self.dataset_size()),
                jnp.asarray(q_abs), jnp.asarray(q_abs.sum(axis=1)),
                k=k, chunk_d=self._chunk_d)
            return np.asarray(idx), np.asarray(vals)
        vals, idx = _sparse_search_kernel(
            self._incidence, self._sizes, jnp.int32(self.dataset_size()),
            jnp.asarray(q), jnp.asarray(q.sum(axis=1)),
            measure=self._measure, k=k,
        )
        return np.asarray(idx), np.asarray(vals)
