"""Exact brute-force searcher.

One jit program per (batch-shape, k): a matrix-product distance matrix +
``lax.top_k``. Replaces the reference's strided AVX2 one-to-many loop + heap
(reference: src/brute_force/searcher.rs:77-139, src/simd/x86.rs:266-346,
src/brute_force/top_k.rs:66-112). The reference's 16.9× "batched" speedup is
rayon threading over queries; here batching is free — the whole [B, N]
distance matrix is a single matmul.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import SearchParameters, Searcher
from scann_tpu.ops.distances import (
    DistanceMeasure,
    many_to_many,
    mask_padded_rows,
    squared_norms,
)
from scann_tpu.ops.topk import top_k_smallest
from scann_tpu.types import MASKED_DISTANCE


@functools.partial(jax.jit, static_argnames=("measure", "k"))
def _search_kernel(db, db_sq_norms, n_valid, queries, allow_mask=None,
                   eps=jnp.inf, *, measure: DistanceMeasure, k: int):
    dists = many_to_many(measure, queries, db, db_sq_norms)
    dists = mask_padded_rows(dists, n_valid, MASKED_DISTANCE)
    if allow_mask is not None:
        dists = jnp.where(allow_mask[None, :], dists, MASKED_DISTANCE)
    vals, idx = top_k_smallest(dists, k)
    # epsilon threshold on the exact distances (reference:
    # src/brute_force/top_k.rs:263-393 FastTopNeighbors semantics)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


@functools.partial(jax.jit, static_argnames=("measure",))
def _distances_kernel(db, db_sq_norms, n_valid, queries, *, measure: DistanceMeasure):
    dists = many_to_many(measure, queries, db, db_sq_norms)
    return mask_padded_rows(dists, n_valid, jnp.inf)


class BruteForceSearcher(Searcher):
    """Exact search over a dense dataset (reference: src/brute_force/searcher.rs:18-30)."""

    def __init__(self, dataset: DenseDataset,
                 distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
        if not isinstance(dataset, DenseDataset):
            raise ScannError.invalid_argument("BruteForceSearcher needs a DenseDataset")
        self._dataset = dataset
        self._measure = distance_measure
        self._norms_cache: Optional[Tuple[int, jnp.ndarray]] = None

    # -- metadata --------------------------------------------------------------
    @property
    def dataset(self) -> DenseDataset:
        return self._dataset

    @property
    def distance_measure(self) -> DistanceMeasure:
        return self._measure

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def _device_state(self):
        db, n = self._dataset.device()
        if self._norms_cache is None or self._norms_cache[0] != n:
            self._norms_cache = (n, jax.jit(squared_norms)(db))
        return db, self._norms_cache[1], n

    # -- core API ----------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        queries = self._validate_queries(queries)
        k = min(int(k), self.dataset_size())
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        db, norms, n = self._device_state()
        eps = params.effective_epsilon() if params is not None else np.inf

        mask_dev = None
        if allow_mask is not None:
            m = np.zeros(db.shape[0], dtype=bool)
            m[:n] = np.asarray(allow_mask, dtype=bool)[:n]
            mask_dev = jnp.asarray(m)
        dists, idx = _search_kernel(
            db, norms, jnp.int32(n), jnp.asarray(queries), mask_dev,
            jnp.float32(eps), measure=self._measure, k=k,
        )
        return np.asarray(idx), np.asarray(dists)

    def distances_to_all(self, queries: np.ndarray) -> np.ndarray:
        """[B, N] exact distance matrix (padded rows -> +inf)."""
        queries = self._validate_queries(queries)
        db, norms, n = self._device_state()
        out = _distances_kernel(db, norms, jnp.int32(n), jnp.asarray(queries),
                                measure=self._measure)
        return np.asarray(out)[:, : self.dataset_size()]

    def radius_search(self, query, radius: float, max_results: Optional[int] = None):
        """All points within ``radius``, sorted ascending
        (reference: src/brute_force/searcher.rs:142-167)."""
        q = self._validate_queries(np.asarray(query))
        dists = self.distances_to_all(q)[0]
        within = np.nonzero(dists <= radius)[0]
        order = within[np.argsort(dists[within], kind="stable")]
        if max_results is not None:
            order = order[:max_results]
        return self._to_results(order[None, :], dists[order][None, :])[0]
