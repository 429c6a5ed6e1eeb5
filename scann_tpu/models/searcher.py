"""Common searcher interface.

Mirrors the reference's ``Searcher`` trait / ``SearchParameters`` /
``SearchResult`` surface (reference: src/searcher.rs:12-30,64-101,148-186).

Device twist: the canonical entry point is *batched* array-in/array-out
search — ``search_batched_arrays(queries [B,D], k) -> (indices [B,k], dists
[B,k])`` — because a batch of queries is one device program. The per-query object API wraps
it for parity with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from scann_tpu.errors import ScannError


@dataclasses.dataclass
class SearchParameters:
    """Per-query search knobs (reference: src/searcher.rs:12-30)."""

    num_neighbors: Optional[int] = None
    pre_reordering_num_neighbors: Optional[int] = None
    pre_reordering_epsilon: Optional[float] = None
    post_reordering_epsilon: Optional[float] = None
    num_leaves_to_search: Optional[int] = None
    crowding_enabled: Optional[bool] = None

    def with_num_neighbors(self, k: int) -> "SearchParameters":
        self.num_neighbors = k
        return self

    def with_pre_reordering_neighbors(self, k: int) -> "SearchParameters":
        self.pre_reordering_num_neighbors = k
        return self

    def with_leaves_to_search(self, n: int) -> "SearchParameters":
        self.num_leaves_to_search = n
        return self

    def with_epsilon(self, epsilon: float) -> "SearchParameters":
        self.pre_reordering_epsilon = epsilon
        return self

    def effective_epsilon(self) -> float:
        """Distance threshold for single-stage (exact) searchers.

        There is no separate reordering pass, so the search itself is both
        the "pre" and "post" stage — the tighter of the two thresholds
        applies (reference: src/brute_force/top_k.rs:263-393 applies the
        epsilon to every pushed neighbor).
        """
        eps = float("inf")
        if self.pre_reordering_epsilon is not None:
            eps = min(eps, float(self.pre_reordering_epsilon))
        if self.post_reordering_epsilon is not None:
            eps = min(eps, float(self.post_reordering_epsilon))
        return eps


def epsilons(params: Optional["SearchParameters"]):
    """(pre, post) per-query distance thresholds — the ONE place the
    None-defaulting ladder lives (reference: src/searcher.rs:12-30)."""
    pre = post = np.inf
    if params is not None:
        if params.pre_reordering_epsilon is not None:
            pre = float(params.pre_reordering_epsilon)
        if params.post_reordering_epsilon is not None:
            post = float(params.post_reordering_epsilon)
    return pre, post


def pad_results_to_k(idx: np.ndarray, dists: np.ndarray, k: int):
    """Pad [B, w] results out to the [B, k] contract with (-1, inf) slots
    when a searcher's candidate ceiling makes w < k (e.g. one survivor per
    r-block in the sweep, p*leaf_cap in partitioned search)."""
    w = idx.shape[1]
    if w >= k:
        return idx, dists
    b = idx.shape[0]
    pi = np.full((b, k), -1, dtype=idx.dtype)
    pd = np.full((b, k), np.inf, dtype=dists.dtype)
    pi[:, :w] = idx
    pd[:, :w] = dists
    return pi, pd


@dataclasses.dataclass
class NNResult:
    """One neighbor (reference: src/searcher.rs:64-101)."""

    index: int
    distance: float
    docid: Optional[object] = None


class SearchResult:
    """Sorted neighbor list (reference: src/searcher.rs:96-146)."""

    def __init__(self, neighbors: Optional[List[NNResult]] = None):
        self.neighbors: List[NNResult] = neighbors or []

    def __len__(self) -> int:
        return len(self.neighbors)

    def __iter__(self):
        return iter(self.neighbors)

    def indices(self) -> List[int]:
        return [n.index for n in self.neighbors]

    def distances(self) -> List[float]:
        return [n.distance for n in self.neighbors]


class Searcher:
    """Base searcher: subclasses implement ``search_batched_arrays``.

    The reference's trait methods ``search_with_params`` /
    ``search_batched_with_params`` / ``dataset_size`` / ``dimensionality``
    (reference: src/searcher.rs:148-186) map onto the methods below.
    """

    # -- metadata (override) -------------------------------------------------
    def dataset_size(self) -> int:
        raise NotImplementedError

    def dimensionality(self) -> int:
        raise NotImplementedError

    def _docids(self):
        return None

    # -- core batched array API (override) ------------------------------------
    def search_batched_arrays(
        self,
        queries: np.ndarray,
        k: int,
        params: Optional[SearchParameters] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (indices [B, k] int32, distances [B, k] f32), sorted
        ascending by distance. Indices may be -1 for missing results."""
        raise NotImplementedError

    # -- convenience object API -------------------------------------------------
    def _validate_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2:
            raise ScannError.invalid_argument(f"queries must be [B, D], got {queries.shape}")
        if queries.shape[1] != self.dimensionality():
            raise ScannError.invalid_argument(
                f"query dimensionality {queries.shape[1]} != dataset {self.dimensionality()}"
            )
        if self.dataset_size() == 0:
            raise ScannError.failed_precondition("dataset is empty")
        return queries

    def _to_results(self, indices: np.ndarray, dists: np.ndarray) -> List[SearchResult]:
        docids = self._docids()
        out = []
        for row_idx, row_dist in zip(indices, dists):
            neighbors = []
            for i, d in zip(row_idx, row_dist):
                i = int(i)
                if i < 0:
                    continue
                docid = docids.get(i) if docids is not None else None
                neighbors.append(NNResult(i, float(d), docid))
            out.append(SearchResult(neighbors))
        return out

    def search(self, query, k: Optional[int] = None,
               params: Optional[SearchParameters] = None) -> SearchResult:
        params = params or SearchParameters()
        k = k if k is not None else (params.num_neighbors or 10)
        q = self._validate_queries(np.asarray(query))
        idx, dist = self.search_batched_arrays(q, k, params)
        return self._to_results(idx, dist)[0]

    def search_with_params(self, query, params: SearchParameters) -> SearchResult:
        return self.search(query, params.num_neighbors, params)

    def search_batched(self, queries, k: Optional[int] = None,
                       params: Optional[SearchParameters] = None) -> List[SearchResult]:
        params = params or SearchParameters()
        k = k if k is not None else (params.num_neighbors or 10)
        q = self._validate_queries(np.asarray(queries))
        idx, dist = self.search_batched_arrays(q, k, params)
        return self._to_results(idx, dist)

    def supports_allow_mask(self) -> bool:
        import inspect

        try:
            return "allow_mask" in inspect.signature(self.search_batched_arrays).parameters
        except (TypeError, ValueError):
            return False

    def search_with_filter(self, query, k: int, restrict_filter,
                           params: Optional[SearchParameters] = None) -> SearchResult:
        """Filtered search (reference: tree_x_hybrid/mod.rs:245-294
        search_with_filter). Filters lower to a device mask fused into
        scoring when the searcher supports it; otherwise the searcher
        over-fetches and post-filters on host."""
        return self.search_batched_with_filter(
            np.asarray(query)[None, :], k, restrict_filter, params)[0]

    def search_batched_with_filter(self, queries, k: int, restrict_filter,
                                   params: Optional[SearchParameters] = None
                                   ) -> List[SearchResult]:
        q = self._validate_queries(np.asarray(queries))
        n = self.dataset_size()
        mask = restrict_filter.to_mask(n)
        if self.supports_allow_mask():
            idx, dist = self.search_batched_arrays(q, k, params, allow_mask=mask)
            return self._to_results(idx, dist)
        # host fallback: over-fetch then filter
        fetch = min(max(4 * k, k + 32), n)
        idx, dist = self.search_batched_arrays(q, fetch, params)
        out_i = np.full((len(q), k), -1, dtype=np.int64)
        out_d = np.full((len(q), k), np.inf, dtype=np.float32)
        for bi in range(len(q)):
            w = 0
            # iterate the columns actually returned (a searcher's candidate
            # ceiling may cap them below the requested fetch)
            for j in range(idx.shape[1]):
                i = int(idx[bi, j])
                if i >= 0 and mask[i]:
                    out_i[bi, w], out_d[bi, w] = i, dist[bi, j]
                    w += 1
                    if w >= k:
                        break
        return self._to_results(out_i, out_d)

    def search_with_crowding(self, queries, k: int, crowding,
                             params: Optional[SearchParameters] = None,
                             over_fetch: int = 4):
        """Crowding-constrained batched search: over-fetch k*over_fetch
        candidates, then the per-group cap post-pass
        (reference: crowding.rs:81-104 applied in scann.rs)."""
        q = self._validate_queries(np.asarray(queries))
        fetch = min(k * over_fetch, self.dataset_size())
        idx, dist = self.search_batched_arrays(q, fetch, params)
        out_i, out_d = crowding.apply_batch(idx.astype(np.int64), dist, k)
        return self._to_results(out_i, out_d)

    def search_batched_with_params(
        self, queries, params_list: Sequence[SearchParameters]
    ) -> List[SearchResult]:
        """Per-query parameter lists run as one batch when the parameters are
        homogeneous; heterogeneous parameters fall back to per-query calls."""
        queries = np.asarray(queries, dtype=np.float32)
        if len(params_list) != queries.shape[0]:
            raise ScannError.invalid_argument("params_list length != batch size")
        if all(p == params_list[0] for p in params_list):
            return self.search_batched(queries, params_list[0].num_neighbors, params_list[0])
        return [self.search(q, p.num_neighbors, p) for q, p in zip(queries, params_list)]
