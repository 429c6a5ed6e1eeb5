"""Partitioned (tree-based) exact searcher.

One fused device program per query batch (replacing the reference's
host-side partition loop with scalar scoring, reference:
src/scann.rs:222-294):

    centroid matmul -> top-p partitions -> gather padded leaf lists ->
    gather candidate rows -> exact einsum scoring -> masked top-k

Padded-leaf gathering keeps every shape static; -1 leaf padding is masked to
a sentinel distance and surfaces as index -1 when fewer than k real
candidates exist.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import SearchParameters, Searcher, pad_results_to_k
from scann_tpu.ops.distances import (
    DistanceMeasure,
    gathered_distances,
    many_to_many,
    squared_norms,
)
from scann_tpu.ops.topk import top_k_smallest, top_k_unique
from scann_tpu.partitioning.tree_partitioner import TreePartitioner, TreePartitionerConfig
from scann_tpu.types import MASKED_DISTANCE


@functools.partial(jax.jit, static_argnames=("measure", "p", "k", "multiplicity"))
def partitioned_search_kernel(
    db, db_sq_norms, centers, leaf_indices, queries, eps=jnp.inf, *,
    measure: DistanceMeasure, p: int, k: int, multiplicity: int = 1,
):
    """(distances [B,k], global indices [B,k]; -1 index for missing).

    ``multiplicity`` > 1 (partition spilling) switches the final selection to
    the over-fetch + dedup top-k so a point probed via several of its leaves
    is returned once.
    """
    b = queries.shape[0]
    cd = many_to_many(measure, queries, centers)          # [B, K]
    _, top_parts = top_k_smallest(cd, p)                  # [B, p]

    cand = jnp.take(leaf_indices, top_parts, axis=0)      # [B, p, L]
    cand = cand.reshape(b, -1)                            # [B, C]
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)

    rows = jnp.take(db, safe, axis=0)                     # [B, C, D]
    # norms recomputed from the gathered rows (identical math to the
    # table, and no per-element norm gather)
    norms = jnp.sum(rows * rows, axis=-1)             # [B, C]
    dists = gathered_distances(measure, queries, rows, norms)
    dists = jnp.where(valid, dists, MASKED_DISTANCE)

    if multiplicity > 1:
        vals, idx = top_k_unique(dists, cand, k, multiplicity)
    else:
        vals, pos = top_k_smallest(dists, k)
        idx = jnp.take_along_axis(cand, pos, axis=1)
    # epsilon threshold on the exact leaf distances (reference:
    # src/brute_force/top_k.rs:263-393 FastTopNeighbors semantics)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


class PartitionedSearcher(Searcher):
    """Exact search over the top-p k-means partitions."""

    def __init__(
        self,
        dataset: DenseDataset,
        partitioner: Optional[TreePartitioner] = None,
        config: Optional[TreePartitionerConfig] = None,
        num_partitions_to_search: int = 10,
        distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
    ):
        self._dataset = dataset
        self._measure = distance_measure
        self._p_default = num_partitions_to_search
        if partitioner is not None:
            self.partitioner = partitioner
        else:
            cfg = config or TreePartitionerConfig()
            cfg.distance_measure = distance_measure
            self.partitioner = TreePartitioner(cfg).build(dataset)
        self._norms_cache = None

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

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        queries = self._validate_queries(queries)
        p = self._p_default
        if params is not None and params.num_leaves_to_search is not None:
            p = params.num_leaves_to_search
        p = min(int(p), self.partitioner.num_partitions)
        if p <= 0:
            raise ScannError.invalid_argument("num_leaves_to_search must be positive")
        k = int(k)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")

        db, norms, _ = self._device_state()
        leaves = self.partitioner.tokenization.padded_leaves()
        k_eff = min(k, p * leaves.shape[1])
        eps = params.effective_epsilon() if params is not None else np.inf
        dists, idx = partitioned_search_kernel(
            db, norms, self.partitioner.centers_device(), leaves, jnp.asarray(queries),
            jnp.float32(eps), measure=self._measure, p=p, k=k_eff,
            multiplicity=self.partitioner.tokenization.max_multiplicity,
        )
        # p*leaf_cap can cap k_eff below k: keep the [B, k] contract by
        # padding the unreachable slots with (-1, inf)
        return pad_results_to_k(np.asarray(idx), np.asarray(dists), k)
