"""Sharded search and training programs (shard_map over a device mesh).

Collective pattern for search: each shard scores its database block and
produces a local top-k; the [k]-sized partials all_gather across devices (tiny
traffic: k entries per shard per query) and a final top-k merges them.
Database rows never move — only candidate lists ride the interconnect.

For k-means training the update is a psum-reduction of per-shard
segment-sums: the classic data-parallel pattern where gradients are replaced
by (cluster_sum, cluster_count) pairs.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import SearchParameters, Searcher
from scann_tpu.ops.distances import DistanceMeasure, many_to_many, squared_norms
from scann_tpu.ops.topk import merge_top_k, top_k_smallest
from scann_tpu.parallel.mesh import make_mesh, replicate, shard_rows
from scann_tpu.types import MASKED_DISTANCE


def sharded_search_kernel(mesh: Mesh, measure: DistanceMeasure, k: int,
                          db_axis: str = "db", q_axis: Optional[str] = None):
    """Build a jitted sharded exact-search function.

    Returns fn(db_sharded [N,D], norms [N], n_valid, queries [B,D])
    -> (dists [B,k], global indices [B,k]).

    db shards along ``db_axis``; queries shard along ``q_axis`` when given
    (2-D mesh), else replicate.
    """
    q_spec_lead = q_axis if q_axis is not None else None

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(db_axis), P(), P(q_spec_lead, None)),
        out_specs=(P(q_spec_lead, None), P(q_spec_lead, None)),
        check_vma=False,
    )
    def _kernel(db_blk, norms_blk, n_valid, q_blk):
        shard_idx = jax.lax.axis_index(db_axis)
        blk = db_blk.shape[0]
        row0 = shard_idx * blk
        n_shards = mesh.shape[db_axis]
        if k > n_shards * min(k, blk):
            # surfaced at trace time with the real constraint, instead of
            # an opaque lax.top_k failure deep inside merge_top_k
            raise ScannError.invalid_argument(
                f"k={k} exceeds the {n_shards * min(k, blk)} gathered "
                f"candidates ({n_shards} shards x {blk} rows); clamp k to "
                "the padded database size")

        dists = many_to_many(measure, q_blk, db_blk, norms_blk)
        # mask padded / out-of-range rows globally
        col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1) + row0
        dists = jnp.where(col < n_valid, dists, MASKED_DISTANCE)

        k_local = min(k, blk)
        vals, idx = top_k_smallest(dists, k_local)
        idx = idx + row0

        all_vals = jax.lax.all_gather(vals, db_axis, axis=1, tiled=True)   # [B, S*k]
        all_idx = jax.lax.all_gather(idx, db_axis, axis=1, tiled=True)
        out_vals, out_idx = merge_top_k(all_vals, all_idx, k)
        missing = out_vals >= MASKED_DISTANCE / 2
        return (jnp.where(missing, jnp.inf, out_vals),
                jnp.where(missing, -1, out_idx))

    return jax.jit(_kernel)


def sharded_kmeans_step(mesh: Mesh, k: int, db_axis: str = "db"):
    """One Lloyd's iteration over sharded data.

    Returns fn(data_blk [N,D] sharded, centers [K,D] replicated, n_valid) ->
    (new_centers [K,D] replicated, counts [K], inertia scalar). ``n_valid``
    is the REAL global row count: shard_rows pads the leading dim to a
    multiple of the mesh size, and unmasked zero-padding rows would count
    as datapoints — dragging centroids toward the origin and inflating
    counts/inertia on any N not divisible by the device count.
    """

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None), P()),
        out_specs=(P(None, None), P(None), P()),
        check_vma=False,
    )
    def _step(data_blk, centers, n_valid):
        from scann_tpu.trees.kmeans import assign_clusters

        # cluster sums via chunked one-hot matmuls, NOT segment_sum (see
        # trees/kmeans.py _lloyd_sums); chunking keeps the [chunk, K]
        # one-hot small for million-row shards
        assign, min_d = assign_clusters(data_blk, centers)
        nb, d = data_blk.shape
        row0 = jax.lax.axis_index(db_axis) * nb
        valid = row0 + jnp.arange(nb, dtype=jnp.int32) < n_valid
        # padding rows join no cluster and contribute no inertia
        assign = jnp.where(valid, assign, -1)
        min_d = jnp.where(valid, min_d, 0.0)
        chunk = min(65536, max(nb, 1))
        n_chunks = -(-nb // chunk)
        n_pad = n_chunks * chunk
        data_p = jnp.pad(data_blk, ((0, n_pad - nb), (0, 0)))
        # padded rows get assignment -1: matches no cluster column
        assign_p = jnp.pad(assign, (0, n_pad - nb), constant_values=-1)
        cols = jnp.arange(k, dtype=jnp.int32)[None, :]

        def body(carry, xs):
            sums_c, counts_c = carry
            x, a = xs
            onehot = (a[:, None] == cols).astype(jnp.float32)
            sums_c = sums_c + jax.lax.dot_general(
                onehot, x, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            return (sums_c, counts_c + jnp.sum(onehot, axis=0)), None

        (sums, counts), _ = jax.lax.scan(
            body, (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
            (data_p.reshape(n_chunks, chunk, d),
             assign_p.reshape(n_chunks, chunk)))
        sums = jax.lax.psum(sums, db_axis)
        counts = jax.lax.psum(counts, db_axis)
        inertia = jax.lax.psum(jnp.sum(min_d), db_axis)
        new_centers = jnp.where(
            (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], centers)
        return new_centers, counts, inertia

    return jax.jit(_step)


class ShardedBruteForceSearcher(Searcher):
    """Exact search with the database sharded over a chip mesh.

    The BASELINE north-star scale-out: [N, D] rows live shard-wise in each
    device's memory; queries broadcast; per-shard top-k partials merge
    across devices.
    """

    def __init__(self, dataset: DenseDataset,
                 distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                 mesh: Optional[Mesh] = None):
        self._dataset = dataset
        self._measure = distance_measure
        self.mesh = mesh or make_mesh(axis_names=("db",))
        # host array straight into the sharded layout: no device-0 staging
        # copy, so the database can exceed one chip's HBM
        self._db, self._n = shard_rows(self.mesh, dataset.numpy())
        self._norms = jax.jit(
            squared_norms,
            out_shardings=jax.sharding.NamedSharding(self.mesh, P("db")),
        )(self._db)
        self._kernels = {}

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        queries = self._validate_queries(queries)
        k = min(int(k), self.dataset_size())
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        if k not in self._kernels:
            self._kernels[k] = sharded_search_kernel(self.mesh, self._measure, k)
        q = replicate(self.mesh, jnp.asarray(queries))
        dists, idx = self._kernels[k](self._db, self._norms, jnp.int32(self._n), q)
        dists, idx = np.asarray(dists), np.asarray(idx)
        # single-stage exact search: the tighter of pre/post epsilon applies
        # to the returned distances, same as BruteForceSearcher
        eps = params.effective_epsilon() if params is not None else np.inf
        if np.isfinite(eps):
            over = dists > eps
            dists = np.where(over, np.inf, dists)
            idx = np.where(over, -1, idx)
        return idx, dists
