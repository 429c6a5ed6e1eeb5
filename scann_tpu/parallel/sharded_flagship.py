"""Database sharding for the flagship searchers (LUT16 sweep + tree-×-AH).

Scale-out pattern (SURVEY §2.6): database rows never move — each shard
scores its own block, re-ranks its own candidates against its own raw rows
(everything local), and only [k]-sized exact partials cross devices
(`all_gather` + merge). Recall is >= the single-device searcher at equal
knobs: every shard keeps a full local pre_k, so the global top-pre_k is a
subset of the union of local candidate sets.

The shard-local bodies reuse the SAME stages as the single-device
searchers — the block-min sweep (ops/sweep_pallas.sweep_block_candidates)
and the tree-AH leaf scorer chosen by the platform
(models/tree_x_hybrid.tree_ah_search's ``scorer``). Shard-local scoring
needs no cross-device communication, so scale-out is pure composition.

Feature parity with the single-device paths: the searcher's configured
``distance_measure`` is threaded into every stage (cosine queries are
normalized exactly as the single-device wrappers do; MIPS builds -dot
LUTs), restrict allowlists fuse into scoring as masks, and per-query
``pre/post_reordering_epsilon`` thresholds ride as dynamic scalars in the
measure's own units (reference: src/searcher.rs:12-30,
src/brute_force/top_k.rs:263-393).

Tree-×-AH shards by **partition ownership**: partitions are bin-packed onto
shards by size, each shard holds its partitions' CSR code block plus the
matching raw rows in the same local CSR order (so exact re-ranking gathers
locally), and unowned partitions enter the shared search body with size 0.
Centroids/codebooks replicate (KBs–MBs).

The reference is single-process (Cargo.toml has no distribution deps) — this
module is a scale-out the reference never had.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import (
    SearchParameters,
    Searcher,
    pad_results_to_k,
)
from scann_tpu.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
)
from scann_tpu.ops.lut16_scoring import lut_score
from scann_tpu.ops.topk import (
    approx_top_k_smallest,
    keep_best_per_id,
    merge_top_k,
    top_k_smallest,
    top_k_unique,
)
from scann_tpu.parallel.mesh import make_mesh, replicate, shard_rows
from scann_tpu.types import MASKED_DISTANCE, align_up


def _merge_partials(vals, idx, k: int, multiplicity: int, post_eps,
                    db_axis: str):
    """all_gather the [B, k_local] exact partials across devices and merge to the
    global top-k, applying the post-reordering threshold."""
    all_vals = jax.lax.all_gather(vals, db_axis, axis=1, tiled=True)
    all_idx = jax.lax.all_gather(idx, db_axis, axis=1, tiled=True)
    if multiplicity > 1:
        out_vals, out_idx = top_k_unique(all_vals, all_idx, k, multiplicity)
    else:
        out_vals, out_idx = merge_top_k(all_vals, all_idx, k)
    missing = (out_vals >= MASKED_DISTANCE / 2) | (out_vals > post_eps)
    return (jnp.where(missing, jnp.inf, out_vals),
            jnp.where(missing, -1, out_idx))


# ---------------------------------------------------------------------------
# sharded LUT16 sweep (AsymmetricHasher scale-out)
# ---------------------------------------------------------------------------


def sharded_ah_sweep_kernel(mesh: Mesh, *, pre_k: int, k: int,
                            measure: DistanceMeasure,
                            with_mask: bool = False, db_axis: str = "db",
                            dequant=None):
    """fn(centroids, codes, db [N,D] row-sharded, norms [N] sharded, n_valid,
    queries replicated[, allow_mask sharded], pre_eps, post_eps)
    -> (dists, idx). Codes [N, S] u8 row-sharded, one-hot lut_score per
    shard.

    Per shard: sweep over the local code block -> local approx top-pre_k
    -> local exact re-rank -> local top-k; all_gather + merge.
    """
    from scann_tpu.hashes.hasher import _ah_luts

    in_specs = [P(), P(db_axis, None), P(db_axis, None), P(db_axis), P(),
                P(None, None)]
    if with_mask:
        in_specs.append(P(db_axis))
    in_specs += [P(), P()]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    def _kern(centroids, codes_blk, db_blk, norms_blk, n_valid, queries,
              *rest):
        if with_mask:
            mask_blk, pre_eps, post_eps = rest
        else:
            (pre_eps, post_eps), mask_blk = rest, None
        shard = jax.lax.axis_index(db_axis)
        blk = db_blk.shape[0]
        row0 = shard * blk
        nv_loc = jnp.clip(n_valid - row0, 0, blk)

        luts = _ah_luts(queries, centroids, measure)          # [B, S, C]

        approx = lut_score(luts, codes_blk)                   # [B, blk]
        col = jax.lax.broadcasted_iota(jnp.int32, approx.shape, 1)
        ok = col < nv_loc
        if mask_blk is not None:
            ok = ok & mask_blk[None, :]
        approx = jnp.where(ok, approx,
                           jnp.asarray(MASKED_DISTANCE, approx.dtype))
        pk = min(pre_k, blk)
        avals, cand = approx_top_k_smallest(approx, pk)
        approx = avals.astype(jnp.float32)
        pre_valid = approx < MASKED_DISTANCE / 2

        # epsilon compares in the measure's own units (COSINE approx scores
        # are 2x the cosine distance — advisor r2 finding)
        approx_m = approx_to_measure_units(approx, measure)
        pre_valid = pre_valid & (approx_m <= pre_eps) & (cand < nv_loc)

        safe = jnp.clip(cand, 0, blk - 1)
        rows = jnp.take(db_blk, safe, axis=0)
        if dequant is not None:
            # int8 rerank copy: dequant only the gathered candidates
            rows = rows.astype(jnp.float32) * dequant[0] + dequant[1]
        elif rows.dtype != jnp.float32:
            rows = rows.astype(jnp.float32)  # bf16 rerank copy
        # norms recomputed from the gathered f32 rows (identical math, no
        # per-element norm gather)
        nrm = jnp.sum(rows * rows, axis=-1)
        exact = gathered_distances(measure, queries, rows, nrm)
        exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
        # local partials can be narrower than k (pk = blk when k > blk),
        # but the merged width must be the requested k: the all_gather
        # supplies n_sh*k_local >= k candidates (k <= n <= n_sh*blk)
        vals, pos = top_k_smallest(exact, min(k, pk))
        idx = jnp.take_along_axis(cand, pos, axis=1) + row0
        idx = jnp.where(vals < MASKED_DISTANCE / 2, idx, -1)
        return _merge_partials(vals, idx, k, 1, post_eps, db_axis)

    return jax.jit(_kern)


class ShardedAsymmetricHasher(Searcher):
    """LUT16/PQ sweep with codes + raw rows sharded over the mesh."""

    def __init__(self, hasher, mesh: Optional[Mesh] = None):
        """Wrap a built single-device AsymmetricHasher (train once on host,
        serve sharded)."""
        if hasher.codebook is None or hasher._dataset is None:
            raise ScannError.failed_precondition(
                "hasher must be built with store_dataset=True")
        self._inner = hasher
        self._measure = hasher.config.distance_measure
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        n = hasher.dataset_size()
        blk = int(align_up(-(-n // n_sh), 8))
        n_pad = n_sh * blk
        self._blk = blk

        # cosine: the inner hasher normalized its stored dataset at build;
        # the shards inherit the normalized rows
        data = hasher._dataset.numpy()
        sh = lambda a, spec: jax.device_put(a, NamedSharding(self.mesh, spec))
        codes = np.zeros((n_pad, hasher.codes.shape[1]), np.uint8)
        codes[:n] = hasher.codes
        self._codes = sh(jnp.asarray(codes), P("db", None))
        # rerank copy in the wrapped hasher's configured dtype — the raw-row
        # slab is the dominant per-shard allocation (same lever as
        # rerank_dtype everywhere else; codec shared via rerank_codec)
        from scann_tpu.utils.reordering import (
            encode_rerank_rows,
            rerank_codec,
            rerank_norms_fn,
        )

        rdt = getattr(hasher.config, "rerank_dtype", "float32")
        db_dt, encode, self._dequant = rerank_codec(data, n, rdt)
        db = np.zeros((n_pad, data.shape[1]), db_dt)
        encode_rerank_rows(db, data, n, encode)
        self._db = sh(jnp.asarray(db), P("db", None))
        self._norms = rerank_norms_fn(
            self._dequant,
            out_shardings=NamedSharding(self.mesh, P("db")))(self._db)
        self._cent = replicate(self.mesh, hasher.codebook.centroids_device())
        self._n = n
        self._kernels = {}

    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        queries = self._validate_queries(queries)
        if self._measure == DistanceMeasure.COSINE:
            # symmetric to the inner hasher's build-time row normalization
            qn = np.sqrt(np.einsum("bd,bd->b", queries, queries))
            queries = queries / np.maximum(qn, 1e-30)[:, None]
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        pre_k = 3 * k
        pre_eps = post_eps = np.inf
        if params is not None:
            if params.pre_reordering_num_neighbors is not None:
                pre_k = int(params.pre_reordering_num_neighbors)
            if params.pre_reordering_epsilon is not None:
                pre_eps = float(params.pre_reordering_epsilon)
            if params.post_reordering_epsilon is not None:
                post_eps = float(params.post_reordering_epsilon)
        pre_k = min(max(pre_k, k), self._blk)
        with_mask = allow_mask is not None

        key = (pre_k, k, with_mask)
        if key not in self._kernels:
            self._kernels[key] = sharded_ah_sweep_kernel(
                self.mesh, pre_k=pre_k, k=k, measure=self._measure,
                with_mask=with_mask, dequant=self._dequant)
        q = replicate(self.mesh, jnp.asarray(queries))
        args = [self._cent, self._codes, self._db, self._norms,
                jnp.int32(self._n), q]
        if with_mask:
            m = np.zeros(self._db.shape[0], dtype=bool)
            m[: self._n] = np.asarray(allow_mask, dtype=bool)[: self._n]
            args.append(jax.device_put(
                jnp.asarray(m), NamedSharding(self.mesh, P("db"))))
        args += [jnp.float32(pre_eps), jnp.float32(post_eps)]
        dists, idx = self._kernels[key](*args)
        return np.asarray(idx), np.asarray(dists)


# ---------------------------------------------------------------------------
# sharded tree-×-AH (partition-ownership sharding)
# ---------------------------------------------------------------------------


def sharded_tree_ah_kernel(mesh: Mesh, *, p: int, pre_k: int, k: int,
                           l_cap: int, use_residuals: bool,
                           measure: DistanceMeasure,
                           multiplicity: int = 1,
                           approx_select_min: int = 1024,
                           scorer: str = "pairs",
                           with_mask: bool = False,
                           db_axis: str = "db",
                           dequant=None,
                           spill_dedup: bool = True,
                           residual_anchor: bool = False):
    """fn(centers, codebook, codes, offsets [Sh,K], sizes [Sh,K],
    perm [Sh,L], db_csr [Sh,L,D], norms_csr [Sh,L], queries[, allow_mask
    replicated [N]], pre_eps, post_eps) -> (dists, idx).

    ``codes``: each shard's slab in the serving layout of ``scorer``
    (models/tree_x_hybrid.code_slab) — the same leaf scorer the
    single-device searcher serves with (shard-local, no collectives).

    Every shard runs the same partition selection (replicated centroids) and
    scores only the partitions it owns (others have size 0); exact re-rank
    gathers the shard's own raw rows (stored in local CSR order), and the
    [k]-sized exact partials merge across devices.
    """
    from scann_tpu.models.tree_x_hybrid import (
        _residual_luts,
        _select_partitions,
        candidate_rows_from_positions,
        leaf_scores_grouped,
        leaf_scores_xla,
    )

    codes_spec = P(db_axis, None, None)
    in_specs = [P(), P(), codes_spec, P(db_axis, None), P(db_axis, None),
                P(db_axis, None), P(db_axis, None, None), P(db_axis, None),
                P(None, None)]
    if residual_anchor:
        in_specs.append(P(db_axis, None))    # per-row anchor tokens
    if with_mask:
        in_specs.append(P())
    in_specs += [P(), P()]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    def _kern(centers, codebook, codes, offsets, sizes, perm, db_csr,
              norms_csr, queries, *rest):
        rest = list(rest)
        tok_csr = rest.pop(0)[0] if residual_anchor else None
        allow_mask = rest.pop(0) if with_mask else None
        pre_eps, post_eps = rest
        codes = codes[0]              # one shard's code_slab
        offsets = offsets[0]          # [K] local CSR starts
        sizes = sizes[0]              # [K] zero for unowned partitions
        perm = perm[0]                # [L_sh] local row -> global point id
        db_csr = db_csr[0]            # [L_sh, D]
        norms_csr = norms_csr[0]      # [L_sh]

        parts = _select_partitions(centers, queries, p=p,
                                   approx_min=approx_select_min,
                                   measure=measure)
        s_pad = align_up(codebook.shape[0], 2)
        num_rows = codes.shape[1] if scorer == "grouped" else codes.shape[0]
        luts_flat = _residual_luts(queries, centers, parts, codebook,
                                   s_pad=s_pad, use_residuals=use_residuals,
                                   measure=measure)

        if scorer == "grouped":
            flat_scores, rows_il = leaf_scores_grouped(
                luts_flat, parts, codes, offsets, sizes,
                p=p, l_cap=l_cap, c=codebook.shape[1])
        else:
            flat_scores, rows_il = leaf_scores_xla(
                luts_flat, parts, codes, offsets, sizes,
                p=p, l_cap=l_cap, c=codebook.shape[1])
        if allow_mask is not None:
            # restricts as pre-selection hard filters (reference semantics:
            # tree_x_hybrid/mod.rs:297-339), same fusion as the
            # single-device path
            allow_csr = jnp.take(allow_mask, jnp.maximum(perm, 0), axis=0)
            allowed = jnp.take(allow_csr, rows_il, axis=0)
            flat_scores = jnp.where(
                allowed, flat_scores,
                jnp.asarray(MASKED_DISTANCE, flat_scores.dtype))

        mult = max(int(multiplicity), 1)
        dedup_first = spill_dedup and mult > 1
        sel_k = min(pre_k * mult, p * l_cap) if mult > 1 \
            else min(pre_k, p * l_cap)
        pre_vals, pre_pos = approx_top_k_smallest(flat_scores, sel_k)
        # arithmetic row resolution (not take_along_axis over the
        # materialized [B, p*l_cap] tensor)
        pre_rows = candidate_rows_from_positions(
            parts, offsets, num_rows, pre_pos, p=p)
        pre_vals = pre_vals.astype(jnp.float32)
        pre_m = approx_to_measure_units(pre_vals, measure)
        pre_valid = (pre_vals < MASKED_DISTANCE / 2) & (pre_m <= pre_eps)
        pk = sel_k
        if dedup_first:
            # collapse a spilled point's shard-local copies BEFORE the
            # rerank gather (same lever as the single-device _finalize:
            # the gather is the latency floor, run it at unique depth).
            # Cross-SHARD copies still exist — the merge dedups those.
            ids = jnp.take(perm, pre_rows, axis=0)
            masked = jnp.where(pre_valid, pre_vals, MASKED_DISTANCE)
            pk = min(pre_k, sel_k)
            dvals, ids_u, pre_rows = keep_best_per_id(
                masked, ids, pk, payload=pre_rows)
            pre_valid = dvals < MASKED_DISTANCE / 2
            pre_rows = jnp.clip(pre_rows, 0, db_csr.shape[0] - 1)

        rrows = jnp.take(db_csr, pre_rows, axis=0)
        if dequant is not None:
            # int8 rerank copy (rerank_dtype='int8'): u8 codes dequantize
            # only for the gathered candidates, same as the single-device
            # _finalize (models/tree_x_hybrid.py)
            rrows = rrows.astype(jnp.float32) * dequant[0] + dequant[1]
            if residual_anchor:
                # residual-anchored codec: codes hold row − its
                # partition's centroid; add the anchor back (per-row
                # token table + small centroid-table row gather)
                tok_l = jnp.take(tok_csr, pre_rows, axis=0)
                rrows = rrows + jnp.take(centers, tok_l, axis=0)
        elif rrows.dtype != jnp.float32:
            # bf16 rerank copy: exact math in f32 on the rounded rows
            rrows = rrows.astype(jnp.float32)
        # norms recomputed from the gathered f32 rows (see above)
        rnorm = jnp.sum(rrows * rrows, axis=-1)
        exact = gathered_distances(measure, queries, rrows, rnorm)
        exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
        if dedup_first:
            # local candidates are already unique: k local slots suffice
            # (a global top-k point is local top-k on every shard holding
            # a copy — identical exact distance); cross-shard duplicates
            # are removed by the multiplicity-aware merge below
            k_local = min(k, pk)
            vals, pos = top_k_smallest(exact, k_local)
            idx = jnp.take_along_axis(ids_u, pos, axis=1)
        else:
            # legacy: over-fetch by the spill multiplicity — a point's
            # copies each hold an exact slot until the merge dedups
            k_local = min(k * mult, pk)
            vals, pos = top_k_smallest(exact, k_local)
            sel_rows = jnp.take_along_axis(pre_rows, pos, axis=1)
            idx = jnp.take(perm, sel_rows, axis=0)
        idx = jnp.where(vals < MASKED_DISTANCE / 2, idx, -1)
        # the all_gather supplies n_shards*k_local candidates; when the
        # per-shard candidate ceiling makes that less than k, merge to
        # what is reachable (the wrapper pads back to [B, k])
        k_merge = min(k, mesh.shape[db_axis] * k_local)
        return _merge_partials(vals, idx, k_merge, multiplicity, post_eps,
                               db_axis)

    return jax.jit(_kern)


def _map_row_chunks(fn, k: int, *rows):
    """``fn`` over row chunks of a shard's [n, ...] arrays (lax.map), so the
    [chunk, K] distance intermediates stay bounded
    (trees/kmeans.adaptive_row_chunk) instead of one [n, K] matrix per
    shard. Outputs are concatenated back to n rows."""
    from scann_tpu.trees.kmeans import adaptive_row_chunk

    n = rows[0].shape[0]
    chunk = adaptive_row_chunk(131072, n, k)
    n_pad = -(-n // chunk) * chunk
    split = [jnp.pad(a, [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1)).reshape(
        (n_pad // chunk, chunk) + a.shape[1:]) for a in rows]
    out = jax.lax.map(lambda xs: fn(*xs), tuple(split))
    return jax.tree_util.tree_map(
        lambda o: o.reshape((n_pad,) + o.shape[2:])[:n], out)


def sharded_topr_kernel(mesh: Mesh, *, r: int, measure: DistanceMeasure,
                        db_axis: str = "db"):
    """fn(data [N,D] row-sharded, centers [K,D] replicated) ->
    (dists [N,r] ascending, choices [N,r]) row-sharded — each shard's
    top-r nearest centers per row (the balance cap's candidate table)."""
    from scann_tpu.partitioning.tree_partitioner import (
        select_partitions_kernel,
    )

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None)),
        out_specs=(P(db_axis, None), P(db_axis, None)),
        check_vma=False,
    )
    def _topr(data_blk, centers):
        return _map_row_chunks(
            lambda x: select_partitions_kernel(centers, x, measure=measure,
                                               p=r),
            centers.shape[0], data_blk)

    return jax.jit(_topr)


def sharded_assign_kernel(mesh: Mesh, db_axis: str = "db"):
    """fn(data [N,D] row-sharded, centers [K,D] replicated) -> tokens [N]
    row-sharded int32 — each shard assigns its own rows (distance matmul +
    argmin, trees/kmeans.assign_clusters), no row ever moves."""
    from scann_tpu.trees.kmeans import assign_clusters

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None)),
        out_specs=P(db_axis),
        check_vma=False,
    )
    def _assign(data_blk, centers):
        a, _ = assign_clusters(data_blk, centers)
        return a.astype(jnp.int32)

    return jax.jit(_assign)


def sharded_residual_encode_kernel(mesh: Mesh, db_axis: str = "db"):
    """fn(data [N,D] row-sharded, centers [K,D] replicated, tokens [N]
    row-sharded, codebook [S,C,dsub] replicated) -> codes [N,S] row-sharded
    uint8. Each shard computes its rows' residuals against their assigned
    centroid and PQ-encodes them locally (hashes/codebook.encode_kernel) —
    the full residual tensor never exists anywhere."""
    from scann_tpu.hashes.codebook import encode_kernel

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None), P(db_axis),
                  P(None, None, None)),
        out_specs=P(db_axis, None),
        check_vma=False,
    )
    def _encode(data_blk, centers, tokens_blk, codebook):
        resid = data_blk - jnp.take(centers, tokens_blk, axis=0)
        return encode_kernel(resid, codebook).astype(jnp.uint8)

    return jax.jit(_encode)


def sharded_soar_select_kernel(mesh: Mesh, *, r: int, lam: float,
                               db_axis: str = "db"):
    """fn(data [N,D] row-sharded, centers [K,D] replicated, primary [N]
    row-sharded) -> secondary tokens [N] row-sharded int32 — each shard
    runs the SOAR orthogonality-amplified selection on its own rows
    (partitioning/tree_partitioner.soar_select_kernel; replicated
    centers, no row movement)."""
    from scann_tpu.partitioning.tree_partitioner import soar_select_kernel

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None), P(db_axis)),
        out_specs=P(db_axis),
        check_vma=False,
    )
    def _soar(data_blk, centers, prim_blk):
        return _map_row_chunks(
            lambda x, prim: soar_select_kernel(centers, x, prim,
                                               jnp.float32(lam), r=r),
            centers.shape[0], data_blk, prim_blk)

    return jax.jit(_soar)


def sharded_avq_encode_kernel(mesh: Mesh, *, eta: float,
                              db_axis: str = "db"):
    """AVQ (score-aware) per-shard residual encode: like
    sharded_residual_encode_kernel but through the anisotropic
    coordinate-descent assignment (hashes/avq.avq_encode_kernel), with the
    shard's RAW rows as the protected directions — codes then match the
    anisotropically trained codebook's loss instead of silently reverting
    to plain L2 argmin (advisor r4 finding)."""
    from scann_tpu.hashes.avq import avq_encode_kernel, unit_directions

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None), P(db_axis),
                  P(None, None, None)),
        out_specs=P(db_axis, None),
        check_vma=False,
    )
    def _encode(data_blk, centers, tokens_blk, codebook):
        resid = data_blk - jnp.take(centers, tokens_blk, axis=0)
        return avq_encode_kernel(
            resid, unit_directions(data_blk), codebook,
            jnp.float32(eta)).astype(jnp.uint8)

    return jax.jit(_encode)


def sharded_tree_ah_build(dataset, config, mesh: Optional[Mesh] = None,
                          verbose: bool = False):
    """Build tree-×-AH end-to-end with the database only ever ROW-SHARDED
   : no single device ever holds the full dataset, so
    the N-chip capacity the sharded wrapper serves is also buildable.

    Stages (SURVEY §7 step 8; single-device analog:
    models/tree_x_hybrid.TreeXHybridSearcher.build):

      1. k-means init on a host sample (k-means++, trees/kmeans.KMeans)
         — the sample is small by construction;
      2. Lloyd refinement over the FULL row-sharded data via
         parallel/sharded.sharded_kmeans_step (per-shard one-hot
         segment-sums, psum across devices), empty clusters reseeded from
         random rows (reference: kmeans.rs:405-410);
      3. per-shard token assignment (sharded_assign_kernel), then the LBG
         balance rounds (shared lbg_grow_centers splitting + sharded
         Lloyd refinement + per-shard re-assign + the shared hard-demote)
         — the discipline that drives build quality;
      4. PQ codebook trained on a host residual sample;
      5. per-shard residual encode into uint8 codes
         (sharded_residual_encode_kernel) — only the [N, S] code bytes
         come back to host for the CSR layout, never the residuals;
      6. the per-shard CSR serving layout (ShardedTreeXHybridSearcher).

    Spilling (distance-rule) and SOAR secondary assignment run per shard
    (sharded_soar_select_kernel / a top-2 threshold rule over
    sharded_topr_kernel) with the per-assignment residual encode done in
    one extra sharded pass — a point's secondary code encodes the
    residual against ITS partition's centroid, exactly like the
    single-device build. Hierarchical partitioning (num_levels > 1)
    trains the k-means tree on the host sample for INITIAL leaf centers,
    then refines them over the full row-sharded data with the same Lloyd
    steps (leaves are flat at serving time either way). The straggler
    split (the hard-cap guarantee) remains single-device-only.

    Returns a serving ShardedTreeXHybridSearcher whose ``_inner`` holds the
    trained artifacts (partitioner, codebook, per-assignment codes), so
    io.py and every single-device tool keep working.
    """
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.codebook import Codebook, CodebookConfig
    from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher
    from scann_tpu.partitioning.partitioner import DatabaseTokenization
    from scann_tpu.partitioning.tree_partitioner import (
        TreePartitioner,
        TreePartitionerConfig,
    )
    from scann_tpu.parallel.sharded import sharded_kmeans_step
    from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit

    cfg = config
    mesh = mesh or make_mesh(axis_names=("db",))
    if dataset.is_empty:
        raise ScannError.invalid_argument("Cannot build from empty dataset")
    if cfg.distance_measure == DistanceMeasure.COSINE:
        raw = dataset.numpy()
        norms = np.sqrt(np.einsum("nd,nd->n", raw, raw))
        dataset = DenseDataset(
            (raw / np.maximum(norms, 1e-30)[:, None]).astype(np.float32),
            docids=dataset.docids)
    data = dataset.numpy()
    n, d = data.shape
    kparts = min(cfg.num_partitions, n)
    seed = cfg.hash_config.seed if cfg.hash_config.seed is not None else 42
    rng = np.random.default_rng(seed)

    # 1. init centers from a host sample (sample-Lloyd = the init, like the
    # single-device training_sample_size path)
    sample_n = cfg.partition_training_sample_size or min(
        n, max(100 * kparts, 10_000))
    sample_idx = (rng.choice(n, sample_n, replace=False) if sample_n < n
                  else np.arange(n))
    if cfg.partition_num_levels > 1:
        # hierarchical init: leaves of a k-means tree over the sample
        # (single-device analog: tree_partitioner._build_hierarchical);
        # the full-data sharded Lloyd refinement below flattens/refines
        # them — serving uses flat leaf centers in both builds
        from scann_tpu.trees.kmeans_tree import KMeansTree, KMeansTreeConfig

        fan = max(int(np.ceil(kparts ** (1.0 / cfg.partition_num_levels))),
                  2)
        tree = KMeansTree(KMeansTreeConfig(
            num_children=fan, max_depth=cfg.partition_num_levels,
            max_iterations=cfg.partition_max_iterations,
            seed=seed)).build(data[sample_idx])
        centers = tree.leaf_centers().astype(np.float32)
        kparts = centers.shape[0]
    else:
        km = KMeans(KMeansConfig(
            num_clusters=kparts,
            max_iterations=cfg.partition_max_iterations,
            convergence_threshold=cfg.partition_convergence_threshold,
            init_method=KMeansInit.KMEANS_PLUS_PLUS, seed=seed))
        centers = km.fit(data[sample_idx]).centers.astype(np.float32)

    # 2. Lloyd refinement over the full sharded data
    data_sh, n_real = shard_rows(mesh, data)
    step = sharded_kmeans_step(mesh, k=kparts)
    cent_dev = jnp.asarray(centers)
    prev_inertia = np.inf
    for it in range(max(int(cfg.partition_max_iterations), 1)):
        cent_dev, counts, inertia = step(data_sh, cent_dev,
                                         jnp.int32(n_real))
        counts_np = np.asarray(counts)
        empties = np.nonzero(counts_np == 0)[0]
        if len(empties):
            # reseed empty clusters from random rows (kmeans.rs:405-410)
            cent_np = np.asarray(cent_dev)
            cent_np[empties] = data[rng.integers(0, n, len(empties))]
            cent_dev = jnp.asarray(cent_np)
        inertia = float(inertia)
        if verbose:
            print(f"sharded-build lloyd it={it} inertia={inertia:.4g}")
        if np.isfinite(prev_inertia) and (prev_inertia - inertia) <= \
                abs(prev_inertia) * cfg.partition_convergence_threshold:
            break
        prev_inertia = inertia
    centers = np.asarray(cent_dev)

    # 3. per-shard assignment
    assign = sharded_assign_kernel(mesh)
    tokens = np.asarray(assign(data_sh, cent_dev))[:n]

    # 3b. LBG balance rounds (the same splitting discipline as the
    # single-device _balance, which dominates build quality — it grows K
    # where partitions overflow and re-refines, roughly halving assignment
    # inertia on clustered data): split oversized partitions by jittered
    # member copies, bucket K to 256, refine with sharded Lloyd steps,
    # re-assign per shard; finally hard-demote via the shared cap loop.
    # Straggler splitting (the hard-cap guarantee) remains
    # single-device-only.
    if cfg.max_partition_size is not None:
        from scann_tpu.partitioning.tree_partitioner import (
            demote_to_cap,
            lbg_grow_centers,
        )

        cap = cfg.max_partition_size
        if cap == "auto":
            cap = max(int(1.5 * n / max(min(kparts, n), 1)), 8)
        cap = int(cap)
        steps_by_k = {}  # reuse the jitted Lloyd step per K (compiles once)
        for _ in range(4):  # TreePartitionerConfig.balance_rounds default
            grown = lbg_grow_centers(data, tokens, centers, cap, rng)
            if grown is None:
                break
            centers = grown
            cent_dev = jnp.asarray(centers)
            k_pad = centers.shape[0]
            if k_pad not in steps_by_k:
                steps_by_k[k_pad] = sharded_kmeans_step(mesh, k=k_pad)
            for _ in range(3):
                cent_dev, _, _ = steps_by_k[k_pad](data_sh, cent_dev,
                                                   jnp.int32(n_real))
            centers = np.asarray(cent_dev)
            tokens = np.asarray(assign(data_sh, cent_dev))[:n]
        kparts = centers.shape[0]
        sizes_now = np.bincount(tokens, minlength=kparts)
        if sizes_now.max() > cap:
            r = min(12, kparts)
            d_r, c_r = sharded_topr_kernel(
                mesh, r=r, measure=cfg.distance_measure)(data_sh, cent_dev)
            tokens = demote_to_cap(np.asarray(d_r)[:n], np.asarray(c_r)[:n],
                                   cap, rounds=12)

    # 3c. secondary assignments (spilling / SOAR), computed per shard
    cent_dev = jnp.asarray(centers)
    sec_full = None
    extra = None
    if cfg.spilling:
        if cfg.spilling_mode == "soar":
            soar = sharded_soar_select_kernel(
                mesh, r=min(8, kparts), lam=float(cfg.soar_lambda))
            tok_pad = jax.device_put(
                np.pad(tokens, (0, data_sh.shape[0] - n)),
                NamedSharding(mesh, P("db")))
            sec_full = np.asarray(soar(data_sh, cent_dev, tok_pad))[:n]
            extra = np.stack(
                [np.arange(n, dtype=np.int64), sec_full.astype(np.int64)],
                axis=1)
        else:
            # distance rule: 2nd-nearest within the ratio threshold
            d2, t2 = sharded_topr_kernel(
                mesh, r=2, measure=cfg.distance_measure)(data_sh, cent_dev)
            d2 = np.asarray(d2)[:n]
            t2 = np.asarray(t2)[:n]
            ok = d2[:, 1] <= d2[:, 0] * (1.0 + cfg.spilling_threshold)
            sec_full = np.where(ok, t2[:, 1], -1).astype(np.int32)
            pts = np.nonzero(ok)[0]
            extra = np.stack([pts, t2[ok, 1].astype(np.int64)], axis=1)

    # the partitioner config mirrors the single-device build's so the
    # shared helpers (_cap_secondaries' cap value in particular) compute
    # identical bounds
    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=cfg.num_partitions, seed=seed,
        distance_measure=cfg.distance_measure,
        spilling=cfg.spilling, spilling_threshold=cfg.spilling_threshold,
        spilling_mode=cfg.spilling_mode, soar_lambda=cfg.soar_lambda,
        max_partition_size=cfg.max_partition_size))
    tp.centers = centers
    if extra is not None and cfg.max_partition_size is not None:
        extra = tp._cap_secondaries(extra, tokens, n)
    tp.tokenization = DatabaseTokenization(tokens, kparts,
                                           extra_pairs=extra)

    # 4. PQ codebook on a host residual sample
    hc = cfg.hash_config
    hs = min(hc.training_sample_size, n)
    h_idx = (rng.choice(n, hs, replace=False) if hs < n else np.arange(n))
    resid_sample = (data[h_idx] - centers[tokens[h_idx]]
                    if cfg.use_residuals else data[h_idx])
    codebook = Codebook(CodebookConfig(
        num_codes=hc.num_codes, num_subspaces=hc.num_subspaces,
        max_iterations=hc.max_iterations, seed=hc.seed,
        anisotropic_threshold=hc.anisotropic_threshold,
    )).train(resid_sample,
             directions=data[h_idx]
             if hc.anisotropic_threshold is not None else None)

    # 5. per-shard encode (codes come back as [N, S] bytes): the AVQ
    # coordinate-descent kernel when the codebook was trained
    # anisotropically — plain L2 argmin would silently mismatch the
    # trained loss (advisor r4 finding)
    if codebook.eta is not None:
        enc_fn = sharded_avq_encode_kernel(mesh, eta=float(codebook.eta))
    else:
        enc_fn = sharded_residual_encode_kernel(mesh)
    cb_dev = codebook.centroids_device()

    def encode_vs(tokens_np):
        """[N, S] u8 codes of every row's residual against tokens_np's
        centroid (raw rows when use_residuals is off), one sharded pass."""
        t_dev = jax.device_put(
            np.pad(tokens_np.astype(np.int32),
                   (0, data_sh.shape[0] - n)),
            NamedSharding(mesh, P("db")))
        e_tok = t_dev if cfg.use_residuals else jnp.zeros_like(t_dev)
        e_cent = cent_dev if cfg.use_residuals else jnp.zeros_like(cent_dev)
        return np.asarray(enc_fn(data_sh, e_cent, e_tok,
                                 cb_dev))[:n].astype(np.uint8)

    primary_codes = encode_vs(tokens)

    # 6. assemble the inner searcher (artifacts only — no single-device
    # serving slab is ever built; the sharded wrapper lays out per shard)
    inner = TreeXHybridSearcher(cfg)
    inner._dataset = dataset
    inner.partitioner = tp
    inner.codebook = codebook
    # per-assignment CSR row order: a spilled point's secondary row
    # encodes the residual against ITS partition's centroid (one extra
    # sharded pass) — same composition as the single-device build
    tk = tp.tokenization
    if cfg.spilling and sec_full is not None and cfg.use_residuals:
        secondary_codes = encode_vs(np.maximum(sec_full, 0))
        row_tokens = np.repeat(np.arange(kparts, dtype=np.int32),
                               tk.partition_sizes)
        pts = tk.point_indices
        is_primary = row_tokens == tokens[pts]
        inner.codes = np.where(is_primary[:, None], primary_codes[pts],
                               secondary_codes[pts])
    else:
        inner.codes = primary_codes[tk.point_indices]
    return ShardedTreeXHybridSearcher(inner, mesh)


def _bin_pack_partitions(sizes: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy largest-first bin packing; returns shard id per partition."""
    order = np.argsort(-sizes.astype(np.int64), kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    owner = np.zeros(len(sizes), dtype=np.int32)
    for t in order:
        s = int(np.argmin(load))
        owner[t] = s
        load[s] += int(sizes[t]) + 8  # +alignment slop
    return owner


def _compute_tree_shard_layout(searcher, n_sh: int) -> dict:
    """Per-shard host CSR layout for ShardedTreeXHybridSearcher: partitions
    bin-packed by size, each shard's codes + rerank rows in local CSR
    order. The canonical code slab is UNPACKED row-major [Sh, L_sh, S] —
    the leaf scorer's packing/transposition happens at device upload, so a
    saved layout serves every platform. This per-partition Python loop (plus
    the rerank encode) is the serving-restart cost warm start skips."""
    from scann_tpu.utils.reordering import rerank_codec

    tk = searcher.partitioner.tokenization
    data = searcher._dataset.numpy()
    kparts = tk.num_partitions
    sizes = tk.partition_sizes
    owner = _bin_pack_partitions(sizes, n_sh)

    from scann_tpu.models.tree_x_hybrid import leaf_cap

    l_cap = leaf_cap(tk.max_partition_size)
    s = searcher.codes.shape[1]
    d = data.shape[1]

    per_shard = []
    for sh in range(n_sh):
        mine = np.nonzero(owner == sh)[0]
        off_local = np.zeros(kparts, np.int32)
        aligned = 0
        blocks = []
        for t in mine:
            off_local[t] = aligned
            aligned += int(align_up(max(int(sizes[t]), 1), 128))
            blocks.append(t)
        per_shard.append((blocks, off_local, aligned))
    l_sh = int(align_up(max(a for _, _, a in per_shard) + l_cap, 8))

    # rerank copy in the wrapped searcher's configured dtype: the
    # [Sh, L_sh, D] raw-row slab is the dominant per-shard allocation
    # (same lever as single-device rerank_dtype; codec shared via
    # rerank_codec; docs/DESIGN.md "Device memory at scale"). int8 uses the
    # RESIDUAL-ANCHORED per-dim codec: each CSR row quantizes the
    # residual against ITS OWN partition's centroid (even finer than the
    # single-device primary-token anchor for spilled copies), with a
    # per-row token table so the kernel adds the centroid back after the
    # gather — same quality mechanism as the single-device store
    # (utils/reordering.residual_rerank_codec).
    rdt = getattr(searcher.config, "rerank_dtype", "float32")
    residual = rdt == "int8"
    tok_sh = None
    if residual:
        centers = searcher.partitioner.centers
        row_tokens = np.repeat(np.arange(kparts, dtype=np.int32),
                               tk.partition_sizes)
        ids_all = tk.point_indices
        # chunked residual min/max over every assignment (never
        # materializes the [M, D] gathered rows)
        r_mn = np.full(d, np.inf, np.float32)
        r_mx = np.full(d, -np.inf, np.float32)
        cs = max(1, (1 << 22) // max(d, 1))
        for lo in range(0, len(ids_all), cs):
            r = (data[ids_all[lo:lo + cs]]
                 - centers[row_tokens[lo:lo + cs]])
            r_mn = np.minimum(r_mn, r.min(axis=0))
            r_mx = np.maximum(r_mx, r.max(axis=0))
        r_scale = np.maximum((r_mx - r_mn) / 255.0, 1e-30).astype(np.float32)
        r_mn = r_mn.astype(np.float32)

        def enc_r(rows, toks):
            r = rows - centers[toks]
            return np.clip(np.rint((r - r_mn) / r_scale), 0,
                           255).astype(np.uint8)

        db_dt = np.uint8
        tok_sh = np.zeros((n_sh, l_sh), np.int32)
    else:
        db_dt, encode, _ = rerank_codec(data, len(data), rdt)

    codes_sh = np.zeros((n_sh, l_sh, s), np.uint8)
    perm_sh = np.zeros((n_sh, l_sh), np.int32)
    db_sh = np.zeros((n_sh, l_sh, d), db_dt)
    sizes_sh = np.zeros((n_sh, kparts), np.int32)
    offs_sh = np.zeros((n_sh, kparts), np.int32)
    csr_off = tk.offsets
    for sh, (blocks, off_local, _) in enumerate(per_shard):
        offs_sh[sh] = off_local
        for t in blocks:
            lo, sz = int(off_local[t]), int(sizes[t])
            sizes_sh[sh, t] = sz
            codes_sh[sh, lo : lo + sz] = \
                searcher.codes[csr_off[t] : csr_off[t] + sz]
            ids = tk.partition_indices(t)
            perm_sh[sh, lo : lo + sz] = ids
            if residual:
                db_sh[sh, lo : lo + sz] = enc_r(
                    data[ids], np.full(sz, t, np.int32))
                tok_sh[sh, lo : lo + sz] = t
            else:
                db_sh[sh, lo : lo + sz] = encode(data[ids])
    out = {"codes": codes_sh, "perm": perm_sh, "db": db_sh,
           "sizes": sizes_sh, "offs": offs_sh,
           "l_cap": l_cap, "n_sh": n_sh}
    if residual:
        out["tok"] = tok_sh
        out["dequant"] = (r_scale.tolist(), r_mn.tolist())
    return out


class ShardedTreeXHybridSearcher(Searcher):
    """Tree-×-AH served with partitions bin-packed across the mesh."""

    def __init__(self, searcher, mesh: Optional[Mesh] = None,
                 layout: Optional[dict] = None):
        """Wrap a built single-device TreeXHybridSearcher; shards serve
        with its leaf scorer (``searcher._leaf_scorer()``).

        ``layout``: precomputed per-shard host layout (save_layout /
        load_layout warm start) — skips the per-partition re-shard +
        rerank re-encode loop, the dominant serving-restart cost at scale
       ."""
        if searcher.codebook is None:
            raise ScannError.failed_precondition("searcher not built")
        self._inner = searcher
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        self._scorer = searcher._leaf_scorer()

        from scann_tpu.utils.reordering import rerank_norms_fn

        if layout is None:
            layout = _compute_tree_shard_layout(searcher, n_sh)
        elif int(layout["n_sh"]) != n_sh:
            raise ScannError.invalid_argument(
                f"saved layout was computed for {layout['n_sh']} shards, "
                f"mesh has {n_sh}")
        # int8 rerank: the residual-anchored codec params + per-row token
        # table travel in the layout (see _compute_tree_shard_layout)
        self._dequant = layout.get("dequant")
        if self._dequant is not None:
            self._dequant = (np.asarray(self._dequant[0], np.float32),
                             np.asarray(self._dequant[1], np.float32))
        self._l_cap = int(layout["l_cap"])
        codes_sh = layout["codes"]

        put = lambda a, spec: jax.device_put(
            jnp.asarray(a), NamedSharding(self.mesh, spec))

        from scann_tpu.models.tree_x_hybrid import code_slab

        num_codes = searcher.config.hash_config.num_codes
        self._codes = put(np.stack([code_slab(c, self._scorer, num_codes)
                                    for c in codes_sh]), P("db", None, None))
        self._perm = put(layout["perm"], P("db", None))
        self._db = put(layout["db"], P("db", None, None))
        self._tok = (put(layout["tok"], P("db", None))
                     if layout.get("tok") is not None else None)
        # norms are recomputed in-kernel from the gathered rows; this
        # table only pads the legacy arg slot (cheap — and for the
        # residual codec it would be wrong without the anchor anyway)
        self._norms = rerank_norms_fn(
            self._dequant,
            out_shardings=NamedSharding(self.mesh, P("db", None)))(self._db)
        self._sizes = put(layout["sizes"], P("db", None))
        self._offs = put(layout["offs"], P("db", None))
        self._cent = replicate(self.mesh, searcher.partitioner.centers_device())
        self._cb = replicate(self.mesh, searcher.codebook.centroids_device())
        self._kernels = {}

    def save_layout(self, path: str) -> None:
        """Persist the per-shard serving layout + the inner searcher's
        trained artifacts to one .npz — a serving restart then skips the
        re-shard + rerank re-encode (load_layout). The layout is
        recomputed here (build-session one-time cost) rather than retained
        in host RAM between searches."""
        from scann_tpu.io import save_sharded_layout

        save_sharded_layout(path, self)

    @classmethod
    def load_layout(cls, path: str, mesh: Optional[Mesh] = None):
        """Restore a wrapper saved with save_layout: artifacts + per-shard
        slabs load straight from disk into the sharded device layout."""
        from scann_tpu.io import load_sharded_layout

        return load_sharded_layout(path, cls, mesh=mesh)

    @classmethod
    def build(cls, dataset, config, mesh: Optional[Mesh] = None,
              verbose: bool = False):
        """Build end-to-end with the database only ever row-sharded over
        ``mesh`` (no single-device index materialization) — see
        sharded_tree_ah_build."""
        return sharded_tree_ah_build(dataset, config, mesh, verbose=verbose)

    def dataset_size(self) -> int:
        return self._inner.dataset_size()

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        queries = self._validate_queries(queries)
        cfg = self._inner.config
        if cfg.distance_measure == DistanceMeasure.COSINE:
            # symmetric to the inner searcher's build-time normalization
            # (tree_x_hybrid.py build): L2 partition selection and residual
            # LUTs then rank identically to cosine
            qn = np.sqrt(np.einsum("bd,bd->b", queries, queries))
            queries = queries / np.maximum(qn, 1e-30)[:, None]
        n = self.dataset_size()
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        p = cfg.partitions_to_search
        if params is not None and params.num_leaves_to_search is not None:
            p = params.num_leaves_to_search
        p = min(int(p), self._inner.partitioner.num_partitions)
        pre_k = int(np.ceil(k * cfg.pre_reorder_multiplier))
        pre_eps = post_eps = np.inf
        if params is not None:
            if params.pre_reordering_num_neighbors is not None:
                pre_k = int(params.pre_reordering_num_neighbors)
            if params.pre_reordering_epsilon is not None:
                pre_eps = float(params.pre_reordering_epsilon)
            if params.post_reordering_epsilon is not None:
                post_eps = float(params.post_reordering_epsilon)
        mult = self._inner.partitioner.tokenization.max_multiplicity
        # (no pre_k inflation here: the kernel over-selects approx slots by
        # the multiplicity itself and dedups before the gather — unless
        # spill_dedup=False pins the legacy inflated-gather path)
        pre_k = min(max(pre_k, k), p * self._l_cap)
        with_mask = allow_mask is not None
        dedup = bool(getattr(cfg, "spill_dedup", True))
        key = (p, pre_k, k, with_mask, dedup)
        if key not in self._kernels:
            self._kernels[key] = sharded_tree_ah_kernel(
                self.mesh, p=p, pre_k=pre_k, k=k, l_cap=self._l_cap,
                use_residuals=cfg.use_residuals, measure=cfg.distance_measure,
                multiplicity=mult,
                approx_select_min=cfg.approx_selection_min_partitions,
                scorer=self._scorer, with_mask=with_mask,
                dequant=self._dequant, spill_dedup=dedup,
                residual_anchor=self._tok is not None)
        q = replicate(self.mesh, jnp.asarray(queries))
        args = [self._cent, self._cb, self._codes, self._offs, self._sizes,
                self._perm, self._db, self._norms, q]
        if self._tok is not None:
            args.append(self._tok)
        if with_mask:
            m = np.zeros(n, dtype=bool)
            m[: len(allow_mask)] = np.asarray(allow_mask, dtype=bool)[:n]
            args.append(replicate(self.mesh, jnp.asarray(m)))
        args += [jnp.float32(pre_eps), jnp.float32(post_eps)]
        dists, idx = self._kernels[key](*args)
        # per-shard candidate ceilings can merge fewer than k columns:
        # pad back to the [B, k] contract
        return pad_results_to_k(np.asarray(idx), np.asarray(dists), k)


# ---------------------------------------------------------------------------
# sharded block-min sweep (BlockSweepSearcher scale-out)
# ---------------------------------------------------------------------------


def sharded_block_sweep_kernel(mesh: Mesh, *, pre_k: int, k: int,
                               measure: DistanceMeasure, r: int,
                               int8_sweep: bool,
                               aug_sn: float = 0.0,
                               db_axis: str = "db", dequant=None,
                               with_mask: bool = False,
                               top2: bool = False):
    """fn(aug [N_pad, D1] row-sharded, rdb [N_pad, Dp] row-sharded (SAME
    permuted row order as aug, so re-rank gathers stay local), norms [N_pad]
    sharded, queries replicated[, aug_scales replicated][, allow_pen
    [N_pad/r, r] row-sharded], pre_eps, post_eps)
    -> (dists, idx) with idx in the PERMUTED global coordinates (the wrapper
    translates winners through the inverse permutation — a [B, k] host
    gather, the only non-local step).

    Per shard: block-min sweep over the local augmented block (the same
    formulation as the single-device pipeline via sweep_block_candidates)
    -> local approx top-pre_k -> local exact re-rank -> local top-k;
    [k]-sized exact partials all_gather + merge.
    ``with_mask`` adds a restrict-allowlist penalty stream, fused into the
    per-shard sweep exactly as single-device (build_allow_penalty layout,
    rows already in the permuted order so the shard slice is local).
    """
    from scann_tpu.ops.sweep_pallas import (
        BLOCK_MASK_VALUE,
        _augment_queries,
        _augment_queries_int8,
        int8_mask_cut,
        sweep_approx_in_measure_units,
        sweep_block_candidates,
    )

    in_specs = [P(db_axis, None), P(db_axis, None), P(db_axis),
                P(None, None)]
    if int8_sweep:
        in_specs.append(P())
    if with_mask:
        in_specs.append(P(db_axis, None))
    in_specs += [P(), P()]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    def _kern(aug_blk, db_blk, norms_blk, queries, *rest):
        rest = list(rest)
        if int8_sweep:
            scales = rest.pop(0)
            q_aug = _augment_queries_int8(queries, measure, scales, aug_sn,
                                          aug_blk.shape[1])
            mask_cut = int8_mask_cut(aug_sn)
        else:
            q_aug = _augment_queries(queries, measure, aug_blk.shape[1])
            mask_cut = BLOCK_MASK_VALUE / 2
        pen_blk = rest.pop(0) if with_mask else None
        pre_eps, post_eps = rest
        shard = jax.lax.axis_index(db_axis)
        blk = aug_blk.shape[0]
        row0 = shard * blk

        pk = min(pre_k, blk // r)
        pv, cand = sweep_block_candidates(q_aug, aug_blk, pre_k=pk, r=r,
                                          penalty=pen_blk, top2=top2)
        approx = sweep_approx_in_measure_units(pv, queries, measure)
        pre_valid = (pv < mask_cut) & (approx <= pre_eps)

        safe = jnp.clip(cand, 0, blk - 1)
        rows = jnp.take(db_blk, safe, axis=0)
        if dequant is not None:
            rows = rows.astype(jnp.float32) * dequant[0] + dequant[1]
        elif rows.dtype != jnp.float32:
            rows = rows.astype(jnp.float32)
        # norms recomputed from the gathered f32 rows (identical math, no
        # per-element norm gather)
        nrm = jnp.sum(rows * rows, axis=-1)
        exact = gathered_distances(measure, queries, rows, nrm)
        exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
        vals, pos = top_k_smallest(exact, min(k, pk * (2 if top2 else 1)))
        idx = jnp.take_along_axis(cand, pos, axis=1) + row0
        idx = jnp.where(vals < MASKED_DISTANCE / 2, idx, -1)
        return _merge_partials(vals, idx, k, 1, post_eps, db_axis)

    return jax.jit(_kern)


def _compute_sweep_shard_layout(sweep, n_sh: int) -> dict:
    """Per-shard host layout for ShardedBlockSweepSearcher: the augmented
    sweep copy (bf16 or int8) and the permuted rerank rows, block-padded to
    the mesh size. This host build (augment + shuffle + rerank encode) is
    the serving-restart cost warm start skips."""
    from scann_tpu.ops.sweep_pallas import (
        build_augmented_db,
        build_int8_augmented_db,
        shuffle_stride_for,
    )
    from scann_tpu.utils.reordering import encode_rerank_rows, rerank_codec

    cfg = sweep._config
    data = sweep.dataset.numpy()
    n = sweep.dataset_size()

    # per-shard blocks: a tile_n multiple, so every shard's block tiles
    # exactly as the single-device copy does
    per_shard = -(-n // n_sh)
    blk = int(align_up(per_shard, cfg.tile_n))
    n_pad = n_sh * blk

    if cfg.shuffle and n > 1:
        stride = shuffle_stride_for(n)
        pos = (np.arange(n, dtype=np.int64) * stride) % n
        inv = np.empty(n, np.int32)
        inv[pos] = np.arange(n, dtype=np.int32)
    else:
        stride, inv = 0, None

    out = {"blk": blk, "n_sh": n_sh, "inv": inv, "aug_sn": 0.0,
           "dequant": None}
    if cfg.sweep_dtype == "int8":
        aug, scales, sn = build_int8_augmented_db(
            data, n, cfg.distance_measure, tile_n=blk, shuffle_stride=stride,
            pad_rows_to=n_pad)
        out["aug_scales"] = np.asarray(scales)
        out["aug_sn"] = float(sn)
    else:
        aug = build_augmented_db(
            data, n, cfg.distance_measure, tile_n=blk, shuffle_stride=stride,
            pad_rows_to=n_pad)
    out["aug"] = np.asarray(aug)

    # rerank rows in the SAME permuted order as the augmented copy, so
    # each shard re-ranks its own candidates locally
    data_perm = data if inv is None else data[inv]
    db_dt, encode, dequant = rerank_codec(data_perm, n, cfg.rerank_dtype)
    if dequant is not None:
        # per-dim [D] vectors -> JSON-safe lists (they ride the layout's
        # meta envelope in io.save_sharded_layout)
        out["dequant"] = (np.asarray(dequant[0]).tolist(),
                          np.asarray(dequant[1]).tolist())
    rdb = np.zeros((n_pad, data.shape[1]), db_dt)
    encode_rerank_rows(rdb, data_perm, n, encode)
    out["rdb"] = rdb
    return out


class ShardedBlockSweepSearcher(Searcher):
    """Block-min sweep with the augmented copy + rerank rows row-sharded
    over the mesh — the scale-out of the single-device sweep (each shard
    streams and holds 1/N of the rows). Wraps a single-device BlockSweepSearcher's config + dataset."""

    def __init__(self, sweep, mesh: Optional[Mesh] = None,
                 layout: Optional[dict] = None):
        from scann_tpu.models.block_sweep import BlockSweepSearcher
        from scann_tpu.utils.reordering import rerank_norms_fn

        if not isinstance(sweep, BlockSweepSearcher):
            raise ScannError.invalid_argument(
                "ShardedBlockSweepSearcher wraps a BlockSweepSearcher")
        cfg = sweep._config
        self._cfg = cfg
        self._measure = cfg.distance_measure
        self._inner = sweep
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        self._n = sweep.dataset_size()

        if layout is None:
            layout = _compute_sweep_shard_layout(sweep, n_sh)
        elif int(layout["n_sh"]) != n_sh:
            raise ScannError.invalid_argument(
                f"saved layout was computed for {layout['n_sh']} shards, "
                f"mesh has {n_sh}")
        self._blk = int(layout["blk"])
        self._inv = layout.get("inv")
        self._aug_sn = float(layout.get("aug_sn", 0.0))
        # int8 rerank codec params travel in the layout (derived from the
        # full permuted data at layout-compute time); None for f32/bf16
        self._dequant = layout.get("dequant")
        if self._dequant is not None:
            # per-dim [D] vectors (scalars in pre-r5 saved layouts — the
            # asarray broadcast serves both)
            self._dequant = (np.asarray(self._dequant[0], np.float32),
                             np.asarray(self._dequant[1], np.float32))

        sh = lambda a, spec: jax.device_put(a, NamedSharding(self.mesh, spec))
        self._aug_scales = None
        if cfg.sweep_dtype == "int8":
            self._aug_scales = replicate(self.mesh,
                                         jnp.asarray(layout["aug_scales"]))
        self._aug = sh(jnp.asarray(layout["aug"]), P("db", None))
        self._rdb = sh(jnp.asarray(layout["rdb"]), P("db", None))
        self._norms = rerank_norms_fn(
            self._dequant,
            out_shardings=NamedSharding(self.mesh, P("db")))(self._rdb)
        self._kernels = {}

    def save_layout(self, path: str) -> None:
        """Persist the per-shard layout (augmented sweep copy + permuted
        rerank rows) + the inner searcher so a restart skips the rebuild
       ."""
        from scann_tpu.io import save_sharded_layout

        save_sharded_layout(path, self)

    @classmethod
    def load_layout(cls, path: str, mesh: Optional[Mesh] = None):
        from scann_tpu.io import load_sharded_layout

        return load_sharded_layout(path, cls, mesh=mesh)

    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask=None):
        from scann_tpu.models.searcher import epsilons
        from scann_tpu.types import SUBLANE_BF16

        queries = self._validate_queries(queries)
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        cfg = self._cfg
        pre_k = max(cfg.pre_reorder_k, k)
        if params is not None and \
                params.pre_reordering_num_neighbors is not None:
            pre_k = max(int(params.pre_reordering_num_neighbors), k)
        pre_k = min(pre_k, self._blk // cfg.block_r)
        pre_eps, post_eps = epsilons(params)

        key = (pre_k, k, allow_mask is not None)
        if key not in self._kernels:
            self._kernels[key] = sharded_block_sweep_kernel(
                self.mesh, pre_k=pre_k, k=k, measure=self._measure,
                r=cfg.block_r,
                int8_sweep=cfg.sweep_dtype == "int8", aug_sn=self._aug_sn,
                dequant=self._dequant, with_mask=allow_mask is not None,
                top2=cfg.top2)
        pen_dev = None
        if allow_mask is not None:
            # penalty rows are in the permuted order the shards store, so
            # each shard's slice is local (no cross-shard translation)
            from scann_tpu.ops.sweep_pallas import (
                INT8_NORM_DIGIT_MAX,
                build_allow_penalty,
            )

            pen_kw = {}
            if cfg.sweep_dtype == "int8":
                pen_kw["mask_value"] = (4.0 * INT8_NORM_DIGIT_MAX
                                        * self._aug_sn)
            pen = build_allow_penalty(
                allow_mask, self._aug.shape[0], cfg.block_r,
                inv_perm=self._inv, **pen_kw)
            pen_dev = jax.device_put(
                jnp.asarray(pen), NamedSharding(self.mesh, P("db", None)))

        # chunk over max_batch like the single-device searcher (top2
        # doubles the per-query block-minima buffers, hence the halved cap)
        max_batch = cfg.max_batch // 2 if cfg.top2 else cfg.max_batch
        out_i, out_d = [], []
        for lo in range(0, len(queries), max_batch):
            qc = queries[lo : lo + max_batch]
            bc = len(qc)
            b_pad = align_up(bc, SUBLANE_BF16)
            if b_pad != bc:
                qc = np.concatenate(
                    [qc, np.zeros((b_pad - bc, qc.shape[1]), np.float32)])
            q = replicate(self.mesh, jnp.asarray(qc))
            args = [self._aug, self._rdb, self._norms, q]
            if cfg.sweep_dtype == "int8":
                args.append(self._aug_scales)
            if pen_dev is not None:
                args.append(pen_dev)
            args += [jnp.float32(pre_eps), jnp.float32(post_eps)]
            dc, ic = self._kernels[key](*args)
            out_i.append(np.asarray(ic)[:bc])
            out_d.append(np.asarray(dc)[:bc])
        idx = np.concatenate(out_i)
        dists = np.concatenate(out_d)
        if self._inv is not None:
            valid = idx >= 0
            idx = np.where(
                valid, self._inv[np.clip(idx, 0, self._n - 1)], -1)
        return pad_results_to_k(idx, dists, k)
