"""Tree-×-AH hybrid searcher — the flagship pipeline.

Build (reference: src/tree_x_hybrid/mod.rs:131-237): k-means partitions; a
*global* PQ codebook trained on residuals (point − partition centroid);
codes stored **per assignment** in one partition-contiguous CSR slab — a
point spilled into two partitions gets two code rows, each encoding the
residual against *that* partition's centroid, so spilling and residuals
compose correctly (the reference declares spilling but never implements it,
config.rs:151-155).

Search (reference: mod.rs:240-364) as ONE device program — the reference
runs a host loop over partitions with scalar LUT scoring and a rayon thread
pool; here the stages fuse into a single jit program with no host round
trips:

    centroid matmul -> top-p partitions
    -> per-(query, partition) residual LUTs (batched einsum)
    -> leaf scoring over the CSR slab (the formulation follows the
       platform, see ``_leaf_scorer``):
         grouped: pairs grouped by partition, each partition's codes read
              once per group (ops/tree_ah_grouped.py)
         pairs: per-pair code-row gather + LUT gather-sum
    -> masked merge across partitions -> approx top-(k·multiplier)
    -> (keep-best-per-id dedup when spilling) -> gather raw rows
    -> exact re-rank -> top-k

Optional restricts enter as a [N] bool allowlist mask fused into scoring;
per-query ``pre/post_reordering_epsilon`` thresholds ride as dynamic
scalars (reference: src/searcher.rs:12-30, brute_force/top_k.rs:263-279).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.hashes.codebook import Codebook, CodebookConfig, lut_kernel
from scann_tpu.hashes.hasher import AsymmetricHasherConfig
from scann_tpu.models.searcher import SearchParameters, Searcher, epsilons
from scann_tpu.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
    many_to_many,
    squared_norms,
)
from scann_tpu.ops.lut16_scoring import lut_score_gathered
from scann_tpu.ops.topk import (
    approx_top_k_smallest,
    keep_best_per_id,
    top_k_smallest,
    dedup_top_k,
    top_k_unique,
)
from scann_tpu.ops.tree_ah_grouped import (
    L_TILE,
    MIN_GROUP_ROWS,
    group_pairs_by_partition,
    grouped_scores_pallas,
)
from scann_tpu.partitioning.tree_partitioner import TreePartitioner, TreePartitionerConfig
from scann_tpu.types import MASKED_DISTANCE, SUBLANE_F32, align_up, use_gpu_kernels


def leaf_cap(max_partition_size: int) -> int:
    """Leaf capacity l_cap: the largest partition, rounded up to the
    grouped scorer's L-tile."""
    return int(align_up(max(int(max_partition_size), 8), L_TILE))


def code_slab(codes_aligned: np.ndarray, scorer: str,
              num_codes: int) -> np.ndarray:
    """Host serving layout of the aligned CSR codes [N_csr, S] for a leaf
    scorer (``tree_ah_search``): row-major [N_csr, S_pad] for "pairs", the
    transposed [S_pad, N_csr] slab for "grouped" — nibble-packed to
    [S_pad/2, N_csr] when the codebook has at most 16 codes (half the
    bytes). S_pad is S rounded up to even."""
    s = codes_aligned.shape[1]
    codes = codes_aligned
    if s % 2:
        codes = np.pad(codes, ((0, 0), (0, 1)))
    if scorer != "grouped":
        return codes
    if num_codes <= 16:
        # low-nibble-first pairs (reference lut16.rs:43-61)
        codes = codes[:, 0::2] | (codes[:, 1::2] << 4)
    return np.ascontiguousarray(codes.T)


@dataclasses.dataclass
class TreeXHybridConfig:
    """(reference: src/tree_x_hybrid/mod.rs:20-48)."""

    num_partitions: int = 100
    partitions_to_search: int = 10
    hash_config: AsymmetricHasherConfig = dataclasses.field(
        default_factory=lambda: AsymmetricHasherConfig(num_codes=16, num_subspaces=8)
    )
    use_residuals: bool = True
    pre_reorder_multiplier: float = 3.0
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # partition balancing cap ("auto" = 1.5x mean, None = off): leaf-scoring
    # cost has an l_cap term, so skew directly slows every query
    max_partition_size: Optional[object] = "auto"
    # hard-cap guarantee: principal-axis split of partitions the demote
    # rounds left oversized (see TreePartitionerConfig.split_stragglers)
    split_stragglers: bool = True
    # partitioner training knobs (threaded into TreePartitionerConfig so the
    # Scann facade's PartitioningConfig fields are honored, not dropped)
    spilling: bool = False
    spilling_threshold: float = 0.1
    # "soar" = orthogonality-amplified secondary assignments for every
    # point (hashes are per-assignment residual codes already, so SOAR
    # composes with the existing spilling dedup merge); "distance" =
    # 2nd-nearest threshold rule
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    partition_max_iterations: int = 100
    partition_convergence_threshold: float = 1e-5
    partition_num_levels: int = 1
    partition_training_sample_size: Optional[int] = None
    # approximate top-p centroid selection (lax.approx_min_k) once the
    # centroid count makes the sort-based exact top-k the bottleneck
    approx_selection_min_partitions: int = 1024
    # spilling serving: dedup a spilled point's copies BEFORE the exact
    # rerank gather (sort-based keep-best-per-id over the approx slots), so
    # the [B, pre_k, D] gather — the measured latency floor — runs at
    # unique depth instead of the legacy pre_k*multiplicity inflation.
    # False = legacy blanket inflation (A/B measurement only).
    spill_dedup: bool = True
    # dtype of the device copy the exact re-rank gathers from. "bfloat16"
    # halves the dominant serving allocation (f32 database: 8 GB at
    # 20M x 100d) at ~3 decimal digits of distance precision — measured
    # recall@10 cost ~0.5pp at 200k x 100d clustered data (0.944 -> 0.939
    # at equal config) and the single-device capacity ceiling doubles
    # (docs/DESIGN.md "Device memory at scale"). "int8" quarters it using the
    # residual-anchored per-dim codec (utils/reordering.
    # residual_rerank_codec: quantize row - center[token], add the
    # centroid back after the gather) — this implements the reference's
    # declared-but-unimplemented quantized reordering (config.rs:290-318)
    # at cluster-noise resolution instead of cluster-spread resolution.
    # "int16" is the same residual codec at 65536 levels — bf16's byte
    # cost with a ~256x finer step, re-ranking essentially exactly where
    # bf16 loses about half a point of recall in-pool: prefer it over bf16
    # whenever the data is partitioned.
    # Norms are recomputed from the rounded rows so the ||d||² term is
    # exactly consistent with the gathered vectors.
    rerank_dtype: str = "float32"
    # layout of the rerank store. "id" = original-id row order (the rerank
    # gather translates CSR positions through the [N_csr] perm table — a
    # [B, sel_k] scalar gather). "csr" = CSR row order with the point id
    # embedded in 4 base-256 digit columns of the row padding
    # (utils/reordering.build_csr_rerank_store): the gather takes the
    # arithmetically-resolved positions directly and the perm gather
    # disappears. None = auto: "csr" when each point has one assignment
    # and the store is f32/bf16 (identical bytes, identical results,
    # strictly less gather work); "id" under spilling (the CSR store
    # carries one row per assignment = x multiplicity bytes) and for the
    # residual-anchored int8 codec (needs its per-row anchor token).
    rerank_layout: Optional[str] = None

    def with_hash(self, cfg: AsymmetricHasherConfig) -> "TreeXHybridConfig":
        self.hash_config = cfg
        return self

    def with_residuals(self, flag: bool) -> "TreeXHybridConfig":
        self.use_residuals = flag
        return self

    def with_pre_reorder(self, multiplier: float) -> "TreeXHybridConfig":
        self.pre_reorder_multiplier = multiplier
        return self


# ---------------------------------------------------------------------------
# fused search stages
# ---------------------------------------------------------------------------


_MIPS = (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT)


# build-time residual-encode chunking: elements per [chunk, D] residual
# block (~600 MB f32 at the default). Module-level so tests can shrink it
# to exercise the multi-chunk path at test scale.
_ENCODE_CHUNK_ELEMS = 150_000_000

# past this many database bytes, build-time row gathers run on HOST
# (device gathers from the whole database force a full padded-layout
# copy). Module-level so tests can force the path at test scale.
_HOST_GATHER_BYTES = 5_000_000_000


@jax.jit
def _residual_gather_kernel(db, centers, idx, tok):
    """[len(idx), D] residual rows db[idx] − centers[tok] (build-time)."""
    return jnp.take(db, idx, axis=0) - jnp.take(centers, tok, axis=0)


@jax.jit
def _row_gather_kernel(db, idx):
    return jnp.take(db, idx, axis=0)


@jax.jit
def _residual_from_rows(rows, centers, tok):
    """rows − centers[tok] for host-gathered row chunks (the whole-database
    device gather forces a full padded-layout copy past ~5 GB)."""
    return rows - jnp.take(centers, tok, axis=0)


def _select_partitions(centers, queries, *, p: int, approx_min: int,
                       measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
    """Top-p centroids by the searcher's measure: L2-nearest for metric
    searches, largest dot for MIPS (many_to_many returns -dot as the
    distance, so smallest-k is correct either way). Sort-based exact
    selection over thousands of centroids costs more than the leaf scoring
    it feeds (measured 3.5 ms at [128, 3840]); approx_min_k does the same
    candidate selection in sub-ms and a missed 20th-best partition is
    recovered by the re-rank."""
    sel_measure = measure if measure in _MIPS else DistanceMeasure.SQUARED_L2
    cd = many_to_many(sel_measure, queries, centers)
    if centers.shape[0] >= approx_min and p < centers.shape[0]:
        return approx_top_k_smallest(cd, p)[1]
    return top_k_smallest(cd, p)[1]


def _residual_luts(queries, centers, parts, codebook, *, s_pad: int,
                   use_residuals: bool,
                   measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
    """Per-(query, partition) LUTs, flattened to [B*p, s_pad*C] with zero
    rows for pad subspaces (pad code 0 then contributes nothing).

    L2 (and cosine after upstream normalization): residual-query L2 tables,
    so Σ_s lut[s][code_s] = ||q - (c_t + r̂)||² exactly.
    MIPS: tables hold -dot(q_s, codebook[s][c]); with residual codes the
    per-partition constant -dot(q, c_t) is folded into subspace 0's row so
    Σ_s lut = -dot(q, c_t + r̂) and scores stay comparable ACROSS
    partitions (the reference builds L2 tables unconditionally, lut.rs:
    47-70 — its tree-AH under dot product returns unrelated points)."""
    b, d = queries.shape
    p = parts.shape[1]
    if measure in _MIPS:
        s, c, dsub = codebook.shape
        qs = queries.reshape(b, s, dsub)
        luts = -jnp.einsum("bsd,scd->bsc", qs, codebook,
                           precision=jax.lax.Precision.HIGHEST)  # [B, S, C]
        luts = jnp.broadcast_to(luts[:, None], (b, p, s, c))
        if use_residuals:
            sel = jnp.take(centers, parts, axis=0)               # [B, p, D]
            bias = -jnp.einsum("bd,bpd->bp", queries, sel,
                               precision=jax.lax.Precision.HIGHEST)
            luts = luts.at[:, :, 0, :].add(bias[:, :, None])
        luts = luts.reshape(b * p, s, c)
    else:
        if use_residuals:
            sel = jnp.take(centers, parts, axis=0)          # [B, p, D]
            q_eff = queries[:, None, :] - sel
        else:
            q_eff = jnp.broadcast_to(queries[:, None, :], (b, p, d))
        luts = lut_kernel(q_eff.reshape(b * p, d), codebook)  # [B*p, S, C]
    s, c = luts.shape[1], luts.shape[2]
    if s_pad != s:
        luts = jnp.pad(luts, ((0, 0), (0, s_pad - s), (0, 0)))
    return luts.reshape(b * p, s_pad * c)


def candidate_rows_from_positions(parts, csr_offsets, num_rows, pos, *,
                                  p: int):
    """CSR rows for leaf-major flat candidate positions, computed
    ARITHMETICALLY: position j = l*p + ti maps to
    min(csr_offsets[parts[b, ti]] + l, num_rows-1) — a [B, p] offset
    gather plus modular arithmetic, instead of take_along_axis over the
    materialized [B, p*l_cap] position tensor. At SOAR width
    (p*l_cap = 61k) that materialize+gather is a [B, p*l_cap] tensor
    larger than the leaf scores; this replacement touches only [B, sel]."""
    offs = jnp.take(csr_offsets, parts, axis=0)            # [B, p]
    row0 = jnp.take_along_axis(offs, pos % p, axis=1)      # exact int32
    return jnp.minimum(row0 + pos // p, num_rows - 1)


def _csr_row_positions(parts, csr_offsets, num_rows, *, p: int, l_cap: int):
    """[B, p*l_cap] leaf-major CSR row positions for the selected partitions
    (pure arithmetic — point ids resolve through ``perm`` only later)."""
    b = parts.shape[0]
    offs = jnp.take(csr_offsets, parts, axis=0)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (b, p, l_cap), 2)
    rows = jnp.minimum(offs[:, :, None] + iota_l, num_rows - 1)
    return rows.transpose(0, 2, 1).reshape(b, p * l_cap)


def leaf_scores_xla(luts_flat, parts, codes_rows, csr_offsets, part_sizes,
                    *, p: int, l_cap: int, c: int):
    """Plain leaf scoring (the CPU path, and the reference the grouped
    kernel is tested against): per-pair code-row gather + LUT gather-sum. Returns ([B, p*l_cap] leaf-major scores with
    MASKED_DISTANCE beyond each partition's size, [B, p*l_cap] CSR rows).

    Shard-local by construction: used verbatim inside the sharded tree-AH
    shard_map body (parallel/sharded_flagship.py) with the shard's own CSR
    slab, so single-device and scale-out serve through the same code.
    """
    b = parts.shape[0]
    s_pad = codes_rows.shape[1]
    num_rows = codes_rows.shape[0]
    offs = jnp.take(csr_offsets, parts, axis=0)                  # [B, p]
    szs = jnp.take(part_sizes, parts, axis=0)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (b, p, l_cap), 2)
    rows = jnp.minimum(offs[:, :, None] + iota_l, num_rows - 1)
    codes_g = jnp.take(codes_rows, rows.reshape(b, p * l_cap), axis=0)
    # leaf-major interleave — see leaf_scores_grouped: partition-major
    # order breaks approx_min_k's layout assumption downstream
    scores = lut_score_gathered(
        luts_flat.reshape(b * p, s_pad, c),
        codes_g.reshape(b * p, l_cap, s_pad),
    ).reshape(b, p, l_cap).transpose(0, 2, 1).reshape(b, p * l_cap)
    valid = (iota_l < szs[:, :, None]).transpose(0, 2, 1).reshape(b, p * l_cap)
    flat_scores = jnp.where(valid, scores, MASKED_DISTANCE)
    rows_il = rows.transpose(0, 2, 1).reshape(b, p * l_cap)
    return flat_scores, rows_il


def leaf_scores_grouped(luts_flat, parts, codes, csr_offsets, part_sizes,
                        *, p: int, l_cap: int, c: int,
                        interpret: bool = False):
    """Grouped leaf scoring (ops/tree_ah_grouped.py): pairs grouped by
    partition, each partition's codes read once per group of up to
    MIN_GROUP_ROWS queries (the rows of one tensor-core product) by the
    Triton-route kernel. ``codes`` is the transposed slab of
    ``code_slab(.., "grouped")`` (packed when it has half as many rows as
    the LUTs have subspaces). Returns ([B, p*l_cap] leaf-major bf16 scores
    with MASKED_DISTANCE beyond each partition's size, [B, p*l_cap] CSR
    rows).

    Shard-local by construction (no cross-device communication inside):
    the sharded tree-AH calls this inside its shard_map body with the
    shard's own slab.
    """
    b = parts.shape[0]
    s_pad = luts_flat.shape[1] // c
    num_partitions = part_sizes.shape[0]
    num_rows = codes.shape[1]
    q_cap = MIN_GROUP_ROWS
    grp_part, slot, ng = group_pairs_by_partition(parts, num_partitions, q_cap)
    grp_safe = jnp.maximum(grp_part, 0)
    grp_off = jnp.take(csr_offsets, grp_safe)
    # unused groups (grp_part == -1) get size 0: the kernel then skips
    # their loads and products entirely
    grp_size = jnp.where(grp_part >= 0, jnp.take(part_sizes, grp_safe), 0)
    pair_of_slot = jnp.zeros((ng * q_cap,), jnp.int32).at[slot].set(
        jnp.arange(b * p, dtype=jnp.int32))
    # bf16 before the grouped gather: the products run in bf16 anyway,
    # casting first halves the gather's traffic
    luts = luts_flat.astype(jnp.bfloat16)
    c_pad = max(16, 1 << (c - 1).bit_length())
    if c_pad != c:
        # tensor-core products need K >= 16: zero LUT columns for codes
        # that never occur
        luts = jnp.pad(luts.reshape(b * p, -1, c),
                       ((0, 0), (0, 0), (0, c_pad - c))).reshape(b * p, -1)
    luts3 = jnp.take(luts, pair_of_slot, axis=0).reshape(ng, q_cap, -1)
    scores_g = grouped_scores_pallas(luts3, codes, grp_off, grp_size,
                                     l_cap=l_cap,
                                     packed=2 * codes.shape[0] == s_pad,
                                     interpret=interpret)
    # Interleave partitions across the flat candidate axis (leaf-major, not
    # partition-major): lax.approx_min_k's recall guarantee assumes the top
    # elements are spread roughly uniformly, but partition-major order
    # concentrates them in the best partition's contiguous block (recall
    # collapses as p*l_cap grows). The transpose restores the guarantee.
    flat_scores = jnp.take(scores_g.reshape(ng * q_cap, l_cap), slot,
                           axis=0).reshape(b, p, l_cap).transpose(
                               0, 2, 1).reshape(b, p * l_cap)
    rows_il = _csr_row_positions(parts, csr_offsets, num_rows,
                                 p=p, l_cap=l_cap)
    return flat_scores, rows_il


def _finalize(db, db_sq_norms, queries, flat_scores, row_ctx, perm,
              pre_eps, post_eps, *, pre_k: int, k: int, p: int,
              measure: DistanceMeasure, reorder: bool, multiplicity: int,
              spill_dedup: bool = True, csr_store: bool = False):
    """approx candidate select -> (dedup) -> exact re-rank -> top-k.

    Position-based: ``flat_rows`` are CSR row positions (pure arithmetic,
    never gathered); candidate point ids resolve through ``perm`` only for
    the approx survivors. Translating ALL p*l_cap candidates up front was
    the tree path's dominant cost — a [B, p*l_cap] scalar gather (10.5M
    random accesses at B=1024, p=10, l_cap=1024) measured ~80 ms/batch, 8x
    the rest of the pipeline combined.

    Under spilling, duplicates are removed BEFORE the rerank gather
    (``spill_dedup``, default): the approx stage over-selects
    pre_k×multiplicity slots (a point's copies each hold one), a
    sort-based keep-best-per-id collapses them, and the [B, pre_k, D] row
    gather — the measured latency floor at ~31 ns/row — runs at UNIQUE
    candidate depth. ``spill_dedup=False`` keeps the legacy blanket
    inflation (gather all pre_k×multiplicity rows, dedup after the exact
    top-k) for A/B measurement.

    ``csr_store=True``: ``db`` is an id-embedded CSR-ordered rerank store
    (utils/reordering.build_csr_rerank_store) — the row gather takes the
    arithmetically-resolved CSR positions directly and the candidate ids
    decode from the gathered rows' digit lanes, eliminating the
    ``[B, sel_k]`` perm-table scalar gather (~20 ns/element, ~12 ms/batch
    at SOAR width) entirely. Spilled copies dedup AFTER the exact scores
    (their rows were gathered anyway; the perm gather they existed to
    amortize is gone)."""
    parts, csr_offsets, num_rows = row_ctx[:3]
    if not reorder:
        kp = min(k * max(int(multiplicity), 1), flat_scores.shape[-1])
        vals, pos = top_k_smallest(flat_scores, kp)
        rows_sel = candidate_rows_from_positions(
            parts, csr_offsets, num_rows, pos, p=p)
        idx = jnp.take(perm, rows_sel, axis=0)
        if multiplicity > 1:
            vals, idx = dedup_top_k(vals, idx, k)
        else:
            vals, idx = vals[..., :k], idx[..., :k]
        vals = vals.astype(jnp.float32)   # scores may arrive bf16
        # COSINE approx scores are 2x the cosine distance (L2 on unit
        # vectors); convert so eps compare + returned values match the
        # exact path's units (advisor r2 finding)
        vals_m = approx_to_measure_units(vals, measure)
        missing = (vals >= MASKED_DISTANCE / 2) | (vals_m > pre_eps)
        return jnp.where(missing, jnp.inf, vals_m), jnp.where(missing, -1, idx)

    mult = max(int(multiplicity), 1)
    dedup_first = spill_dedup and mult > 1 and not csr_store
    width = flat_scores.shape[-1]
    sel_k = min(pre_k * mult, width) if mult > 1 else min(pre_k, width)
    pre_vals, pre_pos = approx_top_k_smallest(flat_scores, sel_k)
    pre_rows = candidate_rows_from_positions(
        parts, csr_offsets, num_rows, pre_pos, p=p)      # [B, sel_k]
    pre_vals = pre_vals.astype(jnp.float32)
    pre_m = approx_to_measure_units(pre_vals, measure)
    pre_valid = (pre_vals < MASKED_DISTANCE / 2) & (pre_m <= pre_eps)
    if csr_store:
        from scann_tpu.utils.reordering import gather_csr_rerank_rows

        rows, pre_cand = gather_csr_rerank_rows(db, pre_rows,
                                                queries.shape[-1])
        if isinstance(db, tuple):
            # anchored (int8/int16 residual) csr store: rows are
            # RESIDUALS; the anchor centroid is reconstructed from the
            # selection position itself — slot j belongs to partition
            # parts[b, j % p] (leaf-major layout) — gathered exactly from
            # the tiny per-query [p, D] centroid tile (no anchor-token
            # table).
            c_sel = jnp.take(row_ctx[3], parts, axis=0)      # [B, p, D]
            rows = rows + jnp.take_along_axis(
                c_sel, (pre_pos % p)[..., None], axis=1)     # [B, sel, D]
        norms = jnp.sum(rows * rows, axis=-1)
        exact = gathered_distances(measure, queries, rows, norms)
        exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
        if mult > 1:
            vals, idx = top_k_unique(exact, pre_cand, k, multiplicity)
        else:
            vals, pos = top_k_smallest(exact, k)
            idx = jnp.take_along_axis(pre_cand, pos, axis=1)
        missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
        return (jnp.where(missing, jnp.inf, vals),
                jnp.where(missing, -1, idx))
    pre_cand = jnp.take(perm, pre_rows, axis=0)
    if dedup_first:
        # collapse a spilled point's copies to its best approx slot, THEN
        # gather: unique depth pre_k instead of sel_k rows
        masked = jnp.where(pre_valid, pre_vals, MASKED_DISTANCE)
        dvals, pre_cand = keep_best_per_id(masked, pre_cand,
                                           min(pre_k, sel_k))
        pre_valid = dvals < MASKED_DISTANCE / 2
    pre_safe = jnp.maximum(pre_cand, 0)

    from scann_tpu.utils.reordering import gather_rerank_rows

    rows = gather_rerank_rows(db, pre_safe)                   # [B, pre_k, D]
    # norms recomputed from the gathered rows (identical math: the norms
    # table is built from the same dequantized rows) — no [B, pre_k]
    # per-element norm gather; the rows are already gathered
    norms = jnp.sum(rows * rows, axis=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
    if mult > 1 and not dedup_first:
        vals, idx = top_k_unique(exact, pre_cand, k, multiplicity)
    else:
        vals, pos = top_k_smallest(exact, k)
        idx = jnp.take_along_axis(pre_cand, pos, axis=1)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


def tree_ah_search(
    db, db_sq_norms, centers, codes, csr_offsets, part_sizes, perm,
    codebook, queries, n_valid, allow_mask, pre_eps, post_eps,
    *, p: int, pre_k: int, k: int, l_cap: int, use_residuals: bool,
    measure: DistanceMeasure, reorder: bool = True, multiplicity: int = 1,
    approx_select_min: int = 1024, spill_dedup: bool = True,
    csr_store: bool = False, scorer: str = "pairs",
):
    """The whole tree-AH search as one device program.

    Args:
        db: [N_pad, D] raw vectors (for re-ranking).
        codes: per-assignment PQ codes in the CSR serving layout of
            ``scorer`` (``code_slab``): rows partition-contiguous,
            partition starts 128-aligned.
        csr_offsets: [K] int32 first CSR row of each partition.
        part_sizes: [K] int32.
        perm: [N_csr] int32 CSR row -> original point id.
        allow_mask: [N_pad] bool or None — restrict allowlist.
        pre_eps / post_eps: f32 scalars (inf = no threshold).
        scorer: leaf scoring formulation — "grouped" (the grouped kernel,
            ``leaf_scores_grouped``) or "pairs" (``leaf_scores_xla``).
    """
    parts = _select_partitions(centers, queries, p=p,
                               approx_min=approx_select_min,
                               measure=measure)                  # [B, p]
    c = codebook.shape[1]
    s_pad = align_up(codebook.shape[0], 2)      # code_slab's subspace pad
    num_rows = codes.shape[1] if scorer == "grouped" else codes.shape[0]
    luts_flat = _residual_luts(queries, centers, parts, codebook,
                               s_pad=s_pad, use_residuals=use_residuals,
                               measure=measure)
    if scorer == "grouped":
        flat_scores, rows_il = leaf_scores_grouped(
            luts_flat, parts, codes, csr_offsets, part_sizes,
            p=p, l_cap=l_cap, c=c)
    else:
        flat_scores, rows_il = leaf_scores_xla(
            luts_flat, parts, codes, csr_offsets, part_sizes,
            p=p, l_cap=l_cap, c=c)
    if allow_mask is not None:
        # restricts are pre-selection hard filters (reference semantics):
        # the bit gather is per-candidate and costs what the unmasked
        # path deliberately avoids — acceptable for filtered queries
        # (rows_il materializes only on this branch; the unmasked path
        # resolves candidate rows arithmetically after selection)
        allow_csr = jnp.take(allow_mask, jnp.maximum(perm, 0), axis=0)
        allowed = jnp.take(allow_csr, rows_il, axis=0)
        flat_scores = jnp.where(allowed, flat_scores, MASKED_DISTANCE)
    return _finalize(db, db_sq_norms, queries, flat_scores,
                     (parts, csr_offsets, num_rows, centers), perm,
                     pre_eps, post_eps, pre_k=pre_k, k=k, p=p,
                     measure=measure,
                     reorder=reorder, multiplicity=multiplicity,
                     spill_dedup=spill_dedup, csr_store=csr_store)


tree_ah_kernel = jax.jit(
    tree_ah_search,
    static_argnames=("p", "pre_k", "k", "l_cap", "use_residuals", "measure",
                     "reorder", "multiplicity", "approx_select_min",
                     "spill_dedup", "csr_store", "scorer"),
)


class TreeXHybridSearcher(Searcher):
    """Partitioning + residual PQ + exact re-rank
    (reference: src/tree_x_hybrid/mod.rs:93-110)."""

    def __init__(self, config: Optional[TreeXHybridConfig] = None):
        self.config = config or TreeXHybridConfig()
        self.partitioner: Optional[TreePartitioner] = None
        self.codebook: Optional[Codebook] = None
        # per-ASSIGNMENT codes [M, S] in CSR (partition-sorted) row order,
        # M = len(tokenization.point_indices) >= N under spilling
        self.codes: Optional[np.ndarray] = None
        self._dataset: Optional[DenseDataset] = None
        self._norms_cache = None
        self._csr_cache = None
        self._csr_perm_np = None
        self._csr_parts_np = None
        self._lp_cache = None
        self._csr_store_cache = None
        if self.config.rerank_dtype not in ("float32", "bfloat16", "int8",
                                            "int16"):
            raise ScannError.invalid_argument(
                f"rerank_dtype must be float32, bfloat16, int16 or int8, "
                f"got {self.config.rerank_dtype!r}")
        if self.config.rerank_layout not in (None, "id", "csr"):
            raise ScannError.invalid_argument(
                f"rerank_layout must be None, 'id' or 'csr', got "
                f"{self.config.rerank_layout!r}")

    # -- build ----------------------------------------------------------------
    def build(self, dataset: DenseDataset) -> "TreeXHybridSearcher":
        if dataset.is_empty:
            raise ScannError.invalid_argument("Cannot build from empty dataset")
        cfg = self.config
        if cfg.distance_measure == DistanceMeasure.COSINE:
            # L2-normalize at build so the L2-based partition selection,
            # residual PQ, and leaf scores all rank identically to cosine
            # (cos(q, x) is invariant to the normalization; unnormalized
            # data measured recall@10 0.24 — candidate generation ranked by
            # a different metric than the rerank). Queries normalize at
            # search time symmetrically.
            raw = dataset.numpy()
            norms = np.sqrt(np.einsum("nd,nd->n", raw, raw))
            dataset = DenseDataset(
                (raw / np.maximum(norms, 1e-30)[:, None]).astype(np.float32),
                docids=dataset.docids)
        self._dataset = dataset
        data = dataset.numpy()
        n = len(data)

        self.partitioner = TreePartitioner(TreePartitionerConfig(
            num_partitions=cfg.num_partitions,
            seed=cfg.hash_config.seed if cfg.hash_config.seed is not None else 42,
            max_partition_size=cfg.max_partition_size,
            split_stragglers=cfg.split_stragglers,
            spilling=cfg.spilling,
            spilling_threshold=cfg.spilling_threshold,
            spilling_mode=cfg.spilling_mode,
            soar_lambda=cfg.soar_lambda,
            max_iterations=cfg.partition_max_iterations,
            convergence_threshold=cfg.partition_convergence_threshold,
            num_levels=cfg.partition_num_levels,
            training_sample_size=cfg.partition_training_sample_size,
        )).build(dataset)

        tk = self.partitioner.tokenization
        row_tokens = np.repeat(
            np.arange(tk.num_partitions, dtype=np.int32), tk.partition_sizes)
        # Per-assignment residuals are computed on device in bounded chunks
        # and NEVER materialized as a full [M, D] tensor: the dataset device
        # copy is reused (DenseDataset.device() cache) and each chunk's
        # residuals exist only long enough to encode. Keeping the full
        # residual tensor resident (a second database copy) OOMed the 10M x
        # 100d build — dataset 4GB + residuals 4GB filled HBM before PQ
        # training even started.
        cent_dev = jnp.asarray(self.partitioner.centers)
        pts_np = np.asarray(tk.point_indices, np.int32)
        hc = cfg.hash_config
        m = len(pts_np)
        use_res = bool(cfg.use_residuals)

        # past ~5 GB, device gathers from the whole database force XLA to
        # copy the full [N, D] operand to its padded layout (measured:
        # 9.54 GB temp for a small gather output at 20M x 100d) — gather
        # the chunk rows on HOST and upload them instead (same total bytes
        # uploaded once, no whole-array device temps)
        host_gather = data.nbytes > _HOST_GATHER_BYTES
        db_dev = None if host_gather else dataset.device()[0]

        def resid_rows(idx_np, tok_np):
            """Device [len(idx), D]: rows (− their centroid when residuals)."""
            if host_gather:
                rows = jnp.asarray(data[idx_np])
                if use_res:
                    return _residual_from_rows(rows, cent_dev,
                                               jnp.asarray(tok_np))
                return rows
            if use_res:
                return _residual_gather_kernel(
                    db_dev, cent_dev, jnp.asarray(idx_np), jnp.asarray(tok_np))
            return _row_gather_kernel(db_dev, jnp.asarray(idx_np))

        def raw_rows(idx_np):
            if host_gather:
                return jnp.asarray(data[idx_np])
            return _row_gather_kernel(db_dev, jnp.asarray(idx_np))

        if hc.training_sample_size < m:
            rng = np.random.default_rng(hc.seed if hc.seed is not None else 42)
            sel = rng.choice(m, hc.training_sample_size, replace=False)
        else:
            sel = np.arange(m)
        sample = np.asarray(resid_rows(pts_np[sel], row_tokens[sel]))

        # AVQ (hashes/avq.py): the anisotropic loss weights residual error
        # along the ORIGINAL point's direction (the score being protected is
        # <q, x>), so directions are gathered from the raw rows, not the
        # residuals — per chunk, like the residuals themselves.
        avq = hc.anisotropic_threshold is not None
        # with residuals off, resid_rows already returns the raw rows —
        # directions are the same array, skip the duplicate gather
        sample_dirs = (sample if (avq and not use_res) else
                       np.asarray(raw_rows(pts_np[sel])) if avq
                       else None)

        self.codebook = Codebook(CodebookConfig(
            num_codes=hc.num_codes,
            num_subspaces=hc.num_subspaces,
            max_iterations=hc.max_iterations,
            seed=hc.seed,
            anisotropic_threshold=hc.anisotropic_threshold,
        )).train(sample, directions=sample_dirs)

        d = data.shape[1]
        chunk = max(min(m, _ENCODE_CHUNK_ELEMS // max(d, 1)), 8192)
        codes = np.empty((m, hc.num_subspaces), np.uint8)
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            r_dev = resid_rows(pts_np[lo:hi], row_tokens[lo:hi])
            d_dev = (r_dev if (avq and not use_res) else
                     raw_rows(pts_np[lo:hi]) if avq else None)
            codes[lo:hi] = self.codebook.encode_dataset(r_dev, directions=d_dev)
        self.codes = codes
        self._norms_cache = None
        self._csr_cache = None
        self._lp_cache = None
        self._csr_store_cache = None
        return self

    # -- metadata ---------------------------------------------------------------
    def dataset_size(self) -> int:
        return 0 if self._dataset is None else self._dataset.size

    def dimensionality(self) -> int:
        return 0 if self._dataset is None else self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids if self._dataset is not None else None

    def memory_usage(self) -> int:
        """Device bytes of the serving CSR code slab + centroids +
        codebook — the device memory the leaf scorer reads (the harness
        publishes this as index_device_bytes). The grouped kernel's packed
        slab costs ceil(S/2) bytes per row, the row-major slab S rounded up
        to even; both carry 128-aligned partition gaps and an int32 perm."""
        tk = self.partitioner.tokenization
        sizes = tk.partition_sizes.astype(np.int64)
        aligned_rows = int((((sizes + 127) // 128) * 128).sum())
        aligned_rows += leaf_cap(tk.max_partition_size)
        s = int(align_up(self.codes.shape[1], 2))
        packed = (self._leaf_scorer() == "grouped"
                  and self.config.hash_config.num_codes <= 16)
        row_bytes = s // 2 if packed else s
        return int(aligned_rows * row_bytes  # code slab (+ int32 perm below)
                   + aligned_rows * 4
                   + self.partitioner.centers.nbytes
                   + self.codebook.centroids.nbytes)

    def _device_state(self):
        if self.config.rerank_dtype != "float32":
            # low-precision rerank copy uploads straight from host (no f32
            # device copy is ever materialized); callers that built through
            # the f32 DenseDataset cache can free it with
            # dataset.drop_device_cache() — ideally BEFORE this call so
            # the two copies never coexist in HBM
            from scann_tpu.utils.reordering import (
                build_rerank_store,
                build_residual_rerank_store,
            )

            n = self._dataset.size
            if self._lp_cache is None or self._lp_cache[2] != n:
                if (self.config.rerank_dtype in ("int8", "int16")
                        and self.partitioner is not None):
                    # residual-anchored int8/int16: quantize
                    # row - center[token] so the levels resolve
                    # within-cluster noise, not the cluster spread (a
                    # global codec loses recall at scale); anchors are
                    # the tree's own centroids.
                    # int16 = bf16's bytes with a ~256x finer step on the
                    # residual scale: re-ranks essentially exactly where
                    # bf16 loses ~0.5pp in-pool
                    db_repr, norms = build_residual_rerank_store(
                        self._dataset.numpy(), n,
                        self.partitioner.tokenization.tokens,
                        self.partitioner.centers, SUBLANE_F32,
                        levels=65535 if self.config.rerank_dtype == "int16"
                        else 255)
                else:
                    db_repr, norms = build_rerank_store(
                        self._dataset.numpy(), n, self.config.rerank_dtype,
                        SUBLANE_F32)
                self._lp_cache = (db_repr, norms, n)
            return self._lp_cache
        db, n = self._dataset.device()
        if self._norms_cache is None or self._norms_cache[0] != n:
            self._norms_cache = (n, jax.jit(squared_norms)(db))
        return db, self._norms_cache[1], n

    def _csr_state(self):
        """Aligned CSR device layout: the code slab in the serving layout
        of ``_leaf_scorer()`` (``code_slab``), aligned offsets, sizes,
        row->id perm, l_cap."""
        if self._csr_cache is None:
            tk = self.partitioner.tokenization
            l_cap = leaf_cap(tk.max_partition_size)
            k = tk.num_partitions
            sizes = tk.partition_sizes
            # 128-align every partition's CSR start; the slab keeps l_cap
            # rows past the last start so every L-tile load stays in bounds
            aligned = np.zeros(k + 1, dtype=np.int64)
            aligned[1:] = np.cumsum(
                ((sizes.astype(np.int64) + 127) // 128) * 128)
            total = int(aligned[-1]) + l_cap
            s = self.codes.shape[1]
            codes_aligned = np.zeros((total, s), dtype=np.uint8)
            perm_aligned = np.zeros(total, dtype=np.int32)
            csr_off = tk.offsets
            for t in range(k):
                lo, sz = int(aligned[t]), int(sizes[t])
                codes_aligned[lo : lo + sz] = \
                    self.codes[csr_off[t] : csr_off[t] + sz]
                perm_aligned[lo : lo + sz] = tk.partition_indices(t)
            # host copies kept for the id-embedded CSR rerank store
            # builder (row -> id, row -> partition)
            self._csr_perm_np = perm_aligned
            parts_aligned = np.zeros(total, dtype=np.int32)
            for t in range(k):
                lo, sz = int(aligned[t]), int(sizes[t])
                parts_aligned[lo : lo + sz] = t
            self._csr_parts_np = parts_aligned
            self._csr_cache = (
                jnp.asarray(code_slab(codes_aligned, self._leaf_scorer(),
                                      self.config.hash_config.num_codes)),
                jnp.asarray(aligned[:-1].astype(np.int32)),
                jnp.asarray(sizes.astype(np.int32)),
                jnp.asarray(perm_aligned),
                l_cap,
            )
        return self._csr_cache

    def _leaf_scorer(self) -> str:
        """Leaf-scoring formulation: the grouped kernel on the GPU, the
        per-pair gather formulation on the CPU (tree_ah_search)."""
        return "grouped" if use_gpu_kernels() else "pairs"

    def _rerank_layout(self) -> str:
        """Resolved rerank-store layout (see TreeXHybridConfig.rerank_layout):
        auto picks "csr" exactly when it is a pure win — one assignment per
        point (identical store bytes) and a non-anchored codec."""
        rl = self.config.rerank_layout
        if rl is not None:
            return rl
        mult = self.partitioner.tokenization.max_multiplicity
        return "csr" if mult == 1 else "id"

    def _csr_store_state(self):
        """Id-embedded CSR-ordered rerank store (+ valid count): the
        serving state for ``rerank_layout='csr'``. Built from the SAME
        codec as the id-ordered store (identical dequantized values, so
        results are bit-identical); rows follow the aligned CSR layout of
        :meth:`_csr_state` so the kernels' arithmetically-resolved
        positions index it directly."""
        n = self._dataset.size
        if self._csr_store_cache is None or self._csr_store_cache[1] != n:
            from scann_tpu.utils.reordering import build_csr_rerank_store

            self._csr_state()  # ensures _csr_perm_np/_csr_parts_np
            dt = self.config.rerank_dtype
            if dt in ("int8", "int16"):
                store = build_csr_rerank_store(
                    self._dataset.numpy(), self._csr_perm_np, dt,
                    row_parts=self._csr_parts_np,
                    tokens=self.partitioner.tokenization.tokens,
                    centers=self.partitioner.centers)
            else:
                store = build_csr_rerank_store(
                    self._dataset.numpy(), self._csr_perm_np, dt)
            self._csr_store_cache = (store, n)
        return self._csr_store_cache

    # -- search -----------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        self._check_built()
        queries = self._validate_queries(queries)
        cfg = self.config
        if cfg.distance_measure == DistanceMeasure.COSINE:
            # symmetric to the build-time normalization: L2 partition
            # selection and residual LUTs then rank identically to cosine
            qn = np.sqrt(np.einsum("bd,bd->b", queries, queries))
            queries = queries / np.maximum(qn, 1e-30)[:, None]
        n = self.dataset_size()
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")

        p = cfg.partitions_to_search
        if params is not None and params.num_leaves_to_search is not None:
            p = params.num_leaves_to_search
        p = min(int(p), self.partitioner.num_partitions)

        if params is not None and params.pre_reordering_num_neighbors is not None:
            pre_k = int(params.pre_reordering_num_neighbors)
        else:
            pre_k = int(np.ceil(k * cfg.pre_reorder_multiplier))
        pre_eps, post_eps = (np.float32(e) for e in epsilons(params))

        codes, csr_offsets, part_sizes, perm, l_cap = self._csr_state()
        mult = self.partitioner.tokenization.max_multiplicity
        # id-embedded CSR store: restricts go through the id layout (the
        # allow mask is indexed by original ids over rows_il, which only
        # materializes on that branch)
        csr_store = self._rerank_layout() == "csr" and allow_mask is None
        if csr_store:
            db, n_valid = self._csr_store_state()
            norms = None
        else:
            db, norms, n_valid = self._device_state()
        # (no pre_k inflation here: _finalize over-selects approx slots by
        # the multiplicity itself and dedups before the gather)

        max_cand = p * l_cap
        if pre_k > max_cand or k > max_cand:
            warnings.warn(
                f"requested pre_k={pre_k} / k={k} exceed the {max_cand} "
                f"candidates reachable with p={p}, l_cap={l_cap}; clamping "
                f"(raise partitions_to_search for more candidates)",
                stacklevel=2)
        pre_k = min(max(pre_k, k), max_cand)
        k_eff = min(k, max_cand)

        mask_dev = None
        if allow_mask is not None:
            n_rows = db[0].shape[0] if isinstance(db, tuple) else db.shape[0]
            m = np.zeros(n_rows, dtype=bool)
            m[: len(allow_mask)] = np.asarray(allow_mask, dtype=bool)[:n_valid]
            mask_dev = jnp.asarray(m)

        common = dict(p=p, pre_k=pre_k, k=k_eff, l_cap=l_cap,
                      use_residuals=cfg.use_residuals,
                      measure=cfg.distance_measure, multiplicity=mult,
                      approx_select_min=cfg.approx_selection_min_partitions,
                      spill_dedup=cfg.spill_dedup, csr_store=csr_store)
        dists, idx = tree_ah_kernel(
            db, norms, self.partitioner.centers_device(), codes,
            csr_offsets, part_sizes, perm,
            self.codebook.centroids_device(), jnp.asarray(queries),
            jnp.int32(n_valid), mask_dev, pre_eps, post_eps,
            scorer=self._leaf_scorer(), **common)
        return np.asarray(idx), np.asarray(dists)

    def _check_built(self):
        if self.codebook is None or self.partitioner is None:
            raise ScannError.failed_precondition("searcher not built")
