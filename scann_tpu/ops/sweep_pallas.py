"""Block-min sweep: a bf16 (or int8) streaming scorer whose [B, N] score
matrix never reaches device memory.

The database is stored once as rows augmented with their squared norm, so
the whole distance computation is ONE matrix product per tile:

    row  = [x, ||x||^2, 0...]          (bf16, built once at index time)
    q'   = [-2q, 1, 0...]              (squared-L2)
    score = row . q' = ||x||^2 - 2 q.x (rank-equivalent to squared-L2)

Each score tile is reduced r:1 (min + argmin per block of r consecutive
rows) before it leaves the chip's registers, so only the query-major
[B, N/r] block minima are written. They feed an approximate top-pre_k, and
an exact f32 re-rank of the pre_k survivors restores full-precision
distances. Invalid/padded rows carry a huge value in the norm slot, so
masking costs nothing in-kernel. Recall loss comes only from bf16 rounding
and the one-candidate-per-r-block cap, both recovered by the exact re-rank
for practical (k, r).

Two formulations of the block minima: ``block_minima_pallas`` (a
Triton-route Pallas kernel, served on the GPU) and ``block_minima_xla``
(the plain matmul + reshape-min, served on the CPU and the reference the
kernel is tested against). PERF.md "Kernel decisions at bring-up" has the
measurement that chose between them.

Reference counterpart: the brute-force searcher + reordering helper
(src/brute_force/searcher.rs:77-139, src/utils/reordering.rs:22-94).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from scann_tpu.ops.distances import DistanceMeasure, gathered_distances
from scann_tpu.ops.topk import approx_top_k_smallest, top_k_smallest
from scann_tpu.types import MASKED_DISTANCE, align_up, use_gpu_kernels

# Sentinel carried in the augmented norm column of invalid rows. bf16-exact
# (a power of two) and far above any real score, far below bf16 max.
BLOCK_MASK_VALUE = float(2.0 ** 30)

# int8 sweep: the squared norm is carried as THREE base-128 digits in
# columns past the data (digits in [-64, 63], slot multipliers sn * (1, 128,
# 16384) with sn a power of two — every multiplier and digit is exact in
# bf16, so the decoded norm is exact to sn/2). Max encodable magnitude:
INT8_NORM_DIGIT_MAX = 63 + 63 * 128 + 63 * 16384  # 1,040,319
# real norms are scaled to stay below this, leaving >2x margin to the mask
INT8_NORM_REAL_MAX = 400_000


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def augmented_dim(d: int, extra: int = 1) -> int:
    """Minor dim of the augmented row: original + ``extra`` norm columns,
    rounded up to a power of two (the Triton-route kernel loads whole rows,
    and Triton tensors have power-of-two sizes)."""
    return max(_pow2_at_least(d + extra), 16)


def shuffle_stride_for(n: int) -> int:
    """A multiplicative stride coprime with n, near the golden ratio of n —
    the seedless analog of a random row shuffle. ``i -> (i * s) % n`` spreads
    any cluster-sorted input across the whole array so block minima satisfy
    lax.approx_min_k's uniform-layout assumption.

    Candidate ids translate back through a device inverse-permutation table
    gather on the pre_k survivors only. (NOT via modular arithmetic on
    device: without x64, int64 silently truncates to int32 and ``pos * s``
    overflows past ~2^31 — measured as recall collapsing to 0.003 at 1.18M
    while small-n CPU tests stayed green.)"""
    s = max(int(0.6180339887 * n) | 1, 1)
    while math.gcd(s, n) != 1:
        s += 2
    return s


def build_augmented_db(db: np.ndarray, n_valid: int, measure: DistanceMeasure,
                       tile_n: int = 2048,
                       shuffle_stride: int = 0,
                       pad_rows_to: int = 0) -> np.ndarray:
    """[N_pad, D1] bf16 augmented rows (built once at index time).

    The norm slot holds ||x||^2 for SQUARED_L2, 0 for DOT_PRODUCT/COSINE
    (cosine rows are L2-normalized here so the sweep scores -cos similarity),
    and BLOCK_MASK_VALUE for padded/invalid rows.

    ``shuffle_stride`` > 0 stores row i at permuted position (i*s) % n_valid
    — see :func:`shuffle_stride_for`. Real-world datasets often arrive
    cluster-sorted (crawl order, label order); without the shuffle the best
    blocks for a query cluster in contiguous block-minima columns and the
    approximate candidate selection degrades (same hazard as the tree-AH
    partition-major layout).
    """
    db = np.asarray(db, dtype=np.float32)
    n, d = db.shape
    d1 = augmented_dim(d)
    n_pad = max(align_up(max(n_valid, 1), tile_n), pad_rows_to)
    out = np.zeros((n_pad, d1), dtype=np.float32)
    rows = db
    if measure == DistanceMeasure.COSINE:
        norms = np.sqrt(np.einsum("nd,nd->n", db, db))
        rows = db / np.maximum(norms, 1e-30)[:, None]
    if shuffle_stride:
        pos = (np.arange(n, dtype=np.int64) * shuffle_stride) % max(n_valid, 1)
        out[pos[:n_valid], :d] = rows[:n_valid]
    else:
        out[:n, :d] = rows
    if measure == DistanceMeasure.SQUARED_L2:
        sq = np.einsum("nd,nd->n", db, db)
        if shuffle_stride:
            out[pos[:n_valid], d] = sq[:n_valid]
        else:
            out[:n, d] = sq
    out[n_valid:, d] = BLOCK_MASK_VALUE
    return out.astype(jnp.bfloat16)


def _encode_norm_digits(m: np.ndarray):
    """Non-negative ints -> three balanced base-128 digits in [-64, 63]."""
    d0 = ((m + 64) % 128) - 64
    c = (m - d0) // 128
    d1 = ((c + 64) % 128) - 64
    d2 = (c - d1) // 128
    return d0, d1, d2


def build_int8_augmented_db(db: np.ndarray, n_valid: int,
                            measure: DistanceMeasure, tile_n: int = 2048,
                            shuffle_stride: int = 0,
                            pad_rows_to: int = 0):
    """int8 sweep storage: HALF the bf16 stream bytes at near-equal recall.

    Returns ``(codes int8 [N_pad, D1], scales f32 [d], sn: float)``:

    - ``codes[:, :d]`` = per-dimension symmetric int8 (scale ``s_j =
      max|x_j| / 127``, folded into the query head at search time so the
      kernel is one int8->bf16 convert + the same matrix product);
    - ``codes[:, d:d+3]`` = the squared norm as base-128 digits (see
      INT8_NORM_DIGIT_MAX) for SQUARED_L2, zeros for dot/cosine;
    - padded/invalid rows carry the all-63 mask digits (decoded magnitude
      INT8_NORM_DIGIT_MAX * sn, >2.5x any real score — same sentinel role
      as BLOCK_MASK_VALUE in the bf16 layout).

    The norm digits live in columns the power-of-two row width pads anyway
    (d=100 -> 128), so the norm costs zero extra bytes; its resolution sn/2
    is ~200x finer than the bf16 layout's one-slot norm. Quantization noise
    in the -2q.x term is the only recall cost, recovered by the exact
    re-rank exactly as bf16 rounding is.
    """
    db = np.asarray(db, dtype=np.float32)
    n, d = db.shape
    d1 = augmented_dim(d, extra=3)
    n_pad = max(align_up(max(n_valid, 1), tile_n), pad_rows_to)
    rows = db
    if measure == DistanceMeasure.COSINE:
        norms = np.sqrt(np.einsum("nd,nd->n", db, db))
        rows = db / np.maximum(norms, 1e-30)[:, None]
    scales = np.abs(rows[:n_valid]).max(axis=0) / 127.0
    scales = np.maximum(scales, 1e-30).astype(np.float32)
    codes = np.zeros((n_pad, d1), dtype=np.int8)
    q = np.clip(np.rint(rows[:n_valid] / scales), -127, 127).astype(np.int8)
    if measure == DistanceMeasure.SQUARED_L2:
        sq = np.einsum("nd,nd->n", db[:n_valid], db[:n_valid])
        sn = float(2.0 ** np.ceil(np.log2(
            max(float(sq.max()), 1e-30) / INT8_NORM_REAL_MAX)))
        m = np.rint(sq / sn).astype(np.int64)
    else:
        # digits are zero for real rows; sn only scales the mask sentinel.
        # 512 puts the mask at ~5.3e8, the bf16 layout's 2^30-class margin.
        sn = 512.0
        m = np.zeros(n_valid, dtype=np.int64)
    g0, g1, g2 = _encode_norm_digits(m)
    if shuffle_stride:
        pos = (np.arange(n_valid, dtype=np.int64) * shuffle_stride) \
            % max(n_valid, 1)
    else:
        pos = np.arange(n_valid, dtype=np.int64)
    codes[pos, :d] = q
    codes[pos, d] = g0.astype(np.int8)
    codes[pos, d + 1] = g1.astype(np.int8)
    codes[pos, d + 2] = g2.astype(np.int8)
    # mask sentinel on padded rows (all-63 digits decode to DIGIT_MAX)
    mask_rows = np.ones(n_pad, dtype=bool)
    mask_rows[pos] = False
    codes[mask_rows, d:d + 3] = 63
    return codes, scales, sn


def int8_mask_cut(sn: float) -> float:
    """Validity threshold for int8-sweep block minima (mask sentinel / 2)."""
    return INT8_NORM_DIGIT_MAX * sn * 0.5


def _augment_queries_int8(queries: jnp.ndarray, measure: DistanceMeasure,
                          scales: jnp.ndarray, sn: float,
                          d1: int) -> jnp.ndarray:
    """[B, D1] bf16 query block matching ``build_int8_augmented_db``: the
    per-dim scales fold into the head; the three norm slots carry the
    base-128 multipliers (powers of two x sn -> exact in bf16)."""
    q = queries.astype(jnp.float32)
    b, d = q.shape
    if measure == DistanceMeasure.SQUARED_L2:
        head = -2.0 * q * scales
    elif measure == DistanceMeasure.COSINE:
        nq = jnp.sqrt(jnp.sum(q * q, axis=1, keepdims=True))
        head = -(q / jnp.maximum(nq, 1e-30)) * scales
    elif measure in (DistanceMeasure.DOT_PRODUCT,
                     DistanceMeasure.GENERAL_INNER_PRODUCT):
        head = -q * scales
    else:
        raise ValueError(f"unsupported sweep measure {measure}")
    out = jnp.zeros((b, d1), jnp.float32)
    out = out.at[:, :d].set(head)
    out = out.at[:, d].set(sn)
    out = out.at[:, d + 1].set(128.0 * sn)
    out = out.at[:, d + 2].set(16384.0 * sn)
    return out.astype(jnp.bfloat16)


def _augment_queries(queries: jnp.ndarray, measure: DistanceMeasure,
                     d1: int) -> jnp.ndarray:
    """[B, D1] bf16 query block matching ``build_augmented_db``'s layout."""
    q = queries.astype(jnp.float32)
    b, d = q.shape
    if measure == DistanceMeasure.SQUARED_L2:
        head = -2.0 * q
    elif measure == DistanceMeasure.COSINE:
        nq = jnp.sqrt(jnp.sum(q * q, axis=1, keepdims=True))
        head = -q / jnp.maximum(nq, 1e-30)
    elif measure in (DistanceMeasure.DOT_PRODUCT,
                     DistanceMeasure.GENERAL_INNER_PRODUCT):
        head = -q
    else:
        raise ValueError(f"unsupported sweep measure {measure}")
    out = jnp.zeros((b, d1), jnp.float32)
    out = out.at[:, :d].set(head)
    out = out.at[:, d].set(1.0)  # picks up the norm slot / mask sentinel
    return out.astype(jnp.bfloat16)


# Block sizes of the Triton-route kernel (powers of two; chosen by
# measurement on an H100, PERF.md "Kernel decisions at bring-up"):
# queries per program, rows per matrix-product tile, and rows each program
# walks with its query tile held (the inner loop Triton software-pipelines).
BLOCK_B = 64
BLOCK_N = 128
ROWS_PER_PROGRAM = 1024
NUM_WARPS = 4
NUM_STAGES = 3
# rows per chunk of the plain formulation's [B, chunk] f32 score matrix
XLA_CHUNK_ROWS = 65536


def _block_reduce(s, r: int, top2: bool):
    """[BB, T] scores -> per r-row block (min, argmin[, 2nd min, argmin]),
    each [BB, T/r]. Ties resolve to the lowest in-block offset."""
    bb, t = s.shape
    s3 = s.reshape(bb, t // r, r)
    iota = jax.lax.broadcasted_iota(jnp.int32, s3.shape, 2)
    m1 = jnp.min(s3, axis=2)
    l1 = jnp.min(jnp.where(s3 == m1[:, :, None], iota, r), axis=2)
    if not top2:
        return m1, l1
    s3 = jnp.where(iota == l1[:, :, None], jnp.inf, s3)
    m2 = jnp.min(s3, axis=2)
    l2 = jnp.min(jnp.where(s3 == m2[:, :, None], iota, r), axis=2)
    return m1, l1, m2, l2


def _block_min_kernel(q_ref, db_ref, *refs, r: int, block_n: int,
                      steps: int, top2: bool, has_pen: bool):
    """One program: a [BB, D1] query tile against ``steps`` consecutive
    [block_n, D1] row tiles. Each tile's scores live only in registers:
    bf16 x bf16 -> f32 on the tensor cores, + the allow penalty, then the
    r:1 reduce; only the [BB, block_n/r] minima are stored (query-major, so
    no transpose follows)."""
    pen_ref = refs[0] if has_pen else None
    outs = refs[1:] if has_pen else refs
    q = q_ref[...]
    w = block_n // r

    def step(i, carry):
        x = db_ref[pl.ds(i * block_n, block_n), :].astype(jnp.bfloat16)
        s = pl.dot(q, x, trans_b=True)                     # [BB, block_n]
        if pen_ref is not None:
            # restrict allowlist as an additive per-row penalty (0 allowed
            # / mask value denied), applied BEFORE the r:1 reduction so a
            # denied row can never occupy its block's candidate slot
            s = s + pen_ref[pl.ds(i * block_n, block_n)].astype(
                jnp.float32)[None, :]
        for o_ref, v in zip(outs, _block_reduce(s, r, top2)):
            o_ref[:, pl.ds(i * w, w)] = v
        return carry

    jax.lax.fori_loop(0, steps, step, 0)


def _tile_sizes(n: int, r: int):
    """(block_n, rows_per_program) for ``n`` rows: powers of two that
    divide n (rows are padded to a power-of-two tile at index time)."""
    rows = math.gcd(n, ROWS_PER_PROGRAM)
    block_n = max(math.gcd(rows, BLOCK_N), r)
    rows = max(rows, block_n)
    if n % rows or rows % r:
        raise ValueError(f"{n} rows do not tile into r={r} blocks")
    return block_n, rows


@functools.partial(jax.jit, static_argnames=("r", "top2", "interpret"))
def block_minima_pallas(q_aug, db_aug, penalty=None, *, r: int,
                        top2: bool = False, interpret: bool = False):
    """Triton-route Pallas block-min sweep.

    q_aug [B, D1] bf16, db_aug [N, D1] bf16 or int8 (D1 a power of two,
    N a multiple of r and of a power-of-two tile), optional ``penalty``
    ([N/r, r] from ``build_allow_penalty``). Returns query-major
    (vals [B, N/r] f32, locs [B, N/r] int32 in-block offsets), plus the
    second-smallest pair when ``top2``."""
    b, d1 = q_aug.shape
    n = db_aug.shape[0]
    block_n, rows = _tile_sizes(n, r)
    bb = min(BLOCK_B, max(_pow2_at_least(b), 16))
    b_pad = align_up(b, bb)
    if b_pad != b:
        q_aug = jnp.pad(q_aug, ((0, b_pad - b), (0, 0)))
    in_specs = [pl.BlockSpec((bb, d1), lambda j, i: (j, 0)),
                pl.BlockSpec((rows, d1), lambda j, i: (i, 0))]
    args = [q_aug, db_aug]
    if penalty is not None:
        in_specs.append(pl.BlockSpec((rows,), lambda j, i: (i,)))
        args.append(penalty.reshape(-1))
    n_out = 4 if top2 else 2
    out_spec = pl.BlockSpec((bb, rows // r), lambda j, i: (j, i))
    out_shape = (jax.ShapeDtypeStruct((b_pad, n // r), jnp.float32),
                 jax.ShapeDtypeStruct((b_pad, n // r), jnp.int32))
    outs = pl.pallas_call(
        functools.partial(_block_min_kernel, r=r, block_n=block_n,
                          steps=rows // block_n, top2=top2,
                          has_pen=penalty is not None),
        out_shape=out_shape * (n_out // 2),
        # query blocks vary fastest, so the programs sharing a row tile run
        # together and the tile is read from device memory once
        grid=(b_pad // bb, n // rows),
        in_specs=in_specs,
        out_specs=(out_spec,) * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="block_min_sweep",
    )(*args)
    return tuple(o[:b] for o in outs)


@functools.partial(jax.jit, static_argnames=("r", "top2"))
def block_minima_xla(q_aug, db_aug, penalty=None, *, r: int,
                     top2: bool = False):
    """Plain formulation of ``block_minima_pallas`` (same inputs, same
    query-major outputs): a bf16 matrix product per chunk of rows with f32
    accumulation, then a reshape-min. XLA writes each [B, chunk] f32 score
    chunk to memory and reads it back for the reduce."""
    b = q_aug.shape[0]
    n = db_aug.shape[0]
    chunk = min(align_up(XLA_CHUNK_ROWS, r), n)
    pen = None if penalty is None else penalty.reshape(-1)
    n_out = 4 if top2 else 2
    init = tuple(jnp.zeros((b, n // r), dt)
                 for dt in (jnp.float32, jnp.int32) * (n_out // 2))

    def body(c, outs):
        # the last chunk is clamped to end at n; the overlap is recomputed
        # identically
        lo = jnp.minimum(c * chunk, n - chunk)
        rows = jax.lax.dynamic_slice_in_dim(db_aug, lo, chunk)
        s = jax.lax.dot_general(
            q_aug, rows.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)            # [B, chunk]
        if pen is not None:
            s = s + jax.lax.dynamic_slice_in_dim(
                pen, lo, chunk).astype(jnp.float32)[None, :]
        return tuple(jax.lax.dynamic_update_slice_in_dim(o, v, lo // r,
                                                         axis=1)
                     for o, v in zip(outs, _block_reduce(s, r, top2)))

    return jax.lax.fori_loop(0, -(-n // chunk), body, init)


def build_allow_penalty(mask, n_pad: int, r: int, inv_perm=None,
                        mask_value: float = 4 * BLOCK_MASK_VALUE
                        ) -> np.ndarray:
    """Restrict allowlist -> [N_pad/r, r] bf16 additive penalty for the
    sweep kernels: 0 for allowed rows, ``mask_value`` for denied ones, in
    the sweep's STORED row order. ``inv_perm`` maps stored position ->
    original point id (the shuffle's inverse table; None = identity).
    Padding rows get 0 — their augmented norm slot already carries the mask
    sentinel. N*2 bytes of extra kernel stream (under 1% of the bf16 rows).

    ``mask_value`` defaults to 4x the bf16 layout's sentinel so a denied
    row's penalized score clears the validity cut even if its raw score is
    strongly negative; int8-layout callers pass 4 * INT8_NORM_DIGIT_MAX *
    sn, which scales with the data exactly as that layout's sentinel does."""
    mask = np.asarray(mask, dtype=bool)
    n = mask.shape[0]
    pen = np.zeros(n_pad, np.float32)
    stored = mask if inv_perm is None else mask[np.asarray(inv_perm)]
    pen[:n] = np.where(stored, 0.0, mask_value)
    return pen.reshape(n_pad // r, r).astype(jnp.bfloat16)


def sweep_block_candidates(q_aug, db_aug, *, pre_k: int, r: int,
                           penalty=None, top2: bool = False):
    """Block-min sweep over (a shard block of) the augmented rows ->
    (pv [B, pre_k] raw sweep scores f32, cand [B, pre_k] int32 local row
    indices). Shared by the single-device pipeline and the sharded
    wrapper's shard body; the formulation follows the platform
    (types.use_gpu_kernels).

    ``top2=True`` keeps the TWO smallest per selected block, returning
    [B, 2*pre_k] pv/cand — removes the one-candidate-per-block collision
    ceiling at the cost of doubled block-minima writes and re-rank width."""
    if use_gpu_kernels():
        minima = block_minima_pallas(q_aug, db_aug, penalty, r=r, top2=top2)
    else:
        minima = block_minima_xla(q_aug, db_aug, penalty, r=r, top2=top2)
    pv, blk = approx_top_k_smallest(minima[0], pre_k)      # [B, pre_k]
    cand = blk * r + jnp.take_along_axis(minima[1], blk, axis=1)
    if top2:
        pv2 = jnp.take_along_axis(minima[2], blk, axis=1)
        loc2 = jnp.take_along_axis(minima[3], blk, axis=1)
        pv = jnp.concatenate([pv, pv2], axis=1)            # [B, 2*pre_k]
        cand = jnp.concatenate([cand, blk * r + loc2], axis=1)
    return pv, cand


def sweep_approx_in_measure_units(pv, queries, measure: DistanceMeasure):
    """Sweep scores -> the measure's own units (for pre_eps compares):
    L2 adds ||q||^2 (pv = ||x||^2 - 2 q.x), cosine adds 1 (pv = -cos)."""
    if measure == DistanceMeasure.SQUARED_L2:
        q_sq = jnp.sum(queries.astype(jnp.float32) ** 2, axis=1)
        return pv + q_sq[:, None]
    if measure == DistanceMeasure.COSINE:
        return 1.0 + pv
    return pv


@functools.partial(jax.jit, static_argnames=("pre_k", "k", "measure", "r",
                                             "top2", "aug_sn"))
def sweep_search_kernel(
    db_aug, db, db_sq_norms, n_valid, queries,
    pre_eps=jnp.inf, post_eps=jnp.inf, inv_perm=None, aug_scales=None,
    allow_pen=None,
    *, pre_k: int, k: int,
    measure: DistanceMeasure, r: int = 32, top2: bool = False,
    aug_sn: float = 0.0,
):
    """Full pipeline: block-min sweep -> approx top-pre_k over block
    minima -> exact f32 re-rank -> top-k. One device program.

    ``db_aug`` is either the bf16 layout (build_augmented_db) or the int8
    layout (build_int8_augmented_db, half the stream bytes); for int8 pass
    ``aug_scales`` ([d] f32) and ``aug_sn`` (static float) so the query
    head folds the per-dim scales and the norm-digit multipliers.

    pre_eps filters on the sweep's (rank-equivalent) approximate distances,
    post_eps on exact re-ranked distances — SearchParameters semantics
    (reference: src/searcher.rs:12-30).

    top2=True re-ranks the two smallest per selected block, removing the
    one-candidate-per-block collision ceiling (~0.998 recall@10 at 1.18M)
    at the cost of doubled block-minima writes and re-rank width.

    ``allow_pen`` ([N_pad/r, r] from ``build_allow_penalty``) fuses a
    restrict allowlist into the pre-reduction scores, so denied rows can
    never shadow allowed ones inside a block — exact filter semantics at
    any selectivity (reference: tree_x_hybrid/mod.rs:297-339 applies the
    filter before scoring each point).
    """
    d1 = db_aug.shape[1]
    if db_aug.dtype == jnp.int8:
        q_aug = _augment_queries_int8(queries, measure, aug_scales, aug_sn,
                                      d1)
        mask_cut = int8_mask_cut(aug_sn)
    else:
        q_aug = _augment_queries(queries, measure, d1)
        mask_cut = BLOCK_MASK_VALUE / 2
    pv, cand = sweep_block_candidates(q_aug, db_aug, pre_k=pre_k, r=r,
                                      penalty=allow_pen, top2=top2)

    # approximate distance in the measure's own units for pre_eps
    approx = sweep_approx_in_measure_units(pv, queries, measure)
    pre_valid = (pv < mask_cut) & (approx <= pre_eps)

    from scann_tpu.utils.reordering import (
        gather_rerank_rows,
        rerank_store_rows,
    )

    safe = jnp.clip(cand, 0, rerank_store_rows(db) - 1)
    rows = gather_rerank_rows(db, safe)                  # [B, pre_k, D]
    # norms recomputed from the gathered rows (identical math to the
    # table, and no per-element norm gather)
    norms = jnp.sum(rows * rows, axis=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    exact = jnp.where(pre_valid, exact, MASKED_DISTANCE)
    out_vals, pos = top_k_smallest(exact, k)
    idx = jnp.take_along_axis(cand, pos, axis=1)
    if inv_perm is not None:
        # stored positions are (id * stride) % n_valid; the rerank store
        # is laid out in the SAME permuted order, so true ids resolve only
        # for the k winners — a [B, k] gather instead of [B, pre_k]
        idx = jnp.take(inv_perm, jnp.clip(idx, 0, inv_perm.shape[0] - 1),
                       axis=0)
    missing = (out_vals >= MASKED_DISTANCE / 2) | (out_vals > post_eps)
    return (jnp.where(missing, jnp.inf, out_vals),
            jnp.where(missing, -1, idx))
