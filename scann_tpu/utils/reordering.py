"""Exact re-ranking helper (reference: src/utils/reordering.rs:8-123).

Device path: gather candidate rows, one einsum, top-k — used standalone here
and fused inside the tree-AH / hasher programs. The reference re-scores
candidates in a host loop (rayon above 100 candidates).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.ops.distances import DistanceMeasure, gathered_distances
from scann_tpu.ops.topk import top_k_smallest
from scann_tpu.types import MASKED_DISTANCE


@functools.partial(jax.jit, static_argnames=("measure", "k"))
def reorder_kernel(db, db_sq_norms, queries, candidates, *, measure: DistanceMeasure, k: int):
    """Re-rank candidate lists by exact distance.

    Args:
        db: [N, D]; db_sq_norms: [N]; queries: [B, D];
        candidates: [B, C] int32 (-1 = missing).

    Returns (dists [B, k], indices [B, k]) sorted ascending, -1/inf padded.
    """
    valid = candidates >= 0
    safe = jnp.maximum(candidates, 0)
    rows = jnp.take(db, safe, axis=0)
    norms = jnp.sum(rows.astype(jnp.float32) ** 2, axis=-1)
    dists = gathered_distances(measure, queries, rows, norms)
    dists = jnp.where(valid, dists, MASKED_DISTANCE)
    vals, pos = top_k_smallest(dists, k)
    idx = jnp.take_along_axis(candidates, pos, axis=1)
    missing = vals >= MASKED_DISTANCE / 2
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


class ReorderingHelper:
    """(reference: reordering.rs:8-94)."""

    def __init__(self, distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
        self.distance_measure = distance_measure

    def reorder(self, dataset, queries: np.ndarray, candidates: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
        """dataset: DenseDataset; queries [B, D]; candidates [B, C] indices."""
        db, n = dataset.device()
        norms = jnp.sum(db.astype(jnp.float32) ** 2, axis=1)
        q = jnp.asarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None, :]
        cand = jnp.asarray(np.asarray(candidates, np.int32))
        if cand.ndim == 1:
            cand = cand[None, :]
        vals, idx = reorder_kernel(db, norms, q, cand,
                                   measure=self.distance_measure, k=min(k, cand.shape[1]))
        return np.asarray(idx), np.asarray(vals)


def rerank_codec(data: np.ndarray, n: int, dtype: str):
    """Shared rerank-copy codec: (storage dtype, row encoder, dequant).

    ``dequant`` is None for float storage, or ``(scale, min)`` for int8 —
    the ``codes * scale + min`` fusion the search kernels apply after the
    candidate gather. int8 calibration is PER-DIMENSION affine: scale/min
    are [D] vectors (exact min..max of each coordinate over 256 levels),
    so a wide-range dimension cannot destroy the resolution of every
    other one the way one global (scale, min) does — measured at 20M the
    global codec cost 3.5pp recall@10 vs bf16 at the same config while
    the per-dim sweep path did not (the same granularity ops/sweep_pallas.build_int8_augmented_db already uses).
    The dequant broadcast over the trailing axis costs the kernels
    nothing. The reference declares quantized reordering but never
    implements it (config.rs:290-318); its scalar codec is global
    (scalar.rs:103-130) — this is the finer-by-design replacement. ONE
    definition of the codec, used by build_rerank_store and by the
    sharded wrappers' custom layouts (per-shard blocks, per-partition
    CSR)."""
    if dtype == "int8":
        valid = data[:n]
        mn = valid.min(axis=0).astype(np.float32)
        scale = ((valid.max(axis=0) - mn) / 255.0).astype(np.float32)
        scale = np.maximum(scale, 1e-30)

        def encode(rows):
            return np.clip(np.rint((rows - mn) / scale), 0, 255) \
                .astype(np.uint8)

        return np.uint8, encode, (scale, mn)
    if dtype == "bfloat16":
        import ml_dtypes

        dt = ml_dtypes.bfloat16
    elif dtype == "float32":
        dt = np.float32
    else:
        raise ValueError(f"unsupported rerank dtype {dtype!r}")
    return dt, (lambda rows: rows.astype(dt)), None


def residual_rerank_codec(data: np.ndarray, n: int, tokens: np.ndarray,
                          centers: np.ndarray, clip_sigmas: float = 4.0,
                          levels: int = 255):
    """Anchored int8 codec for partitioned searchers: quantize the RESIDUAL
    ``row - centers[token]`` per-dimension and add the centroid back after
    the candidate gather.

    On clustered data (every production ≥10M workload here) the residual
    range is the within-cluster noise scale, not the cluster spread, so the
    256 levels resolve what actually separates near-neighbors — the
    mechanism behind the global codec's recall@10 loss at 20M. The
    anchors are the tree's own partition
    centroids: zero extra training, one extra [N] int32 token table, and a
    small-table centroid gather fused after the candidate gather.

    The per-dim range is CLIPPED at mean ± ``clip_sigmas``·σ (intersected
    with the observed min/max — the reference's own calibration shape,
    scalar.rs:103-130): over 20M rows the exact per-dim extremes are
    ~±8-10σ outliers, and spending the 256 levels on them triples the
    quantization step for the 99.99% of mass inside ±4σ. Measured on the
    20M workload's true-candidate rerank, min/max calibration loses ~2.4pp recall@10 vs
    bf16 while ±4σ clipping recovers most of it. Clipped rows saturate —
    exact for ranking purposes at these tail probabilities.

    Returns ``(encode(rows, row_tokens) -> u8, (scale [D], mn [D]))``.
    """
    valid = data[:n]
    d = data.shape[1]
    resid_mn = np.full(d, np.inf, np.float32)
    resid_mx = np.full(d, -np.inf, np.float32)
    s1 = np.zeros(d, np.float64)
    s2 = np.zeros(d, np.float64)
    cs = max(1, (1 << 22) // max(d, 1))
    for lo in range(0, n, cs):
        r = valid[lo:lo + cs] - centers[tokens[lo:lo + cs]]
        resid_mn = np.minimum(resid_mn, r.min(axis=0))
        resid_mx = np.maximum(resid_mx, r.max(axis=0))
        s1 += r.sum(axis=0, dtype=np.float64)
        s2 += np.einsum("nd,nd->d", r, r, dtype=np.float64)
    mean = (s1 / max(n, 1)).astype(np.float32)
    std = np.sqrt(np.maximum(s2 / max(n, 1) - mean.astype(np.float64) ** 2,
                             0.0)).astype(np.float32)
    if clip_sigmas is not None and clip_sigmas > 0:
        lo_c = np.maximum(resid_mn, mean - clip_sigmas * std)
        hi_c = np.minimum(resid_mx, mean + clip_sigmas * std)
    else:
        lo_c, hi_c = resid_mn, resid_mx
    scale = np.maximum((hi_c - lo_c) / float(levels), 1e-30).astype(np.float32)
    mn = lo_c.astype(np.float32)
    store_dt = np.uint8 if levels <= 255 else np.uint16

    def encode(rows, row_tokens):
        r = rows - centers[row_tokens]
        return np.clip(np.rint((r - mn) / scale), 0, levels).astype(store_dt)

    return encode, (scale, mn)


def build_residual_rerank_store(data: np.ndarray, n: int, tokens: np.ndarray,
                                centers: np.ndarray, row_align: int,
                                levels: int = 255):
    """Residual-anchored int8/int16 rerank store (see
    residual_rerank_codec): returns ``((codes, scale, mn, tok, centers),
    norms)`` — the 5-tuple db_repr :func:`gather_rerank_rows` dequantizes
    after the gather. Norms come from the SAME dequantized rows the
    gathers produce. ``levels=65535`` gives the int16 store: bf16's byte
    cost with a ~256x finer step on the RESIDUAL scale — measured
    re-ranking essentially exactly where bf16 loses 0.55pp in-pool at
    20M."""
    from scann_tpu.types import align_up

    encode, (scale, mn) = residual_rerank_codec(data, n, tokens, centers,
                                                levels=levels)
    n_pad = align_up(max(n, 1), row_align)
    host = np.zeros((n_pad, data.shape[1]),
                    np.uint8 if levels <= 255 else np.uint16)
    cs = max(1, (1 << 22) // max(data.shape[1], 1))
    for lo in range(0, n, cs):
        hi = min(lo + cs, n)
        host[lo:hi] = encode(data[lo:hi], tokens[lo:hi])
    tok = np.zeros(n_pad, np.int32)
    tok[:n] = tokens[:n]
    store = jnp.asarray(host)
    tok_dev = jnp.asarray(tok)
    cent_dev = jnp.asarray(centers, jnp.float32)
    sc = jnp.asarray(scale, jnp.float32)
    mnd = jnp.asarray(mn, jnp.float32)

    @jax.jit
    def _norms(codes, t):
        x = codes.astype(jnp.float32) * sc + mnd \
            + jnp.take(cent_dev, t, axis=0)
        return jnp.sum(x * x, axis=-1)

    # chunked: the f32 decode of the full store must not materialize
    n_rows = store.shape[0]
    ch = max(1, (1 << 22) // max(data.shape[1], 1))
    ch = int(align_up(ch, row_align))
    parts = [_norms(store[lo:lo + ch], tok_dev[lo:lo + ch])
             for lo in range(0, n_rows, ch)]
    norms = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return (store, sc, mnd, tok_dev, cent_dev), norms


def encode_rerank_rows(out: np.ndarray, data: np.ndarray, n: int, encode):
    """Chunked host-side encode of ``data[:n]`` into a preallocated store
    (keeps f32 temps ~16 MB regardless of N; ``out`` may be padded past n)."""
    cs = max(1, (1 << 22) // max(data.shape[1], 1) - 1)
    for i in range(0, n, cs):
        hi = min(i + cs, n)
        out[i:hi] = encode(data[i:hi])


def rerank_norms_fn(dequant, out_shardings=None):
    """Jitted squared-norms over a rerank store. Norms MUST come from the
    SAME rounded/dequantized rows the rerank gathers (f32 accumulation),
    or small exact distances go negative; the dequant fuses into the
    reduction so no [N, D] f32 copy lands in HBM."""
    def _norms(x):
        x = (x.astype(jnp.float32) * dequant[0] + dequant[1]) \
            if dequant is not None else x.astype(jnp.float32)
        return jnp.sum(x * x, axis=-1)

    if out_shardings is not None:
        return jax.jit(_norms, out_shardings=out_shardings)
    return jax.jit(_norms)


def build_rerank_store(data: np.ndarray, n: int, dtype: str,
                       row_align: int):
    """(db_repr, norms): the device copy exact re-ranking gathers from.

    ``dtype``: "float32" (caller should use its own f32 device cache
    instead), "bfloat16" — bf16 rows at half the f32 bytes, or "int8" —
    calibrated u8 codes at a quarter, returned as a ``(codes, scale, min)``
    tuple whose dequant the search kernels fuse after the candidate gather
    (see :func:`rerank_codec`). Low-precision copies upload straight from
    host — no f32 device copy is ever materialized. Shared by
    TreeXHybridSearcher and BlockSweepSearcher (rerank_dtype); the sharded
    wrappers compose the same codec helpers over their own layouts.
    """
    from scann_tpu.types import align_up

    if dtype == "float32":
        raise ValueError("unsupported rerank dtype 'float32'")
    n_pad = align_up(max(n, 1), row_align)
    dt, encode, dequant = rerank_codec(data, n, dtype)
    host = np.zeros((n_pad, data.shape[1]), dtype=dt)
    encode_rerank_rows(host, data, n, encode)
    store = jnp.asarray(host)
    norms = rerank_norms_fn(dequant)(store)
    if dequant is not None:
        return (store, jnp.asarray(dequant[0], jnp.float32),
                jnp.asarray(dequant[1], jnp.float32)), norms
    return store, norms


ID_LANES = 4  # base-256 digits: ids to 2^32, exact in bf16/f32/u8 lanes


def build_csr_rerank_store(data: np.ndarray, perm: np.ndarray,
                           dtype: str, row_parts: np.ndarray = None,
                           tokens: np.ndarray = None,
                           centers: np.ndarray = None):
    """Rerank store in CSR (partition-sorted, aligned) row order with the
    original point id embedded as ``ID_LANES`` base-256 digit lanes.

    The tree-AH pipeline resolves candidate CSR rows arithmetically after
    selection (models/tree_x_hybrid.candidate_rows_from_positions) — but
    translating those rows to original ids for the rerank gather costs a
    ``[B, sel_k]`` scalar gather over the [N_csr] perm table. Storing the
    rerank rows in CSR order instead makes the row gather take CSR
    positions DIRECTLY, and the id rides along in ``ID_LANES`` extra
    columns (104 instead of 100 at d=100). Under spilling the store
    carries one row per ASSIGNMENT (×multiplicity memory) — the layout is
    opt-in there.

    Digits are base-256 (exact in bf16's 8-bit mantissa, in f32, and raw
    in u8); alignment-gap rows encode data[perm[gap]]=data[0] with id 0
    and are excluded downstream by their MASKED approx scores exactly like
    today. Returns the [N_csr, D+ID_LANES] device array (bf16 / f32).

    Reference: no counterpart — reordering.rs:22-94 re-scores on the host
    where "gather" is a pointer chase; on a device a per-element scalar
    gather is a separate dependent pass, which this layout removes.
    """
    d = data.shape[1]
    n_csr = len(perm)
    anchored = dtype in ("int8", "int16")
    if anchored:
        if row_parts is None or tokens is None or centers is None:
            raise ValueError(
                "rerank_layout='csr' with an anchored codec needs "
                "row_parts (per-CSR-row partition), tokens and centers")
        levels = 255 if dtype == "int8" else 65535
        # calibration stats over primary-token residuals (identical to
        # the id layout's at one assignment per point); encode each CSR
        # row against ITS OWN partition's centroid so reconstruction
        # r + c[part(row)] is exact under spilling too
        enc_tok, (scale, mn) = residual_rerank_codec(
            data, len(data), tokens, centers, levels=levels)
        dt = np.uint8 if levels <= 255 else np.uint16

        def encode_rows(rows, parts_blk):
            r = rows - centers[parts_blk]
            return np.clip(np.rint((r - mn) / scale), 0,
                           levels).astype(dt)
    else:
        dt, encode, _ = rerank_codec(data, len(data), dtype)
    host = np.zeros((n_csr, d + ID_LANES), dtype=dt)
    ids = perm.astype(np.int64)
    cs = max(1, (1 << 22) // max(d, 1))
    for lo in range(0, n_csr, cs):
        hi = min(lo + cs, n_csr)
        if anchored:
            host[lo:hi, :d] = encode_rows(data[perm[lo:hi]],
                                          row_parts[lo:hi])
        else:
            host[lo:hi, :d] = encode(data[perm[lo:hi]])
        block = ids[lo:hi]
        for j in range(ID_LANES):
            host[lo:hi, d + j] = ((block >> (8 * j)) & 0xFF).astype(dt)
    store = jnp.asarray(host)
    if anchored:
        return (store, jnp.asarray(scale, jnp.float32),
                jnp.asarray(mn, jnp.float32))
    return store


def gather_csr_rerank_rows(store_repr, csr_rows, d: int):
    """Gather ``[B, sel]`` CSR rows from an id-embedded store: returns
    (f32 data rows [B, sel, d], decoded int32 ids [B, sel]) — one row
    gather, no perm translation. An anchored ``(codes, scale, mn)`` store
    returns the dequantized RESIDUAL rows; the caller adds the per-slot
    partition centroid back (reconstructed arithmetically from the
    selection position — no anchor-token gather exists in this layout)."""
    anchored = isinstance(store_repr, tuple)
    store = store_repr[0] if anchored else store_repr
    raw = jnp.take(store, csr_rows, axis=0)
    rows = raw[..., :d].astype(jnp.float32)
    if anchored:
        rows = rows * store_repr[1] + store_repr[2]
    digits = raw[..., d : d + ID_LANES].astype(jnp.int32)
    ids = (digits[..., 0] | (digits[..., 1] << 8) | (digits[..., 2] << 16)
           | (digits[..., 3] << 24))
    return rows, ids


def gather_rerank_rows(db_repr, idx):
    """f32 candidate rows gathered from a rerank store built by
    :func:`build_rerank_store` / :func:`build_residual_rerank_store` (or a
    plain f32 array): int8 stores dequantize only the gathered rows (the
    residual 5-tuple adds its anchor centroid back — a small-table gather);
    bf16 rows cast after the gather."""
    if isinstance(db_repr, tuple):
        if len(db_repr) == 5:
            q8, scale, mn, tok, centers = db_repr
            anchors = jnp.take(centers, jnp.take(tok, idx, axis=0), axis=0)
            return (jnp.take(q8, idx, axis=0).astype(jnp.float32) * scale
                    + mn + anchors)
        q8, scale, mn = db_repr
        return jnp.take(q8, idx, axis=0).astype(jnp.float32) * scale + mn
    rows = jnp.take(db_repr, idx, axis=0)
    return rows if rows.dtype == jnp.float32 else rows.astype(jnp.float32)


def rerank_store_rows(db_repr) -> int:
    """Row count (padded) of a rerank store of any representation."""
    return (db_repr[0] if isinstance(db_repr, tuple) else db_repr).shape[0]
