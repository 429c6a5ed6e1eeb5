"""PQ lookup-table scoring kernels.

Replaces the reference's scalar LUT loop and AVX2 PSHUFB batch kernel
(reference: src/hashes/lut.rs:74-82, src/hashes/lut16_simd.rs:172-299).

A device has no byte-shuffle batch instruction to mirror PSHUFB; the 16-way
(or C-way) table lookup is expressed two ways:

  * **one-hot matmul** (C <= 32): per code chunk build ``onehot [T, S*C]``
    on the fly (a compare against an iota), then one matmul with the
    flattened tables ``[B, S*C]``. The lookup becomes dense FLOPs — 2*C more
    MACs than the scalar sum, but they run on the matrix units and the
    one-hot need not reach device memory when XLA fuses the compare into
    the matmul's operand production.
  * **gather** (large C, e.g. 256): ``take_along_axis`` per subspace,
    summed — elementwise work linear in C.

Both stream codes in chunks so intermediates stay on-chip-sized.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _score_chunk_onehot(luts_flat: jnp.ndarray, codes_chunk: jnp.ndarray,
                        num_codes: int) -> jnp.ndarray:
    """luts_flat [B, S*C] f32, codes_chunk [T, S] -> [T, B] scores."""
    t, s = codes_chunk.shape
    # onehot[t, s, c] = (codes[t, s] == c), laid out flat as [T, S*C]
    iota = jax.lax.broadcasted_iota(jnp.int32, (t, s, num_codes), 2)
    onehot = (codes_chunk.astype(jnp.int32)[:, :, None] == iota)
    onehot = onehot.reshape(t, s * num_codes).astype(jnp.bfloat16)
    return jax.lax.dot_general(
        onehot, luts_flat.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _score_chunk_gather(luts: jnp.ndarray, codes_chunk: jnp.ndarray) -> jnp.ndarray:
    """luts [B, S, C], codes_chunk [T, S] -> [T, B] scores via gather."""
    # luts_t [S, C, B]; take codes along C
    luts_t = jnp.transpose(luts, (1, 2, 0))
    gathered = jnp.take_along_axis(
        luts_t,  # [S, C, B]
        codes_chunk.astype(jnp.int32).T[:, :, None],  # [S, T, 1]
        axis=1,
    )  # [S, T, B]
    return jnp.sum(gathered, axis=0)


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def lut_score(luts: jnp.ndarray, codes: jnp.ndarray, chunk_size: int = 16384) -> jnp.ndarray:
    """Approximate distances [B, N] = sum_s luts[b, s, codes[n, s]].

    Args:
        luts: [B, S, C] f32 per-query tables.
        codes: [N, S] uint8 database codes.
    """
    b, s, c = luts.shape
    n = codes.shape[0]
    use_onehot = c <= 32
    luts_flat = luts.reshape(b, s * c)

    def one_chunk(codes_chunk):
        if use_onehot:
            out = _score_chunk_onehot(luts_flat, codes_chunk, c)
        else:
            out = _score_chunk_gather(luts, codes_chunk)
        return out  # [T, B]

    if n <= chunk_size:
        return one_chunk(codes).T

    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    codes_p = jnp.pad(codes, ((0, n_pad - n), (0, 0)))
    out = jax.lax.map(one_chunk, codes_p.reshape(n_chunks, chunk_size, s))
    return out.reshape(n_pad, b)[:n].T


def lut_score_gathered(luts: jnp.ndarray, codes_per_query: jnp.ndarray,
                       chunk_t: int = 8192) -> jnp.ndarray:
    """Score per-query candidate code lists (tree-AH leaf path).

    Uses a chunked flat-index gather — NOT the one-hot matmul: with per-query
    candidate lists the one-hot would materialize [B, T, S*C] in HBM (GBs at
    database scale), while the gather touches only [B, chunk, S] floats per
    step.

    Args:
        luts: [B, S, C] f32.
        codes_per_query: [B, T, S] codes gathered per query.

    Returns: [B, T] approximate distances.
    """
    b, s, c = luts.shape
    t = codes_per_query.shape[1]
    luts_flat = luts.reshape(b, s * c)
    base = (jnp.arange(s, dtype=jnp.int32) * c)[None, None, :]  # [1, 1, S]

    def one_chunk(codes_chunk):  # [B, Tc, S]
        flat_idx = codes_chunk.astype(jnp.int32) + base
        vals = jnp.take_along_axis(
            luts_flat[:, None, :], flat_idx.reshape(b, -1)[:, None, :], axis=2
        )  # [B, 1, Tc*S]
        return jnp.sum(vals.reshape(b, codes_chunk.shape[1], s), axis=-1)

    if t <= chunk_t:
        return one_chunk(codes_per_query)
    n_chunks = -(-t // chunk_t)
    t_pad = n_chunks * chunk_t
    padded = jnp.pad(codes_per_query, ((0, 0), (0, t_pad - t), (0, 0)))
    chunks = jnp.moveaxis(padded.reshape(b, n_chunks, chunk_t, s), 1, 0)
    out = jax.lax.map(one_chunk, chunks)  # [n_chunks, B, chunk_t]
    return jnp.moveaxis(out, 0, 1).reshape(b, t_pad)[:, :t]
