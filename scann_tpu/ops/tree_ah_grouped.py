"""Grouped leaf scoring for tree-×-AH.

Many queries probe the same partition, so the (query, partition) pairs are
grouped by partition (device-side sort, no host round trip) and each
partition's codes are read once per group of up to ``q_cap`` queries
instead of once per pair. Scoring a group is a matrix product

    [q_cap, S·C] residual LUTs  ×  [S·C, l_tile] code one-hots

per L-tile of the partition. Work is size-adaptive: L-tiles beyond a
partition's size skip the loads and the products and just emit the masked
sentinel, so skewed partitions cost what they contain, not l_cap.

This is the reference's per-partition scoring loop
(reference: src/tree_x_hybrid/mod.rs:297-339) with its rayon threads as
kernel programs and its scalar LUT loop as a matrix product.

``grouped_scores_pallas`` is a Triton-route Pallas kernel, served on the
GPU; the CPU and the tests score through the plain per-pair gather
formulation (models/tree_x_hybrid.leaf_scores_xla). PERF.md "Kernel
decisions at bring-up" has the measurement that chose the kernel over that
formulation and over a plain grouped contraction.

Layout contract:
  - codes_t [S_rows, N_csr] uint8, partition-contiguous columns (the
    transposed CSR slab: a subspace's codes for consecutive rows are
    contiguous). ``packed``: S_rows = S_pad/2, byte j holds subspaces 2j
    (low nibble) and 2j+1 (high), the reference layout (lut16.rs:43-61);
  - luts [NG, q_cap, S_pad·C], zero columns for pad subspaces.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from scann_tpu.types import MASKED_DISTANCE

# Candidates per program of the Triton-route kernel; partitions' leaf
# capacity l_cap is a multiple of it. Power of two, chosen by measurement on
# an H100 (PERF.md "Kernel decisions at bring-up").
L_TILE = 128
# rows of a tensor-core product: groups of fewer queries pad to this
MIN_GROUP_ROWS = 16
NUM_WARPS = 4
NUM_STAGES = 3


def group_pairs_by_partition(
    parts: jnp.ndarray, num_partitions: int, q_cap: int
) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Group the [B, p] selected-partition pairs by partition id, q_cap
    pairs per group (a partition probed by more queries spans several
    groups; every group holds pairs of exactly one partition).

    Runs entirely on device (sort + scans) — no host sync between partition
    selection and leaf scoring.

    Returns:
        grp_part: [NG] int32 partition id per group, **-1 for unused
            groups** — callers must zero those groups' sizes so the kernel
            skips their DMA and compute entirely (an early version scored
            partition 0's codes for every unused group, a large share of
            all programs at B=1024, p=10, 3.8k partitions).
        slot: [B*p] int32 row of each pair in the [NG*q_cap] grouped layout.
        NG: static group-count upper bound,
            min(T, B·p) + ceil(B·p / q_cap) — each distinct partition can
            open at most one partially-filled group.
    """
    b, p = parts.shape
    bp = b * p
    ng = min(int(num_partitions), bp) + -(-bp // q_cap)
    flat = parts.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat)                     # stable
    sp = jnp.take(flat, order)
    idx = jnp.arange(bp, dtype=jnp.int32)
    newrun = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sp[1:] != sp[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(newrun, idx, 0))    # cummax of run heads
    rank = idx - run_start
    newgrp = newrun | (rank % q_cap == 0)
    grp_id = jnp.cumsum(newgrp.astype(jnp.int32)) - 1
    slot_sorted = grp_id * q_cap + rank % q_cap
    slot = jnp.zeros((bp,), jnp.int32).at[order].set(slot_sorted)
    grp_part = jnp.full((ng,), -1, jnp.int32).at[grp_id].set(sp)
    return grp_part, slot, ng


def _grouped_kernel(off_ref, size_ref, lut_ref, codes_ref, out_ref, *,
                    l_tile: int, n_rows: int, packed: bool, num_codes: int):
    """One program: one group's LUT rows against one L-tile of its
    partition. Offsets and sizes are loaded by the program itself; the
    subspace loop is what Triton pipelines (``num_stages``)."""
    g = pl.program_id(0)
    start = pl.program_id(1) * l_tile
    size = size_ref[g]
    qp = out_ref.shape[0]
    col = start + jax.lax.broadcasted_iota(jnp.int32, (qp, l_tile), 1)

    def compute():
        base = off_ref[g] + start
        iota_c = jax.lax.broadcasted_iota(jnp.int32, (num_codes, l_tile), 0)

        def score(acc, s, codes):
            # the [S·C, l_tile] one-hot does not fit one program's
            # registers: contract one subspace's [C, l_tile] slice at a time
            onehot = (codes[None, :] == iota_c).astype(jnp.bfloat16)
            lut = lut_ref[:, pl.ds(s * num_codes, num_codes)]
            return acc + pl.dot(lut, onehot)

        def body(j, acc):
            row = codes_ref[j, pl.ds(base, l_tile)].astype(jnp.int32)
            if packed:
                acc = score(acc, 2 * j, row & 0xF)
                return score(acc, 2 * j + 1, row >> 4)
            return score(acc, j, row)

        acc = jax.lax.fori_loop(0, n_rows, body,
                                jnp.zeros((qp, l_tile), jnp.float32))
        return jnp.where(col < size, acc, MASKED_DISTANCE)

    res = jax.lax.cond(
        start < size, compute,
        lambda: jnp.full((qp, l_tile), MASKED_DISTANCE, jnp.float32))
    out_ref[...] = res.astype(out_ref.dtype)


@functools.partial(jax.jit,
                   static_argnames=("l_cap", "packed", "interpret"))
def grouped_scores_pallas(luts3, codes_t, grp_offsets, grp_sizes, *,
                          l_cap: int, packed: bool = False,
                          interpret: bool = False):
    """Triton-route grouped scores: [NG, q_cap, l_cap] bf16, masked
    (MASKED_DISTANCE) beyond each group's size.

    luts3 [NG, q_cap, S_pad·C] bf16 grouped LUTs (C a power of two >= 16,
    the tensor cores' minimum depth); codes_t the transposed
    CSR slab (see the module docstring); grp_offsets/grp_sizes [NG] int32
    CSR start and size of each group's partition (size 0 = unused group,
    which costs one masked store per tile). The slab must hold l_cap
    columns past the last partition start. bf16 output: these are
    PQ-approximate pre-rank scores, re-ranked exactly downstream."""
    ng, q, sc = luts3.shape
    n_rows = codes_t.shape[0]
    num_codes = sc // (2 * n_rows if packed else n_rows)
    if (sc % n_rows or num_codes < 16 or num_codes & (num_codes - 1)
            or (packed and num_codes != 16)):
        raise ValueError(f"LUT width {sc} over {n_rows} code rows "
                         f"(packed={packed}) is not a power-of-two code "
                         f"count >= 16 (16 when packed)")
    if l_cap % L_TILE:
        raise ValueError(f"l_cap {l_cap} must be a multiple of {L_TILE}")
    qp = max(MIN_GROUP_ROWS, 1 << (q - 1).bit_length())
    if qp != q:
        luts3 = jnp.pad(luts3, ((0, 0), (0, qp - q), (0, 0)))
    out = pl.pallas_call(
        functools.partial(_grouped_kernel, l_tile=L_TILE, n_rows=n_rows,
                          packed=packed, num_codes=num_codes),
        out_shape=jax.ShapeDtypeStruct((ng, qp, l_cap), jnp.bfloat16),
        grid=(ng, l_cap // L_TILE),
        in_specs=[pl.no_block_spec, pl.no_block_spec,
                  pl.BlockSpec((None, qp, sc), lambda g, t: (g, 0, 0)),
                  pl.no_block_spec],
        out_specs=pl.BlockSpec((None, qp, L_TILE), lambda g, t: (g, 0, t)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="tree_ah_grouped",
    )(grp_offsets.astype(jnp.int32), grp_sizes.astype(jnp.int32),
      luts3.astype(jnp.bfloat16), codes_t)
    return out[:, :q]
