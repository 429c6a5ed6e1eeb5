"""Grouped tree-AH leaf scoring: grouping math + kernel parity (the
Triton-route kernel in interpret mode against plain formulations)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from scann_tpu.ops.tree_ah_grouped import (
    L_TILE,
    group_pairs_by_partition,
    grouped_scores_pallas,
)
from scann_tpu.types import MASKED_DISTANCE


def test_grouping_invariants(rng):
    b, p, t, q_cap = 16, 5, 12, 4
    parts = rng.integers(0, t, size=(b, p)).astype(np.int32)
    grp_part, slot, ng = group_pairs_by_partition(jnp.asarray(parts), t, q_cap)
    grp_part, slot = np.asarray(grp_part), np.asarray(slot)
    bp = b * p
    assert ng >= len(set(grp_part.tolist()))
    # every pair has a distinct slot
    assert len(set(slot.tolist())) == bp
    # a slot's group holds the pair's own partition
    flat = parts.reshape(-1)
    for i in range(bp):
        g, r = divmod(int(slot[i]), q_cap)
        assert grp_part[g] == flat[i], (i, g)
        assert r < q_cap
    # group occupancy: at most one partially-filled group per partition
    from collections import Counter

    occ = Counter(slot // q_cap)
    by_part = Counter(flat.tolist())
    for part_id, count in by_part.items():
        groups = [g for g in occ if grp_part[g] == part_id and occ[g]]
        assert len(groups) == -(-count // q_cap)


def _naive_scores(luts, codes, offsets, sizes, slot, q_cap, l_cap):
    """Score every pair against its partition's codes via direct lookup
    (codes [N_csr, S] row-major, luts [B*p, S*16])."""
    bp = luts.shape[0]
    s = codes.shape[1]
    out = np.full((bp, l_cap), MASKED_DISTANCE, np.float32)
    for i in range(bp):
        g = slot[i] // q_cap
        off, size = offsets[g], sizes[g]
        for l in range(min(size, l_cap)):
            out[i, l] = sum(luts[i, ss * 16 + int(codes[off + l, ss])]
                            for ss in range(s))
    return out


def _grouped_case(rng, q_cap, s, b=6, p=3, t=5, c=16):
    """Random CSR slab + pairs, grouped as leaf_scores_grouped does."""
    from scann_tpu.models.tree_x_hybrid import code_slab

    l_cap = 2 * L_TILE
    sizes_np = rng.integers(1, l_cap + 1, size=t).astype(np.int32)
    sizes_np[0] = 0                       # an empty partition
    aligned = np.zeros(t + 1, np.int64)
    aligned[1:] = np.cumsum(((sizes_np + 127) // 128) * 128)
    n_csr = int(aligned[-1]) + l_cap
    codes = rng.integers(0, c, size=(n_csr, s)).astype(np.uint8)
    parts = rng.integers(0, t, size=(b, p)).astype(np.int32)
    s_pad = s + s % 2
    luts = rng.normal(size=(b * p, s_pad, c)).astype(np.float32)
    luts[:, s:] = 0.0                     # pad subspace: zero LUT row
    luts = jnp.asarray(luts.reshape(b * p, -1)).astype(jnp.bfloat16)

    grp_part, slot, ng = group_pairs_by_partition(jnp.asarray(parts), t, q_cap)
    grp_safe = jnp.maximum(grp_part, 0)
    grp_off = jnp.take(jnp.asarray(aligned[:-1].astype(np.int32)), grp_safe)
    grp_size = jnp.where(grp_part >= 0,
                         jnp.take(jnp.asarray(sizes_np), grp_safe), 0)
    pair_of_slot = jnp.zeros((ng * q_cap,), jnp.int32).at[slot].set(
        jnp.arange(b * p, dtype=jnp.int32))
    luts3 = jnp.take(luts, pair_of_slot, axis=0).reshape(ng, q_cap, -1)
    slab = code_slab(codes, "grouped", c)
    unpacked = np.ascontiguousarray(code_slab(codes, "pairs", c).T)
    return dict(codes=codes, slab=slab, unpacked=unpacked, luts=luts,
                luts3=luts3, grp_off=grp_off, grp_size=grp_size, slot=slot,
                l_cap=l_cap)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("q_cap", [8, 16])
def test_kernel_matches_naive(rng, q_cap, packed):
    """Kernel scores vs the f32 gather-sum of the same bf16 LUTs, within
    bf16 output rounding (rtol 2^-7); masked exactly beyond each size."""
    case = _grouped_case(rng, q_cap, s=8)
    slab = case["slab"] if packed else case["unpacked"]
    assert slab.shape[0] == (4 if packed else 8)
    scores = grouped_scores_pallas(
        case["luts3"], jnp.asarray(slab), case["grp_off"], case["grp_size"],
        l_cap=case["l_cap"], packed=packed, interpret=True)
    assert scores.shape == (case["luts3"].shape[0], q_cap, case["l_cap"])
    got = np.asarray(jnp.take(scores.reshape(-1, case["l_cap"]),
                              case["slot"], axis=0)).astype(np.float32)
    want = _naive_scores(np.asarray(case["luts"].astype(jnp.float32)),
                         case["codes"], np.asarray(case["grp_off"]),
                         np.asarray(case["grp_size"]),
                         np.asarray(case["slot"]), q_cap, case["l_cap"])
    mask = want < MASKED_DISTANCE / 2
    assert np.array_equal(mask, got < MASKED_DISTANCE / 2)
    np.testing.assert_allclose(got[mask], want[mask], rtol=2 ** -7,
                               atol=1e-2)


@pytest.mark.parametrize("s_logical", [7, 8, 25])
def test_kernel_packed_matches_unpacked(rng, s_logical):
    """Packed-nibble slab ([S/2] bytes, low-nibble-first, the reference
    layout lut16.rs:43-61) scores identically to the unpacked u8 slab,
    odd subspace counts included (code_slab pads S to even)."""
    case = _grouped_case(rng, 16, s=s_logical)
    kw = dict(l_cap=case["l_cap"], interpret=True)
    want = np.asarray(grouped_scores_pallas(
        case["luts3"], jnp.asarray(case["unpacked"]), case["grp_off"],
        case["grp_size"], **kw)).astype(np.float32)
    got = np.asarray(grouped_scores_pallas(
        case["luts3"], jnp.asarray(case["slab"]), case["grp_off"],
        case["grp_size"], packed=True, **kw)).astype(np.float32)
    mask = want < MASKED_DISTANCE / 2
    assert np.array_equal(mask, got < MASKED_DISTANCE / 2)
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("num_codes", [8, 16, 32])
def test_leaf_scores_grouped_matches_pairs(rng, num_codes):
    """The grouped kernel wrapper (interpret) vs the per-pair gather path
    the CPU serves on a built index: same leaf-major candidate order and
    CSR rows, scores equal within bf16 output rounding. num_codes 8 pads
    the LUT to 16 columns; 32 serves an unpacked slab."""
    import jax

    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models import tree_x_hybrid as tx

    db = rng.normal(size=(900, 15)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(12, 15)).astype(np.float32))
    s = tx.TreeXHybridSearcher(tx.TreeXHybridConfig(
        num_partitions=8, partitions_to_search=3,
        hash_config=AsymmetricHasherConfig(
            num_codes=num_codes, num_subspaces=5, seed=0, max_iterations=4),
    )).build(DenseDataset(db))
    rows, offs, sizes, perm, l_cap = s._csr_state()      # "pairs" slab
    assert s._leaf_scorer() == "pairs"                     # CPU platform
    s._leaf_scorer = lambda: "grouped"
    s._csr_cache = None
    slab = s._csr_state()[0]
    assert slab.shape[0] == (3 if num_codes <= 16 else 6)
    cent = s.partitioner.centers_device()
    cb = s.codebook.centroids_device()
    parts = tx._select_partitions(cent, q, p=3, approx_min=10 ** 9)
    luts = tx._residual_luts(q, cent, parts, cb, s_pad=6, use_residuals=True)
    got, rows_g = tx.leaf_scores_grouped(luts, parts, slab, offs, sizes, p=3,
                                         l_cap=l_cap, c=num_codes,
                                         interpret=True)
    lb = luts.astype(jnp.bfloat16).astype(jnp.float32)
    want, rows_x = jax.jit(functools.partial(
        tx.leaf_scores_xla, p=3, l_cap=l_cap, c=num_codes))(
            lb, parts, rows, offs, sizes)
    np.testing.assert_array_equal(np.asarray(rows_g), np.asarray(rows_x))
    got = np.asarray(got.astype(jnp.float32))
    want = np.asarray(want)
    mask = want < MASKED_DISTANCE / 2
    assert np.array_equal(mask, got < MASKED_DISTANCE / 2)
    np.testing.assert_allclose(got[mask], want[mask], rtol=2 ** -7,
                               atol=1e-2)
