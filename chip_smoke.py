#!/usr/bin/env python3
"""Chip smoke test: the ANN engine's main path, compiled on an NVIDIA GPU.

    python chip_smoke.py               # one card, phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One process drives the card. Data is seeded clustered 1.18M x 100d (GloVe-100
scale) with 5000 clusters and B = 1024 queries from the same clusters, k = 10.
Every phase prints one JSON line: sizes, recall@10 against the plain
reference, compile seconds, one warm batch time (``warm_batch_ms``: one
call, not a benchmark), ``peak_bytes_in_use`` and the kernel that served.
Any failed phase or threshold raises, so the process exits non-zero; the
last line is the JSON result only when every phase passed.

Phases (one card):
  1. reference: blocked f32 HIGHEST matrix product + lax.top_k, itself
     spot-checked against float64 numpy on 32 queries;
  2. BruteForceSearcher: exact distances (1e-4 relative), recall 1 up to ties;
  3. BlockSweepSearcher: r=64, pre_k=64, recall >= 0.99; a 25% allow mask
     (no denied id, recall vs the masked reference >= 0.99); top2 and the
     int8 sweep copy; the sweep kernel against its plain formulation;
  4. TreeXHybridSearcher: 2000 partitions, 16 codes x 50 subspaces,
     (p, pre_k) = (20, 200) recall >= 0.99, (10, 150) reported; a SOAR
     build on adversarial 200k x 100d data (p=30, pre_k=300); the grouped
     leaf-scoring kernel against the per-pair gather-sum;
  5. Scann.auto() on the 1.18M data, and the ann_benchmark harness run
     in-process on 200k synthetic data for tree-ah;
  6. paths served by plain XLA at 200k x 100d: the LUT16 AsymmetricHasher
     with reorder, the int8 ScalarQuantizedBruteForceSearcher, and a
     DynamicSearcher add/delete/search; whether the native host library
     built.

Four cards: ShardedBlockSweepSearcher, ShardedTreeXHybridSearcher and
sharded_tree_ah_build at 4.72M x 100d on a ("db",) mesh over
jax.devices()[:4], each with recall@10 >= 0.99 against the reference and
its id overlap with the single-device searcher on the same data.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 10


class SmokeFailure(Exception):
    """A phase missed its threshold."""


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@dataclasses.dataclass
class Sizes:
    """Real sizes by default; the tests shrink them to run on the CPU."""

    n: int = 1_180_000
    dim: int = 100
    clusters: int = 5000
    batch: int = 1024
    partitions: int = 2000
    subspaces: int = 50
    small_n: int = 200_000          # adversarial / harness / XLA-path data
    small_partitions: int = 400
    f64_queries: int = 32


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def timed(fn):
    """(result, compile_s, warm_batch_ms): the first call's excess over one
    warm call counts as compilation."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    t1 = time.perf_counter()
    fn()
    warm = time.perf_counter() - t1
    return out, max(first - warm, 0.0), warm * 1e3


def recall_at_k(idx, gt) -> float:
    return float(np.mean([len(set(a[:K].tolist()) & set(g[:K].tolist())) / K
                          for a, g in zip(np.asarray(idx), np.asarray(gt))]))


def clustered(seed: int, n: int, d: int, n_clusters: int, b: int,
              spread: float = 2.5):
    """Seeded clustered data + queries from the same clusters (on device)."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    centers = jax.random.normal(k1, (n_clusters, d)) * spread
    a = jax.random.randint(k2, (n,), 0, n_clusters)
    db = jnp.take(centers, a, axis=0) + jax.random.normal(k3, (n, d))
    aq = jax.random.randint(k4, (b,), 0, n_clusters)
    q = jnp.take(centers, aq, axis=0) + jax.random.normal(k5, (b, d))
    return np.asarray(db), np.asarray(q)


def exact_topk(db: np.ndarray, q: np.ndarray, k: int = K, mask=None,
               chunk: int = 131072):
    """The plain reference, independent of the searchers: a blocked f32
    ``jnp.dot(precision=HIGHEST)`` + ``lax.top_k`` over squared L2.
    Returns (dists [B, k], ids [B, k]) sorted ascending."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def block(qq, x, m, off):
        d = (jnp.sum(qq * qq, 1)[:, None] + jnp.sum(x * x, 1)[None, :]
             - 2.0 * jnp.dot(qq, x.T, precision=jax.lax.Precision.HIGHEST))
        d = jnp.where(m[None, :], d, jnp.inf)
        v, i = jax.lax.top_k(-d, min(k, x.shape[0]))
        return -v, i + off

    qd = jnp.asarray(q)
    vals, ids = [], []
    for lo in range(0, len(db), chunk):
        x = db[lo:lo + chunk]
        m = (np.ones(len(x), bool) if mask is None
             else np.asarray(mask[lo:lo + chunk]))
        v, i = block(qd, jnp.asarray(x), jnp.asarray(m), lo)
        vals.append(v)
        ids.append(i)
    v = jnp.concatenate(vals, 1)
    i = jnp.concatenate(ids, 1)
    order = jnp.argsort(v, axis=1)[:, :k]
    return (np.asarray(jnp.take_along_axis(v, order, 1)),
            np.asarray(jnp.take_along_axis(i, order, 1)))


def env_line() -> dict:
    import jax

    import scann_tpu

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or scann_tpu.compile_cache_dir())
    return dict(phase="env", nvidia_smi=smi, jax=jax.__version__,
                device_kind=jax.devices()[0].device_kind,
                device_count=len(jax.devices()),
                xla_flags=os.environ.get("XLA_FLAGS", ""),
                compile_cache_dir=cache)


# -- phase 1 ------------------------------------------------------------------

def phase_reference(db, q, sz: Sizes) -> dict:
    t0 = time.perf_counter()
    gt_d, gt_i = exact_topk(db, q)
    ref_s = time.perf_counter() - t0
    # float64 numpy spot check of the reference itself
    nq = min(sz.f64_queries, len(q))
    q64 = q[:nq].astype(np.float64)
    db64 = db.astype(np.float64)
    d64 = ((q64 * q64).sum(1)[:, None] + (db64 * db64).sum(1)[None, :]
           - 2.0 * q64 @ db64.T)
    i64 = np.argsort(d64, axis=1, kind="stable")[:, :K]
    dk64 = np.take_along_axis(d64, i64, 1)
    rel = float(np.max(np.abs(gt_d[:nq] - dk64)
                       / np.maximum(np.abs(dk64), 1.0)))
    # id differences only where float64 itself ties within tolerance
    tie_tol = 1e-4 * np.maximum(np.abs(dk64[:, -1]), 1.0)
    bad = 0
    for r in range(nq):
        for i in set(gt_i[r].tolist()) ^ set(i64[r].tolist()):
            if abs(d64[r, i] - dk64[r, -1]) > tie_tol[r]:
                bad += 1
    require(rel <= 1e-5, f"reference vs float64: max rel {rel}")
    require(bad == 0, f"reference ids differ from float64 beyond ties: {bad}")
    out = dict(phase="reference", n=len(db), dim=db.shape[1], batch=len(q),
               k=K, seconds=ref_s, f64_queries=nq, f64_max_rel=rel,
               peak_bytes_in_use=peak_bytes(),
               kernel="jnp.dot HIGHEST + lax.top_k")
    emit(**out)
    return dict(gt_d=gt_d, gt_i=gt_i)


# -- phase 2 ------------------------------------------------------------------

def phase_brute_force(db, q, ref) -> None:
    from scann_tpu import BruteForceSearcher, DenseDataset

    s = BruteForceSearcher(DenseDataset(db))
    (idx, dist), comp, warm = timed(lambda: s.search_batched_arrays(q, K))
    gt_d, gt_i = ref["gt_d"], ref["gt_i"]
    rel = float(np.max(np.abs(dist - gt_d) / np.maximum(np.abs(gt_d), 1.0)))
    tol = 1e-4 * np.maximum(np.abs(gt_d[:, -1:]), 1.0)
    # an id may differ from the reference only where its distance ties the
    # k-th reference distance
    ok_ids = (idx == gt_i) | (np.abs(dist - gt_d[:, -1:]) <= tol)
    rec = recall_at_k(idx, gt_i)
    require(rel <= 1e-4, f"brute force distances: max rel {rel}")
    require(bool(ok_ids.all()), "brute force ids differ beyond ties")
    emit(phase="brute_force", n=len(db), batch=len(q), recall_at_10=rec,
         max_rel_dist=rel, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes(), kernel="xla matmul + lax.top_k")


# -- phase 3 ------------------------------------------------------------------

def sweep_parity(aug, q_aug, r: int, interpret: bool = False) -> dict:
    """Sweep kernel vs its plain formulation at the searcher's own widths:
    values within 1e-3 of the batch's score scale; argmins equal wherever a
    block's two smallest differ by more than that."""
    import jax.numpy as jnp

    from scann_tpu.ops.sweep_pallas import (
        BLOCK_MASK_VALUE,
        block_minima_pallas,
        block_minima_xla,
    )

    vk, lk = (np.asarray(a) for a in block_minima_pallas(
        q_aug, aug, r=r, interpret=interpret))
    vx, lx = (np.asarray(a) for a in block_minima_xla(q_aug, aug, r=r))
    valid = vx < BLOCK_MASK_VALUE / 2
    scale = float(np.max(np.abs(vx[valid])))
    max_rel = float(np.max(np.abs(vk - vx)[valid]) / scale)
    nq = min(64, q_aug.shape[0])
    s3 = np.asarray(jnp.dot(q_aug[:nq].astype(jnp.float32),
                            aug.astype(jnp.float32).T)).reshape(nq, -1, r)
    two = np.sort(s3, axis=2)[..., :2]
    separated = (two[..., 1] - two[..., 0]) > 1e-3 * scale
    diff_sep = int(np.sum((lk[:nq] != lx[:nq]) & separated))
    frac_diff = float(np.mean(lk != lx))
    require(max_rel <= 1e-3, f"sweep kernel minima: max rel {max_rel}")
    require(diff_sep == 0, f"sweep kernel argmins differ on {diff_sep} "
                           f"separated blocks")
    return dict(minima_max_rel=max_rel, argmin_frac_differ=frac_diff)


def phase_block_sweep(db, q, ref, seed: int, interpret: bool = False) -> None:
    import jax.numpy as jnp

    from scann_tpu import BlockSweepConfig, BlockSweepSearcher, DenseDataset
    from scann_tpu.ops.sweep_pallas import _augment_queries

    from scann_tpu.types import use_gpu_kernels

    ds = DenseDataset(db)
    kernel = ("block_min_sweep (pallas triton)" if use_gpu_kernels()
              else "block_minima_xla")
    cfg = dict(block_r=64, pre_reorder_k=64)
    s = BlockSweepSearcher(ds, BlockSweepConfig(**cfg))
    (idx, _), comp, warm = timed(lambda: s.search_batched_arrays(q, K))
    rec = recall_at_k(idx, ref["gt_i"])
    require(rec >= 0.99, f"sweep recall {rec}")
    emit(phase="block_sweep", n=len(db), batch=len(q), r=64, pre_k=64,
         recall_at_10=rec, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes(), kernel=kernel)

    mask = np.random.default_rng(seed).random(len(db)) < 0.25
    _, mgt = exact_topk(db, q, mask=mask)
    (idx, _), comp, warm = timed(
        lambda: s.search_batched_arrays(q, K, allow_mask=mask))
    live = idx[idx >= 0]
    rec = recall_at_k(idx, mgt)
    require(bool(mask[live].all()), "sweep returned a denied id")
    require(rec >= 0.99, f"masked sweep recall {rec}")
    emit(phase="block_sweep_allow_mask", allowed_fraction=float(mask.mean()),
         recall_at_10=rec, denied_returned=0, compile_s=comp,
         warm_batch_ms=warm, peak_bytes_in_use=peak_bytes(), kernel=kernel)

    aug, _, _, _ = s._device_state()
    q_aug = _augment_queries(jnp.asarray(q), s._measure, aug.shape[1])
    par = sweep_parity(aug, q_aug, 64, interpret=interpret)
    emit(phase="block_sweep_parity", rows=int(aug.shape[0]),
         row_width=int(aug.shape[1]), batch=len(q), r=64, **par,
         kernel="block_min_sweep vs block_minima_xla")
    del s, aug

    for name, extra in (("block_sweep_top2", dict(top2=True)),
                        ("block_sweep_int8", dict(sweep_dtype="int8"))):
        s = BlockSweepSearcher(ds, BlockSweepConfig(**cfg, **extra))
        (idx, _), comp, warm = timed(lambda: s.search_batched_arrays(q, K))
        rec = recall_at_k(idx, ref["gt_i"])
        require(rec >= 0.99, f"{name} recall {rec}")
        emit(phase=name, recall_at_10=rec, compile_s=comp,
             warm_batch_ms=warm, peak_bytes_in_use=peak_bytes(),
             kernel=kernel)
        del s


# -- phase 4 ------------------------------------------------------------------

def tree_config(partitions: int, subspaces: int, **kw):
    from scann_tpu import TreeXHybridConfig
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig

    return TreeXHybridConfig(
        num_partitions=partitions, partitions_to_search=20,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=subspaces, seed=42,
            max_iterations=12, training_sample_size=100_000), **kw)


def grouped_parity(tree, q, p: int, interpret: bool = False) -> dict:
    """Grouped kernel vs the f32 gather-sum of the same bf16-cast LUTs
    (leaf_scores_xla), within bf16 output rounding (rtol 2^-7)."""
    import jax
    import jax.numpy as jnp

    from scann_tpu.models import tree_x_hybrid as tx
    from scann_tpu.types import MASKED_DISTANCE

    slab, offs, sizes, _, l_cap = tree._csr_state()
    slab_np = np.asarray(slab)
    s = tree.codebook.centroids.shape[0]
    s_pad = s + s % 2
    if tree._leaf_scorer() == "grouped":
        if 2 * slab_np.shape[0] == s_pad:      # packed: unpack to rows
            rows = np.empty((slab_np.shape[1], s_pad), np.uint8)
            rows[:, 0::2] = (slab_np & 0xF).T
            rows[:, 1::2] = (slab_np >> 4).T
        else:
            rows = np.ascontiguousarray(slab_np.T)
        grouped_slab = slab
    else:
        rows = slab_np
        grouped_slab = jnp.asarray(tx.code_slab(
            slab_np, "grouped", tree.config.hash_config.num_codes))
    qd = jnp.asarray(q)
    cent = tree.partitioner.centers_device()
    parts = tx._select_partitions(cent, qd, p=p, approx_min=1024)
    luts = tx._residual_luts(qd, cent, parts, tree.codebook.centroids_device(),
                             s_pad=s_pad, use_residuals=True)
    c = tree.codebook.centroids.shape[1]
    got, _ = jax.jit(lambda *a: tx.leaf_scores_grouped(
        *a, p=p, l_cap=l_cap, c=c, interpret=interpret))(
            luts, parts, grouped_slab, offs, sizes)
    want, _ = jax.jit(lambda *a: tx.leaf_scores_xla(
        *a, p=p, l_cap=l_cap, c=c))(
            luts.astype(jnp.bfloat16).astype(jnp.float32), parts,
            jnp.asarray(rows), offs, sizes)
    got = np.asarray(got.astype(jnp.float32))
    want = np.asarray(want)
    valid = want < MASKED_DISTANCE / 2
    err = np.abs(got - want)[valid]
    bound = 2.0 ** -7 * np.abs(want[valid]) + 1e-3
    require(bool(np.array_equal(valid, got < MASKED_DISTANCE / 2)),
            "grouped kernel masks differ from the gather path")
    require(bool(np.all(err <= bound)),
            f"grouped kernel scores: {int(np.sum(err > bound))} beyond "
            f"rtol 2^-7")
    return dict(scores_checked=int(valid.sum()),
                max_rel=float(np.max(err / np.maximum(np.abs(want[valid]),
                                                      1e-3))))


def phase_tree(db, q, ref, sz: Sizes, seed: int,
               interpret: bool = False) -> None:
    from scann_tpu import DenseDataset, TreeXHybridSearcher
    from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset
    from scann_tpu.models.searcher import SearchParameters

    t0 = time.perf_counter()
    tree = TreeXHybridSearcher(tree_config(
        sz.partitions, sz.subspaces)).build(DenseDataset(db))
    build_s = time.perf_counter() - t0
    kernel = {"grouped": "tree_ah_grouped (pallas triton)",
              "pairs": "xla gather"}[tree._leaf_scorer()]
    for (p, pre_k), floor in (((20, 200), 0.99), ((10, 150), None)):
        params = SearchParameters(num_leaves_to_search=p,
                                  pre_reordering_num_neighbors=pre_k)
        (idx, _), comp, warm = timed(
            lambda: tree.search_batched_arrays(q, K, params))
        rec = recall_at_k(idx, ref["gt_i"])
        if floor is not None:
            require(rec >= floor, f"tree (p={p}, pre_k={pre_k}) recall {rec}")
        emit(phase="tree_ah", n=len(db), partitions=sz.partitions,
             codes=16, subspaces=sz.subspaces, p=p, pre_k=pre_k,
             recall_at_10=rec, build_s=build_s, compile_s=comp,
             warm_batch_ms=warm, peak_bytes_in_use=peak_bytes(),
             kernel=kernel)
    par = grouped_parity(tree, q, 20, interpret=interpret)
    emit(phase="tree_ah_parity", p=20, batch=len(q), **par,
         kernel="tree_ah_grouped vs leaf_scores_xla")
    del tree

    adv = generate_adversarial_dataset(sz.small_n, len(q), sz.dim, K,
                                       seed=seed)
    t0 = time.perf_counter()
    soar = TreeXHybridSearcher(tree_config(
        sz.small_partitions, sz.subspaces, spilling=True,
        spilling_mode="soar")).build(DenseDataset(adv.train))
    build_s = time.perf_counter() - t0
    mult = soar.partitioner.tokenization.max_multiplicity
    params = SearchParameters(num_leaves_to_search=30,
                              pre_reordering_num_neighbors=300)
    (idx, _), comp, warm = timed(
        lambda: soar.search_batched_arrays(adv.test, K, params))
    rec = recall_at_k(idx, adv.gt)
    dup_rows = int(sum(len(set(r[r >= 0].tolist())) != int(np.sum(r >= 0))
                       for r in idx))
    require(mult > 1, "SOAR build has no spilled assignments")
    require(dup_rows == 0, f"{dup_rows} result rows repeat an id")
    require(rec >= 0.95, f"SOAR adversarial recall {rec}")
    emit(phase="tree_ah_soar_adversarial", n=sz.small_n,
         partitions=sz.small_partitions, multiplicity=mult, p=30, pre_k=300,
         recall_at_10=rec, duplicate_rows=dup_rows, build_s=build_s,
         compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes(), kernel=kernel)


# -- phase 5 ------------------------------------------------------------------

def phase_auto_and_harness(db, q, ref, sz: Sizes, seed: int) -> None:
    from scann_tpu import DenseDataset, Scann
    from scann_tpu.harness import ann_benchmark as hb

    t0 = time.perf_counter()
    s = Scann.auto(DenseDataset(db))
    build_s = time.perf_counter() - t0
    (idx, _), comp, warm = timed(lambda: s.search_batched_arrays(q, K))
    rec = recall_at_k(idx, ref["gt_i"])
    require(rec >= 0.99, f"Scann.auto recall {rec}")
    emit(phase="scann_auto", n=len(db), mode=s.search_mode.value,
         recall_at_10=rec, build_s=build_s, compile_s=comp,
         warm_batch_ms=warm, peak_bytes_in_use=peak_bytes())
    del s

    args = hb.make_parser().parse_args([
        "--algorithm", "tree-ah", "--clustered",
        "--synthetic-train", str(sz.small_n),
        "--synthetic-test", str(len(q)), "--dim", str(sz.dim),
        "--seed", str(seed), "--num-partitions", str(sz.small_partitions),
        "--partitions-to-search", "20", "--num-blocks", str(sz.subspaces),
        "--num-buckets", "16", "--reorder", "200",
        "--batch-size", str(len(q))])
    data = hb.generate_synthetic_dataset(
        args.synthetic_train, args.synthetic_test, args.dim, args.k,
        args.seed, clustered=True)
    report = hb.run_benchmark(args.algorithm, data, args)
    require(report.recall_at_k >= 0.9,
            f"harness tree-ah recall {report.recall_at_k}")
    emit(phase="harness_tree_ah", report=json.loads(report.to_json()),
         peak_bytes_in_use=peak_bytes())


# -- phase 6 ------------------------------------------------------------------

def phase_xla_paths(db, q, sz: Sizes) -> None:
    from scann_tpu import (
        BruteForceSearcher,
        DenseDataset,
        ScalarQuantizedBruteForceSearcher,
        ScalarQuantizedConfig,
    )
    from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.mutator import DynamicSearcher
    from scann_tpu.native import load_native

    db = db[:sz.small_n]
    ds = DenseDataset(db)
    _, gt = exact_topk(db, q)

    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=sz.subspaces, seed=42, max_iterations=12,
        training_sample_size=100_000)).build(ds)
    params = SearchParameters(pre_reordering_num_neighbors=200)
    (idx, _), comp, warm = timed(
        lambda: h.search_batched_arrays(q, K, params))
    rec = recall_at_k(idx, gt)
    require(rec >= 0.9, f"AsymmetricHasher recall {rec}")
    emit(phase="xla_lut16_hasher_reorder", n=len(db), pre_k=200,
         recall_at_10=rec, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes(), kernel="xla one-hot lut_score")
    del h

    sq = ScalarQuantizedBruteForceSearcher(
        ds, ScalarQuantizedConfig(storage="int8"))
    (idx, _), comp, warm = timed(lambda: sq.search_batched_arrays(q, K))
    rec = recall_at_k(idx, gt)
    require(rec >= 0.9, f"int8 scalar-quantized recall {rec}")
    emit(phase="xla_int8_scalar_quantized", n=len(db), recall_at_10=rec,
         compile_s=comp, warm_batch_ms=warm, peak_bytes_in_use=peak_bytes(),
         kernel="xla dequant dot_general")
    del sq

    dyn = DynamicSearcher(ds, lambda d: BruteForceSearcher(d),
                          rebuild_threshold=10 ** 9)
    rng = np.random.default_rng(0)
    n_mut = min(256, len(q))
    added = [dyn.add(q[i] + 1e-3 * rng.standard_normal(q.shape[1]).astype(
        np.float32)) for i in range(n_mut)]
    removed = rng.choice(len(db), n_mut, replace=False)
    removed = removed[~np.isin(removed, gt[:n_mut, 0])]
    for i in removed:
        dyn.remove(int(i))
    (idx, _), comp, warm = timed(lambda: dyn.search_batched_arrays(q, K))
    found = float(np.mean([added[i] in idx[i].tolist()
                           for i in range(n_mut)]))
    require(found == 1.0, f"added points found for {found} of their queries")
    require(not np.isin(idx, removed).any(), "a deleted id was returned")
    emit(phase="xla_dynamic_searcher", n=len(db), added=n_mut,
         removed=int(len(removed)), added_found_fraction=found,
         deleted_returned=0, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes(), kernel="xla brute force + delta")
    emit(phase="native_host_library", built=load_native() is not None)


# -- four cards ----------------------------------------------------------------

def phase_four_cards(seed: int, sz: Sizes) -> None:
    import jax

    from scann_tpu import (
        BlockSweepConfig,
        BlockSweepSearcher,
        DenseDataset,
        TreeXHybridSearcher,
    )
    from scann_tpu.models.searcher import SearchParameters
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
        sharded_tree_ah_build,
    )

    require(len(jax.devices()) >= 4, f"--four-cards needs 4 devices, found "
                                     f"{len(jax.devices())}")
    mesh = make_mesh(4, axis_names=("db",))
    n = 4 * sz.n
    db, q = clustered(seed, n, sz.dim, 4 * sz.clusters, sz.batch)
    _, gt = exact_topk(db, q)
    ds = DenseDataset(db)
    emit(phase="four_cards_reference", n=n, dim=sz.dim, batch=len(q),
         mesh=str(mesh.devices.tolist()), peak_bytes_in_use=peak_bytes())

    def overlap(a, b):
        return recall_at_k(a, b)

    def devices_of(arr):
        return sorted({str(s.device) for s in arr.addressable_shards})

    single = BlockSweepSearcher(ds, BlockSweepConfig(block_r=64,
                                                     pre_reorder_k=64))
    i_single, _ = single.search_batched_arrays(q, K)
    sh = ShardedBlockSweepSearcher(single, mesh)
    (idx, _), comp, warm = timed(lambda: sh.search_batched_arrays(q, K))
    rec = recall_at_k(idx, gt)
    devs = devices_of(sh._aug)
    require(len(devs) == 4, f"sweep shards on {devs}")
    require(rec >= 0.99, f"sharded sweep recall {rec}")
    emit(phase="sharded_block_sweep", n=n, shards_on=devs,
         recall_at_10=rec, overlap_with_single_device=overlap(idx, i_single),
         single_device_recall=recall_at_k(i_single, gt), compile_s=comp,
         warm_batch_ms=warm, peak_bytes_in_use=peak_bytes())
    del sh, single

    params = SearchParameters(num_leaves_to_search=20,
                              pre_reordering_num_neighbors=200)
    cfg = tree_config(4 * sz.partitions, sz.subspaces)
    t0 = time.perf_counter()
    tree = TreeXHybridSearcher(cfg).build(ds)
    build_single = time.perf_counter() - t0
    i_single, _ = tree.search_batched_arrays(q, K, params)
    sh = ShardedTreeXHybridSearcher(tree, mesh)
    (idx, _), comp, warm = timed(
        lambda: sh.search_batched_arrays(q, K, params))
    rec = recall_at_k(idx, gt)
    devs = devices_of(sh._codes)
    require(len(devs) == 4, f"tree shards on {devs}")
    require(rec >= 0.99, f"sharded tree recall {rec}")
    emit(phase="sharded_tree_ah", n=n, partitions=4 * sz.partitions,
         shards_on=devs, recall_at_10=rec,
         overlap_with_single_device=overlap(idx, i_single),
         single_device_recall=recall_at_k(i_single, gt),
         single_build_s=build_single, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes())
    del sh, tree

    t0 = time.perf_counter()
    built = sharded_tree_ah_build(ds, cfg, mesh)
    build_s = time.perf_counter() - t0
    (idx, _), comp, warm = timed(
        lambda: built.search_batched_arrays(q, K, params))
    rec = recall_at_k(idx, gt)
    devs = devices_of(built._codes)
    require(len(devs) == 4, f"sharded-build shards on {devs}")
    require(rec >= 0.99, f"sharded_tree_ah_build recall {rec}")
    emit(phase="sharded_tree_ah_build", n=n, shards_on=devs,
         recall_at_10=rec, overlap_with_single_device=overlap(idx, i_single),
         build_s=build_s, compile_s=comp, warm_batch_ms=warm,
         peak_bytes_in_use=peak_bytes())


def run_one_card(seed: int, sz: Sizes, interpret: bool = False) -> None:
    db, q = clustered(seed, sz.n, sz.dim, sz.clusters, sz.batch)
    ref = phase_reference(db, q, sz)
    phase_brute_force(db, q, ref)
    phase_block_sweep(db, q, ref, seed, interpret=interpret)
    phase_tree(db, q, ref, sz, seed, interpret=interpret)
    phase_auto_and_harness(db, q, ref, sz, seed)
    phase_xla_paths(db, q, sz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-card mesh")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import jax

    plat = jax.devices()[0].platform
    if plat != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {plat!r})",
              file=sys.stderr)
        return 2
    env = env_line()
    emit(**env)
    print(env["nvidia_smi"], flush=True)
    sz = Sizes()
    if args.four_cards:
        phase_four_cards(args.seed, sz)
    else:
        run_one_card(args.seed, sz)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
