"""ANN-Benchmarks-style evaluation harness.

Mirror of the reference's ``ann_benchmark`` binary
(reference: src/bin/ann_benchmark.rs:119-227): loads an ANN-Benchmarks JSON
dataset (``{"train": [[..]], "test": [[..]], "neighbors": [[..]]}``) or
generates a seeded synthetic one with exactly-computed ground truth, builds
the configured index, times the search phase, and emits a JSON report with
build seconds, search seconds, QPS, recall@k and memory.

Departures from the reference:
  - queries run in batches (the production serving shape); ``--batch-size``
    controls it. The reference loops per query over rayon threads.
  - memory is reported as host RSS delta plus device index bytes.

Run: ``python -m scann_tpu.harness.ann_benchmark --algorithm tree-ah ...``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class BenchmarkData:
    train: np.ndarray   # [N, D] f32
    test: np.ndarray    # [Q, D] f32
    gt: np.ndarray      # [Q, k] int32
    source: str
    dimension: int


@dataclasses.dataclass
class BenchmarkReport:
    """(reference: ann_benchmark.rs:119-133)."""

    dataset: str
    algorithm: str
    distance: str
    k: int
    train_size: int
    test_size: int
    dimension: int
    build_seconds: float
    search_seconds: float
    qps: float
    recall_at_k: float
    index_rss_delta_bytes: Optional[int] = None
    index_device_bytes: Optional[int] = None
    batch_size: Optional[int] = None
    # Wall-clock QPS includes one host->device dispatch round-trip per batch;
    # at small batches that round-trip (not the kernel) can dominate. These
    # fields let a reader of the artifact tell dispatch-bound from
    # kernel-bound numbers.
    timing_mode: str = "wall_clock_per_batch_dispatch"
    host_roundtrip_seconds: Optional[float] = None
    dispatch_bound_fraction: Optional[float] = None
    # --autotune-target provenance: which SearchParameters served the run
    # and how the tuning sample scored (None when tuning was not requested)
    autotune_target: Optional[float] = None
    autotune_target_met: Optional[bool] = None
    autotune_sample_recall: Optional[float] = None
    autotune_seconds: Optional[float] = None
    autotuned_num_leaves_to_search: Optional[int] = None
    autotuned_pre_reordering_num_neighbors: Optional[int] = None
    # --shards N: served through the database-sharded wrappers on an
    # N-device mesh (None/1 = single device)
    shards: Optional[int] = None
    # --save-index / --load-index provenance (build-once / serve-many):
    # when loaded, build_seconds is the load time, not a training run
    index_loaded_from: Optional[str] = None
    index_saved_to: Optional[str] = None
    index_save_seconds: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def current_rss_bytes() -> Optional[int]:
    """(reference: ann_benchmark.rs:473-479 reads /proc/self/statm)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return None


def measure_host_roundtrip_seconds(rounds: int = 7) -> float:
    """Median wall-clock of one trivial jitted dispatch + result fetch —
    the per-batch overhead floor every wall-clock QPS row pays."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    float(f(x)[0])  # compile
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(f(x)[0])
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _measure_for(name: str):
    from scann_tpu.ops.distances import DistanceMeasure

    return {"squared-l2": DistanceMeasure.SQUARED_L2,
            "l2": DistanceMeasure.L2,
            "cosine": DistanceMeasure.COSINE,
            "dot-product": DistanceMeasure.DOT_PRODUCT}[name]


def exact_ground_truth(train: np.ndarray, queries: np.ndarray, k: int,
                       batch: int = 256,
                       distance: str = "squared-l2") -> np.ndarray:
    """Exact GT via the brute-force searcher under the *benchmarked*
    distance measure (reference: ann_benchmark.rs:427-450 computes it scalar
    on host)."""
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.models.brute_force import BruteForceSearcher

    s = BruteForceSearcher(DenseDataset(train), _measure_for(distance))
    out = []
    for i in range(0, len(queries), batch):
        idx, _ = s.search_batched_arrays(queries[i : i + batch], k)
        out.append(idx)
    return np.concatenate(out, axis=0).astype(np.int32)


def generate_synthetic_dataset(train_size: int = 10_000, test_size: int = 200,
                               dim: int = 64, k: int = 10, seed: int = 42,
                               clustered: bool = False,
                               distance: str = "squared-l2") -> BenchmarkData:
    """Seeded synthetic data; uniform [0,1) like the reference
    (ann_benchmark.rs:402-425), or clustered for partition-friendly regimes."""
    import jax
    import jax.numpy as jnp

    # generate on device: constrained-container host CPUs take minutes to
    # draw 10^8 variates that the chip produces in milliseconds
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    if clustered:
        n_clusters = max(train_size // 500, 8)
        centers = jax.random.normal(k1, (n_clusters, dim), jnp.float32) * 3.0
        a = jax.random.randint(k2, (train_size,), 0, n_clusters)
        train = np.asarray(jnp.take(centers, a, axis=0)
                           + jax.random.normal(k3, (train_size, dim), jnp.float32))
        aq = jax.random.randint(k4, (test_size,), 0, n_clusters)
        test = np.asarray(jnp.take(centers, aq, axis=0)
                          + jax.random.normal(k5, (test_size, dim), jnp.float32))
        source = f"synthetic_clustered_n{train_size}_q{test_size}_d{dim}"
    else:
        train = np.asarray(jax.random.uniform(k1, (train_size, dim), jnp.float32))
        test = np.asarray(jax.random.uniform(k2, (test_size, dim), jnp.float32))
        source = f"synthetic_n{train_size}_q{test_size}_d{dim}"
    gt = exact_ground_truth(train, test, k, distance=distance)
    return BenchmarkData(train, test, gt, source, dim)


def generate_adversarial_dataset(train_size: int, test_size: int, dim: int,
                                 k: int, seed: int = 42,
                                 distance: str = "squared-l2",
                                 zipf_s: float = 1.07,
                                 aniso_sigma: float = 0.6,
                                 norm_sigma: float = 0.35) -> BenchmarkData:
    """GloVe-shaped skewed synthetic data.

    Real embedding corpora are not well-separated isotropic blobs: cluster
    sizes are heavy-tailed, per-cluster covariance is anisotropic, observed
    dimensions are correlated, and point norms vary widely. This generator
    reproduces all four so partition balance (the l_cap lever) and LUT
    quantization are stressed the way GloVe-1.18M stresses them:

    - **Zipf cluster mass**: p_i proportional to (i+1)^-zipf_s — a few giant
      clusters plus a long tail of rare ones.
    - **Anisotropic covariance**: per-cluster, per-axis log-normal scales
      (sigma=aniso_sigma) before a global rotation.
    - **Correlated dims**: one random orthogonal mixing matrix applied to
      every point, so no observed coordinate is independent.
    - **Heavy-tailed norms**: per-point log-normal radial factor
      (sigma=norm_sigma).

    Queries are drawn from the same skewed mixture (rare clusters included).

    Generation runs on HOST numpy: this environment's device->host link is
    ~2.4 MB/s and rejects multi-hundred-MB pulls (RESOURCE_EXHAUSTED), while
    host numpy draws 10^8 normals in seconds; only the exact-GT computation
    uploads to the device (once, chunked).
    """
    rng = np.random.default_rng(seed)
    n_clusters = max(train_size // 500, 64)
    p = (np.arange(1, n_clusters + 1, dtype=np.float64)) ** (-zipf_s)
    p /= p.sum()
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    scales = np.exp(rng.standard_normal((n_clusters, dim)) * aniso_sigma
                    ).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32)

    def draw(m):
        a = rng.choice(n_clusters, size=m, p=p)
        x = rng.standard_normal((m, dim), dtype=np.float32)
        x *= scales[a]
        x += centers[a]
        r = np.exp(rng.standard_normal((m, 1)) * norm_sigma).astype(np.float32)
        return (x * r) @ rot

    train = draw(train_size)
    test = draw(test_size)
    gt = exact_ground_truth(train, test, k, distance=distance)
    source = f"synthetic_adversarial_n{train_size}_q{test_size}_d{dim}"
    return BenchmarkData(train, test, gt, source, dim)


def load_hdf5_dataset(path: str, k: int, limit_train: Optional[int] = None,
                      limit_test: Optional[int] = None,
                      distance: str = "squared-l2") -> BenchmarkData:
    """Native ANN-Benchmarks HDF5 (train/test/neighbors datasets) — the
    reference requires an HDF5->JSON conversion step (README.md:718-730);
    here the standard files load directly. Truncating the train set
    invalidates the file's neighbor ids (they index the FULL set), so GT is
    recomputed exactly over the truncated rows in that case."""
    try:
        import h5py
    except ImportError as e:
        from scann_tpu.errors import ScannError

        raise ScannError.failed_precondition(
            f"reading the HDF5 dataset {path!r} needs the h5py package, "
            f"which is not installed (JSON datasets need nothing extra)"
        ) from e

    with h5py.File(path, "r") as f:
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"], dtype=np.float32)
        neighbors = np.asarray(f["neighbors"], dtype=np.int64)
    truncated = bool(limit_train) and limit_train < len(train)
    if limit_train:
        train = train[:limit_train]
    if limit_test:
        test = test[:limit_test]
        neighbors = neighbors[:limit_test]
    if truncated:
        gt = exact_ground_truth(train, test, k, distance=distance)
    else:
        if neighbors.shape[1] < k:
            raise ValueError(f"neighbors rows must have at least {k} entries")
        gt = neighbors[: len(test), :k].astype(np.int32)
    return BenchmarkData(train, test, gt, path, train.shape[1])


def load_json_dataset(path: str, k: int, limit_train: Optional[int] = None,
                      limit_test: Optional[int] = None,
                      distance: str = "squared-l2") -> BenchmarkData:
    """(reference: ann_benchmark.rs:357-400). As with the HDF5 loader, GT
    is recomputed when --limit-train truncates the indexable rows."""
    with open(path) as f:
        raw = json.load(f)
    train = np.asarray(raw["train"], dtype=np.float32)
    test = np.asarray(raw["test"], dtype=np.float32)
    neighbors = [list(map(int, row)) for row in raw["neighbors"]]
    truncated = bool(limit_train) and limit_train < len(train)
    if limit_train:
        train = train[:limit_train]
    if limit_test:
        test = test[:limit_test]
        neighbors = neighbors[:limit_test]
    if len(train) == 0 or len(test) == 0 or len(neighbors) == 0:
        raise ValueError("dataset JSON must include non-empty train/test/neighbors")
    if truncated:
        gt = exact_ground_truth(train, test, k, distance=distance)
    else:
        if any(len(r) < k for r in neighbors):
            raise ValueError(f"neighbors rows must have at least {k} entries")
        gt = np.asarray([r[:k] for r in neighbors[: len(test)]], dtype=np.int32)
    return BenchmarkData(train, test, gt, path, train.shape[1])


def average_recall_at_k(results: np.ndarray, gt: np.ndarray) -> float:
    """(reference: ann_benchmark.rs:452-471)."""
    recs = []
    for found, want in zip(results, gt):
        want_set = set(int(w) for w in want)
        found_set = set(int(f) for f in found if f >= 0)
        recs.append(len(found_set & want_set) / max(len(want_set), 1))
    return float(np.mean(recs))


def build_index(algorithm: str, data: BenchmarkData, args) -> "object":
    """(reference: ann_benchmark.rs:329-355)."""
    from scann_tpu.config import (
        ExactReorderingConfig,
        HashConfig,
        PartitioningConfig,
        ScannConfig,
    )
    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.models.scann import Scann

    cfg = ScannConfig(num_neighbors=args.k,
                      distance_measure=_measure_for(getattr(args, "distance", "squared-l2")))
    if algorithm == "brute-force":
        cfg.with_brute_force()
    elif algorithm == "block-sweep":
        cfg.with_brute_force()
        cfg.brute_force.with_block_sweep(
            pre_k=args.reorder or 100,
            sweep_dtype=getattr(args, "sweep_dtype", "bfloat16"))
    elif algorithm == "partitioned":
        cfg.with_partitioning(PartitioningConfig(
            num_partitions=args.num_partitions,
            num_partitions_to_search=args.partitions_to_search,
        ))
    elif algorithm == "hashed":
        cfg.with_hashing(HashConfig(num_blocks=args.num_blocks,
                                    num_buckets=args.num_buckets))
        if args.reorder:
            cfg.with_reordering(ExactReorderingConfig(num_candidates=args.reorder))
    elif algorithm == "tree-ah":
        cfg.with_partitioning(PartitioningConfig(
            num_partitions=args.num_partitions,
            num_partitions_to_search=args.partitions_to_search,
        ))
        cfg.with_hashing(HashConfig(num_blocks=args.num_blocks, num_buckets=16))
        cfg.with_reordering(ExactReorderingConfig(
            num_candidates=args.reorder or args.k * 3,
            rerank_dtype=args.rerank_dtype))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return Scann(DenseDataset(data.train), cfg)


_KIND_TO_ALGORITHM = {
    "BruteForceSearcher": "brute-force",
    "BlockSweepSearcher": "block-sweep",
    "ScalarQuantizedBruteForceSearcher": "scalar-quantized",
    "PartitionedSearcher": "partitioned",
    "AsymmetricHasher": "hashed",
    "TreeXHybridSearcher": "tree-ah",
}


def _algorithm_of(index) -> str:
    """Reported algorithm derived from the searcher's actual type (a loaded
    index must not inherit the CLI default, which could mislabel the JSON)."""
    return _KIND_TO_ALGORITHM.get(type(index).__name__,
                                  type(index).__name__)


def _shard_index(index, n_shards: int):
    """Re-serve a built index through the database-sharded wrappers on an
    n-device mesh (SURVEY §2.6 scale-out; the reference has no distributed
    backend at all)."""
    from scann_tpu.models.block_sweep import BlockSweepSearcher
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded import ShardedBruteForceSearcher
    from scann_tpu.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
    )

    impl = getattr(index, "impl", index)
    mesh = make_mesh(n_shards, axis_names=("db",))
    if isinstance(impl, TreeXHybridSearcher):
        return ShardedTreeXHybridSearcher(impl, mesh)
    if isinstance(impl, BlockSweepSearcher):
        return ShardedBlockSweepSearcher(impl, mesh)
    if isinstance(impl, BruteForceSearcher):
        return ShardedBruteForceSearcher(impl.dataset,
                                         impl.distance_measure, mesh)
    raise ValueError(
        f"--shards supports brute-force / block-sweep / tree-ah indexes, "
        f"not {type(impl).__name__}")


def run_benchmark(algorithm: str, data: BenchmarkData, args) -> BenchmarkReport:
    rss0 = current_rss_bytes()
    t0 = time.perf_counter()
    loaded_from = getattr(args, "load_index", None)
    if loaded_from:
        # build-once / serve-many: reload the trained index instead of
        # rebuilding (capability the reference binary lacks — it retrains
        # every run, ann_benchmark.rs:329-355). build_seconds then reports
        # the load time.
        from scann_tpu.io import load_index

        index = load_index(loaded_from)
        algorithm = _algorithm_of(index)
        # Serving a loaded index against the wrong dataset (different --seed,
        # --synthetic-train, or file) would score recall against ground truth
        # for data the index never saw — a silently wrong report. Refuse.
        if index.dataset_size() != len(data.train):
            raise ValueError(
                f"--load-index {loaded_from!r} holds {index.dataset_size()} "
                f"points but the dataset has {len(data.train)}; the loaded "
                "index does not match this dataset (check --seed / "
                "--synthetic-train / --dataset)")
        if index.dimensionality() != data.dimension:
            raise ValueError(
                f"--load-index {loaded_from!r} is {index.dimensionality()}-d "
                f"but the dataset is {data.dimension}-d; the loaded index "
                "does not match this dataset")
    else:
        index = build_index(algorithm, data, args)
    build_s = time.perf_counter() - t0
    rss1 = current_rss_bytes()

    save_s = None
    saved_to = getattr(args, "save_index", None)
    if saved_to:
        from scann_tpu.io import save_index

        t_sv = time.perf_counter()
        save_index(saved_to, index)
        save_s = time.perf_counter() - t_sv

    # shard AFTER saving: the .npz stores the single-device index (the
    # sharded wrappers re-layout from it on any mesh size at load)
    n_shards = max(1, int(getattr(args, "shards", 1) or 1))
    if n_shards > 1:
        index = _shard_index(index, n_shards)

    batch = args.batch_size
    # warm-up compile (excluded from timing, like criterion's warm-up)
    index.search_batched_arrays(data.test[:batch], args.k)

    # Recall-targeted tuning (the reference leaves partitions_to_search /
    # reordering depth to hand sweeps; BASELINE's recall@10=0.9 north star
    # requires tuned values). Each grid point is one batched device program
    # over the sample; the chosen SearchParameters then serve every batch.
    tuned_params = None
    tune_info: dict = {}
    target = getattr(args, "autotune_target", None)
    if target:
        from scann_tpu.utils.autotune import autotune

        n_sample = min(256, len(data.test))
        p_grid = _parse_int_list(getattr(args, "autotune_leaves", None))
        pre_k_grid = _parse_int_list(getattr(args, "autotune_prek", None))
        t_at = time.perf_counter()
        res = autotune(index, data.test[:n_sample], k=args.k,
                       target_recall=float(target),
                       p_grid=p_grid, pre_k_grid=pre_k_grid,
                       gt=data.gt[:n_sample, : args.k])
        tuned_params = res.params
        tune_info = dict(
            autotune_target=float(target),
            autotune_target_met=res.target_met,
            autotune_sample_recall=res.recall,
            autotune_seconds=time.perf_counter() - t_at,
            autotuned_num_leaves_to_search=res.params.num_leaves_to_search,
            autotuned_pre_reordering_num_neighbors=(
                res.params.pre_reordering_num_neighbors),
        )
        # re-warm: the tuned shapes differ from the default warm-up's
        index.search_batched_arrays(data.test[:batch], args.k, tuned_params)

    profile_ctx = None
    if getattr(args, "profile_dir", None):
        import jax
        profile_ctx = jax.profiler.trace(args.profile_dir)
        profile_ctx.__enter__()

    results = np.full((len(data.test), args.k), -1, dtype=np.int64)
    pipeline = max(1, int(getattr(args, "pipeline", 1) or 1))
    starts = list(range(0, len(data.test), batch))
    t0 = time.perf_counter()
    if pipeline > 1:
        # Concurrent serving: `pipeline` batches in flight on worker threads.
        # JAX dispatch is thread-safe and the per-batch host<->device
        # round-trip overlaps across in-flight batches, so wall-clock QPS
        # approaches kernel throughput — the same pattern a real serving
        # frontend uses for concurrent requests.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=pipeline) as ex:
            futs = [ex.submit(index.search_batched_arrays,
                              data.test[i : i + batch], args.k, tuned_params)
                    for i in starts]
            for i, f in zip(starts, futs):
                idx, _ = f.result()
                results[i : i + idx.shape[0], : idx.shape[1]] = idx
    else:
        for i in starts:
            idx, _ = index.search_batched_arrays(data.test[i : i + batch],
                                                 args.k, tuned_params)
            results[i : i + idx.shape[0], : idx.shape[1]] = idx
    search_s = time.perf_counter() - t0

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    recall = average_recall_at_k(results, data.gt)
    dev_bytes = None
    impl = getattr(index, "impl", index)  # loaded indexes are the searcher
    if hasattr(impl, "memory_usage"):
        dev_bytes = int(impl.memory_usage())

    rtt = measure_host_roundtrip_seconds()
    n_batches = -(-len(data.test) // batch)
    dispatch_frac = (min(1.0, (rtt * n_batches) / (search_s * pipeline))
                     if search_s > 0 else None)

    return BenchmarkReport(
        dataset=data.source,
        algorithm=algorithm,
        distance=getattr(args, "distance", "squared-l2"),
        k=args.k,
        train_size=len(data.train),
        test_size=len(data.test),
        dimension=data.dimension,
        build_seconds=build_s,
        search_seconds=search_s,
        qps=len(data.test) / search_s if search_s > 0 else 0.0,
        recall_at_k=recall,
        index_rss_delta_bytes=(rss1 - rss0) if rss0 is not None and rss1 is not None else None,
        index_device_bytes=dev_bytes,
        batch_size=batch,
        timing_mode=(f"wall_clock_pipelined_x{pipeline}" if pipeline > 1
                     else "wall_clock_per_batch_dispatch"),
        shards=n_shards if n_shards > 1 else None,
        host_roundtrip_seconds=rtt,
        dispatch_bound_fraction=dispatch_frac,
        index_loaded_from=loaded_from,
        index_saved_to=saved_to,
        index_save_seconds=save_s,
        **tune_info,
    )


def _parse_int_list(spec) -> Optional[list]:
    """'2,5,10' -> [2, 5, 10]; None/'' -> None (use autotune's defaults)."""
    if not spec:
        return None
    return [int(s) for s in str(spec).split(",") if s.strip()]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="scann_tpu ANN benchmark harness")
    p.add_argument("--algorithm", default="brute-force",
                   choices=["brute-force", "block-sweep", "partitioned",
                            "hashed", "tree-ah"])
    p.add_argument("--distance", default="squared-l2",
                   choices=["squared-l2", "l2", "cosine", "dot-product"])
    p.add_argument("--dataset", default=None, help="ANN-Benchmarks JSON path")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--num-partitions", type=int, default=100)
    p.add_argument("--partitions-to-search", type=int, default=10)
    p.add_argument("--num-blocks", type=int, default=16)
    p.add_argument("--num-buckets", type=int, default=256)
    p.add_argument("--reorder", type=int, default=0)
    p.add_argument("--rerank-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="tree-ah exact-rerank copy dtype (bfloat16 halves / "
                        "int8 quarters the dominant serving allocation)")
    p.add_argument("--sweep-dtype", default="bfloat16",
                   choices=["bfloat16", "int8"],
                   help="block-sweep streamed-copy dtype (int8 halves the "
                        "byte stream; recall recovered by the exact re-rank)")
    p.add_argument("--limit-train", type=int, default=None)
    p.add_argument("--limit-test", type=int, default=None)
    p.add_argument("--synthetic-train", type=int, default=10_000)
    p.add_argument("--synthetic-test", type=int, default=200)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--pipeline", type=int, default=1,
                   help="number of query batches in flight (worker threads); "
                        ">1 overlaps the per-batch host<->device round-trip "
                        "the way a concurrent serving frontend does")
    p.add_argument("--autotune-target", type=float, default=None,
                   help="tune (num_leaves_to_search, pre_reordering depth) on a "
                        "<=256-query sample to the cheapest config meeting this "
                        "recall@k, then serve with it (utils/autotune.py)")
    p.add_argument("--autotune-leaves", default=None,
                   help="comma list of num_leaves_to_search grid values "
                        "(default: autotune's built-in grid)")
    p.add_argument("--autotune-prek", default=None,
                   help="comma list of pre_reordering_num_neighbors grid values")
    p.add_argument("--clustered", action="store_true")
    p.add_argument("--adversarial", action="store_true",
                   help="GloVe-shaped skewed synthetic data: Zipf cluster "
                        "sizes, anisotropic covariance, correlated dims, "
                        "heavy-tailed norms")
    p.add_argument("--save-index", default=None,
                   help="after building, save the trained index to this "
                        ".npz path (scann_tpu.io.save_index)")
    p.add_argument("--load-index", default=None,
                   help="serve from an index saved with --save-index "
                        "instead of building; --algorithm and training "
                        "knobs are ignored, build_seconds reports the load")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of the search phase here")
    p.add_argument("--calibrate-profile", default=None, metavar="PATH",
                   help="re-measure the chip profile's crossover constants "
                        "on THIS device (utils/chip_profile.calibrate), save "
                        "the JSON to PATH, and use it for this run — the "
                        "in-place regeneration hook deployments run once "
                        "per device kind")
    p.add_argument("--shards", type=int, default=1,
                   help="serve through the database-sharded wrappers on an "
                        "N-device mesh (brute-force/block-sweep/tree-ah; "
                        "needs >= N visible devices — on CPU set "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if args.calibrate_profile:
        import os

        from scann_tpu.utils.chip_profile import calibrate, save_profile

        prof = calibrate(verbose=True)
        save_profile(prof, args.calibrate_profile)
        # the rest of this run (auto_config crossovers, advisor) reads it
        os.environ["SCANN_TPU_CHIP_PROFILE"] = args.calibrate_profile
        print(f"chip profile calibrated -> {args.calibrate_profile}: "
              f"sweep_max_n={prof.sweep_max_n:,}")
    if args.dataset:
        loader = load_hdf5_dataset if args.dataset.endswith(
            (".hdf5", ".h5")) else load_json_dataset
        data = loader(args.dataset, args.k, args.limit_train, args.limit_test,
                      distance=args.distance)
    elif args.adversarial:
        data = generate_adversarial_dataset(
            args.synthetic_train, args.synthetic_test, args.dim, args.k,
            args.seed, distance=args.distance,
        )
    else:
        data = generate_synthetic_dataset(
            args.synthetic_train, args.synthetic_test, args.dim, args.k, args.seed,
            clustered=args.clustered, distance=args.distance,
        )
    report = run_benchmark(args.algorithm, data, args)
    print(report.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
