"""K-means clustering, fully on-device.

Replaces the reference's rayon/SIMD Lloyd's loop
(reference: src/trees/kmeans.rs:150-431) with one jit-compiled program:

  - assignment: chunked distance matmul [chunk, K] + argmin
    (reference's per-point scalar/SIMD loop, kmeans.rs:352-379)
  - update: ``segment_sum`` scatter-add + count division
    (reference's f64 accumulation loop, kmeans.rs:381-414); empty cluster i
    is reseeded deterministically to ``data[i % n]`` (kmeans.rs:405-410)
  - k-means++: weighted categorical sampling on the running min-distance
    vector with ``jax.random`` (kmeans.rs:294-349)
  - convergence: relative inertia change < threshold, checked before the
    update step exactly like the reference (kmeans.rs:233-239)
  - restarts: host loop keeping the best-inertia run (kmeans.rs:196-204),
    seed offset by restart index

The whole Lloyd's loop runs inside ``lax.while_loop``; the host only sees the
final result.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.errors import ScannError


class KMeansInit(enum.Enum):
    RANDOM = "Random"
    KMEANS_PLUS_PLUS = "KMeansPlusPlus"
    PROVIDED = "Provided"


@dataclasses.dataclass
class KMeansConfig:
    """(reference: src/trees/kmeans.rs:20-61)."""

    num_clusters: int = 10
    max_iterations: int = 100
    convergence_threshold: float = 1e-5
    init_method: KMeansInit = KMeansInit.KMEANS_PLUS_PLUS
    seed: Optional[int] = None
    num_restarts: int = 1


@dataclasses.dataclass
class KMeansResult:
    """(reference: src/trees/kmeans.rs:121-147)."""

    centers: np.ndarray        # [K, D] f32
    assignments: np.ndarray    # [N] int32
    cluster_sizes: np.ndarray  # [K] int64
    inertia: float
    num_iterations: int
    converged: bool


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------


def adaptive_row_chunk(chunk_size: int, n: int, k: int,
                       cap_elems: int = 200_000_000) -> int:
    """Rows per chunk such that the [chunk, K] intermediates (~4-6 B/elem
    across the fused distance + one-hot buffers) stay near ~1 GB: a fixed
    64k-row chunk at 16k+ partitions is a 4.4 GB matrix that OOMs a 16 GB
    chip next to a multi-GB dataset (measured at 10M x 16k)."""
    c = min(chunk_size, max(n, 1), max(cap_elems // max(k, 1), 4096))
    return max(256, (c // 256) * 256) if c >= 256 else c


def assign_clusters(
    data: jnp.ndarray, centers: jnp.ndarray, chunk_size: int = 65536
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(assignments [N] int32, min squared distance [N] f32).

    Distances via ||x||^2 + ||c||^2 - 2 x.c computed chunk-by-chunk over N so
    the [chunk, K] matrix stays modest for million-point datasets.

    Precision is deliberately left at the default here (TF32 on an NVIDIA
    GPU, one bf16 pass elsewhere), unlike the HIGHEST of the query path:
    only the argmin is used, it is insensitive to the last bits, and the
    min distance feeds only the inertia/convergence check. Query-path
    distances never come from this function.
    """
    n, d = data.shape
    chunk_size = adaptive_row_chunk(chunk_size, n, centers.shape[0])
    c_sq = jnp.sum(centers * centers, axis=1)

    def one_chunk(x):
        dots = jax.lax.dot_general(
            x, centers,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        x_sq = jnp.sum(x * x, axis=1)
        dist = x_sq[:, None] + c_sq[None, :] - 2.0 * dots
        dist = jnp.maximum(dist, 0.0)
        a = jnp.argmin(dist, axis=1).astype(jnp.int32)
        return a, jnp.min(dist, axis=1)

    if n <= chunk_size:
        return one_chunk(data)

    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    padded = jnp.pad(data, ((0, n_pad - n), (0, 0)))
    a, m = jax.lax.map(one_chunk, padded.reshape(n_chunks, chunk_size, d))
    return a.reshape(n_pad)[:n], m.reshape(n_pad)[:n]


def update_centers(
    data: jnp.ndarray, assignments: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(new centers [K, D], counts [K]) with deterministic empty-cluster
    reseed to data[i % n] (reference: kmeans.rs:381-414)."""
    n = data.shape[0]
    sums = jax.ops.segment_sum(data, assignments, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), assignments, num_segments=k)
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    reseed_rows = jnp.arange(k, dtype=jnp.int32) % n
    reseed = jnp.take(data, reseed_rows, axis=0)
    centers = jnp.where((counts > 0)[:, None], means, reseed)
    return centers, counts


def _kmeans_pp_init(key, data: jnp.ndarray, k: int) -> jnp.ndarray:
    """k-means++ seeding (reference: kmeans.rs:294-349): first center uniform,
    then sample proportional to squared distance to the nearest chosen center;
    uniform fallback when all distances are zero."""
    n, d = data.shape

    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers0 = jnp.zeros((k, d), data.dtype).at[0].set(data[first])

    def dist_to(c):
        diff = data - c[None, :]
        return jnp.sum(diff * diff, axis=1)

    min_d0 = dist_to(data[first])

    def body(i, carry):
        centers, min_d, key = carry
        key, sub_cat, sub_unif = jax.random.split(key, 3)
        total = jnp.sum(min_d)
        # categorical ∝ min_d; all-zero -> uniform (duplicate points)
        logits = jnp.where(min_d > 0.0, jnp.log(jnp.maximum(min_d, 1e-30)), -jnp.inf)
        idx_cat = jax.random.categorical(sub_cat, logits)
        idx_unif = jax.random.randint(sub_unif, (), 0, n)
        idx = jnp.where(total > 0.0, idx_cat, idx_unif)
        c = data[idx]
        centers = centers.at[i].set(c)
        min_d = jnp.minimum(min_d, dist_to(c))
        return centers, min_d, key

    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers0, min_d0, key))
    return centers


def _lloyd_sums(data: jnp.ndarray, centers: jnp.ndarray, *, k: int,
                chunk_size: int = 65536):
    """Traced body shared by _lloyd_step and _lloyd_partial: one fused
    pass over the data in chunks: distances (matmul) -> argmin ->
    one-hot -> partial sums via a second matmul. The cluster-sum is
    deliberately a one-hot matmul, NOT ``segment_sum``: a scatter-add over
    a [1M, D] operand can take minutes to compile, while this formulation
    compiles in seconds and runs at matmul speed. Returns (sums [k, D], counts [k], inertia)."""
    data = data.astype(jnp.float32)
    centers = centers.astype(jnp.float32)
    n, d = data.shape
    c_sq = jnp.sum(centers * centers, axis=1)

    chunk = adaptive_row_chunk(chunk_size, n, k)
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    padded = jnp.pad(data, ((0, n_pad - n), (0, 0)))
    chunks = padded.reshape(n_chunks, chunk, d)
    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        sums, counts, inertia = carry
        x, start = xs
        dots = jax.lax.dot_general(
            x, centers, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        x_sq = jnp.sum(x * x, axis=1)
        dist = jnp.maximum(x_sq[:, None] + c_sq[None, :] - 2.0 * dots, 0.0)
        a = jnp.argmin(dist, axis=1)
        md = jnp.min(dist, axis=1)
        row = jax.lax.broadcasted_iota(jnp.int32, (x.shape[0], 1), 0)[:, 0] + start
        valid = row < n
        iota_k = jax.lax.broadcasted_iota(jnp.int32, (x.shape[0], k), 1)
        onehot = ((a[:, None] == iota_k) & valid[:, None]).astype(jnp.bfloat16)
        sums = sums + jax.lax.dot_general(
            onehot, x.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(onehot, axis=0, dtype=jnp.float32)
        inertia = inertia + jnp.sum(jnp.where(valid, md, 0.0))
        return (sums, counts, inertia), None

    init = (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32),
            jnp.float32(0.0))
    (sums, counts, inertia), _ = jax.lax.scan(body, init, (chunks, starts))
    return sums, counts, inertia


_lloyd_partial = jax.jit(_lloyd_sums, static_argnames=("k", "chunk_size"))


@functools.partial(jax.jit, static_argnames=("k", "chunk_size"))
def _lloyd_step(data: jnp.ndarray, centers: jnp.ndarray, *, k: int,
                chunk_size: int = 65536):
    """One Lloyd's iteration: (new_centers, inertia) — see _lloyd_sums."""
    sums, counts, inertia = _lloyd_sums(data, centers, k=k,
                                        chunk_size=chunk_size)
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    n = data.shape[0]
    reseed = jnp.take(data, jnp.arange(k, dtype=jnp.int32) % n, axis=0)
    new_centers = jnp.where((counts > 0)[:, None], means, reseed)
    return new_centers, inertia


# rows per device call in the sliced Lloyd driver: the program pads/copies
# its input, so a whole-database call duplicates the full [N, D] array
# (at 20M x 100d a second 9.54 GB allocation — measured OOM)
_LLOYD_SLICE_ROWS = 1 << 22


def lloyd_step_sliced(data: jnp.ndarray, centers: jnp.ndarray, *, k: int,
                      rows: int = _LLOYD_SLICE_ROWS):
    """One Lloyd's iteration over a device array too large for a single
    program: partial (sums, counts) accumulate on host across row slices
    (each [k, D] partial is MBs), then one tiny program finishes
    means + empty-cluster reseed. Bit-equivalent policy to _lloyd_step."""
    import numpy as np

    n = data.shape[0]
    if n <= rows:
        return _lloyd_step(data, centers, k=k)
    sums = np.zeros((k, data.shape[1]), np.float32)
    counts = np.zeros((k,), np.float32)
    inertia = 0.0
    for lo in range(0, n, rows):
        s, c, i = _lloyd_partial(
            jax.lax.slice_in_dim(data, lo, min(lo + rows, n)), centers, k=k)
        sums += np.asarray(s)
        counts += np.asarray(c)
        inertia += float(i)
    sums_d, counts_d = jnp.asarray(sums), jnp.asarray(counts)
    means = sums_d / jnp.maximum(counts_d, 1.0)[:, None]
    # reseed from the first k rows: with k <= n this equals the
    # arange(k) % n gather policy, but lowers as a SLICE — a whole-array
    # gather forces XLA to copy the full [N, D] operand to its padded
    # layout first (measured 9.54 GB temp for a 16.8 MB output at 20M)
    if k <= n:
        reseed = jax.lax.slice_in_dim(data, 0, k)
    else:
        reseed = jnp.take(data, jnp.arange(k, dtype=jnp.int32) % n, axis=0)
    new_centers = jnp.where((counts_d > 0)[:, None], means, reseed)
    return new_centers, jnp.float32(inertia)


@functools.partial(jax.jit, static_argnames=("k",))
def _finalize(data: jnp.ndarray, centers: jnp.ndarray, *, k: int):
    assignments, min_d = assign_clusters(data, centers)
    counts = jax.ops.segment_sum(
        jnp.ones((data.shape[0],), jnp.float32), assignments, num_segments=k)
    return assignments, counts, jnp.sum(min_d)


@functools.partial(jax.jit, static_argnames=("k",))
def _random_init(data: jnp.ndarray, key, *, k: int):
    perm = jax.random.permutation(key, data.shape[0])[:k]
    return jnp.take(data, perm, axis=0)


_kmeans_pp_init_jit = jax.jit(_kmeans_pp_init, static_argnames=("k",))

# k-means++ is a sequential fori_loop over k steps; its compile time grows
# with nothing but its run time grows with k * N. Above this k we fall back
# to random init + extra Lloyd refinement (same quality regime at far lower
# build cost for partition-count-scale k).
KMEANS_PP_MAX_K = 256


def kmeans_fit_device(
    data: jnp.ndarray,
    key: jnp.ndarray,
    *,
    k: int,
    max_iterations: int,
    convergence_threshold: float,
    init_method: KMeansInit,
    init_centers: Optional[jnp.ndarray] = None,
):
    """One k-means run. The Lloyd's loop is host-driven over small jitted
    steps (assign+update fused per call) rather than one device while_loop —
    the step programs compile once and are shared across every k-means
    instance with the same shapes (subspace codebooks, restarts, tree
    nodes), which matters enormously for build time. Convergence is checked
    on host exactly like the reference (break before update,
    kmeans.rs:233-239).

    Returns (centers [K,D], assignments [N], counts [K], inertia,
    num_iterations, converged) — device arrays/scalars.
    """
    data = data.astype(jnp.float32)

    if init_centers is not None:
        centers = init_centers.astype(jnp.float32)
    elif init_method == KMeansInit.RANDOM or k > KMEANS_PP_MAX_K:
        centers = _random_init(data, key, k=k)
    else:
        centers = _kmeans_pp_init_jit(key, data, k=k)

    prev_inertia = float("inf")
    converged = False
    iters = 0
    for it in range(max_iterations):
        iters = it + 1
        new_centers, inertia_dev = _lloyd_step(data, centers, k=k)
        inertia = float(inertia_dev)
        rel = abs(prev_inertia - inertia) / (prev_inertia + 1e-10) \
            if prev_inertia != float("inf") else float("inf")
        if rel < convergence_threshold:
            converged = True
            break
        prev_inertia = inertia
        centers = new_centers

    assignments, counts, final_inertia = _finalize(data, centers, k=k)
    return centers, assignments, counts, final_inertia, jnp.int32(iters), jnp.bool_(converged)


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


class KMeans:
    """Host wrapper running restarts and materializing the result
    (reference: src/trees/kmeans.rs:150-207)."""

    def __init__(self, config: Optional[KMeansConfig] = None):
        self.config = config or KMeansConfig()

    @classmethod
    def with_clusters(cls, k: int) -> "KMeans":
        return cls(KMeansConfig(num_clusters=k))

    def fit(self, data, init_centers: Optional[np.ndarray] = None) -> KMeansResult:
        arr = data.numpy() if hasattr(data, "numpy") else np.asarray(data, dtype=np.float32)
        n = arr.shape[0]
        if n == 0:
            raise ScannError.invalid_argument("Cannot cluster empty dataset")
        cfg = self.config
        k = min(cfg.num_clusters, n)
        if k <= 0:
            raise ScannError.invalid_argument("Number of clusters must be > 0")
        if cfg.init_method == KMeansInit.PROVIDED and init_centers is None:
            raise ScannError.invalid_argument("Provided initialization requires initial centers")
        if init_centers is not None:
            init_centers = np.asarray(init_centers, dtype=np.float32)
            # the Lloyd step builds its one-hot with k columns: centers
            # beyond k would silently drop their points from every update
            if init_centers.shape != (k, arr.shape[1]):
                raise ScannError.invalid_argument(
                    f"init_centers shape {init_centers.shape} != "
                    f"({k}, {arr.shape[1]})")

        data_dev = jnp.asarray(arr, dtype=jnp.float32)
        seed = cfg.seed if cfg.seed is not None else np.random.SeedSequence().entropy % (2**31)

        best = None
        for restart in range(max(cfg.num_restarts, 1)):
            key = jax.random.PRNGKey(int(seed) + restart)
            out = kmeans_fit_device(
                data_dev, key,
                k=k,
                max_iterations=cfg.max_iterations,
                convergence_threshold=float(cfg.convergence_threshold),
                init_method=cfg.init_method,
                init_centers=None if init_centers is None else jnp.asarray(init_centers),
            )
            centers, assignments, counts, inertia, iters, converged = jax.tree.map(
                np.asarray, out
            )
            if best is None or float(inertia) < best.inertia:
                best = KMeansResult(
                    centers=centers,
                    assignments=assignments.astype(np.int32),
                    cluster_sizes=counts.astype(np.int64),
                    inertia=float(inertia),
                    num_iterations=int(iters),
                    converged=bool(converged),
                )
        return best
