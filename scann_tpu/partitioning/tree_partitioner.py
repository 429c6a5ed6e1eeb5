"""K-means tree partitioner.

Build = on-device k-means over the dataset (reference:
src/partitioning/tree_partitioner.rs:48-98, seed 42, 100 iterations); query =
batched centroid-distance matmul + top-p (the reference scores centroids with
a *scalar* loop and a full sort, tree_partitioner.rs:175-229 — here it's one
[B, K] matmul and ``lax.top_k``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.errors import ScannError
from scann_tpu.ops.distances import DistanceMeasure, many_to_many
from scann_tpu.ops.topk import top_k_smallest
from scann_tpu.partitioning.partitioner import DatabaseTokenization, PartitionResult
from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit


@dataclasses.dataclass
class TreePartitionerConfig:
    """(reference: tree_partitioner.rs:18-45)."""

    num_partitions: int = 100
    max_iterations: int = 100
    convergence_threshold: float = 1e-5
    seed: int = 42
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # >1 builds a hierarchical tree (reference: tree_partitioner.rs:101-140);
    # the production path is flat (num_levels=1).
    num_levels: int = 1
    training_sample_size: Optional[int] = None
    # spilling: also assign a point to its 2nd-nearest partition when
    # d2 <= d1 * (1 + spilling_threshold) (reference declares this in
    # PartitioningConfig, config.rs:151-155, but never implements it)
    spilling: bool = False
    spilling_threshold: float = 0.1
    # spilling_mode "soar" (extension; Sun, Guo & Kumar, NeurIPS 2023):
    # EVERY point gets one secondary partition chosen by the
    # orthogonality-amplified loss ||r2||^2 + lambda * <r2, r1_hat>^2 —
    # when a query aligns with the primary residual r1 (exactly the case
    # where the primary partition's quantized score is worst), the
    # secondary assignment covers it. "distance" = threshold rule above.
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    soar_candidates: int = 8
    # balance: split overloaded partitions (LBG-style center splitting +
    # Lloyd refinement), then hard-enforce the cap by demoting each
    # oversized partition's farthest members to their next-nearest center.
    # Skewed partitions directly cost search time in the padded-leaf/CSR
    # layouts (every query pays an l_cap term). None = off; "auto" = 1.5x
    # mean of the final partition count.
    max_partition_size: Optional[object] = None
    balance_rounds: int = 4
    # overflow-demotion passes and fallback choices per point; points that
    # exhaust all choices stay put (bounded slack instead of livelock).
    # Defaults raised 4 -> 12 after Zipf-mass data measured max size 3148
    # vs an 885 cap: hotspot points exhaust 4 nearby centers while the
    # padded-leaf kernels pay the straggler (l_cap) on EVERY query; the
    # extra rounds are host-side build-time only.
    cap_enforce_rounds: int = 12
    cap_enforce_choices: int = 12
    # hard-cap guarantee: split any partition the demote rounds left
    # oversized into principal-axis chunks of <= cap, each with its own
    # mean centroid (K grows by the straggler surplus). Assignments stay
    # local — only the partition granularity changes where data is densest
    # — so l_cap (the padded-leaf cost every query pays) is bounded by the
    # cap exactly instead of cap + straggler slack.
    split_stragglers: bool = True


@functools.partial(jax.jit, static_argnames=("measure", "p"))
def select_partitions_kernel(centers, queries, *, measure: DistanceMeasure, p: int):
    """[B, K] centroid distances -> (top-p distances, top-p tokens)."""
    dists = many_to_many(measure, queries, centers)
    return top_k_smallest(dists, p)


def lbg_grow_centers(data: np.ndarray, tokens: np.ndarray,
                     centers: np.ndarray, cap: int,
                     rng: np.random.Generator) -> Optional[np.ndarray]:
    """One LBG splitting step, shared by the single-device balance rounds
    and the sharded build: add jittered member copies of every oversized
    centroid, then pad K to a 256 bucket (stable compiled Lloyd shapes)
    with random dataset rows. Returns the grown [K', D] centers, or None
    when no partition exceeds ``cap`` (callers stop their rounds)."""
    sizes = np.bincount(tokens, minlength=centers.shape[0])
    if sizes.max() <= cap:
        return None
    n = len(data)
    new_centers = [centers]
    for t in np.nonzero(sizes > cap)[0]:
        members = np.nonzero(tokens == t)[0]
        n_extra = min(int(sizes[t] // cap), len(members))
        if n_extra <= 0:
            continue
        picks = rng.choice(members, size=n_extra, replace=False)
        new_centers.append(
            data[picks] + rng.normal(size=(n_extra, data.shape[1])
                                     ).astype(np.float32) * 1e-4)
    centers = np.concatenate(new_centers, axis=0)
    k_pad = ((centers.shape[0] + 255) // 256) * 256
    if k_pad > centers.shape[0]:
        # small datasets can need more bucket-pad centers than they have
        # rows: sample with replacement past n (duplicate centers lose
        # their members to whichever copy argmin picks — harmless)
        pad_n = k_pad - centers.shape[0]
        extra = rng.choice(n, size=pad_n, replace=pad_n > n)
        centers = np.concatenate([centers, data[extra]], axis=0)
    return centers


def demote_to_cap(dists: np.ndarray, choices: np.ndarray, cap: int,
                  rounds: int) -> np.ndarray:
    """Host demote loop of the balance cap: given each point's top-r
    nearest centers (``dists`` [N, r] ascending, ``choices`` [N, r]),
    move the lowest-regret members of oversized partitions to their next
    choice until every partition is <= cap or fallbacks are exhausted.
    Shared by the single-device ``_enforce_cap`` and the sharded build
    (which computes the top-r per shard). See _enforce_cap for why this
    runs on host."""
    r = choices.shape[1]
    nn = len(choices)
    rows = np.arange(nn)
    choice_idx = np.zeros(nn, np.int32)
    for _ in range(max(rounds, 0)):
        cur_t = choices[rows, choice_idx]
        cur_d = dists[rows, choice_idx]
        nxt_d = dists[rows, np.minimum(choice_idx + 1, r - 1)]
        regret = np.where(choice_idx < r - 1, nxt_d - cur_d, np.inf)
        order = np.lexsort((-regret, cur_t))
        sorted_t = cur_t[order]
        newrun = np.empty(nn, bool)
        newrun[0] = True
        np.not_equal(sorted_t[1:], sorted_t[:-1], out=newrun[1:])
        run_start = np.maximum.accumulate(np.where(newrun, rows, 0))
        rank = np.empty(nn, np.int64)
        rank[order] = rows - run_start
        demote = (rank >= cap) & (choice_idx < r - 1)
        if not demote.any():
            break
        choice_idx = np.where(demote, choice_idx + 1, choice_idx)
    return choices[rows, choice_idx].astype(np.int32)


@functools.partial(jax.jit, static_argnames=("r",))
def soar_select_kernel(centers, x, primary, lam, *, r: int):
    """SOAR secondary-assignment selection, one device program.

    centers [K, D]; x [B, D]; primary [B] int32 assigned tokens. Returns
    [B] int32 secondary tokens: argmin over the r nearest centers
    (primary masked out) of ||x - c_j||^2 + lam * <x - c_j, r1_hat>^2.
    """
    _, cand = select_partitions_kernel(
        centers, x, measure=DistanceMeasure.SQUARED_L2, p=r)  # [B, r]
    cand_c = jnp.take(centers, cand, axis=0)                  # [B, r, D]
    c1 = jnp.take(centers, primary, axis=0)                   # [B, D]
    r1 = x - c1
    r1h = r1 / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1, keepdims=True), 1e-30)
    r2 = x[:, None, :] - cand_c                               # [B, r, D]
    base = jnp.sum(r2 * r2, axis=-1)                          # [B, r]
    par = jnp.einsum("brd,bd->br", r2, r1h)
    loss = base + lam * par * par
    loss = jnp.where(cand == primary[:, None], jnp.inf, loss)
    best = jnp.argmin(loss, axis=-1)
    return jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0].astype(jnp.int32)


class TreePartitioner:
    """Flat (or hierarchical-leaf) k-means partitioner."""

    def __init__(self, config: Optional[TreePartitionerConfig] = None):
        self.config = config or TreePartitionerConfig()
        self.centers: Optional[np.ndarray] = None       # [K, D] leaf centroids
        self.tokenization: Optional[DatabaseTokenization] = None
        self._centers_dev = None

    # -- build ---------------------------------------------------------------
    def build(self, dataset) -> "TreePartitioner":
        """Train centroids and tokenize the full dataset
        (reference: tree_partitioner.rs:48-98)."""
        data = dataset.numpy() if hasattr(dataset, "numpy") else np.asarray(dataset, np.float32)
        cfg = self.config
        n = data.shape[0]
        if n == 0:
            raise ScannError.invalid_argument("cannot partition empty dataset")
        k = min(cfg.num_partitions, n)

        if cfg.num_levels > 1:
            return self._build_hierarchical(data, k)

        train = data
        if cfg.training_sample_size is not None and cfg.training_sample_size < n:
            rng = np.random.default_rng(cfg.seed)
            sel = rng.choice(n, size=cfg.training_sample_size, replace=False)
            train = data[sel]

        km = KMeans(KMeansConfig(
            num_clusters=k,
            max_iterations=cfg.max_iterations,
            convergence_threshold=cfg.convergence_threshold,
            init_method=KMeansInit.KMEANS_PLUS_PLUS,
            seed=cfg.seed,
        ))
        result = km.fit(train)
        self.centers = result.centers

        # upload the dataset ONCE; every tokenize/balance round reuses the
        # device copy (re-uploading 2GB per round through a host link
        # dominated 5M-scale build time). DenseDataset inputs share their
        # cached device array (also reused later by the searcher).
        # note: numpy>=2 ndarrays also carry a (non-callable) .device attr
        if callable(getattr(dataset, "device", None)):
            padded, n_dev = dataset.device()
            data_dev = padded if padded.shape[0] == n else padded[:n]
        else:
            data_dev = jnp.asarray(data, dtype=jnp.float32)
        if train is data:
            tokens = result.assignments
        else:
            tokens = self.tokenize(data_dev)

        if cfg.max_partition_size is not None:
            tokens = self._balance(data, tokens, data_dev=data_dev)

        extra = None
        if cfg.spilling:
            if cfg.spilling_mode == "soar":
                extra = self._spill_pairs_soar(
                    data_dev, tokens, cfg.soar_lambda, cfg.soar_candidates)
            else:
                extra = self._spill_pairs(data_dev, tokens, cfg.spilling_threshold)
            if cfg.max_partition_size is not None and extra is not None:
                extra = self._cap_secondaries(extra, tokens, len(data))
        self.tokenization = DatabaseTokenization(
            tokens, self.centers.shape[0], extra_pairs=extra)
        self._centers_dev = jnp.asarray(self.centers)
        return self

    def _balance(self, data: np.ndarray, tokens: np.ndarray,
                 data_dev=None) -> np.ndarray:
        """Split overloaded partitions: add jittered member copies of every
        oversized centroid, pad K to a 256 bucket (stable compiled shapes),
        re-run a few Lloyd iterations, re-tokenize. Repeats up to
        ``balance_rounds`` times or until max size <= cap."""
        import jax

        from scann_tpu.trees.kmeans import lloyd_step_sliced

        cfg = self.config
        n = len(data)
        # the cap is fixed from the ORIGINAL partition count — recomputing
        # it as splits grow K would shrink the target every round and
        # explode the tree (a 32-partition build measured ballooning to
        # 1536 partitions of mean size 3)
        cap = self._cap_value(n)
        rng = np.random.default_rng(cfg.seed)
        if data_dev is None:
            data_dev = jnp.asarray(data, dtype=jnp.float32)

        for _ in range(max(cfg.balance_rounds, 0)):
            centers = lbg_grow_centers(data, tokens, self.centers, cap, rng)
            if centers is None:
                break
            c_dev = jnp.asarray(centers, dtype=jnp.float32)
            for _ in range(3):
                c_dev, _ = lloyd_step_sliced(data_dev, c_dev,
                                             k=centers.shape[0])
            self.centers = np.asarray(c_dev)
            self._centers_dev = c_dev
            tokens = self.tokenize(data_dev)
        # LBG splitting alone may plateau above the cap (measured: max size
        # 1664 vs an 885 cap at 1.18M); hard-enforce by demotion
        tokens = self._enforce_cap(data_dev, tokens, cap)
        if cfg.split_stragglers:
            tokens = self._split_stragglers(data, tokens, cap)
        return tokens

    def _split_stragglers(self, data: np.ndarray, tokens: np.ndarray,
                          cap: int) -> np.ndarray:
        """Hard cap guarantee for the partitions the demote rounds left
        oversized (their points exhausted every nearby-center fallback —
        exactly the Zipf hotspots where another demotion round would ship
        points to *far* centroids and hurt recall). Each straggler is cut
        along its members' principal axis into equal chunks of <= cap;
        every chunk becomes a partition with its own mean centroid. No
        point moves to a farther centroid — the partition granularity
        grows where the data is densest, and the padded-leaf kernels'
        l_cap term (paid by EVERY query) drops to the cap exactly.
        Host-side, runs once per build on the straggler tail only."""
        cfg = self.config
        sizes = np.bincount(tokens, minlength=self.centers.shape[0])
        over = np.nonzero(sizes > cap)[0]
        if len(over) == 0:
            return tokens
        tokens = tokens.copy()
        centers = [self.centers.copy()]
        next_tok = self.centers.shape[0]
        for t in over:
            members = np.nonzero(tokens == t)[0]
            x = data[members].astype(np.float32)
            mu = x.mean(axis=0)
            xc = x - mu
            # principal axis via a few power iterations (members are at
            # most a small multiple of cap — host cost is negligible)
            rng = np.random.default_rng(cfg.seed + int(t))
            v = rng.normal(size=x.shape[1]).astype(np.float32)
            for _ in range(8):
                v = xc.T @ (xc @ v)
                nv = float(np.linalg.norm(v))
                if nv < 1e-30:
                    break
                v /= nv
            order = np.argsort(xc @ v, kind="stable")
            n_child = -(-len(members) // cap)
            chunks = np.array_split(order, n_child)
            centers[0][t] = mu + xc[chunks[0]].mean(axis=0)
            for c in chunks[1:]:
                tokens[members[c]] = next_tok
                centers.append((mu + xc[c].mean(axis=0))[None, :])
                next_tok += 1
        self.centers = np.concatenate(centers, axis=0).astype(np.float32)
        self._centers_dev = jnp.asarray(self.centers)
        return tokens

    def _enforce_cap(self, data_dev, tokens: np.ndarray, cap: int) -> np.ndarray:
        """Demote members of oversized partitions to their next-nearest
        center, a few rounds. Within a partition the *lowest-regret* members
        move (smallest distance gap to their next choice — near-boundary
        points lose the least locality). Points that exhaust
        ``cap_enforce_choices`` fallbacks stay put, bounding the final max
        size by cap + stragglers instead of risking livelock.

        The top-r candidate selection is chunked device work (the [N, K]
        matrix never materializes); the demote loop itself is host numpy —
        it runs once per build, and its device formulation needed either a
        multi-million-element scatter or a variadic lexsort, both of which
        XLA compiles pathologically slowly at 5M+ scale (same class as the
        kmeans segment_sum pathology, trees/kmeans.py)."""
        cfg = self.config
        r = min(max(cfg.cap_enforce_choices, 1), self.centers.shape[0])
        rounds = max(cfg.cap_enforce_rounds, 0)
        if rounds == 0 or r <= 1:
            return tokens
        sizes = np.bincount(tokens, minlength=self.centers.shape[0])
        if sizes.max() <= cap:
            return tokens

        # top-r nearest centers per point, chunked (full [N, K] would be GBs);
        # chunk adapts to K — a fixed 131072-row chunk at 16k+ centers is an
        # 8.7 GB [chunk, K] matrix that OOMs next to a multi-GB dataset
        # (measured at 10M x 16k)
        from scann_tpu.trees.kmeans import adaptive_row_chunk

        centers = self.centers_device()
        ch_d, ch_t = [], []
        chunk = adaptive_row_chunk(
            131072, int(data_dev.shape[0]), self.centers.shape[0])
        for lo in range(0, data_dev.shape[0], chunk):
            d, t = select_partitions_kernel(
                centers, data_dev[lo : lo + chunk],
                measure=self.config.distance_measure, p=r)
            ch_d.append(np.asarray(d))
            ch_t.append(np.asarray(t))
        dists = np.concatenate(ch_d, axis=0)        # [N, r] ascending
        choices = np.concatenate(ch_t, axis=0)      # [N, r]
        return demote_to_cap(dists, choices, cap, rounds)

    def _spill_pairs(self, data: np.ndarray, tokens: np.ndarray,
                     threshold: float, chunk: int = 65536) -> np.ndarray:
        """(point, token) rows for 2nd-nearest partitions within the
        distance ratio threshold."""
        from scann_tpu.trees.kmeans import adaptive_row_chunk

        out = []
        centers = jnp.asarray(self.centers)
        chunk = adaptive_row_chunk(chunk, len(data), self.centers.shape[0])
        for lo in range(0, len(data), chunk):
            blk = jnp.asarray(data[lo : lo + chunk])
            d2, t2 = select_partitions_kernel(
                centers, blk, measure=self.config.distance_measure, p=2)
            d2, t2 = np.asarray(d2), np.asarray(t2)
            ok = d2[:, 1] <= d2[:, 0] * (1.0 + threshold)
            pts = np.nonzero(ok)[0] + lo
            out.append(np.stack([pts, t2[ok, 1]], axis=1))
        return np.concatenate(out, axis=0) if out else None

    def _spill_pairs_soar(self, data, tokens: np.ndarray, lam: float,
                          r: int, chunk: int = 65536) -> np.ndarray:
        """One SOAR secondary (point, token) pair for EVERY point: among the
        top-r nearest centers (primary excluded), minimize the
        orthogonality-amplified loss ||x - c_j||^2 + lam * <x - c_j, r1_hat>^2
        with r1 = x - c_primary (Sun, Guo & Kumar, NeurIPS 2023). The
        residual geometry is L2 regardless of search measure (residual PQ
        codes are L2 objects; cosine normalizes upstream)."""
        from scann_tpu.trees.kmeans import adaptive_row_chunk

        centers = self.centers_device()
        r = min(max(r, 2), self.centers.shape[0])
        out = []
        n = data.shape[0] if hasattr(data, "shape") else len(data)
        chunk = adaptive_row_chunk(chunk, n, self.centers.shape[0])
        for lo in range(0, n, chunk):
            blk = jnp.asarray(data[lo: lo + chunk])
            tok = jnp.asarray(tokens[lo: lo + chunk])
            sec = soar_select_kernel(centers, blk, tok, jnp.float32(lam), r=r)
            out.append(np.asarray(sec))
        sec = np.concatenate(out, axis=0)
        return np.stack([np.arange(n, dtype=np.int64), sec], axis=1)

    def _cap_value(self, n: int) -> int:
        """Balance cap, fixed from the CONFIGURED partition count: balance
        rounds split oversized partitions (growing the live K), and
        recomputing from the grown K would shrink the target every round
        (a 32-partition build measured ballooning to 1536 partitions)."""
        cap = self.config.max_partition_size
        if cap == "auto":
            k0 = max(min(self.config.num_partitions, n), 1)
            cap = max(int(1.5 * n / k0), 8)
        return int(cap)

    def _cap_secondaries(self, extra: np.ndarray, tokens: np.ndarray,
                         n: int) -> np.ndarray:
        """Bound secondary assignments per partition by the same cap the
        primaries were balanced to, so spilling cannot re-skew partitions
        the cap-enforce rounds just flattened (secondaries funnel into
        popular central partitions on Zipf-mass data; every query pays
        max_partition_size in l_cap padding). Excess secondaries drop at
        random (seeded) — those points keep their primary assignment."""
        cap = self._cap_value(n)
        prim = np.bincount(tokens, minlength=self.centers.shape[0])
        # room per partition for secondaries: total (primary+secondary)
        # bounded by 2*cap — the primary skew bound carried over to the
        # doubled row count universal spilling implies
        room = np.maximum(2 * cap - prim, 0)
        rng = np.random.default_rng(self.config.seed)
        order = rng.permutation(len(extra))
        toks = extra[order, 1].astype(np.int64)
        # keep the first room[t] secondaries of each token in permuted
        # order: rank = occurrence index within the token group (stable
        # sort preserves the permuted order inside equal tokens) — one
        # vectorized pass instead of a per-secondary Python loop (there is
        # one secondary PER DATABASE POINT under SOAR spilling)
        sorter = np.argsort(toks, kind="stable")
        sorted_toks = toks[sorter]
        grp_start = np.r_[0, np.flatnonzero(np.diff(sorted_toks)) + 1]
        group_first = np.repeat(
            grp_start, np.diff(np.r_[grp_start, len(toks)]))
        rank = np.empty(len(toks), np.int64)
        rank[sorter] = np.arange(len(toks)) - group_first
        keep = np.zeros(len(extra), dtype=bool)
        keep[order] = rank < room[toks]
        return extra[keep]

    def _build_hierarchical(self, data: np.ndarray, k: int) -> "TreePartitioner":
        """num_levels > 1: hierarchical k-means, leaves become partitions
        (reference: tree_partitioner.rs:101-140)."""
        from scann_tpu.trees.kmeans_tree import KMeansTree, KMeansTreeConfig

        cfg = self.config
        # fan-out per level so that children^levels ~ num_partitions
        fan = max(int(np.ceil(k ** (1.0 / cfg.num_levels))), 2)
        tree = KMeansTree(KMeansTreeConfig(
            num_children=fan, max_depth=cfg.num_levels,
            max_iterations=cfg.max_iterations, seed=cfg.seed,
        )).build(data)
        self.tree = tree
        self.centers = tree.leaf_centers().astype(np.float32)
        tokens = tree.leaf_assignments(len(data))
        self.tokenization = DatabaseTokenization(tokens, tree.num_leaves)
        self._centers_dev = jnp.asarray(self.centers)
        return self

    # rows per tokenize device call: bounds the program's own padded copy
    # of its input to ~1 GB at 100d (assign_clusters pads [rows, D] to a
    # chunk multiple INSIDE the program — handing it the whole database in
    # one call duplicates the full [N, D] array: at 20M x 100d a second
    # ~8 GB allocation)
    _TOKENIZE_ROWS = 1 << 21

    def tokenize(self, data: np.ndarray) -> np.ndarray:
        """Assign every row to its nearest centroid — chunked over rows at
        TWO levels: host-level slices cap the per-program input copy (see
        _TOKENIZE_ROWS), and assign_clusters chunks internally so the
        [chunk, K] distance matrix never approaches device memory (a full
        [N, K] matrix at 1M x 8k partitions would be ~37GB)."""
        from scann_tpu.trees.kmeans import assign_clusters

        data = jnp.asarray(data, dtype=jnp.float32)
        cent = jnp.asarray(self.centers)
        n = data.shape[0]
        rows = self._TOKENIZE_ROWS
        if n <= rows:
            tok, _ = jax.jit(assign_clusters)(data, cent)
            return np.asarray(tok).astype(np.int32)
        fn = jax.jit(assign_clusters)
        out = np.empty(n, np.int32)
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            tok, _ = fn(jax.lax.slice_in_dim(data, lo, hi), cent)
            out[lo:hi] = np.asarray(tok)
        return out

    # -- metadata --------------------------------------------------------------
    @property
    def num_partitions(self) -> int:
        return 0 if self.centers is None else self.centers.shape[0]

    def partition_centroid(self, token: int) -> np.ndarray:
        self._check_built()
        return self.centers[token]

    def partition_indices(self, token: int) -> np.ndarray:
        self._check_built()
        return self.tokenization.partition_indices(token)

    def partition_sizes(self) -> np.ndarray:
        self._check_built()
        return self.tokenization.partition_sizes

    def _check_built(self):
        if self.centers is None:
            raise ScannError.failed_precondition("partitioner not built")

    # -- query -----------------------------------------------------------------
    def centers_device(self) -> jnp.ndarray:
        self._check_built()
        if self._centers_dev is None:
            self._centers_dev = jnp.asarray(self.centers)
        return self._centers_dev

    def partition_batch(self, queries: np.ndarray, num_to_search: int) -> List[PartitionResult]:
        self._check_built()
        p = min(int(num_to_search), self.num_partitions)
        if p <= 0:
            raise ScannError.invalid_argument("num_to_search must be positive")
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        dists, toks = select_partitions_kernel(
            self.centers_device(), jnp.asarray(q),
            measure=self.config.distance_measure, p=p,
        )
        dists, toks = np.asarray(dists), np.asarray(toks)
        return [PartitionResult(tokens=t, distances=d) for t, d in zip(toks, dists)]

    def partition(self, query: np.ndarray, num_to_search: int) -> PartitionResult:
        """(reference: tree_partitioner.rs:196-229)."""
        return self.partition_batch(np.asarray(query)[None, :], num_to_search)[0]
