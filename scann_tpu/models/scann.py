"""Unified Scann facade + builder.

Mirrors the reference's top-level entry point
(reference: src/scann.rs:19-56 SearchMode, :60-172 config-driven init,
:364-432 ScannBuilder): the config selects among BruteForce / Partitioned /
Hashed / TreeAH, each backed by the corresponding fused device searcher.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from scann_tpu.config import HashConfig, ScannConfig
from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
from scann_tpu.models.brute_force import BruteForceSearcher
from scann_tpu.models.partitioned import PartitionedSearcher
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu.models.searcher import SearchParameters, Searcher
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.partitioning.tree_partitioner import TreePartitionerConfig


class SearchMode(enum.Enum):
    """(reference: src/scann.rs:19-30)."""

    BRUTE_FORCE = "BruteForce"
    PARTITIONED = "Partitioned"
    HASHED = "Hashed"
    TREE_AH = "TreeAH"


def _hash_to_ah_config(hc: HashConfig, for_tree_ah: bool,
                       measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                       rerank_dtype: str = "float32",
                       ) -> AsymmetricHasherConfig:
    """HashConfig(num_buckets, num_blocks) -> AH(num_codes, num_subspaces).

    For tree-AH the reference's production setting is 16-code (LUT16) blocks;
    standalone hashing defaults to 256 codes (reference: config.rs:221-230,
    hasher.rs:30-40). ``rerank_dtype`` carries the exact-reordering copy
    dtype into standalone HASHED mode (tree-AH threads its own via
    TreeXHybridConfig.rerank_dtype)."""
    return AsymmetricHasherConfig(
        num_codes=int(hc.num_buckets),
        num_subspaces=int(hc.num_blocks),
        training_sample_size=int(hc.training_sample_size),
        seed=42,
        distance_measure=measure,
        anisotropic_threshold=hc.anisotropic_threshold,
        rerank_dtype=rerank_dtype,
    )


# Crossover constants live in the per-device profile
# (utils/chip_profile.py; override with SCANN_TPU_CHIP_PROFILE=/path.json
# or re-measure with chip_profile.calibrate). These module constants are
# the ChipProfile defaults that the CPU test profile uses, kept for callers
# that import them; they measure nothing.
AUTO_SWEEP_MAX_N = 6_000_000
AUTO_F32_RERANK_MAX_BYTES = 5 * 1024**3


def _rerank_dtype_of(r) -> str:
    """Rerank-copy dtype an ExactReorderingConfig selects: an explicit
    rerank_dtype wins; the reference's quantized flag (config.rs:290-318)
    maps to int8 when no explicit dtype was set."""
    if r is None:
        return "float32"
    if r.quantized and r.rerank_dtype == "float32":
        return "int8"
    return r.rerank_dtype


def _tree_cfg_of(config: ScannConfig) -> TreeXHybridConfig:
    """ScannConfig (partitioning + hash [+ reordering]) -> the
    TreeXHybridConfig the facade builds with — shared by the single-device
    constructor branch and the mesh-aware sharded build routing."""
    p = config.partitioning
    cfg = TreeXHybridConfig(
        num_partitions=int(p.num_partitions),
        partitions_to_search=int(p.num_partitions_to_search),
        hash_config=_hash_to_ah_config(config.hash, for_tree_ah=True),
        distance_measure=config.distance_measure,
        spilling=bool(p.spilling),
        spilling_threshold=float(p.spilling_threshold),
        spilling_mode=str(p.spilling_mode),
        soar_lambda=float(p.soar_lambda),
        max_partition_size=p.max_partition_size,
        split_stragglers=bool(p.split_stragglers),
        partition_max_iterations=int(p.max_training_iterations),
        partition_convergence_threshold=float(p.convergence_threshold),
        partition_num_levels=int(p.num_levels),
        partition_training_sample_size=p.training_sample_size,
    )
    if config.exact_reordering is not None:
        cfg.pre_reorder_multiplier = max(
            float(config.exact_reordering.num_candidates)
            / max(config.num_neighbors, 1),
            1.0,
        )
        cfg.rerank_dtype = _rerank_dtype_of(config.exact_reordering)
    return cfg


def auto_config(n: int, dim: int,
                measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                force_tree: bool = False,
                ) -> ScannConfig:
    """Pick an architecture from dataset scale (an extension; the reference
    always requires an explicit mode, scann.rs:60-103).

    Up to a device-dependent size the bf16 block-min sweep + exact re-rank
    wins at serving batch sizes and is immune to cluster skew because it
    streams the whole database; past that the sweep's per-batch cost keeps
    growing linearly with N while tree-×-AH's stays ~flat, so the tree
    becomes the only fast (and, past the memory ceiling for two database
    copies, the only possible) option. Partition count targets ~600
    points/partition (1.18M points -> 2000 partitions).

    The crossover constants come from the chip profile
    (utils/chip_profile.load_profile): override per deployment with
    SCANN_TPU_CHIP_PROFILE or re-measure with chip_profile.calibrate().
    """
    from scann_tpu.utils.chip_profile import load_profile

    prof = load_profile()
    cfg = ScannConfig(distance_measure=measure)
    if n <= prof.sweep_max_n and not force_tree:
        cfg.with_brute_force()
        cfg.brute_force.block_sweep = True
        return cfg
    dens = max(int(prof.partition_density), 1)
    parts = int(min(max(256, round(n / dens / 256) * 256), 65536))
    cfg.with_partitioning()
    cfg.partitioning.num_partitions = parts
    cfg.partitioning.num_partitions_to_search = 10
    cfg.with_hashing()
    cfg.hash.num_buckets = 16   # LUT16 production path
    # aim for ~2 dims/subspace (the codebook requires divisibility,
    # hashes/codebook.py): pick the divisor of dim whose dims-per-subspace
    # is closest to 2. Prime dims get dim subspaces of 1 dim each (16-code
    # per-dim quantization) — NOT one whole-vector subspace, which carries
    # almost no information and silently collapses recall at scale.
    blocks = min((s for s in range(1, dim + 1) if dim % s == 0),
                 key=lambda s: (abs(dim / s - 2), -s), default=1)
    cfg.hash.num_blocks = max(blocks, 1)
    cfg.with_reordering()
    cfg.exact_reordering.num_candidates = 150
    if n * dim * 4 > prof.f32_rerank_max_bytes:
        # past the profile's budget the f32 rerank copy plus codes and
        # centroids crowds the device: bf16 halves the copy at a small
        # recall cost (docs/DESIGN.md "Device memory at scale").
        cfg.exact_reordering.rerank_dtype = "bfloat16"
    return cfg


class Scann(Searcher):
    """Config-driven searcher facade."""

    def __init__(self, dataset: DenseDataset, config: Optional[ScannConfig] = None,
                 _impl: Optional[Searcher] = None,
                 _mode: Optional[SearchMode] = None):
        """``_impl``/``_mode`` are internal: a pre-built implementation
        (the mesh-aware ``auto()`` builds sharded searchers outside this
        constructor) — the facade then only wires delegation around it."""
        config = config or ScannConfig()
        if dataset.is_empty:
            raise ScannError.invalid_argument("Dataset cannot be empty")
        self._dataset = dataset
        self._config = config
        self._auto_decision = None
        if _impl is not None:
            self._impl = _impl
            self.search_mode = _mode or SearchMode.TREE_AH
            return
        measure = config.distance_measure

        if config.brute_force is not None and config.brute_force.block_sweep:
            from scann_tpu.models.block_sweep import (
                BlockSweepConfig,
                BlockSweepSearcher,
            )

            # an explicit ExactReorderingConfig wins for the rerank depth
            # (same precedence as the HASHED branch's default pre_k)
            pre_k = (int(config.exact_reordering.num_candidates)
                     if config.exact_reordering is not None
                     else int(config.brute_force.block_sweep_pre_k))
            self._impl = BlockSweepSearcher(dataset, BlockSweepConfig(
                distance_measure=measure,
                pre_reorder_k=pre_k,
                sweep_dtype=config.brute_force.block_sweep_dtype,
                top2=bool(getattr(config.brute_force,
                                  "block_sweep_top2", False)),
                rerank_dtype=_rerank_dtype_of(config.exact_reordering)))
            self.search_mode = SearchMode.BRUTE_FORCE
        elif config.brute_force is not None and config.brute_force.scalar_quantization:
            self._impl: Searcher = ScalarQuantizedBruteForceSearcher(
                dataset,
                ScalarQuantizedConfig(
                    distance_measure=measure,
                    storage="int4" if config.brute_force.quantization_bits == 4 else "int8",
                ),
            )
            self.search_mode = SearchMode.BRUTE_FORCE
        elif config.partitioning is not None and config.hash is not None:
            self._impl = TreeXHybridSearcher(
                _tree_cfg_of(config)).build(dataset)
            self.search_mode = SearchMode.TREE_AH
        elif config.partitioning is not None:
            p = config.partitioning
            self._impl = PartitionedSearcher(
                dataset,
                config=TreePartitionerConfig(
                    num_partitions=int(p.num_partitions),
                    max_iterations=int(p.max_training_iterations),
                    convergence_threshold=float(p.convergence_threshold),
                    num_levels=int(p.num_levels),
                    distance_measure=measure,
                    training_sample_size=p.training_sample_size,
                    spilling=bool(p.spilling),
                    spilling_threshold=float(p.spilling_threshold),
                    spilling_mode=str(p.spilling_mode),
                    soar_lambda=float(p.soar_lambda),
                    max_partition_size=p.max_partition_size,
                    split_stragglers=bool(p.split_stragglers),
                ),
                num_partitions_to_search=int(p.num_partitions_to_search),
                distance_measure=measure,
            )
            self.search_mode = SearchMode.PARTITIONED
        elif config.hash is not None:
            self._impl = AsymmetricHasher(
                _hash_to_ah_config(
                    config.hash, for_tree_ah=False, measure=measure,
                    rerank_dtype=_rerank_dtype_of(config.exact_reordering))
            ).build(dataset)
            self.search_mode = SearchMode.HASHED
        else:
            self._impl = BruteForceSearcher(dataset, measure)
            self.search_mode = SearchMode.BRUTE_FORCE

    # -- constructors matching the reference (scann.rs:106-172) -------------
    @classmethod
    def brute_force(cls, dataset: DenseDataset,
                    measure: DistanceMeasure = DistanceMeasure.SQUARED_L2) -> "Scann":
        return cls(dataset, ScannConfig(distance_measure=measure).with_brute_force())

    @classmethod
    def partitioned(cls, dataset: DenseDataset, num_partitions: int,
                    partitions_to_search: int) -> "Scann":
        cfg = ScannConfig()
        cfg.with_partitioning()
        cfg.partitioning.num_partitions = num_partitions
        cfg.partitioning.num_partitions_to_search = partitions_to_search
        return cls(dataset, cfg)

    @classmethod
    def hashed(cls, dataset: DenseDataset, num_blocks: int) -> "Scann":
        cfg = ScannConfig().with_hashing()
        cfg.hash.num_blocks = num_blocks
        return cls(dataset, cfg)

    @classmethod
    def auto(cls, dataset: DenseDataset,
             measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
             target_recall: Optional[float] = None,
             tune_queries: Optional[np.ndarray] = None,
             seed: int = 0, mesh=None) -> "Scann":
        """Architecture + build knobs chosen from dataset scale, the chip
        profile, and (when a ``target_recall`` is given) cheap data
        statistics — SOAR / balance caps turn on when a sample shows the
        cluster-mass skew that collapses 1-assignment recall
        (utils/advisor.py).

        With ``target_recall`` set, serving parameters are then autotuned
        on ``tune_queries`` (default: a sample of the dataset itself) and
        become the searcher's defaults, so ``search_batched_arrays``
        without explicit params meets the target out of the box — no
        hand-set knobs anywhere (the reference's own defaults reach
        0.23-0.41 recall, README.md:713-716).

        ``mesh`` (a jax.sharding.Mesh over a "db" axis) makes the choice
        MESH-AWARE: past the one-chip serving budget
        (chip profile ``f32_rerank_max_bytes``, the rerank copy being the
        dominant allocation) auto() forces the tree architecture, builds
        it END-TO-END over the mesh (sharded_tree_ah_build — the database
        only ever row-sharded), and returns the sharded wrapper; within
        budget, the mesh is noted but the single-chip build is kept (it
        has no merge overhead). The decision is stamped in
        :meth:`describe`.
        """
        n, dim = dataset.size, dataset.dimensionality
        rng = np.random.default_rng(seed)
        data = None
        if target_recall is None:
            cfg = auto_config(n, dim, measure)
        else:
            from scann_tpu.utils.advisor import advise_config

            data = dataset.numpy()
            sample_idx = rng.choice(n, min(n, 20_000), replace=False)
            cfg = advise_config(n, dim, data[sample_idx], measure,
                                target_recall, seed=seed)
            cfg.num_neighbors = 10

        self = None
        if mesh is not None and mesh.devices.size > 1:
            from scann_tpu.utils.chip_profile import load_profile

            prof = load_profile()
            rdt = _rerank_dtype_of(cfg.exact_reordering)
            itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[rdt]
            serving_bytes = n * dim * itemsize
            budget = int(prof.f32_rerank_max_bytes)
            shards_needed = max(1, -(-serving_bytes // budget))
            if shards_needed > 1:
                if cfg.partitioning is None or cfg.hash is None:
                    # over one-chip budget: the sweep's two database
                    # copies bind even harder — force the tree
                    cfg = auto_config(n, dim, measure, force_tree=True)
                from scann_tpu.parallel.sharded_flagship import (
                    ShardedTreeXHybridSearcher,
                )

                n_dev = int(mesh.devices.size)
                impl = ShardedTreeXHybridSearcher.build(
                    dataset, _tree_cfg_of(cfg), mesh)
                self = cls(dataset, cfg, _impl=impl,
                           _mode=SearchMode.TREE_AH)
                self._auto_decision = {
                    "sharded": True, "shards": n_dev,
                    "shards_needed": int(shards_needed),
                    "serving_bytes": int(serving_bytes),
                    "per_chip_budget": budget,
                    "reason": "serving bytes exceed one-chip budget",
                }
        if self is None:
            self = cls(dataset, cfg)
            if mesh is not None:
                self._auto_decision = {
                    "sharded": False,
                    "reason": "fits one chip; single-device build kept",
                }
        if target_recall is None:
            return self
        if data is None:
            data = dataset.numpy()
        if tune_queries is None:
            tune_queries = data[rng.choice(n, min(n, 256), replace=False)]
        from scann_tpu.utils.autotune import autotune

        res = autotune(self, np.asarray(tune_queries, np.float32),
                       k=cfg.num_neighbors, target_recall=target_recall)
        self.default_params = res.params
        self.autotune_result = res
        return self

    def describe(self) -> dict:
        """Architecture + decision report (the reference has no analog —
        its modes are always explicit, scann.rs:60-103)."""
        out = {
            "search_mode": self.search_mode.value,
            "impl": type(self._impl).__name__,
            "n": self.dataset_size(),
            "dim": self.dimensionality(),
            "distance_measure": self._config.distance_measure.value,
        }
        if getattr(self, "_auto_decision", None):
            out["auto"] = dict(self._auto_decision)
        if getattr(self, "autotune_result", None) is not None:
            out["autotuned_params"] = str(self.autotune_result.params)
        return out

    # -- delegation -----------------------------------------------------------
    @property
    def config(self) -> ScannConfig:
        return self._config

    @property
    def impl(self) -> Searcher:
        return self._impl

    def distance_measure(self) -> DistanceMeasure:
        return self._config.distance_measure

    def dataset_size(self) -> int:
        return self._dataset.size

    @property
    def size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def search_batched_arrays(self, queries: np.ndarray, k: Optional[int] = None,
                              params: Optional[SearchParameters] = None,
                              query_config=None):
        """``query_config`` (config.QueryConfig) carries per-query
        overrides — the reference declares this struct but never consumes
        it; here it maps onto SearchParameters (explicit ``params`` and
        ``k`` win over it)."""
        if query_config is not None:
            qp = query_config.to_search_parameters()
            if k is None:
                k = qp.num_neighbors
            if params is None:
                params = qp
        if params is None:
            # Scann.auto(target_recall=...) stashes the autotuned serving
            # parameters here; explicit params always win
            params = getattr(self, "default_params", None)
        k = k if k is not None else self._config.num_neighbors
        # default reordering depth from the config for approximate modes —
        # also when params came from a query_config that left the depth
        # unset (otherwise any per-query override silently disables the
        # configured exact reordering)
        if (self._config.exact_reordering is not None
                and self.search_mode == SearchMode.HASHED):
            if params is None:
                params = SearchParameters()
            if params.pre_reordering_num_neighbors is None:
                params = dataclasses.replace(
                    params,
                    pre_reordering_num_neighbors=(
                        self._config.exact_reordering.num_candidates))
        return self._impl.search_batched_arrays(queries, k, params)


class ScannBuilder:
    """Fluent builder (reference: src/scann.rs:364-432)."""

    def __init__(self):
        self._config = ScannConfig()

    def num_neighbors(self, k: int) -> "ScannBuilder":
        self._config.num_neighbors = k
        return self

    def distance_measure(self, measure: DistanceMeasure) -> "ScannBuilder":
        self._config.distance_measure = measure
        return self

    def brute_force(self) -> "ScannBuilder":
        self._config.with_brute_force()
        return self

    def tree(self, num_partitions: int, partitions_to_search: int) -> "ScannBuilder":
        self._config.with_partitioning()
        self._config.partitioning.num_partitions = num_partitions
        self._config.partitioning.num_partitions_to_search = partitions_to_search
        return self

    def hash(self, num_blocks: int, num_buckets: int = 256) -> "ScannBuilder":
        self._config.with_hashing()
        self._config.hash.num_blocks = num_blocks
        self._config.hash.num_buckets = num_buckets
        return self

    def reorder(self, num_candidates: int) -> "ScannBuilder":
        self._config.with_reordering()
        self._config.exact_reordering.num_candidates = num_candidates
        return self

    def auto(self) -> "ScannBuilder":
        """Defer the architecture choice to dataset scale at build time."""
        self._auto = True
        return self

    def build(self, dataset: DenseDataset) -> Scann:
        if getattr(self, "_auto", False):
            cfg = auto_config(dataset.size, dataset.dimensionality,
                              self._config.distance_measure)
            cfg.num_neighbors = self._config.num_neighbors
            return Scann(dataset, cfg)
        return Scann(dataset, self._config)
