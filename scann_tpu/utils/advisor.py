"""Build-knob advisor: pick index-build knobs from cheap data statistics.

The measured lever on adversarial (GloVe-shaped) data is partition-mass
skew: Zipf cluster mass collapses tree-AH recall at matched p (0.9965 ->
0.90) and inflates l_cap, and SOAR secondary assignments are the measured
mitigation (SOAR p=30 reaches recall the 1-assignment build cannot reach
at any measured p). The
reference leaves every one of these knobs to the user (its own defaults
reach 0.23-0.41 recall, reference: README.md:713-716).

``advise_build`` clusters a small sample, measures the mass skew, and
returns the tree-AH build knobs (SOAR on/off, partition count, balance
cap); ``advise_config`` composes that with the chip profile's crossover
into a full ScannConfig — the path ``Scann.auto()`` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from scann_tpu.ops.distances import DistanceMeasure


@dataclasses.dataclass
class DataStats:
    """Cheap sample statistics that drive the build knobs."""

    n_sample: int
    n_clusters: int
    # fraction of sample mass in the top 10% of clusters (0.1 = uniform;
    # Zipf s=1.07 at 128 clusters measures ~0.35)
    top_decile_mass: float
    # max cluster mass / mean cluster mass (1.0 = uniform)
    max_over_mean: float
    # coefficient of variation of point norms (heavy-tailed-norm indicator)
    norm_cv: float

    @property
    def skewed(self) -> bool:
        """Measured discrimination (6000-row samples, 120 sample
        clusters): the adversarial generator scores top-decile 0.31 /
        max-mean 5.8 / norm_cv 0.39; uniform-mass clustered data 0.24 /
        3.8 / 0.12; pure uniform 0.13 / 1.4 / 0.09. k-means
        over-segmentation inflates mass skew even on uniform-mass data,
        so the mass cut sits above that floor and the norm spread (which
        over-segmentation does NOT inflate) is an independent trigger."""
        return (self.top_decile_mass > 0.26 or self.max_over_mean > 4.5
                or self.norm_cv > 0.25)


def dataset_stats(sample: np.ndarray, n_clusters: Optional[int] = None,
                  seed: int = 0) -> DataStats:
    """Cluster ``sample`` (a few thousand rows) and measure mass skew.

    Cost: one small k-means — milliseconds on device, well under any
    build. The cluster count defaults to sample_size/50 so each cluster
    averages ~50 points (enough mass resolution for the decile statistic).
    """
    from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit

    sample = np.asarray(sample, np.float32)
    n = len(sample)
    if n < 64:
        return DataStats(n, 1, 0.1, 1.0, 0.0)
    k = n_clusters or max(min(n // 50, 256), 8)
    res = KMeans(KMeansConfig(
        num_clusters=k, max_iterations=20, seed=seed,
        init_method=KMeansInit.KMEANS_PLUS_PLUS)).fit(sample)
    sizes = np.sort(np.asarray(res.cluster_sizes, np.float64))[::-1]
    mass = sizes / max(sizes.sum(), 1.0)
    top_dec = float(mass[: max(len(mass) // 10, 1)].sum())
    max_over_mean = float(sizes[0] / max(sizes.mean(), 1e-9))
    norms = np.linalg.norm(sample, axis=1)
    norm_cv = float(norms.std() / max(norms.mean(), 1e-9))
    return DataStats(n, k, top_dec, max_over_mean, norm_cv)


@dataclasses.dataclass
class BuildAdvice:
    num_partitions: int
    spilling: bool           # SOAR secondary assignments
    spilling_mode: str
    max_partition_size: object   # "auto" = 1.5x-mean cap
    split_stragglers: bool
    partitions_to_search: int
    pre_reorder_k: int
    stats: DataStats

    def apply_to(self, cfg) -> None:
        """Write the knobs into a TreeXHybridConfig in place."""
        cfg.num_partitions = self.num_partitions
        cfg.partitions_to_search = self.partitions_to_search
        cfg.spilling = self.spilling
        cfg.spilling_mode = self.spilling_mode
        cfg.max_partition_size = self.max_partition_size
        cfg.split_stragglers = self.split_stragglers


def advise_build(n: int, dim: int, sample: np.ndarray,
                 target_recall: Optional[float] = None,
                 seed: int = 0,
                 stats: Optional[DataStats] = None) -> BuildAdvice:
    """Tree-AH build knobs from data statistics.

    - partition count targets the chip profile's measured density
      (~600 points/partition);
    - SOAR turns ON when the sample's cluster mass is skewed OR the recall
      target is >= 0.99 (the measured regimes where 1-assignment recall
      saturates below target);
    - the balance cap + straggler split stay on (pure win on skewed data:
      +20-28% QPS for <=1pp recall);
    - on skewed data ``partitions_to_search`` scales with the partition
      count, NOT a constant: recall at matched probe FRACTION is
      scale-invariant (measured: 1.5% of partitions gives 0.9909 at
      1.18M/2000 parts and 0.9892 at 10M/16k parts; a constant p=30 that
      hit 0.99 at 1.18M probes only 0.19% at 16k and caps at 0.927). The
      fraction maps from
      the target: ~1.5% for >=0.99, ~0.6% for 0.97 (measured 0.9722),
      ~0.4% for 0.95 (measured 0.9595). Friendly clustered data keeps
      constant p~10 (queries land on their centroid: 0.9935 at 10M/16k).
    """
    from scann_tpu.utils.chip_profile import load_profile

    prof = load_profile()
    if stats is None:
        stats = dataset_stats(sample, seed=seed)
    dens = max(int(prof.partition_density), 1)
    parts = int(min(max(256, round(n / dens / 256) * 256), 65536))
    if n < 256 * dens:
        parts = max(n // dens, 16)
    want_soar = stats.skewed or (target_recall is not None
                                 and target_recall >= 0.99)
    if want_soar:
        tr = 0.99 if target_recall is None else target_recall
        frac = 0.015 if tr >= 0.99 else 0.006 if tr >= 0.97 else 0.004
        p = max(30, int(np.ceil(frac * parts)))
        pre_k = max(300, int(np.ceil(p * 10 / 3)))
    else:
        p, pre_k = 10, 150
    return BuildAdvice(
        num_partitions=parts,
        spilling=want_soar,
        spilling_mode="soar",
        max_partition_size="auto",
        split_stragglers=True,
        partitions_to_search=p,
        pre_reorder_k=pre_k,
        stats=stats,
    )


def advise_config(n: int, dim: int, sample: np.ndarray,
                  measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                  target_recall: Optional[float] = None,
                  seed: int = 0):
    """Full ScannConfig from scale + data statistics + chip profile —
    ``auto_config``'s architecture assembly (shared, not duplicated) with
    the data-dependent knobs overridden from the sample statistics."""
    from scann_tpu.models.scann import auto_config
    from scann_tpu.utils.chip_profile import load_profile

    stats = dataset_stats(sample, seed=seed)
    cfg = auto_config(n, dim, measure)
    skew_sweep = False
    if cfg.brute_force is None and stats.skewed:
        # The skewed regime BETWEEN sweep_max_n and the sweep's memory
        # ceiling: under Zipf skew tree-AH must probe a large fraction of
        # its partitions to reach >=0.99, while the sweep's stream cost is
        # distribution-independent and its recall skew-immune (it scores
        # every row). Route skewed data to the sweep with compact copies
        # (int8 stream + bf16 rerank rows) until ~half of device memory is
        # copies; only past that does the tree become the
        # capacity-mandated choice.
        from scann_tpu.ops.sweep_pallas import augmented_dim

        prof = load_profile()
        hbm = 3 * prof.f32_rerank_max_bytes
        ceil_n = int(0.5 * hbm / (augmented_dim(dim, extra=3) + 2 * dim))
        if n <= ceil_n:
            from scann_tpu.config import ScannConfig

            cfg = ScannConfig(distance_measure=measure)
            cfg.with_brute_force()
            cfg.brute_force.block_sweep = True
            cfg.brute_force.block_sweep_dtype = "int8"
            skew_sweep = True
    if cfg.brute_force is not None:
        # the sweep is skew-immune (it streams everything): the knobs that
        # matter are the rerank depth and — for >=0.99 targets on
        # near-duplicate-heavy data — top2, which removes the
        # one-candidate-per-block collision ceiling
        cfg.brute_force.block_sweep_top2 = (target_recall or 0) >= 0.99
        cfg.with_reordering()
        cfg.exact_reordering.num_candidates = (
            100 if (target_recall or 0) >= 0.99 else 64)
        if skew_sweep:
            # the two-copy HBM budget above assumed bf16 rerank rows
            cfg.exact_reordering.rerank_dtype = "bfloat16"
        return cfg
    adv = advise_build(n, dim, sample, target_recall, seed=seed,
                       stats=stats)
    cfg.partitioning.num_partitions = adv.num_partitions
    cfg.partitioning.num_partitions_to_search = adv.partitions_to_search
    cfg.partitioning.spilling = adv.spilling
    cfg.partitioning.spilling_mode = adv.spilling_mode
    cfg.partitioning.max_partition_size = adv.max_partition_size
    cfg.partitioning.split_stragglers = adv.split_stragglers
    cfg.exact_reordering.num_candidates = adv.pre_reorder_k
    return cfg
