"""MIPS (maximum-inner-product) search with the two score-aware extensions:

- anisotropic PQ training (Guo et al. 2020) via ``anisotropic_threshold``
- SOAR secondary assignments (Sun et al. 2023) via ``with_soar()``

Both are extensions beyond the reference (which trains plain
reconstruction-loss PQ and never implements spilling). Run:

    PYTHONPATH=. python examples/mips_avq_soar.py
"""

import numpy as np

from scann_tpu import DenseDataset
from scann_tpu.config import ExactReorderingConfig, ScannConfig
from scann_tpu.models.brute_force import BruteForceSearcher
from scann_tpu.models.scann import Scann
from scann_tpu.ops.distances import DistanceMeasure

rng = np.random.default_rng(42)
N, D, B, K = 50_000, 64, 128, 10

# clustered corpus with heavy-tailed norms: realistic embedding shape, and
# the regime where score-aware quantization visibly helps inner products
centers = rng.standard_normal((200, D), dtype=np.float32) * 3.0
a = rng.integers(0, 200, N)
db = centers[a] + rng.standard_normal((N, D), dtype=np.float32)
db *= np.exp(rng.standard_normal((N, 1)) * 0.3).astype(np.float32)
aq = rng.integers(0, 200, B)
queries = centers[aq] + rng.standard_normal((B, D), dtype=np.float32)
ds = DenseDataset(db)

gt, _ = BruteForceSearcher(ds, DistanceMeasure.DOT_PRODUCT).search_batched_arrays(
    queries, K)


def recall(idx):
    return float(np.mean([len(set(a) & set(g)) / K for a, g in zip(idx, gt)]))


cfg = ScannConfig(num_neighbors=K,
                  distance_measure=DistanceMeasure.DOT_PRODUCT)
cfg.with_partitioning().with_hashing()
cfg.partitioning.num_partitions = 256
cfg.partitioning.num_partitions_to_search = 32
cfg.partitioning.with_soar(soar_lambda=1.0)     # 2x assignments, better tail
cfg.hash.num_buckets = 16                        # LUT16 codes
cfg.hash.num_blocks = 32
cfg.hash.anisotropic_threshold = 0.2             # score-aware codebooks
cfg.with_reordering(ExactReorderingConfig(num_candidates=100))  # re-rank depth

searcher = Scann(ds, cfg)
idx, dists = searcher.search_batched_arrays(queries, K)
print(f"tree-AH + AVQ + SOAR: recall@{K} = {recall(idx):.4f}")
print("top neighbors of query 0:", idx[0].tolist())
