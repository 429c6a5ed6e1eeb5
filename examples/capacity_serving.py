"""Serving past the f32 memory budget: low-precision rerank copies.

The exact-rerank database copy is the dominant serving allocation of every
re-ranking searcher; past the device profile's ``f32_rerank_max_bytes``
the f32 copy no longer fits beside the index (docs/DESIGN.md "Device memory
at scale"). `rerank_dtype` stores that copy as bf16 (half, ~0.5pp recall@10) or
calibrated int8 (quarter — the reference declares quantized reordering at
config.rs:290-318 but never implements it); `Scann.auto()` flips to bf16
automatically past the budget, and `DenseDataset.drop_device_cache()`
frees the f32 build copy once serving starts.

Run (small shapes so it works anywhere):
    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/capacity_serving.py
"""
import numpy as np

from scann_tpu import DenseDataset, SearchParameters
from scann_tpu.hashes.hasher import AsymmetricHasherConfig
from scann_tpu.models.scann import auto_config
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher

rng = np.random.default_rng(0)
centers = rng.normal(size=(64, 96)).astype(np.float32) * 3
db = (centers[rng.integers(0, 64, 20_000)]
      + rng.normal(size=(20_000, 96))).astype(np.float32)
queries = (centers[rng.integers(0, 64, 64)]
           + rng.normal(size=(64, 96))).astype(np.float32)

from scann_tpu import BruteForceSearcher

gt, _ = BruteForceSearcher(DenseDataset(db)).search_batched_arrays(queries, 10)

for rdt in ("float32", "bfloat16", "int8"):
    ds = DenseDataset(db)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=64, partitions_to_search=12, rerank_dtype=rdt,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=24,
                                           seed=7),
    )).build(ds)
    if rdt != "float32":
        ds.drop_device_cache()   # serving keeps only the low-precision copy
    idx, _ = s.search_batched_arrays(
        queries, 10, SearchParameters(pre_reordering_num_neighbors=150))
    recall = np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)])
    print(f"rerank_dtype={rdt:9s} recall@10={recall:.4f}")

# auto() picks the copy dtype from scale: f32 below the budget, bf16 above
print("auto @ 8M  x 100d ->", auto_config(8_000_000, 100).exact_reordering.rerank_dtype)
print("auto @ 20M x 100d ->", auto_config(20_000_000, 100).exact_reordering.rerank_dtype)
