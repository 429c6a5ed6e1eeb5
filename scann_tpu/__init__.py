"""scann_tpu — an approximate-nearest-neighbor index & query engine in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of the Rust
ScaNN port (reference: sunbains/scann-rust). The design is arrays + pure
functions: an *index* is a pytree of device arrays (database tiles, centroids,
codebooks, packed PQ codes, CSR partition tables, norms) plus a small host-side
metadata object; *searchers* are jit-compiled functions
``(index, query_batch) -> (indices, distances)``; *builders* are jit-compiled
training programs (k-means, PQ codebook training) that run on the device.

Key departures from the reference (reference: src/lib.rs:1-135):
  - Batched distance computation is a matrix product + fused ``lax.top_k``
    instead of AVX2 one-to-many loops (reference: src/simd/x86.rs).
  - LUT16 asymmetric-hash scoring is a one-hot matrix product, grouped by
    partition for tree-×-AH (reference: src/hashes/lut16_simd.rs).
  - Thread-level parallelism (rayon) is replaced by the query-batch dimension
    and ``shard_map`` database sharding over a device mesh
    (reference: src/utils/parallel.rs).

Runs on an NVIDIA GPU (hand-written kernels where they won their
measurement, see PERF.md) or on the CPU (plain jax.numpy formulations, for
tests); ``types.platform()`` is the one dispatch.
"""

import os as _os

import jax as _jax


def compile_cache_dir():
    """Where this package keeps XLA's persistent compilation cache, or None
    when it sets none: a set ``JAX_COMPILATION_CACHE_DIR`` is JAX's own and
    wins; ``SCANN_TPU_COMPILE_CACHE=0`` opts out (the tests do); otherwise a
    fixed path inside the checkout, ``<repo>/.jax_cache`` (a fixed path,
    because the path is part of the cache's key)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if _os.environ.get("SCANN_TPU_COMPILE_CACHE") == "0":
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from scann_tpu.errors import ErrorCode, ScannError
from scann_tpu.config import (
    ScannConfig,
    BruteForceConfig,
    PartitioningConfig,
    HashConfig,
    ExactReorderingConfig,
    QueryConfig,
)
from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.data.dataset import DenseDataset, SparseDataset
from scann_tpu.data.docid import DocIdCollection
from scann_tpu.models.searcher import SearchParameters, SearchResult, NNResult
from scann_tpu.models.brute_force import BruteForceSearcher
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher
from scann_tpu.models.partitioned import PartitionedSearcher
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.models.scann import Scann, ScannBuilder, SearchMode, auto_config
from scann_tpu.models.sparse_brute_force import SparseBruteForceSearcher
from scann_tpu.io import (
    load_index,
    load_sharded_layout,
    save_index,
    save_sharded_layout,
)
from scann_tpu.utils.advisor import advise_build, advise_config, dataset_stats
from scann_tpu.utils.autotune import (
    AutotuneResult,
    SweepAutotuneResult,
    autotune,
    autotune_block_sweep,
)
from scann_tpu.utils.chip_profile import ChipProfile, calibrate, load_profile

__version__ = "0.1.0"

__all__ = [
    "ErrorCode",
    "ScannError",
    "ScannConfig",
    "BruteForceConfig",
    "PartitioningConfig",
    "HashConfig",
    "ExactReorderingConfig",
    "QueryConfig",
    "DistanceMeasure",
    "DenseDataset",
    "SparseDataset",
    "DocIdCollection",
    "SearchParameters",
    "SearchResult",
    "NNResult",
    "BruteForceSearcher",
    "ScalarQuantizedBruteForceSearcher",
    "ScalarQuantizedConfig",
    "BlockSweepConfig",
    "BlockSweepSearcher",
    "PartitionedSearcher",
    "TreeXHybridConfig",
    "TreeXHybridSearcher",
    "Scann",
    "auto_config",
    "ScannBuilder",
    "SearchMode",
    "SparseBruteForceSearcher",
    "save_index",
    "load_index",
    "save_sharded_layout",
    "load_sharded_layout",
    "autotune",
    "AutotuneResult",
    "autotune_block_sweep",
    "SweepAutotuneResult",
    "advise_build",
    "advise_config",
    "dataset_stats",
    "ChipProfile",
    "calibrate",
    "load_profile",
]
