"""Multi-device scale-out over a device mesh.

The reference's only parallelism is rayon threads in one address space
(reference: src/utils/parallel.rs, SURVEY §2.6). The device analog:

  - **database sharding** (model-parallel-like): the [N, D] rows, PQ codes
    and partition tables shard along N across chips; per-shard top-k partials
    merge with an ``all_gather`` across devices + final top-k.
  - **query-batch data parallelism**: the batch dimension shards across a
    second mesh axis.

Everything here is expressed with ``jax.sharding.Mesh`` + ``shard_map`` so a
single program spans the mesh and XLA inserts the collectives.
"""

from scann_tpu.parallel.mesh import make_mesh, shard_rows, replicate
from scann_tpu.parallel.sharded import (
    ShardedBruteForceSearcher,
    sharded_kmeans_step,
    sharded_search_kernel,
)
from scann_tpu.parallel.sharded_flagship import (
    ShardedAsymmetricHasher,
    ShardedBlockSweepSearcher,
    ShardedTreeXHybridSearcher,
)

__all__ = [
    "make_mesh",
    "shard_rows",
    "replicate",
    "ShardedBruteForceSearcher",
    "ShardedAsymmetricHasher",
    "ShardedBlockSweepSearcher",
    "ShardedTreeXHybridSearcher",
    "sharded_kmeans_step",
    "sharded_search_kernel",
]
