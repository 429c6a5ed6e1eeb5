"""Worker process for the multi-host (DCN-analog) test.

Run as: python multihost_worker.py <process_id> <num_processes> <port>

Each process owns 2 virtual CPU devices; jax.distributed + gloo CPU
collectives form the global 2x2-device "cluster". The database rows are
sharded across ALL processes' devices (each process materializes only its
own shard — the beyond-RAM loading contract of
scann_tpu.parallel.multihost.process_local_rows), queries are replicated,
and the sharded exact-search kernel's all-gather top-k merge crosses the
process boundary, exercising the real multi-process collective path that
single-process mesh tests cannot.
"""

import os
import sys

proc_id, num_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SCANN_TPU_COMPILE_CACHE"] = "0"

import jax
from jax._src import xla_bridge

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
xla_bridge._clear_backends()

import numpy as np

from scann_tpu.parallel.multihost import (
    global_mesh,
    initialize_multihost,
    process_local_rows,
)

got = initialize_multihost(f"localhost:{port}", num_procs, proc_id)
assert got == proc_id, (got, proc_id)
assert jax.process_count() == num_procs
assert jax.device_count() == 2 * num_procs, jax.devices()
assert len(jax.local_devices()) == 2

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from scann_tpu.ops.distances import DistanceMeasure, squared_norms
from scann_tpu.parallel.sharded import sharded_search_kernel

mesh = global_mesh()

# deterministic dataset: every process can recompute the full array for GT,
# but only materializes its own row range for the device shard
N, D, K = 512, 24, 8
rng = np.random.default_rng(1234)
full = rng.normal(size=(N, D)).astype(np.float32)
queries = rng.normal(size=(16, D)).astype(np.float32)

lo, hi = process_local_rows(N)
assert hi - lo == N // num_procs, (lo, hi)

db_sharding = NamedSharding(mesh, P("db", None))
db = jax.make_array_from_process_local_data(db_sharding, full[lo:hi])
norms = jax.jit(
    squared_norms, out_shardings=NamedSharding(mesh, P("db"))
)(db)
q = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P()), queries)

kernel = sharded_search_kernel(mesh, DistanceMeasure.SQUARED_L2, K)
dists, idx = kernel(db, norms, jnp.int32(N), q)

# out_specs are replicated -> every process holds the full result
idx_np = np.asarray(jax.device_get(idx))
dists_np = np.asarray(jax.device_get(dists))

d2 = ((queries[:, None, :] - full[None, :, :]) ** 2).sum(-1)
gt = np.argsort(d2, axis=1, kind="stable")[:, :K]
for i in range(len(queries)):
    assert set(idx_np[i]) == set(gt[i]), (proc_id, i, idx_np[i], gt[i])
np.testing.assert_allclose(
    dists_np, np.sort(d2, axis=1)[:, :K], rtol=1e-4, atol=1e-4)

print(f"proc {proc_id}: multihost sharded search OK", flush=True)

# ---------------------------------------------------------------------------
# flagship across the process boundary: tree-×-AH with partitions bin-packed
# over BOTH processes' devices. Every process builds the
# same deterministic single-device index; the sharded wrapper places each
# partition's CSR block + raw rows on its owning device, and the [k]-sized
# exact partials merge across the gloo process boundary.
# ---------------------------------------------------------------------------
from scann_tpu.data.dataset import DenseDataset
from scann_tpu.hashes.hasher import AsymmetricHasherConfig
from scann_tpu.models.searcher import SearchParameters
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
from scann_tpu.parallel.sharded_flagship import ShardedTreeXHybridSearcher

tree = TreeXHybridSearcher(TreeXHybridConfig(
    num_partitions=8, partitions_to_search=8,
    hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=6,
                                       seed=7, max_iterations=5),
)).build(DenseDataset(full))
sharded_tree = ShardedTreeXHybridSearcher(tree, mesh)
params = SearchParameters(pre_reordering_num_neighbors=64)
idx_t, dists_t = sharded_tree.search_batched_arrays(queries, K, params)
idx_1, _ = tree.search_batched_arrays(queries, K, params)

# parity vs the single-device searcher, judged by recall against exact GT:
# the sharded path keeps a full local pre_k on every shard, so its recall
# must match or beat single-device (tail candidate sets may differ)
rec_sh = np.mean([len(set(map(int, idx_t[i])) & set(map(int, gt[i]))) / K
                  for i in range(len(queries))])
rec_1 = np.mean([len(set(map(int, idx_1[i])) & set(map(int, gt[i]))) / K
                 for i in range(len(queries))])
assert rec_sh >= rec_1 - 1e-9, (proc_id, rec_sh, rec_1)
assert rec_sh >= 0.9, (proc_id, rec_sh)
# distances of returned ids must be exact
m = idx_t >= 0
d_ret = ((queries[:, None, :] - full[np.maximum(idx_t, 0)]) ** 2).sum(-1)
np.testing.assert_allclose(dists_t[m], d_ret[m], rtol=1e-4, atol=1e-4)

print(f"proc {proc_id}: multihost sharded tree-AH OK", flush=True)

# ---------------------------------------------------------------------------
# warm start across the process boundary: the per-shard layout reloads into
# the SAME global-mesh device placement and serves identical answers
# (each process saves/loads its own file; layouts are deterministic)
# ---------------------------------------------------------------------------
import tempfile

_path = os.path.join(tempfile.gettempdir(),
                     f"mh_layout_{port}_{proc_id}.npz")
sharded_tree.save_layout(_path)
reloaded = ShardedTreeXHybridSearcher.load_layout(_path, mesh)
idx_r, dists_r = reloaded.search_batched_arrays(queries, K, params)
np.testing.assert_array_equal(idx_r, idx_t)
np.testing.assert_allclose(dists_r, dists_t, rtol=1e-5, atol=1e-5)
os.unlink(_path)
print(f"proc {proc_id}: multihost warm-start OK", flush=True)
