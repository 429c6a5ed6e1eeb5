"""Per-device performance profile backing ``Scann.auto()``'s crossovers.

``auto_config``'s architecture choice rests on two measured constants —
the N where the linear-in-N block sweep loses to tree-×-AH, and the byte
budget where the f32 rerank copy stops fitting — which are properties of a
DEVICE (memory size and bandwidth, matrix throughput), not of the library.
This module makes them data: profiles measured with ``calibrate()`` are
committed below keyed by JAX's ``device_kind``, a deployment can override
them (``SCANN_TPU_CHIP_PROFILE=/path.json``), and a device with no profile
is an error that names ``calibrate()`` — never a guess.

The reference has no counterpart — it requires an explicit mode everywhere
(reference: src/scann.rs:60-103).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from scann_tpu.errors import ScannError


@dataclasses.dataclass
class ChipProfile:
    """Measured constants that set ``auto_config``'s crossovers."""

    # N above which the sweep's linear-in-N batch cost loses to tree-AH at
    # serving batches (calibrate(): two-point sweep fit vs the tree time,
    # capped by the memory two sweep copies take)
    sweep_max_n: int = 6_000_000
    # f32 rerank-copy bytes before auto() switches the rerank copy to bf16
    f32_rerank_max_bytes: int = 5 * 1024**3
    # points per partition of the production tree builds (1.18M/2000)
    partition_density: int = 600
    # provenance: device, power limit, commit and fit of the measurement
    source: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ChipProfile":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Profiles by ``jax.devices()[0].device_kind``. GPU entries are calibrate()
# results on that card; the CPU entry is for tests only and measures nothing.
PROFILES = {
    "NVIDIA H100 80GB HBM3": ChipProfile(
        sweep_max_n=800_000,
        f32_rerank_max_bytes=21_254_373_376,
        partition_density=600,
        source="calibrate() on NVIDIA H100 80GB HBM3, power limit 700.00 W, "
               "working tree over commit 9c72cb6: chained 2-pt "
               "n_probe=200000/800000 dim=100 B=1024 a=0.073ms "
               "b=1.8449ns/pt t_tree=1.202ms fit=612154 mem_cap=58319926"),
    "cpu": ChipProfile(
        source="test-only CPU profile: fixed values, not a measurement "
               "(the CPU platform exists for the tests)"),
}


def load_profile(path: Optional[str] = None) -> ChipProfile:
    """Profile from ``path`` / $SCANN_TPU_CHIP_PROFILE / the committed
    profile of the current device kind."""
    path = path or os.environ.get("SCANN_TPU_CHIP_PROFILE")
    if path:
        with open(path) as f:
            return ChipProfile.from_json(f.read())
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PROFILES:
        raise ScannError.failed_precondition(
            f"no chip profile for device kind {kind!r}: measure one with "
            f"scann_tpu.calibrate(), save it with save_profile() and point "
            f"SCANN_TPU_CHIP_PROFILE at the file")
    return PROFILES[kind]


def save_profile(profile: ChipProfile, path: str) -> None:
    with open(path, "w") as f:
        f.write(profile.to_json())


def calibrate(n_probe: int = 200_000, dim: int = 100,
              batch: int = 1024, seed: int = 0,
              hbm_bytes: Optional[int] = None,
              verbose: bool = False) -> ChipProfile:
    """Re-measure the crossover constants on the CURRENT device.

    Methodology (chained on-device timing, two-point linear fit):
      1. time the block-sweep kernel at ``n_probe`` AND ``4*n_probe`` with
         the chained lax.scan protocol (utils/benchmarking.chained — no
         dispatch in the timed region), and fit its per-batch cost as
         ``t(N) = a + b*N``: ``a`` is the fixed select/top-k/rerank cost,
         ``b`` the HBM-stream slope;
      2. time the tree-AH pipeline at ``4*n_probe`` (its cost is ~flat in
         N at fixed (p, l_cap));
      3. crossover = ``(t_tree - a) / b``, capped by the N where the
         sweep's two serving copies (f32 rerank + bf16 augmented) stop
         fitting the device-memory workspace budget.

    A one-point ratio would extrapolate a far too small crossover, because
    at small N the fixed cost ``a`` dominates both searchers; only the
    slope ``b`` carries the linear-in-N term the crossover model needs.

    Cost: two sweep copies + one tree build at 4*n_probe — minutes.
    Returns a ChipProfile (not persisted; pass to save_profile).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scann_tpu.data.dataset import DenseDataset
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.models.block_sweep import BlockSweepConfig, BlockSweepSearcher
    from scann_tpu.models.tree_x_hybrid import (
        TreeXHybridConfig,
        TreeXHybridSearcher,
        tree_ah_kernel,
    )
    from scann_tpu.ops.distances import DistanceMeasure
    from scann_tpu.ops.sweep_pallas import augmented_dim, sweep_search_kernel
    from scann_tpu.utils.benchmarking import chained

    rng = np.random.default_rng(seed)
    n_big = 4 * n_probe
    db = rng.standard_normal((n_big, dim), dtype=np.float32)
    q_dev = jnp.asarray(rng.standard_normal((batch, dim), dtype=np.float32))
    pre_k, block_r = 100, 64

    def time_sweep(n):
        ds = DenseDataset(db[:n])
        s = BlockSweepSearcher(ds, BlockSweepConfig(block_r=block_r,
                                                    pre_reorder_k=pre_k))
        aug, dbd, norms, n_valid = s._device_state()

        def call(qq, augx, dbx, nx):
            return sweep_search_kernel(augx, dbx, nx, jnp.int32(n), qq,
                                       pre_k=pre_k, k=10, r=block_r,
                                       measure=DistanceMeasure.SQUARED_L2)

        t = chained(lambda qq, *r: call(qq, *r), (q_dev, aug, dbd, norms),
                    iters=12)
        del aug, dbd, norms, s, ds
        jax.clear_caches()
        return t

    t1 = time_sweep(n_probe)
    t2 = time_sweep(n_big)
    b = max((t2 - t1) / max(n_big - n_probe, 1), 1e-12)
    a = max(t1 - b * n_probe, 0.0)

    ds = DenseDataset(db)
    parts = max(n_big // 600, 16)
    subs = min((s for s in range(1, dim + 1) if dim % s == 0),
               key=lambda s: (abs(dim / s - 2), -s))
    tree = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=parts, partitions_to_search=10,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=subs, seed=seed,
            max_iterations=8))).build(ds)
    db_d, tnorms, n_v = tree._device_state()
    codes, offs, sizes, perm, l_cap = tree._csr_state()
    kw = dict(p=10, pre_k=150, k=10, l_cap=l_cap, use_residuals=True,
              measure=DistanceMeasure.SQUARED_L2, multiplicity=1,
              approx_select_min=tree.config.approx_selection_min_partitions,
              scorer=tree._leaf_scorer())

    def tree_call(qq, dbx, nx, c, codes_x, off, sz, pm, cbx):
        return tree_ah_kernel(dbx, nx, c, codes_x, off, sz, pm, cbx, qq,
                              jnp.int32(n_v), None, jnp.float32(np.inf),
                              jnp.float32(np.inf), **kw)

    t_tree = chained(lambda qq, *r: tree_call(qq, *r),
                     (q_dev, db_d, tnorms, tree.partitioner.centers_device(),
                      codes, offs, sizes, perm,
                      tree.codebook.centroids_device()), iters=12)

    if hbm_bytes is None:
        stats = jax.local_devices()[0].memory_stats()
        if not stats or "bytes_limit" not in stats:
            raise ScannError.failed_precondition(
                "the device reports no memory limit: pass hbm_bytes")
        hbm_bytes = int(stats["bytes_limit"])
    # memory cap: the sweep serves from an f32 rerank copy + a bf16
    # augmented copy; leave ~40% workspace for program temps
    bytes_per_point = 4 * dim + 2 * augmented_dim(dim)
    n_hbm = int(0.6 * hbm_bytes / bytes_per_point)
    n_fit = int((t_tree - a) / b) if t_tree > a else n_big
    n_cross = max(min(n_fit, n_hbm), n_big)
    prof = ChipProfile(
        sweep_max_n=n_cross,
        f32_rerank_max_bytes=hbm_bytes // 3,
        source=f"calibrate() on {jax.devices()[0].device_kind}: chained "
               f"2-pt n_probe={n_probe}/{n_big} dim={dim} B={batch} "
               f"a={a*1e3:.3f}ms b={b*1e9:.4f}ns/pt t_tree={t_tree*1e3:.3f}ms "
               f"fit={n_fit} mem_cap={n_hbm}",
    )
    if verbose:
        print(f"calibrate: sweep a={a*1e3:.2f}ms b={b*1e9:.3f}ns/pt "
              f"(t({n_probe})={t1*1e3:.2f}ms t({n_big})={t2*1e3:.2f}ms) "
              f"t_tree={t_tree*1e3:.2f}ms -> fit {n_fit:,}, "
              f"memory cap {n_hbm:,} -> sweep_max_n={n_cross:,}")
    return prof
