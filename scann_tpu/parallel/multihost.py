"""Multi-host (DCN) scale-out entry points.

The reference is strictly single-process (SURVEY §2.6). Beyond one host's
devices, JAX spans hosts with ``jax.distributed``: every host runs the same
program, sees the global device list, and the same ``shard_map`` programs
from scann_tpu.parallel.sharded work unchanged — database shards that land
on another host's chips communicate over DCN only at the tiny top-k merge.

This module is the thin host-bootstrap layer; it is exercised in CI only in
single-process form (multi-host hardware is not available in this
environment).
"""

from __future__ import annotations

from typing import Optional

import jax

from scann_tpu.errors import ScannError


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Initialize jax.distributed for a multi-host mesh.

    Args mirror ``jax.distributed.initialize``; with no args, env-based
    JAX's cluster auto-detection is used (where the environment provides
    one; otherwise pass all three). Returns the process index.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # idempotent re-init: match both historical JAX double-init
        # messages ("already initialized" and the current "should only be
        # called once")
        msg = str(e)
        if ("already initialized" not in msg
                and "should only be called once" not in msg):
            raise ScannError.internal(f"jax.distributed init failed: {e}") from e
    return jax.process_index()


def global_mesh(axis_names=("db",), devices_per_axis=None):
    """Mesh over ALL processes' devices (call after initialize_multihost)."""
    from scann_tpu.parallel.mesh import make_mesh

    return make_mesh(n_devices=len(jax.devices()), axis_names=axis_names,
                     shape=devices_per_axis)


def process_local_rows(n_total: int) -> tuple:
    """[lo, hi) row range this process should load for a db-sharded index —
    hosts only materialize their own database shard (beyond-RAM datasets)."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n_total // p)
    lo = min(i * per, n_total)
    return lo, min(lo + per, n_total)
