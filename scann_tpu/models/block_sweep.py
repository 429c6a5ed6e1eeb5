"""Block-sweep searcher: bf16 streaming sweep + exact re-rank.

The production searcher for databases that fit device memory. Stores the
database once as bf16 rows augmented with their squared norm
(ops/sweep_pallas.py) so the whole first pass is one matrix-product sweep
with an in-register r:1 reduction, then exactly re-ranks ``pre_k``
survivors in f32.

Capability position vs the reference: sits between the exact
``BruteForceSearcher`` (src/brute_force/searcher.rs) and its approximate
modes — at moderate D an exact bf16 matrix product costs fewer FLOPs *and*
fewer bytes than PQ one-hot scoring.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.models.searcher import SearchParameters, Searcher, epsilons, pad_results_to_k
from scann_tpu.ops.distances import DistanceMeasure, squared_norms
from scann_tpu.ops.sweep_pallas import (
    build_augmented_db,
    sweep_search_kernel,
)
from scann_tpu.types import SUBLANE_BF16, align_up


@dataclasses.dataclass
class BlockSweepConfig:
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # candidates kept per query for the exact re-rank; raise for higher
    # recall on adversarial data (block collisions), lower for speed
    pre_reorder_k: int = 100
    # r:1 in-kernel reduction — one candidate survives per r-point block
    block_r: int = 32
    # row-padding unit of the augmented copy (a power of two >= block_r)
    tile_n: int = 2048
    # queries per device program: bounds the [B, N/r] block-minima buffers
    max_batch: int = 1024
    # re-rank the two smallest per block: removes the one-candidate-per-
    # block collision ceiling for ~2x block-minima writes + re-rank width
    # (and half the per-program batch, since the minima buffers double)
    top2: bool = False
    # stride-shuffle rows at build so cluster-SORTED datasets (crawl/label
    # order) keep approx_min_k's uniform-layout assumption; survivors'
    # true ids resolve via a small device inverse-table gather
    # (ops/sweep_pallas.py)
    shuffle: bool = True
    # dtype of the device copy the exact re-rank gathers from. The f32
    # database is the sweep's dominant serving allocation (the first pass
    # reads only the bf16 augmented copy): "bfloat16" (half) or "int8"
    # (quarter, calibrated ScalarQuantizer codec) fits more points on one
    # device.
    rerank_dtype: str = "float32"
    # dtype of the streamed sweep copy: "bfloat16" (default) or "int8"
    # (per-dim symmetric scales folded into the query head, squared norm
    # as exact base-128 digits in the padding columns — see
    # ops/sweep_pallas.build_int8_augmented_db). int8 halves the sweep's
    # byte stream for a small quantization-noise recall cost recovered by
    # the exact re-rank.
    sweep_dtype: str = "bfloat16"


class BlockSweepSearcher(Searcher):
    """bf16 block-min sweep + exact f32 re-rank (see module docstring)."""

    def __init__(self, dataset: DenseDataset,
                 config: Optional[BlockSweepConfig] = None):
        if not isinstance(dataset, DenseDataset):
            raise ScannError.invalid_argument(
                "BlockSweepSearcher needs a DenseDataset")
        cfg = config or BlockSweepConfig()
        if cfg.distance_measure not in (
                DistanceMeasure.SQUARED_L2, DistanceMeasure.DOT_PRODUCT,
                DistanceMeasure.GENERAL_INNER_PRODUCT, DistanceMeasure.COSINE):
            raise ScannError.invalid_argument(
                f"BlockSweepSearcher does not support {cfg.distance_measure}")
        if cfg.tile_n % cfg.block_r:
            raise ScannError.invalid_argument("tile_n must be divisible by r")
        if cfg.block_r & (cfg.block_r - 1) or cfg.tile_n & (cfg.tile_n - 1):
            raise ScannError.invalid_argument(
                "block_r and tile_n must be powers of two")
        if cfg.rerank_dtype not in ("float32", "bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"rerank_dtype must be float32, bfloat16 or int8, got "
                f"{cfg.rerank_dtype!r}")
        if cfg.sweep_dtype not in ("bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"sweep_dtype must be bfloat16 or int8, got "
                f"{cfg.sweep_dtype!r}")
        self._config = cfg
        self._dataset = dataset
        self._measure = cfg.distance_measure
        self._aug_dev = None
        self._aug_scales = None
        self._aug_sn = 0.0
        self._inv_perm = None
        self._inv_host = None
        self._rerank_cache = None

    # -- metadata -----------------------------------------------------------
    @property
    def dataset(self) -> DenseDataset:
        return self._dataset

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def memory_usage(self) -> int:
        """Device bytes beyond the raw dataset: the augmented sweep copy
        plus any low-precision rerank copy (f32 rerank shares the
        DenseDataset cache and is not counted here)."""
        total = (0 if self._aug_dev is None
                 else self._aug_dev.size * self._aug_dev.dtype.itemsize)
        if self._rerank_cache is not None and \
                self._config.rerank_dtype != "float32":
            rep = self._rerank_cache[0]
            if isinstance(rep, tuple):
                total += rep[0].size  # u8 codes
            else:
                total += rep.size * 2  # bf16 rows
        return total

    # -- device state ---------------------------------------------------------
    def _rerank_state(self, n: int):
        """(db_repr, norms): the rerank copy in the configured dtype —
        f32 rows, bf16 rows (half), or a (u8 codes, scale, min) tuple
        (quarter, per-dim codec). Low-precision copies upload directly
        from host (no f32 device copy needed — callers can drop the
        dataset cache; see docs/DESIGN.md).

        Rows are stored in the SAME permuted order as the augmented sweep
        copy (when shuffle is on), so the kernel gathers candidates at
        their raw sweep positions and translates only the k winners
        through inv_perm — a [B, k] gather instead of [B, pre_k]. The
        sharded wrapper uses the same layout
        (parallel/sharded_flagship._compute_sweep_shard_layout)."""
        if self._rerank_cache is not None and self._rerank_cache[2] == n:
            return self._rerank_cache[0], self._rerank_cache[1]
        rdt = self._config.rerank_dtype
        data = self._dataset.numpy()
        data_p = data if self._inv_host is None else data[self._inv_host]
        if rdt == "float32":
            if self._inv_host is None:
                db, _ = self._dataset.device()   # shared cache, same order
            else:
                db = jnp.asarray(data_p)
            norms = jax.jit(squared_norms)(db)
            db_repr = db
        else:
            from scann_tpu.utils.reordering import build_rerank_store

            db_repr, norms = build_rerank_store(data_p, n, rdt,
                                                SUBLANE_BF16)
        self._rerank_cache = (db_repr, norms, n)
        return db_repr, norms

    def _device_state(self):
        from scann_tpu.ops.sweep_pallas import (
            build_int8_augmented_db,
            shuffle_stride_for,
        )

        pad_to = self._config.tile_n

        n = self._dataset.size
        if self._aug_dev is None or self._rerank_cache is None or \
                self._rerank_cache[2] != n:
            if self._config.shuffle and n > 1:
                stride = shuffle_stride_for(n)
                pos = (np.arange(n, dtype=np.int64) * stride) % n
                inv = np.empty(n, np.int32)
                inv[pos] = np.arange(n, dtype=np.int32)
                self._inv_host = inv
                self._inv_perm = jnp.asarray(inv)
            else:
                stride, self._inv_perm = 0, None
                self._inv_host = None
            if self._config.sweep_dtype == "int8":
                aug, scales, sn = build_int8_augmented_db(
                    self._dataset.numpy(), n, self._measure,
                    tile_n=pad_to, shuffle_stride=stride)
                self._aug_scales = jnp.asarray(scales)
                self._aug_sn = sn
            else:
                aug = build_augmented_db(
                    self._dataset.numpy(), n, self._measure,
                    tile_n=pad_to, shuffle_stride=stride)
            self._aug_dev = jnp.asarray(aug)
        db_repr, norms = self._rerank_state(n)
        return self._aug_dev, db_repr, norms, n

    # -- search -----------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask=None):
        queries = self._validate_queries(queries)
        n = self.dataset_size()
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        cfg = self._config
        pre_k = max(cfg.pre_reorder_k, k)
        if params is not None and params.pre_reordering_num_neighbors is not None:
            pre_k = max(int(params.pre_reordering_num_neighbors), k)
        pre_eps, post_eps = epsilons(params)
        aug, db, norms, n_valid = self._device_state()
        allow_pen = None
        if allow_mask is not None:
            # restrict allowlist fused into the sweep as a pre-reduction
            # penalty stream — exact filter semantics at any selectivity
            # (a host post-filter cannot recover allowed rows shadowed by
            # denied block minima); see ops/sweep_pallas.build_allow_penalty
            from scann_tpu.ops.sweep_pallas import (
                INT8_NORM_DIGIT_MAX,
                build_allow_penalty,
            )

            pen_kw = {}
            if cfg.sweep_dtype == "int8":
                pen_kw["mask_value"] = 4.0 * INT8_NORM_DIGIT_MAX * self._aug_sn
            allow_pen = jnp.asarray(build_allow_penalty(
                allow_mask, aug.shape[0], cfg.block_r,
                inv_perm=self._inv_host, **pen_kw))
        # one survivor per r-block (two with top2) caps usable pre_k — and
        # with it the usable k: the kernel's final top-k can only be as
        # wide as its candidate list (output pads back to the requested k)
        pre_k = min(pre_k, aug.shape[0] // cfg.block_r)
        k_kern = min(k, pre_k * (2 if cfg.top2 else 1))

        out_i, out_d = [], []
        max_batch = cfg.max_batch // 2 if cfg.top2 else cfg.max_batch
        for lo in range(0, len(queries), max_batch):
            q = queries[lo: lo + max_batch]
            b = len(q)
            b_pad = align_up(b, SUBLANE_BF16)
            if b_pad != b:
                q = np.concatenate(
                    [q, np.zeros((b_pad - b, q.shape[1]), np.float32)])
            dists, idx = sweep_search_kernel(
                aug, db, norms, jnp.int32(n_valid), jnp.asarray(q),
                jnp.float32(pre_eps), jnp.float32(post_eps),
                pre_k=pre_k, k=k_kern, measure=self._measure,
                r=cfg.block_r, top2=cfg.top2,
                inv_perm=self._inv_perm, allow_pen=allow_pen,
                aug_scales=self._aug_scales, aug_sn=self._aug_sn,
            )
            out_i.append(np.asarray(idx)[:b])
            out_d.append(np.asarray(dists)[:b])
        return pad_results_to_k(np.concatenate(out_i),
                                np.concatenate(out_d), k)
