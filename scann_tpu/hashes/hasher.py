"""Asymmetric hasher: PQ-encoded database + per-query LUT scoring.

Replaces the reference's host loop (build LUT, scalar-score every point,
heap) (reference: src/hashes/hasher.rs:75-229) with one device program:

    LUT einsum ([B,S,C] tables) -> code scoring (one-hot matmul / gather)
    -> masked top-k [-> gather raw rows -> exact re-rank -> top-k]

The optional exact re-ranking stage (search_with_reordering,
hasher.rs:188-229) runs inside the same jit program — no host round trip
between approximate and exact stages.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.hashes.codebook import Codebook, CodebookConfig, lut_kernel
from scann_tpu.hashes.lut16 import PackedCodes4Bit
from scann_tpu.models.searcher import SearchParameters, Searcher, epsilons
from scann_tpu.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
)
from scann_tpu.ops.lut16_scoring import lut_score
from scann_tpu.ops.topk import approx_top_k_smallest, top_k_smallest
from scann_tpu.types import MASKED_DISTANCE, SUBLANE_I8, align_up


# shared threshold ladder (models/searcher.epsilons); kept under the old
# module-local name for existing callers
_epsilons = epsilons


@dataclasses.dataclass
class AsymmetricHasherConfig:
    """(reference: src/hashes/hasher.rs:30-70)."""

    num_codes: int = 256
    num_subspaces: int = 8
    seed: Optional[int] = None
    max_iterations: int = 25
    training_sample_size: int = 100_000
    store_dataset: bool = True  # needed for exact reordering
    # extension beyond the reference (hasher.rs:208 hardcodes SquaredL2):
    # COSINE normalizes rows at build + queries at search (L2 LUTs then rank
    # identically to cosine); DOT_PRODUCT/GIP use -dot LUTs
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # extension: score-aware anisotropic codebook training (Guo et al.
    # 2020, hashes/avq.py) — set to e.g. 0.2 to boost MIPS/cosine recall at
    # the same bit budget; None = plain reconstruction-loss PQ
    anisotropic_threshold: Optional[float] = None
    # dtype of the device copy exact re-ranking gathers from ("float32",
    # "bfloat16", "int8") — same HBM lever as TreeXHybridConfig/
    # BlockSweepConfig.rerank_dtype; see utils/reordering.build_rerank_store
    rerank_dtype: str = "float32"


_AH_MIPS = (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT)


def _ah_luts(queries, centroids, measure):
    """[B, S, C] LUTs in the searcher's measure: squared-L2 tables (also
    used for cosine after upstream normalization) or -dot tables for MIPS."""
    if measure in _AH_MIPS:
        b = queries.shape[0]
        s, c, dsub = centroids.shape
        qs = queries.reshape(b, s, dsub)
        return -jnp.einsum("bsd,scd->bsc", qs, centroids,
                           precision=jax.lax.Precision.HIGHEST)
    return lut_kernel(queries, centroids)


@functools.partial(jax.jit, static_argnames=("k", "measure"))
def ah_search_kernel(centroids, codes, n_valid, queries, *, k: int,
                     measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
    """Approximate-only search: LUT build + scoring + top-k."""
    luts = _ah_luts(queries, centroids, measure)
    dists = lut_score(luts, codes)  # [B, N_pad]
    # returned values (and any host-side epsilon compare) in measure units
    dists = approx_to_measure_units(dists, measure)
    col = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1)
    dists = jnp.where(col < n_valid, dists, MASKED_DISTANCE)
    return top_k_smallest(dists, k)


@functools.partial(jax.jit, static_argnames=("pre_k", "k", "measure"))
def ah_search_reorder_kernel(
    centroids, codes, db, db_sq_norms, n_valid, queries,
    pre_eps=jnp.inf, post_eps=jnp.inf, *, pre_k: int, k: int,
    measure: DistanceMeasure,
):
    """Approximate top-pre_k then exact re-rank to top-k, one program."""
    luts = _ah_luts(queries, centroids, measure)
    approx = lut_score(luts, codes)
    col = jax.lax.broadcasted_iota(jnp.int32, approx.shape, 1)
    approx = jnp.where(col < n_valid, approx,
                       jnp.asarray(MASKED_DISTANCE, approx.dtype))
    # candidate selection: approximate top-k (the exact re-rank below
    # recovers the recall_target loss)
    pre_vals, cand = approx_top_k_smallest(approx, pre_k)  # [B, pre_k]

    from scann_tpu.utils.reordering import gather_rerank_rows

    rows = gather_rerank_rows(db, cand)                # [B, pre_k, D]
    # norms recomputed from the gathered f32 rows (identical math to the
    # table, and no per-element norm gather)
    norms = jnp.sum(rows * rows, axis=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    pre_m = approx_to_measure_units(pre_vals.astype(jnp.float32), measure)
    valid = (cand < n_valid) & (pre_m <= pre_eps)
    exact = jnp.where(valid, exact, MASKED_DISTANCE)
    vals, pos = top_k_smallest(exact, k)
    idx = jnp.take_along_axis(cand, pos, axis=1)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


class AsymmetricHasher(Searcher):
    """PQ hashing searcher (reference: src/hashes/hasher.rs:75-93)."""

    def __init__(self, config: Optional[AsymmetricHasherConfig] = None):
        self.config = config or AsymmetricHasherConfig()
        self.codebook: Optional[Codebook] = None
        self.codes: Optional[np.ndarray] = None          # [N, S] uint8
        self.packed: Optional[PackedCodes4Bit] = None    # int4 layout when C<=16
        self._dataset: Optional[DenseDataset] = None
        self._codes_dev = None
        self._rerank_cache = None
        self._n = 0
        self._dim = 0
        if self.config.rerank_dtype not in ("float32", "bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"rerank_dtype must be float32, bfloat16 or int8, got "
                f"{self.config.rerank_dtype!r}")

    # -- build ----------------------------------------------------------------
    def build(self, dataset: DenseDataset) -> "AsymmetricHasher":
        if dataset.is_empty:
            raise ScannError.invalid_argument("Cannot build from empty dataset")
        self._rerank_cache = None
        cfg = self.config
        if cfg.distance_measure not in (
                DistanceMeasure.SQUARED_L2, DistanceMeasure.COSINE,
                *_AH_MIPS):
            raise ScannError.invalid_argument(
                f"AsymmetricHasher does not support {cfg.distance_measure}")
        if cfg.distance_measure == DistanceMeasure.COSINE:
            raw = dataset.numpy()
            nr = np.sqrt(np.einsum("nd,nd->n", raw, raw))
            dataset = DenseDataset(
                (raw / np.maximum(nr, 1e-30)[:, None]).astype(np.float32),
                docids=dataset.docids)
        self._dim = dataset.dimensionality
        self._n = dataset.size

        data = dataset.numpy()
        train = data
        if cfg.training_sample_size < len(data):
            rng = np.random.default_rng(cfg.seed if cfg.seed is not None else 42)
            train = data[rng.choice(len(data), cfg.training_sample_size, replace=False)]

        self.codebook = Codebook(CodebookConfig(
            num_codes=cfg.num_codes,
            num_subspaces=cfg.num_subspaces,
            max_iterations=cfg.max_iterations,
            seed=cfg.seed,
            anisotropic_threshold=cfg.anisotropic_threshold,
        )).train(train)

        self.codes = self.codebook.encode_dataset(data)
        if self.codebook.num_codes <= 16:
            self.packed = PackedCodes4Bit.from_codes(self.codes)
        if cfg.store_dataset:
            self._dataset = dataset
        self._codes_dev = None
        return self

    def _device_codes(self):
        if self._codes_dev is None:
            n_pad = align_up(max(self._n, 1), SUBLANE_I8)
            codes = self.codes
            if n_pad != self._n:
                codes = np.zeros((n_pad, codes.shape[1]), dtype=np.uint8)
                codes[: self._n] = self.codes
            self._codes_dev = jnp.asarray(codes)
        return self._codes_dev

    # -- metadata --------------------------------------------------------------
    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._dim

    def _docids(self):
        return self._dataset.docids if self._dataset is not None else None

    def memory_usage(self) -> int:
        """Code bytes (packed when 4-bit)."""
        if self.packed is not None:
            return self.packed.data.nbytes
        return 0 if self.codes is None else self.codes.nbytes

    # -- search ----------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        self._check_built()
        queries = self._validate_queries(queries)
        if self.config.distance_measure == DistanceMeasure.COSINE:
            qn = np.sqrt(np.einsum("bd,bd->b", queries, queries))
            queries = queries / np.maximum(qn, 1e-30)[:, None]
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")

        pre_k = None
        if params is not None and params.pre_reordering_num_neighbors is not None:
            pre_k = min(int(params.pre_reordering_num_neighbors), self._n)
        pre_eps, post_eps = _epsilons(params)

        if pre_k is not None and pre_k > k:
            return self._search_reorder(queries, k, pre_k, pre_eps, post_eps)

        dists, idx = ah_search_kernel(
            self.codebook.centroids_device(), self._device_codes(),
            jnp.int32(self._n), jnp.asarray(queries), k=k,
            measure=self.config.distance_measure,
        )
        dists, idx = np.asarray(dists), np.asarray(idx)
        if params is not None:
            # approximate-only path: the search IS both stages, so the
            # tighter of pre/post applies (same single-stage semantics as
            # every exact searcher — SearchParameters.effective_epsilon)
            eps = params.effective_epsilon()
            if np.isfinite(eps):
                over = dists > eps
                dists = np.where(over, np.inf, dists)
                idx = np.where(over, -1, idx)
        return idx, dists

    def search_with_reordering(self, query, k: int, pre_reorder_k: int):
        """(reference: hasher.rs:188-229)."""
        q = self._validate_queries(np.asarray(query))
        if self.config.distance_measure == DistanceMeasure.COSINE:
            qn = np.sqrt(np.einsum("bd,bd->b", q, q))
            q = q / np.maximum(qn, 1e-30)[:, None]
        k_c = min(k, self._n)
        # the exact stage's top-k can only be as wide as its candidate
        # list: pre_reorder_k below k would crash the final top_k
        pre_c = min(max(pre_reorder_k, k_c), self._n)
        idx, dist = self._search_reorder(q, k_c, pre_c)
        return self._to_results(idx, dist)[0]

    def _rerank_state(self):
        """(db_repr, norms) in the configured rerank_dtype (low-precision
        copies upload straight from host; the f32 DenseDataset cache can
        then be dropped by the caller)."""
        if self._dataset is None:
            raise ScannError.failed_precondition("Dataset not stored")
        rdt = self.config.rerank_dtype
        if rdt == "float32":
            db, _ = self._dataset.device()
            from scann_tpu.ops.distances import squared_norms

            return db, jax.jit(squared_norms)(db)
        if self._rerank_cache is None or self._rerank_cache[2] != self._n:
            from scann_tpu.types import SUBLANE_F32
            from scann_tpu.utils.reordering import build_rerank_store

            db_repr, norms = build_rerank_store(
                self._dataset.numpy(), self._n, rdt, SUBLANE_F32)
            self._rerank_cache = (db_repr, norms, self._n)
        return self._rerank_cache[0], self._rerank_cache[1]

    def _search_reorder(self, queries, k: int, pre_k: int,
                        pre_eps=np.inf, post_eps=np.inf):
        db, norms = self._rerank_state()
        cent = self.codebook.centroids_device()
        dists, idx = ah_search_reorder_kernel(
            cent, self._device_codes(), db, norms,
            jnp.int32(self._n), jnp.asarray(queries),
            jnp.float32(pre_eps), jnp.float32(post_eps), pre_k=pre_k, k=k,
            measure=self.config.distance_measure,
        )
        return np.asarray(idx), np.asarray(dists)

    def _check_built(self):
        if self.codebook is None:
            raise ScannError.failed_precondition("hasher not built")
