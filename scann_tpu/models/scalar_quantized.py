"""Quantized-database brute-force searcher (int8 / int4 / bf16 / fp8).

Replaces the reference's ``ScalarQuantizedBruteForceSearcher``
(reference: src/brute_force/scalar_quantized.rs:82-347) with one jit program:
asymmetric matmul scoring (ops/asymmetric.py) + fused top-k. The bf16 and fp8
variants are native dtypes, so they share the same program with
scale=1/offset=0.
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
from scann_tpu.models.searcher import SearchParameters, Searcher
from scann_tpu.ops.asymmetric import asymmetric_many_to_many
from scann_tpu.ops.distances import DistanceMeasure, mask_padded_rows
from scann_tpu.ops.topk import top_k_smallest
from scann_tpu.quantization.bfloat16 import BFloat16Dataset
from scann_tpu.quantization.fp8 import Fp8Dataset, Fp8Format
from scann_tpu.quantization.scalar import (
    QuantizedDataset,
    ScalarQuantizer,
    ScalarQuantizerConfig,
)
from scann_tpu.types import MASKED_DISTANCE


@dataclasses.dataclass
class ScalarQuantizedConfig:
    """(reference: src/brute_force/scalar_quantized.rs:26-45)."""

    quantizer_config: ScalarQuantizerConfig = dataclasses.field(
        default_factory=ScalarQuantizerConfig
    )
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # extension: storage dtype — "int8"/"int4" use the scalar codec,
    # "bf16"/"fp8_e4m3"/"fp8_e5m2" store native floating dtypes.
    storage: str = "int8"


@functools.partial(jax.jit, static_argnames=("measure", "k"))
def _search_kernel(codes, norms, scale, offset, n_valid, queries, eps=jnp.inf,
                   *, measure, k):
    dists = asymmetric_many_to_many(measure, queries, codes, norms, scale, offset)
    dists = mask_padded_rows(dists, n_valid, MASKED_DISTANCE)
    vals, idx = top_k_smallest(dists, k)
    # epsilon threshold on the (quantized-exact) distances (reference:
    # src/brute_force/top_k.rs:263-393 FastTopNeighbors semantics)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
    return jnp.where(missing, jnp.inf, vals), jnp.where(missing, -1, idx)


class ScalarQuantizedBruteForceSearcher(Searcher):
    """Exact-over-quantized search (reference: src/brute_force/scalar_quantized.rs:82-93)."""

    def __init__(self, dataset: DenseDataset, config: Optional[ScalarQuantizedConfig] = None):
        cfg = config or ScalarQuantizedConfig()
        self._config = cfg
        self._measure = cfg.distance_measure
        self._dim = dataset.dimensionality
        self._docid_table = dataset.docids
        storage = cfg.storage

        if storage in ("int8", "int4"):
            qcfg = dataclasses.replace(cfg.quantizer_config)
            if storage == "int4":
                qcfg.bits = 4
            quantizer = ScalarQuantizer(qcfg)
            self._quantized = QuantizedDataset.from_dataset(dataset, quantizer)
            self._scale = float(quantizer.scale)
            self._offset = float(quantizer.min_value)
        elif storage == "bf16":
            self._quantized = BFloat16Dataset.from_f32(dataset.numpy())
            self._scale, self._offset = 1.0, 0.0
        elif storage in ("fp8_e4m3", "fp8_e5m2"):
            fmt = Fp8Format.E4M3 if storage == "fp8_e4m3" else Fp8Format.E5M2
            self._quantized = Fp8Dataset(dataset.numpy(), fmt)
            self._scale, self._offset = 1.0, 0.0
        else:
            raise ScannError.invalid_argument(f"unknown storage {storage!r}")

    @classmethod
    def from_quantized(cls, quantized: QuantizedDataset,
                       distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2):
        """Wrap an already-quantized dataset
        (reference: scalar_quantized.rs:117-131)."""
        self = cls.__new__(cls)
        self._config = ScalarQuantizedConfig(distance_measure=distance_measure)
        self._measure = distance_measure
        self._dim = quantized.dimensionality
        self._docid_table = None
        self._quantized = quantized
        self._scale = float(quantized.quantizer.scale)
        self._offset = float(quantized.quantizer.min_value)
        return self

    # -- metadata ---------------------------------------------------------
    @property
    def quantized_dataset(self):
        return self._quantized

    def dataset_size(self) -> int:
        return self._quantized.size

    def dimensionality(self) -> int:
        return self._dim

    def _docids(self):
        return self._docid_table

    def memory_usage(self) -> int:
        return self._quantized.memory_usage_bytes() + 4 * self._quantized.size

    def compression_ratio(self) -> float:
        return self._quantized.compression_ratio()

    # -- search -------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        queries = self._validate_queries(queries)
        k = min(int(k), self.dataset_size())
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        codes, norms, n = self._quantized.device()
        eps = params.effective_epsilon() if params is not None else np.inf
        dists, idx = _search_kernel(
            codes, norms, jnp.float32(self._scale), jnp.float32(self._offset),
            jnp.int32(n), jnp.asarray(queries), jnp.float32(eps),
            measure=self._measure, k=k,
        )
        return np.asarray(idx), np.asarray(dists)
