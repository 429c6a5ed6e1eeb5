"""Configuration dataclasses.

JSON-round-trippable configs mirroring the reference's protobuf-equivalent
structs (reference: src/config.rs:10-42,134-199,201-318,322-336). Builders use
``with_*`` fluent setters returning ``self`` to keep the API shape familiar.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass
from typing import Any, Optional

from scann_tpu.ops.distances import DistanceMeasure


class HashType(enum.Enum):
    """Hashing algorithm (reference: src/config.rs:266-274)."""

    ASYMMETRIC_HASHING = "AsymmetricHashing"
    PRODUCT_QUANTIZATION = "ProductQuantization"


class LutFormat(enum.Enum):
    """Lookup-table numeric format (reference: src/config.rs:277-287)."""

    INT8 = "Int8"
    INT16 = "Int16"
    FLOAT = "Float"


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


class _JsonMixin:
    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = _FIELD_TYPES.get((cls.__name__, f.name))
            if v is None:
                # converter-typed (nested/enum) fields treat None as absent;
                # plain fields keep an explicit None — it can be meaningful
                # against a non-None default (max_partition_size None =
                # balancing off vs the "auto" default)
                if t is None:
                    kwargs[f.name] = None
                continue
            if t is not None:
                v = t.from_dict(v) if isinstance(v, dict) else t(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclass
class BruteForceConfig(_JsonMixin):
    """Brute-force search config (reference: src/config.rs:112-132)."""

    scalar_quantization: bool = False
    quantization_bits: int = 0
    # extension: bf16 block-min sweep + exact re-rank — the flagship
    # device-resident serving path (models/block_sweep.py); approximate
    # (recall ~0.998 at pre-reorder depth 100), not exact brute force
    block_sweep: bool = False
    block_sweep_pre_k: int = 100
    # dtype of the streamed sweep copy: "bfloat16" or "int8" (half the
    # bytes streamed; see BlockSweepConfig.sweep_dtype)
    block_sweep_dtype: str = "bfloat16"
    # keep the TWO smallest per block: removes the
    # one-candidate-per-block collision ceiling — needed for recall
    # targets >= 0.99 on near-duplicate-heavy data
    block_sweep_top2: bool = False

    def with_scalar_quantization(self, bits: int = 8) -> "BruteForceConfig":
        self.scalar_quantization = True
        self.quantization_bits = bits
        return self

    def with_block_sweep(self, pre_k: int = 100,
                         sweep_dtype: str = "bfloat16",
                         top2: bool = False) -> "BruteForceConfig":
        self.block_sweep = True
        self.block_sweep_pre_k = pre_k
        self.block_sweep_dtype = sweep_dtype
        self.block_sweep_top2 = top2
        return self


@dataclass
class PartitioningConfig(_JsonMixin):
    """K-means partitioning config (reference: src/config.rs:134-199)."""

    num_partitions: int = 100
    num_partitions_to_search: int = 10
    max_training_iterations: int = 100
    convergence_threshold: float = 1e-5
    num_levels: int = 1
    spilling: bool = False
    spilling_threshold: float = 0.0
    # extension: "soar" secondary assignments (see TreePartitionerConfig)
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    # extension: cap on training sample size; the reference trains on the
    # full dataset, which is also the default here (None).
    training_sample_size: Optional[int] = None
    # extension: partition balance cap ("auto" = 1.5x mean, None = off)
    # and the hard-cap straggler split — skewed partitions directly cost
    # every query l_cap padding in the leaf-scoring kernels (see
    # TreePartitionerConfig)
    max_partition_size: Optional[object] = "auto"
    split_stragglers: bool = True

    def with_partitions_to_search(self, n: int) -> "PartitioningConfig":
        self.num_partitions_to_search = n
        return self

    def with_spilling(self, threshold: float) -> "PartitioningConfig":
        self.spilling = True
        self.spilling_threshold = threshold
        return self

    def with_soar(self, soar_lambda: float = 1.0) -> "PartitioningConfig":
        self.spilling = True
        self.spilling_mode = "soar"
        self.soar_lambda = soar_lambda
        return self

    def with_levels(self, levels: int) -> "PartitioningConfig":
        self.num_levels = levels
        return self


@dataclass
class HashConfig(_JsonMixin):
    """Asymmetric-hashing config (reference: src/config.rs:201-264)."""

    hash_type: HashType = HashType.ASYMMETRIC_HASHING
    num_buckets: int = 256
    num_blocks: int = 16
    lut_format: LutFormat = LutFormat.INT8
    training_sample_size: int = 100_000
    # extension (no reference counterpart): score-aware anisotropic
    # codebook training (Guo et al. 2020, hashes/avq.py); e.g. 0.2 for
    # MIPS/cosine workloads, None = plain reconstruction-loss PQ
    anisotropic_threshold: Optional[float] = None

    def with_type(self, hash_type: HashType) -> "HashConfig":
        self.hash_type = hash_type
        return self

    def with_buckets(self, buckets: int) -> "HashConfig":
        self.num_buckets = buckets
        return self

    def with_blocks(self, blocks: int) -> "HashConfig":
        self.num_blocks = blocks
        return self

    def with_lut_format(self, fmt: LutFormat) -> "HashConfig":
        self.lut_format = fmt
        return self

    def with_anisotropic_threshold(self, t: Optional[float]) -> "HashConfig":
        self.anisotropic_threshold = t
        return self


@dataclass
class ExactReorderingConfig(_JsonMixin):
    """Exact re-ranking config (reference: src/config.rs:290-318)."""

    num_candidates: int = 100
    quantized: bool = False
    # dtype of the device copy re-ranking gathers from: "float32",
    # "bfloat16" (half the memory, small recall cost), or "int8" (quarter;
    # selected implicitly by quantized=True). Extension: the reference
    # declares quantized reordering (config.rs:290-318) but re-ranks f32.
    rerank_dtype: str = "float32"

    def with_quantized(self) -> "ExactReorderingConfig":
        self.quantized = True
        return self


@dataclass
class QueryConfig(_JsonMixin):
    """Per-query overrides (reference: src/config.rs:322-336 — declared
    there but never consumed by any search path; honored here for real via
    ``to_search_parameters`` and the ``Scann`` facade's ``query_config``
    argument)."""

    num_neighbors: Optional[int] = None
    num_partitions_to_search: Optional[int] = None
    reordering_num_candidates: Optional[int] = None
    epsilon: Optional[float] = None

    def to_search_parameters(self):
        """Map onto SearchParameters: partitions -> leaves to search,
        reordering candidates -> pre_k, epsilon -> the FINAL-distance
        threshold (post-reordering). Mapping epsilon to the post stage
        keeps one semantic across every search mode: results whose
        reported distance exceeds epsilon are dropped, whether the mode
        is exact (effective_epsilon takes the tighter of pre/post) or
        re-ranked (exact distances filtered after the rerank). Mapping it
        to the pre stage instead would compare exact-unit epsilons
        against quantized approximate scores in re-ranked modes
        (reference epsilon semantics: src/brute_force/top_k.rs:263-279,
        always applied to the distances actually returned)."""
        from scann_tpu.models.searcher import SearchParameters

        return SearchParameters(
            num_neighbors=self.num_neighbors,
            num_leaves_to_search=self.num_partitions_to_search,
            pre_reordering_num_neighbors=self.reordering_num_candidates,
            post_reordering_epsilon=self.epsilon,
        )


@dataclass
class ScannConfig(_JsonMixin):
    """Top-level searcher config (reference: src/config.rs:10-42)."""

    num_neighbors: int = 10
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    brute_force: Optional[BruteForceConfig] = None
    partitioning: Optional[PartitioningConfig] = None
    hash: Optional[HashConfig] = None
    exact_reordering: Optional[ExactReorderingConfig] = None

    def with_num_neighbors(self, k: int) -> "ScannConfig":
        self.num_neighbors = k
        return self

    def with_distance_measure(self, measure: DistanceMeasure) -> "ScannConfig":
        self.distance_measure = measure
        return self

    def with_brute_force(self, cfg: Optional[BruteForceConfig] = None) -> "ScannConfig":
        self.brute_force = cfg or BruteForceConfig()
        return self

    def with_partitioning(self, cfg: Optional[PartitioningConfig] = None) -> "ScannConfig":
        self.partitioning = cfg or PartitioningConfig()
        return self

    def with_hashing(self, cfg: Optional[HashConfig] = None) -> "ScannConfig":
        self.hash = cfg or HashConfig()
        return self

    def with_reordering(self, cfg: Optional[ExactReorderingConfig] = None) -> "ScannConfig":
        self.exact_reordering = cfg or ExactReorderingConfig()
        return self

    # -- predicates matching the reference ---------------------------------
    def has_partitioning(self) -> bool:
        return self.partitioning is not None

    def has_hashing(self) -> bool:
        return self.hash is not None

    def has_reordering(self) -> bool:
        return self.exact_reordering is not None


# Nested-field coercion table for from_dict round-trips.
_FIELD_TYPES = {
    ("ScannConfig", "distance_measure"): DistanceMeasure,
    ("ScannConfig", "brute_force"): BruteForceConfig,
    ("ScannConfig", "partitioning"): PartitioningConfig,
    ("ScannConfig", "hash"): HashConfig,
    ("ScannConfig", "exact_reordering"): ExactReorderingConfig,
    ("HashConfig", "hash_type"): HashType,
    ("HashConfig", "lut_format"): LutFormat,
}
