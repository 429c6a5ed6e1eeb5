"""Host-side lookup-table types.

Mirror of the reference's per-query LUT containers
(reference: src/hashes/lut.rs:30-234). Here batched LUTs are device
arrays produced by ``Codebook.lookup_tables`` and consumed directly by the
scoring kernels (ops/lut16_scoring.py); these host classes exist for API
parity, for scalar verification, and for the int8-quantized table codec
(lut.rs:114-196) whose scale/offset semantics the device kernels reproduce.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from scann_tpu.errors import ScannError


class LookupTable:
    """Per-query [S, C] float distance tables (reference: lut.rs:30-107)."""

    def __init__(self, distances: np.ndarray):
        distances = np.asarray(distances, dtype=np.float32)
        if distances.ndim != 2:
            raise ScannError.invalid_argument("LUT must be [num_subspaces, num_codes]")
        self.distances = distances

    @classmethod
    def from_query(cls, codebook, query: np.ndarray) -> "LookupTable":
        return cls(np.asarray(codebook.lookup_tables(query))[0])

    @property
    def num_subspaces(self) -> int:
        return self.distances.shape[0]

    @property
    def num_codes(self) -> int:
        return self.distances.shape[1]

    def compute_distance(self, codes: np.ndarray) -> float:
        """Scalar scoring Σ_s table[s][code_s] (reference: lut.rs:74-82)."""
        codes = np.asarray(codes, dtype=np.int64)
        return float(self.distances[np.arange(self.num_subspaces), codes].sum())

    def compute_distances_batch(self, codes_batch: np.ndarray) -> np.ndarray:
        codes_batch = np.asarray(codes_batch, dtype=np.int64)
        return self.distances[
            np.arange(self.num_subspaces)[None, :], codes_batch
        ].sum(axis=1).astype(np.float32)

    def subspace_distances(self, s: int) -> np.ndarray:
        return self.distances[s]

    def to_int8(self) -> "LookupTableInt8":
        """Global-range u8 quantization (reference: lut.rs:113-150)."""
        lo = float(self.distances.min())
        hi = float(self.distances.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        q = np.floor((self.distances - lo) * scale + 0.5).astype(np.uint8)
        return LookupTableInt8(q, scale=scale, offset=lo)


class LookupTableInt8:
    """u8-quantized tables with scale/offset dequant (reference: lut.rs:153-196).

    compute_distance = (Σ u8) / scale + offset * S.
    """

    def __init__(self, distances: np.ndarray, scale: float, offset: float):
        self.distances = np.asarray(distances, dtype=np.uint8)
        self.scale = float(scale)
        self.offset = float(offset)

    @property
    def num_subspaces(self) -> int:
        return self.distances.shape[0]

    @property
    def num_codes(self) -> int:
        return self.distances.shape[1]

    def compute_distance_raw(self, codes: np.ndarray) -> int:
        codes = np.asarray(codes, dtype=np.int64)
        return int(
            self.distances[np.arange(self.num_subspaces), codes].astype(np.uint32).sum()
        )

    def compute_distance(self, codes: np.ndarray) -> float:
        return self.compute_distance_raw(codes) / self.scale + self.offset * self.num_subspaces


def quantize_luts_u8(luts: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Batch LUT u8 quantization with *global* min/max per query, the LUT16
    SIMD-table codec (reference: src/hashes/lut16_simd.rs:39-90):
        q = round((v - bias) * 255/range); dequant sum = sum*multiplier + bias*S

    Args: luts [B, S, C] f32. Returns (u8 luts [B,S,C], multiplier [B], bias [B]).
    """
    luts = np.asarray(luts, dtype=np.float32)
    lo = luts.min(axis=(1, 2))
    hi = luts.max(axis=(1, 2))
    rng = hi - lo
    degenerate = rng < 1e-10
    scale = np.where(degenerate, 1.0, 255.0 / np.where(degenerate, 1.0, rng))
    multiplier = np.where(degenerate, 1.0, 1.0 / scale)
    q = np.floor((luts - lo[:, None, None]) * scale[:, None, None] + 0.5)
    return np.clip(q, 0, 255).astype(np.uint8), multiplier.astype(np.float32), lo.astype(np.float32)
