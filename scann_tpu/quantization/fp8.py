"""fp8 (E4M3 / E5M2) quantization.

The reference hand-rolls the bit codec (reference: src/quantization/fp8.rs:
64-220). In JAX fp8 is a native dtype (``jnp.float8_e4m3fn`` /
``jnp.float8_e5m2`` via ml_dtypes), so the codec is a dtype cast; we keep
scalar ``encode``/``decode`` helpers for bit-level tests and a dataset
container with a padded device view (4x compression).
"""

from __future__ import annotations

import enum
from typing import Tuple

import jax.numpy as jnp
import numpy as np

import ml_dtypes

from scann_tpu.errors import ScannError
from scann_tpu.types import SUBLANE_I8, align_up


class Fp8Format(enum.Enum):
    E4M3 = "E4M3"
    E5M2 = "E5M2"

    @property
    def np_dtype(self):
        return ml_dtypes.float8_e4m3fn if self is Fp8Format.E4M3 else ml_dtypes.float8_e5m2

    @property
    def jnp_dtype(self):
        return jnp.float8_e4m3fn if self is Fp8Format.E4M3 else jnp.float8_e5m2

    @property
    def max_value(self) -> float:
        return 448.0 if self is Fp8Format.E4M3 else 57344.0


class Fp8Quantizer:
    """Elementwise fp8 codec (reference: src/quantization/fp8.rs:223-260)."""

    def __init__(self, fmt: Fp8Format = Fp8Format.E4M3):
        self.format = fmt

    def quantize(self, values: np.ndarray) -> np.ndarray:
        # Saturate instead of overflowing to NaN — the reference's codec
        # clamps overflow to the max representable (fp8.rs:108-112).
        v = np.asarray(values, dtype=np.float32)
        m = self.format.max_value
        return np.clip(v, -m, m).astype(self.format.np_dtype)

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(codes, dtype=self.format.np_dtype).astype(np.float32)

    def encode_bits(self, value: float) -> int:
        """f32 -> raw fp8 byte."""
        return int(self.quantize(np.array([value])).view(np.uint8)[0])

    def decode_bits(self, bits: int) -> float:
        """raw fp8 byte -> f32."""
        return float(np.array([bits], dtype=np.uint8).view(self.format.np_dtype)[0])


class Fp8Dataset:
    """[N, D] fp8 database with padded device view."""

    def __init__(self, data: np.ndarray, fmt: Fp8Format = Fp8Format.E4M3):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ScannError.invalid_argument("expected [N, D]")
        self.format = fmt
        self._data = data.astype(np.float32).astype(fmt.np_dtype)
        self._device_cache = None

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    def to_f32(self) -> np.ndarray:
        return self._data.astype(np.float32)

    def raw_bytes(self) -> np.ndarray:
        return self._data.view(np.uint8)

    def memory_usage_bytes(self) -> int:
        return int(self._data.nbytes)

    def compression_ratio(self) -> float:
        return 4.0

    def device(self) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
        """(codes [N_pad, D] fp8, sq-norms [N_pad] f32, n)."""
        if self._device_cache is None:
            n = max(self.size, 1)
            n_pad = align_up(n, SUBLANE_I8)
            arr = self._data
            if n_pad != self.size:
                arr = np.zeros((n_pad, self.dimensionality), dtype=self.format.np_dtype)
                arr[: self.size] = self._data
            f32 = arr.astype(np.float64)
            norms = (f32 * f32).sum(axis=1).astype(np.float32)
            self._device_cache = (jnp.asarray(arr), jnp.asarray(norms))
        return self._device_cache[0], self._device_cache[1], self.size
