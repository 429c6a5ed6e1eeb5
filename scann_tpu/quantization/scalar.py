"""Int8/int4 scalar quantization.

Byte-compatible with the reference's codec
(reference: src/quantization/scalar.rs:103-176):

    levels    = 2^bits - 1
    calibrate: [min, max] from explicit range, symmetric abs-max, or
               mean ± num_std_devs*std clipped to observed min/max
    quantize:  q = clamp(round((clamp(v, min, max) - min) * inv_scale), 0, levels)
    store:     q as a raw byte (the reference stores it in an i8, so values
               128..255 wrap negative — the *bytes* are identical; we store
               uint8 on device and expose an i8 view for byte-parity checks)
    dequant:   v' = u8(q) * scale + min        (scalar.rs:168-172)

Note a reference inconsistency we deliberately do NOT reproduce: its SIMD
search path dequantizes as *signed* ``i8 * scale`` with no min offset
(reference: src/distance_measures/one_to_many_asymmetric.rs:53-74), which
disagrees with its own codec above and degrades ranking for non-symmetric
calibrations. Our asymmetric scoring (ops/asymmetric.py) uses the codec's
dequantization exactly, so recall is >= the reference's at identical bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.quantization.stats import QuantizationStats
from scann_tpu.types import SUBLANE_I8, align_up


@dataclasses.dataclass
class ScalarQuantizerConfig:
    """(reference: src/quantization/scalar.rs:14-68)."""

    bits: int = 8
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    symmetric: bool = False
    num_std_devs: float = 3.0

    def with_range(self, lo: float, hi: float) -> "ScalarQuantizerConfig":
        self.min_value, self.max_value = lo, hi
        return self


class ScalarQuantizer:
    """Calibrated scalar quantizer (reference: src/quantization/scalar.rs:70-176)."""

    def __init__(self, config: Optional[ScalarQuantizerConfig] = None):
        self.config = config or ScalarQuantizerConfig()
        if self.config.bits not in (4, 8):
            raise ScannError.invalid_argument(f"bits must be 4 or 8, got {self.config.bits}")
        self.num_levels = (1 << self.config.bits) - 1
        self.min_value = 0.0
        self.max_value = 1.0
        self.scale = 1.0
        self.inv_scale = 1.0
        self.zero_point = 0

    def calibrate(self, stats: QuantizationStats) -> "ScalarQuantizer":
        cfg = self.config
        if cfg.min_value is not None and cfg.max_value is not None:
            self.min_value, self.max_value = cfg.min_value, cfg.max_value
        elif cfg.symmetric:
            abs_max = max(abs(stats.min_value), abs(stats.max_value))
            self.min_value, self.max_value = -abs_max, abs_max
        else:
            # mean +/- k*std, clipped to observed range (scalar.rs:113-119)
            rng = cfg.num_std_devs * stats.std_dev
            self.min_value = max(stats.mean - rng, stats.min_value)
            self.max_value = min(stats.mean + rng, stats.max_value)

        span = self.max_value - self.min_value
        if span > 1e-10:
            self.scale = span / self.num_levels
            self.inv_scale = self.num_levels / span
            self.zero_point = int(round(-self.min_value * self.inv_scale))
        else:
            self.scale = 1.0
            self.inv_scale = 1.0
            self.zero_point = 0
        return self

    def calibrate_from_dataset(self, dataset: DenseDataset) -> "ScalarQuantizer":
        return self.calibrate(QuantizationStats.from_dataset(dataset))

    def calibrate_from_array(self, arr: np.ndarray) -> "ScalarQuantizer":
        return self.calibrate(QuantizationStats.from_array(arr))

    # -- codec (vectorized, matches scalar.rs:162-172 bit-for-bit) -----------
    def quantize(self, values: np.ndarray) -> np.ndarray:
        """f32 -> uint8 codes 0..num_levels."""
        values = np.asarray(values, dtype=np.float32)
        if values.size >= 1 << 22:
            return self._quantize_device(values)
        v = np.clip(values, self.min_value, self.max_value)
        # np.round = banker's rounding; the reference uses Rust round()
        # (half away from zero). Arguments here are >= 0, so floor(x+0.5) matches.
        q = np.floor((v - self.min_value) * np.float32(self.inv_scale) + 0.5).astype(np.int64)
        return np.clip(q, 0, self.num_levels).astype(np.uint8)

    def _quantize_device(self, values: np.ndarray) -> np.ndarray:
        """Same codec math on the accelerator — large arrays quantize far
        faster than the host CPU can in constrained containers."""
        import jax

        def f(v):
            v = jnp.clip(v, self.min_value, self.max_value)
            q = jnp.floor((v - self.min_value) * jnp.float32(self.inv_scale) + 0.5)
            return jnp.clip(q, 0, self.num_levels).astype(jnp.uint8)

        return np.asarray(jax.jit(f)(jnp.asarray(values)))

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        """uint8 codes (or the reference's i8 bytes) -> f32."""
        u = np.asarray(codes).view(np.uint8) if np.asarray(codes).dtype == np.int8 \
            else np.asarray(codes, dtype=np.uint8)
        return u.astype(np.float32) * np.float32(self.scale) + np.float32(self.min_value)

    def quantize_value(self, value: float) -> int:
        return int(self.quantize(np.array([value]))[0])

    def dequantize_value(self, code: int) -> float:
        return float(self.dequantize(np.array([code & 0xFF], dtype=np.uint8))[0])


class PrecomputedQuery:
    """Per-query 256-entry dequantization table
    (reference: src/quantization/scalar.rs:298-324): precomputes
    ``dequant(code)`` for all byte values so host-side scalar scoring avoids
    the multiply-add per element. Provided for API parity; device scoring
    uses the affine-matmul trick instead (ops/asymmetric.py)."""

    def __init__(self, query: np.ndarray, quantizer: "ScalarQuantizer"):
        self.query = np.asarray(query, dtype=np.float32)
        codes = np.arange(256, dtype=np.uint8)
        self.dequant_table = quantizer.dequantize(codes)  # [256] f32

    def squared_l2_to_codes(self, codes: np.ndarray) -> float:
        """Exact distance between the query and one quantized row."""
        vals = self.dequant_table[np.asarray(codes, np.uint8)]
        diff = self.query - vals
        return float((diff * diff).sum())


class QuantizedDataset:
    """Quantized database: uint8 codes + calibration, with device views.

    (reference: src/quantization/scalar.rs:180-296). Device layout: codes as a
    [N_pad, D] uint8 HBM array plus precomputed dequantized squared norms for
    the asymmetric matmul trick (see ops/asymmetric.py).
    """

    def __init__(self, codes: np.ndarray, quantizer: ScalarQuantizer):
        codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2:
            raise ScannError.invalid_argument("codes must be [N, D]")
        self.codes = codes
        self.quantizer = quantizer
        self._device_cache = None

    @classmethod
    def from_dataset(cls, dataset: DenseDataset,
                     quantizer: Optional[ScalarQuantizer] = None) -> "QuantizedDataset":
        q = quantizer or ScalarQuantizer()
        q.calibrate_from_dataset(dataset)
        return cls(q.quantize(dataset.numpy()), q)

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def dimensionality(self) -> int:
        return self.codes.shape[1]

    def raw_data_i8(self) -> np.ndarray:
        """The reference's byte-identical i8 view (scalar.rs stores i8)."""
        return self.codes.view(np.int8)

    def get_quantized(self, index: int) -> np.ndarray:
        return self.codes[index]

    def dequantize_row(self, index: int) -> np.ndarray:
        return self.quantizer.dequantize(self.codes[index])

    def dequantize_all(self) -> np.ndarray:
        return self.quantizer.dequantize(self.codes)

    def memory_usage_bytes(self) -> int:
        return int(self.codes.nbytes)

    def compression_ratio(self) -> float:
        return 4.0  # f32 -> one byte per value

    def _device_norms(self, codes_dev: jnp.ndarray) -> jnp.ndarray:
        """Dequantized squared norms computed on device (f32)."""
        import jax

        scale = jnp.float32(self.quantizer.scale)
        lo = jnp.float32(self.quantizer.min_value)

        def f(c):
            d = c.astype(jnp.float32) * scale + lo
            return jnp.sum(d * d, axis=1)

        return jax.jit(f)(codes_dev)

    def device(self) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
        """(codes [N_pad, D] uint8, dequantized sq-norms [N_pad] f32, n)."""
        if self._device_cache is None:
            n = max(self.size, 1)
            n_pad = align_up(n, SUBLANE_I8)
            codes = self.codes
            if n_pad != self.size:
                codes = np.zeros((n_pad, self.dimensionality), dtype=np.uint8)
                codes[: self.size] = self.codes
            codes_dev = jnp.asarray(codes)
            self._device_cache = (codes_dev, self._device_norms(codes_dev))
        return self._device_cache[0], self._device_cache[1], self.size
