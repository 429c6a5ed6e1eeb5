"""bfloat16 dataset.

The reference converts elementwise through the ``half`` crate
(reference: src/quantization/bfloat16.rs:12-109); on the device bfloat16 is
a native dtype, so this is just a dataset whose device array is bf16 (2x
compression, native bf16 matrix products).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

import ml_dtypes

from scann_tpu.errors import ScannError
from scann_tpu.types import SUBLANE_BF16, align_up


class BFloat16Dataset:
    """[N, D] bf16 database with padded device view."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ScannError.invalid_argument("expected [N, D]")
        self._data = data.astype(ml_dtypes.bfloat16)
        self._device_cache = None

    @classmethod
    def from_f32(cls, data: np.ndarray) -> "BFloat16Dataset":
        return cls(np.asarray(data, dtype=np.float32))

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    def to_f32(self) -> np.ndarray:
        return self._data.astype(np.float32)

    def get(self, index: int) -> np.ndarray:
        return self._data[index].astype(np.float32)

    def memory_usage_bytes(self) -> int:
        return int(self._data.nbytes)

    def compression_ratio(self) -> float:
        return 2.0

    def device(self) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
        """(codes [N_pad, D] bf16, sq-norms [N_pad] f32, n)."""
        if self._device_cache is None:
            n = max(self.size, 1)
            n_pad = align_up(n, SUBLANE_BF16)
            arr = self._data
            if n_pad != self.size:
                arr = np.zeros((n_pad, self.dimensionality), dtype=ml_dtypes.bfloat16)
                arr[: self.size] = self._data
            f32 = arr.astype(np.float64)
            norms = (f32 * f32).sum(axis=1).astype(np.float32)
            self._device_cache = (jnp.asarray(arr), jnp.asarray(norms))
        return self._device_cache[0], self._device_cache[1], self.size
