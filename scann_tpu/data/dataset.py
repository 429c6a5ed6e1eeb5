"""Dataset containers.

``DenseDataset`` replaces the reference's 64-byte-aligned strided flat storage
(reference: src/data_format/dataset.rs:46-303) with a host numpy staging array
plus a cached device-resident array padded along N to a multiple of 8;
padded rows are masked out of every scoring program via the valid
count. ``SparseDataset`` mirrors the vec-of-vecs sparse container
(reference: src/data_format/dataset.rs:306-427).

``Datapoint`` is the owned dense-or-sparse point type
(reference: src/data_format/datapoint.rs:13-152).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from scann_tpu.data.docid import DocIdCollection
from scann_tpu.errors import ScannError
from scann_tpu.types import SUBLANE_F32, align_up


class Datapoint:
    """Owned dense-or-sparse datapoint (reference: src/data_format/datapoint.rs:13-152)."""

    def __init__(
        self,
        values: np.ndarray,
        indices: Optional[np.ndarray] = None,
        dimensionality: Optional[int] = None,
    ):
        self.values = np.asarray(values)
        self.indices = None if indices is None else np.asarray(indices, dtype=np.int64)
        if self.indices is not None:
            if len(self.indices) != len(self.values):
                raise ScannError.invalid_argument("indices/values length mismatch")
            if len(self.indices) > 1 and np.any(np.diff(self.indices) < 0):
                # get() binary-searches the indices: keep them sorted no
                # matter the construction order (the reference requires
                # ascending sparse indices; we normalize instead)
                order = np.argsort(self.indices, kind="stable")
                self.indices = self.indices[order]
                self.values = self.values[order]
            self.dimensionality = dimensionality if dimensionality is not None else (
                int(self.indices.max()) + 1 if len(self.indices) else 0
            )
        else:
            self.dimensionality = len(self.values)

    @classmethod
    def dense(cls, values) -> "Datapoint":
        return cls(np.asarray(values))

    @classmethod
    def sparse(cls, indices, values, dimensionality: Optional[int] = None) -> "Datapoint":
        return cls(np.asarray(values), np.asarray(indices), dimensionality)

    @property
    def is_dense(self) -> bool:
        return self.indices is None

    @property
    def is_sparse(self) -> bool:
        return self.indices is not None

    def get(self, dim: int) -> float:
        """Value at dimension ``dim``; O(1) dense, binary search sparse."""
        if self.is_dense:
            return float(self.values[dim])
        pos = np.searchsorted(self.indices, dim)
        if pos < len(self.indices) and self.indices[pos] == dim:
            return float(self.values[pos])
        return 0.0

    def to_dense(self) -> "Datapoint":
        if self.is_dense:
            return self
        out = np.zeros(self.dimensionality, dtype=np.asarray(self.values).dtype)
        out[self.indices] = self.values
        return Datapoint(out)

    def squared_l2_norm(self) -> float:
        v = self.values.astype(np.float64)
        return float(np.dot(v, v))

    def l2_norm(self) -> float:
        return math.sqrt(self.squared_l2_norm())

    def normalize(self) -> "Datapoint":
        n = self.l2_norm()
        if n == 0.0:
            return self
        return Datapoint(self.values / n, self.indices, self.dimensionality)


class DenseDataset:
    """[N, D] dense dataset with cached padded device array.

    Host staging is a numpy f32 array; ``device()`` returns a jnp array whose
    leading dim is padded up to a sublane multiple (padding rows are zeros and
    masked out by consumers via ``n``). Mutation (``append``) invalidates the
    device cache — device arrays are immutable snapshots, matching the
    RCU-snapshot philosophy of the reference's mutator
    (reference: src/mutator/mod.rs:233-246).
    """

    def __init__(self, data: np.ndarray, docids: Optional[Iterable] = None, dtype=np.float32):
        data = np.asarray(data, dtype=dtype)
        if data.ndim != 2:
            raise ScannError.invalid_argument(f"expected [N, D] array, got shape {data.shape}")
        self._data = data
        self._docids = DocIdCollection(docids) if docids is not None else None
        if self._docids is not None and len(self._docids) != data.shape[0]:
            raise ScannError.invalid_argument("docid count != datapoint count")
        self._device_cache = None

    # -- constructors (reference: src/data_format/dataset.rs:98-170) -------
    @classmethod
    def from_vecs(cls, vecs: Sequence[Sequence[float]], docids=None, dtype=np.float32):
        return cls(np.asarray(vecs, dtype=dtype), docids=docids, dtype=dtype)

    @classmethod
    def from_flat(cls, flat: Sequence[float], dimensionality: int, docids=None, dtype=np.float32):
        arr = np.asarray(flat, dtype=dtype)
        if dimensionality <= 0 or arr.size % dimensionality != 0:
            raise ScannError.invalid_argument(
                f"flat length {arr.size} not divisible by dimensionality {dimensionality}"
            )
        return cls(arr.reshape(-1, dimensionality), docids=docids, dtype=dtype)

    @classmethod
    def empty(cls, dimensionality: int, dtype=np.float32):
        return cls(np.zeros((0, dimensionality), dtype=dtype), dtype=dtype)

    # -- basic accessors ----------------------------------------------------
    def __len__(self) -> int:
        return self._data.shape[0]

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def docids(self) -> Optional[DocIdCollection]:
        return self._docids

    def get(self, index: int) -> np.ndarray:
        if not 0 <= index < self.size:
            raise ScannError.out_of_range(f"index {index} out of range [0, {self.size})")
        return self._data[index]

    def __getitem__(self, index: int) -> np.ndarray:
        return self.get(index)

    def numpy(self) -> np.ndarray:
        """Host view, unpadded [N, D]."""
        return self._data

    # -- mutation ------------------------------------------------------------
    def append(self, point: np.ndarray, docid=None) -> int:
        point = np.asarray(point, dtype=self._data.dtype)
        if point.shape != (self.dimensionality,):
            raise ScannError.invalid_argument(
                f"point shape {point.shape} != ({self.dimensionality},)"
            )
        self._data = np.concatenate([self._data, point[None, :]], axis=0)
        if docid is not None:
            if self._docids is None:
                self._docids = DocIdCollection()
            self._docids.add(docid)
        self._device_cache = None
        return self.size - 1

    # -- device view ----------------------------------------------------------
    def device(self) -> Tuple[jnp.ndarray, int]:
        """(padded [N_pad, D] device array, n_valid). Cached until mutation.
        Padding happens on device — the upload is the only host-side cost."""
        if self._device_cache is None:
            n = max(self.size, 1)
            n_pad = align_up(n, SUBLANE_F32)
            arr = jnp.asarray(self._data if self.size else
                              np.zeros((1, self.dimensionality), self._data.dtype))
            if n_pad != arr.shape[0]:
                arr = jnp.pad(arr, ((0, n_pad - arr.shape[0]), (0, 0)))
            self._device_cache = arr
        return self._device_cache, self.size

    def drop_device_cache(self) -> None:
        """Free the cached device array (host data stays). Used by serving
        setups that re-rank from a lower-precision copy (e.g. tree-AH with
        ``rerank_dtype='bfloat16'``) and no longer need the f32 HBM copy the
        build used — 8 GB at 20M x 100d."""
        self._device_cache = None

    def memory_usage_bytes(self) -> int:
        return int(self._data.nbytes)


class SparseDataset:
    """Vec-of-vecs sparse dataset (reference: src/data_format/dataset.rs:306-427)."""

    def __init__(self, dimensionality: int):
        self._dim = dimensionality
        self._points: List[Datapoint] = []

    @property
    def dimensionality(self) -> int:
        return self._dim

    @property
    def size(self) -> int:
        return len(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def append(self, indices, values) -> int:
        dp = Datapoint.sparse(indices, values, self._dim)
        if len(dp.indices) and int(dp.indices.max()) >= self._dim:
            raise ScannError.out_of_range("sparse index beyond dimensionality")
        self._points.append(dp)
        return len(self._points) - 1

    def get(self, index: int) -> Datapoint:
        return self._points[index]

    def to_dense(self) -> DenseDataset:
        out = np.zeros((len(self._points), self._dim), dtype=np.float32)
        for i, p in enumerate(self._points):
            out[i, p.indices] = p.values
        return DenseDataset(out)

    def to_padded_csr(self, max_nnz: Optional[int] = None):
        """CSR-style padded arrays (indices [N, max_nnz] int32 with -1 pad,
        values [N, max_nnz] f32) for device-side sparse scoring."""
        if max_nnz is None:
            max_nnz = max((len(p.values) for p in self._points), default=1)
        n = len(self._points)
        idx = np.full((n, max_nnz), -1, dtype=np.int32)
        val = np.zeros((n, max_nnz), dtype=np.float32)
        for i, p in enumerate(self._points):
            m = min(len(p.values), max_nnz)
            idx[i, :m] = p.indices[:m]
            val[i, :m] = p.values[:m]
        return jnp.asarray(idx), jnp.asarray(val)
