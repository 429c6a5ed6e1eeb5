"""Product-quantization codebook.

The reference trains one k-means per subspace sequentially with seed+s
(reference: src/hashes/codebook.rs:146-202) and encodes with a scalar argmin
loop (:82-95,205-245). Here the codebook is a single [S, C, d_sub] tensor;
training runs the on-device k-means per subspace (same seed+s convention) and
encoding is one batched program: reshape [N, S, d_sub], distance einsum
against all subspace centroids at once, argmin -> [N, S] uint8 codes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.errors import ScannError
from scann_tpu.trees.kmeans import KMeans, KMeansConfig, KMeansInit


@dataclasses.dataclass
class CodebookConfig:
    """(reference: src/hashes/codebook.rs:119-144).

    ``anisotropic_threshold`` (extension, no reference counterpart):
    when set, per-subspace k-means only initializes the codebook and
    training continues under the score-aware anisotropic loss of Guo et al.
    2020 (see hashes/avq.py) — ScaNN's MIPS-recall lever; its default there
    is T=0.2. Encoding then also minimizes the anisotropic loss."""

    num_codes: int = 256
    num_subspaces: int = 8
    max_iterations: int = 25
    convergence_threshold: float = 1e-4
    seed: Optional[int] = None
    anisotropic_threshold: Optional[float] = None
    avq_iters: int = 8


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def encode_kernel(data: jnp.ndarray, centroids: jnp.ndarray, chunk_size: int = 8192):
    """[N, D] f32, [S, C, d_sub] -> [N, S] int32 argmin codes."""
    n, d = data.shape
    s, c, dsub = centroids.shape
    cent_sq = jnp.sum(centroids * centroids, axis=-1)  # [S, C]

    def one_chunk(x):
        xs = x.reshape(x.shape[0], s, dsub)
        # default precision: argmin code assignment tolerates bf16 passes
        dots = jnp.einsum("nsd,scd->nsc", xs, centroids)
        x_sq = jnp.sum(xs * xs, axis=-1)  # [n, S]
        dists = x_sq[:, :, None] + cent_sq[None, :, :] - 2.0 * dots
        return jnp.argmin(dists, axis=-1).astype(jnp.int32)

    if n <= chunk_size:
        return one_chunk(data)
    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    padded = jnp.pad(data, ((0, n_pad - n), (0, 0)))
    out = jax.lax.map(one_chunk, padded.reshape(n_chunks, chunk_size, d))
    return out.reshape(n_pad, s)[:n]


@jax.jit
def lut_kernel(queries: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    """Per-query squared-L2 lookup tables [B, S, C] from [B, D] queries
    (reference: src/hashes/lut.rs:47-70 builds these per query on the host).
    One batched einsum."""
    b, d = queries.shape
    s, c, dsub = centroids.shape
    qs = queries.reshape(b, s, dsub)
    dots = jnp.einsum("bsd,scd->bsc", qs, centroids,
                      precision=jax.lax.Precision.HIGHEST)
    q_sq = jnp.sum(qs * qs, axis=-1)
    cent_sq = jnp.sum(centroids * centroids, axis=-1)
    return jnp.maximum(q_sq[:, :, None] + cent_sq[None, :, :] - 2.0 * dots, 0.0)


class Codebook:
    """[S, C, d_sub] PQ codebook with on-device train/encode/decode."""

    def __init__(self, config: Optional[CodebookConfig] = None):
        self.config = config or CodebookConfig()
        self.centroids: Optional[np.ndarray] = None  # [S, C, d_sub]
        self.dimensionality = 0
        self.dims_per_subspace = 0
        self._centroids_dev = None
        self.eta: Optional[float] = None  # anisotropic weight ratio, if AVQ

    def train(self, data, directions=None) -> "Codebook":
        """Train the codebook. ``directions`` (AVQ only): [N, D] unit rows
        of the ORIGINAL datapoints — for residual quantization (tree-AH)
        the anisotropic loss weights error along the original point's
        direction, not the residual's; defaults to normalized ``data``."""
        arr = data.numpy() if hasattr(data, "numpy") else np.asarray(data, np.float32)
        if arr.shape[0] == 0:
            raise ScannError.invalid_argument("Cannot train on empty dataset")
        n, d = arr.shape
        s = self.config.num_subspaces
        if d % s != 0:
            raise ScannError.invalid_argument(
                f"Dimensionality {d} must be divisible by num_subspaces {s}"
            )
        self.dimensionality = d
        self.dims_per_subspace = d // s
        c = min(self.config.num_codes, n)
        seed = self.config.seed if self.config.seed is not None else 42

        subs = arr.reshape(n, s, self.dims_per_subspace)
        centroids = np.zeros((s, c, self.dims_per_subspace), dtype=np.float32)
        for sub in range(s):
            km = KMeans(KMeansConfig(
                num_clusters=c,
                max_iterations=self.config.max_iterations,
                convergence_threshold=self.config.convergence_threshold,
                init_method=KMeansInit.KMEANS_PLUS_PLUS,
                seed=seed + sub,  # reference: codebook.rs:193 seed + s
            ))
            centroids[sub] = km.fit(subs[:, sub, :]).centers
        if self.config.anisotropic_threshold is not None:
            from scann_tpu.hashes.avq import (
                anisotropic_eta,
                avq_refine_kernel,
                unit_directions,
            )

            self.eta = anisotropic_eta(self.config.anisotropic_threshold, d)
            x_dev = jnp.asarray(arr)
            h_dev = (unit_directions(x_dev) if directions is None
                     else unit_directions(directions))
            cent_dev, _, _ = avq_refine_kernel(
                x_dev, h_dev, jnp.asarray(centroids), self.eta,
                iters=int(self.config.avq_iters))
            self.centroids = np.asarray(cent_dev)
            self._centroids_dev = cent_dev
            return self
        self.centroids = centroids
        self._centroids_dev = jnp.asarray(centroids)
        return self

    @property
    def num_codes(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[1]

    @property
    def num_subspaces(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[0]

    def centroids_device(self) -> jnp.ndarray:
        self._check_trained()
        if self._centroids_dev is None:
            self._centroids_dev = jnp.asarray(self.centroids)
        return self._centroids_dev

    def _check_trained(self):
        if self.centroids is None:
            raise ScannError.failed_precondition("codebook not trained")

    # -- encode / decode ----------------------------------------------------
    def encode_dataset(self, data, directions=None) -> np.ndarray:
        """[N, D] -> [N, S] uint8 codes. Accepts numpy, DenseDataset, or an
        already-device jnp array (no host round trip — a 5M x 100d residual
        tensor is 2GB; downloading it just to re-upload dominated build).

        Under AVQ training, encoding is score-aware coordinate descent;
        ``directions`` are the original points' unit rows (default:
        normalized ``data``)."""
        self._check_trained()
        if hasattr(data, "numpy"):
            arr = jnp.asarray(data.numpy())
        elif isinstance(data, jnp.ndarray):
            arr = data.astype(jnp.float32)
        else:
            arr = jnp.asarray(np.asarray(data, np.float32))
        if self.eta is not None:
            from scann_tpu.hashes.avq import avq_encode_kernel, unit_directions

            h = (unit_directions(arr) if directions is None
                 else unit_directions(directions))
            codes = avq_encode_kernel(arr, h, self.centroids_device(), self.eta)
        else:
            codes = encode_kernel(arr, self.centroids_device())
        return np.asarray(codes).astype(np.uint8)

    def encode(self, point: np.ndarray) -> np.ndarray:
        return self.encode_dataset(np.asarray(point, np.float32)[None, :])[0]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """[.., S] codes -> [.., D] reconstruction."""
        self._check_trained()
        codes = np.asarray(codes, dtype=np.int64)
        # gather per-subspace centroid then concatenate along dims
        parts = self.centroids[np.arange(self.num_subspaces), codes]  # [.., S, d_sub]
        return parts.reshape(*codes.shape[:-1], self.dimensionality)

    def reconstruction_error(self, data: np.ndarray) -> float:
        arr = np.asarray(data, np.float32)
        rec = self.decode(self.encode_dataset(arr))
        return float(((arr - rec) ** 2).sum(-1).mean())

    # -- lookup tables -------------------------------------------------------
    def lookup_tables(self, queries: np.ndarray) -> jnp.ndarray:
        """[B, D] queries -> [B, S, C] squared-L2 LUTs on device."""
        self._check_trained()
        q = jnp.asarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None, :]
        return lut_kernel(q, self.centroids_device())
