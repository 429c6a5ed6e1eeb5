"""Anisotropic vector quantization — score-aware PQ training for MIPS.

An extension beyond the reference (no counterpart anywhere in the
reference — it trains plain reconstruction-loss k-means
per subspace, src/hashes/codebook.rs:146-202). Implements the anisotropic
loss of Guo et al., "Accelerating Large-Scale Inference with Anisotropic
Vector Quantization" (ICML 2020): quantization error parallel to the
datapoint direction perturbs inner-product scores of the high-scoring
queries far more than orthogonal error, so it is weighted eta >= 1 times
heavier.  With residual r = x - x_tilde and unit direction x_hat:

    loss(x, x_tilde) = ||r_orth||^2 + eta * ||r_par||^2
                     = ||r||^2 + (eta - 1) * <r, x_hat>^2

where eta = (d - 1) * T^2 / (1 - T^2) for the paper's threshold
parameterization T (ScaNN's ``anisotropic_quantization_threshold``,
default 0.2).

Training alternates two jit-compiled device programs:

* **code assignment** — exact coordinate descent across subspaces.  The
  parallel term couples subspaces (<r, x_hat> = sum_s <r_s, x_hat_s>), so
  codes are updated one subspace at a time inside a ``lax.scan`` that
  carries the running parallel-residual dot t = <r, x_hat>; each step is a
  batched [N, C] einsum + argmin (matmul-shaped, static shapes).
* **centroid update** — closed form.  Setting the gradient of the summed
  loss to zero gives, per (subspace, code) with assigned points I:

      (|I| * Id + (eta-1) * sum_I x_hat x_hat^T) c
          = sum_I x + (eta-1) * sum_I (<x, x_hat> + t_rest) x_hat

  assembled with one ``segment_sum`` over flattened (subspace, code) ids
  and solved as a batched [S*C, d_sub, d_sub] ``jnp.linalg.solve``.

The codes that fall out rank by *score impact*, not reconstruction error;
at equal bit budget MIPS/cosine recall improves (tests/test_avq.py
measures the gain on heavy-tailed-norm data).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def anisotropic_eta(threshold: float, dim: int) -> float:
    """Parallel/orthogonal weight ratio from ScaNN's threshold parameter
    (Guo et al. 2020, Thm 3.3): eta = (d-1) T^2 / (1 - T^2)."""
    t2 = float(threshold) * float(threshold)
    if not 0.0 < t2 < 1.0:
        raise ValueError(f"anisotropic threshold must be in (0, 1), got {threshold}")
    return max((dim - 1) * t2 / (1.0 - t2), 1.0)


def _split_subspaces(x: jnp.ndarray, s: int) -> jnp.ndarray:
    n, d = x.shape
    return x.reshape(n, s, d // s).transpose(1, 0, 2)  # [S, N, d_sub]


def _assign_pass(xs, hs, centroids, codes, contribs, t, eta):
    """One full coordinate-descent sweep over subspaces.

    xs, hs: [S, N, d_sub]; centroids: [S, C, d_sub]; codes/contribs: [S, N];
    t: [N] current total parallel dot <r, x_hat>. Returns updated
    (codes, contribs, t).
    """
    s = xs.shape[0]

    def step(carry, inputs):
        codes, contribs, t = carry
        si, x_s, h_s, c_s = inputs  # [N,d], [N,d], [C,d]
        x_sq = jnp.sum(x_s * x_s, axis=-1)                    # [N]
        c_sq = jnp.sum(c_s * c_s, axis=-1)                    # [C]
        xc = x_s @ c_s.T                                      # [N, C]
        d1 = x_sq[:, None] - 2.0 * xc + c_sq[None, :]         # ||x_s - c_j||^2
        xh = jnp.sum(x_s * h_s, axis=-1)                      # [N]
        hc = h_s @ c_s.T                                      # [N, C]
        d2 = xh[:, None] - hc                                 # <x_s - c_j, h_s>
        t_rest = t - jax.lax.dynamic_index_in_dim(contribs, si, 0, keepdims=False)
        score = d1 + (eta - 1.0) * jnp.square(d2 + t_rest[:, None])
        new_code = jnp.argmin(score, axis=-1).astype(jnp.int32)
        new_contrib = jnp.take_along_axis(d2, new_code[:, None], axis=1)[:, 0]
        codes = jax.lax.dynamic_update_index_in_dim(codes, new_code, si, 0)
        contribs = jax.lax.dynamic_update_index_in_dim(contribs, new_contrib, si, 0)
        return (codes, contribs, t_rest + new_contrib), None

    (codes, contribs, t), _ = jax.lax.scan(
        step, (codes, contribs, t),
        (jnp.arange(s, dtype=jnp.int32), xs, hs, centroids))
    return codes, contribs, t


def _init_assignment(xs, hs, centroids):
    """Plain L2 argmin codes + the contribs/t bookkeeping they imply."""
    c_sq = jnp.sum(centroids * centroids, axis=-1)            # [S, C]
    xc = jnp.einsum("snd,scd->snc", xs, centroids)            # [S, N, C]
    x_sq = jnp.sum(xs * xs, axis=-1)                          # [S, N]
    d1 = x_sq[:, :, None] - 2.0 * xc + c_sq[:, None, :]
    codes = jnp.argmin(d1, axis=-1).astype(jnp.int32)         # [S, N]
    xh = jnp.sum(xs * hs, axis=-1)                            # [S, N]
    hc = jnp.einsum("snd,scd->snc", hs, centroids)            # [S, N, C]
    d2 = xh[:, :, None] - hc
    contribs = jnp.take_along_axis(d2, codes[:, :, None], axis=2)[:, :, 0]
    return codes, contribs, jnp.sum(contribs, axis=0)


def _update_centroids(xs, hs, centroids, codes, contribs, t, eta):
    """Closed-form anisotropic centroid update (batched normal equations)."""
    s, n, dsub = xs.shape
    c = centroids.shape[1]
    ids = (codes + (jnp.arange(s, dtype=jnp.int32) * c)[:, None]).reshape(-1)
    t_rest = t[None, :] - contribs                            # [S, N]
    xh = jnp.sum(xs * hs, axis=-1)                            # [S, N]

    hh = hs[..., :, None] * hs[..., None, :]                  # [S, N, d, d]
    rhs2 = (xh + t_rest)[..., None] * hs                      # [S, N, d]
    ones = jnp.ones((s, n, 1), xs.dtype)
    flat = jnp.concatenate(
        [hh.reshape(s, n, dsub * dsub), xs, rhs2, ones], axis=-1
    ).reshape(s * n, -1)
    sums = jax.ops.segment_sum(flat, ids, num_segments=s * c)  # [S*C, F]

    hh_sum = sums[:, : dsub * dsub].reshape(s * c, dsub, dsub)
    x_sum = sums[:, dsub * dsub: dsub * dsub + dsub]
    r2_sum = sums[:, dsub * dsub + dsub: dsub * dsub + 2 * dsub]
    counts = sums[:, -1]

    eye = jnp.eye(dsub, dtype=xs.dtype)
    # ridge keeps empty clusters solvable; their solution is discarded below
    a = counts[:, None, None] * eye + (eta - 1.0) * hh_sum + 1e-6 * eye
    b = x_sum + (eta - 1.0) * r2_sum
    sol = jnp.linalg.solve(a, b[..., None])[..., 0].reshape(s, c, dsub)
    keep = (counts.reshape(s, c) > 0.5)[..., None]
    return jnp.where(keep, sol, centroids)


@functools.partial(jax.jit, static_argnames=("iters",))
def avq_refine_kernel(x, x_hat, centroids, eta, *, iters: int = 8):
    """Refine [S, C, d_sub] centroids under the anisotropic loss.

    x: [N, D] vectors to quantize (points, or residuals for tree-AH);
    x_hat: [N, D] unit direction of the ORIGINAL datapoint (== normalized x
    for a standalone hasher). Returns (centroids, codes [N, S] int32,
    mean anisotropic loss scalar).
    """
    s = centroids.shape[0]
    xs = _split_subspaces(x, s)
    hs = _split_subspaces(x_hat, s)
    eta = jnp.asarray(eta, x.dtype)

    codes, contribs, t = _init_assignment(xs, hs, centroids)

    def body(_, carry):
        centroids, codes, contribs, t = carry
        codes, contribs, t = _assign_pass(xs, hs, centroids, codes, contribs, t, eta)
        centroids = _update_centroids(xs, hs, centroids, codes, contribs, t, eta)
        return centroids, codes, contribs, t

    centroids, codes, contribs, t = jax.lax.fori_loop(
        0, iters, body, (centroids, codes, contribs, t))
    # final re-assignment against the refined centroids
    codes, contribs, t = _assign_pass(xs, hs, centroids, codes, contribs, t, eta)

    r = xs - jnp.take_along_axis(centroids, codes[:, :, None], axis=1)
    loss = jnp.mean(jnp.sum(r * r, axis=(0, 2)) + (eta - 1.0) * t * t)
    return centroids, codes.T, loss


@functools.partial(jax.jit, static_argnames=("passes", "chunk_size"))
def avq_encode_kernel(x, x_hat, centroids, eta, *, passes: int = 2,
                      chunk_size: int = 8192):
    """Score-aware encoding of [N, D] against fixed AVQ centroids.

    Coordinate-descent assignment (init = plain L2 argmin, then ``passes``
    sweeps); chunked over N like codebook.encode_kernel. Returns [N, S]
    int32 codes.
    """
    n, d = x.shape
    s = centroids.shape[0]
    eta = jnp.asarray(eta, x.dtype)

    def one_chunk(args):
        xc, hc = args
        xs = _split_subspaces(xc, s)
        hs = _split_subspaces(hc, s)
        codes, contribs, t = _init_assignment(xs, hs, centroids)
        for _ in range(passes):
            codes, contribs, t = _assign_pass(
                xs, hs, centroids, codes, contribs, t, eta)
        return codes.T  # [chunk, S]

    if n <= chunk_size:
        return one_chunk((x, x_hat))
    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    xp = jnp.pad(x, ((0, n_pad - n), (0, 0)))
    hp = jnp.pad(x_hat, ((0, n_pad - n), (0, 0)))
    out = jax.lax.map(one_chunk, (xp.reshape(n_chunks, chunk_size, d),
                                  hp.reshape(n_chunks, chunk_size, d)))
    return out.reshape(n_pad, s)[:n]


def unit_directions(points) -> jnp.ndarray:
    """[N, D] -> unit rows (zero rows stay zero: their anisotropic term
    vanishes and the loss degrades gracefully to plain reconstruction)."""
    p = jnp.asarray(np.asarray(points, np.float32)) if not isinstance(
        points, jnp.ndarray) else points.astype(jnp.float32)
    norms = jnp.sqrt(jnp.sum(p * p, axis=-1, keepdims=True))
    return p / jnp.maximum(norms, 1e-30)
