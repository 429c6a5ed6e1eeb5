"""Gaussian mixture model via EM (reference: src/utils/gmm.rs:12-601).

On the device the entire EM fit is ONE jitted device program — a
``lax.while_loop`` whose body runs the E-step (vectorized log densities +
log-sum-exp responsibilities over all components at once) and the M-step
(matrix contractions ``resp.T @ x`` / batched covariance einsums) — so a fit
is a single dispatch regardless of iteration count. Covariance types:
full (batched Cholesky) / diagonal / spherical. BIC/AIC for model
selection; sampling stays host-side (np RNG).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scann_tpu.errors import ScannError


class CovarianceType(enum.Enum):
    FULL = "Full"
    DIAGONAL = "Diagonal"
    SPHERICAL = "Spherical"


@dataclasses.dataclass
class GmmConfig:
    """(reference: gmm.rs:12-51)."""

    num_components: int = 2
    covariance_type: CovarianceType = CovarianceType.DIAGONAL
    max_iterations: int = 100
    convergence_threshold: float = 1e-4
    reg_covar: float = 1e-6
    seed: Optional[int] = None


def _log_prob_device(x, weights, means, covs, cov_type: CovarianceType,
                     ):
    """[N, K] per-component log densities, all components at once."""
    n, d = x.shape
    k = means.shape[0]
    diff = x[:, None, :] - means[None, :, :]                    # [N, K, D]
    if cov_type == CovarianceType.FULL:
        chol = jnp.linalg.cholesky(covs)                         # [K, D, D]
        # solve L y = diff per component; [K, D, N]
        y = jax.lax.linalg.triangular_solve(
            chol, jnp.transpose(diff, (1, 2, 0)),
            left_side=True, lower=True)
        maha = jnp.sum(y * y, axis=1).T                          # [N, K]
        logdet = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(chol, axis1=1, axis2=2)), axis=1)
    elif cov_type == CovarianceType.DIAGONAL:
        maha = jnp.sum(diff * diff / covs[None, :, :], axis=-1)
        logdet = jnp.sum(jnp.log(covs), axis=-1)
    else:
        maha = jnp.sum(diff * diff, axis=-1) / covs[None, :]
        logdet = d * jnp.log(covs)
    return -0.5 * (d * jnp.log(2.0 * jnp.pi) + logdet[None, :] + maha)


def _log_resp_device(x, weights, means, covs, cov_type):
    wlp = _log_prob_device(x, weights, means, covs, cov_type) \
        + jnp.log(weights)[None, :]
    norm = jax.nn.logsumexp(wlp, axis=1)
    return wlp - norm[:, None], jnp.mean(norm)


@functools.partial(
    jax.jit,
    static_argnames=("cov_type", "max_iterations", "convergence_threshold",
                     "reg_covar"))
def _em_fit(x, weights0, means0, covs0, *, cov_type: CovarianceType,
            max_iterations: int, convergence_threshold: float,
            reg_covar: float):
    """Full EM fit as one device program. Matches the loop semantics of the
    reference (gmm.rs:200-280): E-step with current params, M-step update,
    then convergence check on the E-step log-likelihood sequence."""
    n, d = x.shape
    k = means0.shape[0]

    def m_step(resp):
        nk = jnp.sum(resp, axis=0) + 1e-10                       # [K]
        weights = nk / n
        means = (resp.T @ x) / nk[:, None]
        diff = x[:, None, :] - means[None, :, :]                 # [N, K, D]
        if cov_type == CovarianceType.FULL:
            covs = jnp.einsum("nk,nkd,nke->kde", resp, diff, diff,
                              optimize=True) / nk[:, None, None]
            covs = covs + jnp.eye(d)[None] * reg_covar
        elif cov_type == CovarianceType.DIAGONAL:
            covs = jnp.einsum("nk,nkd->kd", resp, diff * diff) \
                / nk[:, None] + reg_covar
        else:
            covs = jnp.einsum("nk,nkd->k", resp, diff * diff) \
                / (nk * d) + reg_covar
        return weights, means, covs

    def cond(state):
        it, done, *_ = state
        return (it < max_iterations) & ~done

    def body(state):
        it, done, weights, means, covs, prev_ll, _ = state
        log_resp, ll = _log_resp_device(x, weights, means, covs, cov_type)
        weights, means, covs = m_step(jnp.exp(log_resp))
        done = jnp.abs(ll - prev_ll) < convergence_threshold
        return (it + 1, done, weights, means, covs, ll, ll)

    init = (jnp.int32(0), jnp.bool_(False), weights0, means0, covs0,
            jnp.float32(-jnp.inf), jnp.float32(-jnp.inf))
    it, done, weights, means, covs, _, ll = jax.lax.while_loop(
        cond, body, init)
    return weights, means, covs, ll, it, done


class GaussianMixture:
    """(reference: gmm.rs:100-601)."""

    def __init__(self, config: Optional[GmmConfig] = None):
        self.config = config or GmmConfig()
        self.weights: Optional[np.ndarray] = None       # [K]
        self.means: Optional[np.ndarray] = None         # [K, D]
        self.covariances: Optional[np.ndarray] = None   # [K,D,D] | [K,D] | [K]
        self.converged = False
        self.num_iterations = 0
        self._log_likelihood = -np.inf

    def _estimate_log_resp(self, x: np.ndarray) -> Tuple[np.ndarray, float]:
        lr, ll = _log_resp_device(
            jnp.asarray(x, jnp.float32), jnp.asarray(self.weights, jnp.float32),
            jnp.asarray(self.means, jnp.float32),
            jnp.asarray(self.covariances, jnp.float32),
            self.config.covariance_type)
        return np.asarray(lr), float(ll)

    # -- fit ----------------------------------------------------------------
    def fit(self, data) -> "GaussianMixture":
        x = data.numpy() if hasattr(data, "numpy") else np.asarray(data)
        x = np.asarray(x, dtype=np.float32)
        n, d = x.shape
        cfg = self.config
        k = cfg.num_components
        if n < k:
            raise ScannError.invalid_argument("fewer points than components")

        rng = np.random.default_rng(cfg.seed)
        weights0 = np.full(k, 1.0 / k, np.float32)
        means0 = x[rng.choice(n, k, replace=False)].copy()

        # Ill-conditioned FULL covariances make the f32 Cholesky return NaN
        # silently (the reference's f64 slogdet/solve, gmm.rs, tolerated
        # them); retry with a progressively larger regularizer and surface
        # an error if the fit never becomes finite (advisor r2 finding).
        reg = float(cfg.reg_covar)
        for _attempt in range(4):
            gvar = x.var(axis=0) + reg
            if cfg.covariance_type == CovarianceType.FULL:
                covs0 = np.stack([np.diag(gvar)] * k).astype(np.float32)
            elif cfg.covariance_type == CovarianceType.DIAGONAL:
                covs0 = np.stack([gvar] * k).astype(np.float32)
            else:
                covs0 = np.full(k, float(gvar.mean()), np.float32)

            weights, means, covs, ll, it, done = _em_fit(
                jnp.asarray(x), jnp.asarray(weights0), jnp.asarray(means0),
                jnp.asarray(covs0), cov_type=cfg.covariance_type,
                max_iterations=cfg.max_iterations,
                convergence_threshold=float(cfg.convergence_threshold),
                reg_covar=reg)
            if np.isfinite(float(ll)):
                break
            reg *= 1e3
        else:
            raise ScannError.internal(
                "GMM EM diverged to non-finite log-likelihood even with "
                f"reg_covar={reg / 1e3:g}; data may be degenerate")
        self.weights = np.asarray(weights, np.float64)
        self.means = np.asarray(means, np.float64)
        self.covariances = np.asarray(covs, np.float64)
        self._log_likelihood = float(ll)
        self.num_iterations = int(it)
        self.converged = bool(done)
        return self

    # -- inference ----------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        self._check()
        lr, _ = self._estimate_log_resp(np.asarray(x, np.float32))
        return lr.argmax(axis=1).astype(np.int32)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        self._check()
        lr, _ = self._estimate_log_resp(np.asarray(x, np.float32))
        return np.exp(lr)

    def score(self, x: np.ndarray) -> float:
        """Mean log-likelihood."""
        self._check()
        _, ll = self._estimate_log_resp(np.asarray(x, np.float32))
        return ll

    def sample(self, n: int, seed: Optional[int] = None) -> np.ndarray:
        """(reference: gmm.rs:470-519)."""
        self._check()
        rng = np.random.default_rng(seed)
        k, d = self.means.shape
        comp = rng.choice(k, size=n, p=self.weights / self.weights.sum())
        out = np.empty((n, d))
        ct = self.config.covariance_type
        for j in range(k):
            m = comp == j
            if not m.any():
                continue
            if ct == CovarianceType.FULL:
                out[m] = rng.multivariate_normal(self.means[j], self.covariances[j],
                                                 size=int(m.sum()))
            elif ct == CovarianceType.DIAGONAL:
                out[m] = self.means[j] + rng.normal(size=(int(m.sum()), d)) * np.sqrt(
                    self.covariances[j])
            else:
                out[m] = self.means[j] + rng.normal(size=(int(m.sum()), d)) * np.sqrt(
                    self.covariances[j])
        return out.astype(np.float32)

    def _n_parameters(self) -> int:
        k, d = self.means.shape
        if self.config.covariance_type == CovarianceType.FULL:
            cov = k * d * (d + 1) // 2
        elif self.config.covariance_type == CovarianceType.DIAGONAL:
            cov = k * d
        else:
            cov = k
        return int(k - 1 + k * d + cov)

    def bic(self, x: np.ndarray) -> float:
        """(reference: gmm.rs:540-560)."""
        x = np.asarray(x, np.float32)
        return -2.0 * self.score(x) * len(x) + self._n_parameters() * np.log(len(x))

    def aic(self, x: np.ndarray) -> float:
        x = np.asarray(x, np.float32)
        return -2.0 * self.score(x) * len(x) + 2.0 * self._n_parameters()

    def _check(self):
        if self.means is None:
            raise ScannError.failed_precondition("GMM not fitted")
