"""Test environment: force the CPU backend with 8 virtual devices so sharding
tests exercise a real (virtual) mesh without accelerator hardware.

JAX backends may already be initialized when pytest starts, so env vars
alone can be too late — we update jax's config and clear the
already-created backends.

``SCANN_TPU_TEST_PLATFORM=gpu`` leaves JAX on the GPU instead, for the
tests marked ``gpu`` (``python -m pytest -m gpu tests/`` on a card); they
skip wherever JAX finds no GPU (the ``gpu_device`` fixture).
"""

import os

# CPU AOT cache entries are machine-feature-specific; don't persist them
os.environ.setdefault("SCANN_TPU_COMPILE_CACHE", "0")

import jax
from jax._src import xla_bridge

if os.environ.get("SCANN_TPU_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    xla_bridge._clear_backends()

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """The GPU the ``gpu``-marked tests run on; skips without one (decided
    here, at run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform!r}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_clustered_data(rng, n=512, d=32, n_clusters=8, spread=0.1):
    """Deterministic clustered synthetic data (the reference's fixture style:
    seeded generators, reference: src/trees/kmeans.rs:434-519)."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 5.0
    assign = rng.integers(0, n_clusters, size=n)
    pts = centers[assign] + rng.normal(size=(n, d)).astype(np.float32) * spread
    return pts.astype(np.float32), centers, assign


@pytest.fixture
def clustered_data(rng):
    return make_clustered_data(rng)
