"""Shared benchmark timing/recall helpers — ONE implementation.

Used by bench.py and ``utils/chip_profile.calibrate``, so a methodology fix
reaches every number they print at once.

:func:`scan_time` / :func:`chained` run a device-resident loop via
lax.scan: ``iters`` chained searches in ONE dispatch; each step's result
feeds the next step's input and the returned scalar, so nothing can be
elided. Best-of-rounds: noise only ever adds time. This times the device
program alone; host transfers and per-call dispatch are not in it.
"""

from __future__ import annotations

import time

import numpy as np


def scan_time(make_scan, iters, rounds=3):
    """Best per-iteration seconds of ``make_scan(iters)()`` over rounds."""
    fn = make_scan(iters)
    float(fn())  # compile + run once
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(fn())
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def chained(kern_call, arrays, iters, rounds=3):
    """Chained-scan timing of ``kern_call(q_perturbed, *arrays)`` ->
    (vals, idx); all big arrays ride as jit arguments (closure-captured
    device arrays would become program constants)."""
    import jax
    import jax.numpy as jnp

    def make_scan(it):
        @jax.jit
        def run(qq, *rest):
            def body(acc, i):
                vals, _ = kern_call(qq + acc * 1e-20 + i * 1e-6, *rest)
                return acc + jnp.where(jnp.isfinite(vals), vals, 0.0).sum(), None
            acc, _ = jax.lax.scan(body, jnp.float32(0),
                                  jnp.arange(it, dtype=jnp.float32))
            return acc
        return lambda: run(*arrays)

    return scan_time(make_scan, iters, rounds)


def recall_at_k(idx, gt, k=10):
    """Mean fraction of the k true neighbors present per row."""
    return float(np.mean([len(set(map(int, a[:k])) & set(map(int, g[:k]))) / k
                          for a, g in zip(idx, gt)]))
