"""The hand-written kernels as compiled for the GPU (no interpret mode)
against their plain formulations. Marked ``gpu``: they skip without a card
and run on one with ``SCANN_TPU_TEST_PLATFORM=gpu python -m pytest -m gpu
tests/``."""

import jax.numpy as jnp
import numpy as np
import pytest

from scann_tpu.ops.distances import DistanceMeasure
from scann_tpu.ops.sweep_pallas import (
    _augment_queries,
    block_minima_pallas,
    block_minima_xla,
    build_allow_penalty,
    build_augmented_db,
)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("top2", [False, True])
@pytest.mark.parametrize("r", [32, 64])
def test_compiled_block_minima_match_plain(gpu_device, r, top2):
    rng = np.random.default_rng(0)
    db = rng.normal(size=(65536, 100)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(300, 100)).astype(np.float32))
    aug = jnp.asarray(build_augmented_db(db, 65000,
                                         DistanceMeasure.SQUARED_L2))
    qa = _augment_queries(q, DistanceMeasure.SQUARED_L2, aug.shape[1])
    pen = jnp.asarray(build_allow_penalty(rng.random(65000) < 0.75,
                                          aug.shape[0], r))
    got = block_minima_pallas(qa, aug, pen, r=r, top2=top2)
    want = block_minima_xla(qa, aug, pen, r=r, top2=top2)
    scale = float(jnp.max(jnp.abs(want[0])))
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=0, atol=1e-3 * scale)


def test_compiled_grouped_scores_match_gather(gpu_device):
    """The grouped kernel through the searcher's own grouping, against the
    f32 per-pair gather-sum of the same bf16 LUTs (bf16 output rounding)."""
    from scann_tpu.models.tree_x_hybrid import (
        code_slab,
        leaf_scores_grouped,
        leaf_scores_xla,
    )

    rng = np.random.default_rng(1)
    t, l_cap, s, c, b, p = 40, 256, 50, 16, 200, 8
    sizes = rng.integers(1, l_cap + 1, size=t).astype(np.int32)
    aligned = np.zeros(t + 1, np.int64)
    aligned[1:] = np.cumsum(((sizes + 127) // 128) * 128)
    codes = rng.integers(0, c, size=(int(aligned[-1]) + l_cap, s),
                         dtype=np.uint8)
    parts = jnp.asarray(rng.integers(0, t, size=(b, p)), jnp.int32)
    luts = jnp.asarray(rng.normal(size=(b * p, s * c)), jnp.float32)
    offs = jnp.asarray(aligned[:-1].astype(np.int32))
    got, rows_g = leaf_scores_grouped(
        luts, parts, jnp.asarray(code_slab(codes, "grouped", c)), offs,
        jnp.asarray(sizes), p=p, l_cap=l_cap, c=c)
    want, rows_x = leaf_scores_xla(
        luts.astype(jnp.bfloat16).astype(jnp.float32), parts,
        jnp.asarray(code_slab(codes, "pairs", c)), offs, jnp.asarray(sizes),
        p=p, l_cap=l_cap, c=c)
    got = np.asarray(got.astype(jnp.float32))
    want = np.asarray(want)
    valid = want < 1e37
    assert np.array_equal(valid, got < 1e37)
    assert np.array_equal(np.asarray(rows_g), np.asarray(rows_x))
    np.testing.assert_allclose(got[valid], want[valid], rtol=2 ** -7,
                               atol=1e-2)
