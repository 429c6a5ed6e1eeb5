"""Shared numeric/type helpers: layout padding and the device dispatch.

The reference pads rows to 64-byte cache lines for AVX2
(reference: src/types.rs:285-297, src/data_format/dataset.rs:89-96).
Here rows are padded to a small multiple and every scoring program keeps a
validity count, masking padded rows out.
"""

from __future__ import annotations

import numpy as np

# Row-padding multiples by dtype (layouts only; no kernel depends on them).
LANE = 128
SUBLANE_F32 = 8
SUBLANE_BF16 = 16
SUBLANE_I8 = 32

# Sentinel distance for masked-out (padded / filtered) points. Using a large
# finite value instead of +inf keeps top_k well-defined and avoids NaN from
# inf-inf arithmetic in fused score transforms.
MASKED_DISTANCE = np.float32(3.4e38) / 2


def align_up(x: int, alignment: int) -> int:
    """Round ``x`` up to a multiple of ``alignment`` (reference: src/types.rs:285-290)."""
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    return ((x + alignment - 1) // alignment) * alignment


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def platform() -> str:
    """The ONE device probe every stage's formulation choice shares:
    ``"gpu"`` (NVIDIA card: the hand-written kernels that won their
    measurement, see PERF.md) or ``"cpu"`` (tests: the plain jax.numpy/lax
    formulation of every stage). Any other backend is unsupported."""
    import jax

    from scann_tpu.errors import ScannError

    plat = jax.devices()[0].platform
    if plat in ("gpu", "cpu"):
        return plat
    raise ScannError.unimplemented(
        f"unsupported JAX platform {plat!r}: scann_tpu runs on 'gpu' "
        f"(CUDA) or 'cpu'")


def use_gpu_kernels() -> bool:
    """True when the hand-written GPU kernels serve (platform ``"gpu"``)."""
    return platform() == "gpu"


def pad_rows(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad the leading dimension of ``arr`` up to a multiple of ``multiple``."""
    n = arr.shape[0]
    n_pad = align_up(max(n, 1), multiple)
    if n_pad == n:
        return arr
    pad_widths = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_widths, constant_values=fill)
