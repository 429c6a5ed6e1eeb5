"""Device compute kernels: batched distances, top-k selection, LUT16
scoring, asymmetric (quantized-database) scoring.

This package replaces the reference's SIMD layer (reference: src/simd/,
src/distance_measures/) with XLA programs built around matrix products and
Pallas kernels for the ops XLA cannot fuse well on its own.
"""

from scann_tpu.ops.distances import DistanceMeasure, many_to_many, one_to_many, one_to_one
from scann_tpu.ops.topk import top_k_smallest, merge_top_k

__all__ = [
    "DistanceMeasure",
    "many_to_many",
    "one_to_many",
    "one_to_one",
    "top_k_smallest",
    "merge_top_k",
]
