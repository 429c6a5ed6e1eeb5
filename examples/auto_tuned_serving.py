"""Hands-free index selection + tuning: ``Scann.auto`` with a recall target.

The reference requires an explicit mode everywhere and leaves every knob to
the user — its own published defaults reach recall 0.23-0.41
(reference: README.md:713-716, src/scann.rs:60-103). Here one call:

  1. picks the architecture from dataset scale via the per-device profile
     (utils/chip_profile.py — override with SCANN_TPU_CHIP_PROFILE, or
     re-measure the crossovers with ``calibrate()``);
  2. measures cluster-mass skew + norm spread on a sample and sets the
     build knobs that dominated the adversarial pareto (SOAR secondary
     assignments, partition count, balance caps — utils/advisor.py);
  3. autotunes serving parameters against exact ground truth on a query
     sample and installs the cheapest configuration meeting the target.

Run: PYTHONPATH=. python examples/auto_tuned_serving.py
"""

import numpy as np

from scann_tpu import DenseDataset, Scann
from scann_tpu.harness.ann_benchmark import generate_adversarial_dataset

# GloVe-shaped skewed data: Zipf cluster mass, anisotropic covariance,
# heavy-tailed norms — the regime where default knobs collapse recall
data = generate_adversarial_dataset(20_000, 100, 32, 10, seed=7)

searcher = Scann.auto(DenseDataset(data.train), target_recall=0.99,
                      tune_queries=data.test)
print(f"mode: {searcher.search_mode}")
print(f"tuned params: {searcher.default_params}")
print(f"sample recall during tuning: {searcher.autotune_result.recall:.4f} "
      f"(target met: {searcher.autotune_result.target_met})")

idx, dist = searcher.search_batched_arrays(data.test, 10)  # tuned defaults
recall = np.mean([len(set(a.tolist()) & set(g.tolist())) / 10
                  for a, g in zip(idx, data.gt)])
print(f"serving recall@10 on held-out queries: {recall:.4f}")
assert recall >= 0.98
