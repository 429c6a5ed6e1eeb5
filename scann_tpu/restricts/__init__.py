"""Restricts (search-time filtering) and crowding (result diversity).

Filters mirror the reference (reference: src/restricts/mod.rs:17-167,
allowlist.rs, crowding.rs). The device twist: every filter can lower to
a **device mask** — a [N] bool array fused into the scoring program so
disallowed candidates score the sentinel distance and never reach top-k; the
predicate-composition API on the host stays identical to the reference.
Crowding is a host post-pass over the (small) sorted result lists.
"""

from scann_tpu.restricts.filters import (
    RestrictFilter,
    NoRestrict,
    PredicateFilter,
    RangeFilter,
    AndFilter,
    OrFilter,
    NotFilter,
    AllowlistFilter,
    DenylistFilter,
)
from scann_tpu.restricts.allowlist import (
    RestrictAllowlist,
    RestrictDenylist,
    RestrictTokenMap,
    SparseAllowlist,
)
from scann_tpu.restricts.crowding import (
    CrowdingConfig,
    CrowdingConstraint,
    CrowdingMultidimensional,
    apply_crowding,
)

__all__ = [
    "RestrictFilter",
    "NoRestrict",
    "PredicateFilter",
    "RangeFilter",
    "AndFilter",
    "OrFilter",
    "NotFilter",
    "AllowlistFilter",
    "DenylistFilter",
    "RestrictAllowlist",
    "RestrictDenylist",
    "RestrictTokenMap",
    "SparseAllowlist",
    "CrowdingConfig",
    "CrowdingConstraint",
    "CrowdingMultidimensional",
    "apply_crowding",
]
