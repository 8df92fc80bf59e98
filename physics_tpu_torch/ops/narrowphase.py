"""Narrow-phase dispatch predicates (physics_tpu/ops/narrowphase.py:
`hulls_fast_path`, `MAX_FAST_HULL_TYPES`). The generic narrow phases
themselves are ROADMAP item 1.13; the hull table path only needs the
predicate that decides whether the shared-hull fast layout applies."""

from __future__ import annotations

from physics_tpu_torch.config import SimConfig
from physics_tpu_torch.state import SimState

MAX_FAST_HULL_TYPES = 4   # H² coefficient-table sets + H² segments


def hulls_fast_path(state: SimState, cfg: SimConfig) -> bool:
    """True when the scene is hulls-only with a small hull library: one
    hull type, or up to MAX_FAST_HULL_TYPES with the OBB prefilter that
    segments candidates by type pair. Depends on cfg and shapes only."""
    n_hulls = state.hulls.verts.shape[0]
    return bool(
        cfg.hulls_only and cfg.hull_fast
        and 1 <= n_hulls <= MAX_FAST_HULL_TYPES
        and (n_hulls == 1 or cfg.hull_prefilter_cap > 0)
        and state.hulls.verts.shape[1] > 1
    )
