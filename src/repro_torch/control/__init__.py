"""Unified workload-control plane (port of ``repro.control``)."""
from repro_torch.control.config import ControlConfig  # noqa: F401
from repro_torch.control.plane import ControlPlane, make_schedule  # noqa: F401
from repro_torch.control.projection import (  # noqa: F401
    ProjectedPlan, project_plan)
from repro_torch.control.scopes import (  # noqa: F401
    SCOPE_LAYOUT, control_block_size, control_scopes, per_rank_pri,
    plan_pri_arrays, scope_block_table)

__all__ = [
    "ControlConfig", "ControlPlane", "make_schedule", "ProjectedPlan",
    "project_plan",
    "SCOPE_LAYOUT", "control_block_size", "control_scopes", "per_rank_pri",
    "plan_pri_arrays", "scope_block_table",
]
