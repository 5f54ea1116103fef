"""Fleet build planning, as ``gordo_tpu/planner/`` does it: the geometric
shape ladders (``ladder.py``), the cost model with its calibrated tables
(``costmodel.py``), the ``naive`` and ``packed`` bucket strategies
(``packing.py``), the deterministic ``fleet_plan.json`` a build writes and
replays (``plan.py``) and the text table of ``gordo-tpu plan``
(``report.py``)."""

from .costmodel import (
    COST_TABLE_FILE,
    LEARNED_FEATURES,
    LEARNED_TARGETS,
    LEARNED_VERSION,
    PERFMODEL_ENV,
    CostModel,
    CostTable,
    calibrate,
    compute_precision,
    dtype_precision,
    learned_feature_vector,
    load_table_safe,
    perfmodel_enabled,
    spec_flops_per_sample,
    spec_param_count,
    validate_learned_section,
)
from .ladder import geometric_rungs, round_up_ladder, sample_pad_ratio, series_pad_ratio
from .packing import (
    NAIVE,
    PACKED,
    STRATEGIES,
    PlannedBucket,
    annotate_predictions,
    default_strategy,
    naive_buckets,
    plan_train_buckets,
)
from .plan import PLAN_FILE, FleetPlan, PlanError, build_plan_doc, config_fingerprint
from .report import render_plan

__all__ = [
    "COST_TABLE_FILE", "CostModel", "CostTable", "FleetPlan", "LEARNED_FEATURES", "LEARNED_TARGETS",
    "LEARNED_VERSION", "NAIVE", "PACKED", "PERFMODEL_ENV", "PLAN_FILE", "PlanError", "PlannedBucket", "STRATEGIES",
    "annotate_predictions", "build_plan_doc", "calibrate", "compute_precision", "config_fingerprint",
    "default_strategy", "dtype_precision", "geometric_rungs", "learned_feature_vector", "load_table_safe",
    "naive_buckets", "perfmodel_enabled", "plan_train_buckets", "render_plan", "round_up_ladder", "sample_pad_ratio", "series_pad_ratio",
    "spec_flops_per_sample", "spec_param_count", "validate_learned_section",
]
