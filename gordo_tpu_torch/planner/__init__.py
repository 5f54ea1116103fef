"""Fleet build planning: training buckets (the naive strategy), the
analytic cost model that prices them and the ``fleet_plan.json`` a build
writes."""

from .costmodel import CostModel, compute_precision, dtype_precision, spec_flops_per_sample, spec_param_count
from .packing import PlannedBucket, annotate_predictions, naive_buckets, plan_train_buckets, train_buckets
from .plan import PLAN_FILE, FleetPlan, PlanError, build_plan_doc, config_fingerprint

#: the one strategy the port plans with
NAIVE = "naive"

__all__ = [
    "NAIVE", "PLAN_FILE", "CostModel", "FleetPlan", "PlanError", "PlannedBucket",
    "annotate_predictions", "build_plan_doc", "compute_precision", "config_fingerprint", "dtype_precision",
    "naive_buckets", "plan_train_buckets", "spec_flops_per_sample", "spec_param_count", "train_buckets",
]
