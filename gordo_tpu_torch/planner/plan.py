"""
The ``fleet_plan.json`` a build writes beside its machines, a copy of
``gordo_tpu/planner/plan.py`` (``FleetPlan``, ``build_plan_doc``,
``config_fingerprint``, ``:1-290``).

The plan holds every final-fit bucket (id, program, spec, fit config,
members, pad targets, the cost model's predictions), the strategy, the
cost table's provenance, the totals and the fingerprint of the machines'
configs. It is deterministic (sorted keys, rounded floats, no
timestamps): the same configs and table give the same bytes, and
``plan_hash``, the hash of those bytes, is what the build journal
records. ``predicted_*`` are the cost model's predictions
(``costmodel.py``), not measured times.

:meth:`FleetPlan.materialize_buckets` replays a plan of either strategy
(``:109-160``): ``build-fleet --plan-from`` and the lifecycle's partial
rebuild bind the members to their planned buckets by name, so each keeps
its planned pad targets and member rung whichever of its neighbours are
still to build.
"""

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .costmodel import CostTable, perfmodel_enabled
from .packing import PlannedBucket, member_is_windowed, member_samples

PLAN_VERSION = 1
PLAN_FILE = "fleet_plan.json"


class PlanError(ValueError):
    """A plan document of another version."""


class FleetPlan:
    """A plan document and its identity."""

    def __init__(self, doc: Dict[str, Any]):
        if int(doc.get("version", 0)) != PLAN_VERSION:
            raise PlanError(f"fleet plan version {doc.get('version')!r} != supported {PLAN_VERSION}; "
                            "re-run `gordo-tpu plan`")
        self.doc = doc
        self._assignment: Dict[str, dict] = {name: bucket for bucket in self.buckets for name in bucket["members"]}

    @property
    def strategy(self) -> str:
        return str(self.doc.get("strategy", ""))

    @property
    def buckets(self) -> List[dict]:
        return list(self.doc.get("buckets") or [])

    @property
    def totals(self) -> Dict[str, Any]:
        return dict(self.doc.get("totals") or {})

    @property
    def member_names(self) -> List[str]:
        return sorted(self._assignment)

    def covers(self, names: Sequence[str]) -> bool:
        """True when every name is a member of some bucket."""
        return all(name in self._assignment for name in names)

    def to_json(self) -> str:
        """The canonical bytes: sorted keys, indent 1, a final newline."""
        return json.dumps(self.doc, indent=1, sort_keys=True) + "\n"

    @property
    def plan_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "FleetPlan":
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError as exc:
            raise PlanError(f"unreadable fleet plan {path}: {exc}") from exc
        if not isinstance(doc, dict):
            raise PlanError(f"fleet plan {path} is not a JSON object")
        return cls(doc)

    def materialize_buckets(self, members: Sequence[Any]) -> Tuple[List[PlannedBucket], List[Any]]:
        """Bind this plan's bucket rosters to ``members`` by name:
        ``(buckets, uncovered)``, one bucket with its planned pad targets,
        id and program for each plan bucket that has a member here, and
        the members to pack live: those the plan does not know (a CV fold
        member, a machine added since), whose rows outgrew the pad target
        or whose spec changed."""
        by_bucket: Dict[str, List[Any]] = {}
        uncovered: List[Any] = []
        for member in members:
            entry = self._assignment.get(member.name)
            if (entry is None or member_samples(member) > int(entry["n_padded"])
                    or _jsonable(member.spec.to_dict()) != entry.get("spec")):
                uncovered.append(member)
                continue
            by_bucket.setdefault(entry["id"], []).append(member)
        buckets: List[PlannedBucket] = []
        for entry in self.buckets:
            live = by_bucket.get(entry["id"])
            if not live:
                continue
            windowed = bool(entry.get("windowed"))
            if any(member_is_windowed(m) != windowed for m in live):
                raise PlanError(f"plan bucket {entry['id']} mixes windowed and dense members with the live fleet — "
                                "the plan does not match this config; re-run `gordo-tpu plan`")
            buckets.append(PlannedBucket(spec=live[0].spec, members=live, n_padded=int(entry["n_padded"]),
                                         offset=int(entry.get("offset", 0)), windowed=windowed,
                                         bucket_id=str(entry["id"]), program=str(entry["program"]),
                                         m_padded=int(entry["m_padded"]) if entry.get("m_padded") is not None
                                         else None))
        return buckets, uncovered


def _jsonable(value: Any) -> Any:
    """Tuples as lists, as a JSON round trip gives them."""
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def build_plan_doc(
    buckets_by_config: Sequence[Tuple[Any, Sequence[Any]]],
    strategy: str,
    config_fingerprint: str,
    cost_table: Optional[CostTable] = None,
    mesh_shape: Tuple[int, int] = (1, 1),
) -> FleetPlan:
    """The plan of per-fit-config bucket lists whose predictions are
    filled in (``packing.plan_train_buckets``), for the trainer's
    ``mesh_shape`` (``(1, 1)``: one card), recording the strategy and the
    cost table's version, calibration and samples (default: the analytic
    table)."""
    table = cost_table or CostTable()
    bucket_docs: List[dict] = []
    totals: Dict[str, Any] = {"buckets": 0, "members": 0, "compiles": 0, "predicted_compile_s": 0.0,
                              "predicted_run_s": 0.0, "flops_true": 0.0, "flops_padded": 0.0, "hbm_peak_bytes": 0}
    for config, buckets in buckets_by_config:
        config_doc = {
            "epochs": config.epochs,
            "batch_size": config.batch_size,
            "validation_split": config.validation_split,
            "shuffle": config.shuffle,
            "early_stopping": list(config.early_stopping) if config.early_stopping else None,
        }
        for bucket in buckets:
            predicted = dict(bucket.predicted)
            bucket_docs.append({
                "id": bucket.bucket_id,
                "program": bucket.program,
                "windowed": bucket.windowed,
                "spec": _jsonable(bucket.spec.to_dict()),
                "fit_config": config_doc,
                "members": list(bucket.member_names),
                "n_padded": bucket.n_padded,
                "m_padded": bucket.m_padded,
                "offset": bucket.offset,
                "predicted": predicted,
            })
            totals["buckets"] += 1
            totals["members"] += len(bucket.members)
            totals["compiles"] += int(predicted.get("compiles", 1))
            totals["predicted_compile_s"] += float(predicted.get("compile_s", 0.0))
            totals["predicted_run_s"] += float(predicted.get("run_s", 0.0))
            totals["flops_true"] += float(predicted.get("flops_true", 0.0))
            totals["flops_padded"] += float(predicted.get("flops_padded", 0.0))
            totals["hbm_peak_bytes"] = max(totals["hbm_peak_bytes"], int(predicted.get("hbm_bytes", 0)))
    bucket_docs.sort(key=lambda b: b["id"])
    totals["predicted_wall_s"] = round(totals["predicted_compile_s"] + totals["predicted_run_s"], 6)
    totals["predicted_compile_s"] = round(totals["predicted_compile_s"], 6)
    totals["predicted_run_s"] = round(totals["predicted_run_s"], 6)
    totals["padding_waste"] = round(
        1.0 - totals["flops_true"] / totals["flops_padded"] if totals["flops_padded"] else 0.0, 6)
    totals["flops_true"] = float(f"{totals['flops_true']:.6g}")
    totals["flops_padded"] = float(f"{totals['flops_padded']:.6g}")
    return FleetPlan({
        "version": PLAN_VERSION,
        "strategy": strategy,
        "mesh_shape": [int(mesh_shape[0]), int(mesh_shape[1] or 1)],
        "config_fingerprint": config_fingerprint,
        # which ruler ranked the buckets: learned only with a fitted section and the knob on
        "cost_table": {"version": table.version, "calibrated": table.calibrated,
                       "samples": {str(k): int(v) for k, v in sorted(table.samples.items())},
                       "learned": table.has_learned and perfmodel_enabled()},
        "buckets": bucket_docs,
        "totals": totals,
    })


def config_fingerprint(cache_keys: Sequence[str]) -> str:
    """One hash of the machines' config hashes, in any order.

    >>> config_fingerprint(["b", "a"]) == config_fingerprint(["a", "b"])
    True
    """
    digest = hashlib.sha256()
    for key in sorted(cache_keys):
        digest.update(str(key).encode())
        digest.update(b"\0")
    return digest.hexdigest()[:16]
