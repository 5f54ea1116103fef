"""
The canary's promotion gates, a copy of ``gordo_tpu/lifecycle/gates.py``.

Every rebuilt member of a canary revision must pass, on one probe window
scored by the base fleet and by the canary fleet (``fleet_scores``: one
K2 launch a spec bucket of each, on the card):

- **load and score**: the canary's artifact loads and scores the probe
  rows with finite outputs; the share of rebuilt members that do not may
  be at most ``GORDO_TPU_GATE_MAX_ERROR_RATE`` (default 0);
- **threshold parity**: the rebuilt detector's aggregate threshold lies
  within ``GORDO_TPU_GATE_THRESHOLD_RATIO`` times the base model's, either
  way;
- **residual parity**: the canary's mean reconstruction error on the probe
  rows is at most ``GORDO_TPU_GATE_RESIDUAL_RATIO`` times the (stale) base
  model's;
- **precision parity**: where a canary bucket serves at bf16 or int8
  (``GORDO_TPU_SERVE_PRECISION`` or the spec's own ``precision``), its
  reduced verdicts agree with its f32 ones on at least
  ``GORDO_TPU_GATE_PRECISION_AGREEMENT`` of a seeded probe window
  (``serve/precision.py::evaluate_parity``).

Every failure is collected, so a quarantine record holds all of them.
"""

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..models.spec import FeedForwardSpec
from ..serve.precision import ParityConfig, evaluate_parity, resolve_precision
from ..utils.env import env_float

logger = logging.getLogger(__name__)


@dataclass
class GateConfig:
    """The gates' knobs (``from_env`` reads them)."""

    max_error_rate: float = 0.0
    threshold_ratio: float = 4.0
    residual_ratio: float = 2.0
    #: least reduced-against-f32 verdict agreement (reduced buckets only)
    precision_agreement: float = 0.98

    @classmethod
    def from_env(cls) -> "GateConfig":
        return cls(
            max_error_rate=env_float("GORDO_TPU_GATE_MAX_ERROR_RATE", 0.0),
            threshold_ratio=env_float("GORDO_TPU_GATE_THRESHOLD_RATIO", 4.0),
            residual_ratio=env_float("GORDO_TPU_GATE_RESIDUAL_RATIO", 2.0),
            precision_agreement=env_float("GORDO_TPU_GATE_PRECISION_AGREEMENT", 0.98),
        )


@dataclass
class GateReport:
    """Pass or fail, each failure, and each check's evidence."""

    passed: bool = True
    failures: List[str] = field(default_factory=list)
    checks: Dict[str, Any] = field(default_factory=dict)

    def fail(self, reason: str) -> None:
        self.passed = False
        self.failures.append(reason)


def _aggregate_threshold(model: Any) -> Optional[float]:
    value = getattr(model, "aggregate_threshold_", None)
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if np.isfinite(value) and value > 0 else None


def evaluate_canary(base_fleet: Any, canary_fleet: Any, frames: Dict[str, Any], rebuilt_names: Sequence[str],
                    config: Optional[GateConfig] = None) -> GateReport:
    """Gate ``rebuilt_names``: score the probe ``frames`` (``name -> rows``)
    on both fleets and apply the gates. A rebuilt member without probe rows
    still takes the load and threshold gates, and is listed ``unprobed``."""
    config = config or GateConfig.from_env()
    report = GateReport()
    rebuilt = sorted(set(rebuilt_names))
    probe = {name: frames[name] for name in rebuilt if name in frames}
    report.checks["rebuilt"] = rebuilt
    report.checks["probed"] = sorted(probe)
    unprobed = sorted(set(rebuilt) - set(probe))
    if unprobed:
        report.checks["unprobed"] = unprobed

    base_scores, base_errors = base_fleet.fleet_scores(probe) if probe else ({}, {})
    canary_scores, canary_errors = canary_fleet.fleet_scores(probe) if probe else ({}, {})

    # load and score
    nonfinite = [name for name, (recon, mse) in canary_scores.items()
                 if not (np.all(np.isfinite(recon)) and np.all(np.isfinite(mse)))]
    bad = sorted(set(canary_errors) | set(nonfinite))
    error_rate = len(bad) / len(probe) if probe else 0.0
    report.checks["error_rate"] = round(error_rate, 4)
    if error_rate > config.max_error_rate:
        report.fail(f"canary error rate {error_rate:.2%} over {config.max_error_rate:.2%} ({', '.join(bad[:5])})")

    # threshold parity
    parity: Dict[str, Any] = {}
    for name in rebuilt:
        try:
            base_thr = _aggregate_threshold(base_fleet.model(name))
            canary_thr = _aggregate_threshold(canary_fleet.model(name))
        except Exception as exc:  # noqa: BLE001 - the load gate's finding, unless unprobed
            if name not in bad:
                report.fail(f"{name}: canary model unloadable ({exc!r})")
            continue
        if base_thr is None:
            continue  # the base is no fitted detector: nothing to compare
        if canary_thr is None:
            report.fail(f"{name}: canary lost its anomaly threshold")
            continue
        ratio = max(base_thr, canary_thr) / min(base_thr, canary_thr)
        parity[name] = round(ratio, 4)
        if ratio > config.threshold_ratio:
            report.fail(f"{name}: threshold parity {ratio:.2f}x over {config.threshold_ratio:.2f}x "
                        f"(base {base_thr:.4g}, canary {canary_thr:.4g})")
    report.checks["threshold_parity"] = parity

    # residual parity
    residual: Dict[str, Any] = {}
    for name in sorted(probe):
        base_entry, canary_entry = base_scores.get(name), canary_scores.get(name)
        if base_entry is None or canary_entry is None:
            continue
        base_mse = float(np.mean(base_entry[1]))
        canary_mse = float(np.mean(canary_entry[1]))
        if not np.isfinite(base_mse) or base_mse <= 0:
            continue
        ratio = canary_mse / base_mse
        residual[name] = round(ratio, 4)
        if ratio > config.residual_ratio:
            report.fail(f"{name}: canary residual {ratio:.2f}x the (already stale) base on the probe window")
    report.checks["residual_parity"] = residual
    if base_errors:  # the stale base failing is what the rebuild fixes: no block
        report.checks["base_errors"] = sorted(base_errors)

    _apply_precision_parity(canary_fleet, report, config)
    return report


def _apply_precision_parity(canary_fleet: Any, report: GateReport, config: GateConfig) -> None:
    specs = {spec for spec in canary_fleet.loaded_specs().values() if isinstance(spec, FeedForwardSpec)}
    active = sorted({(resolve_precision(spec), spec) for spec in specs if resolve_precision(spec) != "f32"},
                    key=lambda pair: (pair[0], repr(pair[1])))
    if not active:
        return
    parity_config = ParityConfig.from_env()
    parity_config.agreement = config.precision_agreement
    results: Dict[str, Any] = {}
    for precision, spec in active:
        gate = evaluate_precision_parity(canary_fleet, spec, precision, parity_config)
        results[f"{precision}:{type(spec).__name__}[{spec.n_features}]"] = gate.checks.get("parity")
        if not gate.passed:
            report.failures.extend(gate.failures)
            report.passed = False
    report.checks["precision_parity"] = results


def evaluate_precision_parity(fleet: Any, spec: Any, precision: str,
                              config: Optional[ParityConfig] = None) -> GateReport:
    """The precision-parity gate of one spec bucket as a :class:`GateReport`;
    an evaluation that raises is a failed gate."""
    if config is None:
        config = ParityConfig.from_env()
    report = GateReport()
    try:
        parity = evaluate_parity(fleet, spec, precision, config)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as exc:  # noqa: BLE001 - a crashed evaluation fails the gate
        report.fail(f"precision parity evaluation crashed: {exc!r}")
        report.checks["parity"] = {"precision": precision, "error": repr(exc)}
        return report
    report.checks["parity"] = {
        "precision": parity.get("precision"),
        "agreement_min": parity.get("agreement_min"),
        "agreement_threshold": parity.get("agreement_threshold"),
        "members": {name: member.get("agreement") for name, member in (parity.get("members") or {}).items()},
    }
    if not parity.get("passed"):
        report.fail(parity.get("detail") or f"{precision} verdicts diverge from f32 past tolerance")
    return report
