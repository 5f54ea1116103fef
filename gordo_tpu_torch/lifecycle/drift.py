"""
Each machine's drift statistics, the trigger of the lifecycle loop: a
copy of ``gordo_tpu/lifecycle/drift.py``, host arithmetic in numpy as
there.

Two signals over the rows a machine scores:

- **feature drift**: each input tag's window mean against the training
  baseline the builder wrote into ``metadata.json``
  (``build_metadata.drift_baseline``, ``machine/metadata.py``). A tag
  whose mean moved more than ``GORDO_TPU_DRIFT_SIGMA`` training standard
  deviations is shifted; the machine drifts when the shifted share of its
  measurable tags reaches ``GORDO_TPU_DRIFT_FEATURE_QUORUM`` (one tag at
  least).
- **residual drift**: the mean of each row's reconstruction error (the
  mse ``fleet_scores`` computes, K2 on the card) against a baseline made
  online from the machine's first ``GORDO_TPU_DRIFT_CALIBRATION`` scored
  batches; past ``GORDO_TPU_DRIFT_RESIDUAL_RATIO`` times it, the machine
  drifts.

A verdict needs ``GORDO_TPU_DRIFT_MIN_SAMPLES`` rows in its window; a
signal's window resets only once it was tested. NaN cells count for no
tag. The accumulators are sums, and their snapshots are the JAX
package's JSON, so either package restores the other's.

>>> config = DriftConfig(min_samples=4, sigma=1.0, calibration_batches=1)
>>> machine = MachineDrift("m-1", baseline={"feature_means": [0.0], "feature_stds": [1.0],
...                                         "tags": ["t"], "n_samples": 100}, config=config)
>>> machine.observe([[5.0], [5.1], [4.9], [5.0]])
>>> verdict = machine.evaluate()
>>> verdict.drifted, verdict.reasons[0].startswith("feature-shift")
(True, True)
"""

import json
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import serializer
from ..utils.env import env_float, env_int
from ..utils.faults import fault_point

logger = logging.getLogger(__name__)

#: a constant tag's training std is floored here, so noise is not infinite drift
_STD_FLOOR = 1e-9


@dataclass
class DriftConfig:
    """The drift knobs (``from_env`` reads them)."""

    #: mean shift, in training stds, for a tag to count as shifted
    sigma: float = 2.0
    #: share of the measurable tags that must shift (one at least)
    feature_quorum: float = 0.25
    #: window residual mean over the calibrated baseline for residual drift
    residual_ratio: float = 2.0
    #: rows a window needs before a verdict can fire
    min_samples: int = 64
    #: scored batches that make the residual baseline
    calibration_batches: int = 3

    @classmethod
    def from_env(cls) -> "DriftConfig":
        return cls(
            sigma=env_float("GORDO_TPU_DRIFT_SIGMA", 2.0),
            feature_quorum=env_float("GORDO_TPU_DRIFT_FEATURE_QUORUM", 0.25),
            residual_ratio=env_float("GORDO_TPU_DRIFT_RESIDUAL_RATIO", 2.0),
            min_samples=env_int("GORDO_TPU_DRIFT_MIN_SAMPLES", 64),
            calibration_batches=env_int("GORDO_TPU_DRIFT_CALIBRATION", 3),
        )


@dataclass
class DriftVerdict:
    """One machine's evaluation: drifted or not, and why."""

    machine: str
    drifted: bool = False
    reasons: List[str] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)


class MachineDrift:
    """One machine's window sums and drift tests. ``baseline`` is its
    ``drift_baseline``; without one only the residual test runs."""

    def __init__(self, name: str, baseline: Optional[Dict[str, Any]] = None, config: Optional[DriftConfig] = None):
        self.name = name
        self.config = config or DriftConfig()
        self.baseline = baseline if baseline and baseline.get("tags") else None
        # the window: sums and finite counts a tag
        self._n = 0
        self._sum: Optional[np.ndarray] = None
        self._counts: Optional[np.ndarray] = None
        self._res_n = 0
        self._res_sum = 0.0
        # the residual baseline, from the first calibration_batches batches
        self._cal_batches = 0
        self._cal_n = 0
        self._cal_sum = 0.0

    def observe(self, X: Any, residuals: Any = None) -> None:
        """Fold one scored batch in: ``X`` its raw rows, ``residuals`` each
        row's mse (None for rows that were not scored)."""
        values = np.asarray(X.to_numpy() if hasattr(X, "to_numpy") else X, dtype=float)
        if values.ndim == 1:
            values = values[:, None]
        if len(values):
            finite = np.isfinite(values)
            batch_sum = np.where(finite, values, 0.0).sum(axis=0)
            if self._sum is None or self._sum.shape != batch_sum.shape:
                self._sum = np.zeros_like(batch_sum)
                self._counts = np.zeros(batch_sum.shape, dtype=np.int64)
                self._n = 0
            self._sum += batch_sum
            self._counts += finite.sum(axis=0)
            self._n += len(values)
        if residuals is None:
            return
        res = np.asarray(residuals, dtype=float).ravel()
        res = res[np.isfinite(res)]
        if not len(res):
            return
        if self._cal_batches < self.config.calibration_batches:
            self._cal_batches += 1
            self._cal_n += len(res)
            self._cal_sum += float(res.sum())
        else:
            self._res_n += len(res)
            self._res_sum += float(res.sum())

    @property
    def residual_baseline(self) -> Optional[float]:
        """The calibrated residual mean a row (None while calibrating)."""
        if self._cal_batches < self.config.calibration_batches or not self._cal_n:
            return None
        return self._cal_sum / self._cal_n

    def evaluate(self, reset: bool = True) -> DriftVerdict:
        """The verdict over the current window; a signal's window resets
        (with ``reset``) only once it had ``min_samples`` rows."""
        fault_point("drift_eval", self.name)
        verdict = DriftVerdict(machine=self.name)
        config = self.config
        verdict.stats["window_rows"] = self._n
        features_tested = residuals_tested = False
        try:
            if self._n >= config.min_samples and self.baseline is not None:
                features_tested = True
                self._feature_test(verdict)
            if self._res_n >= config.min_samples:
                residuals_tested = True
                self._residual_test(verdict)
        finally:
            if reset:
                if features_tested:
                    self._reset_features()
                if residuals_tested:
                    self._reset_residuals()
        verdict.drifted = bool(verdict.reasons)
        return verdict

    def _feature_test(self, verdict: DriftVerdict) -> None:
        means = np.asarray([v if v is not None else np.nan for v in (self.baseline.get("feature_means") or [])], float)
        stds = np.asarray([v if v is not None else np.nan for v in (self.baseline.get("feature_stds") or [])], float)
        # a tag with no finite row in the window is NaN, never a shift from 0
        window_mean = np.where(self._counts > 0, self._sum / np.maximum(self._counts, 1), np.nan)
        if means.shape != window_mean.shape or stds.shape != means.shape:
            verdict.stats["feature_baseline"] = "shape-mismatch"
            return
        shift = np.abs(window_mean - means) / np.maximum(stds, _STD_FLOOR)
        # a tag that cannot be measured votes neither way
        shift = np.where(np.isfinite(shift), shift, 0.0)
        measurable = int(np.isfinite(means).sum())
        if not measurable:
            verdict.stats["feature_baseline"] = "no-finite-baseline"
            return
        tags = list(self.baseline.get("tags") or [])
        needed = max(1, int(math.ceil(self.config.feature_quorum * measurable)))
        shifted = [i for i in range(len(shift)) if shift[i] > self.config.sigma]
        verdict.stats["feature_shift_max"] = round(float(shift.max()), 4)
        verdict.stats["feature_shifted"] = len(shifted)
        if len(shifted) >= needed:
            worst = max(shifted, key=lambda i: shift[i])
            tag = tags[worst] if worst < len(tags) else str(worst)
            verdict.reasons.append(f"feature-shift {tag} ({shift[worst]:.2f}σ, {len(shifted)}/{len(shift)} tags)")

    def _residual_test(self, verdict: DriftVerdict) -> None:
        baseline = self.residual_baseline
        if baseline is None or baseline <= 0:
            verdict.stats["residual_baseline"] = "uncalibrated"
            return
        ratio = (self._res_sum / self._res_n) / baseline
        verdict.stats["residual_ratio"] = round(float(ratio), 4)
        if ratio > self.config.residual_ratio:
            verdict.reasons.append(f"residual-ratio {ratio:.2f}x over the calibrated baseline")

    def _reset_features(self) -> None:
        self._n = 0
        self._sum = None
        self._counts = None

    def _reset_residuals(self) -> None:
        self._res_n = 0
        self._res_sum = 0.0

    def reset_window(self) -> None:
        self._reset_features()
        self._reset_residuals()

    def snapshot(self) -> Dict[str, Any]:
        """The sums as JSON (the supervisor's state file)."""
        return {
            "n": self._n,
            "sum": list(self._sum) if self._sum is not None else None,
            "counts": [int(c) for c in self._counts] if self._counts is not None else None,
            "res_n": self._res_n,
            "res_sum": self._res_sum,
            "cal_batches": self._cal_batches,
            "cal_n": self._cal_n,
            "cal_sum": self._cal_sum,
        }

    def restore(self, snapshot: Dict[str, Any]) -> None:
        self._n = int(snapshot.get("n") or 0)
        raw = snapshot.get("sum")
        self._sum = np.asarray(raw, float) if raw is not None else None
        raw_counts = snapshot.get("counts")
        if raw_counts is not None:
            self._counts = np.asarray(raw_counts, np.int64)
        elif self._sum is not None:  # a snapshot from before the counts: every row finite
            self._counts = np.full(self._sum.shape, self._n, np.int64)
        else:
            self._counts = None
        self._res_n = int(snapshot.get("res_n") or 0)
        self._res_sum = float(snapshot.get("res_sum") or 0.0)
        self._cal_batches = int(snapshot.get("cal_batches") or 0)
        self._cal_n = int(snapshot.get("cal_n") or 0)
        self._cal_sum = float(snapshot.get("cal_sum") or 0.0)


class DriftMonitor:
    """The fleet's :class:`MachineDrift` set."""

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig.from_env()
        self._machines: Dict[str, MachineDrift] = {}

    @classmethod
    def from_revision(cls, collection_dir: str, config: Optional[DriftConfig] = None) -> "DriftMonitor":
        """A monitor with every artifact of ``collection_dir``, each with its
        persisted baseline (one without still joins)."""
        monitor = cls(config)
        for name in serializer.list_model_dirs(collection_dir):
            monitor.ensure(name, baseline=_load_baseline(collection_dir, name))
        return monitor

    def ensure(self, name: str, baseline: Optional[Dict[str, Any]] = None) -> MachineDrift:
        machine = self._machines.get(name)
        if machine is None:
            machine = self._machines[name] = MachineDrift(name, baseline=baseline, config=self.config)
        return machine

    def machines(self) -> List[str]:
        return sorted(self._machines)

    def observe_scores(self, frames: Dict[str, Any], scores: Dict[str, Any]) -> None:
        """Fold one scored window in: ``frames[name]`` the raw rows,
        ``scores[name]`` ``(reconstruction, per-row mse)`` as
        ``RevisionFleet.fleet_scores`` answers; a machine that failed to
        score adds its rows and no residuals."""
        for name, X in frames.items():
            entry = scores.get(name)
            try:
                self.ensure(name).observe(X, entry[1] if entry is not None else None)
            except Exception as exc:  # noqa: BLE001 - one machine's bad frame spares the others
                logger.warning("drift observe failed for %s: %r", name, exc)

    def evaluate(self, reset: bool = True) -> Dict[str, DriftVerdict]:
        """Every machine's verdict; one that fails to evaluate is not drifted."""
        verdicts: Dict[str, DriftVerdict] = {}
        for name, machine in sorted(self._machines.items()):
            try:
                verdicts[name] = machine.evaluate(reset=reset)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:  # noqa: BLE001 - per-machine isolation
                logger.warning("drift evaluation failed for %s: %r", name, exc)
                verdicts[name] = DriftVerdict(machine=name, stats={"error": repr(exc)})
        return verdicts

    def snapshot(self) -> Dict[str, Any]:
        return {name: machine.snapshot() for name, machine in self._machines.items()}

    def restore(self, snapshot: Dict[str, Any]) -> None:
        for name, machine_snapshot in (snapshot or {}).items():
            try:
                self.ensure(name).restore(machine_snapshot)
            except (TypeError, ValueError) as exc:
                logger.warning("drift snapshot for %s ignored: %r", name, exc)


def _load_baseline(collection_dir: str, name: str) -> Optional[Dict[str, Any]]:
    """One artifact's ``drift_baseline`` (None when it has none or its
    metadata is torn)."""
    try:
        with open(os.path.join(collection_dir, name, "metadata.json")) as f:
            doc = json.load(f)
        return doc.get("metadata", {}).get("build_metadata", {}).get("drift_baseline")
    except (OSError, ValueError, AttributeError) as exc:
        logger.debug("no drift baseline for %s/%s: %r", collection_dir, name, exc)
        return None
