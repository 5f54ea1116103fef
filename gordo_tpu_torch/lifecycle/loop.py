"""
The fleet lifecycle's supervisor, a copy of ``gordo_tpu/lifecycle/loop.py``:
drift, a partial rebuild, a canary, the gates, then a promotion or a
rollback, while serving goes on.

One :class:`LifecycleSupervisor` owns one served collection directory (the
anchor, what the server serves) and runs cycles over scored rows:

1. **observe**: score the rows through the serving fleet (``fleet_scores``,
   one K2 launch a spec bucket) and fold them into the drift statistics;
2. **detect**: the machines whose verdict trips, and those whose serving
   breaker tripped, become the stale set (less those in quarantine
   cooldown);
3. **rebuild**: only the stale machines, on the store's device
   (:func:`~gordo_tpu_torch.parallel.fleet_build.rebuild_stale`, replaying
   the serving revision's ``fleet_plan.json``; its CV scoring runs K1);
4. **canary**: the rebuilt members and hardlinks of the rest become a new
   revision (``revision.py``), which takes ``canary_fraction`` of the
   anchor's traffic (``FleetModelStore.set_canary``);
5. **gate**: ``gates.py`` on the last probe window, scored by both fleets;
6. **promote**: a passing canary is swapped in (``FleetModelStore.swap``):
   a request already holding a fleet finishes on it, later ones go to the
   new revision;
7. **rollback**: a failing canary loses its slice and is quarantined
   (``quarantine.json``, the health ledger), and serving stays where it was.

Every phase boundary is written to ``state.json`` before its side
effects, and the fault sites ``drift_eval``, ``canary_build``,
``promote_swap`` and ``rollback`` (``utils/faults.py``) let a drill crash
a phase: a supervisor made again resumes it.

Where the port differs from the JAX supervisor:

- **The store.** The port has no process-wide store: the supervisor is
  given one, the app's (``app.store``) to route the app's traffic, and,
  for the engine's warmup of a fleet about to take traffic, the app's
  engine. :func:`restore_serving_state` takes the store too.
- **The device.** The rebuild runs on the store's device, or on
  ``trainer``'s (a ``FleetTrainer``, which also brings its random source).
- **The health ledger** is the anchor directory's serving ledger
  (``telemetry.serving_ledger``), the one the app feeds: drift,
  quarantine, promotion and the rebuild's build records go there.

Under ``GORDO_TPU_PERFMODEL_RECAL`` each cycle ends with one
recalibration of the learned performance model
(``perfmodel.service.maybe_recalibrate``) over the telemetry directory
(``GORDO_TPU_TELEMETRY_DIR``), else the collection directory: the cycle
report's ``details["perfmodel"]`` and a ``perfmodel_recalibrated`` event
say what it did; a failure is a debug line, never a broken cycle.

Its spans and events go to ``lifecycle_trace.jsonl`` in
``GORDO_TPU_TELEMETRY_DIR``, else in ``<models root>/.lifecycle``
(telemetry on); its counters and gauges to the ``gordo_fleet_lifecycle_*``
families of the process's Prometheus registry.
"""

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..parallel.fleet_build import rebuild_stale
from ..perfmodel.service import maybe_recalibrate
from ..planner import PLAN_FILE
from ..server.prometheus import metrics as prometheus
from ..telemetry import slo as slo_engine
from ..utils.env import env_bool, env_float, env_str
from ..utils.faults import fault_point
from .drift import DriftConfig, DriftMonitor, DriftVerdict
from .gates import GateConfig, GateReport, evaluate_canary
from .revision import list_revisions, next_revision, publish_canary
from .state import LIFECYCLE_DIR, LifecycleState

logger = logging.getLogger(__name__)

#: the span trace the supervisor appends to
LIFECYCLE_TRACE_FILE = "lifecycle_trace.jsonl"

PERFMODEL_RECAL_ENV = "GORDO_TPU_PERFMODEL_RECAL"


@dataclass
class LifecycleConfig:
    """The supervisor's knobs, with the drift and gate configs."""

    #: traffic share the canary takes while it is gated
    canary_fraction: float = 0.25
    #: promote when the gates pass (False: ``lifecycle promote`` does)
    auto_promote: bool = True
    #: load the canary's and the promoted revision's models and buckets
    #: (and warm the engine on it) before either takes traffic
    warm_swaps: bool = True
    #: a machine whose canary was quarantined this recently is not rebuilt
    #: again, so a broken rebuild path cannot canary-storm
    quarantine_cooldown_s: float = 3600.0
    #: hold auto-promotions while a page-severity SLO alert fires
    slo_gate: bool = True
    #: members whose serving breaker tripped are rebuild candidates too
    breaker_rebuild: bool = True
    drift: DriftConfig = field(default_factory=DriftConfig)
    gates: GateConfig = field(default_factory=GateConfig)

    @classmethod
    def from_env(cls) -> "LifecycleConfig":
        return cls(
            canary_fraction=env_float("GORDO_TPU_CANARY_FRACTION", 0.25),
            quarantine_cooldown_s=env_float("GORDO_TPU_QUARANTINE_COOLDOWN", 3600.0),
            slo_gate=env_bool("GORDO_TPU_GATE_SLO_BURN", True),
            breaker_rebuild=env_bool("GORDO_TPU_LIFECYCLE_BREAKER_REBUILD", True),
            drift=DriftConfig.from_env(),
            gates=GateConfig.from_env(),
        )


@dataclass
class CycleReport:
    """What one :meth:`LifecycleSupervisor.run_cycle` did."""

    phase: str = "idle"
    drifted: Dict[str, List[str]] = field(default_factory=dict)
    stale: List[str] = field(default_factory=list)
    canary_revision: Optional[str] = None
    promoted: bool = False
    rolled_back: bool = False
    gate: Optional[Dict[str, Any]] = None
    details: Dict[str, Any] = field(default_factory=dict)


class LifecycleSupervisor:
    """The drift-triggered rebuild, canary and promotion loop of one served
    collection directory, routing through ``store`` (the app's
    ``FleetModelStore``). ``engine``: the app's serving engine, warmed on a
    fleet before it takes traffic. ``trainer``: the rebuild's
    ``FleetTrainer`` (default one on the store's device)."""

    def __init__(self, machines: Sequence[Any], collection_dir: str, store: Any,
                 config: Optional[LifecycleConfig] = None, engine: Any = None, trainer: Any = None):
        self.machines = list(machines)
        self.collection_dir = os.path.normpath(collection_dir)
        self.models_root = os.path.dirname(self.collection_dir)
        self.anchor_revision = os.path.basename(self.collection_dir)
        self.store = store
        self.engine = engine
        self.trainer = trainer
        self.config = config or LifecycleConfig.from_env()
        self.state = LifecycleState.load(self.models_root)
        if self.state.anchor_revision not in (None, self.anchor_revision):
            # a new deploy moved the served revision: start afresh (quarantine records stay)
            logger.warning("lifecycle state anchored to revision %s but serving %s; starting a fresh lifecycle",
                           self.state.anchor_revision, self.anchor_revision)
            self.state = LifecycleState(self.models_root)
        if self.state.anchor_revision is None:
            self.state.update(anchor_revision=self.anchor_revision, serving_revision=self.anchor_revision)
        self.recorder: Any = telemetry.NULL_RECORDER
        if telemetry.enabled():
            trace_dir = env_str(telemetry.TRACE_DIR_ENV, None) or os.path.join(self.models_root, LIFECYCLE_DIR)
            try:
                os.makedirs(trace_dir, exist_ok=True)
                self.recorder = telemetry.SpanRecorder(sink_path=os.path.join(trace_dir, LIFECYCLE_TRACE_FILE),
                                                       service="gordo-tpu-lifecycle")
            except OSError as exc:
                logger.debug("no lifecycle trace sink: %r", exc)
        self.monitor = DriftMonitor.from_revision(self.serving_dir, self.config.drift)
        self.monitor.restore(self.state.doc.get("drift") or {})
        self._probe_frames: Optional[Dict[str, Any]] = None
        self._project = getattr(self.machines[0], "project_name", "") if self.machines else ""
        # the anchor's ledger: drift, quarantine and promotion outlive revision swaps
        self._ledger: Any = telemetry.serving_ledger(self.collection_dir, project=self._project)

    # -- identity -----------------------------------------------------------

    @property
    def serving_revision(self) -> str:
        return self.state.serving_revision or self.anchor_revision

    @property
    def serving_dir(self) -> str:
        return os.path.join(self.models_root, self.serving_revision)

    def canary_dir(self, revision: Optional[str] = None) -> Optional[str]:
        revision = revision or self.state.canary_revision
        return os.path.join(self.models_root, revision) if revision else None

    def _build_dir(self, revision: str) -> str:
        return os.path.join(self.models_root, LIFECYCLE_DIR, f"build-{revision}")

    def close(self) -> None:
        self.recorder.close()

    def attach_stream(self, plane: Any) -> None:
        """Feed the streaming plane's flushes into this supervisor's drift
        statistics (``StreamPlane.attach_drift``)."""
        plane.attach_drift(self.monitor)

    # -- observation --------------------------------------------------------

    def observe(self, frames: Dict[str, Any]) -> Tuple[Dict, Dict]:
        """Score ``frames`` through the serving fleet and fold them into
        the drift statistics; ``(scores, errors)`` as ``fleet_scores``
        answers them."""
        fleet = self.store.fleet(self.serving_dir)
        with self.recorder.span("lifecycle_observe", machines=len(frames)):
            scores, errors = fleet.fleet_scores(frames)
        self.monitor.observe_scores(frames, scores)
        self._probe_frames = dict(frames)
        self._feed_scores(frames, scores)
        return scores, errors

    def _feed_scores(self, frames: Dict[str, Any], scores: Dict) -> None:
        """Each machine's rows and residual mean into the health ledger."""
        try:
            for name, entry in scores.items():
                frame = frames.get(name)
                residuals = np.asarray(entry[1], dtype=float).ravel()
                residuals = residuals[np.isfinite(residuals)]
                self._ledger.record_scores(name, len(frame) if frame is not None else 0,
                                           float(residuals.mean()) if len(residuals) else None, write=False)
            self._ledger.write()
        except Exception as exc:  # noqa: BLE001 - the ledger is advisory
            logger.debug("health ledger scores not recorded: %r", exc)

    def evaluate_drift(self) -> Dict[str, DriftVerdict]:
        """Every machine's drift verdict (tested windows reset)."""
        with self.recorder.span("drift_eval", machines=len(self.monitor.machines())):
            verdicts = self.monitor.evaluate()
        for name, verdict in verdicts.items():
            if verdict.drifted:
                self.recorder.event("machine_drifted", machine=name, reasons=verdict.reasons,
                                    **{k: v for k, v in verdict.stats.items() if isinstance(v, (int, float))})
        try:
            for name, verdict in verdicts.items():
                self._ledger.record_drift(name, verdict.drifted, verdict.reasons, verdict.stats, write=False)
            self._ledger.flush()
        except Exception as exc:  # noqa: BLE001 - the ledger is advisory
            logger.debug("health ledger drift not recorded: %r", exc)
        return verdicts

    # -- the cycle ----------------------------------------------------------

    def run_cycle(self, frames: Optional[Dict[str, Any]] = None) -> CycleReport:
        """One cycle: observe ``frames`` (when given), then advance the
        phase machine as far as it goes; an interrupted phase resumes first."""
        report = CycleReport(phase=self.state.phase)
        with self.recorder.span("lifecycle_cycle", phase=self.state.phase):
            if frames:
                self.observe(frames)
            if self.state.phase == "rolling_back":
                self._finish_rollback(report)
            if self.state.phase == "idle":
                self._detect(report)
            if self.state.phase == "canary_building":
                self._build_and_publish(report)
            if self.state.phase == "canary_serving":
                self._gate_and_settle(report)
            # windows in progress survive a restart
            self.state.update(drift=self.monitor.snapshot())
            self._maybe_recalibrate(report)
        report.phase = self.state.phase
        self._export_status(report)
        return report

    def _maybe_recalibrate(self, report: CycleReport) -> None:
        """The learned performance model's recalibration, once a cycle
        (``gordo_tpu/lifecycle/loop.py:316-346``): off unless
        ``GORDO_TPU_PERFMODEL_RECAL``; advisory, a failure is a debug line."""
        if not env_bool(PERFMODEL_RECAL_ENV, False):
            return
        try:
            corpus = env_str(telemetry.TRACE_DIR_ENV, None) or self.collection_dir
            result = maybe_recalibrate(corpus)
            if result is None:
                return
            report.details["perfmodel"] = {"promoted": bool(result.get("promoted")), "reason": result.get("reason"),
                                           "models": len(result.get("models") or [])}
            self.recorder.event("perfmodel_recalibrated", corpus=corpus, promoted=bool(result.get("promoted")),
                                reason=str(result.get("reason", ""))[:200], models=len(result.get("models") or []))
        except Exception as exc:  # noqa: BLE001 - recalibration is advisory
            logger.debug("perfmodel recalibration skipped: %r", exc)

    def _detect(self, report: CycleReport) -> None:
        verdicts = self.evaluate_drift()
        report.drifted = {name: verdict.reasons for name, verdict in verdicts.items() if verdict.drifted}
        tripped = self._breaker_candidates()
        if tripped:
            report.details["breaker_tripped"] = tripped
            logger.warning("serving breaker tripped for %d machine(s) (%s); nominating for rebuild", len(tripped),
                           ", ".join(tripped[:5]))
        candidates = set(report.drifted) | set(tripped)
        buildable = {m.name for m in self.machines}
        stale = sorted(candidates & buildable)
        unbuildable = sorted(candidates - buildable)
        if unbuildable:
            logger.warning("drifted machines with no machine config (cannot rebuild): %s", ", ".join(unbuildable))
            report.details["unbuildable"] = unbuildable
        cooling = self._quarantine_cooldown() & set(stale)
        if cooling:
            logger.warning("drifted machines in quarantine cooldown (a recent canary for them was rolled back): %s",
                           ", ".join(sorted(cooling)))
            report.details["cooldown"] = sorted(cooling)
            stale = sorted(set(stale) - cooling)
        if not stale:
            return
        report.stale = stale
        revision = next_revision(self.models_root)
        logger.info("drift tripped %d machine(s) (%s); canary revision %s", len(stale), ", ".join(stale[:5]),
                    revision)
        self.state.transition("canary_building", event="drift_detected", stale=stale, canary_revision=revision,
                              drift=self.monitor.snapshot())
        self.recorder.event("canary_started", canary_revision=revision, stale=stale)

    def _build_and_publish(self, report: CycleReport) -> None:
        stale = self.state.stale
        revision = self.state.canary_revision
        report.stale = stale
        report.canary_revision = revision
        fault_point("canary_build", revision or "")
        build_dir = self._build_dir(revision)
        with self.recorder.span("canary_build", canary_revision=revision, stale=len(stale)):
            builder = rebuild_stale(self.machines, stale, build_dir,
                                    base_plan_path=os.path.join(self.serving_dir, PLAN_FILE), resume=True,
                                    trainer=self.trainer, health_ledger=self._ledger, device=self.store.device)
        failed = sorted(builder.build_errors)
        rebuilt = sorted(set(stale) - set(failed))
        report.details["rebuilt"] = rebuilt
        report.details["resumed"] = sorted(builder.resumed)
        if failed:
            report.details["rebuild_failed"] = failed
        if not rebuilt:
            logger.error("canary %s: every stale member failed to rebuild; serving stays on %s", revision,
                         self.serving_revision)
            reasons = [f"{name}: rebuild failed ({exc!r})" for name, exc in sorted(builder.build_errors.items())]
            self.state.quarantine({"canary_revision": revision, "machines": stale, "reasons": reasons})
            self.state.transition("idle", event="canary_build_failed", canary_revision=None, stale=[], rebuilt=[])
            self._count_event("rollbacks")
            self._ledger.record_quarantine(stale, revision, reasons)
            report.rolled_back = True
            return
        canary_path = publish_canary(self.models_root, self.serving_revision, build_dir, rebuilt, revision)
        self.recorder.event("canary_published", canary_revision=revision, rebuilt=rebuilt, failed=failed)
        fleet = self.store.set_canary(self.collection_dir, canary_path, self.config.canary_fraction,
                                      warm=self.config.warm_swaps)
        self._warm_programs(fleet)
        self.state.transition("canary_serving", event="canary_serving", rebuilt=rebuilt)
        self._count_event("rebuilds", len(rebuilt))

    def _gate_and_settle(self, report: CycleReport) -> None:
        revision = self.state.canary_revision
        report.canary_revision = revision
        canary_path = self.canary_dir(revision)
        # routing is process memory: a supervisor made again installs the slice again
        if self.store.canary_status() is None and canary_path:
            self.store.set_canary(self.collection_dir, canary_path, self.config.canary_fraction,
                                  warm=self.config.warm_swaps)
        probe = self._probe_frames
        if not probe:
            report.details["gate"] = "awaiting probe data"
            return
        rebuilt = list(self.state.doc.get("rebuilt") or self.state.stale)
        try:
            with self.recorder.span("canary_gate", canary_revision=revision, rebuilt=len(rebuilt)):
                gate = evaluate_canary(self.store.fleet(self.serving_dir), self.store.fleet(canary_path), probe,
                                       rebuilt, self.config.gates)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:  # noqa: BLE001 - a canary that cannot be gated fails
            gate = GateReport()
            gate.fail(f"gate evaluation crashed: {exc!r}")
        report.gate = {"passed": gate.passed, "failures": gate.failures, "checks": gate.checks}
        self.recorder.event("canary_gate", canary_revision=revision, passed=gate.passed, failures=gate.failures)
        if not gate.passed:
            self._rollback(report, gate.failures)
            return
        holding = self._slo_hold()
        if holding:
            # the canary keeps its slice and is gated again next cycle
            report.details["gate"] = f"passed; auto-promotion held: SLO page alert firing ({', '.join(holding)})"
            report.details["slo_hold"] = holding
            logger.warning("canary %s passed gates but auto-promotion is held: firing SLO page alert(s) %s",
                           revision, ", ".join(holding))
        elif self.config.auto_promote:
            self._promote(report)
        else:
            report.details["gate"] = "passed; awaiting manual promote"

    def _promote(self, report: CycleReport) -> None:
        revision = self.state.canary_revision
        canary_path = self.canary_dir(revision)
        fault_point("promote_swap", revision or "")
        start = time.monotonic()
        with self.recorder.span("promote_swap", canary_revision=revision):
            self.store.swap(self.collection_dir, canary_path, warm=self.config.warm_swaps)
        swap_seconds = time.monotonic() - start
        rebuilt = list(self.state.doc.get("rebuilt") or self.state.stale)
        self.state.transition("idle", event="promoted", serving_revision=revision, canary_revision=None, stale=[],
                              rebuilt=[])
        self._ledger.record_promotion(revision, rebuilt)
        logger.info("promoted canary %s into serving (swap %.3fs)", revision, swap_seconds)
        self.recorder.event("promoted", revision=revision, swap_seconds=round(swap_seconds, 4))
        # the rebuilt members' baselines are new: every window restarts
        self.monitor = DriftMonitor.from_revision(self.serving_dir, self.config.drift)
        report.promoted = True
        report.details["swap_seconds"] = round(swap_seconds, 4)
        self._count_event("promotions")
        self._observe_swap(swap_seconds)

    def _rollback(self, report: CycleReport, reasons: List[str]) -> None:
        self.state.transition("rolling_back", event="canary_rejected", reasons=reasons)
        self._finish_rollback(report, reasons=reasons)

    def _finish_rollback(self, report: CycleReport, reasons: Optional[List[str]] = None) -> None:
        revision = self.state.canary_revision
        reasons = reasons or list(self.state.doc.get("reasons") or [])
        quarantined = self.state.stale
        fault_point("rollback", revision or "")
        with self.recorder.span("rollback", canary_revision=revision):
            self.store.clear_canary(self.collection_dir)
            # a crashed promote may have swapped without its transition: serve the recorded revision
            self.store.swap(self.collection_dir, self.serving_dir, warm=False)
            self.state.quarantine({"canary_revision": revision, "machines": self.state.stale, "reasons": reasons})
            self.state.transition("idle", event="rolled_back", canary_revision=None, stale=[], rebuilt=[],
                                  reasons=[])
        logger.warning("canary %s rolled back (%s); serving stays on %s", revision,
                       "; ".join(reasons[:3]) or "no reasons recorded", self.serving_revision)
        self.recorder.event("rolled_back", canary_revision=revision, reasons=reasons)
        report.rolled_back = True
        report.details["quarantined"] = revision
        self._count_event("rollbacks")
        self._ledger.record_quarantine(quarantined, revision, reasons)

    def _breaker_candidates(self) -> List[str]:
        """Machines whose serving breaker is open, from the anchor's health
        snapshots (records expire: a dead server's ``open`` drives nothing)."""
        if not self.config.breaker_rebuild:
            return []
        try:
            return sorted(telemetry.breaker_tripped_machines(self.collection_dir))
        except Exception as exc:  # noqa: BLE001 - the feed is advisory
            logger.debug("breaker candidates not read: %r", exc)
            return []

    def _quarantine_cooldown(self) -> set:
        """Machines whose canary was quarantined within the cooldown."""
        cooldown = self.config.quarantine_cooldown_s
        if cooldown <= 0:
            return set()
        cutoff = time.time() - cooldown
        cooling: set = set()
        for record in self.state.quarantined():
            if float(record.get("time") or 0.0) >= cutoff:
                cooling.update(record.get("machines") or [])
        return cooling

    def _slo_hold(self) -> List[str]:
        """The firing page-severity SLO alerts of the anchor's telemetry
        directory (persisted state, no evaluation; a state older than
        ``STALE_ALERT_HOLD_S`` holds nothing)."""
        if not self.config.slo_gate:
            return []
        try:
            directory = slo_engine.slo_directory(self.collection_dir)
            if not directory:
                return []
            return [alert["id"] for alert in slo_engine.firing_alerts(directory, severity="page",
                                                                       max_age_s=slo_engine.STALE_ALERT_HOLD_S)]
        except Exception as exc:  # noqa: BLE001 - a broken SLO state must not wedge the loop
            logger.debug("slo hold check failed: %r", exc)
            return []

    # -- manual controls (the commands) -------------------------------------

    def promote(self, force: bool = False) -> CycleReport:
        """Gate the current canary on the last probe window (unless
        ``force``) and swap it in."""
        report = CycleReport(phase=self.state.phase)
        if self.state.phase != "canary_serving":
            raise RuntimeError(f"no canary to promote (phase {self.state.phase})")
        if force:
            report.canary_revision = self.state.canary_revision
            self._promote(report)
        else:
            previous, self.config.auto_promote = self.config.auto_promote, True
            try:
                self._gate_and_settle(report)
            finally:
                self.config.auto_promote = previous
            if report.details.get("slo_hold"):
                holding = ", ".join(report.details["slo_hold"])
                raise RuntimeError(f"promotion held: SLO page alert(s) firing ({holding}); resolve the burn or use "
                                   "--force")
            if not (report.promoted or report.rolled_back):
                raise RuntimeError("gates could not run (no probe data scored yet); re-run after traffic or use "
                                   "--force")
        report.phase = self.state.phase
        return report

    def rollback(self, reason: str = "operator rollback") -> CycleReport:
        """Roll the current canary back (or finish an interrupted rollback)."""
        report = CycleReport(phase=self.state.phase)
        if self.state.phase not in ("canary_serving", "rolling_back"):
            raise RuntimeError(f"no canary to roll back (phase {self.state.phase})")
        report.canary_revision = self.state.canary_revision
        if self.state.phase == "canary_serving":
            self._rollback(report, [reason])
        else:
            self._finish_rollback(report, reasons=[reason])
        report.phase = self.state.phase
        return report

    # -- advisory exports ---------------------------------------------------

    def _warm_programs(self, fleet: Any) -> None:
        """The engine's warmup of a fleet about to take traffic (parity
        gates, one forward a bucket), when the app runs an engine."""
        if self.engine is None:
            return
        try:
            self.engine.warmup_fleet(fleet)
        except Exception as exc:  # noqa: BLE001 - warmup only saves the first requests time
            logger.debug("canary warmup skipped: %r", exc)

    def _count_event(self, event: str, n: int = 1) -> None:
        try:
            prometheus.record_fleet_lifecycle_event(self._project, event, n)
        except Exception as exc:  # noqa: BLE001 - metrics are advisory
            logger.debug("lifecycle event not exported: %r", exc)

    def _observe_swap(self, seconds: float) -> None:
        try:
            prometheus.observe_lifecycle_swap(self._project, seconds)
        except Exception as exc:  # noqa: BLE001 - metrics are advisory
            logger.debug("swap duration not exported: %r", exc)

    def _export_status(self, report: CycleReport) -> None:
        try:
            canary = self.store.canary_status()
            prometheus.set_fleet_lifecycle_status(self._project, drifted=len(report.drifted),
                                                  stale=len(self.state.stale),
                                                  canary_fraction=float(canary["fraction"]) if canary else 0.0)
        except Exception as exc:  # noqa: BLE001 - metrics are advisory
            logger.debug("lifecycle status not exported: %r", exc)


def restore_serving_state(store: Any, collection_dir: Optional[str] = None) -> Optional[str]:
    """Route ``collection_dir`` (default the store's) to the revision the
    lifecycle state anchored to it serves, when that revision is another
    one and still on disk (models load lazily; the warmup makes them
    resident). Returns the restored revision, or None."""
    normalized = os.path.normpath(collection_dir or store.collection_dir)
    root, anchor = os.path.dirname(normalized), os.path.basename(normalized)
    state = LifecycleState.load(root)
    if state.anchor_revision != anchor:
        return None
    serving = state.serving_revision
    if not serving or serving == anchor:
        return None
    target = os.path.join(root, serving)
    if serving not in list_revisions(root) or not os.path.isdir(target):
        logger.warning("lifecycle state serves revision %s but it is gone; serving %s", serving, anchor)
        return None
    store.swap(normalized, target, warm=False)
    logger.info("restored lifecycle serving state: %s routes to revision %s", normalized, serving)
    return serving
