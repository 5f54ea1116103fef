"""
The server's and the fleet build's Prometheus metrics, a copy of
``gordo_tpu/server/prometheus/metrics.py`` (``:1-1066``) over the port's
own registry (``registry.py``): the same metric names, HELP strings,
label names, bucket edges and semantics.

- :class:`GordoServerPrometheusMetrics`: the request RED set (requests,
  duration and errors by method, path, status, model and project), the
  per-request stage histograms fed from each response's ``Server-Timing``
  stages, ``gordo_server_info``; paths collapsed to route shapes
  (``{name}``, ``{revision}``, ``{unmatched}``);
- :func:`fleet_build_metrics` and the ``record_*`` / ``set_*`` helpers the
  fleet build calls: phase and compile durations, members' final losses,
  robustness counters, progress and plan gauges;
- :func:`fleet_lifecycle_metrics` and the helpers the lifecycle loop
  calls: rebuilds, promotions and rollbacks, the drifted, stale and canary
  gauges, each promotion's swap seconds;
- the scrape-time collectors: the program cache, the store's resident
  bytes, the fleet health ledgers, the card's memory and the compile
  counters, the SLO statuses, the stream plane;
- :class:`ServeMetrics`: the serving engine's queue depth, batch, shed
  and breaker series.

Where the JAX collectors read process-wide objects (``STORE``, the one
stream plane), the port's read every live app (``app.live_apps``): each
app owns a store and a plane. The program cache and the stream plane are
summed over them, and so are the resident bytes of a revision that two
apps hold. :func:`~gordo_tpu_torch.telemetry.fleet_health.ledger_summaries`
covers every directory the process made a build or serving ledger for.

Metric objects are made once a registry, so a second app of the process
shares the first one's families. With ``PROMETHEUS_MULTIPROC_DIR`` set
(``run-server``'s workers, ``server/prefork.py``), an app's metrics keep
their numbers in the worker's files of that directory
(``multiprocess.py``) on a registry of their own, and
:func:`multiprocess_registry` is the fan-in that the master serves. Every
gauge is merged by its largest value across processes
(``multiprocess_mode="max"``), as the JAX package's are. A forked worker
forgets the metric objects its parent made (``register_postfork_reset``).

One difference from the JAX class: :class:`GordoServerPrometheusMetrics`
caches its stage children by (project, endpoint, stage). The JAX one
keys them by (endpoint, stage), so with no ``PROJECT`` a second project's
stages count under the first project seen on that endpoint.
"""

import os
import re
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ... import __version__
from ...utils.postfork import register_postfork_reset
from .multiprocess import MULTIPROC_ENV, MultiProcessCollector, multiprocess_dir  # noqa: F401 - MULTIPROC_ENV re-exported
from .registry import (
    REGISTRY,
    CollectorRegistry,
    Counter,
    CounterMetricFamily,
    Gauge,
    GaugeHistogramMetricFamily,
    GaugeMetricFamily,
    Histogram,
)

#: the model name of a request path under the API prefix: /gordo/v0/<project>/<name>/...
_MODEL_PATH_RE = re.compile(r"^/gordo/v0/(?P<project>[^/]+)/(?P<name>[^/]+)(?:/|$)")

#: a route that would only add scrape noise
IGNORED_PATH = "/healthcheck"

PROJECT_LEVEL_ROUTES = (
    "models",
    "revisions",
    "expected-models",
    "build-status",
    "fleet-health",
    "slo",
)

#: request-stage latency buckets: stages span sub-millisecond lookups to
#: second-scale inference and serialize on fat payloads
_STAGE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

def _ensure_multiproc_dir() -> Optional[str]:
    """The configured ``PROMETHEUS_MULTIPROC_DIR`` (either spelling),
    made when it is missing, or None."""
    directory = multiprocess_dir()
    if directory:
        os.makedirs(directory, exist_ok=True)
    return directory


def multiprocess_registry() -> Optional[CollectorRegistry]:
    """A registry fanning in every process's files when
    ``PROMETHEUS_MULTIPROC_DIR`` is set (``gordo_tpu/server/prometheus/metrics.py:52-83``),
    else None. It carries the scrape-time collectors too (program cache,
    fleet console): they have no files, so the fan-in alone would drop
    them."""
    if not _ensure_multiproc_dir():
        return None
    registry = CollectorRegistry()
    MultiProcessCollector(registry)
    register_program_cache_collector(registry)
    register_fleet_console_collectors(registry)
    return registry


_made_lock = threading.RLock()


def _once_per_registry(cache: "weakref.WeakKeyDictionary", registry: Optional[CollectorRegistry], make) -> Any:
    """``make(registry)``'s result for ``registry`` (default: ``REGISTRY``),
    made once while the registry lives. Weak keys: a dead registry's id
    handed to a new one never aliases the old metric objects."""
    target = registry if registry is not None else REGISTRY
    with _made_lock:
        made = cache.get(target)
        if made is None:
            made = cache[target] = make(target)
    return made


_request_metrics: "weakref.WeakKeyDictionary[CollectorRegistry, dict]" = weakref.WeakKeyDictionary()


def _make_request_metrics(registry: CollectorRegistry) -> Dict[str, Any]:
    label_names = ["method", "path", "status_code", "gordo_name", "project"]
    return {
        "request_count": Counter(
            "gordo_server_requests_total",
            "Total number of requests to the gordo model server",
            labelnames=label_names,
            registry=registry,
        ),
        "request_duration": Histogram(
            "gordo_server_request_duration_seconds",
            "Request processing wall-time",
            labelnames=label_names,
            registry=registry,
        ),
        "error_count": Counter(
            "gordo_server_request_errors_total",
            "Requests answered with an error status (kind=client for "
            "4xx — including 429/504 batching backpressure — and "
            "kind=server for 5xx)",
            labelnames=label_names + ["kind"],
            registry=registry,
        ),
        # bounded labels: the route map's endpoint names and the stage set
        # (model_resolve, data_decode, device_ingest, inference,
        # response_assemble, serialize and the engine's queue_wait/batch_*)
        "stage_duration": Histogram(
            "gordo_server_stage_duration_seconds",
            "Per-request pipeline-stage wall-time (one observation per "
            "stage per request — the aggregable form of the "
            "Server-Timing response header)",
            labelnames=["project", "endpoint", "stage"],
            buckets=_STAGE_BUCKETS,
            registry=registry,
        ),
        "info": Gauge(
            "gordo_server_info",
            "Server build information",
            labelnames=["version", "project"],
            registry=registry,
            multiprocess_mode="max",
        ),
    }


class GordoServerPrometheusMetrics:
    """The serving RED metric set of one app, keyed by route, model and
    status: ``gordo_server_requests_total`` (rate),
    ``gordo_server_request_errors_total`` (4xx ``kind="client"``, 5xx
    ``kind="server"``), the route latency histogram and
    ``gordo_server_stage_duration_seconds{endpoint,stage}``, the
    ``Server-Timing`` stages of each request as histograms. ``observe``
    reads the port's request (``method``, ``path``) and response
    (``status``, ``stage_durations``, ``endpoint``)."""

    def __init__(
        self,
        project: Optional[str] = None,
        registry: Optional[CollectorRegistry] = None,
    ):
        self.project = project
        self.registry = registry if registry is not None else REGISTRY
        families = _once_per_registry(_request_metrics, self.registry, _make_request_metrics)
        self.request_count = families["request_count"]
        self.request_duration = families["request_duration"]
        self.error_count = families["error_count"]
        self.stage_duration = families["stage_duration"]
        self.info = families["info"]
        self.info.labels(version=__version__, project=project or "").set(1)
        # the scrape-time aggregates ride every scrape registry, batching on or off
        register_fleet_console_collectors(self.registry)
        # label-child caches: a .labels() call builds a key and may take the
        # metric's lock; on the request path it is paid 2-7 times a request
        self._request_children: dict = {}
        self._stage_children: dict = {}
        #: raw (method, path, status) -> labels; the distinct raw paths are
        #: bounded by models x routes
        self._labels_cache: dict = {}

    def _labels(self, request: Any, response: Any) -> Optional[dict]:
        key = (request.method, request.path, response.status)
        try:
            return self._labels_cache[key]
        except KeyError:
            labels = self._labels_uncached(request, response)
            if len(self._labels_cache) < 4096:
                self._labels_cache[key] = labels
            return labels

    def _labels_uncached(self, request: Any, response: Any) -> Optional[dict]:
        path = request.path
        if path == IGNORED_PATH:
            return None
        gordo_name = ""
        project = self.project or ""
        match = _MODEL_PATH_RE.match(path)
        if match:
            project = project or match.group("project")
            name = match.group("name")
            if name not in PROJECT_LEVEL_ROUTES:
                gordo_name = name
                # the route's shape, so label cardinality is bounded by routes, not models or revisions
                path = _MODEL_PATH_RE.sub("/gordo/v0/{project}/{name}/", path, count=1)
                path = re.sub(r"revision/\d+$", "revision/{revision}", path)
            else:
                path = _MODEL_PATH_RE.sub("/gordo/v0/{project}/" + name, path, count=1)
        elif path not in ("/healthcheck", "/server-version"):
            # scanners and typos must not mint series
            path = "{unmatched}"
        return {
            "method": request.method,
            "path": path,
            "status_code": str(response.status),
            "gordo_name": gordo_name,
            "project": project,
        }

    def observe(self, request: Any, response: Any, duration_s: float) -> None:
        labels = self._labels(request, response)
        if labels is None:
            return
        key = (labels["method"], labels["path"], labels["status_code"], labels["gordo_name"], labels["project"])
        children = self._request_children.get(key)
        if children is None:
            children = self._request_children[key] = (
                self.request_count.labels(**labels),
                self.request_duration.labels(**labels),
            )
        count_child, duration_child = children
        count_child.inc()
        duration_child.observe(duration_s)
        status = response.status
        if status >= 400:
            self.error_count.labels(**labels, kind="server" if status >= 500 else "client").inc()
        stages = getattr(response, "stage_durations", None)
        if stages:
            endpoint = getattr(response, "endpoint", None) or "{unmatched}"
            for stage, seconds in stages.items():
                stage_key = (labels["project"], endpoint, stage)
                child = self._stage_children.get(stage_key)
                if child is None:
                    child = self._stage_children[stage_key] = self.stage_duration.labels(
                        project=labels["project"], endpoint=endpoint, stage=stage)
                child.observe(seconds)


def create_prometheus_metrics(
    project: Optional[str] = None, registry: Optional[CollectorRegistry] = None
) -> GordoServerPrometheusMetrics:
    """An app's request metrics on ``registry`` (default: a new
    :func:`multiprocess_registry` when the directory is set, else
    ``REGISTRY``)."""
    if registry is None:
        registry = multiprocess_registry() or REGISTRY
    return GordoServerPrometheusMetrics(project=project, registry=registry)


#: (robustness key, metric name, help) of each fleet-build robustness counter
_BUILD_ROBUSTNESS_COUNTERS = (
    (
        "fleet_retries",
        "gordo_fleet_build_member_retries_total",
        "Diverged fleet members retrained with a reseeded RNG",
    ),
    (
        "bucket_bisects",
        "gordo_fleet_build_bucket_bisects_total",
        "Device-program bucket bisection (split-retry) events",
    ),
    (
        "data_fetch_retries",
        "gordo_fleet_build_data_fetch_retries_total",
        "Per-machine data fetch retry attempts",
    ),
    (
        "sequential_degraded",
        "gordo_fleet_build_sequential_degraded_total",
        "Machines degraded to the sequential builder after isolated "
        "device failures",
    ),
)

#: build phases span sub-second host phases to multi-minute training
_PHASE_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0, 600.0, 1800.0, 3600.0,
)
#: first calls span quick programs to the first run of long trainings
_COMPILE_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0, 600.0, 1800.0, 3600.0,
)
#: final training losses of normalized autoencoder fleets
_LOSS_BUCKETS = (
    1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 100.0,
)

_build_metrics: "weakref.WeakKeyDictionary[CollectorRegistry, dict]" = weakref.WeakKeyDictionary()


def _make_build_metrics(target: CollectorRegistry) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {
        counter_key: Counter(name, help_text, labelnames=["project"], registry=target)
        for counter_key, name, help_text in _BUILD_ROBUSTNESS_COUNTERS
    }
    metrics["phase_duration"] = Histogram(
        "gordo_fleet_build_phase_duration_seconds",
        "Wall-clock of fleet build phases (per occurrence; phases "
        "like cv_train recur once per bucket chunk)",
        labelnames=["project", "phase"],
        buckets=_PHASE_BUCKETS,
        registry=target,
    )
    metrics["compile_duration"] = Histogram(
        "gordo_fleet_compile_duration_seconds",
        "FIRST-CALL wall-clock of fleet device programs per program "
        "and bucket shape: XLA trace+compile plus the first "
        "execution (they are not separable without an AOT split). "
        "The cache-miss signal is the DELTA vs later calls of the "
        "same signature in gordo_fleet_build_phase_duration_seconds "
        "/ the device_program run spans, not this value alone",
        labelnames=["project", "program", "shape"],
        buckets=_COMPILE_BUCKETS,
        registry=target,
    )
    metrics["member_final_loss"] = Histogram(
        "gordo_fleet_member_final_loss",
        "Final training loss of fleet members at the end of their "
        "final fit",
        labelnames=["project"],
        buckets=_LOSS_BUCKETS,
        registry=target,
    )
    for gauge_key, name, help_text in (
        (
            "machines_total",
            "gordo_fleet_build_machines_total",
            "Machines in the currently running fleet build",
        ),
        (
            "machines_completed",
            "gordo_fleet_build_machines_completed",
            "Machines whose artifacts have landed in the current "
            "fleet build (updated live, not only at build end)",
        ),
        (
            "machines_failed",
            "gordo_fleet_build_machines_failed",
            "Machines failed so far in the current fleet build",
        ),
    ):
        metrics[gauge_key] = Gauge(name, help_text, labelnames=["project"], registry=target, multiprocess_mode="max")
    # the plan's promise beside what the final fit cost; strategy is bounded (naive|packed)
    for gauge_key, name, help_text in (
        (
            "plan_predicted_seconds",
            "gordo_fleet_plan_predicted_seconds",
            "FleetPlan predicted build wall-clock (compile + run) for "
            "the planned final-fit buckets",
        ),
        (
            "plan_padding_waste",
            "gordo_fleet_plan_padding_waste_ratio",
            "FleetPlan predicted padded-FLOP waste ratio (padding "
            "FLOPs / total padded FLOPs) across the planned buckets",
        ),
        (
            "plan_compiles",
            "gordo_fleet_plan_compiles",
            "Distinct XLA programs the FleetPlan predicts the planned "
            "buckets will compile",
        ),
        (
            "plan_actual_compiles",
            "gordo_fleet_plan_actual_compiles",
            "First-call (compile) fit programs actually observed "
            "during the final-fit phase of the build",
        ),
        (
            "plan_actual_seconds",
            "gordo_fleet_plan_actual_seconds",
            "Wall-clock of fit device programs actually observed "
            "during the final-fit phase of the build",
        ),
    ):
        metrics[gauge_key] = Gauge(name, help_text, labelnames=["project", "strategy"], registry=target,
                                   multiprocess_mode="max")
    return metrics


def fleet_build_metrics() -> dict:
    """The fleet-build metric set of ``REGISTRY``, made once: the
    robustness counters, the phase, compile and final-loss histograms, the
    progress and plan gauges."""
    return _once_per_registry(_build_metrics, REGISTRY, _make_build_metrics)


def record_fleet_build_robustness(project: Optional[str], counters: dict) -> None:
    """A finished build's robustness counters."""
    metrics = fleet_build_metrics()
    for key, _, _ in _BUILD_ROBUSTNESS_COUNTERS:
        value = int(counters.get(key, 0) or 0)
        if value:
            metrics[key].labels(project=project or "").inc(value)


def record_fleet_build_phase(project: Optional[str], phase: str, seconds: float) -> None:
    """One build phase occurrence's wall-clock."""
    fleet_build_metrics()["phase_duration"].labels(project=project or "", phase=phase).observe(seconds)


def record_fleet_compile(project: Optional[str], program: str, shape: str, seconds: float) -> None:
    """One device program's first call; ``shape`` is the bucket's stacked
    shape, bounded by the fleet's distinct buckets."""
    fleet_build_metrics()["compile_duration"].labels(project=project or "", program=program,
                                                     shape=shape).observe(seconds)


def record_member_final_loss(project: Optional[str], loss: float) -> None:
    """One member's final training loss."""
    fleet_build_metrics()["member_final_loss"].labels(project=project or "").observe(loss)


def set_fleet_plan_prediction(project: Optional[str], strategy: str, predicted_seconds: float,
                              padding_waste: float, compiles: int) -> None:
    """A plan's headline predictions, at bucket-plan time."""
    metrics = fleet_build_metrics()
    labels = {"project": project or "", "strategy": strategy}
    metrics["plan_predicted_seconds"].labels(**labels).set(predicted_seconds)
    metrics["plan_padding_waste"].labels(**labels).set(padding_waste)
    metrics["plan_compiles"].labels(**labels).set(compiles)


def set_fleet_plan_actuals(project: Optional[str], strategy: str, seconds: float, compiles: int) -> None:
    """What the planned (final-fit) programs cost."""
    metrics = fleet_build_metrics()
    labels = {"project": project or "", "strategy": strategy}
    metrics["plan_actual_seconds"].labels(**labels).set(seconds)
    metrics["plan_actual_compiles"].labels(**labels).set(compiles)


def set_fleet_build_progress(project: Optional[str], total: int, completed: int, failed: int) -> None:
    """The live machine-progress gauges."""
    metrics = fleet_build_metrics()
    labels = {"project": project or ""}
    metrics["machines_total"].labels(**labels).set(total)
    metrics["machines_completed"].labels(**labels).set(completed)
    metrics["machines_failed"].labels(**labels).set(failed)


# -- fleet lifecycle metrics --------------------------------------------------

_lifecycle_metrics: "weakref.WeakKeyDictionary[CollectorRegistry, dict]" = weakref.WeakKeyDictionary()

_LIFECYCLE_EVENT_COUNTERS = (
    ("rebuilds", "gordo_fleet_lifecycle_rebuilds_total", "Members rebuilt by the drift-triggered lifecycle loop"),
    ("promotions", "gordo_fleet_lifecycle_promotions_total",
     "Canary revisions promoted into serving by the lifecycle loop"),
    ("rollbacks", "gordo_fleet_lifecycle_rollbacks_total",
     "Canary revisions rolled back and quarantined (gate failures, failed rebuilds, operator rollbacks)"),
)

#: hot swaps are sub-second by design; the tail buckets catch cold loads
_SWAP_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0)


def _make_lifecycle_metrics(target: CollectorRegistry) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {
        key: Counter(name, help_text, labelnames=["project"], registry=target)
        for key, name, help_text in _LIFECYCLE_EVENT_COUNTERS
    }
    metrics["drifted"] = Gauge("gordo_fleet_lifecycle_drifted_machines",
                               "Machines whose latest drift evaluation tripped", labelnames=["project"],
                               registry=target, multiprocess_mode="max")
    metrics["stale"] = Gauge("gordo_fleet_lifecycle_stale_machines",
                             "Machines in the current stale set (being rebuilt/canaried)", labelnames=["project"],
                             registry=target, multiprocess_mode="max")
    metrics["canary_fraction"] = Gauge(
        "gordo_fleet_lifecycle_canary_fraction",
        "Traffic fraction currently routed to the canary revision (0 when no canary is serving)",
        labelnames=["project"], registry=target, multiprocess_mode="max")
    metrics["swap_seconds"] = Histogram(
        "gordo_fleet_lifecycle_swap_seconds",
        "Wall-clock of promoting a canary into serving (the hot swap itself, warm included; requests are "
        "never paused)", labelnames=["project"], buckets=_SWAP_BUCKETS, registry=target)
    return metrics


def fleet_lifecycle_metrics(registry: Optional[CollectorRegistry] = None) -> dict:
    """The ``gordo_fleet_lifecycle_*`` set of ``registry`` (default
    ``REGISTRY``), made once: the event counters, the drift and canary
    gauges, the swap histogram."""
    return _once_per_registry(_lifecycle_metrics, registry, _make_lifecycle_metrics)


def record_fleet_lifecycle_event(project: Optional[str], event: str, n: int = 1) -> None:
    """Count ``n`` lifecycle events (``rebuilds``, ``promotions`` or
    ``rollbacks``; any other name is ignored)."""
    if event not in {key for key, _, _ in _LIFECYCLE_EVENT_COUNTERS}:
        return
    if n:
        fleet_lifecycle_metrics()[event].labels(project=project or "").inc(n)


def set_fleet_lifecycle_status(project: Optional[str], drifted: int, stale: int, canary_fraction: float) -> None:
    """The lifecycle loop's status gauges (a cycle)."""
    metrics = fleet_lifecycle_metrics()
    labels = {"project": project or ""}
    metrics["drifted"].labels(**labels).set(drifted)
    metrics["stale"].labels(**labels).set(stale)
    metrics["canary_fraction"].labels(**labels).set(canary_fraction)


def observe_lifecycle_swap(project: Optional[str], seconds: float) -> None:
    """One promotion's hot-swap seconds."""
    fleet_lifecycle_metrics()["swap_seconds"].labels(project=project or "").observe(seconds)


# -- serving engine metrics ---------------------------------------------------

#: batch sizes are bounded by GORDO_TPU_BATCH_MAX_SIZE (default 32)
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
#: ratios in [0, 1] (program occupancy, padding waste)
_RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0)


def _live_apps() -> List[Any]:
    from ..app import live_apps

    return live_apps()


class ProgramCacheCollector:
    """``gordo_server_program_cache_size``: the live apps'
    ``program_cache_stats`` summed. The port compiles no program:
    ``programs`` counts resident (spec, precision) forward buckets,
    ``signatures`` the distinct forward shapes the engines launched."""

    def collect(self):
        totals: Dict[str, int] = {"programs": 0, "signatures": 0}
        by_precision: Dict[str, int] = {}
        for app in _live_apps():
            stats = app.store.program_cache_stats(app.engine)
            totals["programs"] += stats["programs"]
            totals["signatures"] += stats["signatures"]
            for precision, count in (stats.get("by_precision") or {}).items():
                by_precision[precision] = by_precision.get(precision, 0) + count
        family = GaugeMetricFamily(
            "gordo_server_program_cache_size",
            "Compiled serving-program cache size (programs = cached jit "
            "entries per (spec, backend); signatures = XLA executables "
            "compiled inside them, -1 when the jax version hides the "
            "jit cache)",
            labels=["cache"],
        )
        family.add_metric(["programs"], totals["programs"])
        family.add_metric(["signatures"], totals["signatures"])
        for precision, count in sorted(by_precision.items()):
            family.add_metric([f"programs_{precision}"], count)
        yield family


class StoreResidencyCollector:
    """``gordo_store_revision_bytes``: each resident revision's byte
    estimates (``FleetModelStore.revision_stats``) over the live apps'
    stores, a revision two stores hold counted in both. ``revision`` is
    bounded by ``N_CACHED_REVISIONS`` a store, ``kind`` a constant."""

    def collect(self):
        revisions: Dict[str, Dict[str, int]] = {}
        for app in _live_apps():
            for revision, stats in app.store.revision_stats().items():
                merged = revisions.setdefault(revision, {"model_bytes": 0, "stacked_bytes": 0, "cast_bytes": 0})
                for key in merged:
                    merged[key] += int(stats.get(key, 0))
        family = GaugeMetricFamily(
            "gordo_store_revision_bytes",
            "Estimated resident bytes per cached serving revision "
            "(kind=model per-member params, kind=stacked fused f32 "
            "buckets, kind=cast reduced-precision copies)",
            labels=["revision", "kind"],
        )
        for revision, stats in sorted(revisions.items()):
            family.add_metric([revision, "model"], stats["model_bytes"])
            family.add_metric([revision, "stacked"], stats["stacked_bytes"])
            family.add_metric([revision, "cast"], stats["cast_bytes"])
        yield family


#: registries already carrying the program-cache collectors
_program_cache_registries: "weakref.WeakSet" = weakref.WeakSet()


def register_program_cache_collector(registry: CollectorRegistry) -> None:
    """Attach the program-cache and residency collectors to ``registry``, once."""
    if registry in _program_cache_registries:
        return
    _program_cache_registries.add(registry)
    registry.register(ProgramCacheCollector())
    registry.register(StoreResidencyCollector())


def _histogram_buckets(edges, counts, total) -> List[Tuple[str, int]]:
    """Cumulative ``(le, count)`` pairs of a fixed-bucket histogram, ``+Inf`` last."""
    cumulative, buckets = 0, []
    for edge, count in zip(edges, counts):
        cumulative += int(count)
        buckets.append((str(edge), cumulative))
    buckets.append(("+Inf", int(total)))
    return buckets


class FleetHealthCollector:
    """Bounded aggregates of every live health ledger: machines by state
    and the score histogram over ``SCORE_BUCKETS`` (per-machine detail
    stays in ``fleet_health.json``)."""

    def collect(self):
        from ...telemetry.fleet_health import SCORE_BUCKETS, ledger_summaries

        states = GaugeMetricFamily(
            "gordo_fleet_health_machines",
            "Fleet members by health state (quarantined > degraded > "
            "drifting > healthy; per-machine detail lives in "
            "fleet_health.json, not in labels)",
            labels=["state"],
        )
        scores = GaugeHistogramMetricFamily(
            "gordo_fleet_health_score",
            "Distribution of per-member health scores in [0, 1] "
            "(1.0 = healthy; see telemetry.fleet_health.health_score)",
            labels=[],
        )
        totals = {"healthy": 0, "degraded": 0, "drifting": 0, "quarantined": 0}
        bins = [0] * len(SCORE_BUCKETS)
        machines = 0
        score_sum = 0.0
        for summary in ledger_summaries().values():
            if not summary:
                continue
            machines += summary.get("machines", 0)
            for state in totals:
                totals[state] += int(summary.get(state, 0))
            histogram = summary.get("score_histogram") or {}
            for i, count in enumerate((histogram.get("counts") or [])[: len(bins)]):
                bins[i] += int(count)
            score_sum += float(histogram.get("score_sum") or 0.0)
        for state, count in totals.items():
            states.add_metric([state], count)
        # gsum is the sum of scores (mean health = gsum / gcount)
        scores.add_metric([], buckets=_histogram_buckets(SCORE_BUCKETS, bins, machines), gsum_value=score_sum)
        yield states
        yield scores


class DeviceUtilizationCollector:
    """The card's memory (``telemetry.device.memory_snapshot``: the caching
    allocator's counters, absent on the CPU) and the compile counters of
    ``program_span`` (``side="build"``; the port's serving programs are a
    prebuilt kernel, counted nowhere)."""

    def collect(self):
        from ...telemetry import device as device_telemetry

        memory_family = GaugeMetricFamily(
            "gordo_device_memory_bytes",
            "Device memory summed over local devices "
            "(Device.memory_stats; absent when the backend reports none)",
            labels=["kind"],
        )
        memory = device_telemetry.memory_snapshot()
        if memory and memory.get("available"):
            for kind in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if kind in memory:
                    memory_family.add_metric([kind], memory[kind])
            yield memory_family
        programs = CounterMetricFamily(
            "gordo_compile_cache_events",
            "jit-program executions by compile-cache outcome: "
            "result=compile is a cache miss that paid XLA, result=hit a "
            "steady-state run (side=build for fleet training programs, "
            "side=serve for the fused serving programs)",
            labels=["side", "result"],
        )
        for side, counters in sorted(device_telemetry.program_cache_counters().items()):
            programs.add_metric([side, "compile"], counters.get("compiles", 0))
            programs.add_metric([side, "hit"], counters.get("cache_hits", 0))
        yield programs


#: the alert state machine as a number (``resolved`` closes, it does not page)
_SLO_ALERT_STATE_VALUES = {
    "inactive": 0,
    "resolved": 0,
    "pending": 1,
    "firing": 2,
}


class SloCollector:
    """Error budget remaining, burn rates and the worst alert state of
    each SLO in the process's statuses (``telemetry.slo.scrape_statuses``,
    watched directories evaluated again at most once per
    ``GORDO_TPU_SLO_SCRAPE_REFRESH``)."""

    def collect(self):
        from ...telemetry import slo as slo_engine

        budget = GaugeMetricFamily(
            "gordo_slo_error_budget_remaining_ratio",
            "Fraction of the SLO window's error budget still unspent "
            "(1.0 = clean, 0.0 = the objective is blown)",
            labels=["slo"],
        )
        burn = GaugeMetricFamily(
            "gordo_slo_burn_rate",
            "Error-budget burn rate over the alert windows (1.0 = "
            "spending exactly one budget per SLO window)",
            labels=["slo", "window"],
        )
        state = GaugeMetricFamily(
            "gordo_slo_alert_state",
            "Worst burn-rate alert state per SLO "
            "(0 = inactive/resolved, 1 = pending, 2 = firing)",
            labels=["slo"],
        )
        for doc in slo_engine.scrape_statuses().values():
            for slo in doc.get("slos") or []:
                name = str(slo.get("name"))
                budget.add_metric([name], float((slo.get("budget") or {}).get("remaining_ratio", 1.0)))
                for window, rate in (slo.get("burn_rates") or {}).items():
                    burn.add_metric([name, str(window)], float(rate))
            worst: Dict[str, int] = {}
            for alert in doc.get("alerts") or []:
                name = str(alert.get("slo"))
                worst[name] = max(worst.get(name, 0), _SLO_ALERT_STATE_VALUES.get(str(alert.get("state")), 0))
            for name, value in worst.items():
                state.add_metric([name], value)
        yield budget
        yield burn
        yield state


def _stream_state() -> Tuple[Dict[str, int], Dict[str, Any]]:
    """The live apps' stream planes as one: session counts and the
    telemetry snapshots summed."""
    from ...telemetry.aggregate import LATENCY_BUCKETS_MS

    counts = {"active": 0, "tombstoned": 0, "subscribers": 0, "pending": 0, "quarantined": 0, "outbox": 0,
              "emit": 0}
    telemetry: Dict[str, Any] = {"rows_in": 0, "rows_scored": 0, "rows_failed": 0, "rows_shed": 0, "flushes": 0}
    for key in ("flush_ms", "lag_ms"):
        telemetry[key] = {"buckets_ms": list(LATENCY_BUCKETS_MS), "counts": [0] * (len(LATENCY_BUCKETS_MS) + 1),
                          "count": 0, "sum_ms": 0.0}
    for app in _live_apps():
        plane = app.plane
        if plane is None:
            continue
        stats = plane.stats()
        for session in (stats.get("sessions") or {}).values():
            counts["tombstoned" if session.get("closed") else "active"] += 1
            counts["subscribers"] += int(session.get("subscribers") or 0)
            counts["outbox"] += int(session.get("events_dropped_outbox") or 0)
            counts["emit"] += int(session.get("events_dropped_emit") or 0)
            for machine in (session.get("machines") or {}).values():
                counts["pending"] += int(machine.get("rows_pending") or 0)
                if machine.get("quarantined"):
                    counts["quarantined"] += 1
        snapshot = stats["telemetry"]
        for key in ("rows_in", "rows_scored", "rows_failed", "rows_shed", "flushes"):
            telemetry[key] += int(snapshot[key])
        for key in ("flush_ms", "lag_ms"):
            total, part = telemetry[key], snapshot[key]
            total["counts"] = [a + int(b) for a, b in zip(total["counts"], part["counts"])]
            total["count"] += int(part["count"])
            total["sum_ms"] += float(part["sum_ms"])
    return counts, telemetry


class StreamPlaneCollector:
    """The streaming plane's sessions, subscribers, pending rows,
    quarantined machines, row accounting, dropped events and flushes, and
    its flush-duration and score-lag histograms, over the live apps'
    planes. Bounded labels only: per-stream detail is on
    ``/stream/status``."""

    def collect(self):
        sessions = GaugeMetricFamily(
            "gordo_stream_sessions",
            "Stream sessions by state (tombstoned = closed but retained "
            "for late cursors until the TTL)",
            labels=["state"],
        )
        subscribers = GaugeMetricFamily(
            "gordo_stream_subscribers",
            "Open SSE subscriptions across all stream sessions",
            labels=[],
        )
        pending = GaugeMetricFamily(
            "gordo_stream_pending_rows",
            "Rows buffered in the ingest rings awaiting the watermark, "
            "summed over sessions and machines",
            labels=[],
        )
        quarantined = GaugeMetricFamily(
            "gordo_stream_quarantined_machines",
            "Stream machines currently held by an open circuit breaker "
            "(their rows buffer instead of scoring)",
            labels=[],
        )
        rows = CounterMetricFamily(
            "gordo_stream_rows",
            "Streaming-plane row accounting by outcome (in/scored/"
            "failed/shed); in == scored + failed + pending + shed is "
            "the plane's zero-gap invariant",
            labels=["outcome"],
        )
        events_dropped = CounterMetricFamily(
            "gordo_stream_events_dropped",
            "Emitted events dropped by scope (outbox = slow-consumer "
            "ring eviction, emit = the emit fault site)",
            labels=["scope"],
        )
        flushes = CounterMetricFamily(
            "gordo_stream_flushes",
            "Watermark scoring flushes run by this process",
            labels=[],
        )
        flush_hist = GaugeHistogramMetricFamily(
            "gordo_stream_flush_duration_ms",
            "Wall milliseconds per watermark flush (cut + fused scoring "
            "+ event fan-out), fixed buckets",
            labels=[],
        )
        lag_hist = GaugeHistogramMetricFamily(
            "gordo_stream_score_lag_ms",
            "Ingest→scored lag in milliseconds, row-weighted (each "
            "flush contributes its scored rows at the span's oldest-row "
            "lag) — the freshness SLO's native distribution",
            labels=[],
        )
        counts, telemetry = _stream_state()
        sessions.add_metric(["active"], counts["active"])
        sessions.add_metric(["tombstoned"], counts["tombstoned"])
        subscribers.add_metric([], counts["subscribers"])
        pending.add_metric([], counts["pending"])
        quarantined.add_metric([], counts["quarantined"])
        for scope in ("outbox", "emit"):
            events_dropped.add_metric([scope], counts[scope])
        rows.add_metric(["in"], telemetry["rows_in"])
        rows.add_metric(["scored"], telemetry["rows_scored"])
        rows.add_metric(["failed"], telemetry["rows_failed"])
        rows.add_metric(["shed"], telemetry["rows_shed"])
        flushes.add_metric([], telemetry["flushes"])
        for family, histogram in ((flush_hist, telemetry["flush_ms"]), (lag_hist, telemetry["lag_ms"])):
            family.add_metric([], buckets=_histogram_buckets(histogram["buckets_ms"], histogram["counts"],
                                                             histogram["count"]),
                              gsum_value=float(histogram["sum_ms"]))
        yield sessions
        yield subscribers
        yield pending
        yield quarantined
        yield rows
        yield events_dropped
        yield flushes
        yield flush_hist
        yield lag_hist


#: registries already carrying the fleet-console collectors
_fleet_console_registries: "weakref.WeakSet" = weakref.WeakSet()


def register_fleet_console_collectors(registry: CollectorRegistry) -> None:
    """Attach the fleet-health, device, SLO and stream-plane collectors to
    ``registry``, once."""
    if registry in _fleet_console_registries:
        return
    _fleet_console_registries.add(registry)
    registry.register(FleetHealthCollector())
    registry.register(DeviceUtilizationCollector())
    registry.register(SloCollector())
    registry.register(StreamPlaneCollector())


_serve_families: "weakref.WeakKeyDictionary[CollectorRegistry, dict]" = weakref.WeakKeyDictionary()


def _reset_after_fork() -> None:
    """A forked worker makes its metric objects anew (the process registry
    starts empty in it, ``registry.py``): the caches of the parent's are
    dropped, and the lock is rebound, never taken."""
    global _made_lock, _request_metrics, _build_metrics, _lifecycle_metrics, _serve_families
    global _program_cache_registries, _fleet_console_registries
    _made_lock = threading.RLock()
    _request_metrics, _build_metrics = weakref.WeakKeyDictionary(), weakref.WeakKeyDictionary()
    _lifecycle_metrics, _serve_families = weakref.WeakKeyDictionary(), weakref.WeakKeyDictionary()
    _program_cache_registries, _fleet_console_registries = weakref.WeakSet(), weakref.WeakSet()


register_postfork_reset(_reset_after_fork, name="server.prometheus.metrics.caches")


def _make_serve_families(registry: CollectorRegistry) -> Dict[str, Any]:
    labels = ["project"]
    families = {
        "queue_depth": Gauge(
            "gordo_server_batch_queue_depth",
            "Requests currently waiting in the micro-batch queue",
            labelnames=labels,
            registry=registry,
            multiprocess_mode="max",
        ),
        "batch_size": Histogram(
            "gordo_server_batch_size",
            "Requests coalesced into each fused device program",
            labelnames=labels,
            buckets=_BATCH_SIZE_BUCKETS,
            registry=registry,
        ),
        "coalesce_ratio": Histogram(
            "gordo_server_batch_coalesce_ratio",
            "Program occupancy: coalesced requests / padded member slots "
            "of the fused program (1.0 = a perfectly full batch)",
            labelnames=labels,
            buckets=_RATIO_BUCKETS,
            registry=registry,
        ),
        "padding_waste": Histogram(
            "gordo_server_batch_padding_waste",
            "Fraction of the fused program's padded (member x row) cells "
            "holding no request data",
            labelnames=labels,
            buckets=_RATIO_BUCKETS,
            registry=registry,
        ),
        "shed": Counter(
            "gordo_server_batch_shed_total",
            "Requests shed by serving admission control, by reason "
            "(queue_full -> 429, deadline -> 504, cancelled = waiter "
            "gave up before its batch ran, runner_error = the batcher's "
            "backstop resolved a crashed batch)",
            labelnames=labels + ["reason"],
            registry=registry,
        ),
        # state is the breaker vocabulary (open, half_open, closed)
        "breaker_transitions": Counter(
            "gordo_server_breaker_transitions_total",
            "Per-member serving circuit-breaker state transitions, by "
            "the state ENTERED (open = tripped into quarantine, "
            "half_open = probing, closed = recovered)",
            labelnames=labels + ["state"],
            registry=registry,
        ),
        "breaker_open": Gauge(
            "gordo_server_breaker_open_members",
            "Members currently quarantined by an open serving circuit "
            "breaker (answering 503 + Retry-After instead of riding "
            "batches)",
            labelnames=labels,
            registry=registry,
            multiprocess_mode="max",
        ),
    }
    register_program_cache_collector(registry)
    register_fleet_console_collectors(registry)
    return families


class ServeMetrics:
    """The serving engine's metric sink (``ServeEngine.metrics``): queue
    depth, batch size, coalesce ratio and padding waste, sheds, breaker
    transitions and open members. The port launches the coalesced members
    alone, so the coalesce ratio and padding waste read against the
    power-of-two member rung the JAX engine would pad to, as the
    ``serve_batch`` span's ``padded_members``. Safe from dispatcher
    threads."""

    def __init__(self, project: Optional[str] = None, registry: Optional[CollectorRegistry] = None):
        self.project = project or ""
        self.registry = registry if registry is not None else REGISTRY
        families = _once_per_registry(_serve_families, self.registry, _make_serve_families)
        self.queue_depth = families["queue_depth"]
        self.batch_size = families["batch_size"]
        self.coalesce_ratio = families["coalesce_ratio"]
        self.padding_waste = families["padding_waste"]
        self.shed = families["shed"]
        self.breaker_transitions = families["breaker_transitions"]
        self.breaker_open = families["breaker_open"]

    def observe_batch(self, size: int, occupancy: float, padding_waste: float) -> None:
        self.batch_size.labels(project=self.project).observe(size)
        self.coalesce_ratio.labels(project=self.project).observe(occupancy)
        self.padding_waste.labels(project=self.project).observe(padding_waste)

    def observe_shed(self, reason: str, n: int = 1) -> None:
        self.shed.labels(project=self.project, reason=reason).inc(n)

    def observe_breaker(self, state: str) -> None:
        self.breaker_transitions.labels(project=self.project, state=state).inc()

    def set_breaker_open(self, count: int) -> None:
        self.breaker_open.labels(project=self.project).set(count)

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth.labels(project=self.project).set(depth)
