"""
The SLO engine (``gordo_tpu/telemetry/slo.py``): objectives declared in a
``slos.toml``, evaluated over the rollups (``aggregate.py``), with
multi-window burn-rate alerts kept as a persisted state machine.

- The objectives: ``availability`` and ``latency`` over the requests,
  ``stream_freshness`` and ``stream_integrity`` over the streaming
  plane's rows, each with a target and a window. The file is
  ``GORDO_TPU_SLO_CONFIG``, else ``slos.toml`` beside the telemetry
  sinks, else the packaged one. A malformed file raises ``ValueError``.
- :func:`evaluate` folds the new spans, merges the windows each rule
  needs, computes each objective's budget and burn rates, and steps each
  alert (an objective times a rule, ``fast`` pages and ``slow`` tickets):
  an alert is exceeded only when its long window and its short
  confirmation window (long / ``confirmation_divisor``) both burn above
  the threshold. ``pending -> firing -> resolved`` is journaled
  atomically to ``slo_state.json`` beside the sinks.
- The document it returns is what ``slo status --as-json`` prints and
  ``GET /gordo/v0/<project>/slo`` answers; :func:`evaluate_cached`
  re-serves a status younger than ``GORDO_TPU_SLO_SCRAPE_REFRESH``
  seconds (default 60), so a poller does not step the state machine;
  :func:`slo_section` is the fleet-status document's part;
  :func:`firing_alerts` is what a lifecycle supervisor reads.

Stdlib only. ``slos.toml`` is read with ``tomllib`` where Python has it,
else with the TOML subset reader here, as the JAX package does, so both
packages accept and refuse the same files.
"""

import ast
import logging
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils.env import env_float, env_str
from .aggregate import (RollupStore, histogram_percentile, parse_span_time, read_json, store_for, summarize_rollup,
                        write_json)
from .recorder import TRACE_DIR_ENV, _iso, enabled

try:  # Python >= 3.11
    import tomllib
except ImportError:  # pragma: no cover - Python 3.10
    tomllib = None

logger = logging.getLogger(__name__)

SLO_STATE_FILE = "slo_state.json"
SLO_CONFIG_FILE = "slos.toml"
SLO_CONFIG_ENV = "GORDO_TPU_SLO_CONFIG"
#: seconds a cached status is served before a watched directory or the
#: route evaluates again (0: every call evaluates)
SCRAPE_REFRESH_ENV = "GORDO_TPU_SLO_SCRAPE_REFRESH"
DEFAULT_SCRAPE_REFRESH = 60.0
DEFAULT_SLOS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), SLO_CONFIG_FILE)
OBJECTIVES = ("availability", "latency", "stream_freshness", "stream_integrity")
#: alert states in escalation order
ALERT_STATES = ("inactive", "pending", "firing", "resolved")

_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([smhdw])\s*$")
_DURATION_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0, "w": 604800.0}


def parse_duration(value: Any) -> float:
    """``"30d"``, ``"1h"``, ``"90m"`` or a number of seconds, in seconds;
    ``ValueError`` on anything else.

    >>> parse_duration("90m"), parse_duration(5)
    (5400.0, 5.0)
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    match = _DURATION_RE.match(str(value))
    if not match:
        raise ValueError(f"unparseable duration: {value!r}")
    return float(match.group(1)) * _DURATION_UNITS[match.group(2)]


# -- config -------------------------------------------------------------------


@dataclass(frozen=True)
class SloSpec:
    """One declared objective."""

    name: str
    objective: str
    target: float
    window: str  # as declared ("30d")
    window_s: float
    threshold_ms: Optional[float] = None
    description: str = ""

    @property
    def budget(self) -> float:
        """The bad fraction the target tolerates."""
        return max(1e-9, 1.0 - self.target)


@dataclass(frozen=True)
class BurnRule:
    """One burn-rate rule: ``fast`` or ``slow``."""

    name: str
    severity: str  # "page" | "ticket"
    window: str  # as declared ("1h")
    window_s: float
    threshold: float
    confirmation_s: float


@dataclass
class SloConfig:
    slos: List[SloSpec] = field(default_factory=list)
    rules: List[BurnRule] = field(default_factory=list)
    source: str = DEFAULT_SLOS_PATH


def _parse_toml_subset(text: str) -> Dict:
    """The TOML ``slos.toml`` needs, where ``tomllib`` is missing:
    ``[table]`` and ``[[array]]`` headers, ``key = value`` lines of
    strings, numbers and booleans."""
    doc: Dict = {}
    current: Dict = doc
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        array_header = re.fullmatch(r"\[\[([\w.\-]+)\]\]", line)
        table_header = re.fullmatch(r"\[([\w.\-]+)\]", line)
        if array_header or table_header:
            parts = (array_header or table_header).group(1).split(".")
            node = doc
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            if array_header:
                current = {}
                node.setdefault(parts[-1], []).append(current)
            else:
                current = node.setdefault(parts[-1], {})
            continue
        match = re.match(r"([\w\-]+)\s*=\s*(.*)$", line)
        if not match:
            raise ValueError(f"slos.toml subset parser: bad line {line!r}")
        key, value = match.group(1), match.group(2).strip()
        if not value.startswith(("'", '"')):
            value = value.split("#", 1)[0].strip()
        if value in ("true", "false"):
            current[key] = value == "true"
            continue
        try:
            current[key] = ast.literal_eval(value)
        except (SyntaxError, ValueError) as exc:
            raise ValueError(f"slos.toml: bad value for {key!r}: {value!r} ({exc})") from exc
    return doc


def _read_toml(path: str) -> Dict:
    if tomllib is not None:
        with open(path, "rb") as handle:
            return tomllib.load(handle)
    with open(path, encoding="utf-8") as handle:
        return _parse_toml_subset(handle.read())


def resolve_config_path(directory: Optional[str] = None) -> str:
    """``GORDO_TPU_SLO_CONFIG``, else ``slos.toml`` in ``directory``, else
    the packaged file."""
    override = env_str(SLO_CONFIG_ENV, None)
    if override:
        return override
    if directory:
        local = os.path.join(directory, SLO_CONFIG_FILE)
        if os.path.exists(local):
            return local
    return DEFAULT_SLOS_PATH


def load_slo_config(directory: Optional[str] = None, path: Optional[str] = None) -> SloConfig:
    """The objectives and burn rules of ``path`` (default: resolved from
    ``directory``); ``ValueError`` on a malformed objective."""
    source = path or resolve_config_path(directory)
    doc = _read_toml(source)
    slos: List[SloSpec] = []
    for entry in doc.get("slo") or []:
        name = str(entry.get("name") or "").strip()
        objective = str(entry.get("objective") or "").strip()
        if not name or objective not in OBJECTIVES:
            raise ValueError(f"slos.toml: every [[slo]] needs a name and an objective of "
                             f"availability|latency|stream_freshness|stream_integrity (got {entry!r})")
        target = float(entry.get("target", 0.0))
        if not 0.0 < target < 1.0:
            raise ValueError(f"slos.toml: {name}: target must be in (0, 1), got {target}")
        threshold_ms = entry.get("threshold_ms")
        if objective in ("latency", "stream_freshness") and threshold_ms is None:
            raise ValueError(f"slos.toml: {name}: {objective} objectives need threshold_ms")
        window = str(entry.get("window", "30d"))
        slos.append(SloSpec(name=name, objective=objective, target=target, window=window,
                            window_s=parse_duration(window),
                            threshold_ms=float(threshold_ms) if threshold_ms is not None else None,
                            description=str(entry.get("description", ""))))
    if len({slo.name for slo in slos}) != len(slos):
        raise ValueError("slos.toml: duplicate SLO names")
    burn = doc.get("burn") or {}
    divisor = max(1.0, float(burn.get("confirmation_divisor", 12)))
    rules: List[BurnRule] = []
    for rule_name, default_window, default_threshold, default_severity in (("fast", "1h", 14.4, "page"),
                                                                          ("slow", "6h", 6.0, "ticket")):
        window = str(burn.get(f"{rule_name}_window", default_window))
        window_s = parse_duration(window)
        rules.append(BurnRule(name=rule_name, severity=str(burn.get(f"{rule_name}_severity", default_severity)),
                              window=window, window_s=window_s,
                              threshold=float(burn.get(f"{rule_name}_threshold", default_threshold)),
                              confirmation_s=window_s / divisor))
    return SloConfig(slos=slos, rules=rules, source=source)


# -- the math -----------------------------------------------------------------


def histogram_fraction_over(histogram: Dict[str, Any], threshold_ms: float) -> float:
    """The fraction of observations above ``threshold_ms``, interpolated
    inside the bucket that holds it.

    >>> histogram_fraction_over({"count": 4, "buckets_ms": [10.0, 20.0], "counts": [2, 2, 0]}, 15.0)
    0.25
    """
    total = histogram.get("count", 0)
    if not total:
        return 0.0
    edges = histogram.get("buckets_ms") or []
    over = 0.0
    lower = 0.0
    for i, count in enumerate(histogram.get("counts") or []):
        upper = edges[i] if i < len(edges) else float("inf")
        if lower >= threshold_ms:
            over += count
        elif upper > threshold_ms and count:
            if upper == float("inf"):
                over += count
            else:
                over += count * max(0.0, min(1.0, (upper - threshold_ms) / (upper - lower)))
        lower = upper if upper != float("inf") else lower
    return min(1.0, over / total)


def bad_fraction(spec: SloSpec, rollup: Dict[str, Any]) -> Tuple[float, int]:
    """``(bad fraction, events)`` of ``spec`` over a merged rollup:
    errors or slow requests of all requests; stream rows above the lag
    threshold (freshness), or shed and failed of all ingested (integrity).
    No traffic is ``(0.0, 0)``: silence burns no budget."""
    if spec.objective == "stream_freshness":
        lag = (rollup.get("stream") or {}).get("lag_ms") or {}
        total = int(lag.get("count", 0))
        return (histogram_fraction_over(lag, float(spec.threshold_ms)), total) if total else (0.0, 0)
    if spec.objective == "stream_integrity":
        stream = rollup.get("stream") or {}
        rows_in = int(stream.get("rows_in", 0))
        if not rows_in:
            return 0.0, 0
        return min(1.0, (int(stream.get("rows_shed", 0)) + int(stream.get("rows_failed", 0))) / rows_in), rows_in
    requests = rollup.get("requests") or {}
    total = int(requests.get("count", 0))
    if not total:
        return 0.0, 0
    if spec.objective == "availability":
        return int(requests.get("errors", 0)) / total, total
    return histogram_fraction_over(rollup.get("latency_ms") or {}, float(spec.threshold_ms)), total


def burn_rate(spec: SloSpec, fraction: float) -> float:
    """Error budgets a window spent at this pace: 1.0 is on budget."""
    return round(fraction / spec.budget, 4)


# -- the alert state machine --------------------------------------------------


def advance_alert_state(previous: Optional[str], exceeded: bool) -> str:
    """One step: exceeded, ``inactive``/``resolved`` become ``pending`` and
    ``pending``/``firing`` become ``firing``; calm, ``firing`` becomes
    ``resolved`` and everything else ``inactive``.

    >>> [advance_alert_state(s, True) for s in ALERT_STATES]
    ['pending', 'firing', 'firing', 'pending']
    >>> [advance_alert_state(s, False) for s in ALERT_STATES]
    ['inactive', 'inactive', 'resolved', 'inactive']
    """
    if exceeded:
        return "firing" if previous in ("pending", "firing") else "pending"
    return "resolved" if previous == "firing" else "inactive"


def _load_state(path: str) -> Dict[str, Any]:
    doc = read_json(path)
    if not isinstance(doc, dict) or not isinstance(doc.get("alerts"), dict):
        return {"version": 1, "alerts": {}}
    return doc


def state_path(directory: str) -> str:
    return os.path.join(os.path.normpath(directory), SLO_STATE_FILE)


def load_alert_states(directory: str) -> Dict[str, Dict[str, Any]]:
    """The persisted alert records of ``directory`` (empty when it was
    never evaluated)."""
    return dict(_load_state(state_path(directory)).get("alerts") or {})


#: a persisted ``firing`` record older than this no longer holds the
#: lifecycle's promotions: a stopped evaluator resolves nothing
STALE_ALERT_HOLD_S = 2 * 3600.0


def firing_alerts(directory: str, severity: Optional[str] = None,
                  max_age_s: Optional[float] = None) -> List[Dict[str, Any]]:
    """The persisted alerts that are ``firing`` (of ``severity``), without
    evaluating. With ``max_age_s``, a state last evaluated longer ago is
    silence: a stopped evaluator resolves nothing."""
    alerts = load_alert_states(directory)
    if max_age_s is not None and alerts:
        state = _load_state(state_path(directory))
        updated = parse_span_time(state.get("updated_at"))
        if updated is not None and time.time() - updated > max_age_s:
            if any(a.get("state") == "firing" for a in alerts.values()):
                logger.warning("slo state in %s last evaluated %s — too stale to hold promotions; run "
                               "`slo status` (or keep the server scraping) to refresh it", directory,
                               state.get("updated_at"))
            return []
    return [{"id": alert_id, **record} for alert_id, record in sorted(alerts.items())
            if record.get("state") == "firing" and (severity is None or record.get("severity") == severity)]


# -- evaluation ---------------------------------------------------------------


def slo_directory(anchor: Optional[str] = None) -> Optional[str]:
    """Where the serving telemetry, the rollups and the SLO state live:
    ``GORDO_TPU_TELEMETRY_DIR`` when set, else ``anchor``."""
    return env_str(TRACE_DIR_ENV, None) or anchor


#: one lock a directory: an evaluation reads, steps and writes ``slo_state.json``
_eval_locks_guard = threading.Lock()
_eval_locks: Dict[str, threading.Lock] = {}


def _eval_lock(directory: str) -> threading.Lock:
    with _eval_locks_guard:
        return _eval_locks.setdefault(directory, threading.Lock())


def evaluate(directory: str, config: Optional[SloConfig] = None, now: Optional[float] = None) -> Dict[str, Any]:
    """One evaluation of ``directory`` at ``now`` (default: the clock):
    fold the new spans, compute each objective's budget and burn rates,
    step and persist the alerts, and return the status document."""
    directory = os.path.normpath(directory)
    config = config or load_slo_config(directory)
    with _eval_lock(directory):
        return _evaluate_locked(directory, config, now, store_for(directory))


def _evaluate_locked(directory: str, config: SloConfig, now: Optional[float], store: RollupStore) -> Dict[str, Any]:
    aggregation = store.aggregate()
    now = time.time() if now is None else float(now)
    state_file = state_path(directory)
    state = _load_state(state_file)
    alerts_state: Dict[str, Any] = state.get("alerts") or {}
    slos_doc: List[Dict[str, Any]] = []
    alerts_doc: List[Dict[str, Any]] = []
    merged_cache: Dict[float, Dict[str, Any]] = {}  # the rules of every objective share the merges

    def merged(seconds: float) -> Dict[str, Any]:
        if seconds not in merged_cache:
            merged_cache[seconds] = store.merged(since=now - seconds, until=now)
        return merged_cache[seconds]

    for spec in config.slos:
        window_rollup = merged(spec.window_s)
        fraction, total = bad_fraction(spec, window_rollup)
        consumed = min(1.0, fraction / spec.budget)
        burn_rates: Dict[str, float] = {}
        for rule in config.rules:
            long_burn = burn_rate(spec, bad_fraction(spec, merged(rule.window_s))[0])
            short_burn = burn_rate(spec, bad_fraction(spec, merged(rule.confirmation_s))[0])
            burn_rates[rule.window] = long_burn
            alert_id = f"{spec.name}:{rule.name}"
            previous = alerts_state.get(alert_id) or {}
            previous_state = previous.get("state")
            next_state = advance_alert_state(previous_state,
                                             long_burn > rule.threshold and short_burn > rule.threshold)
            unchanged = next_state == previous_state
            record = {
                "slo": spec.name,
                "rule": rule.name,
                "severity": rule.severity,
                "state": next_state,
                "since": previous.get("since") if unchanged else _iso(now),
                "last_transition": previous.get("last_transition") if unchanged else _iso(now),
                "burn_rate": long_burn,
                "confirmation_burn_rate": short_burn,
                "threshold": rule.threshold,
                "window": rule.window,
                "confirmation_s": rule.confirmation_s,
            }
            alerts_state[alert_id] = record
            alerts_doc.append({"id": alert_id, **record})
        entry = {
            "name": spec.name,
            "objective": spec.objective,
            "description": spec.description,
            "target": spec.target,
            "window": spec.window,
            "threshold_ms": spec.threshold_ms,
            "requests": total,
            "bad_fraction": round(fraction, 6),
            "budget": {"total_ratio": round(spec.budget, 6), "consumed_ratio": round(consumed, 6),
                       "remaining_ratio": round(1.0 - consumed, 6)},
            "burn_rates": burn_rates,
        }
        if spec.objective == "latency":
            entry["latency_p95_ms"] = histogram_percentile(window_rollup.get("latency_ms") or {}, 0.95)
        elif spec.objective == "stream_freshness":
            entry["lag_p95_ms"] = histogram_percentile((window_rollup.get("stream") or {}).get("lag_ms") or {}, 0.95)
        slos_doc.append(entry)

    # the alerts of objectives no longer declared are dropped
    declared = {f"{s.name}:{r.name}" for s in config.slos for r in config.rules}
    state.update({"version": 1, "alerts": {k: v for k, v in alerts_state.items() if k in declared},
                  "updated_at": _iso(now), "config_source": config.source})
    try:
        os.makedirs(directory, exist_ok=True)
        write_json(state_file, state)
    except OSError as exc:
        logger.warning("slo state not persisted: %r", exc)

    firing = sum(1 for a in alerts_doc if a["state"] == "firing")
    pending = sum(1 for a in alerts_doc if a["state"] == "pending")
    doc = {
        "version": 1,
        "directory": directory,
        "generated_at": _iso(now),
        "config": {"source": config.source,
                   "rules": [{"name": rule.name, "severity": rule.severity, "window": rule.window,
                              "threshold": rule.threshold, "confirmation_s": rule.confirmation_s}
                             for rule in config.rules]},
        "slos": slos_doc,
        "alerts": alerts_doc,
        "firing": firing,
        "pending": pending,
        "ok": firing == 0,
        "recent": summarize_rollup(merged(3600.0)),
        "aggregation": aggregation,
    }
    note_status(directory, doc, now=now)
    return doc


#: the package-level name (``telemetry.evaluate_slos``)
evaluate_slos = evaluate


def evaluate_cached(directory: str, config: Optional[SloConfig] = None,
                    max_age_s: Optional[float] = None) -> Dict[str, Any]:
    """:func:`evaluate`, unless this process holds a status of
    ``directory`` younger than ``max_age_s`` (default
    :func:`scrape_refresh_seconds`): the route and the scrape-time refresh
    go through here, so a poller neither writes nor steps alerts faster."""
    directory = os.path.normpath(directory)
    if max_age_s is None:
        max_age_s = scrape_refresh_seconds()
    if max_age_s > 0:
        with _registry_lock:
            entry = _statuses.get(directory)
        if entry is not None and time.time() - entry[1] < max_age_s:
            return entry[0]
    return evaluate(directory, config=config)


# -- the process's statuses (what a scrape exports) ---------------------------

_registry_lock = threading.Lock()
#: directory -> (status document, evaluated at), written by every evaluate()
_statuses: Dict[str, Tuple[Dict[str, Any], float]] = {}
#: directories a server asked to keep fresh at scrape time
_watched: set = set()


def note_status(directory: str, doc: Dict[str, Any], now: Optional[float] = None) -> None:
    with _registry_lock:
        _statuses[os.path.normpath(directory)] = (doc, time.time() if now is None else float(now))


def watch(directory: Optional[str]) -> None:
    """Keep ``directory``'s status fresh at scrape time (a server's
    telemetry directory); nothing with telemetry off."""
    if directory and enabled():
        with _registry_lock:
            _watched.add(os.path.normpath(directory))


def reset_statuses() -> None:
    """Forget the statuses and watches (tests)."""
    with _registry_lock:
        _statuses.clear()
        _watched.clear()


def scrape_refresh_seconds() -> float:
    value = env_float(SCRAPE_REFRESH_ENV, DEFAULT_SCRAPE_REFRESH)
    return max(0.0, value if value is not None else DEFAULT_SCRAPE_REFRESH)


def scrape_statuses() -> Dict[str, Dict[str, Any]]:
    """directory -> latest status, the watched directories evaluated again
    when their status is older than ``GORDO_TPU_SLO_SCRAPE_REFRESH`` (0:
    the cached statuses only). A failed evaluation keeps the old status."""
    refresh = scrape_refresh_seconds()
    if refresh > 0:
        with _registry_lock:
            watched = sorted(_watched)
        for directory in watched:
            try:
                evaluate_cached(directory, max_age_s=refresh)
            except Exception:  # noqa: BLE001 - a scrape never fails on a broken sink
                logger.debug("scrape-time slo refresh failed", exc_info=True)
    with _registry_lock:
        return {directory: doc for directory, (doc, _) in _statuses.items()}


def slo_section(directory: str) -> Optional[Dict[str, Any]]:
    """The fleet-status document's ``slo`` section: the alerts and each
    objective's remaining budget of this process's last evaluation of
    ``directory``, else the persisted alerts alone (``budgets`` None);
    None when neither exists."""
    directory = os.path.normpath(directory)
    with _registry_lock:
        entry = _statuses.get(directory)
    if entry is not None:
        doc = entry[0]
        return {
            "firing": doc.get("firing", 0),
            "pending": doc.get("pending", 0),
            "ok": doc.get("ok", True),
            "alerts": doc.get("alerts"),
            "budgets": {slo["name"]: slo["budget"]["remaining_ratio"] for slo in doc.get("slos") or []},
            "evaluated_at": doc.get("generated_at"),
        }
    state = _load_state(state_path(directory))
    alerts = state.get("alerts") or {}
    if not alerts:
        return None
    firing = sum(1 for a in alerts.values() if a.get("state") == "firing")
    return {
        "firing": firing,
        "pending": sum(1 for a in alerts.values() if a.get("state") == "pending"),
        "ok": firing == 0,
        "alerts": [{"id": alert_id, **record} for alert_id, record in sorted(alerts.items())],
        "budgets": None,
        "evaluated_at": state.get("updated_at"),
    }


# -- rendering ----------------------------------------------------------------

_STATE_MARKS = {"inactive": "ok", "pending": "PENDING", "firing": "FIRING", "resolved": "resolved"}


def render_slo_status(doc: Dict[str, Any]) -> str:
    """The status document as ``slo status`` prints it."""
    lines: List[str] = [f"SLO status: {doc.get('directory', '-')}  (evaluated {doc.get('generated_at', '?')})"]
    for slo in doc.get("slos") or []:
        budget = slo.get("budget") or {}
        burn = ", ".join(f"{window}={rate:g}x" for window, rate in (slo.get("burn_rates") or {}).items())
        threshold = f" (<= {slo['threshold_ms']:g}ms)" if slo.get("threshold_ms") is not None else ""
        unit = "row(s)" if str(slo.get("objective", "")).startswith("stream") else "request(s)"
        lines.append(f"  {slo['name']}: {slo['objective']}{threshold} target {slo['target']:.4%} over "
                     f"{slo['window']} — budget remaining {budget.get('remaining_ratio', 0) * 100:.1f}% "
                     f"({slo.get('requests', 0)} {unit}, burn {burn or '-'})")
    lines.append(f"alerts: {doc.get('firing', 0)} firing, {doc.get('pending', 0)} pending")
    for alert in doc.get("alerts") or []:
        if alert.get("state") == "inactive":
            continue
        lines.append(f"  [{_STATE_MARKS.get(alert['state'], alert['state'])}] {alert['id']} ({alert['severity']}): "
                     f"burn {alert.get('burn_rate', 0):g}x over {alert['window']} (threshold "
                     f"{alert.get('threshold', 0):g}x, since {alert.get('since', '?')})")
    lines.append(f"result: {'inside SLO' if doc.get('ok') else 'BURNING — page is firing'}")
    return "\n".join(lines)
