"""
Analysis of the JSONL span traces (``gordo_tpu/telemetry/trace_analysis.py``),
the library of the ``trace`` command:

- each span name's latency distribution (count, p50/p95/p99, total);
- the request breakdown: each ``request`` span's stage spans, joined by
  ``(trace_id, parent_id)``, as per-stage percentiles and shares of the
  median request's walltime; the **attribution coverage** (the median of
  each request's staged share of its walltime: 0.9 is the bar, below it a
  request has host work no stage names); the median request's stages,
  longest first;
- each stream session's ``stream_ingest`` -> ``stream_score`` ->
  ``stream_emit`` path, lag and row accounting;
- predicted against measured device time of the spans that carry both;
- the heaviest self-time frames of the ``profile`` spans.

Worker variants and rotated generations of a sink are read as one
trace, spans deduplicated by ``(trace_id, span_id)`` as the rollups do.
Stdlib only.
"""

import json
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from .aggregate import generation_files, parse_span_time, sink_bases

#: names never counted as a request's stage; the stream spans are roots
#: with a breakdown of their own
_NON_STAGE_NAMES = ("request", "profile", "stream_ingest", "stream_score", "stream_emit")
_STREAM_STAGES = ("stream_ingest", "stream_score", "stream_emit")
#: the profile frames an analysis lists
MAX_PROFILE_FRAMES = 25


def trace_bases(directory: str, base_name: str) -> List[str]:
    """Every base path of one logical trace in ``directory``: the shared
    name and each ``-<pid>`` worker variant (:func:`~.aggregate.sink_bases`;
    each base's rotated generations ride with it)."""
    return sink_bases(directory, base_name)


def iter_trace_files(path: str, since_ts: Optional[float] = None,
                     window_index: Optional[Dict[str, Dict[str, Any]]] = None) -> List[str]:
    """The files of one sink with its rotated generations, oldest first.
    With ``since_ts``, a rotated generation that holds nothing as new is
    skipped: by the manifest's span window (``window_index``) when it read
    the file to its end, else by its mtime (its last write). The live file
    always stays."""
    paths = generation_files(path)
    if since_ts is None:
        return paths
    kept = []
    for trace_path in paths:
        if trace_path != path:
            entry = (window_index or {}).get(os.path.basename(trace_path))
            if entry and entry.get("complete"):
                max_ts = entry.get("max_ts")
                if max_ts is None or float(max_ts) >= since_ts:
                    kept.append(trace_path)
                continue
            try:
                if os.path.getmtime(trace_path) < since_ts:
                    continue
            except OSError:
                continue
        kept.append(trace_path)
    return kept


def read_trace(path: str, since_ts: Optional[float] = None,
               window_index: Optional[Dict[str, Dict[str, Any]]] = None) -> Iterator[dict]:
    """The spans of a trace file, oldest first across its generations;
    lines that do not parse are skipped, and with ``since_ts`` the spans
    that ended before it."""
    for trace_path in iter_trace_files(path, since_ts, window_index=window_index):
        try:
            handle = open(trace_path)
        except OSError:
            continue  # rotated away since it was listed
        with handle:
            for line in handle:
                line = line.strip()
                if not line:
                    continue
                try:
                    span = json.loads(line)
                except ValueError:
                    continue
                if not (isinstance(span, dict) and "name" in span):
                    continue
                if since_ts is not None:
                    end_ts = parse_span_time(span.get("end_time"))
                    if end_ts is None or end_ts < since_ts:
                        continue
                yield span


def read_traces(paths: List[str], since_ts: Optional[float] = None,
                window_index: Optional[Dict[str, Dict[str, Any]]] = None) -> Iterator[dict]:
    """The spans of several sink bases (:func:`~.aggregate.sink_bases`),
    each ``(trace_id, span_id)`` once."""
    seen: set = set()
    for path in paths:
        for span in read_trace(path, since_ts=since_ts, window_index=window_index):
            context = span.get("context") or {}
            key = (context.get("trace_id", ""), context.get("span_id", ""))
            if key != ("", ""):
                if key in seen:
                    continue
                seen.add(key)
            yield span


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank percentile of sorted ``values``.

    >>> percentile([1.0, 2.0, 3.0, 4.0], 0.5), percentile([], 0.5)
    (3.0, 0.0)
    """
    if not values:
        return 0.0
    return values[max(0, min(len(values) - 1, int(round(q * (len(values) - 1)))))]


def _distribution(durations: List[float]) -> Dict[str, float]:
    durations = sorted(durations)
    return {"count": len(durations), "p50_ms": round(percentile(durations, 0.50), 3),
            "p95_ms": round(percentile(durations, 0.95), 3), "p99_ms": round(percentile(durations, 0.99), 3),
            "total_ms": round(sum(durations), 3)}


def _ms(span: dict) -> float:
    return float(span.get("duration_ms", 0.0))


def summarize_spans(spans: Iterable[dict]) -> Dict[str, Dict[str, float]]:
    """Each span name's duration distribution; events are skipped."""
    by_name: Dict[str, List[float]] = {}
    for span in spans:
        if span.get("kind") != "event":
            by_name.setdefault(span["name"], []).append(_ms(span))
    return {name: _distribution(durations) for name, durations in sorted(by_name.items())}


def request_breakdown(spans: Iterable[dict]) -> Optional[Dict[str, Any]]:
    """The ``request`` spans' stages: ``stages`` (each stage's
    distribution and ``share_of_p50``, its median over the median
    walltime), ``attribution_coverage`` and ``critical_path`` (the median
    request's stages, longest first). None without a request span."""
    requests: List[dict] = []
    children: Dict[Tuple[str, str], List[dict]] = {}
    for span in spans:
        if span.get("kind") == "event":
            continue
        if span["name"] == "request":
            requests.append(span)
        elif span["name"] not in _NON_STAGE_NAMES and span.get("parent_id"):
            trace_id = (span.get("context") or {}).get("trace_id", "")
            children.setdefault((trace_id, span["parent_id"]), []).append(span)
    if not requests:
        return None

    walltimes = sorted(_ms(r) for r in requests)
    p50_wall = percentile(walltimes, 0.50)
    stage_durations: Dict[str, List[float]] = {}
    # coverage a request (its stages over its walltime), then the median:
    # means over a median walltime overstate it under a skewed distribution
    coverage_ratios: List[float] = []
    for request in requests:
        context = request.get("context") or {}
        trace_id = context.get("trace_id", "")
        own = children.get((trace_id, context.get("span_id", "")), [])
        for stage in own:
            stage_durations.setdefault(stage["name"], []).append(_ms(stage))
            # one level down: spans inside a stage (the engine's queue_wait and
            # batch_* inside inference) are listed, but not counted in coverage
            for nested in children.get((trace_id, (stage.get("context") or {}).get("span_id", "")), []):
                stage_durations.setdefault(nested["name"], []).append(_ms(nested))
        wall = _ms(request)
        if wall > 0:
            coverage_ratios.append(min(1.0, sum(_ms(stage) for stage in own) / wall))
    coverage = percentile(sorted(coverage_ratios), 0.50)

    stages: Dict[str, Dict[str, float]] = {}
    for name, durations in sorted(stage_durations.items()):
        dist = _distribution(durations)
        dist["share_of_p50"] = round(dist["p50_ms"] / p50_wall if p50_wall > 0 else 0.0, 4)
        stages[name] = dist

    median_request = min(requests, key=lambda r: abs(_ms(r) - p50_wall))
    context = median_request.get("context") or {}
    own = children.get((context.get("trace_id", ""), context.get("span_id", "")), [])
    critical_path = [{"stage": stage["name"], "duration_ms": round(_ms(stage), 3)}
                     for stage in sorted(own, key=_ms, reverse=True)]
    return {
        "requests": len(requests),
        "walltime_p50_ms": round(p50_wall, 3),
        "walltime_p95_ms": round(percentile(walltimes, 0.95), 3),
        "walltime_p99_ms": round(percentile(walltimes, 0.99), 3),
        "stages": stages,
        "attribution_coverage": round(coverage, 4),
        "critical_path": critical_path,
    }


def stream_breakdown(spans: Iterable[dict]) -> Optional[Dict[str, Any]]:
    """Each stream session's stage distributions and median path, its lag
    (p50 of the flushes' ``lag_p50_ms``, max of their ``lag_max_ms``),
    device time against the cost model's, the row accounting, and
    ``linked_ingests`` (the score spans' links back to their ingests). None
    without a stream span."""
    by_stream: Dict[str, Dict[str, Any]] = {}
    for span in spans:
        name = span.get("name")
        if name not in _STREAM_STAGES:
            continue
        attributes = span.get("attributes") or {}
        entry = by_stream.setdefault(str(attributes.get("stream") or "-"), {
            "durations": {stage: [] for stage in _STREAM_STAGES}, "device_ms": [], "predicted_device_ms": [],
            "lag_p50_ms": [], "lag_max_ms": 0.0, "rows_in": 0, "rows_scored": 0, "rows_failed": 0, "rows_shed": 0,
            "windows": 0, "events": 0, "linked_ingests": 0})
        entry["durations"][name].append(_ms(span))
        if name == "stream_ingest":
            entry["rows_in"] += int(attributes.get("rows", 0) or 0)
        elif name == "stream_score":
            scored = attributes.get("rows_scored")
            if scored is None:
                scored = attributes.get("rows", 0)
            entry["rows_scored"] += int(scored or 0)
            entry["rows_failed"] += int(attributes.get("rows_failed", 0) or 0)
            entry["rows_shed"] += int(attributes.get("shed", 0) or 0)
            entry["windows"] += int(attributes.get("windows", 0) or 0)
            entry["linked_ingests"] += len(span.get("links") or [])
            if attributes.get("device_ms") is not None:
                entry["device_ms"].append(float(attributes["device_ms"]))
            predicted = attributes.get("predicted_device_ms")
            if predicted is not None and float(predicted) >= 0.0:
                entry["predicted_device_ms"].append(float(predicted))
            if attributes.get("lag_p50_ms") is not None:
                entry["lag_p50_ms"].append(float(attributes["lag_p50_ms"]))
            if attributes.get("lag_max_ms") is not None:
                entry["lag_max_ms"] = max(entry["lag_max_ms"], float(attributes["lag_max_ms"]))
        else:
            entry["events"] += int(attributes.get("events", 0) or 0)
    if not by_stream:
        return None

    streams: Dict[str, Dict[str, Any]] = {}
    for stream_id, entry in sorted(by_stream.items()):
        stages = {stage: _distribution(durations) for stage, durations in entry["durations"].items() if durations}
        predicted = sorted(entry["predicted_device_ms"])
        streams[stream_id] = {
            "stages": stages,
            "flushes": stages.get("stream_score", {}).get("count", 0),
            **{key: entry[key] for key in ("rows_in", "rows_scored", "rows_failed", "rows_shed", "windows", "events",
                                           "linked_ingests")},
            "lag_p50_ms": round(percentile(sorted(entry["lag_p50_ms"]), 0.50), 3),
            "lag_max_ms": round(entry["lag_max_ms"], 3),
            "device_p50_ms": round(percentile(sorted(entry["device_ms"]), 0.50), 3),
            "predicted_device_p50_ms": round(percentile(predicted, 0.50), 3) if predicted else None,
            # what one row pays from ingest to its event, in pipeline order
            "critical_path": [{"stage": stage, "p50_ms": stages[stage]["p50_ms"]}
                              for stage in _STREAM_STAGES if stage in stages],
        }
    return {"streams": streams,
            "totals": {key: sum(s[key] for s in streams.values())
                       for key in ("rows_in", "rows_scored", "rows_failed", "rows_shed", "flushes")}}


def prediction_accuracy(spans: Iterable[dict]) -> Optional[Dict[str, Dict[str, Any]]]:
    """Each program's predicted against measured device time, over the
    spans that carry a measured ``device_ms`` and a prediction (the ``-1``
    of no estimate left out): relative-error p50 and p95, and ``bias``, the
    median predicted/measured (above 1: over-predicted)."""
    by_key: Dict[str, Dict[str, list]] = {}
    for span in spans:
        attributes = span.get("attributes") or {}
        try:
            device = float(attributes.get("device_ms"))
            predicted = float(attributes.get("predicted_device_ms"))
        except (TypeError, ValueError):
            continue
        if device <= 0.0 or predicted < 0.0:
            continue
        entry = by_key.setdefault(str(attributes.get("program") or span["name"]), {"ratios": [], "errors": []})
        entry["ratios"].append(predicted / device)
        entry["errors"].append(abs(predicted - device) / device)
    if not by_key:
        return None
    out: Dict[str, Dict[str, Any]] = {}
    for key, entry in sorted(by_key.items()):
        errors = sorted(entry["errors"])
        out[key] = {"count": len(errors), "error_p50": round(percentile(errors, 0.50), 4),
                    "error_p95": round(percentile(errors, 0.95), 4),
                    "bias": round(percentile(sorted(entry["ratios"]), 0.50), 4)}
    return out


def top_profile_frames(spans: Iterable[dict]) -> List[Dict[str, Any]]:
    """Self time by (stage, function) over every ``profile`` span, the
    :data:`MAX_PROFILE_FRAMES` heaviest first."""
    totals: Dict[Tuple[str, str], Dict[str, float]] = {}
    for span in spans:
        if span["name"] != "profile":
            continue
        for frame in (span.get("attributes") or {}).get("frames", []):
            entry = totals.setdefault((frame.get("stage", "-"), frame.get("function", "?")),
                                      {"self_ms": 0.0, "samples": 0})
            entry["self_ms"] += float(frame.get("self_ms", 0.0))
            entry["samples"] += int(frame.get("samples", 0))
    ranked = sorted(totals.items(), key=lambda kv: kv[1]["self_ms"], reverse=True)
    return [{"stage": stage, "function": function, "self_ms": round(entry["self_ms"], 3),
             "samples": entry["samples"]} for (stage, function), entry in ranked[:MAX_PROFILE_FRAMES]]


def analyze_trace(path: Any, since_ts: Optional[float] = None,
                  window_index: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The analysis of one trace (a file, or the list of one logical
    trace's bases), what ``trace --as-json`` prints; ``since_ts`` bounds
    the spans' end times (the window's ``until_ts`` stays null, as the
    JAX command leaves it)."""
    paths = [path] if isinstance(path, str) else list(path)
    spans = list(read_traces(paths, since_ts=since_ts, window_index=window_index))
    doc = {
        "trace": paths[0] if len(paths) == 1 else paths,
        "spans_read": len(spans),
        "span_summary": summarize_spans(spans),
        "request_breakdown": request_breakdown(spans),
        "stream_breakdown": stream_breakdown(spans),
        "prediction_accuracy": prediction_accuracy(spans),
        "profile_frames": top_profile_frames(spans),
    }
    if since_ts is not None:
        doc["window"] = {"since_ts": since_ts, "until_ts": None}
    return doc


# -- rendering ---------------------------------------------------------------


def _table(rows: List[List[Any]], header: List[str]) -> str:
    widths = [max(len(str(row[i])) for row in [header] + rows) for i in range(len(header))]
    lines = ["  ".join(str(cell).ljust(widths[i]) for i, cell in enumerate(row))
             for row in [header, ["-" * w for w in widths]] + rows]
    return "\n".join(line.rstrip() for line in lines)


def render_analysis(doc: Dict[str, Any]) -> str:
    """:func:`analyze_trace`'s document as ``trace`` prints it."""
    trace = doc["trace"]
    if isinstance(trace, list):
        trace = ", ".join(trace)
    out: List[str] = [f"trace: {trace}  ({doc['spans_read']} spans)"]
    window = doc.get("window")
    if window:
        out.append(f"window: since_ts={window.get('since_ts')} until_ts={window.get('until_ts')}")

    summary = doc.get("span_summary") or {}
    if summary:
        out.append("\nSpan latency (ms):")
        out.append(_table([[name, d["count"], d["p50_ms"], d["p95_ms"], d["p99_ms"]] for name, d in summary.items()],
                          ["span", "count", "p50", "p95", "p99"]))

    breakdown = doc.get("request_breakdown")
    if breakdown:
        out.append(f"\nRequests: {breakdown['requests']}  walltime p50={breakdown['walltime_p50_ms']}ms "
                   f"p95={breakdown['walltime_p95_ms']}ms p99={breakdown['walltime_p99_ms']}ms")
        out.append("\nPer-stage breakdown:")
        out.append(_table([[name, d["p50_ms"], d["p95_ms"], f"{d['share_of_p50'] * 100:.1f}%"]
                           for name, d in breakdown["stages"].items()], ["stage", "p50", "p95", "share of p50"]))
        out.append(f"\nattribution coverage: {breakdown['attribution_coverage'] * 100:.1f}% of median "
                   "request walltime explained by instrumented stages")
        if breakdown["critical_path"]:
            path_text = "  >  ".join(f"{step['stage']} {step['duration_ms']}ms" for step in breakdown["critical_path"])
            out.append(f"critical path (median request): {path_text}")

    stream = doc.get("stream_breakdown")
    if stream:
        totals = stream.get("totals") or {}
        streams = stream.get("streams") or {}
        out.append(f"\nStream sessions: {len(streams)}  flushes={totals.get('flushes', 0)} "
                   f"rows in={totals.get('rows_in', 0)} scored={totals.get('rows_scored', 0)} "
                   f"failed={totals.get('rows_failed', 0)} shed={totals.get('rows_shed', 0)}")
        out.append(_table([[stream_id, e["flushes"], e["rows_scored"], e["lag_p50_ms"], e["lag_max_ms"],
                            e["device_p50_ms"],
                            e["predicted_device_p50_ms"] if e["predicted_device_p50_ms"] is not None else "-",
                            e["linked_ingests"]] for stream_id, e in streams.items()],
                          ["stream", "flushes", "rows", "lag p50", "lag max", "device p50", "pred p50", "links"]))
        for stream_id, entry in streams.items():
            if entry.get("critical_path"):
                path_text = "  >  ".join(f"{step['stage']} {step['p50_ms']}ms" for step in entry["critical_path"])
                out.append(f"critical path ({stream_id}, median): {path_text}")

    accuracy = doc.get("prediction_accuracy")
    if accuracy:
        out.append("\nPrediction accuracy (cost model vs measured device ms):")
        out.append(_table([[program, e["count"], f"{e['error_p50'] * 100:.1f}%", f"{e['error_p95'] * 100:.1f}%",
                            e["bias"]] for program, e in accuracy.items()],
                          ["program", "pairs", "err p50", "err p95", "bias"]))

    frames = doc.get("profile_frames") or []
    if frames:
        out.append("\nTop self-time frames (sampling profiler):")
        out.append(_table([[f["stage"], f["function"], f["self_ms"], f["samples"]] for f in frames[:15]],
                          ["stage", "function", "self ms", "samples"]))
    return "\n".join(out)
