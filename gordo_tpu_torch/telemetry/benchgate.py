"""
The performance-regression gate behind ``bench-check``, a copy of
``gordo_tpu/telemetry/benchgate.py``: :data:`GATES` declares, for each
bench kind (a document's ``bench`` field), which of its numbers are gated
and how (a direction and a relative tolerance, or an absolute budget or
floor); :func:`compare` holds a candidate run to a baseline document under
them, :func:`render_report` prints the result.

It reads the repo's committed ``BENCH_*.json`` documents
(:data:`BASELINE_FILES`), which are the JAX package's bench records, not
numbers of the port. ``--tolerance`` scales every tolerance, budget and
floor ("2.0 = twice as lenient").
"""

import json
from typing import Any, Dict, List, NamedTuple, Optional


class MetricSpec(NamedTuple):
    """One gated number inside a bench document.

    ``kind``: ``higher`` / ``lower`` (relative to baseline, within
    ``tolerance``), ``max_bound`` (candidate must stay ≤ ``bound``,
    baseline-independent), ``min_bound`` (candidate must stay ≥
    ``bound`` — absolute floors like "batching-on must not lose to
    batching-off"), or ``truthy`` (candidate must be true).
    ``path`` is dotted (``scoring.batching_on.throughput_rps``).
    """

    label: str
    path: str
    kind: str
    tolerance: float = 0.0
    bound: Optional[float] = None


#: the load-bearing numbers per bench kind, keyed by the document's
#: ``bench`` field — adding a bench to the trajectory means adding its
#: gate row here (the golden-schema tests pin the paths)
GATES: Dict[str, List[MetricSpec]] = {
    "route-observability": [
        MetricSpec(
            "full-route throughput (floor rps)",
            "route.throughput_rps",
            "higher",
            0.25,
        ),
        MetricSpec("full-route p50 latency", "route.p50_ms", "lower", 0.25),
        MetricSpec(
            "stage attribution coverage",
            "route.attribution_coverage",
            "higher",
            0.05,
        ),
        # µs/request, not % of the floor: the telemetry-on cost is a
        # fixed per-request price (trace identity + log binding +
        # head-sampled export), so a %-of-floor budget PENALIZES making
        # scoring faster — the same ~28µs that read as 2% at a 665rps
        # floor reads as 5% past 1900rps.
        MetricSpec(
            "telemetry overhead on the scoring path (µs/request)",
            "scoring_overhead.overhead_us_per_request",
            "max_bound",
            bound=60.0,
        ),
        # -- the columnar-wire acceptance set ---------------------------
        MetricSpec(
            "response_assemble p50 budget (ms)",
            "route.stages.response_assemble.p50_ms",
            "max_bound",
            bound=50.0,
        ),
        # tightened 3.0 -> 1.5 by the device-resident ingest subsystem:
        # with decode, staging and preprocessing all columnar/
        # on-device, the route may cost at most 1.5x the scoring-only
        # floor at matched concurrency
        MetricSpec(
            "columnar (Arrow) route p50 vs scoring-only floor at "
            "matched concurrency (ratio)",
            "route_gap_p50_ratio",
            "max_bound",
            bound=1.5,
        ),
        # wire parse + device staging together must stay a small
        # absolute cost per request (the stages the ingest subsystem
        # owns: data_decode narrowed to wire->host parse, device_ingest
        # the wire->device staging it used to hide)
        MetricSpec(
            "data_decode + device_ingest p50 budget (ms)",
            "ingest_p50_ms",
            "max_bound",
            bound=10.0,
        ),
        # route-level batching must stay at least at parity with
        # batching-off (noise margin included) — a wash between the two
        # was invisible to the gate until this row. On CPU-only hosts
        # the fused program has no parallel hardware to exploit, so
        # parity IS the CPU ceiling; a ratio below the floor means the
        # batched path regressed (e.g. dispatcher latency, queue
        # convoy), which is exactly what this row exists to catch.
        MetricSpec(
            "route-level batched vs unbatched throughput (ratio)",
            "route_batched_vs_unbatched",
            "min_bound",
            bound=0.6,
        ),
    ],
    "serve-micro-batching": [
        MetricSpec(
            "batched scoring throughput (floor rps)",
            "scoring.batching_on.throughput_rps",
            "higher",
            0.25,
        ),
        MetricSpec(
            "unbatched scoring throughput (floor rps)",
            "scoring.batching_off.throughput_rps",
            "higher",
            0.25,
        ),
        MetricSpec("batching gain", "throughput_gain", "higher", 0.2),
        MetricSpec("program-cache bounded", "programs_bounded", "truthy"),
    ],
    "telemetry-overhead": [
        MetricSpec(
            "build telemetry overhead (%)",
            "overhead_pct",
            "max_bound",
            bound=3.0,
        ),
    ],
    "planner-strategies": [
        MetricSpec("packed beats naive", "packed_wins", "truthy"),
    ],
    "lifecycle-hot-swap": [
        MetricSpec("hot-swap p50 (ms)", "swap_p50_ms", "lower", 0.5),
        MetricSpec(
            "dropped requests during swaps",
            "requests_dropped",
            "max_bound",
            bound=0.0,
        ),
    ],
    "fleet-health-overhead": [
        MetricSpec(
            "health ledger + device sampler overhead (%)",
            "overhead_pct",
            "max_bound",
            bound=2.0,
        ),
        MetricSpec(
            "fleet_health.json written by the instrumented build",
            "ledger_written",
            "truthy",
        ),
        MetricSpec(
            "ledger record throughput (records/s)",
            "ledger_records_per_sec",
            "higher",
            0.5,
        ),
    ],
    "precision-ladder": [
        MetricSpec(
            "f32 fused scoring throughput (floor rows/s)",
            "throughput.f32.rows_per_sec",
            "higher",
            0.5,
        ),
        # CPU hosts have no bf16/int8 compute units, so parity with f32
        # is the CEILING there (measured ~0.5x under XLA's emulation) —
        # these floors exist to catch the reduced paths REGRESSING
        # (an accidental f64 upcast, a dequant blowup), exactly the
        # route_batched_vs_unbatched min_bound pattern; the speedup
        # itself asserts on device hardware.
        MetricSpec(
            "bf16 vs f32 fused scoring throughput (ratio)",
            "ratios.bf16_vs_f32",
            "min_bound",
            bound=0.3,
        ),
        MetricSpec(
            "int8 vs f32 fused scoring throughput (ratio)",
            "ratios.int8_vs_f32",
            "min_bound",
            bound=0.25,
        ),
        MetricSpec(
            "reduced-vs-f32 verdict agreement (min across precisions)",
            "verdict_agreement.min",
            "min_bound",
            bound=0.95,
        ),
        MetricSpec(
            "precision-parity gates passed",
            "parity_gates_passed",
            "truthy",
        ),
    ],
    "serve-chaos": [
        # the containment contract, verbatim: one poisoned member out of
        # a coalesced fleet must never turn into innocent-rider 5xx
        MetricSpec(
            "innocent-rider 5xx during the device-fault drill",
            "innocent_rider_5xx",
            "max_bound",
            bound=0.0,
        ),
        MetricSpec(
            "poison member's breaker tripped into quarantine",
            "breaker_tripped",
            "truthy",
        ),
        MetricSpec(
            "breaker recovered via its half-open probe",
            "breaker_recovered",
            "truthy",
        ),
        MetricSpec(
            "health ledger narrated the trip and recovery",
            "ledger_narrated",
            "truthy",
        ),
        MetricSpec(
            "hot-swap mid-drill dropped requests",
            "swap_dropped",
            "max_bound",
            bound=0.0,
        ),
        # steady-state throughput under faults vs the no-fault floor:
        # bisection + breaker quarantine must CONTAIN the poison, not
        # drag the whole serving plane down with it
        MetricSpec(
            "faulted vs clean innocent-rider throughput (ratio)",
            "throughput_ratio_faulted_vs_clean",
            "min_bound",
            bound=0.4,
        ),
    ],
    "fleet-scale": [
        # the bounded fleet-status contract: the summary-first document
        # must stay both cheap in absolute terms and a small fraction
        # of the naive full render at the largest measured N
        MetricSpec(
            "fleet-status summary build+render budget (ms)",
            "gates.fleet_status_summary_ms",
            "max_bound",
            bound=250.0,
        ),
        MetricSpec(
            "fleet-status summary vs naive full render (ratio)",
            "gates.fleet_status_summary_vs_full_ratio",
            "max_bound",
            bound=0.5,
        ),
        # one machine's flush must rewrite ~one shard's share of the
        # corpus regardless of N (the ratio is shard-normalized, so the
        # budget holds at CI's reduced sizes too): a value near the
        # shard count would mean the flush went monolithic again
        MetricSpec(
            "ledger dirty-flush bytes vs one-shard share (ratio)",
            "gates.ledger_dirty_flush_shard_ratio",
            "max_bound",
            bound=2.0,
        ),
        MetricSpec(
            "merged-window read opened only manifest-selected files",
            "gates.rollup_reads_bounded",
            "truthy",
        ),
        MetricSpec(
            "rollup aggregation throughput at scale (spans/s)",
            "gates.rollup_spans_per_sec",
            "higher",
            0.5,
        ),
        MetricSpec(
            "ledger populate throughput at scale (records/s)",
            "gates.ledger_records_per_sec",
            "higher",
            0.5,
        ),
        MetricSpec(
            "breaker-board bounded summary budget (ms)",
            "gates.breaker_summary_ms",
            "max_bound",
            bound=5.0,
        ),
    ],
    "stream-soak": [
        # the always-on plane must beat the request/response ceiling:
        # one ingest connection amortizes decode + dispatch across many
        # windows, where the JSON route pays it per exchange
        MetricSpec(
            "sustained streaming scoring throughput (rows/s)",
            "soak.rows_per_sec",
            "higher",
            0.5,
        ),
        # the zero-gap invariant, audited per machine across the whole
        # soak: rows_in == rows_scored + rows_failed + pending + shed
        MetricSpec(
            "per-machine row-accounting gaps across the soak",
            "soak.accounting_gaps",
            "max_bound",
            bound=0.0,
        ),
        # hot-swap mid-stream: anomaly frames' [first_seq, last_seq]
        # spans must stay contiguous per machine across every promotion
        # — a hole is a dropped window, an overlap a double-score
        MetricSpec(
            "hot-swaps completed mid-stream",
            "swap.swaps",
            "min_bound",
            bound=5.0,
        ),
        MetricSpec(
            "windows dropped or double-scored across hot-swaps",
            "swap.seq_gaps",
            "max_bound",
            bound=0.0,
        ),
        # poison containment: breakers quarantine the poisoned member;
        # its stream-mates keep scoring without a single dropped window
        MetricSpec(
            "poisoned member quarantined by its breaker",
            "poison.quarantined",
            "truthy",
        ),
        MetricSpec(
            "innocent machines' dropped windows under member poison",
            "poison.innocent_drops",
            "max_bound",
            bound=0.0,
        ),
        MetricSpec(
            "quarantined member recovered via half-open probe",
            "poison.recovered",
            "truthy",
        ),
        # drain: every open SSE subscription ended with a terminal frame
        MetricSpec(
            "drain closed every stream with a terminal frame",
            "drain.clean_terminals",
            "truthy",
        ),
        # -- the streaming-observability acceptance set ------------------
        # span telemetry on the flush path, interleaved quiet floors:
        # the always-on plane must not pay a visible tax for its own
        # observability
        MetricSpec(
            "stream telemetry soak overhead (%)",
            "telemetry.overhead_pct",
            "max_bound",
            bound=2.0,
        ),
        # freshness under sustained load: the soak's row-weighted
        # ingest-to-scored lag p95, an absolute budget well under the
        # packaged 5s freshness SLO threshold
        MetricSpec(
            "soak ingest-to-scored lag p95 budget (ms)",
            "soak.lag_p95_ms",
            "max_bound",
            bound=2000.0,
        ),
        # the freshness SLO drill: an injected stream_score stall must
        # walk the alert pending -> firing (the page-severity predicate
        # that holds lifecycle auto-promotion) and resolve on recovery
        MetricSpec(
            "freshness drill: stall -> pending -> firing -> resolved",
            "slo_drill.drill_ok",
            "truthy",
        ),
        MetricSpec(
            "freshness firing held the canary promotion gate",
            "slo_drill.held_promotion",
            "truthy",
        ),
        # the scrape surface must stay a small constant at 10k members:
        # per-machine detail belongs to /stream/status and the trace
        MetricSpec(
            "stream scrape surface bounded at 10k members",
            "prometheus.bounded",
            "truthy",
        ),
        MetricSpec(
            "stream scrape samples at 10k members",
            "prometheus.samples",
            "max_bound",
            bound=100.0,
        ),
    ],
    "device-ingest": [
        # compiled-vs-host numeric parity on the same payloads is the
        # subsystem's contract — a fast wrong answer fails the run
        MetricSpec(
            "compiled plan output matches the host pipeline",
            "parity_ok",
            "truthy",
        ),
        MetricSpec(
            "broken-dlpack fallback still answers correct bytes",
            "fallback_ok",
            "truthy",
        ),
        # the rung dlpack_enabled() picks for this backend vs forced
        # host staging: on CPU both are the host rung, so parity is the
        # ceiling and the floor catches the picked rung REGRESSING (the
        # precision-ladder min_bound pattern); the dlpack zero-copy win
        # itself asserts on device hardware
        MetricSpec(
            "serving transfer rung vs host staging throughput (ratio)",
            "transfer.speedup",
            "min_bound",
            bound=0.4,
        ),
        MetricSpec(
            "compiled-plan vs host-pipeline scoring throughput (ratio)",
            "compiled.speedup",
            "min_bound",
            bound=0.5,
        ),
        MetricSpec(
            "end-to-end staging p50 budget (ms)",
            "compiled.staged_p50_ms",
            "max_bound",
            bound=10.0,
        ),
    ],
    "slo-engine": [
        MetricSpec(
            "rollup aggregation throughput (spans/s)",
            "aggregate_spans_per_sec",
            "higher",
            0.5,
        ),
        MetricSpec(
            "steady-state SLO evaluation overhead vs telemetry-on "
            "floor (%)",
            "overhead_pct",
            "max_bound",
            bound=2.0,
        ),
        MetricSpec(
            "burn drill: pending -> firing -> resolved",
            "drill_ok",
            "truthy",
        ),
    ],
    "learned-perfmodel": [
        # the learned regressor earns its place by beating the analytic
        # model on a held-out slice of the same trace corpus — the same
        # accuracy gate fit_and_promote enforces, re-checked end to end
        # from raw traces. Ratio = learned MAE / analytic MAE in log
        # space; 1.0 is parity, the promotion gate's own floor.
        MetricSpec(
            "learned vs analytic holdout MAE, device time (ratio)",
            "accuracy.device_ms.mae_ratio",
            "max_bound",
            bound=1.0,
        ),
        MetricSpec(
            "learned vs analytic holdout MAE, compile time (ratio)",
            "accuracy.compile_ms.mae_ratio",
            "max_bound",
            bound=1.0,
        ),
        MetricSpec("model promoted from bench corpus", "fit.promoted", "truthy"),
        # learned-informed serving (model-ordered warmup + learned step
        # predictions) vs the static ladder at equal offered load. On
        # CPU hosts there is no hardware for the model to exploit, so
        # parity is the ceiling — the floor catches the learned path
        # *losing* throughput (mispredicted ladders, estimator overhead
        # on the hot path).
        MetricSpec(
            "learned-informed vs static ladder throughput (ratio)",
            "ladder.learned_vs_static_throughput",
            "min_bound",
            bound=0.85,
        ),
        MetricSpec(
            "learned-informed vs static ladder p99 latency (ratio)",
            "ladder.learned_vs_static_p99_ratio",
            "max_bound",
            bound=1.5,
        ),
    ],
}

#: where each bench kind's committed baseline lives (repo root)
BASELINE_FILES: Dict[str, str] = {
    "route-observability": "BENCH_ROUTE.json",
    "serve-micro-batching": "BENCH_SERVE.json",
    "telemetry-overhead": "BENCH_TELEMETRY.json",
    "planner-strategies": "BENCH_PLAN.json",
    "lifecycle-hot-swap": "BENCH_LIFECYCLE.json",
    "fleet-health-overhead": "BENCH_FLEET_HEALTH.json",
    "slo-engine": "BENCH_SLO.json",
    "fleet-scale": "BENCH_SCALE.json",
    "precision-ladder": "BENCH_PRECISION.json",
    "serve-chaos": "BENCH_CHAOS.json",
    "stream-soak": "BENCH_STREAM.json",
    "device-ingest": "BENCH_INGEST.json",
    "learned-perfmodel": "BENCH_PERFMODEL.json",
}


def get_path(doc: Any, path: str) -> Any:
    """Walk a dotted path through nested dicts; None when absent."""
    node = doc
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _evaluate(
    spec: MetricSpec,
    baseline: Optional[float],
    candidate: Any,
    tolerance_scale: float,
) -> Dict[str, Any]:
    result: Dict[str, Any] = {
        "metric": spec.label,
        "path": spec.path,
        "kind": spec.kind,
        "baseline": baseline,
        "candidate": candidate,
        "status": "ok",
    }
    if candidate is None:
        result["status"] = "regression"
        result["detail"] = "metric missing from candidate run"
        return result
    if spec.kind == "truthy":
        if not candidate:
            result["status"] = "regression"
            result["detail"] = "expected truthy"
        return result
    if spec.kind == "max_bound":
        # --tolerance scales budgets too ("2.0 = twice as lenient"
        # must mean every gate, or the loosening a noisy host needs
        # is vetoed by whichever metric is noisiest)
        bound = float(spec.bound) * tolerance_scale
        result["bound"] = round(bound, 6)
        if float(candidate) > bound:
            result["status"] = "regression"
            result["detail"] = f"exceeds budget {bound:g}"
        return result
    if spec.kind == "min_bound":
        # scaling DIVIDES here: "2.0 = twice as lenient" lowers a floor
        bound = float(spec.bound) / tolerance_scale
        result["bound"] = round(bound, 6)
        if float(candidate) < bound:
            result["status"] = "regression"
            result["detail"] = f"below floor {bound:g}"
        return result
    if baseline is None:
        # a schema-evolving candidate gains metrics the old baseline
        # lacks: report, don't fail — the next committed baseline picks
        # it up
        result["status"] = "skipped"
        result["detail"] = "metric missing from baseline"
        return result
    baseline_f, candidate_f = float(baseline), float(candidate)
    tolerance = spec.tolerance * tolerance_scale
    result["tolerance"] = round(tolerance, 4)
    if baseline_f != 0:
        result["ratio"] = round(candidate_f / baseline_f, 4)
    if spec.kind == "higher":
        limit = baseline_f * (1.0 - tolerance)
        if candidate_f < limit:
            result["status"] = "regression"
            result["detail"] = (
                f"below baseline {baseline_f:g} by more than "
                f"{tolerance * 100:.0f}%"
            )
    elif spec.kind == "lower":
        limit = baseline_f * (1.0 + tolerance)
        if candidate_f > limit:
            result["status"] = "regression"
            result["detail"] = (
                f"above baseline {baseline_f:g} by more than "
                f"{tolerance * 100:.0f}%"
            )
    return result


def compare(
    baseline_doc: Dict[str, Any],
    candidate_doc: Dict[str, Any],
    specs: Optional[List[MetricSpec]] = None,
    tolerance_scale: float = 1.0,
) -> Dict[str, Any]:
    """Evaluate ``candidate_doc`` against ``baseline_doc`` under the
    bench kind's gate specs. The two documents must describe the same
    bench (``bench`` field) unless explicit ``specs`` are supplied."""
    bench = candidate_doc.get("bench")
    if specs is None:
        if baseline_doc.get("bench") != bench:
            raise ValueError(
                f"bench mismatch: baseline is "
                f"{baseline_doc.get('bench')!r}, candidate {bench!r}"
            )
        specs = GATES.get(str(bench))
        if specs is None:
            raise ValueError(
                f"no gate specs for bench {bench!r} "
                f"(known: {sorted(GATES)})"
            )
    results = [
        _evaluate(
            spec,
            get_path(baseline_doc, spec.path),
            get_path(candidate_doc, spec.path),
            tolerance_scale,
        )
        for spec in specs
    ]
    regressions = sum(1 for r in results if r["status"] == "regression")
    return {
        "bench": bench,
        "tolerance_scale": tolerance_scale,
        "results": results,
        "regressions": regressions,
        "ok": regressions == 0,
    }


def compare_files(
    baseline_path: str,
    candidate_path: str,
    tolerance_scale: float = 1.0,
) -> Dict[str, Any]:
    with open(baseline_path) as handle:
        baseline_doc = json.load(handle)
    with open(candidate_path) as handle:
        candidate_doc = json.load(handle)
    report = compare(
        baseline_doc, candidate_doc, tolerance_scale=tolerance_scale
    )
    report["baseline"] = baseline_path
    report["candidate"] = candidate_path
    return report


def render_report(report: Dict[str, Any]) -> str:
    """Human-readable gate report."""
    lines = [
        f"bench-check: {report['bench']}  "
        f"(baseline {report.get('baseline', '?')} vs "
        f"candidate {report.get('candidate', '?')})"
    ]
    for result in report["results"]:
        mark = {"ok": "PASS", "regression": "FAIL", "skipped": "SKIP"}[
            result["status"]
        ]
        value = result["candidate"]
        baseline = result["baseline"]
        detail = result.get("detail", "")
        extra = f"  [{detail}]" if detail else ""
        lines.append(
            f"  {mark}  {result['metric']}: {value!r}"
            + (f" (baseline {baseline!r})" if baseline is not None else "")
            + extra
        )
    verdict = "OK" if report["ok"] else (
        f"{report['regressions']} regression(s)"
    )
    lines.append(f"result: {verdict}")
    return "\n".join(lines)
