"""
Harvest, fit, gated promotion and recalibration
(``gordo_tpu/perfmodel/service.py``).

Only :func:`fit_and_promote` installs a fitted section, model by model: a
candidate ``(target, program)`` regressor lands in ``cost_table.json``
when its holdout error beats every incumbent ruler on the same holdout
rows, the analytic model replayed feature for feature and the model
promoted before it, if any. A candidate that loses either is reported and
dropped; a corpus with no winner leaves the table as it was. The analytic
model is never deleted, only out-predicted. The table's analytic
constants are the JAX package's (``planner/costmodel.py``), not the
card's: on the card the gate holds a fit to them as they are.

:func:`maybe_recalibrate` is the lifecycle supervisor's online loop
(``GORDO_TPU_PERFMODEL_RECAL``, default off): an unchanged corpus (its
fingerprint) is not refitted, and no failure escapes it.
"""

import logging
import os
from typing import Any, Dict, List, Optional

from ..planner.costmodel import COST_TABLE_FILE, CostTable, load_table_safe
from ..utils.env import env_bool, env_str
from .features import TrainingRow, corpus_fingerprint, harvest_corpus
from .model import analytic_prediction, coef_predict, evaluate_rows, fit_section, holdout_split

logger = logging.getLogger(__name__)

TABLE_ENV = "GORDO_TPU_PERFMODEL_TABLE"
RECAL_ENV = "GORDO_TPU_PERFMODEL_RECAL"

#: a candidate must beat a ruler's log-MAE by more than this to replace
#: it: refitting noise does not churn the table
_PROMOTE_MARGIN = 1e-6


def default_table_path(directory: Optional[str] = None) -> Optional[str]:
    """The table a fit writes and a consumer loads:
    ``GORDO_TPU_PERFMODEL_TABLE``, else ``cost_table.json`` beside the
    corpus ``directory``, else None (the analytic defaults)."""
    configured = env_str(TABLE_ENV, None)
    if configured:
        return configured
    if directory:
        return os.path.join(directory, COST_TABLE_FILE)
    return None


def _median_baseline(train: List[TrainingRow]) -> Optional[float]:
    if not train:
        return None
    values = sorted(r.y for r in train)
    return values[len(values) // 2]


def _gate_entry(target: str, program: str, entry: dict, population: List[TrainingRow],
                incumbent: CostTable) -> Dict[str, Any]:
    """One candidate's verdict: its holdout error against each incumbent
    ruler's on the same holdout rows (the fit's own split)."""
    train, holdout = holdout_split(population)
    candidate_mae = float(entry["holdout_mae_log"])
    analytic_mae, analytic_n = evaluate_rows(
        holdout, lambda r: analytic_prediction(incumbent, target, program, r.features))
    if analytic_n == 0:
        # no analytic replay (hbm_bytes): the baseline is the training median
        median = _median_baseline(train)
        analytic_mae, analytic_n = evaluate_rows(holdout, lambda r: median)
    incumbent_entry = incumbent.learned_entry(target, program)
    incumbent_mae: Optional[float] = None
    if incumbent_entry is not None:
        incumbent_mae, scored = evaluate_rows(holdout, lambda r: coef_predict(incumbent_entry["coef"], r.features))
        if scored == 0:
            incumbent_mae = None
    beats_analytic = candidate_mae <= analytic_mae + _PROMOTE_MARGIN
    beats_incumbent = incumbent_mae is None or candidate_mae <= incumbent_mae + _PROMOTE_MARGIN
    return {
        "target": target,
        "program": program,
        "n": int(entry["n"]),
        "holdout_mae_log": candidate_mae,
        "analytic_mae_log": round(analytic_mae, 6) if analytic_mae != float("inf") else None,
        "incumbent_mae_log": round(incumbent_mae, 6) if incumbent_mae is not None else None,
        "accepted": bool(beats_analytic and beats_incumbent),
        "reason": "promoted" if beats_analytic and beats_incumbent
        else ("loses to analytic" if not beats_analytic else "loses to incumbent"),
    }


def fit_and_promote(directory: str, table_path: Optional[str] = None, min_samples: Optional[int] = None,
                    force: bool = False) -> Dict[str, Any]:
    """Harvest ``directory``, fit, gate and maybe write the table; the
    report: the corpus's stats, each model's verdict, ``promoted`` and
    ``reason``. ``force`` skips the accuracy gate (an operator's override),
    never the sample floor. An empty corpus writes nothing; neither does
    one whose fingerprint the table's section was fitted on."""
    rows, stats = harvest_corpus(directory)
    report: Dict[str, Any] = {"directory": directory, "corpus": stats, "promoted": False, "models": []}
    path = table_path or default_table_path(directory)
    report["table"] = path
    if not rows:
        report["reason"] = "empty corpus; analytic fallback stays pinned"
        return report
    fingerprint = corpus_fingerprint(rows)
    report["fingerprint"] = fingerprint
    incumbent = load_table_safe(path if path and os.path.exists(path) else None)
    incumbent_meta = (incumbent.learned or {}).get("corpus") or {}
    if not force and incumbent_meta.get("fingerprint") == fingerprint:
        report["reason"] = "corpus unchanged since incumbent fit"
        return report
    section = fit_section(rows, min_samples=min_samples)
    if section is None:
        report["reason"] = "no (target, program) population clears the sample floor"
        return report
    populations: Dict[tuple, List[TrainingRow]] = {}
    for row in rows:
        populations.setdefault((row.target, row.program), []).append(row)
    accepted: Dict[str, Dict[str, dict]] = {}
    for target, programs in sorted(section["targets"].items()):
        for program, entry in sorted(programs.items()):
            verdict = _gate_entry(target, program, entry, populations[(target, program)], incumbent)
            if force and not verdict["accepted"]:
                verdict["accepted"] = True
                verdict["reason"] = "forced"
            report["models"].append(verdict)
            if verdict["accepted"]:
                accepted.setdefault(target, {})[program] = entry
    if not accepted:
        report["reason"] = "no candidate beat the incumbent rulers"
        return report
    # the incumbent's models of keys this corpus did not refit stay: a
    # serving corpus does not evict the build's models
    for target, programs in ((incumbent.learned or {}).get("targets") or {}).items():
        for program, entry in programs.items():
            accepted.setdefault(target, {}).setdefault(program, entry)
    section["targets"] = {t: dict(sorted(p.items())) for t, p in sorted(accepted.items())}
    section["corpus"] = {"fingerprint": fingerprint, "rows": len(rows), "directory": os.path.abspath(directory)}
    promoted = CostTable(
        throughput=incumbent.throughput,
        compile_per_flop=incumbent.compile_per_flop,
        compile_floor_s=incumbent.compile_floor_s,
        dispatch_s=incumbent.dispatch_s,
        run_factors=dict(incumbent.run_factors),
        compile_factors=dict(incumbent.compile_factors),
        precision_factors=dict(incumbent.precision_factors),
        samples=dict(incumbent.samples),
        learned=section,
    )
    if path:
        promoted.save(path)
        report["promoted"] = True
        report["reason"] = "promoted"
    else:
        report["reason"] = "no table path; fit evaluated but not installed"
    report["section"] = {"models": sum(len(p) for p in section["targets"].values()),
                         "targets": sorted(section["targets"])}
    return report


def section_status(table_path: Optional[str]) -> Dict[str, Any]:
    """What the table at ``table_path`` carries: the ``perfmodel status``
    document."""
    table = load_table_safe(table_path)
    doc: Dict[str, Any] = {
        "table": table_path,
        "exists": bool(table_path and os.path.exists(table_path)),
        "calibrated": table.calibrated,
        "learned": table.has_learned,
        "models": [],
    }
    if table.learned:
        corpus = table.learned.get("corpus") or {}
        if corpus:
            doc["corpus"] = dict(corpus)
        for target, programs in sorted((table.learned.get("targets") or {}).items()):
            for program, entry in sorted(programs.items()):
                doc["models"].append({"target": target, "program": program, "n": int(entry.get("n", 0)),
                                      "holdout_mae_log": entry.get("holdout_mae_log")})
    return doc


def maybe_recalibrate(directory: str, table_path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """One recalibration: :func:`fit_and_promote` when
    ``GORDO_TPU_PERFMODEL_RECAL`` is on (else None). It never raises: a
    torn trace, a read-only table directory or a singular fit logs a
    warning and answers None, and the incumbent table keeps serving."""
    if not env_bool(RECAL_ENV, False):
        return None
    try:
        return fit_and_promote(directory, table_path=table_path)
    except Exception as exc:  # noqa: BLE001 - the supervisor's safety contract
        logger.warning("Perfmodel recalibration from %s failed (%s); keeping the incumbent table", directory, exc)
        return None
