"""
The ``perfmodel`` commands (``gordo_tpu/cli/cli.py:2009-2200``), with the
JAX commands' options, documents, lines and exit codes:

- ``perfmodel fit CORPUS_DIR [--table F] [--min-samples N] [--force]
  [--as-json]``: harvest the corpus's build and serve traces, fit, and
  promote each model that beats the analytic model and the incumbent on
  its holdout (``perfmodel.fit_and_promote``). An empty corpus exits 0
  and says the analytic model stays;
- ``perfmodel status [--table F] [--as-json]``: what a table carries
  (``perfmodel.section_status``);
- ``perfmodel eval CORPUS_DIR [--table F] [--as-json]``: a table's learned
  models against the analytic model on every row of a corpus, fitting and
  writing nothing.

``--table`` defaults to ``GORDO_TPU_PERFMODEL_TABLE``, else (``fit`` and
``eval``) ``cost_table.json`` beside the corpus. A corpus directory that
does not exist, an ``eval`` table that does not exist or a ``--table``
that is a directory exits 2, as the JAX commands' path checks do.
"""

import argparse
import json
import os
from typing import Optional

from ..perfmodel import default_table_path, fit_and_promote, harvest_corpus, section_status
from ..perfmodel.model import analytic_prediction, evaluate_rows
from ..planner.costmodel import load_table_safe


def add_parser(commands) -> None:
    perfmodel = commands.add_parser("perfmodel", help="the learned performance model: fit device-cost regressors "
                                    "from telemetry traces, inspect the promoted table, evaluate it on a corpus")
    sub = perfmodel.add_subparsers(dest="perfmodel_command", required=True)
    fit = sub.add_parser("fit", help="harvest a corpus, fit, and promote the models that beat the analytic model "
                         "and the incumbent on their holdout")
    fit.add_argument("corpus_dir")
    fit.add_argument("--table", dest="table_path", default=None, help="the cost_table.json to promote into "
                     "(default: GORDO_TPU_PERFMODEL_TABLE, else cost_table.json beside the corpus)")
    fit.add_argument("--min-samples", type=int, default=None, help="smallest (target, program) population to fit "
                     "(default: GORDO_TPU_PERFMODEL_MIN_SAMPLES)")
    fit.add_argument("--force", action="store_true", help="install the fit even when it loses the holdout "
                     "accuracy gate (the sample floor still applies)")
    fit.add_argument("--as-json", action="store_true", help="raw report JSON")
    status = sub.add_parser("status", help="what the cost table carries: factors, learned models, corpus identity")
    status.add_argument("--table", dest="table_path", default=None,
                        help="the cost table to inspect (default: GORDO_TPU_PERFMODEL_TABLE)")
    status.add_argument("--as-json", action="store_true", help="raw status JSON")
    eval_ = sub.add_parser("eval", help="a table's learned models against the analytic model on a corpus")
    eval_.add_argument("corpus_dir")
    eval_.add_argument("--table", dest="table_path", default=None, help="evaluate this table's learned models "
                       "(default: GORDO_TPU_PERFMODEL_TABLE, else cost_table.json beside the corpus)")
    eval_.add_argument("--as-json", action="store_true", help="raw report JSON")


def main(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    command = args.perfmodel_command
    if command != "status" and not os.path.isdir(args.corpus_dir):
        parser.error(f"CORPUS_DIR: directory {args.corpus_dir!r} does not exist")
    if args.table_path is not None and os.path.isdir(args.table_path):
        parser.error(f"--table: {args.table_path!r} is a directory")
    if command == "eval" and args.table_path is not None and not os.path.isfile(args.table_path):
        parser.error(f"--table: file {args.table_path!r} does not exist")
    if command == "fit":
        return fit(args.corpus_dir, args.table_path, args.min_samples, args.force, args.as_json)
    if command == "status":
        return status(args.table_path, args.as_json)
    return evaluate(args.corpus_dir, args.table_path, args.as_json)


def fit(corpus_dir: str, table_path: Optional[str], min_samples: Optional[int], force: bool, as_json: bool) -> int:
    report = fit_and_promote(corpus_dir, table_path=table_path, min_samples=min_samples, force=force)
    if as_json:
        print(json.dumps(report, indent=1, sort_keys=True), flush=True)
        return 0
    corpus = report.get("corpus") or {}
    print(f"corpus: {corpus.get('rows', 0)} training row(s) from {corpus.get('spans', 0)} span(s) in {corpus_dir}")
    for entry in report.get("models") or []:
        inc = entry.get("incumbent_mae_log")
        print(f"  {entry['target']}/{entry['program']}: n={entry['n']} holdout={entry['holdout_mae_log']:.4f} "
              f"analytic={entry.get('analytic_mae_log')} incumbent={inc if inc is not None else '-'} "
              f"-> {entry['reason']}")
    print(f"{'PROMOTED' if report.get('promoted') else 'not promoted'}: {report.get('reason')}"
          + (f" ({report.get('table')})" if report.get("promoted") else ""))
    if not report.get("promoted") and not (report.get("models") or []):
        # a thin corpus is normal at a cold start
        print("the analytic model remains the active fallback")
    return 0


def status(table_path: Optional[str], as_json: bool) -> int:
    path = table_path or default_table_path()
    doc = section_status(path)
    if as_json:
        print(json.dumps(doc, indent=1, sort_keys=True), flush=True)
        return 0
    print(f"table: {path or '(none; analytic defaults)'}")
    print(f"calibrated: {doc['calibrated']}  learned: {doc['learned']}")
    corpus = doc.get("corpus")
    if corpus:
        print(f"corpus: {corpus.get('rows')} row(s), fingerprint {corpus.get('fingerprint')}")
    for entry in doc["models"]:
        print(f"  {entry['target']}/{entry['program']}: n={entry['n']} holdout_mae_log={entry['holdout_mae_log']}")
    if not doc["models"]:
        print("no learned models; predictions are analytic")
    return 0


def evaluate(corpus_dir: str, table_path: Optional[str], as_json: bool) -> int:
    path = table_path or default_table_path(corpus_dir)
    table = load_table_safe(path)
    rows, stats = harvest_corpus(corpus_dir)
    populations: dict = {}
    for row in rows:
        populations.setdefault((row.target, row.program), []).append(row)
    report = {"table": path, "corpus": stats, "models": []}
    for (target, program), population in sorted(populations.items()):
        learned_mae, learned_n = evaluate_rows(population, lambda r: table.learned_predict(target, program,
                                                                                           r.features))
        analytic_mae, analytic_n = evaluate_rows(population,
                                                 lambda r: analytic_prediction(table, target, program, r.features))
        report["models"].append({
            "target": target,
            "program": program,
            "rows": len(population),
            "learned_mae_log": round(learned_mae, 6) if learned_n else None,
            "learned_scored": learned_n,
            "analytic_mae_log": round(analytic_mae, 6) if analytic_n else None,
        })
    if as_json:
        print(json.dumps(report, indent=1, sort_keys=True), flush=True)
        return 0
    print(f"corpus: {len(rows)} row(s); table: {path or '(analytic defaults)'}")
    for entry in report["models"]:
        learned = entry["learned_mae_log"]
        print(f"  {entry['target']}/{entry['program']}: rows={entry['rows']} "
              f"learned={learned if learned is not None else '-'} (scored {entry['learned_scored']}) "
              f"analytic={entry['analytic_mae_log']}")
    if not report["models"]:
        print("no training rows in the corpus")
    return 0
