"""
The learned performance model, a copy of ``gordo_tpu/perfmodel/``:
log-linear regressors of device cost fitted from the traces the port
already writes, promoted into ``cost_table.json`` only when they beat the
analytic model on held-out rows.

- **harvest** (``features.py``): training rows from ``device_program``
  spans (``build_trace.jsonl``; a run span trains ``device_ms``, a
  ``compile`` span ``compile_ms``) and ``serve_batch`` spans
  (``serve_trace*.jsonl``: one coalesced engine batch each, its measured
  ``device_ms`` beside its shape); a span with ``hbm_bytes`` would train
  that target, and none of the port's carries it;
- **fit** (``model.py``): closed-form ridge in log space per (target,
  program), in pure Python, with a deterministic ~25% holdout and a
  sample floor;
- **promote and recalibrate** (``service.py``): each model installed
  only when its holdout error beats the analytic model replayed on the
  same rows and any incumbent model; an unchanged corpus is not refitted.

Layering: the evaluation side (the ``learned`` section's schema, the
feature vector, the knob-gated predictions) lives in
``planner/costmodel.py``, which never imports this package; this package
imports ``planner/``, ``telemetry/`` and ``utils/`` only, never
``serve/``, ``server/`` or ``cli/``.

Consumers, each behind its own ``GORDO_TPU_PERFMODEL*`` knob (off by
default: the behaviour without the model):

- the planner's bucket and rung decisions (``GORDO_TPU_PERFMODEL``: the
  packer costs through ``CostModel``);
- the serving engine's batch-span predictions
  (``GORDO_TPU_PERFMODEL_TABLE``), predicted-HBM batch caps
  (``_BATCH_CAP_BYTES``), hot-first warmup (``_WARMUP``) and
  predicted-HBM OOM demotion (``_BREAKER``);
- the precision nomination (``serve/precision.py::model_preferred``,
  ``_PRECISION``);
- the stream scorer's flush predictions (``_TABLE``);
- the lifecycle supervisor's recalibration, once a cycle
  (:func:`~.service.maybe_recalibrate`, ``_RECAL``).

Commands: ``python -m gordo_tpu_torch perfmodel fit|status|eval``.
"""

from .features import TrainingRow, corpus_fingerprint, harvest_corpus, harvest_trace, rows_from_spans
from .model import analytic_prediction, evaluate_rows, fit_ridge, fit_section, holdout_split
from .service import default_table_path, fit_and_promote, maybe_recalibrate, section_status

__all__ = [
    "TrainingRow",
    "analytic_prediction",
    "corpus_fingerprint",
    "default_table_path",
    "evaluate_rows",
    "fit_and_promote",
    "fit_ridge",
    "fit_section",
    "harvest_corpus",
    "harvest_trace",
    "holdout_split",
    "maybe_recalibrate",
    "rows_from_spans",
    "section_status",
]
