"""
Training rows from telemetry spans (``gordo_tpu/perfmodel/features.py``).

Nothing is traced for the model's sake; the corpus is what the port
records anyway:

- ``device_program`` spans of ``build_trace.jsonl`` carry the planner's
  static features (``flops_per_sample``, ``stacked_members``,
  ``stacked_samples``, ``epochs``): a run span trains ``device_ms``, a
  ``compile`` span (a shape's first launch on the card) ``compile_ms``;
- ``serve_batch`` spans of ``serve_trace*.jsonl``, one a coalesced engine
  batch, carry ``flops_per_sample``, ``padded_members``, ``padded_rows``,
  ``precision`` and the measured ``device_ms`` (host clock around the
  forward and its copy back, as the JAX engine's is around
  ``block_until_ready``);
- a span of either kind with ``hbm_bytes`` trains that target; no span of
  the port carries it, so that target stays analytic.

Sinks are found and merged as the ``trace`` command merges them
(:func:`~gordo_tpu_torch.telemetry.trace_analysis.trace_bases`, then
``read_traces``): rotated generations and ``-<pid>`` worker variants, each
span once.
"""

import hashlib
import logging
import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

from ..planner.costmodel import learned_feature_vector
from ..telemetry.progress import BUILD_TRACE_FILE
from ..telemetry.serving import SERVE_TRACE_FILE
from ..telemetry.trace_analysis import read_trace, read_traces, trace_bases

logger = logging.getLogger(__name__)


class TrainingRow(NamedTuple):
    """One sample: a feature vector and its measured target."""

    target: str  # device_ms | compile_ms | hbm_bytes
    program: str  # fleet_fit, fleet_windowed_fit, fleet_forward, ...
    features: Tuple[float, ...]  # the LEARNED_FEATURES vector
    y: float  # the measurement, in the target's unit (ms or bytes)


def _float(value: Any) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _shape_of(attrs: Dict[str, Any]) -> Optional[Tuple[float, int, int, int]]:
    """``(flops_per_sample, members, rows, epochs)`` of a span's attributes,
    or None when the static features are missing."""
    flops = _float(attrs.get("flops_per_sample"))
    if flops is None or flops < 0.0:
        return None
    try:
        members = int(attrs.get("stacked_members") or attrs.get("padded_members") or attrs.get("members") or 0)
        rows = int(attrs.get("stacked_samples") or attrs.get("padded_rows") or 0)
        epochs = int(attrs.get("epochs") or 1)
    except (TypeError, ValueError):
        return None
    if members <= 0 or rows <= 0:
        return None
    return flops, members, rows, epochs


def rows_from_spans(spans: Iterable[dict]) -> List[TrainingRow]:
    """Every usable training row of ``spans``; a span without the static
    features or with a missing or zero target gives none."""
    out: List[TrainingRow] = []
    for span in spans:
        if not isinstance(span, dict):
            continue
        name = span.get("name")
        attrs = span.get("attributes") or {}
        if name == "device_program":
            program = str(attrs.get("program") or "")
            shape = _shape_of(attrs)
            if not program or shape is None:
                continue
            flops, members, rows, epochs = shape
            precision = attrs.get("precision")
            device_ms = _float(attrs.get("device_ms"))
            if device_ms is None:
                device_ms = _float(span.get("duration_ms"))
            if attrs.get("compile"):
                # a compile costs by the program, not the data: the shape axes pin to 1
                if device_ms is not None and device_ms > 0.0:
                    out.append(TrainingRow("compile_ms", program,
                                           tuple(learned_feature_vector(flops, 1, 1, 1, precision)), device_ms))
            elif device_ms is not None and device_ms > 0.0:
                out.append(TrainingRow("device_ms", program,
                                       tuple(learned_feature_vector(flops, members, rows, epochs, precision)),
                                       device_ms))
        elif name == "serve_batch":
            shape = _shape_of(attrs)
            if shape is None:
                continue
            flops, members, rows, _ = shape
            precision = attrs.get("precision")
            device_ms = _float(attrs.get("device_ms"))
            if device_ms is None or device_ms <= 0.0:
                continue
            out.append(TrainingRow("device_ms", "fleet_forward",
                                   tuple(learned_feature_vector(flops, members, rows, 1, precision)), device_ms))
        else:
            continue
        # either kind may carry a measured memory peak besides
        hbm = _float(attrs.get("hbm_bytes"))
        if hbm is not None and hbm > 0.0:
            shape = _shape_of(attrs)
            if shape is None:
                continue
            flops, members, rows, _ = shape
            program = "fleet_forward" if name == "serve_batch" else str(attrs.get("program") or "")
            if program:
                out.append(TrainingRow("hbm_bytes", program,
                                       tuple(learned_feature_vector(flops, members, rows, 1, attrs.get("precision"))),
                                       hbm))
    return out


def harvest_trace(path: str) -> List[TrainingRow]:
    """The training rows of one trace file and its rotated generations."""
    return rows_from_spans(read_trace(path))


def harvest_corpus(directory: str) -> Tuple[List[TrainingRow], Dict[str, Any]]:
    """The training rows of every trace in ``directory`` (a build's output
    or a serving telemetry directory), each sink merged as ``trace`` merges
    it, and ``stats``: ``directory``, ``traces`` (each base name and its
    sinks), ``spans``, ``rows`` and ``rows_by_model``. An absent directory
    is ``([], stats)``, never an error."""
    stats: Dict[str, Any] = {"directory": directory, "traces": [], "spans": 0}
    rows: List[TrainingRow] = []
    if not os.path.isdir(directory):
        return rows, stats
    for base_name in (BUILD_TRACE_FILE, SERVE_TRACE_FILE):
        bases = trace_bases(directory, base_name)
        if not bases:
            continue
        spans = list(read_traces(bases))
        stats["traces"].append({"base": base_name, "sinks": len(bases)})
        stats["spans"] += len(spans)
        rows.extend(rows_from_spans(spans))
    stats["rows"] = len(rows)
    by_key: Dict[str, int] = {}
    for row in rows:
        key = f"{row.target}/{row.program}"
        by_key[key] = by_key.get(key, 0) + 1
    stats["rows_by_model"] = dict(sorted(by_key.items()))
    return rows, stats


def corpus_fingerprint(rows: Iterable[TrainingRow]) -> str:
    """A corpus's identity, independent of row order (worker sinks merge
    in no fixed order): recalibration skips a corpus it has fitted."""
    digest = hashlib.sha256()
    for line in sorted(f"{r.target}|{r.program}|{','.join(f'{x:.6f}' for x in r.features)}|{r.y:.6f}"
                       for r in rows):
        digest.update(line.encode())
        digest.update(b"\0")
    return digest.hexdigest()[:16]
