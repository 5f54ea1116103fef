"""
The bucket cost model of ``gordo_tpu/planner/costmodel.py``: static
features of a spec (``spec_param_count``, ``spec_flops_per_sample``,
``compute_precision``, ``:205-252``), the versioned correction table
(``CostTable``, ``load_table_safe``, ``:254-437``), the estimates that
price each bucket of a build's ``fleet_plan.json`` and each serving batch
and stream flush (``CostModel``, ``:439-676``), and ``calibrate``, which
fits the table's factors from a build's ``build_trace.jsonl``
(``:679-786``).

The default table holds the JAX package's uncalibrated constants, so a
plan, and its hash, equal the JAX build's on the same config: a sustained
2.0e9 FLOP/s, 0.35 s plus 2.0e-7 s a FLOP of a sample to compile a
program, 0.01 s to dispatch one, a bf16 program at 0.6 of an f32 one's
run time. They rank buckets against each other; they are neither a TPU's
times nor the card's, and a plan's ``predicted_wall_s`` is this model's
prediction, not a measurement. ``CostModel`` takes the trainer's mesh
shape (``parallel/mesh.py``; ``(1, 1)`` for one card) and rounds stacked
shapes as the trainer does, so a plan equals JAX's on a mesh of that
shape.

``calibrate`` sets each program's factor to the median of actual over
analytic seconds of the trace's ``device_program`` spans. A span with
``compile`` set is a program's first call. On the card that is the first
launch of a stacked shape: there is no XLA compile, so its "compile"
factor measures a first launch's warm-up (allocator, cuBLAS handles)
against the analytic compile time.

The ``learned`` section of a table holds the learned performance model's
log-linear regressors (``gordo_tpu_torch/perfmodel/`` fits and promotes
them). The evaluation side lives here, as in the JAX package
(``costmodel.py:113-141``, ``:303-340``, ``:448-486``): the feature
vector (:func:`learned_feature_vector`), ``CostTable.learned_predict``
inside the training corpus's domain box, and ``CostModel``'s learned
branch of each estimate. It answers only when ``GORDO_TPU_PERFMODEL`` is
on (read once, when a ``CostModel`` is made); off, or out of the domain,
every estimate is the analytic one, and a plan is byte-identical to one
costed with a table that has no such section.
"""

import json
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..models.spec import FeedForwardSpec, LSTMSpec, ModelSpec
from ..utils.env import env_bool

logger = logging.getLogger(__name__)

#: the calibrated table's file name, beside the trace it was fitted from
COST_TABLE_FILE = "cost_table.json"
#: the table's schema version; another one is refused
COST_TABLE_VERSION = 1

#: the learned performance model's switch (default off: the section is inert)
PERFMODEL_ENV = "GORDO_TPU_PERFMODEL"
#: the ``learned`` section's schema (``costmodel.py:51-78``): the fit side
#: (``perfmodel/``) and the evaluation here share this vocabulary
LEARNED_VERSION = 1
LEARNED_FEATURES: Tuple[str, ...] = ("log_flops_per_sample", "log_members", "log_rows", "log_epochs", "bf16",
                                     "int8")
LEARNED_TARGETS: Tuple[str, ...] = ("device_ms", "compile_ms", "hbm_bytes")
#: slack in log space around the corpus's per-feature [lo, hi] box: a
#: shape further out answers analytic
LEARNED_DOMAIN_SLACK = 1.6

#: Adam keeps params, grads and two moments a member
_OPTIMIZER_COPIES = 4
#: a training step: the forward and twice it backward
_TRAIN_FLOP_FACTOR = 3.0
#: resident weight bytes an element, by serving precision (int8 keeps an
#: f32 scale an output channel besides, :meth:`CostModel.serve_weight_bytes`)
PRECISION_WEIGHT_BYTES: Dict[str, int] = {"f32": 4, "bf16": 2, "int8": 1}
#: activation bytes an element, by precision (int8 serving computes in bf16)
PRECISION_COMPUTE_BYTES: Dict[str, int] = {"f32": 4, "bf16": 2, "int8": 2}
#: every accepted spelling of a precision
PRECISION_ALIASES: Dict[str, str] = {
    "f32": "f32", "fp32": "f32", "float32": "f32",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8", "i8": "int8", "w8": "int8",
}
#: a program's run time against f32's, by precision (f32 and the unlisted: 1.0)
DEFAULT_PRECISION_FACTORS: Dict[str, float] = {"bf16": 0.6, "int8": 0.55}


def perfmodel_enabled() -> bool:
    """The ``GORDO_TPU_PERFMODEL`` switch (default off)."""
    return env_bool(PERFMODEL_ENV, False)


def learned_feature_vector(flops_per_sample: float, members: int, rows: int, epochs: int = 1,
                           precision: Optional[str] = None) -> List[float]:
    """The :data:`LEARNED_FEATURES` vector of one program shape, the
    regressors' input on both the fit and the evaluation side.

    >>> [round(v, 3) for v in learned_feature_vector(100.0, 8, 512)]
    [4.615, 2.079, 6.238, 0.0, 0.0, 0.0]
    """
    prec = normalize_precision(precision)
    return [
        math.log(max(float(flops_per_sample), 0.0) + 1.0),
        math.log(max(int(members), 1)),
        math.log(max(int(rows), 1)),
        math.log(max(int(epochs), 1)),
        1.0 if prec == "bf16" else 0.0,
        1.0 if prec == "int8" else 0.0,
    ]


def normalize_precision(precision: Optional[str]) -> str:
    """The canonical name of a precision; unknown or empty costs as f32.

    >>> normalize_precision("bfloat16"), normalize_precision(None), normalize_precision("fp16")
    ('bf16', 'f32', 'f32')
    """
    if not precision:
        return "f32"
    return PRECISION_ALIASES.get(str(precision).strip().lower(), "f32")


def dtype_precision(compute_dtype: Optional[str]) -> str:
    """The precision of a spec's ``compute_dtype``: ``bf16`` for
    ``bfloat16``, else ``f32``."""
    return "bf16" if compute_dtype == "bfloat16" else "f32"


def compute_precision(spec: ModelSpec) -> str:
    """The precision a spec's training programs compute at."""
    return dtype_precision(getattr(spec, "compute_dtype", "float32"))


def spec_param_count(spec: ModelSpec) -> int:
    """Trainable parameters, from the spec's geometry (0: unknown).

    >>> spec_param_count(FeedForwardSpec(3, 3, (2,), ("tanh",)))
    17
    """
    if isinstance(spec, FeedForwardSpec):
        dims = (spec.n_features,) + tuple(spec.dims) + (spec.n_features_out,)
        return sum(d_in * d_out + d_out for d_in, d_out in zip(dims[:-1], dims[1:]))
    if isinstance(spec, LSTMSpec):
        total, d_in = 0, spec.n_features
        for d_h in spec.dims:
            total += 4 * (d_in * d_h + d_h * d_h + d_h)
            d_in = d_h
        return total + d_in * spec.n_features_out + spec.n_features_out
    return 0


def spec_flops_per_sample(spec: ModelSpec) -> float:
    """Forward FLOPs of one sample (an LSTM's: one window,
    ``lookback_window`` steps).

    >>> spec_flops_per_sample(FeedForwardSpec(3, 3, (2,), ("tanh",)))
    24.0
    """
    if isinstance(spec, FeedForwardSpec):
        dims = (spec.n_features,) + tuple(spec.dims) + (spec.n_features_out,)
        return float(sum(2 * d_in * d_out for d_in, d_out in zip(dims[:-1], dims[1:])))
    if isinstance(spec, LSTMSpec):
        per_step, d_in = 0.0, spec.n_features
        for d_h in spec.dims:
            per_step += 2.0 * 4 * (d_in + d_h) * d_h
            d_in = d_h
        return per_step * spec.lookback_window + 2.0 * d_in * spec.n_features_out
    return 2.0 * spec_param_count(spec)


def validate_learned_section(doc: object) -> Optional[dict]:
    """A usable ``learned`` section, or None (with one warning) for
    anything malformed (``costmodel.py:143-195``): a bad section never
    makes a table unusable."""
    if doc is None:
        return None
    try:
        if not isinstance(doc, dict):
            raise ValueError(f"learned section is {type(doc).__name__}, not dict")
        version = int(doc.get("version", 0))
        if version != LEARNED_VERSION:
            raise ValueError(f"learned section version {version} != supported {LEARNED_VERSION}")
        features = tuple(str(f) for f in (doc.get("features") or ()))
        if features != LEARNED_FEATURES:
            raise ValueError(f"learned feature vocabulary {features!r} != {LEARNED_FEATURES!r}")
        width = len(LEARNED_FEATURES)
        targets = doc.get("targets")
        if not isinstance(targets, dict):
            raise ValueError("learned section carries no targets map")
        for target, programs in targets.items():
            if target not in LEARNED_TARGETS:
                raise ValueError(f"unknown learned target {target!r}")
            if not isinstance(programs, dict):
                raise ValueError(f"target {target!r} is not a program map")
            for program, entry in programs.items():
                coef = [float(c) for c in entry["coef"]]
                lo = [float(v) for v in entry["lo"]]
                hi = [float(v) for v in entry["hi"]]
                if len(coef) != width + 1 or len(lo) != width or len(hi) != width:
                    raise ValueError(f"model {target}/{program} has wrong arity")
                if not all(math.isfinite(c) for c in coef):
                    raise ValueError(f"model {target}/{program} has non-finite coefficients")
        return doc
    except (TypeError, ValueError, KeyError) as exc:
        logger.warning("Ignoring unusable learned section in cost table (%s); falling back to the analytic model",
                       exc)
        return None


@dataclass
class CostTable:
    """The analytic model's constants and the correction factors
    :func:`calibrate` fits: ``run_factors`` and ``compile_factors`` by
    program (``fleet_fit``, ``fleet_windowed_fit``,
    ``fleet_segmented_fit``, ...; 1.0 when
    absent), ``precision_factors`` by precision, ``samples`` the spans
    behind each program's factors."""

    #: sustained training FLOP/s the analytic model divides by
    throughput: float = 2.0e9
    #: compile seconds: a floor a program, plus this much a FLOP of a sample
    compile_per_flop: float = 2.0e-7
    compile_floor_s: float = 0.35
    #: fixed seconds a program dispatch
    dispatch_s: float = 0.01
    run_factors: Dict[str, float] = field(default_factory=dict)
    compile_factors: Dict[str, float] = field(default_factory=dict)
    precision_factors: Dict[str, float] = field(default_factory=lambda: dict(DEFAULT_PRECISION_FACTORS))
    samples: Dict[str, int] = field(default_factory=dict)
    #: the learned regressors' section (:func:`validate_learned_section`),
    #: consulted only under ``GORDO_TPU_PERFMODEL``
    learned: Optional[dict] = None
    version: int = COST_TABLE_VERSION

    def precision_factor(self, precision: Optional[str]) -> float:
        return float(self.precision_factors.get(normalize_precision(precision), 1.0))

    def learned_entry(self, target: str, program: str) -> Optional[dict]:
        """The fitted model of ``(target, program)``, or None."""
        if not self.learned:
            return None
        return (self.learned.get("targets") or {}).get(target, {}).get(program)

    def learned_predict(self, target: str, program: str, features: Sequence[float]) -> Optional[float]:
        """``exp(intercept + coef . x)`` of the fitted model of ``(target,
        program)`` on a :func:`learned_feature_vector`, in the target's unit
        (ms or bytes). None when no model is fitted, the shape lies outside
        the corpus's box widened by :data:`LEARNED_DOMAIN_SLACK`, or the
        arithmetic misbehaves: the caller then answers analytic."""
        entry = self.learned_entry(target, program)
        if entry is None:
            return None
        try:
            for x, lo_i, hi_i in zip(features, entry["lo"], entry["hi"]):
                if not (lo_i - LEARNED_DOMAIN_SLACK <= x <= hi_i + LEARNED_DOMAIN_SLACK):
                    return None
            coef = entry["coef"]
            value = math.exp(float(coef[0]) + sum(float(c) * float(x) for c, x in zip(coef[1:], features)))
        except (TypeError, ValueError, KeyError, IndexError, OverflowError):
            return None
        if not math.isfinite(value) or value < 0.0:
            return None
        return value

    def to_dict(self) -> dict:
        doc = {
            "version": self.version,
            "throughput": self.throughput,
            "compile_per_flop": self.compile_per_flop,
            "compile_floor_s": self.compile_floor_s,
            "dispatch_s": self.dispatch_s,
            "run_factors": dict(sorted(self.run_factors.items())),
            "compile_factors": dict(sorted(self.compile_factors.items())),
            "precision_factors": dict(sorted(self.precision_factors.items())),
            "samples": dict(sorted(self.samples.items())),
        }
        if self.learned is not None:
            doc["learned"] = self.learned
        return doc

    @classmethod
    def from_dict(cls, doc: dict) -> "CostTable":
        """A table from its document; ``ValueError`` for another version."""
        version = int(doc.get("version", 0))
        if version != COST_TABLE_VERSION:
            raise ValueError(f"cost table version {version} != supported {COST_TABLE_VERSION}; re-run calibration")
        return cls(
            throughput=float(doc.get("throughput", cls.throughput)),
            compile_per_flop=float(doc.get("compile_per_flop", cls.compile_per_flop)),
            compile_floor_s=float(doc.get("compile_floor_s", cls.compile_floor_s)),
            dispatch_s=float(doc.get("dispatch_s", cls.dispatch_s)),
            run_factors={str(k): float(v) for k, v in (doc.get("run_factors") or {}).items()},
            compile_factors={str(k): float(v) for k, v in (doc.get("compile_factors") or {}).items()},
            # a table without the map loads with the defaults
            precision_factors={str(k): float(v)
                               for k, v in (doc.get("precision_factors") or DEFAULT_PRECISION_FACTORS).items()},
            samples={str(k): int(v) for k, v in (doc.get("samples") or {}).items()},
            learned=validate_learned_section(doc.get("learned")),
            version=version,
        )

    def save(self, path: str) -> None:
        """Write the table atomically (a temporary file, then a rename)."""
        payload = json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CostTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @property
    def calibrated(self) -> bool:
        return bool(self.run_factors or self.compile_factors)

    @property
    def has_learned(self) -> bool:
        return bool(self.learned and (self.learned.get("targets") or {}))


def load_table_safe(path: Optional[str]) -> CostTable:
    """The table at ``path``, never raising: a missing, torn or
    mis-versioned file warns and answers the analytic defaults."""
    if not path:
        return CostTable()
    try:
        return CostTable.load(path)
    except (OSError, ValueError, TypeError, KeyError) as exc:
        logger.warning("Unusable cost table %s (%s); using the analytic defaults", path, exc)
        return CostTable()


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


class CostModel:
    """Bucket estimates against a :class:`CostTable` (default: the
    analytic one) for the trainer's ``mesh_shape``, ``(model axis, data
    axis)`` (default one card, ``(1, 1)``). ``use_learned`` (default
    ``GORDO_TPU_PERFMODEL``) is resolved once, here: one model answers
    with one ruler for its whole life."""

    def __init__(self, table: Optional[CostTable] = None, mesh_shape: Tuple[int, int] = (1, 1),
                 use_learned: Optional[bool] = None):
        self.table = table or CostTable()
        self.mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1] or 1))
        self.use_learned = perfmodel_enabled() if use_learned is None else bool(use_learned)

    def _learned(self, target: str, program: str, spec: ModelSpec, members: int, rows: int, epochs: int = 1,
                 precision: Optional[str] = None) -> Optional[float]:
        """The learned prediction of one shape, or None: answer analytic."""
        if not self.use_learned:
            return None
        return self.table.learned_predict(
            target, program, learned_feature_vector(spec_flops_per_sample(spec), members, rows, epochs, precision))

    def stacked_shape(self, m: int, n_padded: int, batch_size: int) -> Tuple[int, int]:
        """``(m_total, n_total)`` as JAX's trainer stacks them: the members
        rounded up to a multiple of the model axis, the samples to whole
        batches that also divide across the data axis.

        >>> CostModel().stacked_shape(3, 1000, 32), CostModel(mesh_shape=(2, 3)).stacked_shape(3, 1000, 32)
        ((3, 1024), (4, 1056))
        """
        model_axis, data_axis = self.mesh_shape
        return _round_up(m, model_axis), _round_up(n_padded, math.lcm(batch_size, data_axis))

    def stacked_windowed_shape(self, m: int, n_padded: int, offset: int, batch_size: int) -> Tuple[int, int, int]:
        """``(m_total, series_rows, windows_total)``: the members as in
        :meth:`stacked_shape`, the series at ``n_padded``, the windows
        rounded as the samples are."""
        model_axis, data_axis = self.mesh_shape
        return (_round_up(m, model_axis), n_padded,
                _round_up(n_padded - offset, math.lcm(batch_size, data_axis)))

    def train_flops(self, spec: ModelSpec, m: int, n: int, epochs: int) -> float:
        return _TRAIN_FLOP_FACTOR * spec_flops_per_sample(spec) * float(m) * float(n) * float(max(epochs, 1))

    def predict_run_s(self, program: str, spec: ModelSpec, m_total: int, n_total: int, epochs: int,
                      precision: Optional[str] = None) -> float:
        """The run time of one training program, seconds: the analytic
        time corrected by the program's and the precision's factors."""
        if precision is None:
            precision = compute_precision(spec)
        learned = self._learned("device_ms", program, spec, m_total, n_total, epochs, precision)
        if learned is not None:
            return learned / 1000.0
        factor = self.table.run_factors.get(program, 1.0) * self.table.precision_factor(precision)
        return factor * (self.train_flops(spec, m_total, n_total, epochs) / self.table.throughput) + \
            self.table.dispatch_s

    def predict_compile_s(self, program: str, spec: ModelSpec) -> float:
        """The compile time of one program, seconds (on the card: its
        first launch's warm-up, once calibrated). The learned model keys it
        on the spec alone: the shape axes pinned to 1."""
        learned = self._learned("compile_ms", program, spec, 1, 1)
        if learned is not None:
            return learned / 1000.0
        factor = self.table.compile_factors.get(program, 1.0)
        return factor * (self.table.compile_floor_s + self.table.compile_per_flop * spec_flops_per_sample(spec))

    def predict_hbm_bytes(self, spec: ModelSpec, m_total: int, n_total: int, batch_size: int,
                          y_aliased: bool = True, series_rows: Optional[int] = None,
                          precision: Optional[str] = None) -> int:
        """Resident bytes of one training program: staged data, params in
        their optimizer copies, one batch of activations (a windowed
        program holds its series)."""
        if precision is None:
            precision = compute_precision(spec)
        learned = self._learned("hbm_bytes", "fleet_windowed_fit" if series_rows is not None else "fleet_fit", spec,
                                m_total, n_total, 1, precision)
        if learned is not None:
            return int(learned)
        f_in = getattr(spec, "n_features", 1)
        f_out = getattr(spec, "n_features_out", f_in)
        if series_rows is not None:
            data = m_total * series_rows * f_in + m_total * n_total * f_out
        else:
            data = m_total * n_total * f_in + (0 if y_aliased else m_total * n_total * f_out)
        data += 3 * m_total * n_total
        params = spec_param_count(spec) * m_total * _OPTIMIZER_COPIES
        width = max([f_in, f_out, *getattr(spec, "dims", ())] or [1])
        activations = (m_total * batch_size * width * (len(getattr(spec, "dims", ())) + 2)
                       * getattr(spec, "lookback_window", 1))
        compute_bytes = PRECISION_COMPUTE_BYTES.get(normalize_precision(precision), 4)
        return int(4 * (data + params) + compute_bytes * activations)

    def serve_weight_bytes(self, spec: ModelSpec, members: int, precision: str = "f32") -> int:
        """Resident weight bytes of a serving bucket of ``members`` at a
        precision: bf16 halves them, int8 quarters them and adds an f32
        scale an output channel a member.

        >>> CostModel().serve_weight_bytes(FeedForwardSpec(3, 3, (2,), ("tanh",)), 2, "int8")
        74
        """
        precision = normalize_precision(precision)
        scales = 0
        if precision == "int8":
            dims = tuple(getattr(spec, "dims", ())) + (getattr(spec, "n_features_out", 1),)
            scales = 4 * members * sum(dims)
        return int(PRECISION_WEIGHT_BYTES.get(precision, 4) * spec_param_count(spec) * members + scales)

    def predict_serve_hbm_bytes(self, spec: ModelSpec, members: int, rows: int, precision: str = "f32") -> int:
        """Resident bytes of one fused serving batch: the weight bucket, the
        rows at the compute width and the f32 output (the learned model's
        ``hbm_bytes`` of ``fleet_forward`` in its domain)."""
        precision = normalize_precision(precision)
        learned = self._learned("hbm_bytes", "fleet_forward", spec, members, rows, 1, precision)
        if learned is not None:
            return int(learned)
        f_in = getattr(spec, "n_features", 1)
        f_out = getattr(spec, "n_features_out", f_in)
        payload = PRECISION_COMPUTE_BYTES.get(precision, 4) * members * rows * f_in
        return self.serve_weight_bytes(spec, members, precision) + payload + 4 * members * rows * f_out

    def predict_serve_step_s(self, spec: ModelSpec, members: int, rows: int, precision: str = "f32") -> float:
        """The seconds of one fused serving forward of ``members`` x
        ``rows`` rows (no training factor): what the engine's batch spans
        and the stream's flush spans carry as ``predicted_device_ms``
        beside the measured time.

        >>> round(CostModel().predict_serve_step_s(FeedForwardSpec(3, 3, (2,), ("tanh",)), 2, 100), 7)
        0.0100024
        """
        learned = self._learned("device_ms", "fleet_forward", spec, members, rows, 1, precision)
        if learned is not None:
            return learned / 1000.0
        flops = spec_flops_per_sample(spec) * float(members) * float(rows)
        factor = self.table.run_factors.get("fleet_forward", 1.0) * self.table.precision_factor(precision)
        return factor * (flops / self.table.throughput) + self.table.dispatch_s


def calibrate(trace_path: str, table: Optional[CostTable] = None) -> CostTable:
    """
    A table fitted to a ``build_trace.jsonl``: each program's run and
    compile factor is the median of actual / analytic seconds over the
    trace's ``device_program`` spans that carry the cost model's features
    (``flops_per_sample``, ``stacked_members`` or ``members``,
    ``stacked_samples``, ``epochs``). A span's seconds are its
    ``device_ms`` when it has one (a zero one is a broken sample and is
    skipped), else its ``duration_ms``. A span with ``compile`` set is a
    compile sample: the analytic run time comes off its seconds first.
    ``table`` (default the analytic one) gives the constants the factors
    correct; torn lines are skipped.
    """
    base = table or CostTable()
    run_ratios: Dict[str, list] = {}
    compile_ratios: Dict[str, list] = {}
    counts: Dict[str, int] = {}
    for span in _iter_spans(trace_path):
        if span.get("name") != "device_program":
            continue
        attrs = span.get("attributes") or {}
        program = str(attrs.get("program", ""))
        flops_per_sample = attrs.get("flops_per_sample")
        if not program or flops_per_sample is None:
            continue
        try:
            m = int(attrs.get("stacked_members") or attrs.get("members") or 0)
            n = int(attrs.get("stacked_samples") or 0)
            epochs = int(attrs.get("epochs") or 1)
            device_ms = attrs.get("device_ms")
            if device_ms is not None:
                seconds = float(device_ms) / 1000.0
            else:
                seconds = float(span.get("duration_ms") or 0.0) / 1000.0
            flops_per_sample = float(flops_per_sample)
        except (TypeError, ValueError):
            continue
        if m <= 0 or n <= 0 or seconds <= 0.0:
            continue
        counts[program] = counts.get(program, 0) + 1
        flops = _TRAIN_FLOP_FACTOR * flops_per_sample * m * n * max(epochs, 1)
        analytic_run = flops / base.throughput + base.dispatch_s
        if attrs.get("compile"):
            analytic_compile = base.compile_floor_s + base.compile_per_flop * flops_per_sample
            compile_ratios.setdefault(program, []).append(max(seconds - analytic_run, 1e-3) / analytic_compile)
        else:
            run_ratios.setdefault(program, []).append(seconds / analytic_run)

    def medians(ratios: Dict[str, list]) -> Dict[str, float]:
        return {program: round(sorted(values)[len(values) // 2], 6) for program, values in ratios.items()}

    calibrated = CostTable(
        throughput=base.throughput,
        compile_per_flop=base.compile_per_flop,
        compile_floor_s=base.compile_floor_s,
        dispatch_s=base.dispatch_s,
        run_factors=medians(run_ratios),
        compile_factors=medians(compile_ratios),
        samples=counts,
    )
    logger.info("Calibrated cost table from %s: %d program kind(s), %d span(s)", trace_path, len(counts),
                sum(counts.values()))
    return calibrated


def _iter_spans(trace_path: str) -> Iterable[dict]:
    """The trace's JSON objects, a line each; torn lines (a killed
    build's tail) are skipped."""
    with open(trace_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict):
                yield doc
