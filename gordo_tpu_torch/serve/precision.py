"""
The serving precision ladder, a copy of ``gordo_tpu/serve/precision.py``:
bf16 and int8 forwards of a spec bucket behind a precision-parity gate.

- the vocabulary (:data:`PRECISIONS`, :func:`normalize`) and its
  resolution order: a spec's own ``precision`` field, else the
  ``GORDO_TPU_SERVE_PRECISION`` knob, else ``f32`` (the default, the K1
  path unchanged);
- casting (:func:`cast_bucket_params`): a bucket's f32 params cast once
  to bf16, or quantized once to int8 per member and output channel; the
  store keeps the result for the bucket's membership;
- the reduced forwards (:func:`forward_feedforward_bf16`,
  :func:`forward_feedforward_quantized`): plain PyTorch ``bmm`` over the
  gathered members in bf16, output float32. The JAX package runs them on
  XLA, not in its Pallas kernel (``gordo_tpu/server/fleet_store.py:713-721``),
  so the port has no hand kernel for them either;
- the parity gate (:func:`evaluate_parity`, :class:`PrecisionGovernor`):
  a reduced bucket serves only after its anomaly verdicts agree with f32
  on a seeded probe window; a failed gate serves f32 (logged, never an
  error). The agreement math (:func:`recon_agreement`,
  :func:`verdict_agreement`) is the JAX package's.

Dtype contract, as there: weights and activations at the serving
precision, output float32 at every precision. The JAX engine stages a
reduced request's rows as ``ml_dtypes.bfloat16`` on the host; the port
stages float32 and casts on the card (both round to nearest even, so the
bf16 values are the same), and :func:`payload_dtype` answers the torch
dtype the forward casts its input rows to.

Under ``GORDO_TPU_PERFMODEL_PRECISION`` the learned performance model may
nominate the rung it measured fastest (:func:`model_preferred`), which
then rides the gate and the degrade set as a configured rung does.
"""

import logging
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.activations import resolve_activation
from ..planner.costmodel import PRECISION_ALIASES, learned_feature_vector, spec_flops_per_sample
from ..utils.env import env_bool, env_float, env_int, env_str

logger = logging.getLogger(__name__)

PRECISION_ENV = "GORDO_TPU_SERVE_PRECISION"
GATE_ENV = "GORDO_TPU_PRECISION_GATE"
PERFMODEL_PRECISION_ENV = "GORDO_TPU_PERFMODEL_PRECISION"

#: the ladder, widest first; f32 is the default and the degrade target.
#: int8 is per-channel weight-only quantization (activations run bf16)
PRECISIONS: Tuple[str, ...] = ("f32", "bf16", "int8")

F32 = "f32"


#: raw values already warned about: a malformed knob warns once
_warned: set = set()


def normalize(value: Optional[str], default: str = F32) -> str:
    """The canonical name of ``value`` (``float32`` is ``f32``); an unknown
    spelling warns once and answers ``default``.

    >>> normalize("bfloat16"), normalize(""), normalize("fp16")
    ('bf16', 'f32', 'f32')
    """
    if not value:
        return default
    name = PRECISION_ALIASES.get(str(value).strip().lower())
    if name is None:
        if value not in _warned:
            _warned.add(value)
            logger.warning("Unknown serving precision %r; using %r (known: %s)", value, default, "/".join(PRECISIONS))
        return default
    return name


def serve_precision() -> str:
    """The process default (``GORDO_TPU_SERVE_PRECISION``, default f32)."""
    return normalize(env_str(PRECISION_ENV, F32))


def resolve_precision(spec: Any, default: Optional[str] = None) -> str:
    """The precision ``spec`` serves at: its own ``precision`` field, else
    ``default`` (the engine's configured one, else the environment's)."""
    if default is None:
        default = serve_precision()
    declared = getattr(spec, "precision", "")
    return normalize(declared, normalize(default)) if declared else normalize(default)


def gate_enabled() -> bool:
    """The parity gate's switch (``GORDO_TPU_PRECISION_GATE``, default on)."""
    return env_bool(GATE_ENV, True)


def model_preferred(spec: Any, members: int, rows: int, cost_model: Any) -> Optional[str]:
    """The rung the learned performance model predicts fastest for
    ``spec`` at ``members`` x ``rows``, or None to keep the configured
    resolution (``gordo_tpu/serve/precision.py:109-155``): off unless
    ``GORDO_TPU_PERFMODEL_PRECISION``; only from measured evidence (every
    rung needs an in-domain learned ``fleet_forward`` prediction: the
    analytic precision factors always favour reduced); a nomination of f32
    is None. Advisory: the winner still rides the gate and the degrade set."""
    if not env_bool(PERFMODEL_PRECISION_ENV, False):
        return None
    try:
        flops = spec_flops_per_sample(spec)
        best: Optional[Tuple[float, str]] = None
        for candidate in PRECISIONS:
            predicted = cost_model.table.learned_predict(
                "device_ms", "fleet_forward", learned_feature_vector(flops, members, rows, 1, candidate))
            if predicted is None:
                return None  # partial evidence: keep the configured rung
            if best is None or predicted < best[0]:
                best = (predicted, candidate)
        if best is None or best[1] == F32:
            return None
        return best[1]
    except Exception:  # noqa: BLE001 - advisory, never a gate
        return None


def payload_dtype(precision: str = F32) -> torch.dtype:
    """The dtype a forward at ``precision`` takes its input rows in:
    float32 at f32, bfloat16 at bf16 and int8 (whose activations run
    bf16). The rows cross to the card as float32 and are cast there.

    >>> payload_dtype("f32"), payload_dtype("int8")
    (torch.float32, torch.bfloat16)
    """
    return torch.float32 if normalize(precision) == F32 else torch.bfloat16


def cast_bucket_params(stacked: Dict[str, Dict[str, torch.Tensor]], precision: str):
    """One bucket's stacked f32 params at ``precision``. bf16 casts every
    leaf. int8 replaces each weight ``W[N, d_in, d_out]`` by a symmetric
    quantization per member and output channel, ``W ~ Wq * scale`` with
    ``scale = max |W| over d_in / 127`` (at least 1e-12, so a dead channel
    gives no 0/0) and ``Wq = clip(round(W / scale), -127, 127)`` as int8;
    biases stay f32. Unknown names raise (callers pass normalized ones)."""
    name = PRECISION_ALIASES.get(str(precision).strip().lower())
    if name is None:
        raise ValueError(f"unknown serving precision {precision!r}")
    if name == F32:
        return stacked
    if name == "bf16":
        return {key: {leaf: t.to(torch.bfloat16) for leaf, t in layer.items()} for key, layer in stacked.items()}
    quantized = {}
    for key, layer in stacked.items():
        W = layer["W"].to(torch.float32)
        scale = torch.clamp(W.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
        quantized[key] = {
            "W": torch.clamp(torch.round(W / scale), -127, 127).to(torch.int8),
            "scale": scale,
            "b": layer["b"].to(torch.float32),
        }
    return quantized


def forward_feedforward_bf16(spec: Any, params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """The bf16 forward of gathered members ``params`` (leading axis M, any
    dtype) on ``x[M, B, F]``: every leaf, the rows and each layer's
    ``h @ W + b`` in bf16, output float32 (the JAX package's
    ``forward_feedforward`` at ``compute_dtype=bfloat16``)."""
    h = x.to(torch.bfloat16)
    for key, act in spec.layer_names():
        layer = params[key]
        h = resolve_activation(act)(
            torch.bmm(h, layer["W"].to(torch.bfloat16)) + layer["b"].to(torch.bfloat16)[:, None, :]
        )
    return h.to(torch.float32)


def forward_feedforward_quantized(
    spec: Any, params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor
) -> torch.Tensor:
    """The int8 weight-quantized forward of gathered members: each weight
    dequantized as ``Wq * scale`` in bf16, activations bf16, output
    float32. Inference only: no activity penalty."""
    h = x.to(torch.bfloat16)
    for key, act in spec.layer_names():
        layer = params[key]
        W = layer["W"].to(torch.bfloat16) * layer["scale"].to(torch.bfloat16)
        h = resolve_activation(act)(torch.bmm(h, W) + layer["b"].to(torch.bfloat16)[:, None, :])
    return h.to(torch.float32)


# -- parity math ------------------------------------------------------------------


@dataclass
class ParityConfig:
    """The gate's knobs (``from_env`` reads them)."""

    #: least fraction of a member's probe rows whose verdicts agree
    agreement: float = 0.98
    #: closeness for members without a threshold: ``atol + rtol * |row|``
    rtol: float = 0.05
    atol: float = 0.01
    #: rows scored a member
    probe_rows: int = 128

    @classmethod
    def from_env(cls) -> "ParityConfig":
        return cls(
            agreement=env_float("GORDO_TPU_GATE_PRECISION_AGREEMENT", 0.98),
            rtol=env_float("GORDO_TPU_GATE_PRECISION_RTOL", 0.05),
            probe_rows=max(8, env_int("GORDO_TPU_GATE_PRECISION_PROBE_ROWS", 128)),
        )


def recon_agreement(recon_a: np.ndarray, recon_b: np.ndarray, rtol: float = 0.05, atol: float = 1e-3) -> Dict[str, Any]:
    """The fraction of rows of two reconstructions of the same input whose
    largest absolute difference is within ``atol + rtol * row magnitude``
    (leading axes flatten into rows)."""
    a = np.asarray(recon_a, np.float64)
    b = np.asarray(recon_b, np.float64)
    if a.shape != b.shape:
        return {"mode": "recon", "agreement": 0.0, "rows": 0, "detail": f"shape mismatch {a.shape} vs {b.shape}"}
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    a = a.reshape(-1, a.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    diff = np.abs(a - b).max(axis=-1)
    budget = atol + rtol * np.abs(a).max(axis=-1)
    rows = int(diff.shape[0])
    agree = int(np.count_nonzero(diff <= budget))
    return {
        "mode": "recon",
        "agreement": round(agree / rows, 6) if rows else 1.0,
        "rows": rows,
        "max_diff": round(float(diff.max()), 6) if rows else 0.0,
    }


def verdict_agreement(
    recon_a: np.ndarray,
    recon_b: np.ndarray,
    y: np.ndarray,
    scaler: Any = None,
    threshold: Optional[float] = None,
    rtol: float = 0.05,
    atol: float = 1e-3,
) -> Dict[str, Any]:
    """The fraction of rows whose anomaly verdict (the detector's scaled
    mse, in f64, against ``threshold``) is the same for both
    reconstructions; :func:`recon_agreement` when there is no scaler or
    threshold to take a verdict from."""
    if scaler is None or not threshold or threshold <= 0:
        return recon_agreement(recon_a, recon_b, rtol=rtol, atol=atol)
    try:
        scaled_y = np.asarray(scaler.transform(y), np.float64)
        scaled_a = np.asarray(scaler.transform(recon_a), np.float64)
        scaled_b = np.asarray(scaler.transform(recon_b), np.float64)
    except Exception:  # noqa: BLE001 - an unfitted scaler: judge closeness instead
        return recon_agreement(recon_a, recon_b, rtol=rtol, atol=atol)
    mse_a = np.mean(np.square(scaled_a - scaled_y), axis=1)
    mse_b = np.mean(np.square(scaled_b - scaled_y), axis=1)
    verdict_a = mse_a > threshold
    verdict_b = mse_b > threshold
    rows = int(len(mse_a))
    agree = int(np.count_nonzero(verdict_a == verdict_b))
    return {
        "mode": "verdict",
        "agreement": round(agree / rows, 6) if rows else 1.0,
        "rows": rows,
        "flagged_f32": int(np.count_nonzero(verdict_a)),
        "flagged_reduced": int(np.count_nonzero(verdict_b)),
    }


def _data_range(scaler: Any) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The range a fitted min-max scaler was fitted on (sklearn's
    ``data_min_``/``data_max_``), read back from ``scale_`` and ``min_``:
    ``X * scale_ + min_`` maps it onto ``feature_range``."""
    scale, offset = getattr(scaler, "scale_", None), getattr(scaler, "min_", None)
    if scale is None or offset is None:
        return None, None
    low, high = getattr(scaler, "feature_range", (0.0, 1.0))
    scale, offset = np.asarray(scale, np.float64), np.asarray(offset, np.float64)
    lo = (low - offset) / scale
    return lo, lo + (high - low) / scale


def _probe_rows(model: Any, n_features: int, rows: int, seed: int) -> np.ndarray:
    """A seeded probe window in model-input space: uniform inside the
    detector scaler's fitted range when there is one, else standard
    normal. Seeded per member, so the verdict does not depend on order."""
    rng = np.random.default_rng(seed)
    lo, hi = _data_range(getattr(model, "scaler", None))
    if lo is not None and len(lo) == n_features:
        span = np.where(hi > lo, hi - lo, 1.0)
        return (lo + rng.random((rows, n_features)) * span).astype(np.float32)
    return rng.standard_normal((rows, n_features)).astype(np.float32)


def evaluate_parity(fleet: Any, spec: Any, precision: str, config: Optional[ParityConfig] = None) -> Dict[str, Any]:
    """The gate for one revision's spec bucket: a seeded probe window a
    member, scored through the f32 bucket (K1 on the card) and the
    ``precision`` bucket, the path a served batch takes; every member's
    verdicts must agree on at least ``config.agreement`` of the rows.
    Returns a JSON-able report (``passed``, ``agreement_min``, ``members``,
    ``bucket_epoch``, ...)."""
    from ..server.fleet_store import fleet_forward_gather

    config = config or ParityConfig.from_env()
    precision = normalize(precision)
    report: Dict[str, Any] = {
        "precision": precision,
        "spec": type(spec).__name__,
        "n_features": getattr(spec, "n_features", None),
        "passed": True,
        "members": {},
    }
    if precision == F32:
        report["detail"] = "f32 is the reference; nothing to gate"
        return report
    # one membership for both buckets: a member loading between the two
    # reads would pair one member's f32 rows with another's reduced ones
    for _ in range(4):
        epoch = fleet.bucket_epoch
        names, stacked, ingest = fleet.serving_bucket(spec)
        cast_names, cast, _ = fleet.serving_bucket(spec, precision)
        if cast_names == names and fleet.bucket_epoch == epoch:
            break
    else:
        raise RuntimeError("bucket membership kept changing during parity evaluation")
    report["bucket_epoch"] = epoch
    rows = int(config.probe_rows)
    models = [fleet.model(name) for name in names]
    probes = [_probe_rows(model, spec.n_features, rows, seed=i + 1) for i, model in enumerate(models)]
    x = torch.from_numpy(np.stack(probes)).to(fleet.device)
    indices = list(range(len(names)))
    recon_f32 = fleet_forward_gather(spec, stacked, indices, x, ingest=ingest).cpu().numpy()
    recon_lp = fleet_forward_gather(spec, cast, indices, x, ingest=ingest, precision=precision).cpu().numpy()

    agreements = []
    for i, name in enumerate(names):
        threshold = getattr(models[i], "aggregate_threshold_", None)
        member = verdict_agreement(
            recon_f32[i], recon_lp[i], probes[i], scaler=getattr(models[i], "scaler", None),
            threshold=float(threshold) if threshold else None, rtol=config.rtol, atol=config.atol,
        )
        if not np.all(np.isfinite(recon_lp[i])):
            member["agreement"] = 0.0
            member["detail"] = "non-finite reduced-precision output"
        report["members"][name] = member
        agreements.append(member["agreement"])
    report["agreement_min"] = min(agreements) if agreements else 1.0
    report["agreement_threshold"] = config.agreement
    report["probe_rows"] = rows
    if report["agreement_min"] < config.agreement:
        report["passed"] = False
        worst = min(report["members"], key=lambda n: report["members"][n]["agreement"])
        report["detail"] = (
            f"{precision} verdicts diverge from f32: member {worst} agrees on "
            f"{report['members'][worst]['agreement']:.2%} of the probe window (gate {config.agreement:.2%})"
        )
    return report


class PrecisionGovernor:
    """The engine's precision arbiter: the first request of a (fleet,
    spec, precision) runs :func:`evaluate_parity` and records the verdict
    on the fleet; later ones read it. A failed gate serves f32."""

    def __init__(self):
        self._lock = threading.Lock()  # guards the lock registry
        #: (fleet id, spec, precision) -> the lock of its one evaluation, so
        #: gating one bucket never holds up another's first request
        self._evaluating: Dict[Tuple, threading.Lock] = {}

    def effective_precision(self, fleet: Any, spec: Any, desired: str, recorder: Any = None) -> str:
        desired = normalize(desired)
        if desired == F32:
            return F32
        if not gate_enabled():
            return desired
        state = fleet.precision_state(spec, desired)
        if state is None:
            key = (id(fleet), spec, desired)
            with self._lock:
                key_lock = self._evaluating.setdefault(key, threading.Lock())
            with key_lock:  # one evaluation a bucket, however many threads ask
                state = fleet.precision_state(spec, desired)
                if state is None:
                    state = self._evaluate(fleet, spec, desired, recorder)
            with self._lock:
                self._evaluating.pop(key, None)
        return desired if state.get("passed") else F32

    def _evaluate(self, fleet: Any, spec: Any, precision: str, recorder: Any = None) -> Dict[str, Any]:
        try:
            report = evaluate_parity(fleet, spec, precision)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:  # noqa: BLE001 - a gate that cannot run has failed
            report = {"precision": normalize(precision), "passed": False, "detail": f"parity evaluation crashed: {exc!r}"}
        # stamped with the membership it was taken at: a member loaded
        # meanwhile makes the verdict read as absent, and the bucket re-gates
        fleet.set_precision_state(spec, precision, report, epoch=report.get("bucket_epoch"))
        if report.get("passed"):
            logger.info(
                "precision gate PASSED: %s serving at %s (verdict agreement >= %.2f%% on %s members)",
                fleet.collection_dir, report["precision"], 100.0 * report.get("agreement_min", 1.0),
                len(report.get("members", {})),
            )
        else:
            logger.warning(
                "precision gate FAILED for %s at %s; serving f32: %s",
                fleet.collection_dir, report["precision"], report.get("detail", "verdict divergence"),
            )
        if recorder is not None:  # the verdict as a ``precision_gate`` event of the serving trace
            try:
                recorder.event("precision_gate", collection_dir=fleet.collection_dir, precision=report["precision"],
                               passed=bool(report.get("passed")), agreement_min=report.get("agreement_min"),
                               detail=report.get("detail", ""))
            except Exception:  # noqa: BLE001 - telemetry is advisory
                pass
        return report
