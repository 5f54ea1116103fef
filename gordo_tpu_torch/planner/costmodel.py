"""
The analytic bucket cost model of ``gordo_tpu/planner/costmodel.py``
(``spec_param_count``, ``spec_flops_per_sample``, ``compute_precision``,
``CostTable``'s constants, ``CostModel``'s shape and estimate methods,
``:205-295``, ``:439-676``), which prices each bucket of a build's
``fleet_plan.json`` and each serving batch and stream flush.

The constants are the JAX package's uncalibrated defaults, copied as they
are so that a naive plan, and its hash, equal the JAX build's on the same
config: a sustained 2.0e9 FLOP/s, 0.35 s plus 2.0e-7 s a FLOP of a sample
to compile a program, 0.01 s to dispatch one, a bf16 program at 0.6 of an
f32 one's run time. They were chosen to rank buckets against each other
on a CPU; they are neither a TPU's times nor the card's, and a plan's
``predicted_wall_s`` is this model's prediction, not a measurement. The
port plans for one card, the JAX trainer's ``(1, 1)`` mesh. Not ported:
the correction factors that ``calibrate`` fits and ``--cost-table`` loads
(``ROADMAP.md`` item 7), and the learned section (``GORDO_TPU_PERFMODEL``,
item 13).
"""

from typing import Optional, Tuple

from ..models.spec import FeedForwardSpec, LSTMSpec, ModelSpec

#: the cost table version a plan records
COST_TABLE_VERSION = 1
#: sustained training FLOP/s the analytic model divides by
THROUGHPUT = 2.0e9
#: compile seconds: a floor a program, plus this much a FLOP of a sample
COMPILE_FLOOR_S = 0.35
COMPILE_PER_FLOP = 2.0e-7
#: fixed seconds a program dispatch
DISPATCH_S = 0.01
#: run time against f32's, and activation bytes an element, by precision
PRECISION_RUN_FACTORS = {"f32": 1.0, "bf16": 0.6}
#: a serving forward's run time against f32's (the JAX table's defaults)
SERVE_PRECISION_FACTORS = {"f32": 1.0, "bf16": 0.6, "int8": 0.55}
PRECISION_COMPUTE_BYTES = {"f32": 4, "bf16": 2}
#: Adam keeps params, grads and two moments a member
_OPTIMIZER_COPIES = 4
#: a training step: the forward and twice it backward
_TRAIN_FLOP_FACTOR = 3.0


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


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


class CostModel:
    """Bucket estimates of the analytic model for one card."""

    def stacked_shape(self, m: int, n_padded: int, batch_size: int) -> Tuple[int, int]:
        """``(m_total, n_total)``: the members, the samples rounded up to
        whole batches.

        >>> CostModel().stacked_shape(3, 1000, 32)
        (3, 1024)
        """
        return m, _round_up(n_padded, batch_size)

    def stacked_windowed_shape(self, m: int, n_padded: int, offset: int, batch_size: int) -> Tuple[int, int, int]:
        """``(m_total, series_rows, windows_total)``: the series stays at
        ``n_padded``, the windows round up to whole batches."""
        return m, n_padded, _round_up(n_padded - offset, batch_size)

    def train_flops(self, spec: ModelSpec, m: int, n: int, epochs: int) -> float:
        return _TRAIN_FLOP_FACTOR * spec_flops_per_sample(spec) * float(m) * float(n) * float(max(epochs, 1))

    def predict_run_s(self, program: str, spec: ModelSpec, m_total: int, n_total: int, epochs: int) -> float:
        """The analytic run time of one training program, seconds."""
        factor = PRECISION_RUN_FACTORS[compute_precision(spec)]
        return factor * (self.train_flops(spec, m_total, n_total, epochs) / THROUGHPUT) + DISPATCH_S

    def predict_compile_s(self, program: str, spec: ModelSpec) -> float:
        """The analytic compile time of one program, seconds."""
        return COMPILE_FLOOR_S + COMPILE_PER_FLOP * spec_flops_per_sample(spec)

    def predict_hbm_bytes(self, spec: ModelSpec, m_total: int, n_total: int, batch_size: int,
                          y_aliased: bool = True, series_rows: Optional[int] = None) -> int:
        """Resident bytes of one training program: staged data, params in
        their optimizer copies, one batch of activations (a windowed
        program holds its series)."""
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
        return int(4 * (data + params) + PRECISION_COMPUTE_BYTES[compute_precision(spec)] * activations)

    def predict_serve_step_s(self, spec: ModelSpec, members: int, rows: int, precision: str = "f32") -> float:
        """The analytic seconds of one fused serving forward of ``members``
        x ``rows`` rows (no training factor): what the engine's batch spans
        and the stream's flush spans carry as ``predicted_device_ms``
        beside the measured time.

        >>> round(CostModel().predict_serve_step_s(FeedForwardSpec(3, 3, (2,), ("tanh",)), 2, 100), 7)
        0.0100024
        """
        flops = spec_flops_per_sample(spec) * float(members) * float(rows)
        return SERVE_PRECISION_FACTORS.get(precision, 1.0) * (flops / THROUGHPUT) + DISPATCH_S
