"""
Feedforward and LSTM init and forward as plain functions over parameter
dicts.

The parameter layout is the JAX package's (``gordo_tpu/models/nn.py``),
float32: ``{"dense_i": {"W": [d_in, d_out], "b": [d_out]}, ..., "out":
{...}}`` for a feedforward network, ``{"lstm_i": {"Wx": [d_in, 4H], "Wh":
[H, 4H], "b": [4H]}, ..., "out": {"W", "b"}}`` for an LSTM (gates in the
order input, forget, candidate, output). A pickled artifact therefore
carries the same arrays to both packages, and :func:`params_from_jax` is
only a type conversion.

:func:`forward_feedforward` is the plain forward of one model. Serving
never calls it: the fleet store runs every feedforward forward through
:func:`gordo_tpu_torch.ops.fleet_dense.fleet_feedforward`.
:func:`forward_feedforward_stacked` is the training forward of a whole
stacked bucket, under autograd.

The LSTM runs as the JAX package writes it (``nn.py:133-194``), never
through ``torch.nn.LSTM``, which knows only tanh and carries two biases:
each layer's input projection is one product over every time step, then
a loop over time adds ``h @ Wh`` and applies the gates, the configured
activation on the candidate and on the cell output. Every LSTM function
here is stacked over a leading member axis (one ``baddbmm`` a product for
all members); :func:`forward_lstm` is the stacked forward of one member.
:func:`forward_lstm_windows` forwards a stacked bucket's series window
batch by window batch, the windows gathered on the series' device.
"""

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.activations import resolve_activation
from ..ops.windows import gather_windows
from .spec import FeedForwardSpec, LSTMSpec, ModelSpec

Params = Dict[str, Dict[str, torch.Tensor]]


def init_feedforward(
    spec: FeedForwardSpec,
    generator: torch.Generator,
    device: Any = "cpu",
) -> Params:
    """Glorot-uniform weights and zero biases, float32, drawn from
    ``generator`` (a CPU generator; tensors are moved to ``device``)."""
    params: Params = {}
    widths = spec.widths()
    for i, (key, _) in enumerate(spec.layer_names()):
        params[key] = {
            "W": _glorot(widths[i], widths[i + 1], generator).to(device),
            "b": torch.zeros(widths[i + 1], dtype=torch.float32, device=device),
        }
    return params


def _glorot(fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    """A Glorot-uniform ``[fan_in, fan_out]`` float32 matrix on the CPU."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(fan_in, fan_out, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def _orthogonal(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """An orthogonal ``[rows, cols]`` float32 matrix on the CPU, drawn as
    ``jax.nn.initializers.orthogonal`` draws one: the Q of a standard
    normal matrix's QR (the wider side first), its columns signed by R's
    diagonal, transposed back when ``rows < cols`` (orthonormal rows).

    >>> q = _orthogonal(3, 12, torch.Generator().manual_seed(0))
    >>> bool(torch.allclose(q @ q.T, torch.eye(3), atol=1e-6))
    True
    """
    tall = rows < cols
    A = torch.randn((cols, rows) if tall else (rows, cols), dtype=torch.float64, generator=generator)
    Q, R = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diagonal(R))
    return (Q.T if tall else Q).contiguous().to(torch.float32)


def init_lstm(spec: LSTMSpec, generator: torch.Generator, device: Any = "cpu") -> Params:
    """An LSTM's params, drawn from ``generator`` (a CPU generator; tensors
    are moved to ``device``) layer by layer as ``init_lstm`` of the JAX
    package draws them (``nn.py:107-130``): ``Wx`` Glorot-uniform, ``Wh``
    orthogonal, ``b`` zero but the forget gate's slice ``[H:2H]``, 1
    (Keras' ``unit_forget_bias``); a Glorot-uniform head with zero bias.
    The numbers are the port's own: JAX draws from threefry keys."""
    params: Params = {}
    in_dim = spec.n_features
    for i, units in enumerate(spec.dims):
        bias = torch.zeros(4 * units, dtype=torch.float32)
        bias[units:2 * units] = 1.0
        params[f"lstm_{i}"] = {
            "Wx": _glorot(in_dim, 4 * units, generator).to(device),
            "Wh": _orthogonal(units, 4 * units, generator).to(device),
            "b": bias.to(device),
        }
        in_dim = units
    params["out"] = {
        "W": _glorot(in_dim, spec.n_features_out, generator).to(device),
        "b": torch.zeros(spec.n_features_out, dtype=torch.float32, device=device),
    }
    return params


def init_params(spec: ModelSpec, generator: torch.Generator, device: Any = "cpu") -> Params:
    """The spec's own initialisation: :func:`init_lstm` or
    :func:`init_feedforward`."""
    if isinstance(spec, LSTMSpec):
        return init_lstm(spec, generator, device)
    return init_feedforward(spec, generator, device)


def param_keys(spec: ModelSpec) -> Tuple[Tuple[str, str], ...]:
    """Every ``(layer key, leaf name)`` of the spec's params, in forward
    order.

    >>> param_keys(LSTMSpec(3, 3, 4, (2,), ("tanh",)))
    (('lstm_0', 'Wx'), ('lstm_0', 'Wh'), ('lstm_0', 'b'), ('out', 'W'), ('out', 'b'))
    """
    keys = []
    for key, _ in spec.layer_names():
        leaves = ("Wx", "Wh", "b") if key.startswith("lstm_") else ("W", "b")
        keys += [(key, leaf) for leaf in leaves]
    return tuple(keys)


def forward_feedforward(
    spec: FeedForwardSpec, params: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Forward pass on ``x[batch, n_features]``: ``(output, activity_penalty)``.
    Compute runs in ``spec.compute_dtype``; the output and the summed L1
    activity penalty are float32 (the JAX package's dtype contract).
    """
    dtype = getattr(torch, spec.compute_dtype)
    penalty = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x.to(dtype)
    for i, (key, act) in enumerate(spec.layer_names()):
        layer = params[key]
        h = resolve_activation(act)(h @ layer["W"].to(dtype) + layer["b"].to(dtype))
        if key != "out" and spec.l1_activity and spec.l1_activity[i]:
            penalty = penalty + spec.l1_activity[i] * h.abs().sum(dtype=torch.float32)
    return h.to(torch.float32), penalty


def forward_feedforward_stacked(
    spec: FeedForwardSpec, stacked: Params, X: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    The training forward of a stacked fleet bucket, differentiable:
    ``X[M, B, n_features]`` through every member's layers at once (one
    ``baddbmm`` a layer), returning ``(output[M, B, n_features_out],
    penalty[M])``. ``penalty`` is each member's L1 activity term, the raw
    sum over its whole batch, padding rows included, as Keras and the JAX
    program add it (``gordo_tpu/models/training.py:263-268``). Compute
    runs in ``spec.compute_dtype``; output and penalty are float32.
    """
    dtype = getattr(torch, spec.compute_dtype)
    penalty = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    h = X.to(dtype)
    for i, (key, act) in enumerate(spec.layer_names()):
        layer = stacked[key]
        h = resolve_activation(act)(
            torch.baddbmm(layer["b"].to(dtype)[:, None, :], h, layer["W"].to(dtype))
        )
        if key != "out" and spec.l1_activity and spec.l1_activity[i]:
            # |h| with jnp.abs's gradient: 1 at h == 0, where torch's abs has
            # 0 (a zero-filled padding row meets zero-initialized biases)
            magnitude = torch.where(h >= 0, h, -h)
            penalty = penalty + spec.l1_activity[i] * magnitude.sum(dim=(1, 2), dtype=torch.float32)
    return h.to(torch.float32), penalty


def _lstm_layer_stacked(layer: Mapping[str, torch.Tensor], x_seq: torch.Tensor, activation: str) -> torch.Tensor:
    """One LSTM layer of every member over ``x_seq[M, T, B, F]`` (time
    major), returning the hidden sequence ``[M, T, B, H]``, in ``x_seq``'s
    dtype: the input projection of all ``T`` steps in one ``baddbmm``,
    then a loop over time of ``baddbmm(x_proj[t], h, Wh)`` and the gates."""
    act = resolve_activation(activation)
    dtype = x_seq.dtype
    Wx, Wh, b = (layer[name].to(dtype) for name in ("Wx", "Wh", "b"))
    M, T, B, F = x_seq.shape
    H = Wh.shape[-2]
    x_proj = torch.baddbmm(b[:, None, :], x_seq.reshape(M, T * B, F), Wx).view(M, T, B, 4 * H)
    h = x_seq.new_zeros(M, B, H)
    c = x_seq.new_zeros(M, B, H)
    hidden = []
    for t in range(T):
        gates = torch.baddbmm(x_proj[:, t], h, Wh)
        sig = torch.sigmoid(gates)  # i, f and o; the candidate's quarter is not read
        c = sig[..., H:2 * H] * c + sig[..., :H] * act(gates[..., 2 * H:3 * H])
        h = sig[..., 3 * H:] * act(c)
        hidden.append(h)
    return torch.stack(hidden, dim=1)


def forward_lstm_time_major(spec: LSTMSpec, stacked: Params, x_seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked LSTM forward on windows ``x_seq[M, T, B, F]`` (time
    major, as :func:`~gordo_tpu_torch.ops.windows.gather_windows` gathers
    them): ``(output[M, B, n_features_out], penalty[M])``, the head on the
    last step's hidden state; the penalty is 0 (an LSTM has no L1 term).
    Compute runs in ``spec.compute_dtype``; the output is float32."""
    dtype = getattr(torch, spec.compute_dtype)
    h = x_seq.to(dtype)
    for key, act in spec.layer_names()[:-1]:
        h = _lstm_layer_stacked(stacked[key], h, act)
    head = stacked["out"]
    out = torch.baddbmm(head["b"].to(dtype)[:, None, :], h[:, -1], head["W"].to(dtype))
    penalty = torch.zeros(x_seq.shape[0], dtype=torch.float32, device=x_seq.device)
    return resolve_activation(spec.out_activation)(out).to(torch.float32), penalty


def forward_lstm_sequence(spec: LSTMSpec, stacked: Params, x_seq: torch.Tensor) -> torch.Tensor:
    """The stacked LSTM over ``x_seq[M, T, G, F]`` (time major) with the
    head at every step: ``[M, T, G, n_features_out]``, the segmented fit's
    forward (``gordo_tpu/models/nn.py::forward_lstm_sequence``). The output
    at step ``t`` is the many-to-one output of the window ending at ``t``
    with its state warmed by the span's earlier steps. Compute runs in
    ``spec.compute_dtype``; the output is float32."""
    dtype = getattr(torch, spec.compute_dtype)
    h = x_seq.to(dtype)
    for key, act in spec.layer_names()[:-1]:
        h = _lstm_layer_stacked(stacked[key], h, act)
    M, T, G, H = h.shape
    head = stacked["out"]
    out = torch.baddbmm(head["b"].to(dtype)[:, None, :], h.reshape(M, T * G, H), head["W"].to(dtype))
    return resolve_activation(spec.out_activation)(out).to(torch.float32).view(M, T, G, -1)


def forward_lstm_stacked(spec: LSTMSpec, stacked: Params, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked LSTM forward on windows ``X[M, B, lookback, F]`` (the JAX
    package's ``[batch, lookback, F]`` a member): ``(output[M, B, F_out],
    penalty[M])``."""
    return forward_lstm_time_major(spec, stacked, X.transpose(1, 2))


def forward_lstm(spec: LSTMSpec, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One model's LSTM forward on windows ``x[batch, lookback, F]`` ->
    ``(output[batch, F_out], penalty 0)``, many to one."""
    single = {key: {name: t[None] for name, t in layer.items()} for key, layer in params.items()}
    out, penalty = forward_lstm_stacked(spec, single, x[None])
    return out[0], penalty[0]


def forward_stacked(spec: ModelSpec, stacked: Params, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked training forward of either kind of spec."""
    if isinstance(spec, LSTMSpec):
        return forward_lstm_stacked(spec, stacked, X)
    return forward_feedforward_stacked(spec, stacked, X)


@torch.no_grad()
def forward_lstm_windows(
    spec: LSTMSpec, stacked: Params, series: torch.Tensor, order: torch.Tensor, batch_size: int = 256
) -> torch.Tensor:
    """Forward the windows ``order[M, nv]`` (window starts) of each member's
    ``series[M, n, F]``: ``[M, nv, F_out]`` float32. The windows of one
    ``batch_size`` batch of starts are gathered on the series' device and
    forwarded together, so no more than a batch of windows exists at
    once (the JAX package's ``fleet_windowed_predict_program``)."""
    outs = [
        forward_lstm_time_major(
            spec, stacked, gather_windows(series, order[:, start:start + batch_size], spec.lookback_window)
        )[0]
        for start in range(0, order.shape[1], batch_size)
    ]
    return torch.cat(outs, dim=1)


def params_from_jax(params: Mapping[str, Mapping[str, Any]], device: Any = "cpu") -> Params:
    """The JAX package's parameter dict (numpy or array-like leaves;
    ``dense_i``/``out`` or ``lstm_i: {Wx, Wh, b}``/``out``) as the port's
    float32 tensors on ``device``, same keys."""
    return {
        key: {
            name: torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)
            for name, leaf in layer.items()
        }
        for key, layer in params.items()
    }


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Host float32 numpy copies of a parameter dict (the pickled form)."""
    return {
        key: {
            name: np.asarray(torch.as_tensor(leaf).detach().cpu(), np.float32)
            for name, leaf in layer.items()
        }
        for key, layer in params.items()
    }
