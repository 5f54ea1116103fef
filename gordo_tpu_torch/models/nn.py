"""
Feedforward init and forward as plain functions over parameter dicts.

The parameter layout is the JAX package's (``gordo_tpu/models/nn.py``):
``{"dense_i": {"W": [d_in, d_out], "b": [d_out]}, ..., "out": {...}}``,
float32. A pickled artifact therefore carries the same arrays to both
packages, and :func:`params_from_jax` is only a type conversion.

:func:`forward_feedforward` is the plain forward of one model. Serving
never calls it: the fleet store runs every forward through
:func:`gordo_tpu_torch.ops.fleet_dense.fleet_feedforward`.
:func:`forward_feedforward_stacked` is the training forward of a whole
stacked bucket, under autograd.
"""

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.activations import resolve_activation
from .spec import FeedForwardSpec

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
        fan_in, fan_out = widths[i], widths[i + 1]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        W = torch.empty(fan_in, fan_out, dtype=torch.float32)
        W.uniform_(-limit, limit, generator=generator)
        params[key] = {
            "W": W.to(device),
            "b": torch.zeros(fan_out, dtype=torch.float32, device=device),
        }
    return params


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


def params_from_jax(params: Mapping[str, Mapping[str, Any]], device: Any = "cpu") -> Params:
    """The JAX package's parameter dict (numpy or array-like leaves) as the
    port's float32 tensors on ``device``, same keys."""
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
