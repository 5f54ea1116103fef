"""
Activation-name resolution: Keras-style names to torch functions, and to
the integer codes the fleet dense kernel switches on.

Each function matches its ``jax.nn`` counterpart in the JAX package
(``gordo_tpu/ops/activations.py``): ``gelu`` is the tanh approximation
(``jax.nn.gelu`` defaults to ``approximate=True``), ``hard_sigmoid`` is
``relu6(x + 3) / 6``, ``leaky_relu`` has slope 0.01, ``elu``/``selu`` use
JAX's constants, ``softplus`` is ``logaddexp(x, 0)`` (no linear cut-off),
and ``softmax`` runs over the last axis.

The codes are the kernel's ABI: ``ops/csrc/fleet_dense.cu`` holds the
same table in its ``Act`` enum, so append new names, never renumber.
"""

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _linear(x: torch.Tensor) -> torch.Tensor:
    return x


def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


#: name -> torch function; the insertion order is the kernel's enum
_TABLE: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": _linear,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": _hard_sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": _softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "silu": F.silu,
    "gelu": _gelu,
    "leaky_relu": _leaky_relu,
    "relu6": F.relu6,
    "exponential": torch.exp,
    "softmax": _softmax,
}

#: name -> integer code of ``fleet_dense.cu``'s ``Act`` enum
ACTIVATION_CODES: Dict[str, int] = {name: i for i, name in enumerate(_TABLE)}

ACTIVATION_NAMES = tuple(_TABLE)


def _unknown(activation: str) -> ValueError:
    return ValueError(
        f"Unknown activation {activation!r}; known: {sorted(_TABLE)}"
    )


def resolve_activation(activation: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """
    The torch function for a Keras-style activation name.

    >>> resolve_activation("tanh") is torch.tanh
    True
    """
    try:
        return _TABLE[activation]
    except KeyError:
        raise _unknown(activation) from None


def activation_code(activation: str) -> int:
    """The kernel's integer code for an activation name.

    >>> activation_code("linear"), activation_code("softmax")
    (0, 15)
    """
    try:
        return ACTIVATION_CODES[activation]
    except KeyError:
        raise _unknown(activation) from None
