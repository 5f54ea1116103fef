"""
Loss functions over batches with sample weights, a copy of
``gordo_tpu/ops/losses.py`` in torch.

Per-sample losses reduce over the last axis only, so they take a stacked
fleet batch ``[M, B, F]`` as readily as one model's ``[B, F]``;
:func:`weighted_mean_loss` then reduces the sample axis, leaving one loss
per member.
"""

from typing import Callable

import torch


def _per_sample_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - target).mean(-1)


def _per_sample_mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean(-1)


_LOSSES = {
    "mse": _per_sample_mse,
    "mean_squared_error": _per_sample_mse,
    "mae": _per_sample_mae,
    "mean_absolute_error": _per_sample_mae,
}


def resolve_loss(name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """
    Per-sample loss function for a Keras-style loss name.

    >>> fn = resolve_loss("mse")
    >>> float(fn(torch.ones(1, 2), torch.zeros(1, 2))[0])
    1.0
    """
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; known: {sorted(_LOSSES)}") from None


def weighted_mean_loss(per_sample: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """
    Weighted mean of per-sample losses over the last axis; weights zero
    out padding rows. An all-zero weight vector yields NaN: "no data"
    must stay distinguishable from "zero loss" (a fleet member without
    validation rows would otherwise report a perfect val_loss of 0.0).

    >>> weighted_mean_loss(torch.tensor([[1.0, 3.0], [5.0, 7.0]]),
    ...                    torch.tensor([[1.0, 1.0], [0.0, 0.0]])).tolist()
    [2.0, nan]
    """
    total = weights.sum(-1)
    mean = (per_sample * weights).sum(-1) / total.clamp(min=1.0)
    return torch.where(total > 0, mean, torch.full_like(mean, float("nan")))
