"""
The optimizers of ``OptimizerSpec.to_optax`` (``gordo_tpu/models/spec.py``)
over stacked fleet params, written out in torch.

A fleet bucket trains M members as one program: every parameter leaf
carries a leading member axis, and each member keeps its own optimizer
step count. ``torch.optim`` has one scalar step, and cannot leave one
member of a tensor unmoved, so the port writes optax's update rules out
by hand. :meth:`StackedOptimizer.step` takes a per-member ``mask[M]``:
where it is False the member's params, moments and step count all stay
as they were (an all-padding batch, or a member early stopping has
frozen), as the JAX program's ``tree_where`` leaves them
(``gordo_tpu/models/training.py:295-303``). The packed fit's optional
``count_mask`` lets a pack of members share one step count, as optax's
scalar count is shared by the JAX package's block-diagonal pack
(``gordo_tpu/models/packing.py:270-292``).

Each rule follows the installed optax's arithmetic in the same order,
Keras' defaults where the spec names none:

- ``adam``: ``scale_by_adam`` then ``-lr``; eps 1e-7 (torch's is 1e-8);
- ``adamw``: ``adam`` with ``weight_decay * p`` added before ``-lr``
  (decoupled decay, default 1e-4);
- ``sgd``: optax's ``trace`` (``t = g + momentum * t``; nesterov adds
  ``momentum * t`` once more) then ``-lr``;
- ``rmsprop``: ``g * rsqrt(nu + eps)`` (eps inside the square root,
  optax's ``eps_in_sqrt=True``; torch adds it outside), ``-lr``, then a
  ``trace`` of ``momentum``.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from .spec import OptimizerSpec


@dataclass
class OptimizerState:
    """Per-member step counts ``[M]`` (int32) and per-leaf moment slots."""

    count: torch.Tensor
    slots: Dict[str, List[torch.Tensor]] = field(default_factory=dict)


def _member_view(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``mask[M]`` shaped to broadcast against a stacked leaf ``[M, ...]``."""
    return mask.view((-1,) + (1,) * (leaf.dim() - 1))


class StackedOptimizer:
    """One of optax's optimizers over stacked params (leading member axis)."""

    _SLOTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": ("trace",), "rmsprop": ("nu", "trace")}

    def __init__(self, spec: OptimizerSpec):
        self.name = spec.name.lower()
        if self.name not in self._SLOTS:
            raise ValueError(f"Unsupported optimizer {spec.name!r}")
        kwargs = dict(spec.kwargs)
        self.lr = spec.learning_rate
        self.b1 = kwargs.get("beta_1", 0.9)
        self.b2 = kwargs.get("beta_2", 0.999)
        self.eps = kwargs.get("epsilon", 1e-7)
        self.weight_decay = kwargs.get("weight_decay", 1e-4)
        self.momentum = kwargs.get("momentum", 0.0)
        self.nesterov = bool(kwargs.get("nesterov", False))
        self.rho = kwargs.get("rho", 0.9)

    def init(self, params: Sequence[torch.Tensor]) -> OptimizerState:
        """Zero moments and step counts for stacked ``params``."""
        members = params[0].shape[0]
        return OptimizerState(
            count=torch.zeros(members, dtype=torch.int32, device=params[0].device),
            slots={
                name: [torch.zeros_like(p, dtype=torch.float32) for p in params]
                for name in self._SLOTS[self.name]
            },
        )

    @torch.no_grad()
    def step(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: OptimizerState,
        mask: torch.Tensor,
        count_mask: Optional[torch.Tensor] = None,
    ) -> None:
        """Update ``params`` and ``state`` in place for the members where
        ``mask[M]`` is True; the others keep params, moments and count.
        With ``count_mask[M]`` the step counts advance where it is True
        instead: a pack of the packed fit shares one count, which moves
        when any member of the pack has data (``models/packing.py``)."""
        count = state.count + 1
        if self.name in ("adam", "adamw"):
            # optax's bias_correction: 1 - decay ** count, in f32
            c1 = 1 - torch.pow(self.b1, count.to(torch.float32))
            c2 = 1 - torch.pow(self.b2, count.to(torch.float32))
        for i, (p, g) in enumerate(zip(params, grads)):
            keep = _member_view(mask, p)
            new_slots = {}
            if self.name in ("adam", "adamw"):
                mu = (1 - self.b1) * g + self.b1 * state.slots["mu"][i]
                nu = (1 - self.b2) * (g * g) + self.b2 * state.slots["nu"][i]
                mu_hat = mu / _member_view(c1, p)
                nu_hat = nu / _member_view(c2, p)
                update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
                if self.name == "adamw":
                    update = update + self.weight_decay * p
                update = update * -self.lr
                new_slots = {"mu": mu, "nu": nu}
            elif self.name == "sgd":
                trace = g + self.momentum * state.slots["trace"][i]
                update = g + self.momentum * trace if self.nesterov else trace
                update = update * -self.lr
                new_slots = {"trace": trace}
            else:  # rmsprop
                nu = (1 - self.rho) * (g * g) + self.rho * state.slots["nu"][i]
                update = (torch.rsqrt(nu + self.eps) * g) * -self.lr
                trace = update + self.momentum * state.slots["trace"][i]
                update = update + self.momentum * trace if self.nesterov else trace
                new_slots = {"nu": nu, "trace": trace}
            p.copy_(torch.where(keep, p + update, p))
            for name, value in new_slots.items():
                slot = state.slots[name][i]
                slot.copy_(torch.where(keep, value, slot))
        state.count = torch.where(mask if count_mask is None else count_mask, count, state.count)
