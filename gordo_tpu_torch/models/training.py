"""
The training engine of the port: a stacked fleet bucket + arrays ->
trained params + per-member history, the counterpart of
``gordo_tpu/models/training.py``'s ``build_raw_fit_fn`` and
``_make_fit_loop`` (``:137-339``) under ``jax.vmap``.

JAX compiles one program per (spec, fit config) and vmaps it over the
member axis. Here the member axis is written out: every parameter leaf
is ``[M, ...]``, the forward is one ``baddbmm`` a layer for all members
(``nn.forward_feedforward_stacked``), and the optimizer
(``optim.StackedOptimizer``) keeps a step count per member. The loop runs
eagerly, a few hundred small launches a step.

Semantics kept from the JAX program, member by member:

- each epoch draws one permutation of the **padded** sample axis and
  applies it to X, y and the train weights together (``:275-283``);
- an all-padding batch is a no-op for its member: params, moments and
  step count stay put, and its loss adds 0 to the epoch (``:295-305``);
- the epoch loss is ``sum(loss * sum(w)) / max(sum(w), 1)`` over the
  epoch's batches; the batch loss is the weighted mean of the per-sample
  loss plus the raw L1 activity sum;
- the objective that is differentiated is the **sum** of the members'
  losses, never their mean, so each member's gradient is its own; a
  member whose loss is NaN touches no other member's gradient;
- validation is a forward over the whole padded axis with the
  validation weights, NaN for a member without validation rows;
- ``EarlyStopping`` is a masked update: ``val_loss`` falls back to the
  train loss where it is NaN, a member stops once ``wait >=
  max(patience, 1)``, restore-best is optional, and ``epochs_ran`` counts
  the epochs a member had not stopped at their start (``:151-200``).

Randomness is explicit: a :class:`RandomSource` draws each member's
initial params and its per-epoch permutations from the member's seed.
The default, :class:`TorchRandom`, draws from CPU ``torch.Generator``s,
so a build draws the same numbers on the CPU and on the card. JAX draws
from threefry keys, whose bits torch cannot reproduce; the parity tests
inject a source that derives them as the JAX trainer does.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from ..ops.losses import resolve_loss, weighted_mean_loss
from .callbacks import Callback, EarlyStopping
from .nn import Params, forward_feedforward_stacked, init_feedforward
from .optim import OptimizerState, StackedOptimizer
from .spec import FeedForwardSpec


@dataclass(frozen=True)
class FitConfig:
    """Static (hashable) fit configuration; members of one config and spec
    train as one stacked program."""

    epochs: int = 1
    batch_size: int = 32
    validation_split: float = 0.0
    shuffle: bool = True
    # (monitor, patience, min_delta, restore_best_weights) or None
    early_stopping: Optional[Tuple[str, int, float, bool]] = None


@dataclass
class History:
    """Keras-History-shaped fit record (read by the training summary)."""

    history: Dict[str, List[float]]
    params: Dict[str, Any]
    epoch: List[int]


def split_fit_kwargs(kwargs: dict) -> Tuple[dict, dict]:
    """Split estimator kwargs into (fit-related, factory-related)."""
    fit_keys = {
        "epochs",
        "batch_size",
        "validation_split",
        "shuffle",
        "callbacks",
        "verbose",
        "initial_epoch",
        "seed",
    }
    fit_args = {k: v for k, v in kwargs.items() if k in fit_keys}
    rest = {k: v for k, v in kwargs.items() if k not in fit_keys}
    return fit_args, rest


def fit_config_from_kwargs(kwargs: dict) -> Tuple[FitConfig, List[Callback]]:
    """
    A :class:`FitConfig` from Keras-style fit kwargs. ``EarlyStopping``
    compiles into the config; any other callbacks are returned, and
    callers refuse them (the port has no per-epoch host loop).
    """
    early_stopping = None
    host_callbacks: List[Callback] = []
    for cb in list(kwargs.get("callbacks") or []):
        if isinstance(cb, EarlyStopping):
            early_stopping = (cb.monitor, cb.patience, cb.min_delta, cb.restore_best_weights)
        elif isinstance(cb, Callback):
            host_callbacks.append(cb)
        else:
            raise TypeError(f"Unsupported callback: {cb!r}")
    config = FitConfig(
        epochs=int(kwargs.get("epochs", 1)),
        batch_size=int(kwargs.get("batch_size", 32)),
        validation_split=float(kwargs.get("validation_split", 0.0)),
        shuffle=bool(kwargs.get("shuffle", True)),
        early_stopping=None if host_callbacks else early_stopping,
    )
    return config, host_callbacks


class RandomSource(Protocol):
    """Where a member's random numbers come from."""

    def init_params(self, spec: FeedForwardSpec, seed: int) -> Any:
        """Initial params in the ``{"dense_i": {"W", "b"}, "out": ...}``
        layout (tensors or numpy arrays)."""

    def permutations(self, seed: int, epochs: int, n_total: int) -> Any:
        """``[epochs, n_total]`` integer permutations, one an epoch."""


def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one of a member's two streams (0: init, 1:
    permutations), seeded from the member's seed."""
    return torch.Generator().manual_seed((2 * int(seed) + stream) % (1 << 63))


class TorchRandom:
    """The default source: Glorot-uniform weights and zero biases (as
    ``init_feedforward`` draws them) and ``randperm``s, each from a CPU
    ``torch.Generator`` seeded from the member's seed, so the same build
    draws the same numbers on every device."""

    def init_params(self, spec: FeedForwardSpec, seed: int) -> Params:
        return init_feedforward(spec, _generator(seed, 0))

    def permutations(self, seed: int, epochs: int, n_total: int) -> torch.Tensor:
        gen = _generator(seed, 1)
        return torch.stack([torch.randperm(n_total, generator=gen) for _ in range(epochs)])


@dataclass
class FitOutput:
    """What one stacked fit returns, on the fit's device: final params and
    ``losses[M, epochs]``, ``val_losses[M, epochs]``, ``epochs_ran[M]``."""

    params: Params
    losses: torch.Tensor
    val_losses: torch.Tensor
    epochs_ran: torch.Tensor


class StackedFit:
    """The fused fit of one (spec, config) over a stacked bucket."""

    def __init__(self, spec: FeedForwardSpec, config: FitConfig):
        self.spec = spec
        self.config = config
        self.per_sample = resolve_loss(spec.loss)
        self.optimizer = StackedOptimizer(spec.optimizer)
        self.keys = [(key, name) for key, _ in spec.layer_names() for name in ("W", "b")]

    def leaves(self, params: Params) -> List[torch.Tensor]:
        return [params[key][name] for key, name in self.keys]

    def batch_loss(
        self, params: Params, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor
    ) -> torch.Tensor:
        """Each member's batch loss ``[M]``: weighted mean + L1 activity."""
        out, penalty = forward_feedforward_stacked(self.spec, params, xb)
        return weighted_mean_loss(self.per_sample(out, yb), wb) + penalty

    def train_step(
        self,
        params: Params,
        state: OptimizerState,
        xb: torch.Tensor,
        yb: torch.Tensor,
        wb: torch.Tensor,
        active: torch.Tensor,
    ) -> torch.Tensor:
        """One optimizer step for every member with data in the batch and
        ``active``; returns each member's ``loss * sum(wb)`` (0 for an
        all-padding batch). Never synchronises with the device."""
        leaves = self.leaves(params)
        with torch.enable_grad():
            loss = self.batch_loss(params, xb, yb, wb)
            wsum = wb.sum(-1)
            has_data = wsum > 0
            # the sum over members: each member's gradient is its own, and
            # the masked-off NaN of an all-padding batch reaches nothing
            objective = torch.where(has_data, loss, torch.zeros_like(loss)).sum()
            grads = torch.autograd.grad(objective, leaves)
        self.optimizer.step(leaves, grads, state, has_data & active)
        with torch.no_grad():
            return torch.where(has_data, loss * wsum, torch.zeros_like(loss))

    @torch.no_grad()
    def evaluate(self, params: Params, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Each member's weighted loss ``[M]`` over all of ``X`` (no L1
        term); NaN where ``w`` is all zero."""
        out, _ = forward_feedforward_stacked(self.spec, params, X)
        return weighted_mean_loss(self.per_sample(out, y), w)

    def run(
        self,
        params: Params,
        X: torch.Tensor,
        y: torch.Tensor,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        perms: Optional[torch.Tensor],
    ) -> FitOutput:
        """
        Train ``params`` (stacked, float32, on X's device; updated in
        place) on ``X[M, n, F]``, ``y[M, n, F_out]`` (``y`` may be ``X``)
        with weights ``wtr``/``wval`` ``[M, n]`` (``n`` a whole number of
        batches), shuffling each epoch by ``perms[M, epochs, n]`` when the
        config shuffles.
        """
        config, es = self.config, self.config.early_stopping
        M, n = wtr.shape
        B = config.batch_size
        if n % B:
            raise ValueError(f"sample axis {n} is not a whole number of {B}-row batches")
        dtype = getattr(torch, self.spec.compute_dtype)
        aliased = y is X
        X = X.to(dtype)
        y = X if aliased else y.to(dtype)
        for leaf in self.leaves(params):
            leaf.requires_grad_(True)
        state = self.optimizer.init(self.leaves(params))
        has_val = bool((wval > 0).any())
        device = X.device
        best = torch.full((M,), float("inf"), device=device)
        wait = torch.zeros(M, dtype=torch.int32, device=device)
        stopped = torch.zeros(M, dtype=torch.bool, device=device)
        restore = es is not None and es[3]
        best_params = [leaf.detach().clone() for leaf in self.leaves(params)] if restore else None
        wtr_total = wtr.sum(-1).clamp(min=1.0)
        losses, val_losses, ran = [], [], []
        for epoch in range(config.epochs):
            active = ~stopped
            Xe, ye, we = X, y, wtr
            if config.shuffle:
                perm = perms[:, epoch].long()
                Xe = torch.take_along_dim(X, perm[:, :, None], dim=1)
                ye = Xe if aliased else torch.take_along_dim(y, perm[:, :, None], dim=1)
                we = torch.take_along_dim(wtr, perm, dim=1)
            total = torch.zeros(M, device=device)
            for s in range(0, n, B):
                total = total + self.train_step(
                    params, state, Xe[:, s:s + B], ye[:, s:s + B], we[:, s:s + B], active
                )
            loss = total / wtr_total
            val_loss = (
                self.evaluate(params, X, y, wval) if has_val
                else torch.full((M,), float("nan"), device=device)
            )
            losses.append(loss)
            val_losses.append(val_loss)
            ran.append(active)
            if es is not None:
                monitor = torch.where(torch.isnan(val_loss), loss, val_loss) if es[0] == "val_loss" else loss
                improved = monitor < best - es[2]
                better = active & improved
                best = torch.where(better, monitor, best)
                if restore:
                    with torch.no_grad():
                        for saved, leaf in zip(best_params, self.leaves(params)):
                            saved.copy_(torch.where(better.view((-1,) + (1,) * (leaf.dim() - 1)), leaf, saved))
                wait = torch.where(stopped, wait, torch.where(improved, torch.zeros_like(wait), wait + 1))
                stopped = stopped | (wait >= max(es[1], 1))
        final = {key: {} for key, _ in self.spec.layer_names()}
        sources = best_params if restore else self.leaves(params)
        for (key, name), leaf in zip(self.keys, sources):
            final[key][name] = leaf.detach()
        epochs = torch.stack(ran, dim=1).sum(dim=1) if es is not None else torch.full(
            (M,), config.epochs, dtype=torch.int64, device=device)
        return FitOutput(
            params=final,
            losses=torch.stack(losses, dim=1),
            val_losses=torch.stack(val_losses, dim=1),
            epochs_ran=epochs,
        )


def permutation_tensor(
    random: RandomSource, seeds: List[int], epochs: int, n_total: int, device: torch.device
) -> torch.Tensor:
    """Every member's permutations ``[M, epochs, n_total]`` (int64) on
    ``device``, drawn on the host."""
    perms = np.stack([np.asarray(random.permutations(s, epochs, n_total), np.int64) for s in seeds])
    return torch.from_numpy(perms).to(device)
