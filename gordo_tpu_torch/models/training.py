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
  the epochs a member had not stopped at their start (``:151-200``);
- host callbacks (``ReduceLROnPlateau``, ``TerminateOnNaN``, any other
  ``Callback``, with ``EarlyStopping`` among them) make a one-member fit
  a per-epoch host loop (``_fit_host_loop``, ``:778-850``).

:class:`WindowedFit` is the windowed (LSTM) fit of
``build_raw_windowed_fit_fn`` (``:343-457``): only each member's series
``[n, F]`` and its window targets ``[n_windows, F_out]`` are on the
device, and each step gathers its batch of windows from the series
through ``order`` (virtual slot -> window start), so a bucket never
holds its ``lookback``-times larger windows; the weights are per virtual
slot, validation runs batch by batch. Given the same virtual order it
trains as :class:`StackedFit` does on the windows made beforehand.

:class:`SegmentedFit` is ``build_raw_segmented_fit_fn`` (``:461-607``),
opt-in with ``GORDO_TPU_LSTM_SEGMENTED`` (:func:`segmented_config`): each
update's windows in order as a few segments, one recurrence a segment
with its state carried from window to window; :func:`fit_single_segmented`
is its one-model form (``:610-689``).

Randomness is explicit: a :class:`RandomSource` draws each member's
initial params and its per-epoch permutations from the member's seed.
The default, :class:`TorchRandom`, draws from CPU ``torch.Generator``s,
so a build draws the same numbers on the CPU and on the card. JAX draws
from threefry keys, whose bits torch cannot reproduce; the parity tests
inject a source that derives them as the JAX trainer does.
"""

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..ops.losses import resolve_loss, weighted_mean_loss
from ..ops.windows import gather_windows
from ..telemetry import program_span
from ..utils.env import env_int
from .callbacks import Callback, EarlyStopping
from .nn import Params, forward_lstm_sequence, forward_lstm_time_major, forward_stacked, init_params, param_keys
from .optim import OptimizerState, StackedOptimizer
from .spec import ModelSpec

logger = logging.getLogger(__name__)


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
    compiles into the config unless other callbacks come with it: then
    every callback, the early stoppers first, is returned for the
    per-epoch host loop (``gordo_tpu/models/training.py:93-128``).
    """
    early_stopping = None
    early_stoppers: List[Callback] = []
    host_callbacks: List[Callback] = []
    for cb in list(kwargs.get("callbacks") or []):
        if isinstance(cb, EarlyStopping):
            early_stoppers.append(cb)
            early_stopping = (cb.monitor, cb.patience, cb.min_delta, cb.restore_best_weights)
        elif isinstance(cb, Callback):
            host_callbacks.append(cb)
        else:
            raise TypeError(f"Unsupported callback: {cb!r}")
    if host_callbacks:
        # the host loop runs every callback: EarlyStopping rides along
        host_callbacks = early_stoppers + host_callbacks
        early_stopping = None
    config = FitConfig(
        epochs=int(kwargs.get("epochs", 1)),
        batch_size=int(kwargs.get("batch_size", 32)),
        validation_split=float(kwargs.get("validation_split", 0.0)),
        shuffle=bool(kwargs.get("shuffle", True)),
        early_stopping=early_stopping,
    )
    return config, host_callbacks


class RandomSource(Protocol):
    """Where a member's random numbers come from."""

    def init_params(self, spec: ModelSpec, seed: int) -> Any:
        """Initial params in the spec's layout (``models/nn.py``; tensors or
        numpy arrays)."""

    def permutations(self, seed: int, epochs: int, n_total: int) -> Any:
        """``[epochs, n_total]`` integer permutations, one an epoch. A
        source may also have ``host_loop_permutations`` of the same form:
        a host-loop fit (``FleetTrainer.fit_single`` with host callbacks)
        draws from it."""


def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one of a member's two streams (0: init, 1:
    permutations), seeded from the member's seed."""
    return torch.Generator().manual_seed((2 * int(seed) + stream) % (1 << 63))


class TorchRandom:
    """The default source: the spec's initialisation (``nn.init_params``:
    Glorot-uniform, orthogonal recurrent weights for an LSTM) and
    ``randperm``s, each from a CPU ``torch.Generator`` seeded from the
    member's seed, so the same build draws the same numbers on every
    device."""

    def init_params(self, spec: ModelSpec, seed: int) -> Params:
        return init_params(spec, _generator(seed, 0))

    def permutations(self, seed: int, epochs: int, n_total: int) -> torch.Tensor:
        gen = _generator(seed, 1)
        return torch.stack([torch.randperm(n_total, generator=gen) for _ in range(epochs)])


@dataclass
class FitOutput:
    """What one stacked fit returns, on the fit's device: final params and
    ``losses[M, epochs]``, ``val_losses[M, epochs]``, ``epochs_ran[M]``;
    ``steps``, the optimizer steps it ran (over all members)."""

    params: Params
    losses: torch.Tensor
    val_losses: torch.Tensor
    epochs_ran: torch.Tensor
    steps: int = 0


class StackedFit:
    """The fused fit of one (spec, config) over a stacked bucket of
    samples (feedforward rows, or LSTM windows made beforehand)."""

    def __init__(self, spec: ModelSpec, config: FitConfig):
        self.spec = spec
        self.config = config
        self.per_sample = resolve_loss(spec.loss)
        self.optimizer = StackedOptimizer(spec.optimizer)
        self.keys = list(param_keys(spec))
        #: the mesh's data axis (``parallel/mesh.py::DataShard``), set by
        #: the fleet trainer when it is wider than 1: each rank computes
        #: its share of every batch's rows, weighted over the batch's whole
        #: weight, and the group sums the gradients and the losses
        self.data: Any = None

    def leaves(self, params: Params) -> List[torch.Tensor]:
        return [params[key][name] for key, name in self.keys]

    def forward(self, params: Params, xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(output[M, B, F_out], penalty[M])`` of a batch."""
        return forward_stacked(self.spec, params, xb)

    def batch_loss(
        self, params: Params, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor
    ) -> torch.Tensor:
        """Each member's batch loss ``[M]``: weighted mean + L1 activity."""
        out, penalty = self.forward(params, xb)
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
            wsum = wb.sum(-1)
            has_data = wsum > 0
            if self.data is None:
                loss = self.batch_loss(params, xb, yb, wb)
            else:
                loss = self.shard_loss(params, xb, yb, wb, wsum)
            # the sum over members: each member's gradient is its own, and
            # the masked-off NaN of an all-padding batch reaches nothing
            objective = torch.where(has_data, loss, torch.zeros_like(loss)).sum()
            grads = torch.autograd.grad(objective, leaves)
        if self.data is not None:
            # one flat buffer a step: every leaf's gradient and the batch loss
            flat = torch.cat([g.reshape(-1) for g in grads] + [torch.where(has_data, loss, 0.0).detach()])
            self.data.all_reduce(flat)
            grads = [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads] + [len(loss)]), grads)]
            loss = flat[-len(loss):]
        self.optimizer.step(leaves, grads, state, has_data & active, self.count_mask(has_data, active))
        with torch.no_grad():
            return torch.where(has_data, loss * wsum, torch.zeros_like(loss))

    def shard_batch(self, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor):
        """This data rank's rows of a batch ``(xb, yb, wb)`` (rows on axis 1)."""
        lo, hi = self.data.bounds(wb.shape[1])
        return xb[:, lo:hi], yb[:, lo:hi], wb[:, lo:hi]

    def shard_loss(self, params: Params, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor,
                   wsum: torch.Tensor) -> torch.Tensor:
        """This data rank's part of each member's batch loss ``[M]``: its
        rows' weighted losses over the whole batch's weight ``wsum`` plus
        its rows' L1 activity (a raw sum); the group's parts sum to
        :meth:`batch_loss`."""
        xs, ys, ws = self.shard_batch(xb, yb, wb)
        out, penalty = self.forward(params, xs)
        return (self.per_sample(out, ys) * ws).sum(-1) / wsum.clamp(min=1.0) + penalty

    def count_mask(self, has_data: torch.Tensor, active: torch.Tensor) -> Optional[torch.Tensor]:
        """Whose optimizer step counts advance this step; None: the members
        that step (``models/packing.py`` shares a count a pack)."""
        return None

    @torch.no_grad()
    def evaluate(self, params: Params, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Each member's weighted loss ``[M]`` over all of ``X`` (no L1
        term); NaN where ``w`` is all zero."""
        if self.data is not None:
            wsum = w.sum(-1)
            lo, hi = self.data.bounds(w.shape[1])
            out, _ = self.forward(params, X[:, lo:hi])
            total = self.data.all_reduce((self.per_sample(out, y[:, lo:hi]) * w[:, lo:hi]).sum(-1))
            return torch.where(wsum > 0, total / wsum.clamp(min=1.0), torch.full_like(total, float("nan")))
        out, _ = self.forward(params, X)
        return weighted_mean_loss(self.per_sample(out, y), w)

    def run(
        self,
        params: Params,
        X: torch.Tensor,
        y: torch.Tensor,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        perms: Optional[torch.Tensor],
        val: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        callbacks: Sequence[Callback] = (),
    ) -> FitOutput:
        """
        Train ``params`` (stacked, float32, on X's device; updated in
        place) on ``X[M, n, ...]``, ``y[M, n, F_out]`` (``y`` may be ``X``)
        with weights ``wtr``/``wval`` ``[M, n]`` (``n`` a whole number of
        batches), shuffling each epoch by ``perms[M, epochs, n]`` when the
        config shuffles. With ``val = (X_val, y_val)`` validation runs on
        those rows instead, ``wval`` their weights (``fit_single``'s
        separate validation arrays). With host ``callbacks`` (one member
        only) the epochs run in the host loop of :meth:`_fit`.
        """
        B = self.config.batch_size
        n = wtr.shape[1]
        if n % B:
            raise ValueError(f"sample axis {n} is not a whole number of {B}-row batches")
        dtype = getattr(torch, self.spec.compute_dtype)
        aliased = y is X
        X = X.to(dtype)
        y = X if aliased else y.to(dtype)

        def batches(epoch: int):
            Xe, ye, we = X, y, wtr
            if self.config.shuffle:
                perm = perms[:, epoch].long()
                index = perm.view(perm.shape + (1,) * (X.dim() - 2))
                Xe = torch.take_along_dim(X, index, dim=1)
                ye = Xe if aliased else torch.take_along_dim(y, perm[:, :, None], dim=1)
                we = torch.take_along_dim(wtr, perm, dim=1)
            for s in range(0, n, B):
                yield Xe[:, s:s + B], ye[:, s:s + B], we[:, s:s + B]

        if val is None:
            X_val, y_val = X, y
        else:
            X_val = val[0].to(dtype)
            y_val = X_val if val[1] is val[0] else val[1].to(dtype)
        return self._fit(params, wtr, wval, batches, lambda: self.evaluate(params, X_val, y_val, wval), callbacks)

    def _fit(
        self,
        params: Params,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        batches: Callable[[int], Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]],
        validate: Callable[[], torch.Tensor],
        callbacks: Sequence[Callback] = (),
    ) -> FitOutput:
        """The epochs and early stopping around ``batches(epoch)`` (each
        epoch's ``(xb, yb, wb)``) and ``validate()`` (each member's
        validation loss), the scaffold of ``_make_fit_loop``; with host
        ``callbacks``, :meth:`_fit_host_loop`'s epochs instead."""
        if callbacks:
            return self._fit_host_loop(params, wtr, wval, batches, validate, callbacks)
        config, es = self.config, self.config.early_stopping
        M = wtr.shape[0]
        for leaf in self.leaves(params):
            leaf.requires_grad_(True)
        state = self.optimizer.init(self.leaves(params))
        has_val = bool((wval > 0).any())
        device = wtr.device
        best = torch.full((M,), float("inf"), device=device)
        wait = torch.zeros(M, dtype=torch.int32, device=device)
        stopped = torch.zeros(M, dtype=torch.bool, device=device)
        restore = es is not None and es[3]
        best_params = [leaf.detach().clone() for leaf in self.leaves(params)] if restore else None
        wtr_total = wtr.sum(-1).clamp(min=1.0)
        losses, val_losses, ran = [], [], []
        steps = 0
        for epoch in range(config.epochs):
            active = ~stopped
            total = torch.zeros(M, device=device)
            for xb, yb, wb in batches(epoch):
                total = total + self.train_step(params, state, xb, yb, wb, active)
                steps += 1
            loss = total / wtr_total
            val_loss = validate() if has_val else torch.full((M,), float("nan"), device=device)
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
            steps=steps,
        )


    def _fit_host_loop(
        self,
        params: Params,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        batches: Callable[[int], Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]],
        validate: Callable[[], torch.Tensor],
        callbacks: Sequence[Callback],
    ) -> FitOutput:
        """The per-epoch host loop of one member (``_fit_host_loop``,
        ``gordo_tpu/models/training.py:778-850``): each epoch trains, then
        validates when there are validation rows, then every callback's
        ``on_epoch_end`` runs on ``{loss, lr, val_loss}`` (Keras
        semantics), then the last learning-rate request changes the
        optimizer's rate (moments and step counts carry over), then the
        loop stops if any callback asked to."""
        if wtr.shape[0] != 1:
            raise ValueError(f"the host loop trains one member, not {wtr.shape[0]}")
        for leaf in self.leaves(params):
            leaf.requires_grad_(True)
        state = self.optimizer.init(self.leaves(params))
        has_val = bool((wval > 0).any())
        device = wtr.device
        active = torch.ones(1, dtype=torch.bool, device=device)
        wtr_total = wtr.sum(-1).clamp(min=1.0)
        for cb in callbacks:
            cb.on_train_begin()
        losses, val_losses = [], []
        steps = 0
        for epoch in range(self.config.epochs):
            total = torch.zeros(1, device=device)
            for xb, yb, wb in batches(epoch):
                total = total + self.train_step(params, state, xb, yb, wb, active)
                steps += 1
            loss = total / wtr_total
            val_loss = validate() if has_val else torch.full((1,), float("nan"), device=device)
            losses.append(loss)
            val_losses.append(val_loss)
            logs = {"loss": float(loss[0]), "lr": self.optimizer.lr}
            if has_val:
                logs["val_loss"] = float(val_loss[0])
            stop_requests = [cb.on_epoch_end(epoch, logs) for cb in callbacks]
            new_lr = None
            for cb in callbacks:
                request = getattr(cb, "consume_lr_request", None)
                if callable(request):
                    requested = request()
                    if requested is not None:
                        new_lr = requested
            if new_lr is not None and new_lr != self.optimizer.lr:
                logger.info("Host loop: learning rate -> %g (epoch %d)", new_lr, epoch)
                self.optimizer.lr = float(new_lr)
            if any(stop_requests):
                break
        final = {key: {} for key, _ in self.spec.layer_names()}
        for (key, name), leaf in zip(self.keys, self.leaves(params)):
            final[key][name] = leaf.detach()
        return FitOutput(
            params=final,
            losses=torch.stack(losses, dim=1),
            val_losses=torch.stack(val_losses, dim=1),
            epochs_ran=torch.full((1,), len(losses), dtype=torch.int64, device=device),
            steps=steps,
        )


def _live_batches(weights: torch.Tensor, batch_size: int) -> List[int]:
    """The batches of ``weights[M, n]`` where some member has weight: a
    batch of padding slots alone changes nothing and adds 0, so it is left
    out (a windowed fit's unshuffled batches, a segmented fit's updates)."""
    return torch.nonzero(weights.view(len(weights), -1, batch_size).sum(-1).sum(0)).flatten().tolist()


class WindowedFit(StackedFit):
    """The windowed fit of one (LSTM spec, config) over a stacked bucket:
    windows gathered from the resident series each step. Unshuffled, a
    batch of padding slots for every member (a padded series' tail, a
    fold's unused windows) changes nothing and adds 0, so it is not run;
    validation skips such batches too."""

    def forward(self, params: Params, xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward of gathered, time-major windows ``xb[M, L, B, F]``."""
        return forward_lstm_time_major(self.spec, params, xb)

    def shard_batch(self, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor):
        """This data rank's windows of a batch (axis 2 of the time-major ``xb``)."""
        lo, hi = self.data.bounds(wb.shape[1])
        return xb[:, :, lo:hi], yb[:, lo:hi], wb[:, lo:hi]

    def run(
        self,
        params: Params,
        series: torch.Tensor,
        targets: torch.Tensor,
        order: torch.Tensor,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        perms: Optional[torch.Tensor],
        callbacks: Sequence[Callback] = (),
    ) -> FitOutput:
        """
        Train ``params`` (stacked, float32, on the series' device; updated
        in place) on each member's ``series[M, n, F]`` towards its window
        targets ``targets[M, n_windows, F_out]``. Virtual slot ``j`` of a
        member is its window ``order[m, j]``, with weights ``wtr``/``wval``
        ``[M, nv]`` (``nv`` a whole number of batches; padding slots point
        at window 0 with weight 0). When the config shuffles, each epoch
        permutes the slots by ``perms[M, epochs, nv]``. Host ``callbacks``
        run as in :meth:`StackedFit.run`.
        """
        B, lookback = self.config.batch_size, self.spec.lookback_window
        nv = wtr.shape[1]
        if nv % B:
            raise ValueError(f"window axis {nv} is not a whole number of {B}-window batches")
        dtype = getattr(torch, self.spec.compute_dtype)
        series, targets, order = series.to(dtype), targets.to(dtype), order.long()

        def batch(starts: torch.Tensor):
            return gather_windows(series, starts, lookback), torch.take_along_dim(targets, starts[..., None], dim=1)

        def live(weights: torch.Tensor) -> List[int]:
            return [B * i for i in _live_batches(weights, B)]

        train_starts = None if self.config.shuffle else live(wtr)

        def batches(epoch: int):
            order_e, we, starts = order, wtr, train_starts
            if self.config.shuffle:
                perm = perms[:, epoch].long()
                order_e = torch.take_along_dim(order, perm, dim=1)
                we = torch.take_along_dim(wtr, perm, dim=1)
                starts = range(0, nv, B)
            for s in starts:
                yield (*batch(order_e[:, s:s + B]), we[:, s:s + B])

        @torch.no_grad()
        def validate() -> torch.Tensor:
            # batch by batch, as training: validation memory stays bounded too
            total = torch.zeros(wval.shape[0], device=wval.device)
            wsum = torch.zeros_like(total)
            for s in live(wval):
                xb, yb = batch(order[:, s:s + B])
                wb = wval[:, s:s + B]
                wsum = wsum + wb.sum(-1)
                if self.data is not None:
                    xb, yb, wb = self.shard_batch(xb, yb, wb)
                total = total + (self.per_sample(self.forward(params, xb)[0], yb) * wb).sum(-1)
            if self.data is not None:
                self.data.all_reduce(total)
            return torch.where(wsum > 0, total / wsum, torch.full_like(total, float("nan")))

        return self._fit(params, wtr, wval, batches, validate, callbacks)


def segmented_config() -> Optional[int]:
    """The segments an update of the opt-in segmented LSTM fit
    (``GORDO_TPU_LSTM_SEGMENTED``: 0 or unset is off, N is N segments an
    update), read by the fleet trainer and the LSTM estimators alike
    (``gordo_tpu/models/training.py:44-52``)."""
    value = env_int("GORDO_TPU_LSTM_SEGMENTED", 0)
    return value if value > 0 else None


class SegmentedFit(StackedFit):
    """
    The segmented (stateful-scan) fit of one (LSTM spec, config) over a
    stacked bucket, ``build_raw_segmented_fit_fn``
    (``gordo_tpu/models/training.py:461-607``). Update ``k`` covers the
    same ``B`` consecutive windows as the unshuffled windowed fit's batch
    ``k``, as ``G`` segments of ``L = B / G`` windows headed at ``k*B +
    g*L``: one recurrence over the ``L + lookback - 1`` rows of each
    segment (:func:`~.nn.forward_lstm_sequence`) gives every window of the
    segment. A segment's first window starts cold, as the windowed fit's
    do; the later ones start from the state the segment has warmed,
    which is JAX's semantics. At ``G = B`` every window starts cold and
    the fit is the windowed fit's.

    Cell applications an update drop from ``B * lookback`` to ``B + G *
    (lookback - 1)``; the steps run one after another rise from
    ``lookback`` to ``L + lookback - 1``. Row indices clamp to the last
    series row and window indices to the last target; the loss is the
    weighted mean over the ``B`` windows, an update without weight for a
    member changes nothing of it, and an update without weight for any
    member is not run (the penalty is 0: an LSTM has no L1 term).
    Validation adds each update's weighted mean times
    its weight, 0 for an update without weight, and is NaN without
    validation weight.
    """

    def __init__(self, spec: ModelSpec, config: FitConfig, segments: int):
        if config.shuffle:
            raise ValueError("segmented LSTM training requires shuffle=False")
        if config.batch_size % segments:
            raise ValueError(f"batch_size {config.batch_size} not divisible by segments {segments}")
        super().__init__(spec, config)
        self.segments = segments

    def indices(self, updates: int, n: int, n_windows: int, device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every update's gather indices on ``device``: the series rows of
        its segments, ``[updates, span, G]`` (time major, clamped to ``n -
        1``), and its windows in segment order, ``[updates, B]`` (clamped
        to ``n_windows - 1``); ``series[:, rows[k]]`` is update ``k``'s
        input, ``targets[:, windows[k]]`` its targets."""
        B, G = self.config.batch_size, self.segments
        L = B // G
        heads = torch.arange(updates, device=device)[:, None] * B + torch.arange(G, device=device)[None, :] * L
        span = torch.arange(L + self.spec.lookback_window - 1, device=device)
        rows = (heads[:, None, :] + span[None, :, None]).clamp(max=n - 1)
        windows = (heads[:, :, None] + torch.arange(L, device=device)[None, None, :]).clamp(max=n_windows - 1)
        return rows, windows.reshape(updates, B)

    def shard_batch(self, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor):
        """This data rank's whole segments of an update: segments on axis 2
        of ``xb[M, span, G, F]``, their ``L`` windows each in ``yb`` and
        ``wb``."""
        lo, hi = self.data.bounds(self.segments)
        L = self.config.batch_size // self.segments
        return xb[:, :, lo:hi], yb[:, lo * L:hi * L], wb[:, lo * L:hi * L]

    def forward(self, params: Params, xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The outputs of an update's windows, ``[M, B, F_out]`` in segment
        order, from its segments' rows ``xb[M, span, G, F]``; penalty 0."""
        lookback = self.spec.lookback_window
        out = forward_lstm_sequence(self.spec, params, xb)[:, lookback - 1:]  # [M, L, G, F_out]
        penalty = torch.zeros(xb.shape[0], dtype=torch.float32, device=xb.device)
        return out.transpose(1, 2).reshape(out.shape[0], -1, out.shape[-1]), penalty

    def run(
        self,
        params: Params,
        series: torch.Tensor,
        targets: torch.Tensor,
        wtr: torch.Tensor,
        wval: torch.Tensor,
        perms: Optional[torch.Tensor] = None,
        callbacks: Sequence[Callback] = (),
    ) -> FitOutput:
        """
        Train ``params`` (stacked, float32, on the series' device; updated
        in place) on each member's ``series[M, n, F]`` towards its window
        targets ``targets[M, n_windows, F_out]``, window ``j`` starting at
        row ``j``, with weights ``wtr``/``wval`` ``[M, nv]`` over the
        windows in order (``nv`` a whole number of batches). ``perms`` is
        not read: the fit never shuffles. Host ``callbacks`` run as in
        :meth:`StackedFit.run`.
        """
        B = self.config.batch_size
        nv = wtr.shape[1]
        if nv % B:
            raise ValueError(f"window axis {nv} is not a whole number of {B}-window batches")
        dtype = getattr(torch, self.spec.compute_dtype)
        series, targets = series.to(dtype), targets.to(dtype)
        rows, windows = self.indices(nv // B, series.shape[1], targets.shape[1], series.device)

        def update(k: int):
            return series[:, rows[k]], targets[:, windows[k]]

        train_updates = _live_batches(wtr, B)

        def batches(epoch: int):
            for k in train_updates:
                yield (*update(k), wtr[:, k * B:(k + 1) * B])

        @torch.no_grad()
        def validate() -> torch.Tensor:
            total = torch.zeros(wval.shape[0], device=wval.device)
            wsum = torch.zeros_like(total)
            for k in _live_batches(wval, B):
                wb = wval[:, k * B:(k + 1) * B]
                w = wb.sum(-1)
                if self.data is None:
                    loss = self.batch_loss(params, *update(k), wb)
                else:
                    loss = self.shard_loss(params, *update(k), wb, w)
                # the all-padding member's NaN mean times 0 is NaN: the guard zeroes it
                total = total + torch.where(w > 0, loss * w, torch.zeros_like(loss))
                wsum = wsum + w
            if self.data is not None:
                self.data.all_reduce(total)
            return torch.where(wsum > 0, total / wsum, torch.full_like(total, float("nan")))

        return self._fit(params, wtr, wval, batches, validate, callbacks)


def fit_single_segmented(
    spec: ModelSpec,
    series: np.ndarray,
    targets: np.ndarray,
    config: FitConfig,
    seed: int = 42,
    segments: int = 4,
    device: Any = "cpu",
    random: Optional[RandomSource] = None,
) -> Tuple[Params, History]:
    """
    One model's segmented fit (``gordo_tpu/models/training.py:610-689``),
    the estimators' path under ``GORDO_TPU_LSTM_SEGMENTED``: the raw
    ``series[n, F]`` and its window targets ``targets[n_windows, F_out]``
    on ``device``, the last ``int(n_windows * validation_split)`` windows
    validating, the windows padded to whole batches at weight 0, init from
    ``random`` (default :class:`TorchRandom`) at ``seed``. Returns the
    params (one model's, on ``device``) and the history, whose ``steps``
    count the train windows' batches and whose ``segmented`` is
    ``segments``. A ``device_program`` span ``fit_single_segmented``.
    """
    if config.shuffle:
        raise ValueError("segmented LSTM training requires shuffle=False")
    series = np.asarray(series, np.float32)
    targets = np.asarray(targets, np.float32)
    nw = len(targets)
    B = config.batch_size
    if B % segments or nw < B:
        raise ValueError(
            f"segments={segments} needs batch_size divisible by it and at "
            f"least one full batch of windows (nw={nw}, batch={B})"
        )
    nv = -(-nw // B) * B
    n_val = int(nw * config.validation_split)
    wtr = np.zeros((1, nv), np.float32)
    wtr[0, : nw - n_val] = 1.0
    wval = np.zeros((1, nv), np.float32)
    wval[0, nw - n_val: nw] = 1.0
    init = (random or TorchRandom()).init_params(spec, seed)
    params = {
        key: {name: torch.as_tensor(np.asarray(leaf, np.float32))[None].to(device) for name, leaf in layer.items()}
        for key, layer in init.items()
    }
    fit = SegmentedFit(spec, config, segments)
    data = [torch.from_numpy(a).to(device) for a in (series[None], targets[None], wtr, wval)]
    with program_span("fit_single_segmented", (spec, config, segments, series.shape, targets.shape),
                      shape=str(tuple(series.shape)), spec=type(spec).__name__):
        out = fit.run(params, *data)
        losses, val_losses, ran = out.losses[0].tolist(), out.val_losses[0].tolist(), int(out.epochs_ran[0])
    history = {"loss": losses[:ran]}
    if n_val:
        history["val_loss"] = val_losses[:ran]
    return {key: {name: leaf[0] for name, leaf in layer.items()} for key, layer in out.params.items()}, History(
        history=history,
        params={
            "epochs": config.epochs,
            # the train windows' batches, as the dense fit over windows counts them
            "steps": (nw - n_val + B - 1) // B,
            "verbose": 0,
            "metrics": list(history),
            "segmented": segments,
        },
        epoch=list(range(ran)),
    )


def permutation_tensor(
    random: RandomSource, seeds: List[int], epochs: int, n_total: int, device: torch.device
) -> torch.Tensor:
    """Every member's permutations ``[M, epochs, n_total]`` (int64) on
    ``device``, drawn on the host."""
    perms = np.stack([np.asarray(random.permutations(s, epochs, n_total), np.int64) for s in seeds])
    return torch.from_numpy(perms).to(device)
