"""
Training callbacks, a copy of ``gordo_tpu/models/callbacks.py``.

A fleet build compiles ``EarlyStopping`` into its stacked fit as a masked
update (``models/training.py``). Any other callback makes the fit a
per-epoch host loop (``StackedFit.run(..., callbacks=...)``, the port of
``_fit_host_loop``): one epoch a call, then every callback's
``on_epoch_end`` with the epoch's ``loss``, ``val_loss`` and ``lr``, then
the stop and learning-rate requests. ``EarlyStopping`` rides along there
as a host callback. A fleet build sends such a machine to the sequential
``ModelBuilder``.

Quirks kept from the JAX package: under the host loop
``restore_best_weights`` restores nothing, and ``ReduceLROnPlateau``
ignores ``mode`` (it always minimises).
"""

import math
from typing import Optional


class Callback:
    """Base class; host-loop callbacks receive per-epoch logs."""

    def on_train_begin(self, logs: Optional[dict] = None):
        ...

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> bool:
        """Return True to request early stop."""
        return False

    def get_params(self, deep: bool = False) -> dict:
        return {}


class EarlyStopping(Callback):
    """
    Stop training when ``monitor`` stops improving by ``min_delta`` for
    ``patience`` epochs (``patience=0`` acts as 1); optionally restore the
    best params seen (compiled fit only). ``verbose``, ``mode`` and other
    Keras arguments are accepted and ignored, as the JAX package does.
    """

    def __init__(
        self,
        monitor: str = "val_loss",
        min_delta: float = 0.0,
        patience: int = 0,
        verbose: int = 0,
        mode: str = "auto",
        restore_best_weights: bool = False,
        **kwargs,
    ):
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.verbose = verbose
        self.mode = mode
        self.restore_best_weights = bool(restore_best_weights)
        self._best = None
        self._wait = 0

    def get_params(self, deep: bool = False) -> dict:
        return {
            "monitor": self.monitor,
            "min_delta": self.min_delta,
            "patience": self.patience,
            "restore_best_weights": self.restore_best_weights,
        }

    def on_train_begin(self, logs: Optional[dict] = None):
        self._best, self._wait = None, 0

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> bool:
        value = (logs or {}).get(self.monitor)
        if value is None:
            return False
        if self._best is None or value < self._best - self.min_delta:
            self._best, self._wait = value, 0
            return False
        self._wait += 1
        # Keras stops when wait >= patience (patience=0 behaves like 1)
        return self._wait >= max(self.patience, 1)

    def __repr__(self):
        return (
            f"EarlyStopping(monitor={self.monitor!r}, min_delta={self.min_delta}, "
            f"patience={self.patience}, restore_best_weights={self.restore_best_weights})"
        )


class TerminateOnNaN(Callback):
    """Stop training the moment the epoch loss goes non-finite (Keras
    ``TerminateOnNaN``)."""

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> bool:
        loss = (logs or {}).get("loss")
        return loss is not None and not math.isfinite(loss)

    def __repr__(self):
        return "TerminateOnNaN()"


class ReduceLROnPlateau(Callback):
    """
    Multiply the learning rate by ``factor`` when ``monitor`` stops
    improving for ``patience`` epochs (Keras-compatible surface:
    monitor/factor/patience/min_delta/cooldown/min_lr).

    The host loop applies the request between epochs: the optimizer's rate
    changes, and Adam's moments and step counts carry over unchanged (the
    learning rate only scales the update).
    """

    def __init__(
        self,
        monitor: str = "val_loss",
        factor: float = 0.1,
        patience: int = 10,
        min_delta: float = 1e-4,
        cooldown: int = 0,
        min_lr: float = 0.0,
        verbose: int = 0,
        mode: str = "auto",
        **kwargs,
    ):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau factor must be < 1.0")
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.verbose = verbose
        self.mode = mode
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_left = 0
        self._requested_lr: Optional[float] = None

    def get_params(self, deep: bool = False) -> dict:
        return {
            "monitor": self.monitor,
            "factor": self.factor,
            "patience": self.patience,
            "min_delta": self.min_delta,
            "cooldown": self.cooldown,
            "min_lr": self.min_lr,
        }

    def on_train_begin(self, logs: Optional[dict] = None):
        self._best, self._wait, self._cooldown_left = None, 0, 0
        self._requested_lr = None

    def consume_lr_request(self) -> Optional[float]:
        """The new learning rate this callback wants (one-shot), or None.
        Called by the host loop after each epoch's callbacks ran."""
        requested, self._requested_lr = self._requested_lr, None
        return requested

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> bool:
        logs = logs or {}
        # monitor falls back to the train loss when it is absent
        value = logs.get(self.monitor, logs.get("loss"))
        current_lr = logs.get("lr")
        if value is None or not math.isfinite(value):
            return False
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self._best is None or value < self._best - self.min_delta:
            self._best, self._wait = value, 0
        elif self._cooldown_left <= 0:
            self._wait += 1
            if self._wait >= max(self.patience, 1) and current_lr is not None:
                new_lr = max(current_lr * self.factor, self.min_lr)
                if new_lr < current_lr:
                    self._requested_lr = new_lr
                self._wait = 0
                self._cooldown_left = self.cooldown
        return False

    def __repr__(self):
        return (
            f"ReduceLROnPlateau(monitor={self.monitor!r}, factor={self.factor}, patience={self.patience}, "
            f"min_delta={self.min_delta}, cooldown={self.cooldown}, min_lr={self.min_lr})"
        )
