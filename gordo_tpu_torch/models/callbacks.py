"""
Training callbacks: the fields of ``gordo_tpu/models/callbacks.py``'s
``EarlyStopping`` that a fleet build compiles into its fit loop.

The fleet builder compiles ``EarlyStopping`` into the stacked fit as a
masked update (``models/training.py``); it runs no per-epoch host hooks,
so any other callback is refused where the fit config is made, as the
JAX fleet builder refuses host callbacks
(``gordo_tpu/parallel/fleet_build.py:1298-1302``).
"""


class Callback:
    """Base class of training callbacks."""


class EarlyStopping(Callback):
    """
    Stop training when ``monitor`` stops improving by ``min_delta`` for
    ``patience`` epochs (``patience=0`` acts as 1); optionally restore the
    best params seen. ``verbose``, ``mode`` and other Keras arguments are
    accepted and ignored, as the JAX package does.
    """

    def __init__(
        self,
        monitor: str = "val_loss",
        min_delta: float = 0.0,
        patience: int = 0,
        restore_best_weights: bool = False,
        **kwargs,
    ):
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.restore_best_weights = bool(restore_best_weights)

    def __repr__(self):
        return (
            f"EarlyStopping(monitor={self.monitor!r}, min_delta={self.min_delta}, "
            f"patience={self.patience}, restore_best_weights={self.restore_best_weights})"
        )
