"""Architecture factories returning :class:`~..spec.FeedForwardSpec` or
:class:`~..spec.LSTMSpec`."""

from .feedforward_autoencoder import (
    feedforward_hourglass,
    feedforward_model,
    feedforward_symmetric,
)
from .lstm_autoencoder import lstm_hourglass, lstm_model, lstm_symmetric
from .utils import hourglass_calc_dims

__all__ = [
    "feedforward_hourglass",
    "feedforward_model",
    "feedforward_symmetric",
    "hourglass_calc_dims",
    "lstm_hourglass",
    "lstm_model",
    "lstm_symmetric",
]
