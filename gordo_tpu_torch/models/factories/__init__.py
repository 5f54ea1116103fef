"""Architecture factories returning :class:`~..spec.FeedForwardSpec`."""

from .feedforward_autoencoder import (
    feedforward_hourglass,
    feedforward_model,
    feedforward_symmetric,
)
from .utils import hourglass_calc_dims

__all__ = [
    "feedforward_hourglass",
    "feedforward_model",
    "feedforward_symmetric",
    "hourglass_calc_dims",
]
