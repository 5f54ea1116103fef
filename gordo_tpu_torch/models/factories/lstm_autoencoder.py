"""
LSTM factories, a copy of ``gordo_tpu/models/factories/lstm_autoencoder.py``:
explicit dims, symmetric and hourglass. The JAX package registers each
for both LSTM estimators (``JaxLSTMAutoEncoder`` and
``JaxLSTMForecast``); here both estimators take them from
``models.estimators.LSTM_KINDS``. Each returns an :class:`LSTMSpec` equal,
field by field, to the JAX factory's.
"""

from typing import Any, Dict, Optional, Tuple, Union

from ..spec import LSTMSpec, OptimizerSpec
from .utils import check_dim_func_len, hourglass_calc_dims


def lstm_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    encoding_dim: Tuple[int, ...] = (256, 128, 64),
    encoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    decoding_dim: Tuple[int, ...] = (64, 128, 256),
    decoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: Union[str, OptimizerSpec] = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    compute_dtype: str = "float32",
    precision: str = "",
    **kwargs,
) -> LSTMSpec:
    """
    Encoding layers then decoding layers over a lookback window.

    >>> lstm_model(20, lookback_window=10).widths()
    (20, 256, 128, 64, 64, 128, 256, 20)
    """
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)
    compile_kwargs = compile_kwargs or {}
    return LSTMSpec(
        n_features=n_features,
        n_features_out=n_features_out,
        lookback_window=lookback_window,
        dims=tuple(encoding_dim) + tuple(decoding_dim),
        activations=tuple(encoding_func) + tuple(decoding_func),
        out_activation=out_func,
        optimizer=OptimizerSpec.from_config(optimizer, optimizer_kwargs),
        loss=compile_kwargs.get("loss", "mse"),
        compute_dtype=compute_dtype,
        precision=precision,
    )


def lstm_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: Union[str, OptimizerSpec] = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> LSTMSpec:
    """Symmetric stacked LSTM: ``dims`` encoding, reversed decoding.

    >>> lstm_symmetric(20, dims=(64, 32), funcs=("tanh", "tanh")).dims
    (64, 32, 32, 64)
    """
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return lstm_model(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        encoding_dim=tuple(dims),
        decoding_dim=tuple(dims)[::-1],
        encoding_func=tuple(funcs),
        decoding_func=tuple(funcs)[::-1],
        out_func=out_func,
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )


def lstm_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    out_func: str = "linear",
    optimizer: Union[str, OptimizerSpec] = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> LSTMSpec:
    """
    Hourglass stacked LSTM: layer sizes taper linearly to
    ``ceil(compression_factor * n_features)`` and mirror back out.

    >>> lstm_hourglass(10).dims
    (8, 7, 5, 5, 7, 8)
    >>> lstm_hourglass(20, encoding_layers=2).dims
    (15, 10, 10, 15)
    """
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return lstm_symmetric(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        dims=dims,
        funcs=tuple([func] * len(dims)),
        out_func=out_func,
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )
