"""
Feedforward autoencoder factories, a copy of
``gordo_tpu/models/factories/feedforward_autoencoder.py``: explicit dims,
symmetric and hourglass. Each returns a :class:`FeedForwardSpec` equal,
field by field, to the JAX factory's.
"""

from typing import Any, Dict, Optional, Tuple, Union

from ..spec import FeedForwardSpec, OptimizerSpec
from .utils import check_dim_func_len, hourglass_calc_dims

L1_ACTIVITY_DEFAULT = 1e-4


def feedforward_model(
    n_features: int,
    n_features_out: Optional[int] = None,
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
) -> FeedForwardSpec:
    """
    Encoder layers then decoder layers, with an L1 activity penalty on
    every encoder layer except the first.

    >>> feedforward_model(20).widths()
    (20, 256, 128, 64, 64, 128, 256, 20)
    """
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)

    dims = tuple(encoding_dim) + tuple(decoding_dim)
    activations = tuple(encoding_func) + tuple(decoding_func)
    l1 = tuple(
        L1_ACTIVITY_DEFAULT if 0 < i < len(encoding_dim) else 0.0
        for i in range(len(dims))
    )
    compile_kwargs = compile_kwargs or {}
    return FeedForwardSpec(
        n_features=n_features,
        n_features_out=n_features_out,
        dims=dims,
        activations=activations,
        out_activation=out_func,
        l1_activity=l1 if any(l1) else (),
        optimizer=OptimizerSpec.from_config(optimizer, optimizer_kwargs),
        loss=compile_kwargs.get("loss", "mse"),
        compute_dtype=compute_dtype,
        precision=precision,
    )


def feedforward_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    optimizer: Union[str, OptimizerSpec] = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> FeedForwardSpec:
    """Symmetric AE: ``dims`` for the encoder, reversed for the decoder."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return feedforward_model(
        n_features,
        n_features_out,
        encoding_dim=tuple(dims),
        decoding_dim=tuple(dims)[::-1],
        encoding_func=tuple(funcs),
        decoding_func=tuple(funcs)[::-1],
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )


def feedforward_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    optimizer: Union[str, OptimizerSpec] = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> FeedForwardSpec:
    """
    Hourglass AE: layer sizes taper linearly to ``ceil(compression_factor *
    n_features)`` and mirror back out.

    >>> feedforward_hourglass(20).widths()
    (20, 17, 13, 10, 10, 13, 17, 20)
    """
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return feedforward_symmetric(
        n_features,
        n_features_out,
        dims=dims,
        funcs=tuple([func] * len(dims)),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )
