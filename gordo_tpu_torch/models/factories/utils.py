"""Layer-geometry helpers, a copy of ``gordo_tpu/models/factories/utils.py``."""

import math
from typing import Sequence, Tuple


def hourglass_calc_dims(
    compression_factor: float, encoding_layers: int, n_features: int
) -> Tuple[int, ...]:
    """
    Encoder layer sizes tapering linearly from ``n_features`` down to
    ``ceil(compression_factor * n_features)`` over ``encoding_layers`` steps
    (the decoder mirrors them).

    >>> hourglass_calc_dims(0.5, 3, 10)
    (8, 7, 5)
    >>> hourglass_calc_dims(0.5, 3, 20)
    (17, 13, 10)
    """
    if not 0 <= compression_factor <= 1:
        raise ValueError("compression_factor must satisfy 0 <= cf <= 1")
    if encoding_layers < 1:
        raise ValueError("encoding_layers must be >= 1")
    smallest = max(min(math.ceil(compression_factor * n_features), n_features), 1)
    slope = (n_features - smallest) / encoding_layers
    return tuple(
        round(n_features - step * slope) for step in range(1, encoding_layers + 1)
    )


def check_dim_func_len(prefix: str, dims: Sequence[int], funcs: Sequence[str]):
    """Dims and activation-function tuples must pair up one-to-one."""
    if len(dims) != len(funcs):
        raise ValueError(
            f"Length of {prefix}_dim ({len(dims)}) and {prefix}_func "
            f"({len(funcs)}) must be equal"
        )
