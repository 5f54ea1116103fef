"""
Sliding windows for the LSTM models: the contract the model offset rides
on, a copy of ``gordo_tpu/ops/windows.py`` for numpy arrays and torch
tensors.

For lookback ``L`` and lookahead ``la``:

- window ``k`` reads ``X[k : k+L]`` and its target is ``y[k + L + la - 1]``;
- a series of ``n`` rows gives ``n - L - la + 1`` windows;
- the model's output is ``L + la - 1`` rows shorter than its input (the
  *model offset* in a build's metadata, in CV scoring and in the
  server's tail alignment).

A tensor's windows are one gather on its own device.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def num_windows(n_samples: int, lookback: int, lookahead: int) -> int:
    """
    Number of (window, target) samples a series of ``n_samples`` rows
    yields.

    >>> num_windows(100, 20, 0)
    81
    >>> num_windows(100, 20, 1)
    80
    """
    return n_samples - lookback - lookahead + 1


def model_offset(lookback: int, lookahead: int) -> int:
    """
    How many rows shorter than its input the model output is.

    >>> model_offset(20, 0), model_offset(20, 1)
    (19, 20)
    """
    return lookback + lookahead - 1


def sliding_windows(X: Array, lookback: int, lookahead: int = 0) -> Array:
    """
    All length-``lookback`` windows of ``X`` usable with the given lookahead:
    shape ``[num_windows, lookback, n_features]``.

    >>> X = np.arange(10).reshape(5, 2)
    >>> w = sliding_windows(X, lookback=2, lookahead=0)
    >>> w.shape
    (4, 2, 2)
    >>> w[0].tolist()
    [[0, 1], [2, 3]]
    >>> tuple(sliding_windows(torch.from_numpy(X), 2, 1).shape)
    (3, 2, 2)
    """
    n = X.shape[0]
    count = num_windows(n, lookback, lookahead)
    if count <= 0:
        raise ValueError(
            f"Series of length {n} too short for lookback={lookback}, "
            f"lookahead={lookahead}"
        )
    if isinstance(X, torch.Tensor):
        start, step = torch.arange(count, device=X.device), torch.arange(lookback, device=X.device)
    else:
        start, step = np.arange(count), np.arange(lookback)
    return X[start[:, None] + step[None, :]]


def window_targets(y: Array, lookback: int, lookahead: int = 0) -> Array:
    """
    Targets aligned with :func:`sliding_windows`: ``y[k + lookback +
    lookahead - 1]`` for each window ``k``.

    >>> y = np.arange(5)
    >>> window_targets(y, lookback=2, lookahead=0).tolist()
    [1, 2, 3, 4]
    >>> window_targets(y, lookback=2, lookahead=1).tolist()
    [2, 3, 4]
    """
    n = y.shape[0]
    count = num_windows(n, lookback, lookahead)
    start = model_offset(lookback, lookahead)
    return y[start : start + count]


def windowed_dataset(
    X: Array, y: Optional[Array], lookback: int, lookahead: int = 0
) -> Tuple[Array, Optional[Array]]:
    """``(windows, aligned targets)``; targets None when ``y`` is.

    >>> w, t = windowed_dataset(np.arange(6).reshape(3, 2), np.arange(3), 2)
    >>> w.shape, t.tolist()
    ((2, 2, 2), [1, 2])
    """
    windows = sliding_windows(X, lookback, lookahead)
    targets = window_targets(y, lookback, lookahead) if y is not None else None
    return windows, targets


def gather_windows(series: torch.Tensor, starts: torch.Tensor, lookback: int) -> torch.Tensor:
    """Each member's windows starting at ``starts[M, B]`` from its
    ``series[M, n, F]``, time major: ``[M, lookback, B, F]``, one gather
    on the series' device (window ``(m, b)`` reads ``series[m,
    starts[m, b] : starts[m, b] + lookback]``).

    >>> series = torch.arange(12.0).reshape(1, 6, 2)
    >>> gather_windows(series, torch.tensor([[0, 3]]), 2)[0, :, 1].tolist()
    [[6.0, 7.0], [8.0, 9.0]]
    """
    steps = torch.arange(lookback, device=series.device)
    rows = starts.to(series.device, torch.int64)[:, None, :] + steps[None, :, None]
    members = torch.arange(series.shape[0], device=series.device)[:, None, None]
    return series[members, rows]
