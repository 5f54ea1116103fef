"""
The build's default CV metrics (``gordo_tpu/builder/build_model.py:307-332``)
as numpy versions of their ``sklearn.metrics`` namesakes with
``multioutput="raw_values"``: one score per target column, computed in
the inputs' float type as scikit-learn computes them. The aggregate a
build records is the plain mean of the columns (sklearn's
``uniform_average``).

Explained variance and r2 follow sklearn's ``force_finite``: a column
with no error scores 1, a constant column with error scores 0.
"""

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _float_pair(y_true, y_pred):
    dtype = np.result_type(np.asarray(y_true).dtype, np.asarray(y_pred).dtype, np.float32)
    return np.asarray(y_true, dtype), np.asarray(y_pred, dtype)


def _fraction_explained(numerator: np.ndarray, denominator: np.ndarray) -> np.ndarray:
    scores = np.ones(numerator.shape, numerator.dtype)
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return scores


def explained_variance_score(y_true, y_pred) -> np.ndarray:
    """Per column: ``1 - var(y_true - y_pred) / var(y_true)``.

    >>> explained_variance_score([[1.0], [2.0], [3.0]], [[2.0], [3.0], [4.0]]).tolist()
    [1.0]
    """
    y_true, y_pred = _float_pair(y_true, y_pred)
    diff = y_true - y_pred
    numerator = np.average((diff - np.average(diff, axis=0)) ** 2, axis=0)
    denominator = np.average((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    return _fraction_explained(numerator, denominator)


def r2_score(y_true, y_pred) -> np.ndarray:
    """Per column: ``1 - SS_res / SS_tot``.

    >>> r2_score([[1.0], [2.0], [3.0]], [[2.0], [3.0], [4.0]]).tolist()
    [-0.5]
    """
    y_true, y_pred = _float_pair(y_true, y_pred)
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    return _fraction_explained(numerator, denominator)


def mean_squared_error(y_true, y_pred) -> np.ndarray:
    y_true, y_pred = _float_pair(y_true, y_pred)
    return np.average((y_true - y_pred) ** 2, axis=0)


def mean_absolute_error(y_true, y_pred) -> np.ndarray:
    y_true, y_pred = _float_pair(y_true, y_pred)
    return np.average(np.abs(y_pred - y_true), axis=0)


METRICS: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    fn.__name__: fn
    for fn in (explained_variance_score, r2_score, mean_squared_error, mean_absolute_error)
}


def metrics_from_list(names: Optional[Sequence[str]] = None) -> List[Callable]:
    """The metric functions an evaluation config names (bare or as
    ``sklearn.metrics.<name>``); the four defaults when it names none."""
    if not names:
        return list(METRICS.values())
    resolved = []
    for name in names:
        short = name.rsplit(".", 1)[-1]
        if short not in METRICS or (name != short and not name.startswith("sklearn.metrics.")):
            raise NotImplementedError(f"metric {name!r} is not ported; known: {sorted(METRICS)}")
        resolved.append(METRICS[short])
    return resolved
