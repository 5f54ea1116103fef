"""
Affine preprocessing that a served detector holds, without scikit-learn.

:class:`MinMaxScaler` stands in for the two ``sklearn.preprocessing.
MinMaxScaler``s of a served ``DiffBasedAnomalyDetector``: the pipeline
step ahead of the estimator (which the compiled ingest plan turns into
``(scale, offset)``) and the detector's own error scaler. Its state is
sklearn's (``scale_``, ``min_``, float64) and ``transform`` is
``X * scale_ + min_``, as sklearn's is.

:class:`Pipeline` is the ``sklearn.pipeline.Pipeline`` stand-in: named
steps, transformers first, the estimator last.
"""

from typing import Any, List, Sequence, Tuple

import numpy as np


class MinMaxScaler:
    """Scale each feature to ``feature_range`` by ``X * scale_ + min_``.

    >>> s = MinMaxScaler().fit(np.array([[0.0, 10.0], [2.0, 30.0]]))
    >>> s.transform(np.array([[1.0, 20.0]])).tolist()
    [[0.5, 0.5]]
    """

    def __init__(self, scale_=None, min_=None, feature_range: Tuple[float, float] = (0.0, 1.0)):
        self.feature_range = tuple(feature_range)
        self.scale_ = None if scale_ is None else np.asarray(scale_, np.float64)
        self.min_ = None if min_ is None else np.asarray(min_, np.float64)

    def fit(self, X) -> "MinMaxScaler":
        """Fit to the columns of ``X`` (NaN-ignoring, constant columns get
        scale 1, as sklearn's ``_handle_zeros_in_scale`` does)."""
        X = np.asarray(X, np.float64)
        data_min = np.nanmin(X, axis=0)
        data_range = np.nanmax(X, axis=0) - data_min
        data_range[data_range < 10 * np.finfo(np.float64).eps] = 1.0
        low, high = self.feature_range
        self.scale_ = (high - low) / data_range
        self.min_ = low - data_min * self.scale_
        return self

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X) -> np.ndarray:
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        return np.asarray(X, np.float64) * self.scale_ + self.min_

    def affine(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(scale, offset)`` with ``transform(X) == X * scale + offset``."""
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        return self.scale_, self.min_

    def __repr__(self):
        return f"MinMaxScaler(feature_range={self.feature_range})"


class Pipeline:
    """Named steps: transformers with ``affine()``, then an estimator."""

    def __init__(self, steps: Sequence[Tuple[str, Any]]):
        if not steps:
            raise ValueError("Pipeline needs at least one step")
        self.steps: List[Tuple[str, Any]] = list(steps)

    @property
    def transformers(self) -> List[Any]:
        return [step for _, step in self.steps[:-1]]

    @property
    def estimator(self) -> Any:
        return self.steps[-1][1]

    def transform_input(self, X) -> np.ndarray:
        """``X`` through every transformer, float64."""
        X = np.asarray(X, np.float64)
        for step in self.transformers:
            X = step.transform(X)
        return X

    def predict(self, X) -> np.ndarray:
        return self.estimator.predict(self.transform_input(X))

    def __repr__(self):
        return f"Pipeline(steps={self.steps!r})"
