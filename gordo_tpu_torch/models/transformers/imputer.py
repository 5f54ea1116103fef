"""
The ±inf imputer of ``gordo_tpu/models/transformers/imputer.py`` in numpy
(the reference's ``gordo/machine/model/transformers/imputer.py``).

Each feature's positive and negative infinities are filled, either with
the train-time column max and min nudged out by ``delta`` (``minmax``) or
with the input dtype's extreme values (``extremes``); an explicit
``inf_fill_value`` / ``neg_inf_fill_value`` wins over both. It is not an
affine map, so a served pipeline holding it is transformed on the host.
"""

from typing import Any, Dict, Optional

import numpy as np


class InfImputer:
    """Fill ±inf per feature.

    >>> imp = InfImputer(delta=1.0).fit(np.array([[0.0, np.inf], [2.0, 3.0]]))
    >>> imp.transform(np.array([[np.inf, -np.inf]])).tolist()
    [[3.0, 2.0]]
    """

    def __init__(
        self,
        inf_fill_value: Optional[float] = None,
        neg_inf_fill_value: Optional[float] = None,
        strategy: str = "minmax",
        delta: float = 2.0,
    ):
        if strategy not in ("minmax", "extremes"):
            raise ValueError(f"Unknown strategy {strategy!r}")
        self.inf_fill_value = inf_fill_value
        self.neg_inf_fill_value = neg_inf_fill_value
        self.strategy = strategy
        self.delta = delta

    def fit(self, X, y=None) -> "InfImputer":
        X = np.asarray(X)
        if self.strategy == "extremes":
            info = np.finfo(X.dtype) if np.issubdtype(X.dtype, np.floating) else np.finfo(np.float64)
            self._fill_values = np.full(X.shape[1], info.max)
            self._neg_fill_values = np.full(X.shape[1], info.min)
        else:
            masked = np.ma.masked_invalid(X)
            self._fill_values = masked.max(axis=0).filled(0.0) + self.delta
            self._neg_fill_values = masked.min(axis=0).filled(0.0) - self.delta
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X, y=None) -> np.ndarray:
        """A copy of ``X`` (its dtype) with every ±inf filled."""
        values = np.array(X, copy=True)
        for col in range(values.shape[1]):
            pos = self.inf_fill_value
            neg = self.neg_inf_fill_value
            if pos is None:
                pos = self._fill_values[col]
            if neg is None:
                neg = self._neg_fill_values[col]
            column = values[:, col]
            column[np.isposinf(column)] = pos
            column[np.isneginf(column)] = neg
        return values

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {
            "inf_fill_value": self.inf_fill_value,
            "neg_inf_fill_value": self.neg_inf_fill_value,
            "strategy": self.strategy,
            "delta": self.delta,
        }

    def __repr__(self):
        return f"InfImputer(strategy={self.strategy!r}, delta={self.delta})"
