"""
The preprocessing a detector holds, without scikit-learn: the stock
scalers, a ``FunctionTransformer`` over the port's own functions, a
``Pipeline`` and ``clone``.

The scalers stand in for ``sklearn.preprocessing``'s :class:`MinMaxScaler`,
:class:`StandardScaler`, :class:`MaxAbsScaler` and :class:`RobustScaler`:
as pipeline steps ahead of the estimator, as a detector's error
``scaler`` and as an evaluation's ``scoring_scaler``. They fit as
scikit-learn 1.x does, in float64 (NaN ignored, population variance,
sklearn's ``_handle_zeros_in_scale`` for near-zero scales), and keep its
fitted attributes. :class:`MinMaxScaler`'s ``transform`` gives float64;
the others follow sklearn's dtype flow (a copy in the input's float
dtype, then sklearn's in-place operations), so float32 rows round as
sklearn rounds them.

``affine()`` is each step's ``(scale, offset)`` with ``transform(X) ==
X * scale + offset``, as ``gordo_tpu/ingest/plan.py:60-122`` reads it;
the serving store composes a pipeline's steps into K1's ingest
prologue. A step that has no affine form (a clipping ``MinMaxScaler`` or
``MaxAbsScaler``, a ``FunctionTransformer``, the ``InfImputer`` of
``models/transformers/``) answers None or has no ``affine``, and its
pipeline is transformed on the host instead.

:class:`Pipeline` is the ``sklearn.pipeline.Pipeline`` stand-in: named
steps, transformers first, the estimator last; ``fit`` fits each
transformer on what the one before gives, then the estimator.

:func:`clone` is ``sklearn.base.clone`` for the port's objects: a fresh,
unfitted copy with the same constructor parameters (``get_params``).
:func:`transformer_from_state` makes a fitted step from plain state.
"""

import copy
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .transformer_funcs.general import multiply_by
from .transformers.imputer import InfImputer

Affine = Optional[Tuple[np.ndarray, np.ndarray]]


def _handle_zeros_in_scale(scale: np.ndarray, constant_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """sklearn's rule: a scale below ten machine epsilons (or flagged by
    ``constant_mask``) becomes 1."""
    scale = np.array(scale, copy=True)
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


def _float_copy(X) -> np.ndarray:
    """sklearn's ``validate_data(copy=True, dtype=FLOAT_DTYPES)``: a copy
    in the input's float dtype, float64 for anything else."""
    X = np.asarray(X)
    dtype = X.dtype if X.dtype in (np.float64, np.float32, np.float16) else np.float64
    return np.array(X, dtype=dtype, copy=True)


class MinMaxScaler:
    """Scale each feature to ``feature_range`` by ``X * scale_ + min_``,
    clipped to the range when ``clip`` is set.

    >>> s = MinMaxScaler().fit(np.array([[0.0, 10.0], [2.0, 30.0]]))
    >>> s.transform(np.array([[1.0, 20.0]])).tolist()
    [[0.5, 0.5]]
    """

    clip = False  # class default: scalers pickled before clip existed load

    def __init__(self, scale_=None, min_=None, feature_range: Tuple[float, float] = (0.0, 1.0), clip: bool = False):
        self.feature_range = tuple(feature_range)
        self.clip = bool(clip)
        self.scale_ = None if scale_ is None else np.asarray(scale_, np.float64)
        self.min_ = None if min_ is None else np.asarray(min_, np.float64)

    def fit(self, X, y=None) -> "MinMaxScaler":
        """Fit to the columns of ``X`` (NaN-ignoring, constant columns get
        scale 1, as sklearn's ``_handle_zeros_in_scale`` does)."""
        X = np.asarray(X, np.float64)
        data_min = np.nanmin(X, axis=0)
        data_range = _handle_zeros_in_scale(np.nanmax(X, axis=0) - data_min)
        low, high = self.feature_range
        self.scale_ = (high - low) / data_range
        self.min_ = low - data_min * self.scale_
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"feature_range": self.feature_range, "clip": self.clip}

    def transform(self, X) -> np.ndarray:
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        out = np.asarray(X, np.float64) * self.scale_ + self.min_
        if self.clip:
            np.clip(out, self.feature_range[0], self.feature_range[1], out=out)
        return out

    def affine(self) -> Affine:
        """``(scale, offset)`` with ``transform(X) == X * scale + offset``;
        None when clipping (not affine)."""
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        return None if self.clip else (self.scale_, self.min_)

    def __repr__(self):
        clip = ", clip=True" if self.clip else ""
        return f"MinMaxScaler(feature_range={self.feature_range}{clip})"


class StandardScaler:
    """``(X - mean_) / scale_`` per feature, ``scale_`` the population
    standard deviation (sklearn's corrected two-pass variance, NaN
    ignored).

    >>> StandardScaler().fit(np.array([[0.0], [2.0]])).transform(np.array([[3.0]])).tolist()
    [[2.0]]
    """

    def __init__(self, with_mean: bool = True, with_std: bool = True):
        self.with_mean = bool(with_mean)
        self.with_std = bool(with_std)

    def fit(self, X, y=None) -> "StandardScaler":
        X = np.asarray(X, np.float64)
        nan = np.isnan(X)
        total = np.nansum if nan.any() else np.sum
        count = X.shape[0] - nan.sum(axis=0)
        self.n_samples_seen_ = int(count[0]) if count.max() == count.min() else count
        if not self.with_mean and not self.with_std:
            self.mean_ = self.var_ = self.scale_ = None
            return self
        sums = total(X, axis=0)
        self.mean_ = sums / count
        if not self.with_std:
            self.var_ = self.scale_ = None
            return self
        temp = X - sums / count
        correction = total(temp, axis=0)
        temp **= 2
        unnormalized = total(temp, axis=0)
        unnormalized -= correction ** 2 / count
        self.var_ = unnormalized / count
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= self.n_samples_seen_ * eps * self.var_ + (self.n_samples_seen_ * self.mean_ * eps) ** 2
        self.scale_ = _handle_zeros_in_scale(np.sqrt(self.var_), constant)
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X) -> np.ndarray:
        if not hasattr(self, "n_samples_seen_"):
            raise AttributeError("StandardScaler is not fitted")
        X = _float_copy(X)
        if self.with_mean:
            X -= self.mean_.astype(X.dtype)
        if self.with_std:
            X /= self.scale_.astype(X.dtype)
        return X

    def affine(self) -> Affine:
        if not hasattr(self, "n_samples_seen_"):
            raise AttributeError("StandardScaler is not fitted")
        s = 1.0 / self.scale_ if self.with_std and self.scale_ is not None else np.asarray(1.0)
        o = -(self.mean_ * s) if self.with_mean and self.mean_ is not None else np.asarray(0.0)
        return np.asarray(s), np.asarray(o)

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"with_mean": self.with_mean, "with_std": self.with_std}

    def __repr__(self):
        return f"StandardScaler(with_mean={self.with_mean}, with_std={self.with_std})"


class MaxAbsScaler:
    """``X / scale_`` per feature, ``scale_`` the largest absolute value
    (NaN ignored), clipped to [-1, 1] when ``clip`` is set.

    >>> MaxAbsScaler().fit(np.array([[-4.0], [2.0]])).transform(np.array([[2.0]])).tolist()
    [[0.5]]
    """

    def __init__(self, clip: bool = False):
        self.clip = bool(clip)

    def fit(self, X, y=None) -> "MaxAbsScaler":
        X = np.asarray(X, np.float64)
        self.n_samples_seen_ = X.shape[0]
        self.max_abs_ = np.nanmax(np.abs(X), axis=0)
        self.scale_ = _handle_zeros_in_scale(self.max_abs_)
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X) -> np.ndarray:
        if not hasattr(self, "scale_"):
            raise AttributeError("MaxAbsScaler is not fitted")
        X = _float_copy(X)
        X /= self.scale_
        if self.clip:
            np.clip(X, -1.0, 1.0, out=X)
        return X

    def affine(self) -> Affine:
        if not hasattr(self, "scale_"):
            raise AttributeError("MaxAbsScaler is not fitted")
        return None if self.clip else (1.0 / self.scale_, np.asarray(0.0))

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"clip": self.clip}

    def __repr__(self):
        return f"MaxAbsScaler(clip={self.clip})" if self.clip else "MaxAbsScaler()"


class RobustScaler:
    """``(X - center_) / scale_`` per feature: the median, and the
    ``quantile_range`` interquartile range (``np.nanpercentile``), divided
    by the normal's when ``unit_variance`` is set.

    >>> RobustScaler().fit(np.array([[1.0], [2.0], [3.0]])).transform(np.array([[3.0]])).tolist()
    [[1.0]]
    """

    def __init__(
        self,
        with_centering: bool = True,
        with_scaling: bool = True,
        quantile_range: Tuple[float, float] = (25.0, 75.0),
        unit_variance: bool = False,
    ):
        self.with_centering = bool(with_centering)
        self.with_scaling = bool(with_scaling)
        self.quantile_range = tuple(quantile_range)
        self.unit_variance = bool(unit_variance)

    def fit(self, X, y=None) -> "RobustScaler":
        X = np.asarray(X, np.float64)
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"Invalid quantile range: {self.quantile_range}")
        self.center_ = np.nanmedian(X, axis=0) if self.with_centering else None
        if self.with_scaling:
            quantiles = np.transpose([np.nanpercentile(X[:, j], self.quantile_range) for j in range(X.shape[1])])
            self.scale_ = _handle_zeros_in_scale(quantiles[1] - quantiles[0])
            if self.unit_variance:
                from scipy.stats import norm

                self.scale_ = self.scale_ / (norm.ppf(q_max / 100.0) - norm.ppf(q_min / 100.0))
        else:
            self.scale_ = None
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X) -> np.ndarray:
        if not hasattr(self, "center_"):
            raise AttributeError("RobustScaler is not fitted")
        X = _float_copy(X)
        if self.with_centering:
            X -= self.center_
        if self.with_scaling:
            X /= self.scale_
        return X

    def affine(self) -> Affine:
        if not hasattr(self, "center_"):
            raise AttributeError("RobustScaler is not fitted")
        s = 1.0 / self.scale_ if self.with_scaling and self.scale_ is not None else np.asarray(1.0)
        o = -(self.center_ * s) if self.with_centering and self.center_ is not None else np.asarray(0.0)
        return np.asarray(s), np.asarray(o)

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {
            "with_centering": self.with_centering,
            "with_scaling": self.with_scaling,
            "quantile_range": self.quantile_range,
            "unit_variance": self.unit_variance,
        }

    def __repr__(self):
        return f"RobustScaler(quantile_range={self.quantile_range}, unit_variance={self.unit_variance})"


#: the functions a ``FunctionTransformer`` may name: the JAX package's
#: paths and the reference's, never imported by name
FUNCTIONS: Dict[str, Callable] = {
    "gordo_tpu.models.transformer_funcs.general.multiply_by": multiply_by,
    "gordo.machine.model.transformer_funcs.general.multiply_by": multiply_by,
}


class FunctionTransformer:
    """``func(X, **kw_args)`` (identity when ``func`` is None), ``func`` a
    path of :data:`FUNCTIONS`. Stateless; not affine to the serving store,
    as the JAX package's ingest plan matches stock scalers only.

    >>> path = "gordo_tpu.models.transformer_funcs.general.multiply_by"
    >>> FunctionTransformer(path, kw_args={"factor": 3}).transform(np.array([[1.0]])).tolist()
    [[3.0]]
    """

    def __init__(self, func: Optional[str] = None, kw_args: Optional[Mapping[str, Any]] = None):
        if func is not None and func not in FUNCTIONS:
            raise NotImplementedError(f"FunctionTransformer: function {func!r} is not ported; known: "
                                      f"{sorted(FUNCTIONS)}")
        self.func = func
        self.kw_args = dict(kw_args or {})

    def fit(self, X, y=None) -> "FunctionTransformer":
        return self

    def fit_transform(self, X, y=None):
        return self.transform(X)

    def transform(self, X):
        if self.func is None:
            return X
        return FUNCTIONS[self.func](X, **self.kw_args)

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"func": self.func, "kw_args": self.kw_args}

    def __repr__(self):
        return f"FunctionTransformer(func={self.func!r}, kw_args={self.kw_args!r})"


#: every step :func:`transformer_from_state` makes, by its ``type``
TRANSFORMERS = {
    cls.__name__: cls
    for cls in (MinMaxScaler, StandardScaler, MaxAbsScaler, RobustScaler, InfImputer, FunctionTransformer)
}


def transformer_from_state(state: Mapping[str, Any]) -> Any:
    """A fitted pipeline step or scaler from plain state: ``type`` (a name
    of :data:`TRANSFORMERS`, default ``MinMaxScaler``), its constructor
    arguments, and its fitted attributes (names that end or begin with
    ``_``, arrays as lists or numpy).

    >>> step = transformer_from_state({"type": "StandardScaler", "mean_": [1.0], "scale_": [2.0],
    ...                                "var_": [4.0], "n_samples_seen_": 3})
    >>> step.transform(np.array([[5.0]])).tolist()
    [[2.0]]
    """
    state = dict(state)
    kind = state.pop("type", "MinMaxScaler")
    if kind not in TRANSFORMERS:
        raise NotImplementedError(f"transformer {kind!r} is not ported; known: {sorted(TRANSFORMERS)}")
    fitted = {k: v for k, v in state.items() if k.endswith("_") or k.startswith("_")}
    params = {k: v for k, v in state.items() if k not in fitted}
    if kind == "MinMaxScaler":
        return MinMaxScaler(**params, **fitted)
    step = TRANSFORMERS[kind](**params)
    for name, value in fitted.items():
        setattr(step, name, value if value is None or np.isscalar(value) else np.asarray(value, np.float64))
    return step


class Pipeline:
    """Named steps: transformers, then an estimator."""

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

    def fit(self, X, y, **fit_kwargs) -> "Pipeline":
        """Fit each transformer on the output of the ones before it, then
        the estimator on the result towards ``y`` (``fit_kwargs`` go to
        the estimator's ``fit``)."""
        X = np.asarray(X, np.float64)
        for step in self.transformers:
            X = step.fit_transform(X)
        self.estimator.fit(X, y, **fit_kwargs)
        return self

    def fit_transform(self, X, y) -> np.ndarray:
        return self.fit(X, y).predict(X)

    def predict(self, X) -> np.ndarray:
        return self.estimator.predict(self.transform_input(X))

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"steps": self.steps}

    def __repr__(self):
        return f"Pipeline(steps={self.steps!r})"


def clone(obj: Any) -> Any:
    """A fresh unfitted copy of a port estimator, detector, pipeline or
    scaler: its class made again from ``get_params()``, each parameter
    cloned in turn (lists and tuples item by item); a value without
    ``get_params`` is deep-copied.

    >>> s = MinMaxScaler(feature_range=(0, 2)).fit(np.ones((2, 1)))
    >>> c = clone(s)
    >>> c.feature_range, c.scale_
    ((0, 2), None)
    """
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone(item) for item in obj)
    if not hasattr(obj, "get_params"):
        return copy.deepcopy(obj)
    return type(obj)(**{name: clone(value) for name, value in obj.get_params(deep=False).items()})
