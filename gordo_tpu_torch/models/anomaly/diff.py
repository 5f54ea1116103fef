"""
The ``DiffBasedAnomalyDetector`` of ``gordo_tpu/models/anomaly/diff.py``:
the base estimator (a pipeline of the input scaler and the autoencoder),
the error ``scaler``, the fitted ``feature_thresholds_`` /
``aggregate_threshold_``, ``require_thresholds``, ``shuffle``, ``window``
and ``smoothing_method``. Two builders train it. The sequential one
(``builder/build_model.py``) calls :meth:`DiffBasedAnomalyDetector.fit`
(the base estimator on rows in ``sklearn.utils.shuffle``'s order when
``shuffle`` is set, then the error scaler on ``y``) and
:meth:`DiffBasedAnomalyDetector.cross_validate` (``diff.py:149-228``). The
fleet builder (``parallel/fleet_build.py``) trains every fold of every
machine at once and hands each fold's errors to the same threshold
functions: :func:`fold_errors`, :func:`rolling_min_max`,
:meth:`DiffBasedAnomalyDetector.fold_thresholds` and
:meth:`DiffBasedAnomalyDetector.set_fold_thresholds`.

The anomaly math itself lives in ``server/wire/assemble.py``, composed as
numpy columns around the fused reconstruction, as the JAX server's
columnar path does, with ``y``'s last rows set against an LSTM's shorter
output (``diff.py:294-305``; the fleet builder aligns its CV test rows the
same way, ``:189-190``); the detectors' smoothing (:func:`smooth`, pandas'
rolling median, rolling mean and ``ewm`` in numpy) lives here and serves
both ``?all_columns`` and the KFCV thresholds.
:meth:`DiffBasedAnomalyDetector.anomaly` gives the same table for a
frame, what the ``score`` command writes.

``DiffBasedKFCVAnomalyDetector`` is the KFold variant
(``diff.py:365-462``): cross-validated with ``KFold(5, shuffle=True,
random_state=0)`` by the fleet builder and by default, with the
evaluation's splitter by the sequential builder, its folds' errors
stitched back into row order
(:meth:`DiffBasedKFCVAnomalyDetector.set_kfcv_thresholds`); its
thresholds are the ``threshold_percentile`` quantile of the smoothed
errors (:meth:`DiffBasedKFCVAnomalyDetector.calculate_threshold`). It
keeps no per-fold or smoothed thresholds, and serves without them.

:meth:`DiffBasedAnomalyDetector.from_state` builds a detector from plain
numpy/JSON state, which is how a JAX-built detector crosses into the
port.
"""

import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ... import DeviceLike
from ..estimators import TorchAutoEncoder, TorchLSTMAutoEncoder, TorchLSTMForecast
from ..metrics import explained_variance_score
from ..model_selection import KFold, TimeSeriesSplit, cross_validate, shuffle_indices
from ..preprocessing import MinMaxScaler, Pipeline, transformer_from_state
from ..spec import LSTMSpec, spec_from_dict


#: window elements reduced at once by :func:`smooth` (32 MB of float64)
_SMOOTH_BLOCK = 1 << 22


def smooth(model: Any, values: np.ndarray) -> np.ndarray:
    """The detector's smoothing of a column (1-D) or of each column of a
    matrix (2-D), as pandas computes it over the JAX package's frames
    (``gordo_tpu/models/anomaly/diff.py::_smoothing``): ``smm``
    ``rolling(window).median()``, ``sma`` ``rolling(window).mean()``, both
    NaN for the first ``window - 1`` rows and for every window that holds
    a NaN; ``ewma`` ``ewm(span=window).mean()``."""
    values = np.asarray(values, np.float64)
    window = int(model.window)
    if model.smoothing_method == "ewma":
        return _ewma(values, window)
    if model.smoothing_method not in ("smm", "sma"):
        raise ValueError(f"Unknown smoothing_method {model.smoothing_method!r}")
    out = np.full(values.shape, np.nan)
    if len(values) >= window:
        windows = np.lib.stride_tricks.sliding_window_view(values, window, axis=0)
        reduce = np.median if model.smoothing_method == "smm" else np.mean
        # the reduction copies the windows it reads: a block of them at a time
        step = max(1, _SMOOTH_BLOCK // (window * max(1, values[0].size)))
        for start in range(0, len(windows), step):
            block = windows[start: start + step]
            out[window - 1 + start: window - 1 + start + len(block)] = reduce(block, axis=-1)  # NaN in, NaN out
    return out


def _ewma(values: np.ndarray, span: int) -> np.ndarray:
    """pandas' ``ewm(span=span).mean()`` (``adjust=True``,
    ``min_periods=0``, ``ignore_na=False``) with its own recurrence: a
    weighted mean whose old weight decays by ``1 - alpha`` a row, NaN
    rows included, and grows by 1 with each reading; NaN until a column's
    first reading."""
    alpha = 1.0 / (1.0 + (span - 1) / 2.0)
    decay = 1.0 - alpha
    rows = values if values.ndim == 2 else values[:, None]
    out = np.empty_like(rows)
    if not len(rows):
        return out.reshape(values.shape)
    weighted = rows[0].copy()
    old_wt = np.ones(rows.shape[1])
    out[0] = weighted
    for i in range(1, len(rows)):
        cur = rows[i]
        seen, observed = ~np.isnan(weighted), ~np.isnan(cur)
        old_wt = np.where(seen, old_wt * decay, old_wt)
        update = seen & observed & (weighted != cur)
        with np.errstate(invalid="ignore"):
            mixed = (old_wt * weighted + cur) / (old_wt + 1.0)
        weighted = np.where(update, mixed, np.where(~seen & observed, cur, weighted))
        old_wt = np.where(seen & observed, old_wt + 1.0, old_wt)
        out[i] = weighted
    return out.reshape(values.shape)


def rolling_min_max(values: np.ndarray, window: int):
    """
    ``pd.Series(values).rolling(window).min().max()`` in numpy: the max
    over time of the minimum of each ``window``-row run. A run holding a
    NaN has a NaN minimum and is skipped by the max; no complete run, or
    only NaN ones, gives NaN. ``[n]`` gives a float, ``[n, k]`` a ``[k]``.

    >>> rolling_min_max(np.array([3.0, 1.0, 4.0, 1.0, 5.0, 9.0]), 2)
    5.0
    """
    values = np.asarray(values, np.float64)
    if len(values) < window:
        return np.nan if values.ndim == 1 else np.full(values.shape[1], np.nan)
    mins = np.lib.stride_tricks.sliding_window_view(values, window, axis=0).min(axis=-1)
    if np.isnan(mins).any():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slice
            out = np.nanmax(mins, axis=0)
    else:
        out = mins.max(axis=0)
    return float(out) if values.ndim == 1 else out


def fold_errors(scaler: Any, y_true, y_pred) -> Tuple[np.ndarray, np.ndarray]:
    """A fold's errors on its test rows: each row's MSE between the
    prediction and ``y_true`` after the fold model's fitted error
    ``scaler`` (any of ``models/preprocessing.py``'s), and the absolute
    error of each tag (``_scaled_mse_per_timestep``, ``_absolute_error``)."""
    y_true = np.asarray(y_true)
    scaled_mse = np.mean(np.square(scaler.transform(y_pred) - scaler.transform(y_true)), axis=1)
    return scaled_mse, np.abs(y_true - np.asarray(y_pred))


class DiffBasedAnomalyDetector:
    """Diff-error anomaly detection around ``base_estimator``."""

    #: class default: detectors pickled before ``shuffle`` existed load
    shuffle = False

    def __init__(
        self,
        base_estimator: Any,
        scaler: Optional[Any] = None,
        require_thresholds: bool = True,
        window: Optional[int] = None,
        smoothing_method: Optional[str] = None,
        feature_thresholds: Optional[Any] = None,
        aggregate_threshold: Optional[float] = None,
        shuffle: bool = False,
    ):
        self.base_estimator = base_estimator
        self.scaler = scaler if scaler is not None else MinMaxScaler()
        self.require_thresholds = require_thresholds
        self.shuffle = bool(shuffle)
        self.window = window
        self.smoothing_method = smoothing_method
        if window is not None and smoothing_method is None:
            self.smoothing_method = "smm"
        self.feature_thresholds_ = (
            None
            if feature_thresholds is None
            else np.asarray(feature_thresholds, np.float64)
        )
        self.aggregate_threshold_ = (
            None if aggregate_threshold is None else float(aggregate_threshold)
        )

    def get_params(self, deep: bool = False) -> dict:
        return {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "require_thresholds": self.require_thresholds,
            "window": self.window,
            "smoothing_method": self.smoothing_method,
            "shuffle": self.shuffle,
        }

    def fit(self, X, y, **fit_kwargs) -> "DiffBasedAnomalyDetector":
        """Fit the base estimator (on ``shuffle_indices(n, 0)``'s row
        order when ``shuffle`` is set; ``fit_kwargs`` go to its ``fit``),
        then the error scaler on ``y``."""
        X, y = np.asarray(X), np.asarray(y)
        if self.shuffle:
            order = shuffle_indices(len(X), random_state=0)
            self.base_estimator.fit(X[order], y[order], **fit_kwargs)
        else:
            self.base_estimator.fit(X, y, **fit_kwargs)
        self.scaler.fit(y)
        return self

    def cross_validate(self, *, X, y, cv: Any = None, **kwargs) -> Dict[str, Any]:
        """
        :func:`~..model_selection.cross_validate` of this detector (default
        ``TimeSeriesSplit(3)``; ``kwargs`` pass on, ``scoring`` and
        ``fit_params`` among them), then its thresholds from each fold's
        errors on its test rows, the last rows of the fold as many as the
        model's output has (an LSTM's is shorter): per fold, and the last
        fold's as the thresholds. The per-fold smoothed thresholds are
        empty without a ``window``, as the JAX detector leaves them.
        """
        cv = cv if cv is not None else TimeSeriesSplit(n_splits=3)
        kwargs.update(return_estimator=True, return_indices=True, return_predictions=True)
        out = cross_validate(self, X, y, cv=cv, **kwargs)
        y = np.asarray(y)
        folds = []
        for test, fold_model, y_pred in zip(out["indices"]["test"], out["estimator"], out.pop("predictions")):
            test = test[len(test) - len(y_pred):]
            folds.append(self.fold_thresholds(*fold_errors(fold_model.scaler, y[test], y_pred)))
        self.set_fold_thresholds(folds, range(y.shape[1]))
        if self.window is None:
            self.smooth_feature_thresholds_per_fold_ = {}
            self.smooth_aggregate_thresholds_per_fold_ = {}
        return out

    def fold_thresholds(self, scaled_mse: np.ndarray, abs_err: np.ndarray) -> Dict[str, Any]:
        """One fold's thresholds from its errors: the max over time of the
        6-row rolling minimum, and of the ``window``-row one when the
        detector smooths."""
        out = {"aggregate": rolling_min_max(scaled_mse, 6), "feature": rolling_min_max(abs_err, 6)}
        if self.window is not None:
            out["smooth_aggregate"] = rolling_min_max(scaled_mse, self.window)
            out["smooth_feature"] = rolling_min_max(abs_err, self.window)
        return out

    def set_fold_thresholds(self, folds: Sequence[Dict[str, Any]], columns: Sequence[Any]) -> None:
        """Set the thresholds from :meth:`fold_thresholds` of every fold in
        order: each fold's as ``fold-<i>`` (a feature's keyed by its column
        name, as ``DataFrame(folds).T.to_dict()`` keys them), the last
        fold's as the detector's."""
        columns = list(columns)

        def per_column(key: str) -> Dict[Any, Dict[str, float]]:
            return {col: {f"fold-{i}": float(f[key][j]) for i, f in enumerate(folds)} for j, col in enumerate(columns)}

        last = folds[-1]
        self.feature_thresholds_ = np.asarray(last["feature"], np.float64)
        self.aggregate_threshold_ = last["aggregate"]
        self.feature_thresholds_per_fold_ = per_column("feature")
        self.aggregate_thresholds_per_fold_ = {f"fold-{i}": f["aggregate"] for i, f in enumerate(folds)}
        self.smooth_aggregate_threshold_ = last.get("smooth_aggregate")
        self.smooth_feature_thresholds_ = last.get("smooth_feature")
        if self.window is not None:
            self.smooth_feature_thresholds_per_fold_ = per_column("smooth_feature")
            self.smooth_aggregate_thresholds_per_fold_ = {
                f"fold-{i}": f["smooth_aggregate"] for i, f in enumerate(folds)}

    def predict(self, X) -> np.ndarray:
        return self.base_estimator.predict(X)

    def anomaly(self, X, y, frequency: Optional[Any] = None) -> Any:
        """The anomaly frame of ``X`` against ``y`` (``diff.py:254-364``):
        the base estimator's prediction (on a card, one K1 launch for a
        feedforward autoencoder) assembled by
        ``server/wire/assemble.py::anomaly_table`` into the ``WireTable``
        the anomaly route answers with ``?all_columns``, the ``smooth-*``
        groups included when the detector smooths, as the JAX frame
        includes them. ``X`` and ``y`` are request frames
        (``json_codec.Frame``: ``index``, ``columns``, ``values``);
        ``frequency`` (a ``timedelta``) fills the ``end`` column."""
        from ...server.wire.assemble import anomaly_table

        if not hasattr(X, "values"):
            raise ValueError("Unable to find X.values property")
        return anomaly_table(self, X, y, self.predict(np.asarray(X.values)), frequency, keep_smooth=True)

    def score(self, X, y) -> float:
        """Explained variance of the prediction against ``y``'s last rows,
        as many as the model gives (an LSTM's output is shorter by its
        offset; ``diff.py:147``)."""
        out = np.asarray(self.predict(X))
        y = np.asarray(y, np.float64)
        return float(np.mean(explained_variance_score(y[len(y) - len(out):], out)))

    def get_metadata(self) -> dict:
        """The thresholds and settings a build records under
        ``model_meta``, with the keys of the JAX detector's
        ``get_metadata`` (the estimator's fit history included)."""
        metadata: dict = {}
        if self.feature_thresholds_ is not None:
            metadata["feature-thresholds"] = self.feature_thresholds_.tolist()
        if self.aggregate_threshold_ is not None:
            metadata["aggregate-threshold"] = self.aggregate_threshold_
        for attr, key in (
            ("feature_thresholds_per_fold_", "feature-thresholds-per-fold"),
            ("aggregate_thresholds_per_fold_", "aggregate-thresholds-per-fold"),
        ):
            if getattr(self, attr, None) is not None:
                metadata[key] = getattr(self, attr)
        metadata["window"] = self.window
        metadata["smoothing-method"] = self.smoothing_method
        for attr, key in (
            ("smooth_feature_thresholds_", "smooth-feature-thresholds"),
            ("smooth_aggregate_threshold_", "smooth-aggregate-threshold"),
            ("smooth_feature_thresholds_per_fold_", "smooth-feature-thresholds-per-fold"),
            ("smooth_aggregate_thresholds_per_fold_", "smooth-aggregate-thresholds-per-fold"),
        ):
            value = getattr(self, attr, None)
            if value is not None:
                metadata[key] = value.tolist() if isinstance(value, np.ndarray) else value
        metadata.update(scaler=repr(self.scaler), base_estimator=repr(self.base_estimator), shuffle=self.shuffle)
        estimator = getattr(self.base_estimator, "estimator", self.base_estimator)
        if isinstance(estimator, TorchAutoEncoder):
            metadata.update(estimator.get_metadata())
        return metadata

    @classmethod
    def from_state(
        cls, state: Mapping[str, Any], device: DeviceLike = None
    ) -> "DiffBasedAnomalyDetector":
        """
        A detector from plain state, its autoencoder on ``device`` (``cuda``
        unless the caller asks for the CPU):

        - ``spec``: the autoencoder's ``to_dict()`` (a ``FeedForwardSpec``
          or an ``LSTMSpec``);
        - ``params``: ``{"dense_i": {"W", "b"}, "out": {...}}`` arrays, or
          an LSTM's ``{"lstm_i": {"Wx", "Wh", "b"}, "out": {...}}``;
        - for an LSTM, the estimator: ``estimator`` (its class name,
          ``JaxLSTMAutoEncoder`` or ``JaxLSTMForecast``) or ``lookahead``
          (0 or 1);
        - ``pipeline``: the transformers ahead of the autoencoder (may be
          empty), each the state
          :func:`~..preprocessing.transformer_from_state` reads: a
          ``type`` (``MinMaxScaler`` when absent, so ``{"scale_": [...],
          "min_": [...]}`` is a MinMax step), its arguments and its fitted
          attributes;
        - ``scaler``: the error scaler, same form;
        - optional ``feature_thresholds``, ``aggregate_threshold``,
          ``require_thresholds`` (default True), ``window`` and
          ``smoothing_method``.
        """
        spec = spec_from_dict(state["spec"])
        estimator_class = TorchAutoEncoder
        if isinstance(spec, LSTMSpec):
            lstm = {"JaxLSTMAutoEncoder": TorchLSTMAutoEncoder, "JaxLSTMForecast": TorchLSTMForecast,
                    0: TorchLSTMAutoEncoder, 1: TorchLSTMForecast}
            key = state.get("estimator", state.get("lookahead"))
            if key not in lstm:
                raise ValueError(f"an LSTM detector's state needs its estimator or lookahead, got {key!r}")
            estimator_class = lstm[key]
        estimator = estimator_class(spec, state["params"], device)
        steps = [(f"step_{i}", transformer_from_state(s)) for i, s in enumerate(state.get("pipeline") or ())]
        steps.append((f"step_{len(steps)}", estimator))
        return cls(
            base_estimator=Pipeline(steps),
            scaler=transformer_from_state(state["scaler"]),
            require_thresholds=bool(state.get("require_thresholds", True)),
            window=state.get("window"),
            smoothing_method=state.get("smoothing_method"),
            feature_thresholds=state.get("feature_thresholds"),
            aggregate_threshold=state.get("aggregate_threshold"),
        )

    def __repr__(self):
        return (
            f"{type(self).__name__}(base_estimator={self.base_estimator!r}, "
            f"scaler={self.scaler!r})"
        )



class DiffBasedKFCVAnomalyDetector(DiffBasedAnomalyDetector):
    """The KFold variant: shuffled, a 144-row rolling median, thresholds
    the 0.99 quantile of the smoothed errors by default."""

    def __init__(
        self,
        base_estimator: Any,
        scaler: Optional[Any] = None,
        require_thresholds: bool = True,
        shuffle: bool = True,
        window: int = 144,
        smoothing_method: str = "smm",
        threshold_percentile: float = 0.99,
        feature_thresholds: Optional[Any] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        super().__init__(
            base_estimator=base_estimator,
            scaler=scaler,
            require_thresholds=require_thresholds,
            window=window,
            smoothing_method=smoothing_method,
            feature_thresholds=feature_thresholds,
            aggregate_threshold=aggregate_threshold,
            shuffle=shuffle,
        )
        self.threshold_percentile = threshold_percentile

    def get_params(self, deep: bool = True) -> dict:
        return {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "window": self.window,
            "smoothing_method": self.smoothing_method,
            "shuffle": self.shuffle,
            "threshold_percentile": self.threshold_percentile,
        }

    def cross_validate(self, *, X, y, cv: Any = None, **kwargs) -> Dict[str, Any]:
        """:func:`~..model_selection.cross_validate` of this detector (default
        ``KFold(5, shuffle=True, random_state=0)``), then the thresholds of
        :meth:`set_kfcv_thresholds` from every fold's test rows
        (``diff.py:422-462``). A fold whose prediction is shorter than its
        test rows (an LSTM's) raises ``ValueError``."""
        cv = cv if cv is not None else KFold(n_splits=5, shuffle=True, random_state=0)
        kwargs.update(return_estimator=True, return_indices=True, return_predictions=True)
        out = cross_validate(self, X, y, cv=cv, **kwargs)
        y = np.asarray(y)
        parts = []
        for test, fold_model, y_pred in zip(out["indices"]["test"], out["estimator"], out.pop("predictions")):
            if len(y_pred) != len(test):
                raise ValueError(f"shape mismatch: a prediction of {len(y_pred)} rows for {len(test)} test rows")
            parts.append((test, *fold_errors(fold_model.scaler, y[test], y_pred)))
        self.set_kfcv_thresholds(y, parts)
        return out

    def set_kfcv_thresholds(self, y: np.ndarray, parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]) -> None:
        """The thresholds of every fold's ``(test rows, scaled MSE, absolute
        error)`` stitched into row order: a row no fold tested has a NaN
        MSE and its absolute error against a prediction of 0, as the JAX
        detector's zero-filled frame gives."""
        y = np.asarray(y, np.float64)
        mse_full = np.full(len(y), np.nan)
        abs_full = np.abs(y)
        for rows, mse_part, abs_part in parts:
            mse_full[rows] = mse_part
            abs_full[rows] = abs_part
        self.aggregate_threshold_ = float(self.calculate_threshold(mse_full))
        self.feature_thresholds_ = self.calculate_threshold(abs_full)

    def calculate_threshold(self, values: np.ndarray) -> Any:
        """``_calculate_threshold``: the ``threshold_percentile`` quantile
        (linear, NaN skipped, as pandas' ``quantile``) of the smoothed
        ``values``; a float for a column, an array for each column of a
        matrix. NaN where no smoothed value exists."""
        smoothed = smooth(self, values)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns stay NaN
            out = np.nanquantile(smoothed, self.threshold_percentile, axis=0)
        return float(out) if np.ndim(values) == 1 else np.asarray(out, np.float64)

    def get_metadata(self) -> dict:
        """The keys of the JAX detector's ``get_metadata`` with a pipeline
        as base estimator, then the estimator's fit history."""
        metadata: dict = {}
        if self.feature_thresholds_ is not None:
            metadata["feature-thresholds"] = self.feature_thresholds_.tolist()
        if self.aggregate_threshold_ is not None:
            metadata["aggregate-threshold"] = self.aggregate_threshold_
        metadata.update({
            "scaler": repr(self.scaler),
            "base_estimator": repr(self.base_estimator),
            "shuffle": self.shuffle,
            "window": self.window,
            "smoothing-method": self.smoothing_method,
            "threshold-percentile": self.threshold_percentile,
        })
        estimator = getattr(self.base_estimator, "estimator", self.base_estimator)
        if isinstance(estimator, TorchAutoEncoder):
            metadata.update(estimator.get_metadata())
        return metadata
