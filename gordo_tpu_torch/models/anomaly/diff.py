"""
The ``DiffBasedAnomalyDetector`` of ``gordo_tpu/models/anomaly/diff.py``:
the base estimator (a pipeline of the input scaler and the autoencoder),
the error ``scaler``, the fitted ``feature_thresholds_`` /
``aggregate_threshold_``, ``require_thresholds``, ``shuffle``, ``window``
and ``smoothing_method``. The fleet builder (``parallel/fleet_build.py``)
trains it: the autoencoder on rows in ``sklearn.utils.shuffle``'s order
when ``shuffle`` is set, the thresholds from cross-validation, the error
scaler on ``y``.

The anomaly math itself lives in ``server/wire/assemble.py``, composed as
numpy columns around the fused reconstruction, as the JAX server's
columnar path does, with ``y``'s last rows set against an LSTM's shorter
output (``diff.py:294-305``; the fleet builder aligns its CV test rows the
same way, ``:189-190``); the detectors' smoothing (:func:`smooth`, pandas'
rolling median, rolling mean and ``ewm`` in numpy) lives here and serves
both ``?all_columns`` and the KFCV thresholds.

``DiffBasedKFCVAnomalyDetector`` is the KFold variant
(``diff.py:365-462``): the fleet builder cross-validates it with
``KFold(5, shuffle=True, random_state=0)`` and stitches the folds'
errors back into row order; its thresholds are the
``threshold_percentile`` quantile of the smoothed errors
(:meth:`DiffBasedKFCVAnomalyDetector.calculate_threshold`). It keeps no
per-fold or smoothed thresholds, and serves without them.

:meth:`DiffBasedAnomalyDetector.from_state` builds a detector from plain
numpy/JSON state, which is how a JAX-built detector crosses into the
port.
"""

import warnings
from typing import Any, Mapping, Optional

import numpy as np

from ... import DeviceLike
from ..estimators import TorchAutoEncoder, TorchLSTMAutoEncoder, TorchLSTMForecast
from ..metrics import explained_variance_score
from ..preprocessing import MinMaxScaler, Pipeline
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


class DiffBasedAnomalyDetector:
    """Diff-error anomaly detection around ``base_estimator``."""

    #: class default: detectors pickled before ``shuffle`` existed load
    shuffle = False

    def __init__(
        self,
        base_estimator: Any,
        scaler: Optional[MinMaxScaler] = None,
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

    def predict(self, X) -> np.ndarray:
        return self.base_estimator.predict(X)

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
        - ``pipeline``: the input scalers ahead of the autoencoder, each
          ``{"scale_": [...], "min_": [...]}`` (may be empty);
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
        steps = [
            (f"step_{i}", MinMaxScaler(s["scale_"], s["min_"]))
            for i, s in enumerate(state.get("pipeline") or ())
        ]
        steps.append((f"step_{len(steps)}", estimator))
        scaler = state["scaler"]
        return cls(
            base_estimator=Pipeline(steps),
            scaler=MinMaxScaler(scaler["scale_"], scaler["min_"]),
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
        scaler: Optional[MinMaxScaler] = None,
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
