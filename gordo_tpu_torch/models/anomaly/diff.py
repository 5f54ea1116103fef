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
columnar path does. :meth:`DiffBasedAnomalyDetector.from_state` builds a
detector from plain numpy/JSON state, which is how a JAX-built detector
crosses into the port.
"""

from typing import Any, Mapping, Optional

import numpy as np

from ... import DeviceLike
from ..estimators import TorchAutoEncoder
from ..preprocessing import MinMaxScaler, Pipeline
from ..spec import FeedForwardSpec


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

        - ``spec``: the autoencoder's ``FeedForwardSpec.to_dict()``;
        - ``params``: ``{"dense_i": {"W", "b"}, "out": {...}}`` arrays;
        - ``pipeline``: the input scalers ahead of the autoencoder, each
          ``{"scale_": [...], "min_": [...]}`` (may be empty);
        - ``scaler``: the error scaler, same form;
        - optional ``feature_thresholds``, ``aggregate_threshold``,
          ``require_thresholds`` (default True), ``window`` and
          ``smoothing_method``.
        """
        estimator = TorchAutoEncoder(
            FeedForwardSpec.from_dict(state["spec"]), state["params"], device
        )
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

