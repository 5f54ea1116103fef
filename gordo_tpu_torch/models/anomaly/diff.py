"""
The ``DiffBasedAnomalyDetector`` state that serving reads
(``gordo_tpu/models/anomaly/diff.py``): the base estimator (a pipeline of
the input scaler and the autoencoder), the error ``scaler``, the fitted
``feature_thresholds_`` / ``aggregate_threshold_``, ``require_thresholds``,
``window`` and ``smoothing_method``.

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

    def __init__(
        self,
        base_estimator: Any,
        scaler: MinMaxScaler,
        require_thresholds: bool = True,
        window: Optional[int] = None,
        smoothing_method: Optional[str] = None,
        feature_thresholds: Optional[Any] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        self.base_estimator = base_estimator
        self.scaler = scaler
        self.require_thresholds = require_thresholds
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

