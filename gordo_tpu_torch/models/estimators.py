"""
The port's ``JaxAutoEncoder`` (``gordo_tpu/models/estimators.py``):
``spec_``, ``params_`` and ``predict`` for serving, and the fit side
(``:143-263``): the definition's ``kind`` and kwargs (factory and fit
kwargs alike), ``fit``, which trains one model as the JAX estimator's
``fit_single`` does (``parallel.fleet.FleetTrainer.fit_single``), the
fit ``history``, and ``get_params`` for ``preprocessing.clone``.

:class:`TorchLSTMAutoEncoder` (lookahead 0) and :class:`TorchLSTMForecast`
(lookahead 1) are the JAX package's ``JaxLSTMAutoEncoder`` and
``JaxLSTMForecast`` (``:265-402``): many-to-one LSTMs over windows of
``lookback_window`` rows, whose output is ``lookback_window + lookahead -
1`` rows shorter than their input (the model offset). They never shuffle
between epochs, and ``predict`` forwards the windows 256 at a time,
gathered on the device, so a long series never has all its windows made
at once.

Params are held as float32 tensors on the estimator's device (``cuda``
unless the caller asks for the CPU) and pickled as host numpy arrays, so
an artifact is device-independent. An unpickled estimator holds host
arrays and no device until :meth:`TorchAutoEncoder.to` places it
(``serializer.load`` does); until then ``predict`` raises.
"""

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..ops.fleet_dense import fleet_feedforward
from ..ops.windows import model_offset, num_windows, window_targets
from . import factories
from .nn import Params, forward_lstm_windows, params_from_jax, params_to_numpy
from .spec import LSTMSpec, ModelSpec
from .training import History, fit_config_from_kwargs, split_fit_kwargs

#: the architecture factories a feedforward definition's ``kind`` may name
KINDS = {
    "feedforward_model": factories.feedforward_model,
    "feedforward_symmetric": factories.feedforward_symmetric,
    "feedforward_hourglass": factories.feedforward_hourglass,
}
#: the factories both LSTM estimators take
LSTM_KINDS = {
    "lstm_model": factories.lstm_model,
    "lstm_symmetric": factories.lstm_symmetric,
    "lstm_hourglass": factories.lstm_hourglass,
}
#: windows an LSTM's predict forwards at once
PREDICT_BATCH = 256


class NotFittedError(AttributeError):
    """The estimator has no params yet."""


def find_estimator(model: Any) -> Optional["TorchAutoEncoder"]:
    """The autoencoder inside a served object (detector and/or pipeline)."""
    obj = getattr(model, "base_estimator", model)
    obj = getattr(obj, "estimator", obj)
    return obj if isinstance(obj, TorchAutoEncoder) else None


class TorchAutoEncoder:
    """
    A feedforward autoencoder: ``spec_`` plus ``params_`` once fitted (or
    given), and, when made from a definition, its ``kind`` (a factory of
    :data:`KINDS`) and ``kwargs`` (factory and fit kwargs, as the
    definition gives them).
    """

    # class defaults: estimators pickled before the fit side existed load
    kind: Optional[str] = None
    _history: Optional[History] = None
    KINDS = KINDS

    def __init__(
        self,
        spec: Optional[ModelSpec] = None,
        params: Optional[Mapping[str, Mapping[str, Any]]] = None,
        device: DeviceLike = None,
        *,
        kind: Optional[str] = None,
        **kwargs,
    ):
        if kind is not None and kind not in self.KINDS:
            raise NotImplementedError(
                f"kind {kind!r} is not ported for {type(self).__name__}; known: {sorted(self.KINDS)}")
        self.spec_ = spec
        self.device: Optional[torch.device] = resolve_device(device)
        self.params_: Optional[Params] = (
            None if params is None else params_from_jax(params, self.device)
        )
        self.kind = kind
        self.kwargs: Dict[str, Any] = kwargs
        self._history: Optional[History] = None

    def build_spec(self, n_features: int, n_features_out: int) -> ModelSpec:
        """The spec ``kind``'s factory makes for these widths from the
        factory kwargs (the fit kwargs left out)."""
        if self.kind is None:
            raise ValueError(f"This {type(self).__name__} has no kind to build a spec from")
        _, factory_kwargs = split_fit_kwargs(self.kwargs)
        factory_kwargs.update(n_features=n_features, n_features_out=n_features_out)
        return self.KINDS[self.kind](**factory_kwargs)

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        """The constructor's arguments: ``kind`` and the kwargs (the spec
        when the estimator has no kind), and the device."""
        params: Dict[str, Any] = {"device": self.device}
        if self.kind is None:
            params["spec"] = self.spec_
        else:
            params["kind"] = self.kind
        params.update(self.kwargs)
        return params

    def fit(self, X, y, random: Any = None) -> "TorchAutoEncoder":
        """Train on ``X[rows, n_features]`` towards ``y`` on the
        estimator's device, as the JAX estimator's ``fit_single`` does
        (``random``: the trainer's random source, default
        ``TorchRandom``). Host callbacks other than ``EarlyStopping`` are
        refused."""
        from ..parallel.fleet import FleetMember, FleetTrainer

        X_arr = np.asarray(X, np.float32)
        y_arr = X_arr if y is X else np.asarray(y, np.float32)
        if y_arr.ndim == 1:
            y_arr = y_arr.reshape(-1, 1)
        if self.device is None:
            raise RuntimeError(f"This {type(self).__name__} is on no device; call .to(device) first")
        fit_kwargs, _ = split_fit_kwargs(self.kwargs)
        config, host_callbacks = fit_config_from_kwargs(fit_kwargs)
        if host_callbacks:
            raise NotImplementedError(f"host callbacks are not supported: {host_callbacks!r}")
        self.kwargs.update(n_features=X_arr.shape[-1], n_features_out=y_arr.shape[-1])
        self.spec_ = self.build_spec(X_arr.shape[-1], y_arr.shape[-1])
        member = FleetMember("estimator", self.spec_, X_arr, y_arr, seed=int(fit_kwargs.get("seed", 42)))
        result = FleetTrainer(self.device, random).fit_single(member, config)
        self.params_ = params_from_jax(result.params, self.device)
        self._history = result.history
        return self

    @property
    def history(self) -> Optional[History]:
        """The last fit's Keras-shaped history (None before a fit)."""
        return self._history

    def get_metadata(self) -> Dict[str, Any]:
        """``{"history": {...losses, "params": ...}}`` after a fit, as the
        JAX estimator reports it."""
        if self._history is None:
            return {}
        history: Dict[str, Any] = dict(self._history.history)
        history["params"] = self._history.params
        return {"history": history}

    def to(self, device: DeviceLike = None) -> "TorchAutoEncoder":
        """Place the params on ``device`` (``cuda`` unless the caller asks
        for the CPU); in place, returns self."""
        self.device = resolve_device(device)
        if self.params_ is not None:
            self.params_ = {
                key: {
                    name: torch.as_tensor(leaf, dtype=torch.float32, device=self.device)
                    for name, leaf in layer.items()
                }
                for key, layer in self.params_.items()
            }
        return self

    def predict(self, X) -> np.ndarray:
        """Reconstruction of ``X[rows, n_features]`` as float32 numpy, through
        the fleet kernel as a bucket of one on a CUDA device."""
        self._require_device()
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        single = {
            key: {name: t[None] for name, t in layer.items()}
            for key, layer in self.params_.items()
        }
        out = fleet_feedforward(self.spec_, single, x[None])[0]
        return out.cpu().numpy()

    def _require_device(self) -> None:
        if self.params_ is None or self.spec_ is None:
            raise NotFittedError(f"This {type(self).__name__} has not been fitted yet.")
        if self.device is None:
            raise RuntimeError(
                f"This {type(self).__name__} was unpickled and is on no device; "
                "call .to(device) first (serializer.load does)"
            )

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["device"] = None
        if state.get("params_") is not None:
            state["params_"] = params_to_numpy(state["params_"])
        return state

    def __repr__(self):
        if self.kind is not None:
            return f"{type(self).__name__}(kind={self.kind!r})"
        return f"{type(self).__name__}(spec={self.spec_!r})"


class TorchLSTMBaseEstimator(TorchAutoEncoder):
    """
    A many-to-one LSTM over sliding windows (``JaxLSTMBaseEstimator``):
    ``lookback_window`` and ``batch_size`` join the kwargs (the factory
    reads the one, the fit the other), ``lookahead`` is the subclass's.
    Made from a spec, the spec's ``lookback_window`` is the estimator's.
    """

    KINDS = LSTM_KINDS
    #: steps ahead in y the model targets
    lookahead = 0

    def __init__(
        self,
        spec: Optional[LSTMSpec] = None,
        params: Optional[Mapping[str, Mapping[str, Any]]] = None,
        device: DeviceLike = None,
        *,
        kind: Optional[str] = None,
        lookback_window: int = 1,
        batch_size: int = 32,
        **kwargs,
    ):
        if spec is not None:
            lookback_window = spec.lookback_window
        # the JAX estimator's kwargs order: the definition's, then these two
        super().__init__(spec, params, device, kind=kind, **kwargs, lookback_window=lookback_window,
                         batch_size=batch_size)
        self.lookback_window = int(lookback_window)
        self.batch_size = int(batch_size)

    @property
    def offset(self) -> int:
        """How many rows shorter than its input the output is."""
        return model_offset(self.lookback_window, self.lookahead)

    def _checked(self, X) -> np.ndarray:
        """``X`` as float32 rows; a lookback not under the row count raises
        ``ValueError`` (``_validate_and_fix_size_of_X``)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(len(X), 1)
        if self.lookback_window >= X.shape[0]:
            raise ValueError(f"For {type(self).__name__} lookback_window must be < size of X")
        return X

    def fit(self, X, y, random: Any = None) -> "TorchLSTMBaseEstimator":
        """Train on the windows of ``X[rows, n_features]`` towards ``y``'s
        rows ``offset`` on, never shuffled, as the JAX estimator's
        ``fit_single`` over its windows does, the windows gathered on the
        device (``random``: the trainer's random source, default
        ``TorchRandom``)."""
        from ..parallel.fleet import FleetTrainer, WindowedFleetMember

        X_arr = self._checked(X)
        y_arr = np.asarray(y, np.float32)
        if y_arr.ndim == 1:
            y_arr = y_arr.reshape(-1, 1)
        if self.device is None:
            raise RuntimeError(f"This {type(self).__name__} is on no device; call .to(device) first")
        fit_kwargs, _ = split_fit_kwargs(self.kwargs)
        fit_kwargs["shuffle"] = False  # time series train in order (models.py:613-615)
        config, host_callbacks = fit_config_from_kwargs(fit_kwargs)
        if host_callbacks:
            raise NotImplementedError(f"host callbacks are not supported: {host_callbacks!r}")
        self.kwargs.update(n_features=X_arr.shape[-1], n_features_out=y_arr.shape[-1])
        self.spec_ = self.build_spec(X_arr.shape[-1], y_arr.shape[-1])
        member = WindowedFleetMember(
            "estimator", self.spec_, X_arr, window_targets(y_arr, self.lookback_window, self.lookahead),
            seed=int(fit_kwargs.get("seed", 42)),
        )
        result = FleetTrainer(self.device, random).fit_single(member, config)
        self.params_ = params_from_jax(result.params, self.device)
        self._history = result.history
        return self

    def get_metadata(self) -> Dict[str, Any]:
        """The fit history, as for the feedforward estimator, and
        ``forecast_steps`` (the lookahead)."""
        return {**super().get_metadata(), "forecast_steps": self.lookahead}

    def predict(self, X) -> np.ndarray:
        """The output for every window of ``X[rows, n_features]``:
        ``[rows - offset, n_features_out]`` float32, the windows forwarded
        ``PREDICT_BATCH`` at a time on the estimator's device."""
        self._require_device()
        X = self._checked(X)
        count = num_windows(len(X), self.lookback_window, self.lookahead)  # >= 1 once checked
        single = {key: {name: t[None] for name, t in layer.items()} for key, layer in self.params_.items()}
        series = torch.as_tensor(X, device=self.device)[None]
        order = torch.arange(count, device=self.device)[None]
        return forward_lstm_windows(self.spec_, single, series, order, PREDICT_BATCH)[0].cpu().numpy()


class TorchLSTMAutoEncoder(TorchLSTMBaseEstimator):
    """Reconstructs each window's last row (lookahead 0, offset
    ``lookback_window - 1``)."""

    lookahead = 0


class TorchLSTMForecast(TorchLSTMBaseEstimator):
    """Forecasts the row after each window (lookahead 1, offset
    ``lookback_window``)."""

    lookahead = 1
