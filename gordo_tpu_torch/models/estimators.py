"""
The port's ``JaxAutoEncoder`` (``gordo_tpu/models/estimators.py``):
``spec_``, ``params_`` and ``predict`` for serving, and the fit side
(``:143-263``): the definition's ``kind`` and kwargs (factory and fit
kwargs alike), ``fit``, which trains a fleet of one through
``parallel.fleet.FleetTrainer``, and the fit ``history``.

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
from . import factories
from .nn import Params, params_from_jax, params_to_numpy
from .spec import FeedForwardSpec
from .training import History, fit_config_from_kwargs, split_fit_kwargs

#: the architecture factories a definition's ``kind`` may name
KINDS = {
    "feedforward_model": factories.feedforward_model,
    "feedforward_symmetric": factories.feedforward_symmetric,
    "feedforward_hourglass": factories.feedforward_hourglass,
}


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

    def __init__(
        self,
        spec: Optional[FeedForwardSpec] = None,
        params: Optional[Mapping[str, Mapping[str, Any]]] = None,
        device: DeviceLike = None,
        *,
        kind: Optional[str] = None,
        **kwargs,
    ):
        if kind is not None and kind not in KINDS:
            raise NotImplementedError(f"kind {kind!r} is not ported; known: {sorted(KINDS)}")
        self.spec_ = spec
        self.device: Optional[torch.device] = resolve_device(device)
        self.params_: Optional[Params] = (
            None if params is None else params_from_jax(params, self.device)
        )
        self.kind = kind
        self.kwargs: Dict[str, Any] = kwargs
        self._history: Optional[History] = None

    def build_spec(self, n_features: int, n_features_out: int) -> FeedForwardSpec:
        """The spec ``kind``'s factory makes for these widths from the
        factory kwargs (the fit kwargs left out)."""
        if self.kind is None:
            raise ValueError(f"This {type(self).__name__} has no kind to build a spec from")
        _, factory_kwargs = split_fit_kwargs(self.kwargs)
        factory_kwargs.update(n_features=n_features, n_features_out=n_features_out)
        return KINDS[self.kind](**factory_kwargs)

    def fit(self, X, y, random: Any = None) -> "TorchAutoEncoder":
        """Train on ``X[rows, n_features]`` towards ``y`` as a fleet of one
        on the estimator's device (``random``: the trainer's random
        source, default ``TorchRandom``). Host callbacks other than
        ``EarlyStopping`` are refused."""
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
        self.spec_ = self.build_spec(X_arr.shape[-1], y_arr.shape[-1])
        member = FleetMember("estimator", self.spec_, X_arr, y_arr, seed=int(fit_kwargs.get("seed", 42)))
        result = FleetTrainer(self.device, random).train([member], config)[0]
        if result.error is not None:
            raise result.error
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
        if self.params_ is None or self.spec_ is None:
            raise NotFittedError(f"This {type(self).__name__} has not been fitted yet.")
        if self.device is None:
            raise RuntimeError(
                f"This {type(self).__name__} was unpickled and is on no device; "
                "call .to(device) first (serializer.load does)"
            )
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        single = {
            key: {name: t[None] for name, t in layer.items()}
            for key, layer in self.params_.items()
        }
        out = fleet_feedforward(self.spec_, single, x[None])[0]
        return out.cpu().numpy()

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
