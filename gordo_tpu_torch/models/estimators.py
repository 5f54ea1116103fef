"""
The serving surface of the JAX package's ``JaxAutoEncoder``
(``gordo_tpu/models/estimators.py``): ``spec_``, ``params_`` and
``predict``. Training waits for a later slice of the port.

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
from .nn import Params, params_from_jax, params_to_numpy
from .spec import FeedForwardSpec


class NotFittedError(AttributeError):
    """The estimator has no params yet."""


def find_estimator(model: Any) -> Optional["TorchAutoEncoder"]:
    """The autoencoder inside a served object (detector and/or pipeline)."""
    obj = getattr(model, "base_estimator", model)
    obj = getattr(obj, "estimator", obj)
    return obj if isinstance(obj, TorchAutoEncoder) else None


class TorchAutoEncoder:
    """A fitted feedforward autoencoder: ``spec_`` plus ``params_``."""

    def __init__(
        self,
        spec: Optional[FeedForwardSpec] = None,
        params: Optional[Mapping[str, Mapping[str, Any]]] = None,
        device: DeviceLike = None,
    ):
        self.spec_ = spec
        self.device: Optional[torch.device] = resolve_device(device)
        self.params_: Optional[Params] = (
            None if params is None else params_from_jax(params, self.device)
        )

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
        return f"{type(self).__name__}(spec={self.spec_!r})"
