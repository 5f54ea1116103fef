"""
Port objects to model definitions: the inverse of ``from_definition``,
the counterpart of ``gordo_tpu/serializer/into_definition.py``.

A definition names the **JAX package's** classes, as the JAX package
writes it: its ``into_definition`` walks ``get_params(deep=False)`` of
live sklearn and JAX objects and names each by its class's module, so a
MinMax scaler is ``sklearn.preprocessing._data.MinMaxScaler`` and an
autoencoder ``gordo_tpu.models.estimators.JaxAutoEncoder``. The port
imports neither package, so :data:`JAX_CLASSES` holds, for each port
class, the JAX class's dotted path and the parameters its
``get_params(deep=False)`` gives at their defaults, in their order. A
port object's own parameters replace those defaults where their values
differ (a value equal to the default keeps the default's form, so
``(0.0, 1.0)`` stays sklearn's ``(0, 1)``; a tuple-typed one that differs
is a tuple, as the JAX reader makes one of the YAML's list).

- A detector gives ``base_estimator``, ``scaler`` and ``shuffle``, and
  ``window`` and ``smoothing_method`` when it smooths (the JAX detector
  leaves out ``require_thresholds``); the KFold detector gives all six of
  its parameters.
- A pipeline gives sklearn's ``memory``, ``steps`` (each step's
  definition), ``transform_input`` and ``verbose``.
- An autoencoder gives the JAX estimator's ``into_definition`` hook: its
  kwargs as the definition gave them, callbacks as their definitions,
  then ``kind``.

``into_definition(from_definition(d))`` is what the ``build`` command
records (``gordo_tpu/cli/cli.py:166-172``), every default filled in.
"""

from typing import Any, Dict, Tuple

from ..models.anomaly.diff import DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector
from ..models.callbacks import Callback
from ..models.estimators import TorchAutoEncoder, TorchLSTMAutoEncoder, TorchLSTMForecast, TorchRawModelRegressor
from ..models.preprocessing import (
    FunctionTransformer,
    MaxAbsScaler,
    MinMaxScaler,
    Pipeline,
    RobustScaler,
    StandardScaler,
)
from ..models.transformers.imputer import InfImputer
from ..reporters import LogReporter, MlFlowReporter, PostgresReporter

_ESTIMATORS = "gordo_tpu.models.estimators"
_SKLEARN_DATA = "sklearn.preprocessing._data"

#: port class -> (the JAX package's class path, its ``get_params(deep=False)`` at the defaults)
JAX_CLASSES: Dict[type, Tuple[str, Dict[str, Any]]] = {
    MinMaxScaler: (f"{_SKLEARN_DATA}.MinMaxScaler", {"clip": False, "copy": True, "feature_range": (0, 1)}),
    StandardScaler: (f"{_SKLEARN_DATA}.StandardScaler", {"copy": True, "with_mean": True, "with_std": True}),
    MaxAbsScaler: (f"{_SKLEARN_DATA}.MaxAbsScaler", {"clip": False, "copy": True}),
    RobustScaler: (f"{_SKLEARN_DATA}.RobustScaler", {
        "copy": True, "quantile_range": (25.0, 75.0), "unit_variance": False, "with_centering": True,
        "with_scaling": True}),
    FunctionTransformer: ("sklearn.preprocessing._function_transformer.FunctionTransformer", {
        "accept_sparse": False, "check_inverse": True, "feature_names_out": None, "func": None,
        "inv_kw_args": None, "inverse_func": None, "kw_args": None, "validate": False}),
    InfImputer: ("gordo_tpu.models.transformers.imputer.InfImputer", {
        "delta": 2.0, "inf_fill_value": None, "neg_inf_fill_value": None, "strategy": "minmax"}),
    Pipeline: ("sklearn.pipeline.Pipeline", {"memory": None, "steps": None, "transform_input": None,
                                             "verbose": False}),
    # the reporters' captured arguments (``capture_args``), as their ``to_dict`` writes them
    PostgresReporter: ("gordo_tpu.reporters.postgres.PostgresReporter", {
        "host": None, "port": 5432, "user": "postgres", "password": "postgres", "database": "postgres"}),
    MlFlowReporter: ("gordo_tpu.reporters.mlflow.MlFlowReporter", {"args": [], "model_builder_class": None}),
    LogReporter: ("gordo_tpu.reporters.base.LogReporter", {"level": "INFO"}),
}
#: the port's estimators by the JAX estimators' paths
ESTIMATOR_PATHS = {
    TorchAutoEncoder: f"{_ESTIMATORS}.JaxAutoEncoder",
    TorchLSTMAutoEncoder: f"{_ESTIMATORS}.JaxLSTMAutoEncoder",
    TorchLSTMForecast: f"{_ESTIMATORS}.JaxLSTMForecast",
    TorchRawModelRegressor: f"{_ESTIMATORS}.JaxRawModelRegressor",
}
DETECTOR_PATHS = {
    DiffBasedAnomalyDetector: "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector",
    DiffBasedKFCVAnomalyDetector: "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector",
}
#: the paths ``from_definition`` maps a FunctionTransformer's ``func`` from, to the JAX package's
_FUNCTION_PATHS = {"gordo.machine.model.transformer_funcs.general.multiply_by":
                   "gordo_tpu.models.transformer_funcs.general.multiply_by"}


def into_definition(model: Any) -> Dict[str, Any]:
    """The definition of a port object, with the JAX package's paths and
    every default its ``into_definition`` writes.

    >>> into_definition(MinMaxScaler())
    {'sklearn.preprocessing._data.MinMaxScaler': {'clip': False, 'copy': True, 'feature_range': (0, 1)}}
    """
    return _decompose(model)


def _decompose(obj: Any) -> Any:
    kind = type(obj)
    if kind in DETECTOR_PATHS:
        return {DETECTOR_PATHS[kind]: _detector_params(obj)}
    if kind in ESTIMATOR_PATHS:
        definition = dict(obj.kwargs)
        if definition.get("callbacks"):
            definition["callbacks"] = [_callback(cb) for cb in definition["callbacks"]]
        definition["kind"] = obj.kind
        return {ESTIMATOR_PATHS[kind]: definition}
    if kind in JAX_CLASSES:
        path, defaults = JAX_CLASSES[kind]
        params = dict(defaults)
        for name, value in _port_params(obj).items():
            default = params.get(name)
            if value != default:
                # the JAX reader makes a tuple of a list given for a tuple-typed parameter
                params[name] = tuple(value) if isinstance(default, tuple) else value
        return {path: params}
    if isinstance(obj, Callback):
        return _callback(obj)
    if isinstance(obj, (list, tuple)):
        return [_decompose(item) for item in obj]
    return obj


def _detector_params(detector: DiffBasedAnomalyDetector) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "base_estimator": _decompose(detector.base_estimator),
        "scaler": _decompose(detector.scaler),
    }
    if isinstance(detector, DiffBasedKFCVAnomalyDetector):
        params.update(window=detector.window, smoothing_method=detector.smoothing_method,
                      shuffle=detector.shuffle, threshold_percentile=detector.threshold_percentile)
        return params
    params["shuffle"] = detector.shuffle
    if detector.window is not None:
        params.update(window=detector.window, smoothing_method=detector.smoothing_method)
    return params


def _port_params(obj: Any) -> Dict[str, Any]:
    """A port object's parameters under the JAX class's names."""
    if isinstance(obj, Pipeline):
        return {"steps": [_decompose(step) for _, step in obj.steps]}
    params = dict(obj.get_params())
    if isinstance(obj, FunctionTransformer):
        params["func"] = _FUNCTION_PATHS.get(obj.func, obj.func)
        params["kw_args"] = obj.kw_args or None
    return params


def _callback(callback: Any) -> Any:
    """A callback as its definition: the one it was made from (the JAX
    estimator keeps its callbacks' definitions as given), else its
    parameters under the JAX package's path."""
    if not isinstance(callback, Callback):
        return callback
    definition = getattr(callback, "definition", None)
    if definition is not None:
        return definition
    return {f"gordo_tpu.models.callbacks.{type(callback).__name__}": callback.get_params()}
