"""
Model definitions to port objects: a reader for every definition
``gordo_tpu/serializer/from_definition.py`` reads in the example configs.

A definition is a single-key dict ``{dotted.path: kwargs}`` or a bare
path (defaults). The paths below are matched as strings, never
imported; the reference's ``gordo.machine.model...`` names and the
``tensorflow.keras.`` / ``keras.`` spellings map onto them as the JAX
package's ``COMPAT_LOCATIONS`` maps them (``from_definition.py:38-80``).
Anything else raises ``NotImplementedError`` naming the path.

- ``gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector``: its
  ``base_estimator`` (default: an hourglass autoencoder), ``scaler``
  (default: MinMaxScaler), ``require_thresholds``, ``shuffle``,
  ``window``, ``smoothing_method``;
- ``sklearn.pipeline.Pipeline`` (``steps``, named ``step_<i>``);
- ``sklearn.preprocessing.MinMaxScaler`` (``feature_range``, ``clip``),
  ``StandardScaler`` (``with_mean``, ``with_std``), ``MaxAbsScaler``
  (``clip``), ``RobustScaler`` (``with_centering``, ``with_scaling``,
  ``quantile_range``, ``unit_variance``), all taking ``copy``;
- ``sklearn.preprocessing.FunctionTransformer`` (``func``, a path of
  ``models.preprocessing.FUNCTIONS``, and ``kw_args``) and
  ``gordo_tpu.models.transformers.imputer.InfImputer``;
- ``gordo_tpu.models[.estimators].JaxAutoEncoder`` with a ``kind`` of
  ``models.estimators.KINDS``; its ``callbacks`` may hold
  ``EarlyStopping``, ``ReduceLROnPlateau`` and ``TerminateOnNaN`` (the
  JAX package's, Keras' or TensorFlow's path);
- ``gordo_tpu.models[.estimators].JaxLSTMAutoEncoder`` and
  ``...JaxLSTMForecast`` with a ``kind`` of ``models.estimators.LSTM_KINDS``
  (and ``lookback_window``, ``batch_size``), the same callbacks;
- ``gordo_tpu.models[.estimators].JaxRawModelRegressor``: its ``kind`` is
  ``{spec: <Sequential>, compile: {...}}``, kept as given and compiled at
  fit time; ``gordo_tpu.models.spec.Sequential`` (``layers`` built in
  turn, ``optimizer``, ``optimizer_kwargs``, ``loss``) and
  ``gordo_tpu.models.spec.Dense``;
- ``gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector``: the
  same arguments (``shuffle`` defaulting to True, ``window`` to 144,
  ``smoothing_method`` to ``smm``) and ``threshold_percentile`` (0.99);
- an expanded definition (``into_definition``, what ``build`` records):
  the scalers under their classes' own modules
  (``sklearn.preprocessing._data.MinMaxScaler``,
  ``..._function_transformer.FunctionTransformer``), and sklearn's other
  arguments (a pipeline's ``transform_input``, a FunctionTransformer's
  ``validate``, ``inverse_func`` ...) at their defaults;
- ``sklearn.model_selection.TimeSeriesSplit`` (``n_splits``) and
  ``sklearn.model_selection.KFold`` (``n_splits``, ``shuffle``,
  ``random_state``), for an evaluation's ``cv``;
- the reporters of ``runtime.reporters`` (:func:`reporter_from_definition`,
  :data:`REPORTERS`): ``gordo_tpu.reporters[.postgres].PostgresReporter``,
  ``...[.mlflow].MlFlowReporter`` and ``...[.base].LogReporter``.
"""

import copy
from typing import Any, Dict, Tuple

from .. import DeviceLike, resolve_device
from ..models.anomaly.diff import DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector
from ..models.callbacks import Callback, EarlyStopping, ReduceLROnPlateau, TerminateOnNaN
from ..models.estimators import TorchAutoEncoder, TorchLSTMAutoEncoder, TorchLSTMForecast, TorchRawModelRegressor
from ..models.model_selection import KFold, TimeSeriesSplit
from ..models.preprocessing import (
    FunctionTransformer,
    MaxAbsScaler,
    MinMaxScaler,
    Pipeline,
    RobustScaler,
    StandardScaler,
)
from ..models.spec import Dense, Sequential
from ..models.transformers.imputer import InfImputer
from ..reporters import LogReporter, MlFlowReporter, PostgresReporter

DETECTOR = "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"
KFCV_DETECTOR = "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector"
PIPELINE = "sklearn.pipeline.Pipeline"
MIN_MAX_SCALER = "sklearn.preprocessing.MinMaxScaler"
TIME_SERIES_SPLIT = "sklearn.model_selection.TimeSeriesSplit"
K_FOLD = "sklearn.model_selection.KFold"
AUTOENCODERS = ("gordo_tpu.models.JaxAutoEncoder", "gordo_tpu.models.estimators.JaxAutoEncoder")
#: every estimator path, with the port's class
ESTIMATORS = {
    **{path: TorchAutoEncoder for path in AUTOENCODERS},
    "gordo_tpu.models.JaxLSTMAutoEncoder": TorchLSTMAutoEncoder,
    "gordo_tpu.models.estimators.JaxLSTMAutoEncoder": TorchLSTMAutoEncoder,
    "gordo_tpu.models.JaxLSTMForecast": TorchLSTMForecast,
    "gordo_tpu.models.estimators.JaxLSTMForecast": TorchLSTMForecast,
    "gordo_tpu.models.JaxRawModelRegressor": TorchRawModelRegressor,
    "gordo_tpu.models.estimators.JaxRawModelRegressor": TorchRawModelRegressor,
}
#: the scalers and stateless transformers, with the keyword arguments each takes
TRANSFORMERS = {
    MIN_MAX_SCALER: (MinMaxScaler, ("feature_range", "clip", "copy")),
    "sklearn.preprocessing.StandardScaler": (StandardScaler, ("with_mean", "with_std", "copy")),
    "sklearn.preprocessing.MaxAbsScaler": (MaxAbsScaler, ("clip", "copy")),
    "sklearn.preprocessing.RobustScaler": (
        RobustScaler, ("with_centering", "with_scaling", "quantile_range", "unit_variance", "copy")),
    "sklearn.preprocessing.FunctionTransformer": (FunctionTransformer, ("func", "kw_args")),
    "gordo_tpu.models.transformers.imputer.InfImputer": (
        InfImputer, ("inf_fill_value", "neg_inf_fill_value", "strategy", "delta")),
    "gordo_tpu.models.transformers.InfImputer": (
        InfImputer, ("inf_fill_value", "neg_inf_fill_value", "strategy", "delta")),
}
SEQUENTIAL = ("gordo_tpu.models.spec.Sequential", "gordo_tpu.models.Sequential")
DENSE = ("gordo_tpu.models.spec.Dense", "gordo_tpu.models.Dense")
#: every callback path, with the port's class
CALLBACKS = {
    f"gordo_tpu.models.callbacks.{cls.__name__}": cls for cls in (EarlyStopping, ReduceLROnPlateau, TerminateOnNaN)
}

#: every reporter path, with the port's class
REPORTERS = {
    f"gordo_tpu.reporters{module}.{cls.__name__}": cls
    for cls, modules in ((PostgresReporter, ("", ".postgres")), (MlFlowReporter, ("", ".mlflow")),
                         (LogReporter, ("", ".base")))
    for module in modules
}

#: the reference's and Keras' paths of the ported classes
COMPAT_LOCATIONS: Dict[str, str] = {
    "gordo.machine.model.models.KerasAutoEncoder": "gordo_tpu.models.JaxAutoEncoder",
    "gordo.machine.model.models.KerasLSTMAutoEncoder": "gordo_tpu.models.JaxLSTMAutoEncoder",
    "gordo.machine.model.models.KerasLSTMForecast": "gordo_tpu.models.JaxLSTMForecast",
    "gordo.machine.model.models.KerasRawModelRegressor": "gordo_tpu.models.JaxRawModelRegressor",
    "gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector": DETECTOR,
    "gordo.machine.model.anomaly.diff.DiffBasedKFCVAnomalyDetector": KFCV_DETECTOR,
    "gordo.machine.model.transformers.imputer.InfImputer": "gordo_tpu.models.transformers.imputer.InfImputer",
    "gordo.machine.model.transformer_funcs.general.multiply_by": (
        "gordo_tpu.models.transformer_funcs.general.multiply_by"),
    **{f"{keras}.callbacks.{cls.__name__}": f"gordo_tpu.models.callbacks.{cls.__name__}"
       for keras in ("tensorflow.keras", "keras") for cls in (EarlyStopping, ReduceLROnPlateau, TerminateOnNaN)},
    **{f"{keras}.models.Sequential": SEQUENTIAL[0] for keras in ("tensorflow.keras", "keras")},
    **{f"{keras}.layers.Dense": DENSE[0] for keras in ("tensorflow.keras", "keras")},
    # the classes' own modules, as an expanded definition (``into_definition``) names them
    **{f"sklearn.preprocessing._data.{name}": f"sklearn.preprocessing.{name}"
       for name in ("MinMaxScaler", "StandardScaler", "MaxAbsScaler", "RobustScaler")},
    "sklearn.preprocessing._function_transformer.FunctionTransformer": "sklearn.preprocessing.FunctionTransformer",
}

#: arguments an expanded definition gives at sklearn's defaults, which the port reads only at them
SKLEARN_DEFAULTS = {
    PIPELINE: {"transform_input": None},
    "sklearn.preprocessing.FunctionTransformer": {
        "accept_sparse": False, "check_inverse": True, "feature_names_out": None, "inv_kw_args": None,
        "inverse_func": None, "validate": False},
}


def _path_and_kwargs(definition: Any) -> Tuple[str, Dict[str, Any]]:
    if isinstance(definition, str):
        path, kwargs = definition, {}
    elif isinstance(definition, dict) and len(definition) == 1:
        path, kwargs = next(iter(definition.items()))
        kwargs = dict(kwargs or {})
    else:
        raise ValueError(f"A definition is a path or a single-key dict, got {definition!r}")
    return COMPAT_LOCATIONS.get(path, path), kwargs


def _no_more(path: str, kwargs: Dict[str, Any]) -> None:
    for key, default in SKLEARN_DEFAULTS.get(path, {}).items():
        if key in kwargs and kwargs[key] == default:
            del kwargs[key]
    if kwargs:
        raise NotImplementedError(f"{path}: arguments {sorted(kwargs)} are not ported")


def from_definition(definition: Any, device: DeviceLike = None) -> Any:
    """
    The port object a definition describes; autoencoders are placed on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    >>> model = from_definition({DETECTOR: {"base_estimator": {PIPELINE: {"steps": [
    ...     MIN_MAX_SCALER, {AUTOENCODERS[0]: {"kind": "feedforward_hourglass", "epochs": 5}}]}}}},
    ...     device="cpu")
    >>> model.base_estimator.estimator.kind, model.base_estimator.estimator.kwargs
    ('feedforward_hourglass', {'epochs': 5})
    """
    return _build(copy.deepcopy(definition), resolve_device(device))


def _build(definition: Any, device) -> Any:
    path, kwargs = _path_and_kwargs(definition)
    if path in (DETECTOR, KFCV_DETECTOR):
        base = kwargs.pop("base_estimator", None)
        scaler = kwargs.pop("scaler", None)
        names = ("require_thresholds", "shuffle", "window", "smoothing_method")
        if path == KFCV_DETECTOR:
            names += ("threshold_percentile",)
        options = {key: kwargs.pop(key) for key in names if key in kwargs}
        _no_more(path, kwargs)
        detector = DiffBasedKFCVAnomalyDetector if path == KFCV_DETECTOR else DiffBasedAnomalyDetector
        return detector(
            base_estimator=(
                _build(base, device) if base is not None
                else TorchAutoEncoder(device=device, kind="feedforward_hourglass")
            ),
            scaler=None if scaler is None else _build(scaler, device),
            **options,
        )
    if path == PIPELINE:
        steps = kwargs.pop("steps")
        kwargs.pop("memory", None)
        kwargs.pop("verbose", None)
        _no_more(path, kwargs)
        return Pipeline([(f"step_{i}", _build(step, device)) for i, step in enumerate(steps)])
    if path in TRANSFORMERS:
        cls, names = TRANSFORMERS[path]
        options = {key: kwargs.pop(key) for key in names if key in kwargs}
        _no_more(path, kwargs)
        options.pop("copy", None)  # the port's transforms always copy
        if "func" in options and options["func"] is not None:
            options["func"] = COMPAT_LOCATIONS.get(options["func"], options["func"])
        return cls(**options)
    if path in SEQUENTIAL:
        layers = [_build(layer, device) for layer in kwargs.pop("layers", ())]
        options = {key: kwargs.pop(key) for key in ("optimizer", "optimizer_kwargs", "loss") if key in kwargs}
        _no_more(path, kwargs)
        return Sequential(layers, **options)
    if path in DENSE:
        if "input_shape" in kwargs and kwargs["input_shape"] is not None:
            kwargs["input_shape"] = tuple(kwargs["input_shape"])
        return Dense(**kwargs)
    if path in ESTIMATORS:
        if "kind" not in kwargs:
            raise ValueError(f"{path} needs a kind")
        if kwargs.get("callbacks"):
            kwargs["callbacks"] = [_callback(cb) for cb in kwargs["callbacks"]]
        return ESTIMATORS[path](device=device, **kwargs)
    if path == TIME_SERIES_SPLIT:
        n_splits = kwargs.pop("n_splits", 5)
        _no_more(path, kwargs)
        return TimeSeriesSplit(n_splits)
    if path == K_FOLD:
        options = {key: kwargs.pop(key) for key in ("n_splits", "shuffle", "random_state") if key in kwargs}
        _no_more(path, kwargs)
        return KFold(**options)
    raise NotImplementedError(f"{path} is not supported by gordo_tpu_torch")


def _callback(definition: Any) -> Any:
    if isinstance(definition, Callback):
        return definition
    path, kwargs = _path_and_kwargs(definition)
    if path not in CALLBACKS:
        raise NotImplementedError(f"callback {path} is not supported by gordo_tpu_torch")
    callback = CALLBACKS[path](**kwargs)
    callback.definition = definition  # what ``into_definition`` gives back, as the JAX estimator keeps it
    return callback


def reporter_from_definition(definition: Any) -> Any:
    """The reporter a ``runtime.reporters`` entry names (a path, or a
    single-key dict of the path and its arguments)."""
    path, kwargs = _path_and_kwargs(definition)
    if path not in REPORTERS:
        raise NotImplementedError(f"reporter {path} is not supported by gordo_tpu_torch")
    return REPORTERS[path](**kwargs)
