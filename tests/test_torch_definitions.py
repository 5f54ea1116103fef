"""Every model definition the JAX package reads, on the port, against the
JAX package, on the CPU.

- ``from_definition``: every block of ``examples/model-configuration.yaml``,
  the model block of ``examples/config-influx-callbacks.yaml`` and
  detectors holding the stock scalers, the imputer and
  ``FunctionTransformer(multiply_by)`` (the reference's and Keras' paths
  too) make the same object graph in both packages.
- ``TorchRawModelRegressor``: its compiled spec is JAX's ``compile_spec``
  (``to_dict`` equal), its errors JAX's, and a fit (JAX's randomness
  injected) JAX's, with the same pickled state, ``get_params`` and
  ``get_metadata`` keys.
- A project config of CSV data built by both packages' ``build-fleet``:
  the raw spec as written (20 tags), a ``StandardScaler`` and a
  ``MaxAbsScaler`` detector sharing an affine bucket (``RobustScaler`` /
  ``MaxAbsScaler`` error scalers, ``StandardScaler`` / ``RobustScaler``
  scoring scalers), two non-affine detectors (``InfImputer`` →
  ``FunctionTransformer(multiply_by, factor 2)`` → ``MinMaxScaler(clip)``,
  ``inf`` cells in an input-only tag, the other four their targets; a
  ``StandardScaler`` error scaler, a
  clipping ``MinMaxScaler`` scoring scaler) and the callbacks block (10 of
  its 30 epochs). Thresholds rtol 1e-5, CV scores rtol/atol 1e-5, params
  atol 1e-5 (``tests/test_torch_fleet_build.py``'s limits). The JAX
  ``build-fleet`` fails the callbacks machine (``FleetBuildError`` at its
  stage); the port's sends it to ``ModelBuilder``, held to JAX's
  ``ModelBuilder`` of the same machine.
- The JAX-built detectors carried into the port through ``from_state``:
  both apps' ``/anomaly/prediction``, ``/prediction`` and fleet answers,
  with and without the port's engine, and a stream flush; the forward's
  columns at rtol 1e-5 / atol 1e-6, the derived ones at the forward's
  error carried through the error scaler (``tests/test_torch_engine.py``'s
  bound). The non-affine bucket runs without the ingest prologue on
  host-transformed rows; K2's ``y`` is the raw rows.

Also the repairs that admitting these definitions needed: the fold
error scaler is a fresh copy of the detector's own (it was a
``MinMaxScaler`` whatever the detector held).
"""

import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import yaml
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.models.estimators import JaxRawModelRegressor
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
from gordo_tpu.parallel.fleet_build import FleetBuildError
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimators import TorchRawModelRegressor
from gordo_tpu_torch.models.preprocessing import MinMaxScaler
from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
from gordo_tpu_torch.parallel import fleet_build as port_fleet_build
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.server import build_app

from tests.test_torch_serving import _frame, _post, _same_events, _sse

PROJECT = "definitions"
REVISION = "1700000000000"
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
ROWS = 300
CALLBACK_EPOCHS = 10

with open("examples/model-configuration.yaml") as _f:
    EXAMPLES = yaml.safe_load(_f)
with open("examples/config-influx-callbacks.yaml") as _f:
    CALLBACKS_BLOCK = yaml.safe_load(_f)["globals"]["model"]

DETECTOR = "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"
HOURGLASS = {"gordo_tpu.models.estimators.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 2}}


def detector(steps, scaler, estimator=HOURGLASS):
    return {DETECTOR: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [*steps, estimator]}},
                       "scaler": scaler}}


NON_AFFINE_STEPS = [
    "gordo_tpu.models.transformers.imputer.InfImputer",
    {"sklearn.preprocessing.FunctionTransformer": {
        "func": "gordo_tpu.models.transformer_funcs.general.multiply_by", "kw_args": {"factor": 2}}},
    {"sklearn.preprocessing.MinMaxScaler": {"clip": True}},
]
DEFINITIONS = {
    **{f"example-{name}": block for name, block in EXAMPLES.items()},
    "influx-callbacks": CALLBACKS_BLOCK,
    "standard-robust": detector(["sklearn.preprocessing.StandardScaler"], "sklearn.preprocessing.RobustScaler"),
    "maxabs-standard": detector([{"sklearn.preprocessing.MaxAbsScaler": {}}],
                                {"sklearn.preprocessing.StandardScaler": {"with_mean": False}}),
    "non-affine": detector(NON_AFFINE_STEPS, {"sklearn.preprocessing.RobustScaler": {
        "quantile_range": [10.0, 90.0], "unit_variance": True}}),
    "reference-paths": {"gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            {"gordo.machine.model.transformers.imputer.InfImputer": {"strategy": "extremes"}},
            {"sklearn.preprocessing.FunctionTransformer": {
                "func": "gordo.machine.model.transformer_funcs.general.multiply_by", "kw_args": {"factor": 3}}},
            {"gordo.machine.model.models.KerasRawModelRegressor": {"kind": {
                "spec": {"keras.models.Sequential": {"layers": [
                    {"keras.layers.Dense": {"units": 3, "activation": "relu", "input_dim": 4}},
                    {"keras.layers.Dense": {"units": 4}}]}},
                "compile": {"loss": "mae", "optimizer": "sgd"}},
                "epochs": 3, "callbacks": [
                    {"keras.callbacks.EarlyStopping": {"patience": 2}},
                    {"tensorflow.keras.callbacks.ReduceLROnPlateau": {"factor": 0.2}},
                    {"keras.callbacks.TerminateOnNaN": {}}]}},
        ]}}}},
}

#: port class names that stand for the JAX package's
NAMES = {"TorchAutoEncoder": "JaxAutoEncoder", "TorchLSTMAutoEncoder": "JaxLSTMAutoEncoder",
         "TorchLSTMForecast": "JaxLSTMForecast", "TorchRawModelRegressor": "JaxRawModelRegressor"}


def describe(obj):
    """An object graph as plain data both packages' objects map onto."""
    from gordo_tpu.serializer.from_definition import build_callbacks

    name = NAMES.get(type(obj).__name__, type(obj).__name__)
    if hasattr(obj, "base_estimator"):
        return [name, describe(obj.base_estimator), describe(obj.scaler),
                [obj.require_thresholds, obj.window, obj.smoothing_method, obj.shuffle]]
    if hasattr(obj, "steps"):
        return [name, [describe(step) for _, step in obj.steps]]
    if hasattr(obj, "kwargs"):
        kwargs = dict(obj.kwargs)
        callbacks = [cb for cb in kwargs.pop("callbacks", None) or []]
        if any(isinstance(cb, dict) for cb in callbacks):
            callbacks = build_callbacks(callbacks)
        return [name, obj.kind, {k: list(v) if isinstance(v, tuple) else v for k, v in kwargs.items()},
                [[type(cb).__name__, cb.get_params()] for cb in callbacks]]
    if name == "FunctionTransformer":
        func = obj.func if isinstance(obj.func, str) or obj.func is None else f"{obj.func.__module__}.{obj.func.__name__}"
        return [name, func.replace("gordo.machine.model.", "gordo_tpu.models."), obj.kw_args]
    params = {k: list(v) if isinstance(v, tuple) else v for k, v in obj.get_params().items() if k != "copy"}
    return [name, {k: float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else v
                   for k, v in params.items()}]


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_from_definition_matches_jax(name):
    definition = DEFINITIONS[name]
    jax_obj = jax_serializer.from_definition(definition)
    port_obj = serializer.from_definition(definition, device="cpu")
    assert describe(port_obj) == describe(jax_obj)


def test_raw_regressor_compiles_as_jax():
    """The compiled spec of the example and of a reference-path spec is
    JAX's ``compile_spec``; the same ``ValueError``s."""
    for definition, width in ((EXAMPLES["raw_spec"], 20), (DEFINITIONS["reference-paths"], 4)):
        port = serializer.from_definition(definition, device="cpu")
        jax_obj = jax_serializer.from_definition(definition)
        port = getattr(port, "base_estimator", port)
        jax_obj = getattr(jax_obj, "base_estimator", jax_obj)
        port, jax_obj = getattr(port, "estimator", port), getattr(jax_obj, "steps", [[None, jax_obj]])[-1][1]
        want = jax_obj._build_spec({"n_features": width, "n_features_out": width})
        assert port.build_spec(width, width).to_dict() == want.to_dict()
    for kind, match in (({"spec": EXAMPLES["raw_spec"]["gordo_tpu.models.estimators.JaxRawModelRegressor"]["kind"][
            "spec"]}, "Expected spec to have keys"),
                        ({"spec": {"keras.models.Sequential": {"layers": []}}, "compile": {}}, "at least one Dense"),
                        ({"spec": "sklearn.preprocessing.StandardScaler", "compile": {}}, "Sequential")):
        with pytest.raises(ValueError, match=match):
            JaxRawModelRegressor(kind=kind)._build_spec({"n_features": 3})
        with pytest.raises(ValueError, match=match):
            TorchRawModelRegressor(kind=kind, device="cpu").build_spec(3, 3)


class JaxRandom:
    """The JAX trainers' randomness for the port's: init from
    ``split(PRNGKey(seed))[1]``; the fused fit's permutations from
    ``split(fit, epochs)``, the host loop's from its own key chain."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))

    def host_loop_permutations(self, seed, epochs, n_total):
        return np.array(_jax_host_loop_permutations(seed, epochs, n_total))


@jax.jit
def _split(seed):
    return jax.random.split(jax.random.PRNGKey(seed))


def _jax_init(seed, spec):
    return jax_init(_split(seed)[1], spec)


def _jax_permutations(seed, epochs, n_total):
    keys = jax.random.split(_split(seed)[0], epochs)
    return np.stack([jax.random.permutation(key, n_total) for key in keys])


def _jax_host_loop_permutations(seed, epochs, n_total):
    rng, perms = _split(seed)[0], []
    for _ in range(epochs):
        rng, erng = jax.random.split(rng)
        perms.append(jax.random.permutation(jax.random.split(erng, 1)[0], n_total))
    return np.stack(perms)


def test_raw_regressor_fits_as_jax():
    kind = EXAMPLES["raw_spec"]["gordo_tpu.models.estimators.JaxRawModelRegressor"]["kind"]
    X = np.random.RandomState(4).rand(80, 20).astype(np.float32)
    port = TorchRawModelRegressor(kind=kind, device="cpu", epochs=2, batch_size=16).fit(X, X, random=JaxRandom())
    jax_est = JaxRawModelRegressor(kind=kind, epochs=2, batch_size=16).fit(X, X)
    assert port.spec_.to_dict() == jax_est.spec_.to_dict()
    for key, layer in jax_est.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(port.params_[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL)
    np.testing.assert_allclose(port.history.history["loss"], jax_est._history.history["loss"], rtol=RTOL)
    assert set(port.__getstate__()) - {"device"} == set(jax_est.__getstate__())
    assert set(port.get_params()) - {"device"} == set(jax_est.get_params())
    assert list(port.get_metadata()) == list(jax_est.get_metadata()) == ["history"]
    assert list(port.get_metadata()["history"]) == list(jax_est.get_metadata()["history"])
    again = pickle.loads(pickle.dumps(port)).to("cpu")
    np.testing.assert_array_equal(again.predict(X), port.predict(X))
    assert repr(port).startswith("TorchRawModelRegressor(kind: {")


# -- a project config through both packages' build-fleet ----------------------------

START = "2020-01-01T00:00:00+00:00"
END = "2020-01-03T02:00:00+00:00"  # ROWS 10-minute rows
MACHINES = {
    # name: (tags, model, evaluation)
    "raw-spec": (20, EXAMPLES["raw_spec"], {}),
    "standard": (4, DEFINITIONS["standard-robust"], {"scoring_scaler": "sklearn.preprocessing.StandardScaler"}),
    "maxabs": (4, detector([{"sklearn.preprocessing.MaxAbsScaler": {}}], "sklearn.preprocessing.MaxAbsScaler"),
               {"scoring_scaler": {"sklearn.preprocessing.RobustScaler": {"quantile_range": [20.0, 80.0]}}}),
    "non-affine-a": (5, detector(NON_AFFINE_STEPS, "sklearn.preprocessing.StandardScaler"),
                     {"scoring_scaler": {"sklearn.preprocessing.MinMaxScaler": {"clip": True}}}),
    "non-affine-b": (5, detector(NON_AFFINE_STEPS, "sklearn.preprocessing.StandardScaler"), {}),
    "callbacks": (3, json.loads(json.dumps(CALLBACKS_BLOCK).replace('"epochs": 30', f'"epochs": {CALLBACK_EPOCHS}')),
                  {}),
}
SEQUENTIAL = "callbacks"


def write_config(directory):
    """The project config (JSON, which both YAML readers read) and one
    wide CSV a machine: sinusoid readings (the raw spec's at unit scale:
    it has no scaler, and readings of tens saturate its tanh units, whose
    ~0 gradients Adam turns into steps of +-lr signed by f32 rounding, in
    any two implementations), ``inf`` / ``-inf`` cells in the
    non-affine machines' last tag, which is not among their targets (an
    infinite target would make every loss infinite, in both packages)."""
    machines = []
    for i, (name, (n_tags, model, evaluation)) in enumerate(MACHINES.items()):
        rng = np.random.RandomState(i)
        t = np.arange(ROWS)[:, None]
        values = rng.uniform(20, 80, n_tags) + 5 * np.sin(2 * np.pi * t / 144 + rng.uniform(0, 6, n_tags))
        values = values + rng.standard_normal((ROWS, n_tags))
        if name == "raw-spec":
            values = (values - 50.0) / 30.0  # no scaler ahead of its tanh units: readings at unit scale
        tags = [f"{name}-t{j}" for j in range(n_tags)]
        path = os.path.join(directory, f"{name}.csv")
        with open(path, "w") as f:
            f.write(",".join(["time", *tags]) + "\n")
            for r in range(ROWS):
                row = [f"{v:.17g}" for v in values[r]]
                if name.startswith("non-affine") and r % 37 == 5:
                    row[-1] = "inf" if r % 2 else "-inf"  # an input-only sensor
                stamp = np.datetime64("2020-01-01T00:00") + np.timedelta64(10 * r, "m")
                f.write(f"{stamp}:00+00:00," + ",".join(row) + "\n")
        dataset = {"data_provider": {"type": "FileDataProvider", "path": path, "timestamp_column": "time"},
                   "tag_list": tags, "train_start_date": START, "train_end_date": END}
        if name.startswith("non-affine"):
            dataset["target_tag_list"] = tags[:-1]
        machines.append({"name": name, "model": model, "evaluation": evaluation, "dataset": dataset})
    return json.dumps({"machines": machines})


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    from gordo_tpu.cli.cli import _load_fleet_machines as jax_load_fleet_machines
    from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
    from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
    from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict
    from gordo_tpu_torch.cli.cli import load_fleet_machines
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = tmp_path_factory.mktemp("definitions")
    text = write_config(str(root))
    jax_dir, port_dir, state_dir = root / "jax" / REVISION, root / "port" / REVISION, root / "state" / REVISION
    jax_machines = jax_load_fleet_machines(
        jax_machines_yaml(JaxNormalizedConfig(jax_get_dict(io.StringIO(text)), PROJECT).machines))
    jax_builder = JaxFleetBuilder(jax_machines)
    jax_results = {m.name: (model, m) for model, m in jax_builder.build(output_dir=str(jax_dir))}
    # JAX's build-fleet fails a machine with host callbacks; its ModelBuilder builds it
    assert sorted(jax_builder.build_errors) == [SEQUENTIAL]
    assert isinstance(jax_builder.build_errors[SEQUENTIAL], FleetBuildError)
    machine = next(m for m in jax_machines if m.name == SEQUENTIAL)
    model, built = JaxModelBuilder(machine).build()
    jax_serializer.dump(model, str(jax_dir / SEQUENTIAL), metadata=built.to_dict())
    jax_results[SEQUENTIAL] = (model, built)

    machines = load_fleet_machines(normalize(io.StringIO(text), PROJECT))
    builder = port_fleet_build.FleetBuilder(machines, device="cpu", random=JaxRandom())
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    port_results = {m.name: (model, m) for model, m in builder.build(output_dir=str(port_dir))}
    assert builder.build_errors == {} and sorted(port_results) == sorted(MACHINES)

    # the JAX-built detectors carried into the port
    for name, (model, _) in jax_results.items():
        with open(jax_dir / name / "metadata.json") as f:
            metadata = json.load(f)
        serializer.dump(port_model(model), str(state_dir / name), metadata=metadata)
    return jax_results, port_results, builder, jax_dir, port_dir, state_dir


def step_state(step):
    """A fitted sklearn (or JAX package) step as ``transformer_from_state``'s state."""
    kind = type(step).__name__
    if kind == "FunctionTransformer":
        func = step.func
        return {"type": kind, "func": None if func is None else f"{func.__module__}.{func.__name__}",
                "kw_args": step.kw_args}
    fitted = {"MinMaxScaler": ("scale_", "min_"), "StandardScaler": ("mean_", "var_", "scale_", "n_samples_seen_"),
              "MaxAbsScaler": ("max_abs_", "scale_"), "RobustScaler": ("center_", "scale_"),
              "InfImputer": ("_fill_values", "_neg_fill_values")}[kind]
    params = {k: v for k, v in step.get_params().items() if k != "copy"}
    return {"type": kind, **params, **{k: getattr(step, k) for k in fitted}}


def port_model(model):
    """A JAX-built detector or bare raw regressor in the port, through
    ``from_state`` (a bare estimator as a port estimator of its spec)."""
    from gordo_tpu_torch.models.estimators import TorchAutoEncoder
    from gordo_tpu_torch.models.spec import FeedForwardSpec

    if not hasattr(model, "base_estimator"):
        params = {k: {n: np.asarray(v) for n, v in layer.items()} for k, layer in model.params_.items()}
        return TorchAutoEncoder(FeedForwardSpec.from_dict(model.spec_.to_dict()), params, device="cpu")
    pipeline = model.base_estimator
    estimator = pipeline.steps[-1][1]
    return DiffBasedAnomalyDetector.from_state({
        "spec": estimator.spec_.to_dict(),
        "params": {k: {n: np.asarray(v) for n, v in layer.items()} for k, layer in estimator.params_.items()},
        "pipeline": [step_state(step) for _, step in pipeline.steps[:-1]],
        "scaler": step_state(model.scaler),
        "feature_thresholds": np.asarray(model.feature_thresholds_.values),
        "aggregate_threshold": model.aggregate_threshold_,
    }, device="cpu")


def _params(model):
    estimator = getattr(model, "base_estimator", model)
    estimator = getattr(estimator, "estimator", None) or getattr(estimator, "steps", [[None, estimator]])[-1][1]
    return {k: {n: np.asarray(v.numpy() if hasattr(v, "numpy") else v) for n, v in layer.items()}
            for k, layer in estimator.params_.items()}


@pytest.mark.parametrize("name", list(MACHINES))
def test_build_fleet_matches_jax(builds, name):
    """Thresholds, CV scores and final params of each machine against JAX's
    (its callbacks machine against JAX's ``ModelBuilder``), and the
    epochs it ran."""
    jax_results, port_results, _, jax_dir, port_dir, _ = builds
    (jax_model, _), (model, _) = jax_results[name], port_results[name]
    if hasattr(jax_model, "feature_thresholds_"):
        np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float),
                                   rtol=RTOL)
        np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
    want, got = _params(jax_model), _params(model)
    for key, layer in want.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(got[key][leaf], value, atol=PARAM_ATOL, err_msg=f"{name} {key}/{leaf}")
    with open(jax_dir / name / "metadata.json") as f:
        jax_meta = json.load(f)["metadata"]["build_metadata"]["model"]
    meta = serializer.load_metadata(str(port_dir / name))["metadata"]["build_metadata"]["model"]
    assert sorted(meta["cross_validation"]["scores"]) == sorted(jax_meta["cross_validation"]["scores"])
    for key, folds in jax_meta["cross_validation"]["scores"].items():
        np.testing.assert_allclose(list(meta["cross_validation"]["scores"][key].values()), list(folds.values()),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert meta["training"]["epochs_run"] == jax_meta["training"]["epochs_run"]
    assert meta["model_offset"] == jax_meta["model_offset"] == 0
    if name == SEQUENTIAL:
        history = meta["model_meta"]["history"]
        assert history["loss"] and len(history["loss"]) <= CALLBACK_EPOCHS
        np.testing.assert_allclose(history["loss"], jax_meta["model_meta"]["history"]["loss"], rtol=RTOL)


def test_build_fleet_routes_host_callbacks_to_the_sequential_builder(builds):
    """The callbacks machine is not planned into the fleet (the JAX fleet
    fails it at its stage): it builds alone, its CV folds one a K1
    forward; the raw-spec machine's compiled spec is planned."""
    _, port_results, builder, *_ = builds
    assert builder.phase_seconds["sequential"] > 0
    assert SEQUENTIAL not in {m.name for m in builder.machines if port_fleet_build.FleetBuilder._plan_machine(
        builder, m) is not None}
    raw = port_results["raw-spec"][0]
    assert raw.spec_.dims == (16, 4) and raw.spec_.activations == ("tanh", "tanh")


def test_fold_error_scaler_is_the_detectors_own():
    """The fleet fits each fold's error scaler as a fresh copy of the
    detector's own (``sklearn_clone(detector.scaler)``), so a
    ``RobustScaler`` detector's fold thresholds are the JAX builder's
    (it fitted a ``MinMaxScaler`` whatever the detector held, which
    gives other thresholds)."""
    from types import SimpleNamespace

    from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxBuilder
    from gordo_tpu_torch.models.anomaly.diff import fold_errors

    definition = DEFINITIONS["standard-robust"]
    port_detector = serializer.from_definition(definition, device="cpu")
    jax_detector = jax_serializer.from_definition(definition)
    rng = np.random.RandomState(0)
    y_train, y_true = (rng.rand(100, 4) * 30).astype(np.float32), (rng.rand(40, 4) * 30).astype(np.float32)
    y_pred = y_true + rng.standard_normal((40, 4)).astype(np.float32)
    port_state, jax_state = {}, {}
    port_fleet_build.FleetBuilder._accumulate_thresholds(
        SimpleNamespace(detector=port_detector), y_true, y_pred, 0, port_state, y_train=y_train, test_rows=None)
    JaxBuilder._accumulate_thresholds(
        SimpleNamespace(detector=jax_detector), y_true, y_pred, 0, jax_state, y_train=y_train, test_rows=None)
    got = port_state["folds"][0]
    want_aggregate, want_feature = jax_state["aggregate_threshold"], jax_state["feature_folds"]["fold-0"]
    np.testing.assert_allclose(got["aggregate"], want_aggregate, rtol=RTOL)
    np.testing.assert_allclose(got["feature"], want_feature.to_numpy(float), rtol=RTOL)
    assert not hasattr(port_detector.scaler, "center_")  # the detector's own stays unfitted
    minmax = port_detector.fold_thresholds(*fold_errors(MinMaxScaler().fit(y_train), y_true, y_pred))
    assert not np.isclose(minmax["aggregate"], want_aggregate, rtol=1e-3)


# -- serving: the port's own build, and the JAX build carried over -----------------


def _request(name, n_tags, seed, rows=40, targets=False):
    """A frame of ``name``'s tags (its target tags with ``targets``)."""
    if targets and name.startswith("non-affine"):
        n_tags -= 1
    tags = [f"{name}-t{j}" for j in range(n_tags)]
    frame = _frame(tags, rows, seed=seed)
    if name != "raw-spec":  # readings at the training data's level
        for column in frame.values():
            for key, value in column.items():
                column[key] = None if value is None else 40 + 20 * value
    return frame


def _multiplier(model):
    """The largest factor the error scaler multiplies a difference by."""
    scaler = getattr(model, "scaler", None)
    if scaler is None:
        return 1.0
    affine = scaler.affine() if hasattr(scaler, "affine") else None
    return float(np.max(np.abs(affine[0]))) if affine is not None else float(np.max(scaler.scale_))


def _same_answers(expected, got, multiplier):
    assert list(got) == list(expected)
    largest = max((abs(v) for column in expected.get("model-output", {}).values() for v in column.values()
                   if v is not None), default=1.0)
    derived = (FORWARD_ATOL + FORWARD_RTOL * largest) * max(1.0, multiplier)
    for column in expected:
        forward = column in ("start", "end", "model-input", "model-output")
        _close(expected[column], got[column], FORWARD_ATOL if forward else derived, column)


def _close(expected, got, atol, path):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and list(got) == list(expected), path
        for key in expected:
            _close(expected[key], got[key], atol, f"{path}/{key}")
    elif isinstance(expected, float) and isinstance(got, float):
        np.testing.assert_allclose(got, expected, rtol=FORWARD_RTOL, atol=atol, err_msg=path)
    else:
        assert got == expected, path


@pytest.fixture(scope="module")
def jax_app(builds):
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = str(builds[3])
    try:
        yield Client(jax_build_app(config={"EXPECTED_MODELS": []}))
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous


def _events(client, stream, max_events):
    response = client.get(f"/gordo/v0/{PROJECT}/stream/{stream}/events?max_events={max_events}&idle_timeout_s=0.1")
    assert response.status_code == 200
    return _sse(response.get_data())


def _post_json(client, url, body):
    response = client.post(url, data=json.dumps(body), content_type="application/json")
    return response.status_code, json.loads(response.get_data())


@pytest.mark.parametrize("engine", [False, True], ids=["unbatched", "engine"])
def test_carried_detectors_serve_as_jax(builds, jax_app, engine, monkeypatch):
    """Each detector carried over through ``from_state`` answers
    ``/anomaly/prediction`` as the JAX app does, the raw spec
    ``/prediction``, and the fleet route all of them; the non-affine
    bucket without the prologue, its requests through one launch each."""
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    state_dir = str(builds[5])
    config = ServeConfig(max_size=1, max_delay_ms=20000.0, deadline_ms=40000.0) if engine else None
    app = build_app(state_dir, device="cpu", serve_config=config)
    port = Client(app)
    try:
        fleet = app.store.fleet()
        for i, name in enumerate(n for n in MACHINES if n != "raw-spec"):
            n_tags = MACHINES[name][0]
            body = {"X": _request(name, n_tags, seed=i), "y": _request(name, n_tags, seed=i + 50, targets=True)}
            url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
            expected, got = _post_json(jax_app, url, body), _post_json(port, url, body)
            assert got[0] == expected[0] == 200, (name, got)
            _same_answers(expected[1]["data"], got[1]["data"], _multiplier(fleet.model(name)))
        for name in ("raw-spec", "non-affine-b", "maxabs"):
            url = f"/gordo/v0/{PROJECT}/{name}/prediction"
            body = {"X": _request(name, MACHINES[name][0], seed=9)}
            expected, got = _post_json(jax_app, url, body), _post_json(port, url, body)
            assert got[0] == expected[0] == 200, (name, got)
            _same_answers(expected[1]["data"], got[1]["data"], 1.0)
        spec_a = fleet.loaded_specs()["non-affine-a"]
        assert fleet.host_transformed(spec_a) and fleet.ingest_plan(spec_a) is None
        spec_s = fleet.loaded_specs()["standard"]
        assert not fleet.host_transformed(spec_s) and fleet.ingest_plan(spec_s) is not None
        assert fleet.loaded_specs()["maxabs"] == spec_s
        if engine:
            stats = app.engine.stats()
            assert stats["batches"] == stats["launches"] == 8 and stats["ingest_batches"] == 4
        body = {"X": {name: _request(name, MACHINES[name][0], seed=20 + i) for i, name in enumerate(MACHINES)}}
        url = f"/gordo/v0/{PROJECT}/prediction/fleet"
        launches = fleet_anomaly_scores.launches
        expected, got = _post_json(jax_app, url, body), _post_json(port, url, body)
        assert got[0] == expected[0] == 200 and sorted(got[1]["data"]) == sorted(MACHINES)
        for name in MACHINES:
            _close(expected[1]["data"][name], got[1]["data"][name], 1e-4, name)
        assert fleet_anomaly_scores.launches == launches  # the CPU runs K2's plain version
    finally:
        app.shutdown()


def test_host_transformed_fleet_scores_take_raw_rows_as_y(builds):
    """``fleet_scores`` on the non-affine bucket: the reconstruction of the
    host-transformed rows, each row's error against the raw rows."""
    from gordo_tpu_torch.server.fleet_store import RevisionFleet, host_transform

    fleet = RevisionFleet(str(builds[5]), device=__import__("torch").device("cpu"))
    rng = np.random.RandomState(3)
    inputs = {name: 40 + 20 * rng.rand(30, 5) for name in ("non-affine-a", "non-affine-b")}
    inputs["non-affine-b"][4, 4] = np.inf
    out, errors = fleet.fleet_scores(inputs)
    assert errors == {}
    for name, raw in inputs.items():
        recon, mse = out[name]
        model = fleet.model(name)
        want = model.base_estimator.estimator.predict(host_transform(model, raw))
        np.testing.assert_allclose(recon, want, rtol=1e-5, atol=1e-6)
        assert recon.shape == (30, 4) and np.isfinite(recon).all()
        np.testing.assert_allclose(mse, ((recon - raw[:, :4].astype(np.float32)) ** 2).mean(axis=1), rtol=1e-5)


def test_stream_flush_of_a_host_transformed_bucket_matches_jax(builds, jax_app, monkeypatch):
    """A stream over the non-affine and the affine machines: the flushes go
    through ``fleet_scores``, so the same acks and events as JAX's."""
    from gordo_tpu import serve as jax_serve
    from gordo_tpu.stream import reset_plane

    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    engine = jax_serve.get_engine()
    jax_serve.install_engine(None)
    jax_serve.reset_stream_breakers()
    reset_plane()
    try:
        port = Client(build_app(str(builds[5]), device="cpu"))
        url = f"/gordo/v0/{PROJECT}/stream/d1"
        X = {name: _request(name, MACHINES[name][0], seed=70 + i, rows=16)
             for i, name in enumerate(("non-affine-a", "non-affine-b", "standard"))}
        jax_ack, ack = _post(jax_app, url + "/ingest", {"X": X}), _post(port, url + "/ingest", {"X": X})
        assert ack == jax_ack and ack[0] == 200
        assert ack[1]["scored"] == {name: 16 for name in X}
        expected, got = _events(jax_app, "d1", 8), _events(port, "d1", 8)
        _same_events(expected, got)
        assert [k for _, k, _ in got] == ["open"] + ["anomaly"] * 3
        for client in (jax_app, port):
            assert client.delete(url).status_code == 200
    finally:
        reset_plane()
        jax_serve.reset_stream_breakers()
        jax_serve.install_engine(engine)


def test_port_build_serves_its_own_definitions(builds):
    """The port's own build serves every kind: anomaly answers finite, the
    host-transformed bucket's flagged as such, the raw spec's ``/prediction``."""
    port_dir = str(builds[4])
    app = build_app(port_dir, device="cpu")
    port = Client(app)
    for i, name in enumerate(n for n in MACHINES if n != "raw-spec"):
        n_tags = MACHINES[name][0]
        body = {"X": _request(name, n_tags, seed=i), "y": _request(name, n_tags, seed=i, targets=True)}
        status, body = _post_json(port, f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction", body)
        assert status == 200, (name, body)
        values = [v for v in body["data"]["total-anomaly-confidence"]["total-anomaly-confidence"].values()]
        assert all(np.isfinite(v) for v in values if v is not None) and any(v is not None for v in values)
    fleet = app.store.fleet()
    assert fleet.host_transformed(fleet.loaded_specs()["non-affine-b"])
    status, body = _post_json(port, f"/gordo/v0/{PROJECT}/raw-spec/prediction", {"X": _request("raw-spec", 20, 1)})
    assert status == 200 and len(body["data"]["model-output"]) == 20
