"""
The MLflow reporter, the port's ``gordo_tpu/reporters/mlflow.py``: a
build's metadata as MLflow metrics and params
(:func:`get_machine_log_items`), in batches of at most 200 metrics and 100
params (:func:`batch_log_items`), logged one run a build, tagged with the
builder's cache key (``model_key``), with the machine's ``metadata.json``
attached.

The tracking client is chosen in the JAX reporter's order
(:func:`get_mlflow_client`): workspace kwargs (``AZUREML_WORKSPACE_STR``)
reach the AzureML workspace's tracking server through a service principal
(``DL_SERVICE_AUTH_STR``; ``reporters/azureml.py``); else an ``http(s)``
``MLFLOW_TRACKING_URI`` is spoken to over MLflow's REST API
(``reporters/mlflow_rest.py``, where the JAX reporter uses
``MlflowClient``); else, with it unset, :class:`FileTrackingClient` writes
under ``GORDO_TPU_MLFLOW_DIR``, as the JAX package does without mlflow. A
tracking URI of any other scheme raises. None of them falls back to
another: a server that cannot be reached fails the report.
"""

import json
import os
import shutil
import tempfile
import urllib.parse
import uuid
from collections import namedtuple
from contextlib import contextmanager
from datetime import datetime, timezone
from typing import List, Optional, Tuple

from ..utils.args import capture_args
from ..utils.env import env_str
from .azureml import ARM_HOST, LOGIN_HOST, workspace_client
from .base import BaseReporter
from .mlflow_rest import MlflowLoggingError, RestTrackingClient

Metric = namedtuple("Metric", ["key", "value", "timestamp", "step"])
Param = namedtuple("Param", ["key", "value"])


def _datetime_to_ms_since_epoch(dt: datetime) -> int:
    """Milliseconds since the Unix epoch.

    >>> _datetime_to_ms_since_epoch(datetime(1970, 1, 1, 0, 0))
    0
    """
    epoch = datetime.fromtimestamp(0, tz=timezone.utc).replace(tzinfo=dt.tzinfo)
    return round((dt - epoch).total_seconds() * 1000.0)


def epoch_now() -> int:
    """The current UTC time in ms since the epoch."""
    return _datetime_to_ms_since_epoch(datetime.now(tz=timezone.utc))


def _tag_name(tag) -> str:
    """A ``tag_list`` entry (a name or a ``{"name": ...}`` dict) as score
    keys spell it: spaces dashed."""
    if isinstance(tag, dict):
        tag = tag.get("name", "")
    elif not isinstance(tag, str):
        tag = getattr(tag, "name", str(tag))
    return tag.replace(" ", "-")


def get_machine_log_items(machine) -> Tuple[List[Metric], List[Param]]:
    """A built machine's metadata as ``(metrics, params)``: the project and
    machine names, the dataset's time range, the model's build params and
    CV splits as params; each CV score's summary and folds as metrics
    (step the fold), per-tag scores left out; the fit history's series as
    metrics with its params as params."""
    model_meta = machine.metadata["build_metadata"]["model"]
    params = [Param("project_name", machine.project_name), Param("name", machine.name)]
    dataset = machine.dataset
    dataset_dict = dataset.to_dict() if hasattr(dataset, "to_dict") else dict(dataset)
    for key in ("train_start_date", "train_end_date", "resolution", "row_filter", "row_filter_buffer_size"):
        if key in dataset_dict:
            params.append(Param(key, str(dataset_dict[key])))
    for key in ("model_creation_date", "model_builder_version", "model_offset"):
        params.append(Param(key, str(model_meta[key])))
    params.extend(Param(k, str(v)) for k, v in model_meta["cross_validation"]["splits"].items())

    metrics: List[Metric] = []
    scores = model_meta["cross_validation"]["scores"]
    if scores:
        tag_names = [_tag_name(t) for t in dataset_dict.get("tag_list", [])]
        subkeys = ["mean", "max", "min", "std"]
        keys = sorted(scores.keys())
        n_folds = len(scores[keys[0]]) - len(subkeys)
        now = epoch_now()
        for k in keys:
            if any(tag in k for tag in tag_names):  # per-tag scores: too many for MLflow
                continue
            for sk in subkeys:
                metrics.append(Metric(f"{k}-{sk}", scores[k][f"fold-{sk}"], now, 0))
            metrics.extend(Metric(k, scores[k][f"fold-{i + 1}"], now, i) for i in range(n_folds))

    history = (model_meta["model_meta"] or {}).get("history")
    if history and "params" in history:
        now = epoch_now()
        if model_meta["model_training_duration_sec"] is not None:
            metrics.append(Metric("model_training_duration_sec", float(model_meta["model_training_duration_sec"]),
                                  now, 0))
        for series_name, series in history.items():
            if series_name == "params":
                continue
            metrics.extend(Metric(series_name, float(x), now, i) for i, x in enumerate(series))
        params.extend(Param(k, str(v)) for k, v in history["params"].items())
    return metrics, params


def batch_log_items(metrics: List[Metric], params: List[Param], n_max_metrics: int = 200,
                    n_max_params: int = 100) -> List[dict]:
    """``log_batch`` keyword batches of at most ``n_max_metrics`` metrics
    (AzureML's limit) and ``n_max_params`` params (MLflow's)."""

    def n_batches(n: int, n_max: int) -> int:
        return (n // n_max) + int(n % n_max > 0)

    total = max(n_batches(len(metrics), n_max_metrics), n_batches(len(params), n_max_params))
    return [
        {"metrics": metrics[i * n_max_metrics: (i + 1) * n_max_metrics],
         "params": params[i * n_max_params: (i + 1) * n_max_params]}
        for i in range(total)
    ]


def get_kwargs_from_secret(name: str, keys: List[str]) -> dict:
    """A colon-separated secret in the variable ``name`` as kwargs: empty
    gives ``{}``; an unset variable or a count of elements other than
    ``keys``' raises."""
    secret_str = os.getenv(name)
    if secret_str is None:
        raise MlflowLoggingError(f"The value for env var '{name}' must not be `None`.")
    if not secret_str:
        return {}
    elements = secret_str.split(":")
    if len(elements) != len(keys):
        raise MlflowLoggingError(f"keys len {len(keys)} must equal env var {name} elements {len(elements)}.")
    return dict(zip(keys, elements))


def get_workspace_kwargs() -> dict:
    """AzureML workspace kwargs from ``AZUREML_WORKSPACE_STR``."""
    return get_kwargs_from_secret("AZUREML_WORKSPACE_STR", ["subscription_id", "resource_group", "workspace_name"])


def get_spauth_kwargs() -> dict:
    """Service-principal kwargs from ``DL_SERVICE_AUTH_STR``."""
    return get_kwargs_from_secret("DL_SERVICE_AUTH_STR",
                                  ["tenant_id", "service_principal_id", "service_principal_password"])


class FileTrackingClient:
    """The JAX package's tracking client without mlflow: a run is
    ``<root>/<experiment>/<run>/`` with ``tags.json``, ``batches.jsonl``
    (one line a ``log_batch``), ``artifacts/`` and ``status``."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or env_str("GORDO_TPU_MLFLOW_DIR", os.path.join(tempfile.gettempdir(), "gordo-mlruns"))

    def _run_dir(self, run_id: str) -> str:
        experiment, _, run = run_id.partition("/")
        return os.path.join(self.root, experiment, run)

    def create_run(self, experiment_name: str, tags: dict) -> str:
        run_id = f"{experiment_name}/{uuid.uuid4().hex}"
        run_dir = self._run_dir(run_id)
        os.makedirs(os.path.join(run_dir, "artifacts"), exist_ok=True)
        with open(os.path.join(run_dir, "tags.json"), "w") as fh:
            json.dump(tags, fh)
        return run_id

    def log_batch(self, run_id: str, metrics=(), params=()) -> None:
        with open(os.path.join(self._run_dir(run_id), "batches.jsonl"), "a") as fh:
            fh.write(json.dumps({"metrics": [list(m) for m in metrics], "params": [list(p) for p in params]}) + "\n")

    def log_artifacts(self, run_id: str, local_dir: str) -> None:
        dest = os.path.join(self._run_dir(run_id), "artifacts")
        for name in os.listdir(local_dir):
            shutil.copy(os.path.join(local_dir, name), os.path.join(dest, name))

    def set_terminated(self, run_id: str) -> None:
        with open(os.path.join(self._run_dir(run_id), "status"), "w") as fh:
            fh.write("FINISHED")


def get_mlflow_client(workspace_kwargs: Optional[dict] = None, service_principal_kwargs: Optional[dict] = None,
                      login_host: str = LOGIN_HOST, arm_host: str = ARM_HOST):
    """The tracking client: the AzureML workspace's with workspace kwargs
    (through ``login_host`` and ``arm_host``), the REST client of an
    ``http(s)`` ``MLFLOW_TRACKING_URI``, or the file client with it unset."""
    if workspace_kwargs:
        return workspace_client(workspace_kwargs, service_principal_kwargs or {}, login_host, arm_host)
    tracking_uri = env_str("MLFLOW_TRACKING_URI", None)
    if tracking_uri is None:
        return FileTrackingClient()
    scheme = urllib.parse.urlsplit(tracking_uri).scheme
    if scheme not in ("http", "https"):
        raise MlflowLoggingError(f"MLFLOW_TRACKING_URI {tracking_uri!r}: the scheme {scheme!r} is not supported "
                                 "(http and https are; unset, runs go under GORDO_TPU_MLFLOW_DIR)")
    return RestTrackingClient(tracking_uri)


def get_run_id(client, experiment_name: str, model_key: str) -> str:
    """A new run of the experiment (created on a tracking server that lacks
    it), tagged with the model's cache key."""
    if isinstance(client, FileTrackingClient):
        return client.create_run(experiment_name, tags={"model_key": model_key})
    experiment = client.get_experiment_by_name(experiment_name)
    experiment_id = experiment["experiment_id"] if experiment else client.create_experiment(experiment_name)
    return client.create_run(experiment_id, tags={"model_key": model_key})


@contextmanager
def mlflow_context(name: str, model_key: Optional[str] = None, workspace_kwargs: Optional[dict] = None,
                   service_principal_kwargs: Optional[dict] = None, login_host: str = LOGIN_HOST,
                   arm_host: str = ARM_HOST):
    """``(client, run_id)``, the run terminated on exit."""
    client = get_mlflow_client(workspace_kwargs, service_principal_kwargs, login_host, arm_host)
    run_id = get_run_id(client, name, model_key or uuid.uuid4().hex)
    try:
        yield client, run_id
    finally:
        client.set_terminated(run_id)


def log_machine(client, run_id: str, machine) -> None:
    """The machine's batches, and its dict as a ``metadata.json`` artifact."""
    for batch_kwargs in batch_log_items(*get_machine_log_items(machine)):
        client.log_batch(run_id, **batch_kwargs)
    try:
        with tempfile.TemporaryDirectory() as tmp_dir:
            with open(os.path.join(tmp_dir, "metadata.json"), "w") as fh:
                fh.write(machine.to_json())
            client.log_artifacts(run_id=run_id, local_dir=tmp_dir)
    except Exception as exc:
        raise MlflowLoggingError(exc)


class MlFlowReporter(BaseReporter):
    """One tracked run a build, keyed by the builder's cache key."""

    @capture_args
    def __init__(self, *args, model_builder_class=None, **kwargs):
        from ..builder.utils import create_model_builder

        self.model_builder_class = (model_builder_class if isinstance(model_builder_class, type)
                                    else create_model_builder(model_builder_class))

    def report(self, machine) -> None:
        workspace_kwargs = get_workspace_kwargs() if os.getenv("AZUREML_WORKSPACE_STR") is not None else {}
        service_principal_kwargs = get_spauth_kwargs() if os.getenv("DL_SERVICE_AUTH_STR") is not None else {}
        cache_key = self.model_builder_class.calculate_cache_key(machine)
        with mlflow_context(machine.name, cache_key, workspace_kwargs, service_principal_kwargs) as (client, run_id):
            log_machine(client, run_id, machine)
