"""
The Machine: one model's configuration, ``gordo_tpu/machine/machine.py``
in the port: ``name``, ``model`` (a definition, see
``serializer/from_definition.py``), ``dataset`` (a dataset object of
``dataset/datasets.py``; a dict is read with
``GordoBaseDataset.from_dict``), ``evaluation`` (``cv_mode``,
``metrics``, ``scoring_scaler``, ``cv``), ``metadata`` and ``runtime``.

:meth:`Machine.from_config` merges a machine block with the project's
globals in the JAX package's directions (``machine.py:81-128``): the
globals are the base of ``runtime`` and ``evaluation``, but the globals'
``dataset`` patches over the machine's. :meth:`Machine.from_dict` reads
back :meth:`Machine.to_dict`, the form a machine shard holds.

A caller that already holds the rows passes them as ``data=(X, y)``
(``y`` None: the targets are the tags): the dataset is then an
``ArrayDataset``, whose ``to_dict`` is the config's ``dataset`` block as
given, with ``resolution`` (default ``10min``) and ``target_tag_list``
(default None).
"""

import copy
import datetime
import json
import logging
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..dataset import ArrayDataset, GordoBaseDataset
from ..dataset.sensor_tag import to_list_of_strings
from ..workflow.helpers import patch_dict
from .loader import GlobalsConfig, load_machine_config

logger = logging.getLogger(__name__)

DEFAULT_EVALUATION_CONFIG = {
    "cv_mode": "full_build",
    "scoring_scaler": "sklearn.preprocessing.MinMaxScaler",
    "metrics": [
        "explained_variance_score",
        "r2_score",
        "mean_squared_error",
        "mean_absolute_error",
    ],
}

#: a k8s resource name / DNS label, as the JAX package validates names
_NAME = re.compile(r"^[a-z0-9]([a-z0-9\-]{0,61}[a-z0-9])?$")


def _valid_name(value: Any, what: str) -> str:
    if not isinstance(value, str) or not _NAME.match(value):
        raise ValueError(
            f"{what} {value!r} is not a valid name: must be lowercase alphanumeric "
            "or '-', at most 63 chars, starting/ending alphanumeric"
        )
    return value


def json_default(obj: Any) -> Any:
    """What JSON cannot hold, as the JAX package's ``MachineJSONEncoder``
    writes it: datetimes as ISO strings, objects by ``to_dict``, numpy
    values as Python's."""
    if isinstance(obj, (datetime.datetime, datetime.date)):
        return obj.isoformat()
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def tag_names(tags: Optional[Sequence[Any]]) -> list:
    """Tag names of a ``tag_list`` (names or ``{"name": ...}`` dicts)."""
    return [t["name"] if isinstance(t, dict) else str(t) for t in tags or ()]


def default_build_metadata() -> Dict[str, Any]:
    """The ``build_metadata`` tree of a machine not yet built, as the JAX
    package's ``Metadata().to_dict()`` writes it."""
    return {
        "model": {
            "model_offset": 0,
            "model_creation_date": None,
            "model_builder_version": None,
            "cross_validation": {"scores": {}, "cv_duration_sec": None, "splits": {}},
            "model_training_duration_sec": None,
            "model_meta": {},
            "training": {
                "final_loss": None, "best_loss": None, "final_val_loss": None, "best_val_loss": None,
                "epochs_run": 0, "epochs_configured": 0, "early_stop_epoch": None,
            },
        },
        "dataset": {"query_duration_sec": None, "dataset_meta": {}},
        "robustness": {"fleet_retries": 0, "bucket_bisects": 0, "data_fetch_retries": 0},
        "drift_baseline": {"tags": [], "feature_means": [], "feature_stds": [], "n_samples": 0},
    }


class Machine:
    """One machine: its config blocks and the ``metadata`` tree a build
    fills in."""

    def __init__(
        self,
        name: str,
        model: dict,
        dataset: Any,
        project_name: str,
        evaluation: Optional[dict] = None,
        metadata: Optional[dict] = None,
        runtime: Optional[dict] = None,
    ):
        self.name = _valid_name(name, "machine name")
        self.project_name = _valid_name(project_name, "project name")
        if not isinstance(model, dict):
            raise ValueError(f"Model definition must be a dict, got {type(model)}")
        self.model = model
        if isinstance(dataset, dict):
            dataset = GordoBaseDataset.from_dict(copy.deepcopy(dataset))
        if not isinstance(dataset, GordoBaseDataset):
            raise ValueError(f"Dataset must be a dict or GordoBaseDataset, got {type(dataset)}")
        self.dataset = dataset
        self.evaluation = evaluation if evaluation is not None else dict(DEFAULT_EVALUATION_CONFIG)
        self.metadata = (
            metadata if metadata is not None
            else {"user_defined": {}, "build_metadata": default_build_metadata()}
        )
        self.runtime = runtime if runtime is not None else {}

    @classmethod
    def from_config(
        cls,
        config: Dict[str, Any],
        project_name: Optional[str] = None,
        config_globals: Optional[GlobalsConfig] = None,
        data: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
        index: Optional[Sequence[Any]] = None,
    ) -> "Machine":
        """A machine from its config block and the project's globals; with
        ``data=(X, y)`` its rows as arrays (and ``index``, their datetimes)."""
        config = load_machine_config(config)
        config_globals = config_globals or {}
        name = config["name"]
        model = config.get("model") or config_globals.get("model")
        if model is None:
            raise ValueError(f"Machine {name} has no model (locally or in globals)")
        if project_name is None:
            project_name = config.get("project_name")
        if project_name is None:
            raise ValueError("project_name is empty")
        runtime = patch_dict(config_globals.get("runtime", {}), config.get("runtime", {}))
        dataset = patch_dict(config.get("dataset") or {}, config_globals.get("dataset", {}))
        evaluation = patch_dict(
            config_globals.get("evaluation", DEFAULT_EVALUATION_CONFIG), config.get("evaluation") or {}
        )
        if data is not None:
            dataset = _array_dataset(name, {"resolution": "10min", "target_tag_list": None, **dataset}, data, index)
        return cls(
            name=name,
            model=copy.deepcopy(model),
            dataset=dataset,
            project_name=project_name,
            evaluation=evaluation,
            metadata={
                "user_defined": {
                    "global-metadata": config_globals.get("metadata", {}),
                    "machine-metadata": config.get("metadata", {}),
                },
                "build_metadata": default_build_metadata(),
            },
            runtime=runtime,
        )

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "Machine":
        """A machine from :meth:`to_dict`'s form (a shard's entry)."""
        return cls(
            name=config["name"],
            model=config["model"],
            dataset=config["dataset"],
            project_name=config["project_name"],
            evaluation=config.get("evaluation"),
            metadata=config.get("metadata"),
            runtime=config.get("runtime"),
        )

    def copy(self) -> "Machine":
        """An independent machine for a build's results: the dataset made
        anew from its config (a provider's cached file stays behind), the
        rest deep-copied. Rows a caller handed in are shared."""
        dataset = self.dataset
        if not isinstance(dataset, ArrayDataset):
            dataset = dataset.to_dict()
        return Machine(
            name=self.name,
            model=copy.deepcopy(self.model),
            dataset=dataset,
            project_name=self.project_name,
            evaluation=copy.deepcopy(self.evaluation),
            metadata=copy.deepcopy(self.metadata),
            runtime=copy.deepcopy(self.runtime),
        )

    @property
    def tag_list(self) -> list:
        return to_list_of_strings(self.dataset.tag_list)

    @property
    def target_tag_list(self) -> list:
        return to_list_of_strings(self.dataset.target_tag_list)

    def to_dict(self) -> Dict[str, Any]:
        """The ``metadata.json`` form, key for key the JAX machine's."""
        return {
            "name": self.name,
            "project_name": self.project_name,
            "model": self.model,
            "dataset": self.dataset.to_dict(),
            "evaluation": self.evaluation,
            "metadata": self.metadata,
            "runtime": self.runtime,
        }

    def to_json(self) -> str:
        """:meth:`to_dict` as JSON, datetimes as ISO strings."""
        return json.dumps(self.to_dict(), default=json_default)

    def to_yaml(self) -> str:
        """:meth:`to_dict` as JSON text, which is YAML: the JAX machine
        writes block YAML (``yaml.dump``), which reads back the same; the
        port has no YAML writer."""
        return json.dumps(self.to_dict(), default=json_default, indent=1)

    def report(self) -> None:
        """Run the reporters of ``runtime.reporters`` on this machine
        (``gordo_tpu/machine/machine.py:217-227``)."""
        from ..reporters.base import create_reporters

        for reporter in create_reporters(self.runtime.get("reporters", [])):
            logger.debug("Reporting machine %s via %r", self.name, reporter)
            reporter.report(self)

    def __repr__(self) -> str:
        return f"Machine(name={self.name!r}, project_name={self.project_name!r})"


def _array_dataset(name: str, dataset: dict, data, index) -> ArrayDataset:
    X = np.asarray(data[0])
    y = X if data[1] is None else np.asarray(data[1])
    tags = tag_names(dataset.get("tag_list"))
    targets = tag_names(dataset.get("target_tag_list")) or tags
    if X.ndim != 2 or X.shape[1] != len(tags):
        raise ValueError(f"{name}: X has shape {X.shape}, the dataset names {len(tags)} tags")
    if y.ndim != 2 or len(y) != len(X) or y.shape[1] != len(targets):
        raise ValueError(f"{name}: y has shape {y.shape}, expected ({len(X)}, {len(targets)})")
    if index is not None and len(index) != len(X):
        raise ValueError(f"{name}: index has {len(index)} entries for {len(X)} rows")
    return ArrayDataset(dataset, X, y, index)
