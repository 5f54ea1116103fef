"""
The Machine: one model's configuration and its data, the part of
``gordo_tpu/machine/machine.py`` a fleet build needs.

A config is the JAX package's dict form of one machine: ``name``,
``model`` (a definition, see ``serializer/from_definition.py``),
``dataset``, ``evaluation`` (``cv_mode``, ``metrics``,
``scoring_scaler``, ``cv``), ``metadata`` and ``runtime``. The dataset
layer (providers, resampling, row filters) is not ported: the caller
passes the rows as arrays, and the ``dataset`` block is carried into the
artifact's metadata as it is given (``tag_list``, ``target_tag_list``,
``resolution``, which serving reads; ``resolution`` defaults to
``10min`` and ``target_tag_list`` to None, as the JAX dataset's do).
"""

import copy
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

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


def tag_names(tags: Optional[Sequence[Any]]) -> list:
    """Tag names of a ``tag_list`` (names or ``{"name": ...}`` dicts)."""
    return [t["name"] if isinstance(t, dict) else str(t) for t in tags or ()]


class Machine:
    """One machine: its config blocks, its rows ``X`` (``[n, tags]``) and
    ``y`` (``[n, targets]``, ``X`` itself when the targets are the tags),
    an optional row ``index`` (datetimes, for the CV split metadata), and
    the ``metadata`` tree a build fills in."""

    def __init__(
        self,
        name: str,
        model: dict,
        dataset: dict,
        project_name: str,
        X: np.ndarray,
        y: np.ndarray,
        index: Optional[Sequence[Any]] = None,
        evaluation: Optional[dict] = None,
        metadata: Optional[dict] = None,
        runtime: Optional[dict] = None,
    ):
        self.name = _valid_name(name, "machine name")
        self.project_name = _valid_name(project_name, "project name")
        if not isinstance(model, dict):
            raise ValueError(f"Model definition must be a dict, got {type(model)}")
        self.model = model
        self.dataset = dataset
        self.evaluation = evaluation if evaluation is not None else dict(DEFAULT_EVALUATION_CONFIG)
        self.metadata = metadata if metadata is not None else {"user_defined": {}, "build_metadata": {}}
        self.runtime = runtime if runtime is not None else {}
        self.X, self.y, self.index = X, y, index

    @classmethod
    def from_config(
        cls,
        config: Dict[str, Any],
        project_name: str,
        data: Tuple[np.ndarray, Optional[np.ndarray]],
        index: Optional[Sequence[Any]] = None,
    ) -> "Machine":
        """A machine from its config block and its rows ``data=(X, y)``
        (``y`` None: the targets are the tags, ``y`` is ``X``)."""
        name = config["name"]
        if config.get("model") is None:
            raise ValueError(f"Machine {name} has no model")
        dataset = {"resolution": "10min", "target_tag_list": None, **copy.deepcopy(config.get("dataset") or {})}
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
        return cls(
            name=name,
            model=copy.deepcopy(config["model"]),
            dataset=dataset,
            project_name=project_name,
            X=X,
            y=y,
            index=index,
            evaluation={**DEFAULT_EVALUATION_CONFIG, **(config.get("evaluation") or {})},
            metadata={
                "user_defined": {"global-metadata": {}, "machine-metadata": config.get("metadata") or {}},
                "build_metadata": {},
            },
            runtime=copy.deepcopy(config.get("runtime") or {}),
        )

    @property
    def tag_list(self) -> list:
        return tag_names(self.dataset.get("tag_list"))

    @property
    def target_tag_list(self) -> list:
        return tag_names(self.dataset.get("target_tag_list")) or self.tag_list

    def to_dict(self) -> Dict[str, Any]:
        """The ``metadata.json`` form, key for key the JAX machine's."""
        return {
            "name": self.name,
            "project_name": self.project_name,
            "model": self.model,
            "dataset": self.dataset,
            "evaluation": self.evaluation,
            "metadata": self.metadata,
            "runtime": self.runtime,
        }

    def __repr__(self) -> str:
        return f"Machine(name={self.name!r}, project_name={self.project_name!r})"
