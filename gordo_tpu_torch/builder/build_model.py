"""
ModelBuilder: the sequential build of one machine, the JAX package's
``gordo_tpu/builder/build_model.py`` (``:49-493``) in the port, what an
Argo build pod runs for its machine (``python -m gordo_tpu_torch build``).

:meth:`ModelBuilder.build` seeds ``random`` and numpy with 1337, fetches
the machine's rows (timed into ``query_duration_sec``), makes the model
from its definition, cross-validates it by ``evaluation.cv_mode``
(``full_build``, ``cross_val_only`` or ``build_only``), fits it, and fills
in the machine's ``build_metadata`` with the JAX artifact's keys. Cross-
validation goes through the model's own ``cross_validate`` (a detector's)
or :func:`~gordo_tpu_torch.models.model_selection.cross_validate`: a
clone of the model fitted on each fold's train rows, one fold after
another, every fold with the same seed, and scored per tag and over all
tags with the evaluation's metrics (after the ``scoring_scaler``). Each
fold's ``predict`` is one K1 launch for a feedforward autoencoder on a
card. A fleet build (``parallel/fleet_build.py``) trains all machines
at once instead and sees other batches, so the two agree only roughly;
this builder agrees with the JAX ``ModelBuilder``.

With a ``model_register_dir`` a build is first looked up in the
model-register cache: ``builds/<key>`` under the register directory,
indexed by ``utils/disk_registry.py``, the key a sha3-256 over the
machine's name, model, dataset and evaluation configs and the package's
version (:meth:`ModelBuilder.calculate_cache_key`). A hit loads the model
and trains nothing; a miss builds and registers. Every artifact is
written with ``serializer.dump_atomic``.

The model trains on ``device`` (``cuda`` unless the caller asks for the
CPU), drawing its random numbers from ``random`` (default
``TorchRandom``; tests inject the JAX trainer's).
"""

import datetime
import hashlib
import json
import logging
import os
import random as stdlib_random
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import DeviceLike, __version__, resolve_device, serializer
from ..machine import Machine
from ..machine.machine import default_build_metadata
from ..machine.metadata import TrainingSummaryMetadata, drift_baseline
from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..models.estimators import TorchAutoEncoder, TorchLSTMBaseEstimator, find_estimator
from ..models.metrics import metrics_from_list as resolve_metrics
from ..models.model_selection import TimeSeriesSplit, cross_validate
from ..models.preprocessing import Pipeline
from ..models.training import RandomSource
from ..utils import disk_registry

logger = logging.getLogger(__name__)

PathLike = Union[os.PathLike, str]

_VERSION = re.match(r"^(\d+)\.(\d+)\.(\d+)(.*)$", __version__)
MAJOR_VERSION, MINOR_VERSION = int(_VERSION.group(1)), int(_VERSION.group(2))


def version_is_stable(version: str = __version__) -> bool:
    """A version with no suffix (``1.2.3``, not ``1.2.3.dev4``).

    >>> version_is_stable("1.2.3"), version_is_stable("1.2.3.dev4")
    (True, False)
    """
    match = re.match(r"^(\d+)\.(\d+)\.(\d+)(.*)$", version)
    if match is None:
        raise ValueError(f"Unparseable package version: {version!r}")
    return not match.group(4)


def split_metadata(splits: Sequence[Tuple[np.ndarray, np.ndarray]], index: Optional[Sequence[Any]] = None) -> dict:
    """The first and last row of each fold's train and test rows, as the
    index's ISO times (positions without an index), under
    ``fold-<i>-<train|test>-<start|end>``.

    >>> split_metadata([(np.arange(2), np.arange(2, 4))])
    {'fold-1-train-start': 0, 'fold-1-train-end': 1, 'fold-1-test-start': 2, 'fold-1-test-end': 3}
    """
    metadata = {}
    for i, (train, test) in enumerate(splits):
        for label, rows in (("train", train), ("test", test)):
            for endpoint, pos in (("start", rows[0]), ("end", rows[-1])):
                value = index[pos] if index is not None else int(pos)
                metadata[f"fold-{i + 1}-{label}-{endpoint}"] = value.isoformat() if hasattr(value, "isoformat") else value
    return metadata


class ModelBuilder:
    """Builds ``machine`` on ``device`` (``cuda`` unless the caller asks for
    the CPU), its random numbers from ``random`` (default ``TorchRandom``)."""

    def __init__(self, machine: Machine, device: DeviceLike = None, random: Optional[RandomSource] = None):
        self.machine = machine
        self.device = resolve_device(device)
        self.random = random
        self._cached_model_path: Optional[str] = None
        #: the registered ``model.pkl`` of a cache hit, dumped as it is
        self.cached_model_bytes: Optional[bytes] = None

    @property
    def cache_key(self) -> str:
        return self.calculate_cache_key(self.machine)

    @property
    def cached_model_path(self) -> Optional[str]:
        return self._cached_model_path

    def build(
        self,
        output_dir: Optional[PathLike] = None,
        model_register_dir: Optional[PathLike] = None,
        replace_cache: bool = False,
    ) -> Tuple[Any, Machine]:
        """``(model, machine)``, the machine's ``build_metadata`` filled in;
        with a ``model_register_dir``, a cache hit loads the registered
        model and a miss builds and registers it (``replace_cache``
        forgets the key first); with an ``output_dir``, the artifact is
        dumped there."""
        if not model_register_dir:
            model, machine = self._build()
        else:
            logger.debug("Model register dir %s; cache key %s", model_register_dir, self.cache_key)
            cached = self.load_cached(model_register_dir, replace_cache=replace_cache)
            if cached is not None:
                model, machine = cached
            else:
                self.cached_model_bytes = None
                model, machine = self._build()
                self.register(model, machine, model_register_dir)
        if output_dir:
            self._save_model(model, machine, output_dir, pickled=self.cached_model_bytes)
        return model, machine

    def load_cached(self, model_register_dir: PathLike, replace_cache: bool = False) -> Optional[Tuple[Any, Machine]]:
        """The registered model and its machine, ``date_of_retrieval``
        stamped into its user metadata (and its ``model.pkl`` bytes in
        :attr:`cached_model_bytes`); None on a miss."""
        if replace_cache:
            self.delete_cached_model(model_register_dir)
        path = self.check_cache(model_register_dir)
        if not path:
            return None
        with open(os.path.join(path, serializer.MODEL_FILE), "rb") as f:
            self.cached_model_bytes = f.read()
        model = serializer.loads(self.cached_model_bytes, self.device)
        metadata = serializer.load_metadata(path)
        metadata["metadata"]["user_defined"]["date_of_retrieval"] = str(datetime.datetime.now(datetime.timezone.utc))
        self._cached_model_path = path
        return model, Machine.from_dict(metadata)

    def register(self, model: Any, machine: Machine, model_register_dir: PathLike) -> str:
        """Dump the artifact to ``builds/<cache key>`` of the register
        directory and index it there; its path."""
        self._cached_model_path = self._save_model(
            model, machine, os.path.join(str(model_register_dir), "builds", self.cache_key))
        disk_registry.write_key(model_register_dir, self.cache_key, self._cached_model_path)
        return self._cached_model_path

    def _build(self) -> Tuple[Any, Machine]:
        """Fetch, make the model, cross-validate, fit, fill the metadata."""
        self.set_seed(seed=1337)
        machine = self.machine.copy()
        logger.info("Fetching data for machine %s", machine.name)
        start = time.time()
        X, y, index = machine.dataset.get_data()
        query_duration = time.time() - start
        x_names, y_names = machine.dataset.column_names()

        model = serializer.from_definition(machine.model, device=self.device)
        fit_params = {"random": self.random}
        cv_duration: Optional[float] = None
        scores: Dict[str, Any] = {}
        splits: Dict[str, Any] = {}
        build_metadata = default_build_metadata()
        build_metadata["dataset"] = {"query_duration_sec": query_duration,
                                     "dataset_meta": machine.dataset.get_metadata()}

        cv_mode = machine.evaluation.get("cv_mode", "full_build").lower()
        if cv_mode in ("cross_val_only", "full_build"):
            metrics_list = self.metrics_from_list(machine.evaluation.get("metrics"))
            if hasattr(model, "predict"):
                logger.debug("Starting cross validation")
                start = time.time()
                metrics_dict = self.build_metrics_dict(
                    metrics_list, y, scaler=machine.evaluation.get("scoring_scaler"), columns=y_names)
                cv_def = machine.evaluation.get("cv")
                split_obj = serializer.from_definition(cv_def, device="cpu") if cv_def else TimeSeriesSplit(n_splits=3)
                splits = self.build_split_dict(X, split_obj, index)
                cv_kwargs = dict(X=X, y=y, scoring=metrics_dict, return_estimator=True, cv=split_obj,
                                 fit_params=fit_params)
                if hasattr(model, "cross_validate"):
                    cv = model.cross_validate(**cv_kwargs)
                else:
                    cv = cross_validate(model, **cv_kwargs)
                for metric_name in metrics_dict:
                    fold_values = cv[f"test_{metric_name}"]
                    scores[metric_name] = {
                        "fold-mean": float(fold_values.mean()),
                        "fold-std": float(fold_values.std()),
                        "fold-max": float(fold_values.max()),
                        "fold-min": float(fold_values.min()),
                        **{f"fold-{i + 1}": float(v) for i, v in enumerate(fold_values)},
                    }
                cv_duration = time.time() - start
            else:
                logger.debug("Model has no predict; skipping scoring")
            if cv_mode == "cross_val_only":
                build_metadata["model"]["cross_validation"] = {
                    "scores": scores, "cv_duration_sec": cv_duration, "splits": splits}
                machine.metadata["build_metadata"] = build_metadata
                return model, machine

        logger.debug("Starting to train model")
        start = time.time()
        model.fit(X, y, **fit_params)
        training_duration = time.time() - start
        build_metadata["model"].update(
            model_offset=self._determine_offset(model, X),
            model_creation_date=str(datetime.datetime.now(datetime.timezone.utc).astimezone()),
            model_builder_version=__version__,
            cross_validation={"scores": scores, "cv_duration_sec": cv_duration, "splits": splits},
            model_training_duration_sec=training_duration,
            model_meta=self._extract_metadata_from_model(model),
            training=self._extract_training_summary(model).to_dict(),
        )
        build_metadata["drift_baseline"] = drift_baseline(X, x_names)
        machine.metadata["build_metadata"] = build_metadata
        return model, machine

    @staticmethod
    def _extract_training_summary(model: Any) -> TrainingSummaryMetadata:
        """The final fit's loss summary, from the autoencoder's history."""
        estimator = find_estimator(model)
        history = getattr(estimator, "history", None)
        return TrainingSummaryMetadata.from_history(history) if history is not None else TrainingSummaryMetadata()

    @staticmethod
    def set_seed(seed: int) -> None:
        """Seed ``random`` and numpy (the port's training draws from its
        random source, not from these)."""
        stdlib_random.seed(seed)
        np.random.seed(seed)

    @staticmethod
    def build_split_dict(X, split_obj: Any, index: Optional[Sequence[Any]] = None) -> dict:
        """Each fold's first and last train and test row (:func:`split_metadata`)."""
        return split_metadata(list(split_obj.split(X)), index)

    @staticmethod
    def metrics_from_list(metric_names: Optional[Sequence[Union[str, Callable]]] = None) -> List[Callable]:
        """The evaluation's metrics (names, bare or ``sklearn.metrics.``, or
        callables returning one score per column); the four defaults
        without any."""
        if not metric_names:
            return resolve_metrics(None)
        return [name if callable(name) else resolve_metrics([name])[0] for name in metric_names]

    @staticmethod
    def build_metrics_dict(
        metrics_list: Sequence[Callable],
        y,
        scaler: Optional[Any] = None,
        columns: Optional[Sequence[Any]] = None,
    ) -> Dict[str, Callable[[np.ndarray, np.ndarray], float]]:
        """
        Scorers ``(y_true, y_pred) -> float`` keyed ``<metric>-<tag>`` for
        each target column (``columns``, default the column numbers; spaces
        dashed) and ``<metric>`` for the mean over the columns, metric
        names dashed (``build_model.py:377-446``). ``scaler`` (a
        definition, or an object with ``fit``/``transform``) is fitted on
        ``y`` and scales both sides first; ``y_true`` is cut to the
        prediction's last rows (an LSTM's output is shorter).
        """
        y = np.asarray(y)
        if scaler:
            if isinstance(scaler, (str, dict)):
                scaler = serializer.from_definition(scaler, device="cpu")
            scaler.fit(y)
        columns = list(range(y.shape[1])) if columns is None else list(columns)

        def scorer(metric: Callable, col: Optional[int]):
            def score(y_true, y_pred) -> float:
                if scaler is not None:
                    y_true, y_pred = scaler.transform(y_true), scaler.transform(y_pred)
                y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
                values = np.asarray(metric(y_true[-len(y_pred):], y_pred))
                return float(values[col] if col is not None else np.mean(values))

            return score

        metrics_dict = {}
        for metric in metrics_list:
            metric_str = metric.__name__.replace("_", "-")
            for i, col in enumerate(columns):
                metrics_dict[f"{metric_str}-{str(col).replace(' ', '-')}"] = scorer(metric, i)
            metrics_dict[metric_str] = scorer(metric, None)
        return metrics_dict

    @staticmethod
    def _determine_offset(model: Any, X) -> int:
        """How many rows shorter than its input the model's output is: an
        LSTM's offset, 0 for a feedforward autoencoder, read off the
        estimator rather than by a forward over every row; another model
        is asked by a ``predict``."""
        estimator = find_estimator(model)
        if isinstance(estimator, TorchLSTMBaseEstimator):
            return estimator.offset
        if isinstance(estimator, TorchAutoEncoder):
            return 0
        X = np.asarray(X)
        out = model.predict(X) if hasattr(model, "predict") else model.transform(X)
        return len(X) - len(out)

    @staticmethod
    def _extract_metadata_from_model(model: Any) -> dict:
        """``model_meta``: a detector's ``get_metadata`` (which holds its
        autoencoder's), else the autoencoder's."""
        if isinstance(model, DiffBasedAnomalyDetector):
            return model.get_metadata()
        if isinstance(model, Pipeline):
            model = model.estimator
        return model.get_metadata() if hasattr(model, "get_metadata") else {}

    @staticmethod
    def calculate_cache_key(machine: Machine) -> str:
        """sha3-256 of the JAX package's payload (``build_model.py:575-631``):
        name, model, dataset and evaluation configs, the major and minor
        version, and the version (``major.minor`` for a stable one, the
        whole version otherwise)."""
        dataset = machine.dataset
        dataset_config = dataset.to_dict() if hasattr(dataset, "to_dict") else dataset
        version = f"{MAJOR_VERSION}.{MINOR_VERSION}" if version_is_stable() else __version__
        payload = json.dumps(
            {
                "name": machine.name,
                "model_config": machine.model,
                "data_config": dataset_config,
                "evaluation_config": machine.evaluation,
                "gordo-major-version": MAJOR_VERSION,
                "gordo-minor-version": MINOR_VERSION,
                "version": version,
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha3_256(payload.encode()).hexdigest()

    @staticmethod
    def _cache_entry_valid(path: str) -> bool:
        """A loadable cache entry: a directory holding ``model.pkl``."""
        return os.path.isdir(path) and os.path.isfile(os.path.join(path, serializer.MODEL_FILE))

    @classmethod
    def probe_cache(cls, machine: Machine, model_register_dir: PathLike) -> Optional[str]:
        """:meth:`check_cache` without its clean-up of a stale key: reads only."""
        path = disk_registry.get_value(model_register_dir, cls.calculate_cache_key(machine))
        return path if path is not None and cls._cache_entry_valid(path) else None

    def check_cache(self, model_register_dir: PathLike) -> Optional[str]:
        """The registered path of this machine's build, if it is valid; a
        key pointing at a missing entry is deleted."""
        path = disk_registry.get_value(model_register_dir, self.cache_key)
        if path is None:
            return None
        if not self._cache_entry_valid(path):
            logger.warning("Registry key %s points at missing dir %s", self.cache_key, path)
            disk_registry.delete_value(model_register_dir, self.cache_key)
            return None
        return path

    def delete_cached_model(self, model_register_dir: PathLike) -> None:
        disk_registry.delete_value(model_register_dir, self.cache_key)

    @staticmethod
    def _save_model(model: Any, machine: Union[Machine, dict], output_dir: PathLike,
                    pickled: Optional[bytes] = None) -> str:
        """Dump the artifact atomically (``serializer.dump_atomic``; a cache
        hit's ``pickled`` bytes as they are); its path."""
        output_dir = str(output_dir)
        metadata = machine.to_dict() if isinstance(machine, Machine) else machine
        serializer.dump_atomic(model, output_dir, metadata=metadata, pickled=pickled)
        return output_dir
