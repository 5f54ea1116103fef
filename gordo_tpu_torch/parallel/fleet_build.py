"""
FleetBuilder: the dense fleet build of ``gordo_tpu/parallel/fleet_build.py``
(``_run_build``, ``:504-683``) in the port. Every machine of a project
is trained as stacked buckets and written out in the artifact layout the
port's server loads (``model.pkl``, ``metadata.json``, ``info.json``).

Per machine it follows the JAX builder:

- **plan** (``_plan_machine``, ``:889-922``): the definition becomes
  port objects;
- **data fetch** (``_load_all_data``, ``:1169-1245``): the machine's
  dataset fetches and resamples its rows (``dataset/datasets.py``, on
  the host), timed into ``query_duration_sec``; a failed fetch is tried
  again ``GORDO_TPU_DATA_RETRIES`` times (default 2) after
  ``GORDO_TPU_DATA_BACKOFF`` seconds (0.5), doubling, within an optional
  ``GORDO_TPU_DATA_DEADLINE``; configuration errors, too few rows and
  what the port does not implement are not tried again. A machine whose
  fetch fails is recorded in ``build_errors``;
- **stage** (``_stage_arrays``, ``:1247-1304``): the host pipeline steps
  (MinMax) are fitted on the machine's X, ``y`` is aliased to ``X`` when
  they are equal, and the fit config and seed come from the estimator's
  kwargs. An LSTM machine keeps its series and its window targets
  (``ops.windows.window_targets``) instead, its model offset is
  ``lookback + lookahead - 1``, and it never shuffles between epochs;
- **cross-validation** (``:1308-1394``): fold models are members
  ``<machine>::fold<k>`` with seed ``seed + 1000 * (k + 1)`` and the
  fold's rows as train weights, appended fold-major, all folds of all
  machines of one fit config in one ``train`` call (chunked by
  ``GORDO_TPU_CV_CHUNK_BYTES``); each (spec, width) group of trained
  folds is scored by **one** forward, ``FleetTrainer.predict_bucket``
  (one K1 launch on a card, ``:1579-1636``), an LSTM spec group by one
  windowed forward of its folds' test windows
  (``predict_windowed_bucket``, ``:1638-1661``). An LSTM fold trains on
  the windows whose targets lie in its train rows and is scored on those
  whose targets lie in its test rows (``_window_train_weights``,
  ``_test_window_rows``, ``:1453-1485``): folds must be contiguous, so a
  KFCV LSTM machine fails as it does in JAX. Then per-tag and aggregate
  metric scores, and the ``DiffBasedAnomalyDetector`` thresholds: the
  error scaler fitted on the fold's train targets, thresholds the max
  over time of 6-row rolling minimums, the last fold's kept
  (``:1687-1860``). A ``DiffBasedKFCVAnomalyDetector`` is
  cross-validated with ``KFold(5, shuffle=True, random_state=0)``; its
  folds' errors are kept with their test rows, stitched back into row
  order, and its thresholds are a quantile of their smoothing;
- **final fit** of every machine (``:1864-1965``), then the detector's
  error scaler fitted on ``y``;
- **assemble and dump** (``:1969-2011``): ``metadata.json`` with the
  JAX artifact's ``dataset`` and ``build_metadata.model`` keys
  (``model_offset``: 0, or an LSTM's offset; ``cross_validation.{scores, splits,
  cv_duration_sec}``, ``training``, ``model_meta``), the dataset's own
  ``get_metadata()`` and fetch time under ``build_metadata.dataset``,
  ``info.json`` with the model's checksum.

Where the JAX builder does more, the port does not yet (``ROADMAP.md``
queue 3): a machine that fails, or whose program fails alone on the
device after bisection, is recorded in ``build_errors`` (there is no
sequential builder to fall back to); fetches run one after another,
not in a thread pool; there is no journal, resume, model-register
cache, telemetry, progress file or packing.
"""

import contextlib
import datetime
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import DeviceLike, __version__, serializer
from ..dataset.exceptions import ConfigException, InsufficientDataError
from ..machine import Machine, TrainingSummaryMetadata
from ..machine.metadata import drift_baseline
from ..models.anomaly.diff import DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector
from ..models.estimators import TorchAutoEncoder, TorchLSTMBaseEstimator
from ..models.metrics import metrics_from_list
from ..models.model_selection import KFold, TimeSeriesSplit, shuffle_indices
from ..models.nn import params_from_jax
from ..models.preprocessing import MinMaxScaler, Pipeline
from ..models.training import FitConfig, RandomSource, fit_config_from_kwargs, split_fit_kwargs
from ..ops.windows import model_offset, window_targets
from ..utils.env import env_float, env_int
from .fleet import FleetMember, FleetTrainer, WindowedFleetMember, stack_member_params

logger = logging.getLogger(__name__)


class FleetBuildError(RuntimeError):
    pass


@dataclass
class _Plan:
    """Everything needed to train and reassemble one machine."""

    machine: Machine
    model_obj: Any  # the unfitted object graph of the definition
    detector: Optional[DiffBasedAnomalyDetector]
    pipeline: Optional[Pipeline]
    estimator: TorchAutoEncoder
    X: np.ndarray = None  # the fetched rows, float64
    y: np.ndarray = None
    index: Optional[Sequence[Any]] = None  # the rows' datetimes
    query_duration: Optional[float] = None
    data_retries: int = 0
    X_arr: np.ndarray = None  # inputs after the host pipeline steps, float32
    y_arr: np.ndarray = None  # targets, float32 (X_arr itself when equal)
    offset: int = 0  # the model offset: rows the output is shorter than the input
    targets: Optional[np.ndarray] = None  # an LSTM's window targets (None: dense)
    n_windows: int = 0  # training samples: windows, or rows
    shuffle_perm: Optional[np.ndarray] = None  # the detector's sample shuffle
    spec: Any = None
    fit_config: FitConfig = None
    seed: int = 42
    cv_scores: Dict[str, Any] = field(default_factory=dict)
    cv_splits: Dict[str, Any] = field(default_factory=dict)
    cv_duration: float = 0.0
    train_duration: float = 0.0
    fleet_retries: int = 0
    bucket_bisects: int = 0
    training_summary: Optional[TrainingSummaryMetadata] = None
    scoring: Any = None  # (metrics, fitted scoring scaler), made once
    shuffled: Any = None  # (X, y) in the shuffle's order, made once

    @property
    def windowed(self) -> bool:
        return self.targets is not None


def _cv_chunk_bytes() -> int:
    """Staging budget of one CV ``train`` call (raw member bytes);
    ``GORDO_TPU_CV_CHUNK_BYTES`` overrides it."""
    return env_int("GORDO_TPU_CV_CHUNK_BYTES", 1 << 30)


def _member_nbytes(member) -> int:
    if isinstance(member, WindowedFleetMember):
        return member.series.nbytes + member.targets.nbytes
    return member.X.nbytes + (0 if member.y is member.X else member.y.nbytes)


def _chunk_by_bytes(members, items, budget: int):
    """Order-preserving chunks of (members, items) whose member bytes stay
    under ``budget`` (every chunk holds at least one member)."""
    chunks = []
    start, used = 0, 0
    for i, member in enumerate(members):
        size = _member_nbytes(member)
        if i > start and used + size > budget:
            chunks.append((members[start:i], items[start:i]))
            start, used = i, 0
        used += size
    if start < len(members):
        chunks.append((members[start:], items[start:]))
    return chunks


def _fold_member_name(machine_name: str, fold_idx: int) -> str:
    """A fold model's member name; ``::`` cannot occur in a machine name."""
    return f"{machine_name}::fold{fold_idx}"


def _rolling_min_max(values: np.ndarray, window: int):
    """
    ``pd.Series(values).rolling(window).min().max()`` in numpy: the max
    over time of the minimum of each ``window``-row run. A run holding a
    NaN has a NaN minimum and is skipped by the max; no complete run, or
    only NaN ones, gives NaN. ``[n]`` gives a float, ``[n, k]`` a ``[k]``.

    >>> _rolling_min_max(np.array([3.0, 1.0, 4.0, 1.0, 5.0, 9.0]), 2)
    5.0
    """
    values = np.asarray(values, np.float64)
    if len(values) < window:
        return np.nan if values.ndim == 1 else np.full(values.shape[1], np.nan)
    mins = np.lib.stride_tricks.sliding_window_view(values, window, axis=0).min(axis=-1)
    if np.isnan(mins).any():
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slice
            out = np.nanmax(mins, axis=0)
    else:
        out = mins.max(axis=0)
    return float(out) if values.ndim == 1 else out


#: windows an LSTM group's CV forward gathers at once
SCORING_BATCH = 256


def _window_train_weights(plan: _Plan, train_idx: np.ndarray) -> np.ndarray:
    """A fold's train rows as a train mask over the plan's samples: the
    rows themselves for a dense model; for an LSTM, the windows whose
    targets lie in the fold's rows ``[first, last]``, which must be
    contiguous (``_window_train_weights``, ``fleet_build.py:1453-1469``).

    >>> plan = _Plan(None, None, None, None, None, offset=2, targets=np.zeros(8), n_windows=8)
    >>> _window_train_weights(plan, np.arange(5)).tolist()
    [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    """
    weights = np.zeros(plan.n_windows, np.float32)
    if plan.offset == 0:
        weights[train_idx[train_idx < plan.n_windows]] = 1.0
        return weights
    if len(train_idx) != int(train_idx[-1]) - int(train_idx[0]) + 1:
        raise FleetBuildError(
            f"{plan.machine.name}: non-contiguous CV folds are not supported for windowed "
            "(LSTM) models in fleet builds"
        )
    weights[: max(int(train_idx[-1]) + 1 - plan.offset, 0)] = 1.0
    return weights


def _test_window_rows(plan: _Plan, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A fold's test rows as ``(windows to forward, the rows they
    target)``: for an LSTM the windows of a contiguous ``[b, c)`` are
    ``[b, c - offset)``, targeting ``[b + offset, c)``
    (``_test_window_rows``, ``fleet_build.py:1471-1485``).

    >>> plan = _Plan(None, None, None, None, None, offset=2, targets=np.zeros(8), n_windows=8)
    >>> [a.tolist() for a in _test_window_rows(plan, np.arange(5, 10))]
    [[5, 6, 7], [7, 8, 9]]
    """
    if plan.offset == 0:
        rows = rows[rows < plan.n_windows]
        return rows, rows
    b, c = int(rows[0]), int(rows[-1]) + 1
    windows = np.arange(b, max(c - plan.offset, b))
    windows = windows[windows < plan.n_windows]
    return windows, windows + plan.offset


def _cv_for(plan: _Plan):
    """The machine's CV splitter: ``KFold(5, shuffle=True,
    random_state=0)`` for a KFCV detector, else its evaluation's ``cv``
    definition, else ``TimeSeriesSplit(n_splits=3)``."""
    if isinstance(plan.detector, DiffBasedKFCVAnomalyDetector):
        return KFold(n_splits=5, shuffle=True, random_state=0)
    cv_def = plan.machine.evaluation.get("cv")
    return serializer.from_definition(cv_def, device="cpu") if cv_def else TimeSeriesSplit(n_splits=3)


def _retry_call(fn, attempts: int, backoff: float, deadline: Optional[float], no_retry, on_retry):
    """``fn()``, tried up to ``attempts`` times, sleeping ``backoff * 2**k``
    seconds (at most 30) between tries; ``no_retry`` exceptions, and a
    sleep that would cross ``deadline`` seconds, re-raise at once
    (``gordo_tpu/utils/retry.py::retry_call``)."""
    start = time.monotonic()
    attempt = 1
    while True:
        try:
            return fn()
        except no_retry:
            raise
        except Exception as exc:
            delay = min(backoff * 2.0 ** (attempt - 1), 30.0)
            if attempt >= attempts or (deadline is not None and time.monotonic() - start + delay > deadline):
                raise
            on_retry(attempt, exc)
            time.sleep(delay)
            attempt += 1


class FleetBuilder:
    """
    Builds every machine of ``machines`` as stacked fleet buckets on
    ``device`` (``cuda`` unless the caller asks for the CPU), drawing each
    member's random numbers from ``random`` (default ``TorchRandom``).

    ``build_errors`` maps a failed machine to its exception: one machine's
    failure spares the rest. ``phase_seconds`` holds the host wall time
    of each phase: ``plan``, ``data_fetch``, ``stage``, ``cv_train``,
    ``cv_predict`` (the fold forwards through K1), ``cv_score``,
    ``cv_finalize``, ``final_fit``, ``assemble``, ``dump``.
    """

    def __init__(
        self,
        machines: Sequence[Machine],
        device: DeviceLike = None,
        random: Optional[RandomSource] = None,
    ):
        self.machines = list(machines)
        self.trainer = FleetTrainer(device, random)
        self.device = self.trainer.device
        self.build_errors: Dict[str, BaseException] = {}
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        self.robustness: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def _phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] += time.perf_counter() - start

    def _fail(self, name: str, exc: BaseException) -> None:
        logger.error("Fleet build of machine %s failed: %r", name, exc)
        self.build_errors[name] = exc

    def _skipped(self, name: str) -> bool:
        return name in self.build_errors

    # -------------------------------------------------------------------- API

    def build(self, output_dir: Optional[str] = None) -> List[Tuple[Any, Machine]]:
        """Train the whole fleet; ``(model, machine)`` for every machine
        that built, in input order, its metadata filled in. With an
        ``output_dir``, each is dumped to ``output_dir/<name>/``."""
        self.build_errors = {}
        self.phase_seconds = defaultdict(float)
        self.robustness = defaultdict(int)
        bisects_start = self.trainer.bucket_bisects
        counts_start = dict(self.trainer.bisect_counts)
        with self._phase("plan"):
            plans = []
            for machine in self.machines:
                try:
                    plans.append(self._plan_machine(machine))
                except Exception as exc:
                    self._fail(machine.name, exc)
        plans = self._load_all_data(plans)

        def cv_mode(plan: _Plan) -> str:
            return plan.machine.evaluation.get("cv_mode", "full_build").lower()

        cv_plans = [p for p in plans if cv_mode(p) in ("full_build", "cross_val_only")]
        if cv_plans:
            self._run_cross_validation(cv_plans)
        self._run_final_fit(
            [p for p in plans if not self._skipped(p.machine.name) and cv_mode(p) != "cross_val_only"]
        )
        # bisections the trainer resolved inside a train call, by machine
        for member_name, count in self.trainer.bisect_counts.items():
            delta = count - counts_start.get(member_name, 0)
            for plan in plans:
                if delta > 0 and plan.machine.name == member_name.split("::", 1)[0]:
                    plan.bucket_bisects += delta
        self.robustness["bucket_bisects"] += self.trainer.bucket_bisects - bisects_start

        results = []
        with self._phase("assemble"):
            for plan in plans:
                if self._skipped(plan.machine.name):
                    continue
                try:
                    results.append(self._assemble(plan))
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
        if output_dir is not None:
            with self._phase("dump"):
                results = self._dump_all(results, output_dir)
        return results

    def _dump_all(self, results, output_dir: str):
        saved = []
        for model, machine in results:
            try:
                serializer.dump(model, os.path.join(output_dir, machine.name), metadata=machine.to_dict())
            except Exception as exc:
                self._fail(machine.name, exc)
                continue
            saved.append((model, machine))
        return saved

    # --------------------------------------------------------------- planning

    def _load_all_data(self, plans: List[_Plan]) -> List[_Plan]:
        """Fetch and stage every plan; a machine that fails drops out and
        is recorded in ``build_errors``."""
        attempts = 1 + max(0, env_int("GORDO_TPU_DATA_RETRIES", 2))
        backoff = env_float("GORDO_TPU_DATA_BACKOFF", 0.5)
        deadline = env_float("GORDO_TPU_DATA_DEADLINE", None)

        def note_retry(plan: _Plan, attempt: int, exc: BaseException) -> None:
            plan.data_retries += 1
            logger.warning("Data fetch retry %d for %s after %r", attempt, plan.machine.name, exc)

        fetched = []
        with self._phase("data_fetch"):
            for plan in plans:
                start = time.perf_counter()
                try:
                    X, y, index = _retry_call(
                        plan.machine.dataset.get_data, attempts, backoff, deadline,
                        no_retry=(ConfigException, InsufficientDataError, NotImplementedError),
                        on_retry=lambda attempt, exc, plan=plan: note_retry(plan, attempt, exc),
                    )
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                plan.query_duration = time.perf_counter() - start
                plan.X, plan.y, plan.index = X, y, index
                fetched.append(plan)
        self.robustness["data_fetch_retries"] += sum(p.data_retries for p in plans)
        staged = []
        with self._phase("stage"):
            for plan in fetched:
                try:
                    self._stage_arrays(plan)
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                staged.append(plan)
        return staged

    def _plan_machine(self, machine: Machine) -> _Plan:
        model_obj = serializer.from_definition(machine.model, device=self.device)
        obj, detector, pipeline = model_obj, None, None
        if isinstance(obj, DiffBasedAnomalyDetector):
            detector, obj = obj, obj.base_estimator
        if isinstance(obj, Pipeline):
            pipeline, obj = obj, obj.estimator
        if not isinstance(obj, TorchAutoEncoder):
            raise FleetBuildError(f"{machine.name}: the model's estimator {obj!r} is not an autoencoder")
        return _Plan(machine=machine, model_obj=model_obj, detector=detector, pipeline=pipeline, estimator=obj)

    @staticmethod
    def _stage_arrays(plan: _Plan) -> None:
        """Fit the host pipeline steps, window an LSTM's targets, resolve
        spec, fit config and seed."""
        machine = plan.machine
        X_arr = np.asarray(plan.X, np.float32)
        y_arr = np.asarray(plan.y, np.float32)
        if plan.pipeline is not None and plan.pipeline.transformers:
            transformed = np.asarray(plan.X, np.float64)
            for transformer in plan.pipeline.transformers:
                transformed = transformer.fit_transform(transformed)
            X_arr = np.asarray(transformed, np.float32)
        estimator = plan.estimator
        fit_kwargs, _ = split_fit_kwargs(estimator.kwargs)
        if isinstance(estimator, TorchLSTMBaseEstimator):
            # the series stays whole; windows are gathered on the device
            plan.offset = model_offset(estimator.lookback_window, estimator.lookahead)
            plan.targets = window_targets(y_arr, estimator.lookback_window, estimator.lookahead)
            plan.n_windows = len(plan.targets)
            fit_kwargs["shuffle"] = False
        else:
            # pure autoencoder builds train y == X: stage the block once
            if X_arr.shape == y_arr.shape and np.array_equal(X_arr, y_arr):
                y_arr = X_arr
            plan.n_windows = len(X_arr)
        plan.X_arr, plan.y_arr = X_arr, y_arr
        estimator.kwargs.update(n_features=X_arr.shape[1], n_features_out=y_arr.shape[1])
        if plan.detector is not None and plan.detector.shuffle:
            # the detector's fit trains on sklearn.utils.shuffle's sample
            # order (an LSTM's: its window order); scoring is chronological
            plan.shuffle_perm = shuffle_indices(plan.n_windows, random_state=0)
        plan.spec = estimator.build_spec(X_arr.shape[1], y_arr.shape[1])
        config, host_callbacks = fit_config_from_kwargs(fit_kwargs)
        if host_callbacks:
            raise FleetBuildError(f"{machine.name}: custom host callbacks are not supported in fleet builds")
        plan.fit_config = config
        plan.seed = int(fit_kwargs.get("seed", 42))

    # --------------------------------------------------------------------- CV

    def _run_cross_validation(self, plans: List[_Plan]) -> None:
        """Every fold of every machine of one fit config trains in one
        ``train`` call; fold boundaries are train-weight masks."""
        start = time.perf_counter()
        fold_state: Dict[str, Dict[str, Any]] = {p.machine.name: {} for p in plans}
        per_plan_folds: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        max_folds = 0
        for plan in plans:
            try:
                splits = list(_cv_for(plan).split(plan.X_arr))
                plan.cv_splits = self._split_metadata(plan, splits)
            except Exception as exc:
                self._fail(plan.machine.name, exc)
                continue
            per_plan_folds[plan.machine.name] = splits
            max_folds = max(max_folds, len(splits))

        grouped: Dict[FitConfig, Tuple[List[FleetMember], List[Tuple[_Plan, int]]]] = {}
        for fold_idx in range(max_folds):  # fold-major: the last fold's thresholds win
            for plan in plans:
                if self._skipped(plan.machine.name) or fold_idx >= len(per_plan_folds[plan.machine.name]):
                    continue
                train_idx, _ = per_plan_folds[plan.machine.name][fold_idx]
                try:
                    member = self._make_member(
                        plan, _window_train_weights(plan, train_idx), seed=plan.seed + 1000 * (fold_idx + 1),
                        name=_fold_member_name(plan.machine.name, fold_idx),
                    )
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                members, items = grouped.setdefault(plan.fit_config, ([], []))
                members.append(member)
                items.append((plan, fold_idx))
        for config, (members, items) in grouped.items():
            for chunk_members, chunk_items in _chunk_by_bytes(members, items, _cv_chunk_bytes()):
                self._train_and_score_folds(chunk_members, chunk_items, config, per_plan_folds, fold_state)

        with self._phase("cv_finalize"):
            for plan in plans:
                if self._skipped(plan.machine.name):
                    continue
                try:
                    self._finalize_cv(plan, fold_state[plan.machine.name])
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                plan.cv_duration = time.perf_counter() - start

    @staticmethod
    def _make_member(plan: _Plan, train_weights: Optional[np.ndarray], seed: int, name: str):
        """A training member, in the detector's shuffled sample order if
        any; an LSTM's is its series, the shuffle its window order."""
        perm = plan.shuffle_perm
        if plan.windowed:
            if perm is not None and train_weights is not None:
                train_weights = train_weights[perm]
            return WindowedFleetMember(name=name, spec=plan.spec, series=plan.X_arr, targets=plan.targets,
                                       order=perm, train_weights=train_weights, seed=seed)
        if perm is None:
            X, y = plan.X_arr, plan.y_arr
        else:
            if plan.shuffled is None:
                X = plan.X_arr[perm]
                plan.shuffled = (X, X if plan.y_arr is plan.X_arr else plan.y_arr[perm])
            X, y = plan.shuffled
            if train_weights is not None:
                train_weights = train_weights[perm]
        return FleetMember(name=name, spec=plan.spec, X=X, y=y, train_weights=train_weights, seed=seed)

    def _train_and_score_folds(self, members, items, config, per_plan_folds, fold_state) -> None:
        """Train one chunk of fold members and score it. The trainer
        bisects device errors itself; a chunk whose ``train`` raises (a
        host error, such as one member's bad data) is halved and retried,
        down to one member, so one bad machine fails alone."""
        live = [i for i, (plan, _) in enumerate(items) if not self._skipped(plan.machine.name)]
        members, items = [members[i] for i in live], [items[i] for i in live]
        if not members:
            return
        try:
            with self._phase("cv_train"):
                results = self.trainer.train(members, config)
        except Exception as exc:
            if len(members) > 1:
                logger.warning("CV chunk of %d fold-members failed (%s); splitting", len(members), exc)
                self.robustness["bucket_bisects"] += 1
                for plan, _ in items:
                    plan.bucket_bisects += 1
                mid = len(members) // 2
                self._train_and_score_folds(members[:mid], items[:mid], config, per_plan_folds, fold_state)
                self._train_and_score_folds(members[mid:], items[mid:], config, per_plan_folds, fold_state)
                return
            self._fail(items[0][0].machine.name, exc)
            return
        scorable_items, scorable_results = [], []
        for (plan, fold_idx), result in zip(items, results):
            if result.error is not None:
                self._fail(plan.machine.name, result.error)
        for (plan, fold_idx), result in zip(items, results):
            if self._skipped(plan.machine.name):
                continue
            plan.fleet_retries += result.retries
            self.robustness["fleet_retries"] += result.retries
            scorable_items.append((plan, fold_idx))
            scorable_results.append(result)
        if not scorable_items:
            return
        try:
            self._score_folds(scorable_items, scorable_results, per_plan_folds, fold_state)
        except Exception as exc:
            for plan, _ in scorable_items:
                self._fail(plan.machine.name, exc)

    def _score_folds(self, items, results, per_plan_folds, fold_state) -> None:
        """Score trained fold models: one forward per (spec, width) group,
        every fold of every machine of the group at once (one K1 launch on
        a card; one windowed forward for an LSTM group), each fold on its
        test windows, against the rows they target."""
        by_name = {r.name: r for r in results}
        groups: Dict[Tuple, List[Tuple[_Plan, int]]] = {}
        for plan, fold_idx in items:
            groups.setdefault((plan.spec, plan.X_arr.shape[1:]), []).append((plan, fold_idx))
        for (spec, _), group in groups.items():
            stacked = stack_member_params(
                [by_name[_fold_member_name(p.machine.name, k)].params for p, k in group]
            )
            fold_rows = []  # per item: (train rows, test windows, the rows they target)
            for plan, fold_idx in group:
                train_rows, test_rows = per_plan_folds[plan.machine.name][fold_idx]
                fold_rows.append((train_rows, *_test_window_rows(plan, test_rows)))
            with self._phase("cv_predict"):
                n_max = max(len(windows) for _, windows, _ in fold_rows)
                width = group[0][0].X_arr.shape[1:]
                if group[0][0].windowed:
                    series = np.zeros((len(group), max(len(p.X_arr) for p, _ in group)) + width, np.float32)
                    order = np.zeros((len(group), n_max), np.int64)
                    for i, (plan, _) in enumerate(group):
                        series[i, : len(plan.X_arr)] = plan.X_arr
                        order[i, : len(fold_rows[i][1])] = fold_rows[i][1]
                    predictions = self.trainer.predict_windowed_bucket(
                        spec, stacked, series, order, batch_size=SCORING_BATCH)
                else:
                    X = np.zeros((len(group), n_max) + width, np.float32)
                    for i, (plan, _) in enumerate(group):
                        X[i, : len(fold_rows[i][1])] = plan.X_arr[fold_rows[i][1]]
                    predictions = self.trainer.predict_bucket(spec, stacked, X)
            with self._phase("cv_score"):
                for i, (plan, fold_idx) in enumerate(group):
                    train_rows, windows, test_rows = fold_rows[i]
                    y_true = plan.y_arr[test_rows]
                    y_pred = predictions[i, : len(windows)]
                    self._accumulate_metric_scores(plan, y_true, y_pred, fold_idx)
                    if plan.detector is not None:
                        self._accumulate_thresholds(
                            plan, y_true, y_pred, fold_idx, fold_state[plan.machine.name],
                            y_train=plan.y_arr[train_rows], test_rows=test_rows,
                        )

    @staticmethod
    def _scoring_setup(plan: _Plan):
        """The resolved metrics and the scoring scaler, fitted on the whole
        target frame (one fit serves every fold)."""
        if plan.scoring is None:
            evaluation = plan.machine.evaluation
            scaler_def = evaluation.get("scoring_scaler")
            scaler = None
            if scaler_def:
                scaler = serializer.from_definition(scaler_def, device="cpu").fit(plan.y_arr)
            plan.scoring = (metrics_from_list(evaluation.get("metrics")), scaler)
        return plan.scoring

    def _accumulate_metric_scores(self, plan: _Plan, y_true, y_pred, fold_idx: int) -> None:
        metrics, scaler = self._scoring_setup(plan)
        if scaler is not None:
            y_true, y_pred = scaler.transform(y_true), scaler.transform(y_pred)
        tags = plan.machine.target_tag_list
        fold_key = f"fold-{fold_idx + 1}"
        for metric in metrics:
            name = metric.__name__.replace("_", "-")
            per_tag = metric(y_true, y_pred)
            for i, tag in enumerate(tags):
                plan.cv_scores.setdefault(f"{name}-{tag.replace(' ', '-')}", {})[fold_key] = float(per_tag[i])
            plan.cv_scores.setdefault(name, {})[fold_key] = float(np.mean(per_tag))

    @staticmethod
    def _accumulate_thresholds(plan: _Plan, y_true, y_pred, fold_idx: int, state, y_train, test_rows) -> None:
        detector = plan.detector
        # the fold model's error scaler is fitted on the fold's train targets
        scaler = MinMaxScaler(feature_range=detector.scaler.feature_range).fit(y_train)
        scaled_mse = np.mean(np.square(scaler.transform(y_pred) - scaler.transform(y_true)), axis=1)
        abs_err = np.abs(y_true - y_pred)
        if isinstance(detector, DiffBasedKFCVAnomalyDetector):
            # KFold's test rows are scattered: keep each fold's errors with
            # their rows, to smooth them in row order once every fold is in
            state.setdefault("kfcv_parts", []).append((np.asarray(test_rows), scaled_mse, abs_err))
            return
        fold = f"fold-{fold_idx}"
        state["aggregate_threshold"] = _rolling_min_max(scaled_mse, 6)
        state.setdefault("feature_folds", {})[fold] = _rolling_min_max(abs_err, 6)
        state.setdefault("agg_folds", {})[fold] = state["aggregate_threshold"]
        if detector.window is not None:
            state["smooth_aggregate_threshold"] = _rolling_min_max(scaled_mse, detector.window)
            state["smooth_feature_thresholds"] = _rolling_min_max(abs_err, detector.window)
            state.setdefault("smooth_feature_folds", {})[fold] = state["smooth_feature_thresholds"]
            state.setdefault("smooth_agg_folds", {})[fold] = state["smooth_aggregate_threshold"]

    @staticmethod
    def _finalize_cv(plan: _Plan, state: Dict[str, Any]) -> None:
        """Fold statistics rows of every score; the detector's thresholds
        from the last fold, and per fold."""
        for folds in plan.cv_scores.values():
            values = np.array([v for k, v in folds.items() if k.startswith("fold-")])
            folds.update({
                "fold-mean": float(values.mean()),
                "fold-std": float(values.std()),
                "fold-max": float(values.max()),
                "fold-min": float(values.min()),
            })
        detector = plan.detector
        if isinstance(detector, DiffBasedKFCVAnomalyDetector) and "kfcv_parts" in state:
            n = len(plan.y_arr)
            mse_full = np.full(n, np.nan)
            abs_full = np.full((n, plan.y_arr.shape[1]), np.nan)
            for rows, mse_part, abs_part in state["kfcv_parts"]:
                mse_full[rows] = mse_part
                abs_full[rows] = abs_part
            detector.aggregate_threshold_ = float(detector.calculate_threshold(mse_full))
            detector.feature_thresholds_ = detector.calculate_threshold(abs_full)
            return
        if detector is None or "feature_folds" not in state:
            return
        tags = plan.machine.target_tag_list

        def per_fold(folds):  # DataFrame(folds).T.to_dict(): {tag: {fold: value}}
            return {tag: {fold: float(v[i]) for fold, v in folds.items()} for i, tag in enumerate(tags)}

        last = list(state["feature_folds"])[-1]
        detector.feature_thresholds_ = np.asarray(state["feature_folds"][last], np.float64)
        detector.aggregate_threshold_ = state["aggregate_threshold"]
        detector.feature_thresholds_per_fold_ = per_fold(state["feature_folds"])
        detector.aggregate_thresholds_per_fold_ = state["agg_folds"]
        detector.smooth_aggregate_threshold_ = state.get("smooth_aggregate_threshold")
        detector.smooth_feature_thresholds_ = state.get("smooth_feature_thresholds")
        if "smooth_feature_folds" in state:
            detector.smooth_feature_thresholds_per_fold_ = per_fold(state["smooth_feature_folds"])
            detector.smooth_aggregate_thresholds_per_fold_ = state["smooth_agg_folds"]

    # -------------------------------------------------------------- final fit

    def _run_final_fit(self, plans: List[_Plan]) -> None:
        start = time.perf_counter()
        by_config: Dict[FitConfig, List[_Plan]] = {}
        for plan in plans:
            by_config.setdefault(plan.fit_config, []).append(plan)
        for config, group in by_config.items():
            members = [self._make_member(p, None, seed=p.seed, name=p.machine.name) for p in group]
            self._train_final_group(members, group, config, start)

    def _train_final_group(self, members, plans, config, start) -> None:
        """Final-fit one config group. The trainer bisects device errors
        itself and returns a member that fails alone as its result's
        ``error``; what escapes ``train`` is a host error, and fails the
        group's machines."""
        try:
            with self._phase("final_fit"):
                results = self.trainer.train(members, config)
        except Exception as exc:
            for plan in plans:
                self._fail(plan.machine.name, exc)
            return
        for plan, result in zip(plans, results):
            if result.error is not None:
                self._fail(plan.machine.name, result.error)
                continue
            plan.fleet_retries += result.retries
            self.robustness["fleet_retries"] += result.retries
            estimator = plan.estimator
            estimator.spec_ = plan.spec
            estimator.params_ = params_from_jax(result.params, estimator.device)
            estimator._history = result.history
            plan.train_duration = time.perf_counter() - start
            plan.training_summary = TrainingSummaryMetadata.from_history(result.history)
            if plan.detector is not None:
                plan.detector.scaler.fit(plan.y)

    # --------------------------------------------------------------- assembly

    def _assemble(self, plan: _Plan) -> Tuple[Any, Machine]:
        machine = plan.machine.copy()
        model_obj = plan.model_obj
        meta_source = model_obj if plan.detector is not None else plan.estimator
        machine.metadata["build_metadata"] = {
            "model": {
                "model_offset": plan.offset,
                "model_creation_date": str(datetime.datetime.now(datetime.timezone.utc).astimezone()),
                "model_builder_version": __version__,
                "cross_validation": {
                    "scores": plan.cv_scores,
                    "cv_duration_sec": plan.cv_duration,
                    "splits": plan.cv_splits,
                },
                "model_training_duration_sec": plan.train_duration,
                "model_meta": meta_source.get_metadata(),
                "training": (plan.training_summary or TrainingSummaryMetadata()).to_dict(),
            },
            "dataset": {
                "query_duration_sec": plan.query_duration,
                "dataset_meta": plan.machine.dataset.get_metadata(),
            },
            "robustness": {
                "fleet_retries": plan.fleet_retries,
                "bucket_bisects": plan.bucket_bisects,
                "data_fetch_retries": plan.data_retries,
            },
            "drift_baseline": drift_baseline(plan.X, plan.machine.dataset.column_names()[0]),
        }
        return model_obj, machine

    @staticmethod
    def _split_metadata(plan: _Plan, splits) -> Dict[str, Any]:
        """First and last row of each fold's train and test split, as the
        index's ISO times (positions when the machine has no index)."""
        index = plan.index
        metadata = {}
        for i, (train, test) in enumerate(splits):
            for label, idx in (("train", train), ("test", test)):
                for endpoint, pos in (("start", idx[0]), ("end", idx[-1])):
                    value = index[pos] if index is not None else int(pos)
                    metadata[f"fold-{i + 1}-{label}-{endpoint}"] = (
                        value.isoformat() if hasattr(value, "isoformat") else value
                    )
        return metadata


def fleet_build(
    machines: Sequence[Machine],
    output_dir: Optional[str] = None,
    device: DeviceLike = None,
    random: Optional[RandomSource] = None,
) -> List[Tuple[Any, Machine]]:
    """Build the whole fleet on ``device`` (``cuda`` unless the caller asks
    for the CPU); see :class:`FleetBuilder`."""
    return FleetBuilder(machines, device=device, random=random).build(output_dir=output_dir)
