"""
The fleet trainer: many per-machine models as one stacked computation,
the dense half of ``gordo_tpu/parallel/fleet.py``.

1. **Bucketing.** Members are grouped by (spec, padded sample count), the
   naive strategy of the JAX planner (``planner/packing.py``); windowed
   (LSTM) members by (spec, padded series rows, model offset).
2. **Stacking.** Each bucket's data becomes ``X[M, n_padded, F]``
   (zero-filled), with weight masks for ragged lengths, validation
   splits and CV-fold boundaries; ``y`` is ``X`` itself when every
   member trains ``y is X`` (``fleet.py:664-724``).
3. **One program.** ``models/training.py::StackedFit`` trains the bucket
   with the member axis written out; each member draws its own init and
   permutations from its seed (``models/training.py::RandomSource``).

A :class:`WindowedFleetMember` (an LSTM machine) brings its raw series
and its window targets instead of samples: its bucket stacks
``series[M, n_padded, F]`` and ``targets[M, n_padded - offset, F_out]``
and trains through ``models/training.py::WindowedFit``, which gathers
each batch's windows on the device (``fleet.py:898-1026``, without the
mesh). :meth:`FleetTrainer.predict_windowed_bucket` forwards windows the
same way, 256 a batch (``:1108-1161``).

A diverged member (final loss not finite) is retrained with seed
``seed + 7919 * attempt`` (``fleet.py:476-531``). A bucket whose program
fails on the device is bisected until the failure is isolated to one
member, which then gets a :class:`FleetResult` with ``error`` set
(``fleet.py:612-662``); host errors raise.

:meth:`FleetTrainer.fit_single` trains one member as the JAX package's
sequential ``fit_single`` does (the estimators' ``fit``, so the
sequential ``ModelBuilder``): train rows padded to whole batches, not
to a power of two, validation apart.

:meth:`FleetTrainer.predict_bucket` forwards a whole bucket through
``ops/fleet_dense.py::fleet_feedforward``: K1 on a CUDA device, its
plain version because the tensors lie on the CPU otherwise.
"""

import logging
import re
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models.nn import forward_lstm_windows
from ..models.spec import FeedForwardSpec, LSTMSpec, ModelSpec
from ..models.training import (
    FitConfig,
    FitOutput,
    History,
    RandomSource,
    StackedFit,
    TorchRandom,
    WindowedFit,
    permutation_tensor,
)
from ..ops.fleet_dense import fleet_feedforward
from ..planner.packing import member_offset, naive_buckets
from ..utils.faults import InjectedDeviceError, fault_point

logger = logging.getLogger(__name__)

#: what a CUDA runtime failure says: torch's own errors and the fleet
#: kernel wrapper's launch error carry one of these
_DEVICE_ERROR = re.compile(r"CUDA|CUBLAS|CUDNN|fleet_dense kernel launch failed", re.IGNORECASE)


def is_device_error(exc: BaseException) -> bool:
    """True for failures raised by device work: out of memory, CUDA
    runtime errors and their injected stand-ins. Those are worth
    bisecting a bucket over; host errors are deterministic and are not.

    >>> is_device_error(RuntimeError("CUDA error: an illegal memory access"))
    True
    >>> is_device_error(ValueError("bad shape"))
    False
    """
    if isinstance(exc, (InjectedDeviceError, torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exc, RuntimeError) and bool(_DEVICE_ERROR.search(str(exc)))


def stack_member_params(
    members: Sequence[Mapping[str, Mapping[str, Any]]], device: Any = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Stack per-member parameter dicts (same keys and shapes) on a leading
    member axis: ``W[d_in, d_out] -> W[N, d_in, d_out]``. Leaves may be
    tensors or numpy arrays; the result is float32 on ``device`` (default:
    the first member's device).

    >>> p = {"out": {"W": torch.ones(2, 3), "b": torch.zeros(3)}}
    >>> tuple(stack_member_params([p, p])["out"]["W"].shape)
    (2, 2, 3)
    """
    if not members:
        raise ValueError("stack_member_params needs at least one member")
    first = members[0]
    stacked: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, layer in first.items():
        stacked[key] = {}
        for name in layer:
            leaves = [torch.as_tensor(m[key][name], dtype=torch.float32) for m in members]
            target = device if device is not None else leaves[0].device
            stacked[key][name] = torch.stack([t.to(target) for t in leaves])
    return stacked


@dataclass
class FleetMember:
    """One machine's (or one CV fold's) training problem, as arrays."""

    name: str
    spec: ModelSpec
    X: np.ndarray  # [n, n_features] (or LSTM windows [n, lookback, n_features])
    y: np.ndarray  # [n, n_features_out]; may be X itself
    train_weights: Optional[np.ndarray] = None  # defaults to all rows
    val_weights: Optional[np.ndarray] = None
    seed: int = 42

    def __post_init__(self):
        if len(self.X) != len(self.y):
            raise ValueError(f"{self.name}: X ({len(self.X)}) and y ({len(self.y)}) lengths differ")

    @property
    def n(self) -> int:
        return len(self.X)


@dataclass
class WindowedFleetMember:
    """One windowed (LSTM) machine's training problem: its raw series and
    window targets (``ops.windows.window_targets``); the windows are
    gathered on the device batch by batch."""

    name: str
    spec: LSTMSpec
    series: np.ndarray  # [n, n_features]
    targets: np.ndarray  # [n_windows, n_features_out]
    order: Optional[np.ndarray] = None  # virtual slot -> window start; None: in order
    train_weights: Optional[np.ndarray] = None  # per virtual slot
    val_weights: Optional[np.ndarray] = None
    seed: int = 42

    def __post_init__(self):
        # the window count, not the series length: a lookahead shortens it too
        if len(self.targets) < 1:
            raise ValueError(
                f"{self.name}: series of {len(self.series)} rows too short "
                f"for lookback {self.spec.lookback_window} (no complete windows)"
            )

    @property
    def n_windows(self) -> int:
        return len(self.targets)


@dataclass
class FleetResult:
    name: str
    params: Any  # host numpy params (None when ``error`` is set)
    history: History
    seed: int = 0  # the seed this member trained with
    retries: int = 0  # diverged-member reseeds that led to this result
    #: the device failure this member met in isolation after bisection;
    #: it trained nothing, and the caller decides what follows
    error: Optional[BaseException] = None


def _fill_weight_row(wtr, wval, i, n, member, config: FitConfig):
    """One member's train/val masks: explicit weights, or the Keras-style
    tail validation split over its ``n`` samples."""
    if member.train_weights is not None:
        wtr[i, : len(member.train_weights)] = member.train_weights
    else:
        n_val = int(n * config.validation_split)
        wtr[i, : n - n_val] = 1.0
        if n_val:
            wval[i, n - n_val : n] = 1.0
    if member.val_weights is not None:
        wval[i, : len(member.val_weights)] = member.val_weights


class FleetTrainer:
    """
    Trains buckets of same-spec members as one stacked program each, on
    ``device`` (``cuda`` unless the caller asks for the CPU), drawing
    every member's init and permutations from ``random`` (default
    :class:`~gordo_tpu_torch.models.training.TorchRandom`).

    ``fits`` records each bucket it trained: members, padded rows (window
    slots for a windowed bucket), optimizer steps run, host seconds of the fit loop (ending in the results'
    copy to the host) and, on a card, the CUDA-event milliseconds between
    the loop's first and last launch.
    """

    def __init__(self, device: DeviceLike = None, random: Optional[RandomSource] = None):
        self.device = resolve_device(device)
        self.random = random if random is not None else TorchRandom()
        #: lifetime count of bucket bisections after device errors
        self.bucket_bisects = 0
        #: member name -> bisections its bucket rode through
        self.bisect_counts: Dict[str, int] = {}
        self.fits: List[Dict[str, Any]] = []

    def train(
        self, members: Sequence[FleetMember], config: FitConfig, retry_failed: int = 1
    ) -> List[FleetResult]:
        """
        Train every member (bucketed by spec and pad target); one
        :class:`FleetResult` per member, in input order. Members whose
        final loss is not finite are retrained with a new seed, up to
        ``retry_failed`` times. A member whose bucket failed on the device
        in isolation gets ``params=None`` and the exception in ``error``;
        host exceptions raise for the whole call.
        """
        results = self._train_once(members, config)
        for attempt in range(1, retry_failed + 1):
            failed = [
                i for i, r in enumerate(results)
                if r.history.history["loss"] and not np.isfinite(r.history.history["loss"][-1])
            ]
            if not failed:
                break
            logger.warning(
                "Fleet retry %d: %d member(s) diverged (%s); reseeding",
                attempt, len(failed), ", ".join(results[i].name for i in failed[:5]),
            )
            retried = self._train_once(
                [replace(members[i], seed=members[i].seed + 7919 * attempt) for i in failed], config
            )
            for i, result in zip(failed, retried):
                result.retries = attempt
                result.history.params["fleet_retry"] = {"retries": attempt, "seed": result.seed}
                results[i] = result
        return results

    def _train_once(self, members: Sequence[FleetMember], config: FitConfig) -> List[FleetResult]:
        by_name: Dict[str, FleetResult] = {}
        failures: Dict[str, BaseException] = {}
        for planned in naive_buckets(members, config.batch_size):
            logger.info(
                "Fleet bucket: %d models, spec=%s, padded_n=%d%s",
                len(planned.members), type(planned.spec).__name__, planned.n_padded,
                f", windowed, offset {planned.offset}" if planned.windowed else "",
            )
            train = self._train_windowed_bucket if planned.windowed else self._train_bucket
            self._run_bucket_degraded(
                lambda b, _p=planned, _t=train: _t(_p.spec, _p.n_padded, b, config),
                planned.members, by_name, failures,
            )
        for member in members:
            if member.name in failures:
                by_name[member.name] = FleetResult(
                    name=member.name,
                    params=None,
                    history=History(history={"loss": []}, params={}, epoch=[]),
                    seed=member.seed,
                    error=failures[member.name],
                )
        return [by_name[m.name] for m in members]

    def _run_bucket_degraded(self, run, bucket, by_name, failures) -> None:
        """Run one bucket; on a device error bisect it and retry each half,
        down to a single member whose failure lands in ``failures``."""
        try:
            for member in bucket:
                fault_point("device_program", member.name)
            results = run(bucket)
        except Exception as exc:
            if not is_device_error(exc):
                raise
            if len(bucket) == 1:
                logger.error("Device program failed for member %s in isolation: %r", bucket[0].name, exc)
                failures[bucket[0].name] = exc
                return
            mid = len(bucket) // 2
            self.bucket_bisects += 1
            for member in bucket:
                self.bisect_counts[member.name] = self.bisect_counts.get(member.name, 0) + 1
            logger.warning(
                "Device program failed for bucket of %d members (%s); bisecting into %d + %d",
                len(bucket), exc, mid, len(bucket) - mid,
            )
            self._run_bucket_degraded(run, bucket[:mid], by_name, failures)
            self._run_bucket_degraded(run, bucket[mid:], by_name, failures)
            return
        for result in results:
            by_name[result.name] = result

    def fit_single(self, member, config: FitConfig) -> FleetResult:
        """
        Train one member as the JAX package's sequential fit does
        (``gordo_tpu/models/training.py::fit_single``, ``:692-775``, the fit
        of ``JaxAutoEncoder`` and of an LSTM estimator over its windows): the
        last ``int(n * validation_split)`` samples validate, the batch is at
        most the train samples, the train samples are padded to whole
        batches with the last one repeated at weight 0, and each epoch
        permutes those padded samples alone. A fleet bucket pads to a power
        of two instead and so sees other batches. Device errors raise.
        """
        windowed = isinstance(member, WindowedFleetMember)
        n = member.n_windows if windowed else member.n
        n_val = int(n * config.validation_split)
        n_tr = n - n_val
        config = replace(config, batch_size=min(config.batch_size, max(1, n_tr)))
        B = config.batch_size
        total = max(1, -(-n_tr // B)) * B
        pad_rows = np.full(total - n_tr, n_tr - 1)
        wtr = np.zeros((1, total), np.float32)
        wtr[0, :n_tr] = 1.0
        if windowed:
            if config.shuffle:
                raise ValueError("a windowed fit never shuffles")
            # validation slots after the train slots, rounded up to a whole batch
            val_slots = -(-n_val // B) * B
            order = np.concatenate([np.arange(n_tr), pad_rows, np.arange(n_tr, n), np.zeros(val_slots - n_val, int)])
            wtr = np.concatenate([wtr, np.zeros((1, val_slots), np.float32)], axis=1)
            wval = np.zeros_like(wtr)
            wval[0, total: total + n_val] = 1.0
            fit = WindowedFit(member.spec, config)
            data = [torch.from_numpy(a[None]).to(self.device) for a in (member.series, member.targets, order)]
            val = None
        else:
            rows = np.concatenate([np.arange(n_tr), pad_rows])
            X_tr = torch.from_numpy(member.X[rows][None]).to(self.device)
            y_tr = X_tr if member.y is member.X else torch.from_numpy(member.y[rows][None]).to(self.device)
            X_val = torch.from_numpy(member.X[n_tr:][None]).to(self.device)
            y_val = X_val if member.y is member.X else torch.from_numpy(member.y[n_tr:][None]).to(self.device)
            wval = np.ones((1, n_val), np.float32)
            fit, data, val = StackedFit(member.spec, config), [X_tr, y_tr], (X_val, y_val)
        params = stack_member_params([self.random.init_params(member.spec, member.seed)], self.device)
        perms = (permutation_tensor(self.random, [member.seed], config.epochs, total, self.device)
                 if config.shuffle else None)
        wtr_dev, wval_dev = torch.from_numpy(wtr).to(self.device), torch.from_numpy(wval).to(self.device)
        out = fit.run(params, *data, wtr_dev, wval_dev, perms, **({} if val is None else {"val": val}))
        return self._collect_results([member], out, config, total // B)[0]

    def _stack_bucket(self, n_padded: int, bucket: List[FleetMember], config: FitConfig):
        """``(X, y, wtr, wval)`` tensors on the trainer's device: zero-filled
        padding, ``y`` aliased to ``X`` when every member trains ``y is X``."""

        def stacked(arrays):
            out = np.zeros((len(arrays), n_padded) + np.shape(arrays[0])[1:], np.float32)
            for i, a in enumerate(arrays):
                out[i, : len(a)] = a
            return out

        X = stacked([m.X for m in bucket])
        y = X if all(m.y is m.X for m in bucket) else stacked([m.y for m in bucket])
        wtr = np.zeros((len(bucket), n_padded), np.float32)
        wval = np.zeros((len(bucket), n_padded), np.float32)
        for i, member in enumerate(bucket):
            _fill_weight_row(wtr, wval, i, member.n, member, config)
        X_dev = torch.from_numpy(X).to(self.device)
        y_dev = X_dev if y is X else torch.from_numpy(y).to(self.device)
        return X_dev, y_dev, torch.from_numpy(wtr).to(self.device), torch.from_numpy(wval).to(self.device)

    def _train_bucket(
        self, spec: FeedForwardSpec, n_padded: int, bucket: List[FleetMember], config: FitConfig
    ) -> List[FleetResult]:
        X, y, wtr, wval = self._stack_bucket(n_padded, bucket, config)
        return self._fit_bucket(bucket, config, StackedFit(spec, config), (X, y), wtr, wval)

    def _stack_windowed_bucket(
        self, spec: LSTMSpec, n_padded: int, bucket: List[WindowedFleetMember], config: FitConfig
    ):
        """``(series, targets, order, wtr, wval)`` tensors on the trainer's
        device: ``n_padded`` series rows, ``n_padded - offset`` target
        rows, and the virtual slots rounded up to whole batches."""
        nw_padded = n_padded - member_offset(bucket[0])
        B = config.batch_size
        nv_padded = -(-nw_padded // B) * B
        M = len(bucket)
        series = np.zeros((M, n_padded, bucket[0].series.shape[1]), np.float32)
        targets = np.zeros((M, nw_padded, bucket[0].targets.shape[1]), np.float32)
        order = np.zeros((M, nv_padded), np.int64)
        wtr = np.zeros((M, nv_padded), np.float32)
        wval = np.zeros((M, nv_padded), np.float32)
        for i, member in enumerate(bucket):
            nv = member.n_windows
            series[i, : len(member.series)] = member.series
            targets[i, :nv] = member.targets
            order[i, :nv] = member.order if member.order is not None else np.arange(nv)
            _fill_weight_row(wtr, wval, i, nv, member, config)
        return tuple(torch.from_numpy(a).to(self.device) for a in (series, targets, order, wtr, wval))

    def _train_windowed_bucket(
        self, spec: LSTMSpec, n_padded: int, bucket: List[WindowedFleetMember], config: FitConfig
    ) -> List[FleetResult]:
        series, targets, order, wtr, wval = self._stack_windowed_bucket(spec, n_padded, bucket, config)
        return self._fit_bucket(bucket, config, WindowedFit(spec, config), (series, targets, order), wtr, wval)

    def _fit_bucket(self, bucket, config: FitConfig, fit: StackedFit, data, wtr, wval) -> List[FleetResult]:
        """Draw the bucket's init and permutations, run ``fit`` on ``data``
        and the weights, time it into ``fits`` and collect the results."""
        seeds = [m.seed for m in bucket]
        params = stack_member_params([self.random.init_params(fit.spec, s) for s in seeds], self.device)
        n = wtr.shape[1]
        perms = permutation_tensor(self.random, seeds, config.epochs, n, self.device) if config.shuffle else None
        steps = n // config.batch_size
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        out = fit.run(params, *data, wtr, wval, perms)
        if on_card:
            events[1].record()
        results = self._collect_results(bucket, out, config, steps)
        self.fits.append(dict(
            members=len(bucket), rows=n, steps=out.steps,
            seconds=time.perf_counter() - t0,
            event_ms=events[0].elapsed_time(events[1]) if on_card else None,
            windowed=isinstance(fit, WindowedFit),
        ))
        return results

    @staticmethod
    def _collect_results(bucket, out: FitOutput, config: FitConfig, steps: int) -> List[FleetResult]:
        host = {key: {name: t.cpu().numpy() for name, t in layer.items()} for key, layer in out.params.items()}
        losses = out.losses.cpu().numpy()
        val_losses = out.val_losses.cpu().numpy()
        epochs_ran = out.epochs_ran.cpu().numpy()
        results = []
        for i, member in enumerate(bucket):
            ran = int(epochs_ran[i])
            history = {"loss": [float(v) for v in losses[i][:ran]]}
            member_val = val_losses[i][:ran]
            # NaN marks a member without validation rows: no val_loss history
            if ran and not np.all(np.isnan(member_val)):
                history["val_loss"] = [float(v) for v in member_val]
            results.append(FleetResult(
                name=member.name,
                seed=member.seed,
                params={key: {name: a[i].copy() for name, a in layer.items()} for key, layer in host.items()},
                history=History(
                    history=history,
                    params={"epochs": config.epochs, "steps": steps, "verbose": 0, "metrics": list(history)},
                    epoch=list(range(ran)),
                ),
            ))
        return results

    def predict_bucket(
        self, spec: FeedForwardSpec, stacked_params: Mapping[str, Mapping[str, Any]], X: np.ndarray
    ) -> np.ndarray:
        """Forward a whole bucket, ``X[M, N, F] -> [M, N, F_out]`` (float32
        numpy), member ``i`` of ``stacked_params`` on ``X[i]``: one K1
        launch on a CUDA device."""
        stacked = {
            key: {name: torch.as_tensor(leaf, dtype=torch.float32).to(self.device) for name, leaf in layer.items()}
            for key, layer in stacked_params.items()
        }
        x = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(self.device)
        return fleet_feedforward(spec, stacked, x).cpu().numpy()

    def predict_windowed_bucket(
        self,
        spec: LSTMSpec,
        stacked_params: Mapping[str, Mapping[str, Any]],
        series: np.ndarray,
        order: np.ndarray,
        batch_size: int = 256,
    ) -> np.ndarray:
        """Forward a windowed bucket, ``series[M, n, F]`` and window starts
        ``order[M, nv]`` -> ``[M, nv, F_out]`` (float32 numpy), the windows
        gathered on the device ``batch_size`` at a time."""
        stacked = {
            key: {name: torch.as_tensor(leaf, dtype=torch.float32).to(self.device) for name, leaf in layer.items()}
            for key, layer in stacked_params.items()
        }
        s = torch.from_numpy(np.ascontiguousarray(series, np.float32)).to(self.device)
        o = torch.from_numpy(np.asarray(order, np.int64)).to(self.device)
        return forward_lstm_windows(spec, stacked, s, o, batch_size).cpu().numpy()
