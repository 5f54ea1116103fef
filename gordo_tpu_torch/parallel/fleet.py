"""
The fleet trainer: many per-machine models as one stacked computation,
the dense half of ``gordo_tpu/parallel/fleet.py``.

1. **Bucketing.** Members are grouped by (spec, padded sample count), the
   naive strategy of the JAX planner (``planner/packing.py``).
2. **Stacking.** Each bucket's data becomes ``X[M, n_padded, F]``
   (zero-filled), with weight masks for ragged lengths, validation
   splits and CV-fold boundaries; ``y`` is ``X`` itself when every
   member trains ``y is X`` (``fleet.py:664-724``).
3. **One program.** ``models/training.py::StackedFit`` trains the bucket
   with the member axis written out; each member draws its own init and
   permutations from its seed (``models/training.py::RandomSource``).

A diverged member (final loss not finite) is retrained with seed
``seed + 7919 * attempt`` (``fleet.py:476-531``). A bucket whose program
fails on the device is bisected until the failure is isolated to one
member, which then gets a :class:`FleetResult` with ``error`` set
(``fleet.py:612-662``); host errors raise.

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
from ..models.spec import FeedForwardSpec
from ..models.training import (
    FitConfig,
    FitOutput,
    History,
    RandomSource,
    StackedFit,
    TorchRandom,
    permutation_tensor,
)
from ..ops.fleet_dense import fleet_feedforward
from ..planner.packing import naive_buckets
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
    spec: FeedForwardSpec
    X: np.ndarray  # [n, n_features]
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

    ``fits`` records each bucket it trained: members, padded rows,
    optimizer steps, host seconds of the fit loop (ending in the results'
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
                "Fleet bucket: %d models, spec=%s, padded_n=%d",
                len(planned.members), type(planned.spec).__name__, planned.n_padded,
            )
            self._run_bucket_degraded(
                lambda b, _p=planned: self._train_bucket(_p.spec, _p.n_padded, b, config),
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
        seeds = [m.seed for m in bucket]
        params = stack_member_params([self.random.init_params(spec, s) for s in seeds], self.device)
        perms = (
            permutation_tensor(self.random, seeds, config.epochs, n_padded, self.device)
            if config.shuffle else None
        )
        steps = n_padded // config.batch_size
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        out = StackedFit(spec, config).run(params, X, y, wtr, wval, perms)
        if on_card:
            events[1].record()
        results = self._collect_results(bucket, out, config, steps)
        self.fits.append(dict(
            members=len(bucket), rows=n_padded, steps=config.epochs * steps,
            seconds=time.perf_counter() - t0,
            event_ms=events[0].elapsed_time(events[1]) if on_card else None,
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
