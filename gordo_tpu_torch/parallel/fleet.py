"""
The fleet trainer: many per-machine models as one stacked computation,
the dense half of ``gordo_tpu/parallel/fleet.py``.

1. **Bucketing.** ``planner.plan_train_buckets`` groups the members by
   the trainer's strategy (``naive`` or ``packed``, ``planner/packing.py``)
   and its cost table; a ``fleet_plan`` replays its buckets for the
   members it covers (``fleet.py:533-610``).
2. **Stacking.** Each bucket's data becomes ``X[M, n_padded, F]``
   (zero-filled), with weight masks for ragged lengths, validation
   splits and CV-fold boundaries; ``y`` is ``X`` itself when every
   member trains ``y is X`` (``fleet.py:664-724``).
3. **One program.** ``models/training.py::StackedFit`` trains the bucket
   with the member axis written out; each member draws its own init and
   permutations from its seed (``models/training.py::RandomSource``).
   With ``packing`` (``"auto"`` or a factor), a feedforward bucket without
   early stopping and without a planned member rung trains packed
   (``models/packing.py::PackedFit``, ``fleet.py:445-463``, ``:758-883``):
   its consecutive members form packs of G, each pack shuffling with its
   first member's permutations and sharing Adam's step count, in the same
   stacked program. The JAX trainer pads a bucket's member axis up to the
   plan's ``m_padded`` so that sibling buckets share one XLA compile; a
   PyTorch program has no compile to share, so the port launches the
   live members only (the plan still records JAX's stacked shape).

A :class:`WindowedFleetMember` (an LSTM machine) brings its raw series
and its window targets instead of samples: its bucket stacks
``series[M, n_padded, F]`` and ``targets[M, n_padded - offset, F_out]``
and trains through ``models/training.py::WindowedFit``, which gathers
each batch's windows on the device (``fleet.py:898-1026``, without the
mesh). :meth:`FleetTrainer.predict_windowed_bucket` forwards windows the
same way, 256 a batch (``:1108-1161``). With ``GORDO_TPU_LSTM_SEGMENTED=N``
a windowed bucket whose members train in order, without their own order
or weights, under a batch N divides, trains through
``models/training.py::SegmentedFit`` instead (``fleet.py:954-1030``),
silently falling back to the windowed fit otherwise, as in JAX.

**The mesh** (``parallel/mesh.py``; ``fleet.py:665-735``, ``:775-830``,
``:1072-1106``). Over a ``(models, data)`` mesh of ranks, each bucket's
member axis is cut into the model axis's blocks (whole packs for a packed
bucket; the padding to a multiple of the axis is JAX's zero-weight dummies,
which the port leaves out as it leaves out ``m_padded``), and each rank
stacks and trains only its own block. The sample axis is rounded to
``lcm(batch_size, data)`` (``:682-689``, ``:780-787``); the ranks of a data
group hold the same block and each computes its share of every batch's
rows (``models/training.py``: ``StackedFit.data``), summing the gradients
as one flat buffer a step, so every rank applies the same Adam update.
Each bucket's results (or its failure) are then gathered to every rank as
host values, as ``fetch_to_host``'s ``process_allgather`` does
(``:221-240``), so every rank goes on with the same results, retries and
bisections: a device error on any rank bisects the bucket on all of them.
:meth:`FleetTrainer.predict_bucket` and
:meth:`FleetTrainer.predict_windowed_bucket` score each rank's member
block on its own device (K1 on a card) and gather the predictions. The
cost model takes the mesh's shape, so a ``fleet_plan.json`` is JAX's on a
mesh of the same shape.

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

Each bucket fit (``fleet_fit``, ``fleet_packed_fit`` with ``packed=G``,
``fleet_windowed_fit``, ``fleet_segmented_fit``) and each forward
(``fleet_predict``, ``fleet_windowed_predict``) runs inside a
``device_program`` span of the active recorder (``telemetry/recorder.py``,
the JAX sites ``fleet.py:739``, ``:1015``, ``:1096``, ``:1147``) with the
JAX attributes: members, shape, spec, bytes and the cost model's
features. The span closes after the results' copy to the host, which
waits for the card, so it times the device work and adds no
synchronisation (the JAX trainer blocks on its outputs for that, only
while a recorder is active).
"""

import logging
import re
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike
from ..models.callbacks import Callback
from ..models.nn import forward_lstm_windows
from ..models.spec import FeedForwardSpec, LSTMSpec, ModelSpec
from ..models.training import (
    FitConfig,
    FitOutput,
    History,
    RandomSource,
    SegmentedFit,
    StackedFit,
    TorchRandom,
    WindowedFit,
    permutation_tensor,
    segmented_config,
)
from ..ops.fleet_dense import fleet_feedforward
from ..models.packing import PackedFeedForwardSpec, PackedFit, auto_packing
from ..ops.losses import resolve_loss
from ..planner.costmodel import CostModel, CostTable, spec_flops_per_sample, spec_param_count
from ..planner.packing import member_offset, plan_train_buckets
from ..telemetry import program_span
from ..utils.faults import InjectedDeviceError, fault_point
from .mesh import DataShard, Mesh, make_mesh, model_data_sharding, model_sharding

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
    if isinstance(exc, (InjectedDeviceError, torch.cuda.OutOfMemoryError, RankDeviceError)):
        return True
    return isinstance(exc, RuntimeError) and bool(_DEVICE_ERROR.search(str(exc)))


class RankDeviceError(RuntimeError):
    """Another rank's device program failed on its block of the bucket:
    every rank bisects the bucket alike."""


class RankError(RuntimeError):
    """Another rank failed its block of the bucket with a host error: every
    rank fails alike."""


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


def _bucket_nbytes(bucket) -> int:
    """The members' raw staged bytes (a span attribute)."""
    total = 0
    for member in bucket:
        if isinstance(member, WindowedFleetMember):
            total += member.series.nbytes + member.targets.nbytes
        else:
            total += member.X.nbytes + (0 if member.y is member.X else member.y.nbytes)
    return total


def _calibration_attrs(spec: ModelSpec, config: FitConfig, stacked_members: int, stacked_samples: int):
    """The cost model's features on a fit's span, as the JAX trainer
    records them for calibration."""
    return dict(
        params=spec_param_count(spec),
        flops_per_sample=spec_flops_per_sample(spec),
        stacked_members=int(stacked_members),
        stacked_samples=int(stacked_samples),
        epochs=config.epochs,
    )


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

    ``packing`` (None or 1: off, an int, or ``"auto"``) packs feedforward
    buckets (``models/packing.py``); ``plan_strategy`` (None: the
    ``GORDO_TPU_PLAN_STRATEGY`` default) and ``cost_table`` (None: the
    analytic one) plan the buckets, and ``fleet_plan`` is a
    ``planner.FleetPlan`` to replay.

    ``mesh`` (``parallel/mesh.py``; default :func:`~.mesh.make_mesh`, the
    process group's ranks on the model axis, or the one-device mesh) shards
    each bucket over ranks (the module's docstring); the trainer's device
    is then the mesh's. ``device`` names it when no mesh is given.

    ``fits`` records each bucket it trained: its id (the id
    ``fleet_plan.json`` gives it), the members' names and count, padded
    rows (window slots for a windowed bucket), the packing factor, the
    planned member rung (``m_padded``; None for a bisected half, which
    drops it), optimizer steps run, host seconds of the fit loop (ending
    in the results' copy to the host) and, on a card, the CUDA-event
    milliseconds between the loop's first and last launch, whether the
    bucket is windowed and the segments an update of a segmented fit
    (None for any other).
    """

    def __init__(self, device: DeviceLike = None, random: Optional[RandomSource] = None, packing: Any = None,
                 plan_strategy: Optional[str] = None, cost_table: Optional[CostTable] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.device = self.mesh.device
        self.random = random if random is not None else TorchRandom()
        self.packing = packing
        self.plan_strategy = plan_strategy
        self.cost_table = cost_table
        #: a ``planner.FleetPlan`` to replay (``FleetBuilder`` sets it for
        #: a build): the members it covers train in its buckets
        self.fleet_plan: Any = None
        #: lifetime count of bucket bisections after device errors
        self.bucket_bisects = 0
        #: member name -> bisections its bucket rode through
        self.bisect_counts: Dict[str, int] = {}
        self.fits: List[Dict[str, Any]] = []

    def cost_model(self) -> CostModel:
        """The planner's cost model over this trainer's table and mesh shape."""
        return CostModel(self.cost_table, mesh_shape=self.mesh.shape)

    def _packing_factor(self, spec: ModelSpec, n_members: int, config: FitConfig) -> int:
        """The packing factor of a bucket (``fleet.py:445-463``): 1 unless
        packing is on, the spec is feedforward, no early stopping and the
        loss is known."""
        if not self.packing or self.packing == 1:
            return 1
        if not isinstance(spec, FeedForwardSpec) or config.early_stopping is not None:
            return 1
        try:
            resolve_loss(spec.loss)
        except ValueError:
            return 1
        if self.packing == "auto":
            return auto_packing(spec, n_members)
        return max(1, min(int(self.packing), n_members))

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
        planned_buckets = plan_train_buckets(members, config, strategy=self.plan_strategy,
                                             cost_model=self.cost_model(), plan=self.fleet_plan)
        for planned in planned_buckets:
            # sibling buckets of a split rung (a planned m_padded) are never block-packed
            g = 1 if planned.windowed or planned.m_padded is not None else self._packing_factor(
                planned.spec, len(planned.members), config)
            logger.info(
                "Fleet bucket %s: %d models, spec=%s, padded_n=%d%s%s",
                planned.bucket_id, len(planned.members), type(planned.spec).__name__, planned.n_padded,
                f", windowed, offset {planned.offset}" if planned.windowed else "", f", packed x{g}" if g > 1 else "",
            )

            def run(b, _p=planned, _g=g):
                # the planned member rung holds for the intact bucket only: a bisected half drops it
                m_padded = _p.m_padded if len(b) == len(_p.members) else None
                local = b[model_sharding(self.mesh, len(b), _g)]
                if not local:  # this rank's block is all padding
                    return []
                if _p.windowed:
                    return self._train_windowed_bucket(_p.spec, _p.n_padded, local, config, _p.bucket_id)
                if _g > 1:
                    return self._train_bucket_packed(_p.spec, _p.n_padded, local, config, _p.bucket_id, _g)
                return self._train_bucket(_p.spec, _p.n_padded, local, config, _p.bucket_id, m_padded)

            self._run_bucket_degraded(lambda b, _run=run: self._gathered(_run, b), planned.members, by_name,
                                      failures)
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

    def _gathered(self, run, bucket) -> List["FleetResult"]:
        """``run(bucket)`` on every rank (each trains its own block), the
        blocks' results gathered to every rank in member order; a failure on
        any rank raises on all: a host error anywhere as :class:`RankError`,
        else a device error as :class:`RankDeviceError`, so that every rank
        bisects or fails alike (a failed rank raises its own exception
        where it is of that kind)."""
        if not self.mesh.distributed:
            return run(bucket)
        try:
            outcome: Any = ("ok", run(bucket))
        except Exception as exc:  # noqa: BLE001 - every rank must reach the gather
            outcome, local_exc = ("device" if is_device_error(exc) else "host", repr(exc)), exc
        else:
            local_exc = None
        gathered = self.mesh.all_gather_object((self.mesh.coords, outcome))
        failed = [(coords, o) for coords, o in gathered if o[0] != "ok"]
        if failed:
            host = [(coords, o) for coords, o in failed if o[0] == "host"]
            if local_exc is not None and (not host or not is_device_error(local_exc)):
                raise local_exc
            coords, (_, text) = (host or failed)[0]
            cls = RankError if host else RankDeviceError
            raise cls(f"rank at mesh coordinates {coords} failed its block: {text}")
        by_name = {r.name: r for coords, (_, results) in gathered if coords[1] == 0 for r in results}
        return [by_name[m.name] for m in bucket]

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

    def fit_single(self, member, config: FitConfig, callbacks: Sequence[Callback] = ()) -> FleetResult:
        """
        Train one member as the JAX package's sequential fit does
        (``gordo_tpu/models/training.py::fit_single``, ``:692-775``, the fit
        of ``JaxAutoEncoder`` and of an LSTM estimator over its windows): the
        last ``int(n * validation_split)`` samples validate, the batch is at
        most the train samples, the train samples are padded to whole
        batches with the last one repeated at weight 0, and each epoch
        permutes those padded samples alone. A fleet bucket pads to a power
        of two instead and so sees other batches. Host ``callbacks`` run
        the epochs in the per-epoch host loop (``_fit_host_loop``), its
        permutations from the random source's ``host_loop_permutations``
        when it has one (JAX keys the host loop's epochs apart from the
        fused fit's). Device errors raise. A fit without callbacks is a
        ``device_program`` span ``fit_single`` with the JAX attributes.
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
        # the host loop draws each epoch's key apart in JAX: a source may say so
        source = self.random
        if callbacks and hasattr(source, "host_loop_permutations"):
            source = SimpleNamespace(permutations=source.host_loop_permutations)
        perms = (permutation_tensor(source, [member.seed], config.epochs, total, self.device)
                 if config.shuffle else None)
        wtr_dev, wval_dev = torch.from_numpy(wtr).to(self.device), torch.from_numpy(wval).to(self.device)

        def run() -> FleetResult:
            out = fit.run(params, *data, wtr_dev, wval_dev, perms, **({} if val is None else {"val": val}),
                          callbacks=callbacks)
            return self._collect_results([member], out, config, total // B)[0]

        if callbacks:  # the host loop is no one program: no span, as in JAX
            return run()
        # the JAX fit's padded train and validation arrays (an LSTM's as materialized windows)
        trailing = (member.spec.lookback_window, member.series.shape[1]) if windowed else tuple(member.X.shape[1:])
        tr_shape, val_shape = (total, *trailing), (n_val, *trailing)
        # closed after the results' copy to the host, which waits on the fit
        with program_span("fit_single", (member.spec, config, tr_shape, val_shape), shape=str(tr_shape),
                          spec=type(member.spec).__name__):
            return run()

    def _sample_step(self, config: FitConfig) -> int:
        """What the sample axis rounds up to: whole batches that also divide
        across the data axis (``fleet.py:682-689``)."""
        return int(np.lcm(config.batch_size, self.mesh.shape[1]))

    def _stack_bucket(self, n_padded: int, bucket: List[FleetMember], config: FitConfig):
        """``(X, y, wtr, wval)`` tensors on the trainer's device: zero-filled
        padding (the rows rounded up to :meth:`_sample_step`), ``y`` aliased
        to ``X`` when every member trains ``y is X``."""
        step = self._sample_step(config)
        n_padded = -(-n_padded // step) * step

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
        self, spec: FeedForwardSpec, n_padded: int, bucket: List[FleetMember], config: FitConfig, bucket_id: str,
        m_padded: Optional[int] = None,
    ) -> List[FleetResult]:
        X, y, wtr, wval = self._stack_bucket(n_padded, bucket, config)
        span = ("fleet_fit", (spec, config, tuple(X.shape)), dict(
            members=len(bucket), shape=str(tuple(X.shape)), spec=type(spec).__name__, bytes=_bucket_nbytes(bucket),
            **_calibration_attrs(spec, config, X.shape[0], X.shape[1])))
        return self._fit_bucket(bucket, config, StackedFit(spec, config), (X, y), wtr, wval, span, bucket_id,
                                m_padded=m_padded)

    def _train_bucket_packed(
        self, spec: FeedForwardSpec, n_padded: int, bucket: List[FleetMember], config: FitConfig, bucket_id: str,
        g: int,
    ) -> List[FleetResult]:
        """Train the bucket in packs of ``g`` consecutive members
        (``_train_bucket_packed``, ``fleet.py:758-883``): one stacked
        program of the live members, each pack shuffled by its first
        member's permutations; results per member, ``history.params``
        carrying ``packed``."""
        X, y, wtr, wval = self._stack_bucket(n_padded, bucket, config)
        span = ("fleet_packed_fit", (PackedFeedForwardSpec(spec, g), config, tuple(X.shape)), dict(
            members=len(bucket), packed=g, shape=str(tuple(X.shape)), spec=type(spec).__name__,
            bytes=_bucket_nbytes(bucket), **_calibration_attrs(spec, config, X.shape[0], X.shape[1])))
        perm_seeds = [bucket[(i // g) * g].seed for i in range(len(bucket))]
        return self._fit_bucket(bucket, config, PackedFit(spec, config, g), (X, y), wtr, wval, span, bucket_id,
                                perm_seeds=perm_seeds, packed=g)

    def _stack_windowed_bucket(
        self, spec: LSTMSpec, n_padded: int, bucket: List[WindowedFleetMember], config: FitConfig
    ):
        """``(series, targets, order, wtr, wval)`` tensors on the trainer's
        device: ``n_padded`` series rows, ``n_padded - offset`` target
        rows, and the virtual slots rounded up to :meth:`_sample_step`."""
        nw_padded = n_padded - member_offset(bucket[0])
        step = self._sample_step(config)
        nv_padded = -(-nw_padded // step) * step
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

    @staticmethod
    def _segmented_eligible(bucket: List[WindowedFleetMember], config: FitConfig) -> Optional[int]:
        """The segments an update when the opt-in segmented fit takes the
        bucket (``fleet.py:954-973``), else None: segments need the
        windows in order, so a shuffle, a member's own ``order`` or
        weights, or a batch the segments do not divide keep the windowed
        fit."""
        segments = segmented_config()
        if not segments or config.shuffle or config.batch_size % segments:
            return None
        if any(m.order is not None or m.train_weights is not None or m.val_weights is not None for m in bucket):
            return None
        return segments

    def _train_windowed_bucket(
        self, spec: LSTMSpec, n_padded: int, bucket: List[WindowedFleetMember], config: FitConfig, bucket_id: str
    ) -> List[FleetResult]:
        series, targets, order, wtr, wval = self._stack_windowed_bucket(spec, n_padded, bucket, config)
        attributes = dict(
            members=len(bucket), shape=str(tuple(series.shape)), spec=type(spec).__name__,
            bytes=_bucket_nbytes(bucket), **_calibration_attrs(spec, config, series.shape[0], order.shape[1]))
        segments = self._segmented_eligible(bucket, config)
        if segments is not None:
            logger.info("Segmented LSTM training: %d segments/update (L=%d)", segments, config.batch_size // segments)
            span = ("fleet_segmented_fit", (spec, config, segments, tuple(series.shape)), attributes)
            return self._fit_bucket(bucket, config, SegmentedFit(spec, config, segments), (series, targets), wtr, wval,
                                    span, bucket_id)
        span = ("fleet_windowed_fit", (spec, config, tuple(series.shape), tuple(order.shape)), attributes)
        return self._fit_bucket(bucket, config, WindowedFit(spec, config), (series, targets, order), wtr, wval, span,
                                bucket_id)

    def _fit_bucket(self, bucket, config: FitConfig, fit: StackedFit, data, wtr, wval, span, bucket_id: str,
                    perm_seeds: Optional[List[int]] = None, packed: int = 1,
                    m_padded: Optional[int] = None) -> List[FleetResult]:
        """Draw the bucket's init (each member's own) and permutations
        (from ``perm_seeds``, default each member's seed), run ``fit`` on
        ``data`` and the weights inside the ``span`` (program, key,
        attributes), time it into ``fits`` and collect the results."""
        seeds = [m.seed for m in bucket]
        fit.data = DataShard(self.mesh) if self.mesh.shape[1] > 1 else None
        params = stack_member_params([self.random.init_params(fit.spec, s) for s in seeds], self.device)
        n = wtr.shape[1]
        perms = permutation_tensor(self.random, seeds if perm_seeds is None else perm_seeds, config.epochs, n,
                                   self.device) if config.shuffle else None
        steps = n // config.batch_size
        on_card = self.device.type == "cuda"
        program, key, attributes = span
        t0 = time.perf_counter()
        with program_span(program, key, **attributes):
            if on_card:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                events[0].record()
            out = fit.run(params, *data, wtr, wval, perms)
            if on_card:
                events[1].record()
            results = self._collect_results(bucket, out, config, steps, packed)
        self.fits.append(dict(
            bucket=bucket_id, names=[m.name for m in bucket], members=len(bucket), rows=n, packed=packed,
            m_padded=m_padded, steps=out.steps,
            seconds=time.perf_counter() - t0,
            event_ms=events[0].elapsed_time(events[1]) if on_card else None,
            windowed=isinstance(fit, (WindowedFit, SegmentedFit)),
            segmented=getattr(fit, "segments", None),
        ))
        return results

    @staticmethod
    def _collect_results(bucket, out: FitOutput, config: FitConfig, steps: int, packed: int = 1) -> List[FleetResult]:
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
                    params={"epochs": config.epochs, "steps": steps, "verbose": 0, "metrics": list(history),
                            **({"packed": packed} if packed > 1 else {})},
                    epoch=list(range(ran)),
                ),
            ))
        return results

    def predict_bucket(
        self, spec: FeedForwardSpec, stacked_params: Mapping[str, Mapping[str, Any]], X: np.ndarray
    ) -> np.ndarray:
        """Forward a whole bucket, ``X[M, N, F] -> [M, N, F_out]`` (float32
        numpy), member ``i`` of ``stacked_params`` on ``X[i]``: one K1
        launch on a CUDA device. Over a mesh each rank forwards its block of
        members and rows (``fleet.py:1072-1106``) and every rank gets the
        whole prediction."""
        X = np.asarray(X)
        members, rows = model_data_sharding(self.mesh, X.shape[0], X.shape[1])
        stacked = {
            key: {name: torch.as_tensor(leaf[members], dtype=torch.float32).to(self.device)
                  for name, leaf in layer.items()}
            for key, layer in stacked_params.items()
        }
        x = torch.from_numpy(np.ascontiguousarray(X[members, rows], np.float32)).to(self.device)
        with program_span("fleet_predict", (spec, tuple(x.shape)), members=x.shape[0], shape=str(tuple(x.shape)),
                          spec=type(spec).__name__):
            out = fleet_feedforward(spec, stacked, x).cpu().numpy() if x.numel() else None
        return self._assemble(X.shape[:2], members, rows, out)

    def _assemble(self, shape, members: slice, rows: slice, out: Optional[np.ndarray]) -> np.ndarray:
        """The whole ``[M, N, F_out]`` prediction from every rank's block
        (``out`` this rank's, None when its block is empty)."""
        if not self.mesh.distributed:
            return out
        blocks = self.mesh.all_gather_object((members, rows, out))
        width = next(b[2].shape[-1] for b in blocks if b[2] is not None)
        whole = np.zeros(tuple(shape) + (width,), np.float32)
        for m, r, block in blocks:
            if block is not None:
                whole[m, r] = block
        return whole

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
        gathered on the device ``batch_size`` at a time. Over a mesh each
        rank forwards its block of members (``fleet.py:1108-1161``)."""
        members = model_sharding(self.mesh, len(series))
        every = slice(0, np.shape(order)[1])
        stacked = {
            key: {name: torch.as_tensor(leaf[members], dtype=torch.float32).to(self.device)
                  for name, leaf in layer.items()}
            for key, layer in stacked_params.items()
        }
        s = torch.from_numpy(np.ascontiguousarray(series[members], np.float32)).to(self.device)
        o = torch.from_numpy(np.asarray(order, np.int64)[members]).to(self.device)
        # the JAX key holds the window axis padded to whole batches
        nv_padded = -(-o.shape[1] // batch_size) * batch_size
        with program_span("fleet_windowed_predict", (spec, batch_size, tuple(s.shape), (o.shape[0], nv_padded)),
                          members=s.shape[0], shape=str(tuple(s.shape)), spec=type(spec).__name__):
            out = forward_lstm_windows(spec, stacked, s, o, batch_size).cpu().numpy() if len(s) else None
        if self.mesh.distributed and self.mesh.coords[1]:
            out = None  # the data group's first rank answers for its block
        return self._assemble((len(series), every.stop), members, every, out)
