"""
The fleet-resident model store: every served model of a revision loaded
once, with its params on the device, grouped into one stacked bucket per
spec so that a request scores through one kernel launch per bucket. The
store keeps the served revision and the revisions that requests pin,
least recently used first out.

A copy of the serving core of ``gordo_tpu/server/fleet_store.py``
(``RevisionFleet``, ``fleet_forward_gather``, ``FleetModelStore``) for f32
feedforward and LSTM autoencoders. There is no program cache: PyTorch runs eagerly and the
kernel takes every spec's widths as arguments. ``fleet_scores`` scores a
feedforward spec bucket with one K2 launch: the forward and each row's
error against its raw input rows, fused.

LSTM members join one bucket per ``LSTMSpec`` (an autoencoder and a
forecaster of one architecture share it: the lookahead is each member's
own). An LSTM bucket is scored by one windowed forward
(``models/nn.py::forward_lstm_windows``): each member's series is scaled
on the device, and its windows are gathered there 256 at a time
(``fleet_store.py:639-700``). Its output is ``lookback + lookahead - 1``
rows shorter than its input; the error is taken against the raw rows'
tail (``:554-560``), and a series shorter than one window is that
machine's error alone.

A bucket serves at a reduced precision too (``serve/precision.py``): its
bf16 cast or int8 quantization is made once from the f32 bucket, kept for
the bucket's membership, and forwarded by plain PyTorch, as the JAX
package forwards it with XLA rather than its Pallas kernel. The fleet
also keeps the precision gate's verdicts, stamped with the membership
they were taken at.

Each bucket also has a compiled ingest plan: the affine preprocessing of
every member's pipeline (``X * scale + offset``, stacked ``[N, F]`` on the
device), which the kernel applies to the raw request rows as a prologue
(``gordo_tpu/ingest/plan.py``). A bucket whose members have no
transformers at all has no plan and runs without the prologue (a member
without transformers in a mixed bucket gets the identity row). A bucket
with any member whose pipeline is not affine (an ``InfImputer``, a
``FunctionTransformer``, a clipping scaler) has no plan either and is
**host-transformed** (:meth:`RevisionFleet.host_transformed`): every
member's rows go through its own pipeline steps on the host, from the
request's float64 values to float32 (``_host_transform``,
``fleet_store.py:53-64``), before the same one K1 or K2 launch; K2 then
takes the transformed rows as X and the raw rows as y, the JAX store's
``mse_vs_raw`` rule (``:554-587``). Plans are all or nothing per bucket,
as in JAX, so a batch never mixes compiled and host-transformed rows.
"""

import logging
import os
import re
import threading
from collections import OrderedDict
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import serializer
from ..ingest import RawColumns, compiled_enabled, dlpack_enabled, to_device
from ..models.estimators import find_estimator
from ..models.nn import forward_lstm_windows
from ..models.spec import FeedForwardSpec, LSTMSpec, ModelSpec
from ..ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
from ..ops.windows import num_windows
from ..parallel.fleet import stack_member_params
from ..serve import precision as serve_precision
from ..utils.env import env_int

logger = logging.getLogger(__name__)

Stacked = Dict[str, Dict[str, torch.Tensor]]

#: pandas' fixed-frequency aliases, old and new spellings
_UNITS = {
    "d": "days", "D": "days",
    "h": "hours", "H": "hours",
    "min": "minutes", "T": "minutes",
    "s": "seconds", "S": "seconds",
    "ms": "milliseconds", "L": "milliseconds",
    "us": "microseconds", "U": "microseconds",
}
_RESOLUTION = re.compile(r"^\s*(\d*)\s*([A-Za-z]+)\s*$")


def parse_resolution(text: str) -> timedelta:
    """A dataset resolution such as ``10min`` or ``1H`` as a timedelta.

    >>> parse_resolution("10min"), parse_resolution("H")
    (datetime.timedelta(seconds=600), datetime.timedelta(seconds=3600))
    """
    match = _RESOLUTION.match(str(text))
    if not match or match.group(2) not in _UNITS:
        raise ValueError(f"Unsupported dataset resolution {text!r}")
    count = int(match.group(1) or 1)
    return timedelta(**{_UNITS[match.group(2)]: count})


def _tag_names(tags: Sequence[Any]) -> List[str]:
    """Tag entries of ``metadata.json`` (names, ``{"name": ...}`` dicts or
    ``[name, asset]`` pairs) as names."""
    names = []
    for tag in tags:
        if isinstance(tag, dict):
            names.append(str(tag["name"]))
        elif isinstance(tag, (list, tuple)):
            names.append(str(tag[0]))
        else:
            names.append(str(tag))
    return names


def _transformers(model: Any) -> List[Any]:
    """The transformer steps ahead of the estimator."""
    obj = getattr(model, "base_estimator", model)
    return list(getattr(obj, "transformers", ()))


class ModelResolution:
    """What the routes derive from one model's artifacts, once per
    revision: the model, its metadata, tag names, resolution and
    thresholds."""

    __slots__ = (
        "name",
        "model",
        "metadata",
        "tag_names",
        "target_names",
        "feature_thresholds",
        "aggregate_threshold",
        "_frequency",
    )

    def __init__(self, name: str, model: Any, metadata: dict):
        self.name = name
        self.model = model
        self.metadata = metadata
        dataset = metadata.get("dataset") or {}
        self.tag_names = _tag_names(dataset.get("tag_list") or [])
        target = dataset.get("target_tag_list")
        self.target_names = _tag_names(target) if target else list(self.tag_names)
        try:
            self._frequency: Tuple[str, Any] = ("ok", parse_resolution(dataset["resolution"]))
        except (KeyError, TypeError, ValueError) as exc:
            self._frequency = ("error", exc)
        self.feature_thresholds = getattr(model, "feature_thresholds_", None)
        self.aggregate_threshold = getattr(model, "aggregate_threshold_", None)

    @property
    def frequency(self) -> timedelta:
        """The training resolution; a bad one raises on every access."""
        kind, value = self._frequency
        if kind == "error":
            raise ValueError(f"Bad dataset resolution in metadata: {value}")
        return value


Ingest = Optional[Tuple[torch.Tensor, torch.Tensor]]

#: windows an LSTM bucket's forward gathers at once
LSTM_SERVING_BATCH = 256


#: :func:`member_plan`'s answer for a pipeline with a step that has no affine form
NOT_AFFINE = "not affine"


def member_plan(model: Any, n_features: int) -> Any:
    """One model's composed affine pipeline ``(scale, offset)`` (float32);
    None when it has no transformers; :data:`NOT_AFFINE` when a step has
    no affine form (no ``affine()``, or one that answers None).
    ``X*s1+o1`` then ``(s2, o2)`` composes to ``X*(s1*s2) + (o1*s2 +
    o2)``, in float64."""
    transformers = _transformers(model)
    if not transformers:
        return None
    scale = np.ones(n_features, np.float64)
    offset = np.zeros(n_features, np.float64)
    for step in transformers:
        affine = getattr(step, "affine", None)
        pair = affine() if affine is not None else None
        if pair is None:
            return NOT_AFFINE
        s, o = pair
        scale = scale * np.broadcast_to(s, (n_features,))
        offset = offset * np.broadcast_to(s, (n_features,)) + np.broadcast_to(o, (n_features,))
    return scale.astype(np.float32), offset.astype(np.float32)


def host_transform(model: Any, X: Any) -> np.ndarray:
    """``X`` through the model's own pipeline steps on the host, as they
    compute (float64 for the request's float64 rows), then float32: the
    rows a host-transformed bucket's kernel reads (``_host_transform``)."""
    for step in _transformers(model):
        X = step.transform(X)
    return np.asarray(X, np.float32)


def fleet_forward_gather(
    spec: FeedForwardSpec,
    stacked: Stacked,
    indices: Sequence[int],
    X: torch.Tensor,
    ingest: Ingest = None,
    precision: str = "f32",
) -> torch.Tensor:
    """The gather forward, ``(bucket[N], indices[M], X[M, B, F]) ->
    [M, B, F_out]`` float32: each row of the batch is scored by bucket
    member ``indices[m]``. ``ingest`` is the bucket's ``(scale, offset)``;
    ``X`` then holds raw float32 rows.

    At f32, one K1 launch (its plain version on the CPU), the member read
    in place by the kernel. At bf16 or int8 ``stacked`` is the bucket at
    that precision (``RevisionFleet.spec_bucket(spec, precision)``): the
    members are gathered with ``index_select``, the ingest plan applied in
    float32, the rows cast to bf16 and the plain reduced forward run."""
    if not precision or precision == serve_precision.F32:
        return fleet_feedforward(spec, stacked, X, indices=indices, ingest=ingest)
    if isinstance(indices, torch.Tensor):
        index = indices.to(X.device, torch.int64)
    else:
        index = torch.as_tensor(np.asarray(indices, np.int64), device=X.device)
    members = {key: {n: t.index_select(0, index) for n, t in layer.items()} for key, layer in stacked.items()}
    h = X.to(torch.float32)
    if ingest is not None:
        h = h * ingest[0].index_select(0, index)[:, None, :] + ingest[1].index_select(0, index)[:, None, :]
    h = h.to(serve_precision.payload_dtype(precision))
    if precision == "int8":
        return serve_precision.forward_feedforward_quantized(spec, members, h)
    return serve_precision.forward_feedforward_bf16(spec, members, h)


class StagedInput:
    """One request's rows on the device (:meth:`RevisionFleet.stage_input`):
    the member, its spec, ``x[1, B, F]`` and, for an LSTM, its windows."""

    __slots__ = ("name", "spec", "x", "windows")

    def __init__(self, name: str, spec: ModelSpec, x: torch.Tensor, windows: int):
        self.name = name
        self.spec = spec
        self.x = x
        self.windows = windows


class RevisionFleet:
    """All models of one revision directory, loaded lazily and kept for
    the life of the revision, with one stacked bucket and ingest plan per
    spec, its reduced-precision copies and the precision gate's verdicts
    (rebuilt, or read as absent, when the spec's membership grows)."""

    def __init__(self, collection_dir: str, device: torch.device):
        self.collection_dir = collection_dir
        self.device = device
        self._lock = threading.RLock()
        self._models: Dict[str, Any] = {}
        self._specs: Dict[str, ModelSpec] = {}
        self._resolutions: Dict[str, ModelResolution] = {}
        self._buckets: Dict[ModelSpec, Tuple[List[str], Stacked, Ingest]] = {}
        #: spec -> whether its bucket is host-transformed (a member is not affine)
        self._host: Dict[ModelSpec, bool] = {}
        #: (spec, precision) -> the bucket's params cast to that precision
        self._cast_buckets: Dict[Tuple[ModelSpec, str], Stacked] = {}
        #: (spec, precision) -> (gate report, membership epoch it was taken at)
        self._precision_states: Dict[Tuple[ModelSpec, str], Tuple[Dict[str, Any], int]] = {}
        #: bumped whenever a bucket's membership grows
        self.bucket_epoch = 0

    def model(self, name: str) -> Any:
        """The loaded model for ``name`` (load once, then resident)."""
        with self._lock:
            model = self._models.get(name)
            if model is not None:
                return model
            model = serializer.load(os.path.join(self.collection_dir, name), self.device)
            estimator = find_estimator(model)
            if estimator is not None and estimator.params_ is not None:
                spec = estimator.spec_
                self._specs[name] = spec
                # membership grew: restack, recast, and re-gate
                self._buckets.pop(spec, None)
                for key in [k for k in self._cast_buckets if k[0] == spec]:
                    del self._cast_buckets[key]
                self.bucket_epoch += 1
            self._models[name] = model
            return model

    def resolution(self, name: str) -> ModelResolution:
        """The cached :class:`ModelResolution`; ``FileNotFoundError`` when
        the artifacts are gone."""
        with self._lock:
            cached = self._resolutions.get(name)
            if cached is None:
                model = self.model(name)
                metadata = serializer.load_metadata(os.path.join(self.collection_dir, name))
                cached = self._resolutions[name] = ModelResolution(name, model, metadata)
            return cached

    def loaded_specs(self) -> Dict[str, ModelSpec]:
        """``{name: spec}`` of every loaded servable model."""
        with self._lock:
            return dict(self._specs)

    def warm(self) -> List[str]:
        """Load every model of the revision; returns the names that loaded."""
        loaded = []
        for name in serializer.list_model_dirs(self.collection_dir):
            try:
                self.model(name)
                loaded.append(name)
            except Exception:  # noqa: BLE001 - one bad artifact must not stop the rest
                logger.exception("warm: could not load %s", name)
        return loaded

    def warm_buckets(self) -> List[str]:
        """:meth:`warm`, then every loaded spec's stacked bucket made
        resident on the device; the names that loaded."""
        loaded = self.warm()
        for spec in set(self.loaded_specs().values()):
            self._bucket(spec)
        return loaded

    def _bucket(self, spec: ModelSpec) -> Tuple[List[str], Stacked, Ingest]:
        """``(names, stacked params, ingest plan)`` of ``spec``'s resident
        bucket; with ``GORDO_TPU_INGEST_COMPILED`` off, no plan (the bucket
        is then host-transformed, :meth:`host_transformed`)."""
        names, stacked, ingest = self._resident_bucket(spec)
        return names, stacked, ingest if compiled_enabled() else None

    def _resident_bucket(self, spec: ModelSpec) -> Tuple[List[str], Stacked, Ingest]:
        with self._lock:
            cached = self._buckets.get(spec)
            if cached is not None:
                return cached
            names = sorted(n for n, s in self._specs.items() if s == spec)
            if not names:
                raise KeyError(f"no loaded models with spec {spec}")
            stacked = stack_member_params(
                [find_estimator(self._models[n]).params_ for n in names], self.device
            )
            plans = [member_plan(self._models[n], spec.n_features) for n in names]
            ingest = None
            host = self._host[spec] = any(p is NOT_AFFINE for p in plans)
            if not host and any(p is not None for p in plans):
                identity = (np.ones(spec.n_features, np.float32), np.zeros(spec.n_features, np.float32))
                plans = [identity if p is None else p for p in plans]
                ingest = (
                    torch.from_numpy(np.stack([s for s, _ in plans])).to(self.device),
                    torch.from_numpy(np.stack([o for _, o in plans])).to(self.device),
                )
            cached = self._buckets[spec] = (names, stacked, ingest)
            return cached

    def spec_bucket(self, spec: ModelSpec, precision: str = "f32") -> Tuple[List[str], Stacked]:
        """``(names, stacked params)`` over every loaded model of ``spec``:
        names sorted, params on the device; at bf16 or int8 the bucket's
        cast (:func:`~gordo_tpu_torch.serve.precision.cast_bucket_params`),
        made once for the bucket's membership."""
        names, stacked, _ = self.serving_bucket(spec, precision)
        return names, stacked

    def serving_bucket(self, spec: ModelSpec, precision: str = "f32") -> Tuple[List[str], Stacked, Ingest]:
        """``(names, params at precision, ingest plan)`` of ``spec``'s bucket,
        all three of one membership."""
        with self._lock:
            names, stacked, ingest = self._bucket(spec)
            if not precision or precision == serve_precision.F32:
                return names, stacked, ingest
            cast = self._cast_buckets.get((spec, precision))
            if cast is None:
                cast = self._cast_buckets[(spec, precision)] = serve_precision.cast_bucket_params(stacked, precision)
            return names, cast, ingest

    def precision_state(self, spec: ModelSpec, precision: str) -> Optional[Dict[str, Any]]:
        """The gate's report for ``(spec, precision)``, or None when there
        is none for the bucket's present membership."""
        entry = self._precision_states.get((spec, precision))
        if entry is None:
            return None
        report, epoch = entry
        return report if epoch == self.bucket_epoch else None

    def set_precision_state(
        self, spec: ModelSpec, precision: str, report: Dict[str, Any], epoch: Optional[int] = None
    ) -> None:
        """Record a gate verdict, stamped with the membership epoch it was
        taken at (default: the present one)."""
        with self._lock:
            self._precision_states[(spec, precision)] = (report, self.bucket_epoch if epoch is None else epoch)

    def ingest_plan(self, spec: ModelSpec) -> Ingest:
        """The bucket's compiled preprocessing, row for row with
        :meth:`spec_bucket`: ``(scale[N, F], offset[N, F])`` float32 on the
        device, or None when no member has a transformer or the bucket is
        host-transformed."""
        return self._bucket(spec)[2]

    def host_transformed(self, spec: ModelSpec) -> bool:
        """Whether ``spec``'s bucket is host-transformed: some member's
        pipeline is not affine, or ``GORDO_TPU_INGEST_COMPILED`` is off, so
        every member's rows go through :func:`host_transform` and the
        kernel runs without the prologue."""
        with self._lock:
            self._resident_bucket(spec)
            return self._host[spec] or not compiled_enabled()

    def predict(self, name: str, X: np.ndarray) -> np.ndarray:
        """One model's reconstruction of raw rows ``X[B, F]``: the compiled
        single-member path, one gather launch with the ingest prologue; an
        LSTM's, one windowed forward of the member (``B - offset`` rows;
        ``ValueError`` unless its lookback is under ``B``).
        :meth:`stage_input` then :meth:`predict_staged`."""
        return self.predict_staged(self.stage_input(name, X))

    def stage_input(self, name: str, X: Any) -> "StagedInput":
        """One request's rows on the device for :meth:`predict_staged` (the
        routes' ``device_ingest`` stage): checked, transformed on the host
        in a host-transformed bucket, else moved by ``ingest.to_device``,
        over the dlpack rung on a card unless ``GORDO_TPU_INGEST_DLPACK`` is
        off (``gordo_tpu/server/model_io.py:111-156``). ``X`` is a matrix
        or the request's decoded columns (``ingest.RawColumns``).
        ``TypeError`` for a model without an autoencoder, ``ValueError``
        for rows it cannot take."""
        estimator = find_estimator(self.model(name))
        if estimator is None:
            raise TypeError(f"{name} holds no servable autoencoder")
        spec = estimator.spec_
        if isinstance(X, RawColumns):
            raw, shape = X, (X.rows, X.width)
        else:
            X = np.asarray(X)
            raw, shape = RawColumns.from_matrix(X), X.shape
        if len(shape) != 2 or shape[1] != spec.n_features:
            raise ValueError(f"expected rows of {spec.n_features} features, got shape {shape}")
        rows = raw.rows
        if isinstance(spec, LSTMSpec) and spec.lookback_window >= rows:
            raise ValueError(f"For {type(estimator).__name__} lookback_window must be < size of X")
        # a host-transformed bucket reads the member's transformed rows; any other, the raw rows
        if self.host_transformed(spec):
            x = torch.from_numpy(host_transform(self.model(name), raw.values())).to(self.device)
        else:
            x = to_device(raw, dlpack=dlpack_enabled(self.device), device=self.device)
        windows = rows - estimator.offset if isinstance(spec, LSTMSpec) else rows
        return StagedInput(name, spec, x[None], windows)

    def predict_staged(self, staged: "StagedInput") -> np.ndarray:
        """The forward of one staged request (the routes' ``inference``
        stage): one K1 gather launch, or an LSTM's windowed forward, and the
        copy back to the host, which waits for the launch."""
        spec = staged.spec
        names, stacked, ingest = self._bucket(spec)
        if isinstance(spec, LSTMSpec):
            return self._windowed(spec, [names.index(staged.name)], staged.x, [staged.windows])[0].cpu().numpy()
        out = fleet_forward_gather(spec, stacked, [names.index(staged.name)], staged.x, ingest=ingest)
        return out[0].cpu().numpy()

    def precision_reports(self) -> List[Dict[str, Any]]:
        """The gate reports of the present membership (the fleet-status
        document's ``serving.gates``)."""
        with self._lock:
            return [report for report, epoch in self._precision_states.values() if epoch == self.bucket_epoch]

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes this fleet keeps on its device: each loaded member's
        params, the stacked buckets, their reduced-precision casts and the
        ingest plans (tensor sizes, not an allocator reading)."""
        def tree_bytes(tree: Stacked) -> int:
            return sum(t.numel() * t.element_size() for layer in tree.values() for t in layer.values())

        with self._lock:
            models = dict(self._models)
            buckets = list(self._buckets.values())
            casts = list(self._cast_buckets.values())
        model_bytes = 0
        for model in models.values():
            estimator = find_estimator(model)
            if estimator is not None and estimator.params_ is not None:
                model_bytes += tree_bytes(estimator.params_)
        stacked_bytes = sum(tree_bytes(stacked) for _, stacked, _ in buckets)
        cast_bytes = sum(tree_bytes(cast) for cast in casts)
        ingest_bytes = sum(sum(t.numel() * t.element_size() for t in ingest)
                           for _, _, ingest in buckets if ingest is not None)
        return {"models": len(models), "model_bytes": model_bytes, "stacked_bytes": stacked_bytes,
                "cast_bytes": cast_bytes, "ingest_bytes": ingest_bytes,
                "total_bytes": model_bytes + stacked_bytes + cast_bytes + ingest_bytes}

    def forward_buckets(self) -> Dict[str, int]:
        """The forward buckets this fleet holds, by precision: each f32
        stacked bucket and each reduced cast of one."""
        with self._lock:
            counts = {"f32": len(self._buckets)} if self._buckets else {}
            for _, prec in self._cast_buckets:
                counts[prec] = counts.get(prec, 0) + 1
        return counts

    def _windowed(self, spec: LSTMSpec, rows: Sequence[int], x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
        """The windowed forward of bucket members ``rows`` on their series
        ``x[M, b, F]`` (on the device; raw, or host-transformed in such a
        bucket): each series scaled by its member's ingest plan if the
        bucket has one, then the first ``counts[m]`` windows of
        member ``m`` forwarded, ``[M, max(counts), F_out]``."""
        _, stacked, ingest = self._bucket(spec)
        index = torch.tensor(rows, device=self.device)
        members = {key: {n: t.index_select(0, index) for n, t in layer.items()} for key, layer in stacked.items()}
        if ingest is not None:
            x = x * ingest[0].index_select(0, index)[:, None, :] + ingest[1].index_select(0, index)[:, None, :]
        order = np.zeros((len(rows), max(counts)), np.int64)
        for i, count in enumerate(counts):
            order[i, :count] = np.arange(count)
        return forward_lstm_windows(spec, members, x, torch.from_numpy(order).to(self.device), LSTM_SERVING_BATCH)

    def fleet_scores(
        self, inputs: Dict[str, np.ndarray]
    ) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], Dict[str, Exception]]:
        """Score many models, one K2 launch per feedforward spec bucket and
        one windowed forward per LSTM one: ``inputs[name]`` are raw rows;
        returns ``({name: (reconstruction, per-row mse)}, {name: error})``.
        A host-transformed bucket forwards each member's transformed rows.
        The mse is against the raw rows (their last rows, for an LSTM's
        shorter output), over the first ``min(F_out, F)`` columns (the JAX
        store's ``mse_vs_raw`` rule). One broken model, or one failed host
        transform, never takes the batch down."""
        errors: Dict[str, Exception] = {}
        by_spec: Dict[ModelSpec, List[str]] = {}
        for name in inputs:
            try:
                estimator = find_estimator(self.model(name))
            except Exception as exc:  # noqa: BLE001 - per-machine isolation
                logger.warning("fleet_scores: could not load %s: %r", name, exc)
                errors[name] = exc
                continue
            if estimator is None:
                errors[name] = TypeError(f"{name} holds no servable autoencoder")
                continue
            by_spec.setdefault(estimator.spec_, []).append(name)

        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # feedforward buckets first, then the LSTM ones: the JAX store's order
        for spec, names in sorted(by_spec.items(), key=lambda item: isinstance(item[0], LSTMSpec)):
            names = sorted(names)
            raw = {n: np.asarray(inputs[n], np.float32) for n in names}
            for n in names:
                if raw[n].ndim != 2 or raw[n].shape[1] != spec.n_features:
                    errors[n] = ValueError(f"expected rows of {spec.n_features} features, got shape {raw[n].shape}")
            names = [n for n in names if n not in errors]
            rows = raw
            if names and self.host_transformed(spec):
                rows = {}
                for n in names:
                    try:
                        rows[n] = host_transform(self._models[n], inputs[n])
                    except Exception as exc:  # noqa: BLE001 - per-machine isolation
                        logger.warning("fleet_scores: transform failed for %s: %r", n, exc)
                        errors[n] = exc
                names = [n for n in names if n in rows]
            if isinstance(spec, LSTMSpec):
                self._score_lstm_bucket(spec, names, rows, raw, out, errors)
                continue
            if not names:
                continue
            bucket_names, stacked, ingest = self._bucket(spec)
            b_max = max(raw[n].shape[0] for n in names)

            def stacked_rows(arrays):
                X = np.zeros((len(names), b_max, spec.n_features), np.float32)
                for i, n in enumerate(names):
                    X[i, : arrays[n].shape[0]] = arrays[n]
                return torch.from_numpy(X).to(self.device)

            x = stacked_rows(rows)
            y = x if rows is raw else stacked_rows(raw)
            indices = None if names == bucket_names else [bucket_names.index(n) for n in names]
            recon, mse = fleet_anomaly_scores(spec, stacked, x, y, indices, ingest)
            recon, mse = recon.cpu().numpy(), mse.cpu().numpy()
            for i, n in enumerate(names):
                rows = raw[n].shape[0]
                out[n] = (recon[i, :rows], mse[i, :rows])
        return out, errors

    def _score_lstm_bucket(self, spec: LSTMSpec, names: List[str], rows: Dict[str, np.ndarray],
                           raw: Dict[str, np.ndarray], out, errors) -> None:
        """One windowed forward for the LSTM members ``names`` (model input
        rows in ``rows``, raw rows in ``raw``, the same dict unless the
        bucket is host-transformed), each forwarding its own count of
        windows (its lookahead is its own); a series without a whole window
        is its error."""
        counts = {}
        for n in names:
            estimator = find_estimator(self._models[n])
            count = num_windows(len(raw[n]), spec.lookback_window, estimator.lookahead)
            if count <= 0:
                errors[n] = ValueError(
                    f"series of {len(raw[n])} rows too short for lookback {spec.lookback_window} "
                    f"(lookahead {estimator.lookahead})"
                )
            else:
                counts[n] = count
        kept = [n for n in names if n in counts]
        if not kept:
            return
        bucket_names = self._bucket(spec)[0]
        # at least one window's rows, so the padded gather stays in bounds
        b_max = max(spec.lookback_window, *(len(raw[n]) for n in kept))
        X = np.zeros((len(kept), b_max, spec.n_features), np.float32)
        for i, n in enumerate(kept):
            X[i, : len(rows[n])] = rows[n]
        x = torch.from_numpy(X).to(self.device)
        predictions = self._windowed(spec, [bucket_names.index(n) for n in kept], x,
                                     [counts[n] for n in kept]).cpu().numpy()
        for i, n in enumerate(kept):
            prediction = predictions[i, : counts[n]]
            aligned = raw[n][len(raw[n]) - len(prediction):]
            width = min(prediction.shape[-1], aligned.shape[-1])
            out[n] = (prediction, ((prediction[:, :width] - aligned[:, :width]) ** 2).mean(axis=-1))


class FleetModelStore:
    """An LRU of :class:`RevisionFleet` objects keyed by the real path of their
    revision directory (``FleetModelStore`` of
    ``gordo_tpu/server/fleet_store.py``): the served revision
    (``collection_dir``) and the revisions that requests pin with
    ``?revision=``. ``N_CACHED_REVISIONS`` (default 2) bounds how many
    stay resident; a revision is never evicted model by model. An evicted
    or invalidated fleet stays usable by a request that already holds
    it.

    The lifecycle's routing (``:946-1032``): a hot-swap redirect
    (:meth:`swap`) and a canary slice (:meth:`set_canary`, every Nth routed
    request) send an unpinned request for a directory to another revision;
    :meth:`route` resolves it once a request. A swap or a canary with
    ``warm`` loads the revision's models and makes its buckets resident on
    the device before the routing lands (the port compiles nothing). A
    request already holding a fleet keeps it across a swap."""

    def __init__(self, collection_dir: str, device: torch.device):
        max_revisions = env_int("N_CACHED_REVISIONS", 2)
        if max_revisions < 1:
            logger.warning("N_CACHED_REVISIONS=%d is not a positive revision count; using 2", max_revisions)
            max_revisions = 2
        self.collection_dir = collection_dir
        self.device = device
        self.max_revisions = max_revisions
        self._lock = threading.Lock()
        self._revisions: "OrderedDict[str, RevisionFleet]" = OrderedDict()
        #: the last ``(collection_dir as asked, fleet)``: a request for the
        #: same directory skips the realpath and the lock
        self._mru: Optional[Tuple[str, RevisionFleet]] = None
        #: hot-swap redirects, requested directory -> served one; written
        #: under the lock, read without it
        self._redirects: Dict[str, str] = {}
        #: the canary slice, (source key, canary directory, every-Nth period)
        self._canary: Optional[Tuple[str, str, int]] = None
        #: counts routed requests of the canary's source; unlocked, so under
        #: concurrent load the slice may be off by a request or two
        self._canary_tick = 0

    @staticmethod
    def _route_key(collection_dir: str) -> str:
        """Routing keys are normalized paths, so a trailing slash does not
        miss a redirect (no realpath: no system call a request)."""
        return os.path.normpath(collection_dir)

    def route(self, collection_dir: str) -> str:
        """The directory that serves an unpinned request for
        ``collection_dir``: the canary on every Nth request of its slice,
        else the redirect, else ``collection_dir`` itself."""
        key = self._route_key(collection_dir)
        canary = self._canary
        if canary is not None and canary[0] == key:
            self._canary_tick += 1
            if self._canary_tick % canary[2] == 0:
                return canary[1]
        return self._redirects.get(key, collection_dir)

    def swap(self, collection_dir: str, new_dir: str, warm: bool = True) -> RevisionFleet:
        """Route ``collection_dir``'s requests to ``new_dir`` from now on
        (loaded first, with ``warm``); onto itself, drop the redirect. A
        canary slice of ``collection_dir`` ends."""
        fleet = self._ensure_fleet(new_dir, warm=warm)
        key = self._route_key(collection_dir)
        with self._lock:
            if os.path.realpath(new_dir) == os.path.realpath(collection_dir):
                self._redirects.pop(key, None)
            else:
                self._redirects[key] = new_dir
            canary = self._canary
            if canary is not None and canary[0] == key:
                self._canary = None
            self._mru = (new_dir, fleet)
        return fleet

    def set_canary(self, collection_dir: str, canary_dir: str, fraction: float, warm: bool = True) -> RevisionFleet:
        """Route every ``round(1 / fraction)``-th request for
        ``collection_dir`` to ``canary_dir`` (loaded first, with ``warm``)."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1]: {fraction}")
        fleet = self._ensure_fleet(canary_dir, warm=warm)
        period = max(1, int(round(1.0 / fraction)))
        with self._lock:
            self._canary = (self._route_key(collection_dir), canary_dir, period)
        return fleet

    def clear_canary(self, collection_dir: Optional[str] = None) -> None:
        """End the canary slice (of ``collection_dir``, or any); requests
        already routed to it finish there."""
        with self._lock:
            canary = self._canary
            if canary is not None and (collection_dir is None or canary[0] == self._route_key(collection_dir)):
                self._canary = None

    def canary_status(self) -> Optional[Dict[str, Any]]:
        canary = self._canary
        if canary is None:
            return None
        return {"source": canary[0], "canary": canary[1], "fraction": 1.0 / canary[2]}

    def _ensure_fleet(self, collection_dir: str, warm: bool = False) -> RevisionFleet:
        """The resident fleet of ``collection_dir``, made (evicting the
        least recently used beyond ``max_revisions``) on first use; with
        ``warm``, its models loaded and buckets resident (outside the lock)."""
        key = os.path.realpath(collection_dir)
        with self._lock:
            fleet = self._revisions.get(key)
            if fleet is None:
                mru = self._mru
                if mru is not None:  # requests served through _mru never refreshed its slot
                    for mru_key, mru_fleet in self._revisions.items():
                        if mru_fleet is mru[1]:
                            self._revisions.move_to_end(mru_key)
                            break
                fleet = self._revisions[key] = RevisionFleet(key, self.device)
                while len(self._revisions) > self.max_revisions:
                    evicted, _ = self._revisions.popitem(last=False)
                    logger.info("Evicting served revision %s", evicted)
            else:
                self._revisions.move_to_end(key)
        if warm:
            fleet.warm_buckets()
        return fleet

    def fleet(self, collection_dir: Optional[str] = None) -> RevisionFleet:
        """The fleet of ``collection_dir`` (default: the served revision)."""
        if collection_dir is None:
            collection_dir = self.collection_dir
        mru = self._mru
        if mru is not None and mru[0] == collection_dir:
            return mru[1]
        fleet = self._ensure_fleet(collection_dir)
        with self._lock:
            self._mru = (collection_dir, fleet)
        return fleet

    def revision_stats(self) -> Dict[str, Dict[str, int]]:
        """:meth:`RevisionFleet.resident_bytes` of each resident revision,
        by its directory's name (the fleet-status ``serving.store``)."""
        with self._lock:
            revisions = list(self._revisions.items())
        return {os.path.basename(key) or key: fleet.resident_bytes() for key, fleet in revisions}

    def program_cache_stats(self, engine: Any = None) -> Dict[str, Any]:
        """The fleet-status document's ``programs``, under the JAX keys. The
        port compiles no program; what it keeps is forward buckets:
        ``programs`` counts the (spec, precision) forward buckets resident
        across the revisions, ``by_precision`` them by precision, and
        ``signatures`` the distinct forward shapes (members, rows,
        precision) the app's engine launched (0 without one)."""
        with self._lock:
            fleets = list(self._revisions.values())
        by_precision: Dict[str, int] = {}
        for fleet in fleets:
            for prec, count in fleet.forward_buckets().items():
                by_precision[prec] = by_precision.get(prec, 0) + count
        return {"programs": sum(by_precision.values()),
                "signatures": len(engine.program_shapes()) if engine is not None else 0,
                "by_precision": by_precision}

    def invalidate(self, collection_dir: str) -> None:
        """Forget ``collection_dir``'s fleet (its artifacts changed on
        disk); the next request loads it afresh."""
        key = os.path.realpath(collection_dir)
        with self._lock:
            self._mru = None
            self._revisions.pop(key, None)
            # routing onto the forgotten revision goes; routing from it stays
            canary = self._canary
            if canary is not None and os.path.realpath(canary[1]) == key:
                self._canary = None
            for source, target in list(self._redirects.items()):
                if os.path.realpath(target) == key:
                    del self._redirects[source]
