"""
Training buckets: the ``naive`` strategy of ``gordo_tpu/planner/packing.py``
(``_round_up_pow2``, ``naive_pad_target``, ``_naive_buckets``,
``:91-117``, ``:194-220``) and the geometric ladder of
``gordo_tpu/planner/ladder.py`` (``round_up_ladder``,
``series_pad_ratio``, ``:135-176``).

Members train together when they share a spec and a pad target. A dense
member's pad target is the next power of two of its sample count, at
least one batch, rounded up to whole batches. A windowed (LSTM) member's
is its series length rounded up the geometric ladder of ratio
``GORDO_TPU_SERIES_PAD_RATIO`` (default 1.25); windowed buckets are also
keyed by the model offset, so every member of one has the same number of
window slots. The pad length sets each epoch's batches (and a dense
member's permutation length), so it must equal the JAX package's for the
two trainers to see the same batches.

:func:`train_buckets` names each bucket (``<hash of spec and fit
config>-n<pad>``, ``-o<offset>`` when windowed, ``_bucket_key``,
``:173-188``): the trainer trains these buckets, and
:func:`plan_train_buckets` fills their ``predicted`` numbers from the
analytic cost model (``annotate_predictions``, ``:366-440``) for the
build's ``fleet_plan.json``. The cost-model ``packed`` strategy and
block-diagonal packing are not ported (``ROADMAP.md`` item 7).
"""

import hashlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

from ..utils.env import env_float
from .costmodel import CostModel

SERIES_PAD_RATIO_ENV = "GORDO_TPU_SERIES_PAD_RATIO"
DEFAULT_SERIES_PAD_RATIO = 1.25


def _round_up_pow2(n: int, batch_size: int) -> int:
    """The next power of two of ``n``, at least ``batch_size``, rounded up
    to a whole number of batches.

    >>> _round_up_pow2(577, 32), _round_up_pow2(10, 32), _round_up_pow2(2000, 48)
    (1024, 32, 2064)
    """
    target = max(n, batch_size)
    power = 1
    while power < target:
        power <<= 1
    return ((power + batch_size - 1) // batch_size) * batch_size


def round_up_ladder(n: int, ratio: float, multiple: int = 1) -> int:
    """
    The smallest geometric-ladder rung ``>= n``: rung ``k`` is
    ``multiple * ratio**k`` rounded up to a multiple of ``multiple``, each
    rung above the last.

    >>> round_up_ladder(100, 2.0, 16)
    128
    >>> round_up_ladder(1100, 1.25), round_up_ladder(2000, 1.25)
    (1263, 2466)
    """
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    ratio = max(float(ratio), 1.0001)
    rung, k = multiple, 0
    while rung < n:
        k += 1
        raw = math.ceil(multiple * ratio**k)
        rung = max(-(-raw // multiple) * multiple, rung + multiple)
    return rung


def series_pad_ratio() -> float:
    """The windowed series axis' ladder ratio: ``GORDO_TPU_SERIES_PAD_RATIO``
    when it is above 1, else 1.25."""
    value = env_float(SERIES_PAD_RATIO_ENV, DEFAULT_SERIES_PAD_RATIO)
    return value if value and value > 1.0 else DEFAULT_SERIES_PAD_RATIO


def member_is_windowed(member: Any) -> bool:
    return hasattr(member, "series")


def member_offset(member: Any) -> int:
    """A windowed member's model offset (series rows less windows), else 0."""
    return len(member.series) - member.n_windows if member_is_windowed(member) else 0


def naive_pad_target(member: Any, batch_size: int) -> int:
    """A member's pad target: pow2 on the dense sample axis, the geometric
    ladder on the windowed series axis."""
    if member_is_windowed(member):
        return round_up_ladder(len(member.series), series_pad_ratio())
    return _round_up_pow2(member.n, batch_size)


@dataclass
class PlannedBucket:
    """One training bucket: members of one spec padded to ``n_padded``
    samples (series rows when ``windowed``, of model offset ``offset``);
    ``bucket_id``, ``program`` and the cost model's ``predicted`` numbers
    once :func:`plan_train_buckets` has planned it."""

    spec: Any
    members: List[Any]
    n_padded: int
    offset: int = 0
    windowed: bool = False
    bucket_id: str = ""
    program: str = ""
    predicted: Dict[str, Any] = field(default_factory=dict)

    @property
    def member_names(self) -> List[str]:
        return [m.name for m in self.members]


def naive_buckets(members: Sequence[Any], batch_size: int) -> List[PlannedBucket]:
    """One bucket per exact ``(spec, pad target, offset, windowed)``,
    members in input order."""
    grouped: Dict[Tuple[Any, int, int, bool], List[Any]] = {}
    for member in members:
        key = (member.spec, naive_pad_target(member, batch_size), member_offset(member), member_is_windowed(member))
        grouped.setdefault(key, []).append(member)
    return [PlannedBucket(spec, bucket, n_padded, offset, windowed)
            for (spec, n_padded, offset, windowed), bucket in grouped.items()]


def _bucket_key(spec: Any, config: Any) -> str:
    """A short id of (spec, fit config), the same in every process and in
    the JAX package (the spec's dataclass ``repr`` is the same string)."""
    fit = (config.epochs, config.batch_size, config.validation_split, config.shuffle,
           tuple(config.early_stopping or ()) or None)
    return hashlib.sha256(f"{spec!r}|{fit!r}".encode()).hexdigest()[:10]


def annotate_predictions(buckets: Sequence[PlannedBucket], config: Any) -> None:
    """Each bucket's ``predicted`` numbers: stacked shape, run and compile
    seconds, resident bytes, true and padded FLOPs, padding waste. A
    compile is counted on the first bucket of each stacked signature
    only, as ``program_span`` counts them."""
    cost_model = CostModel()
    seen = set()
    for bucket in buckets:
        m = len(bucket.members)  # the naive strategy pads no member axis
        if bucket.windowed:
            m_total, n_series, n_total = cost_model.stacked_windowed_shape(m, bucket.n_padded, bucket.offset,
                                                                            config.batch_size)
            shape = [m_total, n_series, n_total]
        else:
            m_total, n_total = cost_model.stacked_shape(m, bucket.n_padded, config.batch_size)
            shape = [m_total, n_total]
        signature = (repr(bucket.spec), bucket.program, tuple(shape))
        compiles = 0 if signature in seen else 1
        seen.add(signature)
        true_flops = sum(
            cost_model.train_flops(bucket.spec, 1, member_samples(member) - (bucket.offset if bucket.windowed else 0),
                                   config.epochs)
            for member in bucket.members
        )
        padded_flops = cost_model.train_flops(bucket.spec, m_total, n_total, config.epochs)
        run_s = cost_model.predict_run_s(bucket.program, bucket.spec, m_total, n_total, config.epochs)
        compile_s = cost_model.predict_compile_s(bucket.program, bucket.spec) if compiles else 0.0
        if bucket.windowed:
            hbm = cost_model.predict_hbm_bytes(bucket.spec, m_total, n_total, config.batch_size,
                                               series_rows=bucket.n_padded)
        else:
            aliased = all(getattr(mm, "y", None) is getattr(mm, "X", None) for mm in bucket.members)
            hbm = cost_model.predict_hbm_bytes(bucket.spec, m_total, n_total, config.batch_size, y_aliased=aliased)
        bucket.predicted = {
            "members": len(bucket.members),
            "stacked_shape": shape,
            "compiles": compiles,
            "compile_s": round(compile_s, 6),
            "run_s": round(run_s, 6),
            "hbm_bytes": int(hbm),
            "flops_true": float(f"{true_flops:.6g}"),
            "flops_padded": float(f"{padded_flops:.6g}"),
            "padding_waste": round(1.0 - true_flops / padded_flops if padded_flops else 0.0, 6),
        }


def member_samples(member: Any) -> int:
    """A member's rows on its pad axis: series rows when windowed, else samples."""
    return len(member.series) if member_is_windowed(member) else member.n


def train_buckets(members: Sequence[Any], config: Any) -> List[PlannedBucket]:
    """The naive buckets of ``members`` under ``config``, each with its id
    and program: what the trainer trains and the plan records."""
    buckets = naive_buckets(members, config.batch_size)
    for bucket in buckets:
        bucket.bucket_id = f"{_bucket_key(bucket.spec, config)}-n{bucket.n_padded}" + (
            f"-o{bucket.offset}" if bucket.windowed else "")
        bucket.program = "fleet_windowed_fit" if bucket.windowed else "fleet_fit"
    return buckets


def plan_train_buckets(members: Sequence[Any], config: Any) -> List[PlannedBucket]:
    """:func:`train_buckets`, priced by the analytic cost model."""
    buckets = train_buckets(members, config)
    annotate_predictions(buckets, config)
    return buckets
