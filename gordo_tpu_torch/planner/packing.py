"""
Training buckets, as ``gordo_tpu/planner/packing.py`` builds them
(``:57-481``): which members train together as one stacked program, at
which padded shape.

Two strategies (``GORDO_TPU_PLAN_STRATEGY``, default ``naive``):

- ``naive`` (``_naive_buckets``): one bucket per exact (spec, pad target,
  offset, windowed). A dense member's pad target is the next power of two
  of its samples, at least one batch, rounded up to whole batches; a
  windowed (LSTM) member's is its series rows rounded up the geometric
  ladder of ``GORDO_TPU_SERIES_PAD_RATIO`` (``ladder.py``).
- ``packed`` (:func:`_packed_buckets`), the cost-model bin packer, in
  three steps: each member's rows round up the geometric ladder
  (``GORDO_TPU_PLAN_PAD_RATIO`` on the dense sample axis, at least one
  batch, whole batches); then a rung merges into the next one up of its
  (spec, offset, windowed) family while the compile it saves outweighs
  the padded run time it adds (the largest net win across families
  first), or, past a compile budget (``GORDO_TPU_PLAN_COMPILE_BUDGET``),
  cheapest padding first until the programs fit it; then each rung's
  members go best-fit-decreasing into bins whose predicted resident bytes
  stay under ``GORDO_TPU_PLAN_HBM_CAP_BYTES`` (4 GiB). Sibling bins of a
  split rung share a power-of-two member rung, ``m_padded``, so that JAX
  compiles them once.

Both keep members in input order. The pad length sets each epoch's
batches (and a dense member's permutation length), so it must equal the
JAX package's for the two trainers to see the same batches.

Each bucket's id is ``<hash of spec and fit config>-n<pad>``, then
``-o<offset>`` when windowed and ``-b<bin>`` for a split rung's siblings
(``_bucket_key``). :func:`annotate_predictions` fills its ``predicted``
numbers from the cost model for the build's ``fleet_plan.json``.
"""

import hashlib
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.env import env_int, env_str
from .costmodel import CostModel
from .ladder import round_up_ladder, sample_pad_ratio, series_pad_ratio  # noqa: F401 - re-exported

logger = logging.getLogger(__name__)

NAIVE = "naive"
PACKED = "packed"
STRATEGIES = (NAIVE, PACKED)

STRATEGY_ENV = "GORDO_TPU_PLAN_STRATEGY"
COMPILE_BUDGET_ENV = "GORDO_TPU_PLAN_COMPILE_BUDGET"
HBM_CAP_ENV = "GORDO_TPU_PLAN_HBM_CAP_BYTES"
#: the packed strategy's default cap on a bucket's predicted resident bytes
DEFAULT_HBM_CAP_BYTES = 4 << 30


def default_strategy() -> str:
    """The build's strategy, ``GORDO_TPU_PLAN_STRATEGY``; an unknown value
    warns and gives ``naive``."""
    raw = (env_str(STRATEGY_ENV, NAIVE) or NAIVE).strip().lower()
    if raw not in STRATEGIES:
        logger.warning("Invalid %s=%r; using %r", STRATEGY_ENV, raw, NAIVE)
        return NAIVE
    return raw


def compile_budget() -> int:
    """The packed strategy's cap on programs, ``GORDO_TPU_PLAN_COMPILE_BUDGET``
    (0: none; rungs merge only while a merge pays)."""
    return max(0, env_int(COMPILE_BUDGET_ENV, 0))


def hbm_cap_bytes() -> int:
    """The packed strategy's cap on a bucket's predicted resident bytes,
    ``GORDO_TPU_PLAN_HBM_CAP_BYTES`` (at least 1 MiB)."""
    return max(1 << 20, env_int(HBM_CAP_ENV, DEFAULT_HBM_CAP_BYTES))


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


def member_is_windowed(member: Any) -> bool:
    return hasattr(member, "series")


def member_samples(member: Any) -> int:
    """A member's rows on its pad axis: series rows when windowed, else samples."""
    return len(member.series) if member_is_windowed(member) else member.n


def member_offset(member: Any) -> int:
    """A windowed member's model offset (series rows less windows), else 0."""
    return len(member.series) - member.n_windows if member_is_windowed(member) else 0


def naive_pad_target(member: Any, batch_size: int) -> int:
    """A member's naive pad target: pow2 on the dense sample axis, the
    geometric ladder on the windowed series axis."""
    if member_is_windowed(member):
        return round_up_ladder(len(member.series), series_pad_ratio())
    return _round_up_pow2(member.n, batch_size)


def _spec_program(member: Any) -> str:
    return "fleet_windowed_fit" if member_is_windowed(member) else "fleet_fit"


def _member_bytes(cost_model: CostModel, member: Any, n_padded: int, batch: int) -> int:
    """One member's predicted bytes in a bucket padded to ``n_padded``:
    the bin packer's item weight."""
    if member_is_windowed(member):
        return cost_model.predict_hbm_bytes(member.spec, 1, n_padded - member_offset(member), batch,
                                            series_rows=n_padded)
    y_aliased = getattr(member, "y", None) is getattr(member, "X", None)
    return cost_model.predict_hbm_bytes(member.spec, 1, n_padded, batch, y_aliased=y_aliased)


@dataclass
class PlannedBucket:
    """One training bucket: members of one spec padded to ``n_padded``
    samples (series rows when ``windowed``, of model offset ``offset``),
    ``m_padded`` the member rung a split rung's siblings share (None:
    the members alone); its id, program and the cost model's
    ``predicted`` numbers once planned."""

    spec: Any
    members: List[Any]
    n_padded: int
    offset: int = 0
    windowed: bool = False
    bucket_id: str = ""
    program: str = ""
    m_padded: Optional[int] = None
    predicted: Dict[str, Any] = field(default_factory=dict)

    @property
    def member_names(self) -> List[str]:
        return [m.name for m in self.members]


def _bucket_key(spec: Any, config: Any) -> str:
    """A short id of (spec, fit config), the same in every process and in
    the JAX package (the spec's dataclass ``repr`` is the same string)."""
    fit = (config.epochs, config.batch_size, config.validation_split, config.shuffle,
           tuple(config.early_stopping or ()) or None)
    return hashlib.sha256(f"{spec!r}|{fit!r}".encode()).hexdigest()[:10]


def naive_buckets(members: Sequence[Any], batch_size: int) -> List[PlannedBucket]:
    """One bucket per exact ``(spec, pad target, offset, windowed)``,
    members in input order (no ids yet)."""
    grouped: Dict[Tuple[Any, int, int, bool], List[Any]] = {}
    for member in members:
        key = (member.spec, naive_pad_target(member, batch_size), member_offset(member), member_is_windowed(member))
        grouped.setdefault(key, []).append(member)
    return [PlannedBucket(spec, bucket, n_padded, offset, windowed)
            for (spec, n_padded, offset, windowed), bucket in grouped.items()]


def _naive_buckets(members: Sequence[Any], config: Any) -> List[PlannedBucket]:
    """:func:`naive_buckets` with their ids and programs."""
    buckets = naive_buckets(members, config.batch_size)
    for bucket in buckets:
        bucket.bucket_id = f"{_bucket_key(bucket.spec, config)}-n{bucket.n_padded}" + (
            f"-o{bucket.offset}" if bucket.windowed else "")
        bucket.program = _spec_program(bucket.members[0])
    return buckets


def _packed_buckets(members: Sequence[Any], config: Any, cost_model: CostModel, budget: Optional[int] = None,
                    hbm_cap: Optional[int] = None) -> List[PlannedBucket]:
    """The ``packed`` strategy's buckets (``packing.py:226-364``)."""
    budget = compile_budget() if budget is None else budget
    hbm_cap = hbm_cap_bytes() if hbm_cap is None else hbm_cap
    batch = config.batch_size
    input_pos = {m.name: i for i, m in enumerate(members)}

    # 1. each member's rows up the geometric ladder
    rung_groups: Dict[Tuple, List[Any]] = {}
    for member in members:
        if member_is_windowed(member):
            rung = round_up_ladder(len(member.series), series_pad_ratio())
        else:
            rung = round_up_ladder(max(member.n, batch), sample_pad_ratio(), multiple=batch)
        key = (member.spec, member_offset(member), member_is_windowed(member), rung)
        rung_groups.setdefault(key, []).append(member)

    # 2. merging a rung into the next one up of its family saves a program
    #    and pads the merged members further
    def candidate_merges():
        families: Dict[Tuple, List[Tuple]] = {}
        for key in rung_groups:
            families.setdefault(key[:3], []).append(key)
        merges = []  # (added run seconds, compile seconds saved, src, dst)
        for family_keys in families.values():
            family_keys.sort(key=lambda k: k[3])
            for src, dst in zip(family_keys[:-1], family_keys[1:]):
                spec, _, windowed, _ = src
                program = "fleet_windowed_fit" if windowed else "fleet_fit"
                added_flops = (dst[3] - src[3]) * len(rung_groups[src]) * cost_model.train_flops(
                    spec, 1, 1, config.epochs)
                added_run_s = cost_model.table.run_factors.get(program, 1.0) * added_flops / \
                    cost_model.table.throughput
                merges.append((added_run_s, cost_model.predict_compile_s(program, spec), src, dst))
        return merges

    while len(rung_groups) > 1:
        merges = candidate_merges()
        if not merges:
            break
        if budget and len(rung_groups) > budget:
            # forced: the cheapest padding, the first such merge on a tie
            pick = min(range(len(merges)), key=lambda i: (merges[i][0], i))
        else:
            # voluntary: the largest net win across every family
            pick = max(range(len(merges)), key=lambda i: (merges[i][1] - merges[i][0], -i))
            added_run_s, compile_saved_s = merges[pick][:2]
            if added_run_s >= compile_saved_s:
                break
        _, _, src, dst = merges[pick]
        rung_groups[dst] = rung_groups[dst] + rung_groups.pop(src)

    # 3. best-fit-decreasing under the HBM cap inside each rung
    buckets: List[PlannedBucket] = []
    for (spec, offset, windowed, rung), group in rung_groups.items():
        group = sorted(group, key=lambda m: input_pos[m.name])
        weights = {m.name: _member_bytes(cost_model, m, rung, batch) for m in group}
        order = sorted(range(len(group)), key=lambda i: (-weights[group[i].name], i))
        bins: List[Tuple[List[Any], int]] = []  # (members, bytes used)
        for i in order:
            member = group[i]
            size = weights[member.name]
            best_bin = None
            for b, (_, used) in enumerate(bins):
                if used + size <= hbm_cap and (best_bin is None or used > bins[best_bin][1]):
                    best_bin = b
            if best_bin is None:
                bins.append(([member], size))
            else:
                bin_members, used = bins[best_bin]
                bin_members.append(member)
                bins[best_bin] = (bin_members, used + size)
        packed_bins = [sorted(bin_members, key=lambda m: input_pos[m.name]) for bin_members, _ in bins]
        m_padded = round_up_ladder(max(len(b) for b in packed_bins), 2.0) if len(packed_bins) > 1 else None
        for idx, bin_members in enumerate(packed_bins):
            buckets.append(PlannedBucket(
                spec=spec,
                members=bin_members,
                n_padded=rung,
                offset=offset,
                windowed=windowed,
                bucket_id=f"{_bucket_key(spec, config)}-n{rung}" + (f"-o{offset}" if windowed else "")
                + (f"-b{idx}" if len(packed_bins) > 1 else ""),
                program=_spec_program(bin_members[0]),
                m_padded=m_padded,
            ))
    return buckets


def annotate_predictions(buckets: Sequence[PlannedBucket], config: Any, cost_model: Optional[CostModel] = None) -> None:
    """Each bucket's ``predicted`` numbers: stacked shape (the member axis
    at least ``m_padded``), run and compile seconds, resident bytes, true
    and padded FLOPs, padding waste. A stacked signature's compile is
    counted on its first bucket only, as ``program_span`` counts them."""
    cost_model = cost_model or CostModel()
    seen = set()
    for bucket in buckets:
        m = max(len(bucket.members), bucket.m_padded or 0)
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


def plan_train_buckets(
    members: Sequence[Any],
    config: Any,
    strategy: Optional[str] = None,
    cost_model: Optional[CostModel] = None,
    plan: Optional[Any] = None,
    budget: Optional[int] = None,
    hbm_cap: Optional[int] = None,
) -> List[PlannedBucket]:
    """
    ``members`` (dense and windowed) as training buckets, priced by the
    cost model. With a ``plan`` (``plan.FleetPlan``), the members it
    covers keep its buckets and pad targets (:meth:`FleetPlan.materialize_buckets`);
    the others (CV fold members, machines added since) pack live with
    ``strategy`` (default :func:`default_strategy`).
    """
    if not members:
        return []
    strategy = strategy or default_strategy()
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown plan strategy {strategy!r}")
    cost_model = cost_model or CostModel()
    planned: List[PlannedBucket] = []
    remaining = list(members)
    if plan is not None:
        planned, remaining = plan.materialize_buckets(members)
    if remaining:
        if strategy == PACKED:
            planned += _packed_buckets(remaining, config, cost_model, budget=budget, hbm_cap=hbm_cap)
        else:
            planned += _naive_buckets(remaining, config)
    annotate_predictions(planned, config, cost_model)
    return planned
