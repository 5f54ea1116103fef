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
two trainers to see the same batches. The cost-model ``packed`` strategy
and block-diagonal packing are not ported.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from ..utils.env import env_float

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
    samples (series rows when ``windowed``, of model offset ``offset``)."""

    spec: Any
    members: List[Any]
    n_padded: int
    offset: int = 0
    windowed: bool = False


def naive_buckets(members: Sequence[Any], batch_size: int) -> List[PlannedBucket]:
    """One bucket per exact ``(spec, pad target, offset, windowed)``,
    members in input order."""
    grouped: Dict[Tuple[Any, int, int, bool], List[Any]] = {}
    for member in members:
        key = (member.spec, naive_pad_target(member, batch_size), member_offset(member), member_is_windowed(member))
        grouped.setdefault(key, []).append(member)
    return [PlannedBucket(spec, bucket, n_padded, offset, windowed)
            for (spec, n_padded, offset, windowed), bucket in grouped.items()]
