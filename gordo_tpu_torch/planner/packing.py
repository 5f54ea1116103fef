"""
Training buckets: the ``naive`` strategy of ``gordo_tpu/planner/packing.py``
(``_round_up_pow2``, ``naive_pad_target``, ``_naive_buckets``,
``:91-117``, ``:194-220``).

Members train together when they share a spec and a pad target: the
next power of two of their sample count, at least one batch, rounded up
to whole batches. The pad length is also each epoch's permutation
length, so it must equal the JAX package's for the two trainers to see
the same batches. The cost-model ``packed`` strategy and block-diagonal
packing are not ported.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple


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


def naive_pad_target(member: Any, batch_size: int) -> int:
    """A dense member's pad target on the sample axis."""
    return _round_up_pow2(member.n, batch_size)


@dataclass
class PlannedBucket:
    """One training bucket: members of one spec padded to ``n_padded``."""

    spec: Any
    members: List[Any]
    n_padded: int


def naive_buckets(members: Sequence[Any], batch_size: int) -> List[PlannedBucket]:
    """One bucket per exact ``(spec, pad target)``, members in input order."""
    grouped: Dict[Tuple[Any, int], List[Any]] = {}
    for member in members:
        grouped.setdefault((member.spec, naive_pad_target(member, batch_size)), []).append(member)
    return [PlannedBucket(spec, bucket, n_padded) for (spec, n_padded), bucket in grouped.items()]
