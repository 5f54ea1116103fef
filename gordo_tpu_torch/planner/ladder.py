"""
The build planner's geometric shape ladders, a copy of the geometric half
of ``gordo_tpu/planner/ladder.py`` (``round_up_ladder``,
``geometric_rungs``, ``series_pad_ratio``, ``sample_pad_ratio``,
``:135-183``). The serving engine's explicit row ladder lives with the
engine (``serve/ladder.py``).

An open-ended axis (a member's samples, a windowed member's series rows)
is padded up a ladder of ratio ``r``: rung ``k`` is ``multiple * r**k``
rounded up to a multiple of ``multiple``. Ratio 2 is pow2 padding (up to
twice the work an axis); 1.25 bounds the waste at a quarter for about
three times the distinct shapes, which the packed planner then merges
back where a compile costs more than the padding it saves.
"""

import math
from typing import List

from ..utils.env import env_float

#: the windowed series axis' ratio (both strategies)
SERIES_PAD_RATIO_ENV = "GORDO_TPU_SERIES_PAD_RATIO"
DEFAULT_SERIES_PAD_RATIO = 1.25

#: the packed strategy's dense sample axis' ratio
SAMPLE_PAD_RATIO_ENV = "GORDO_TPU_PLAN_PAD_RATIO"
DEFAULT_SAMPLE_PAD_RATIO = 1.25


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


def geometric_rungs(lo: int, hi: int, ratio: float, multiple: int = 1) -> List[int]:
    """Every rung covering ``[lo, hi]``, both rounded up onto the ladder:
    the shapes a packer chooses from.

    >>> geometric_rungs(600, 2000, 1.25, 32)
    [608, 736, 928, 1152, 1440, 1792, 2240]
    """
    rungs = [round_up_ladder(max(lo, 1), ratio, multiple)]
    while rungs[-1] < hi:
        rungs.append(round_up_ladder(rungs[-1] + 1, ratio, multiple))
    return rungs


def series_pad_ratio() -> float:
    """The windowed series axis' ratio: ``GORDO_TPU_SERIES_PAD_RATIO``
    when it is above 1, else 1.25."""
    value = env_float(SERIES_PAD_RATIO_ENV, DEFAULT_SERIES_PAD_RATIO)
    return value if value and value > 1.0 else DEFAULT_SERIES_PAD_RATIO


def sample_pad_ratio() -> float:
    """The packed strategy's dense sample axis' ratio:
    ``GORDO_TPU_PLAN_PAD_RATIO`` when it is above 1, else 1.25."""
    value = env_float(SAMPLE_PAD_RATIO_ENV, DEFAULT_SAMPLE_PAD_RATIO)
    return value if value and value > 1.0 else DEFAULT_SAMPLE_PAD_RATIO
