"""
The serve ladders, a copy of ``gordo_tpu/planner/ladder.py``'s rungs
(``gordo_tpu/serve/ladder.py`` re-exports them there).

The serving engine pads each request's rows up the row ladder
(:func:`row_ladder`, :func:`pad_to`): the rung decides which requests
share a batch, and a request taller than the top rung is served
unbatched. The member ladder (:func:`member_ladder`) is the JAX engine's
bound on its compile cache; the port launches exactly the live members
and reports the padded count beside them. The streaming plane snaps a
multi-window backlog onto a row rung (:func:`snap_rows`), so a backlog
flush scores the row counts the request plane batches into.
"""

import logging
import os
from typing import Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: default row-count rungs, factor-4 geometric
DEFAULT_ROW_LADDER: Tuple[int, ...] = (32, 128, 512, 2048, 8192)

ROW_LADDER_ENV = "GORDO_TPU_BATCH_ROW_LADDER"


def parse_ladder(text: str) -> Tuple[int, ...]:
    """A comma-separated rung list as a sorted, deduplicated tuple of
    positive ints; raises ``ValueError`` on anything else.

    >>> parse_ladder("128, 32,128")
    (32, 128)
    """
    rungs = sorted({int(part) for part in text.split(",") if part.strip()})
    if not rungs or rungs[0] <= 0:
        raise ValueError(f"ladder needs positive rungs, got {text!r}")
    return tuple(rungs)


def row_ladder() -> Tuple[int, ...]:
    """The configured row ladder (``GORDO_TPU_BATCH_ROW_LADDER``, else
    :data:`DEFAULT_ROW_LADDER`, also on a malformed value)."""
    raw = os.environ.get(ROW_LADDER_ENV)
    if raw:
        try:
            return parse_ladder(raw)
        except ValueError:
            logger.warning("Invalid %s=%r; using %r", ROW_LADDER_ENV, raw, DEFAULT_ROW_LADDER)
    return DEFAULT_ROW_LADDER


def member_ladder(max_size: int) -> Tuple[int, ...]:
    """Powers of two up to and including ``max_size`` rounded up to one.

    >>> member_ladder(5)
    (1, 2, 4, 8)
    """
    rungs = []
    rung = 1
    while rung < max_size:
        rungs.append(rung)
        rung <<= 1
    rungs.append(rung)
    return tuple(rungs)


def pad_to(n: int, ladder: Sequence[int]) -> Optional[int]:
    """The first rung ``>= n``, or None when ``n`` overflows the ladder.

    >>> pad_to(33, (32, 128)), pad_to(129, (32, 128))
    (128, None)
    """
    for rung in ladder:
        if n <= rung:
            return rung
    return None


def snap_rows(pending_rows: int, window_rows: int, ladder: Optional[Sequence[int]] = None) -> int:
    """The rows a stream cut takes from ``pending_rows`` buffered rows:
    the largest whole-window span that lands on a rung's whole-window
    capacity (``(rung // window_rows) * window_rows``). Below the smallest
    such size the whole backlog is taken; the remainder is whole windows
    that ride the next flush.

    >>> snap_rows(224, 32)
    128
    >>> snap_rows(96, 32)
    32
    >>> snap_rows(10, 5)
    10
    >>> snap_rows(3, 5)
    0
    """
    window_rows = int(window_rows)
    if window_rows <= 0:
        return 0
    whole = (int(pending_rows) // window_rows) * window_rows
    if whole <= 0:
        return 0
    rungs = ladder if ladder is not None else row_ladder()
    best = 0
    for rung in rungs:
        aligned = (int(rung) // window_rows) * window_rows
        if 0 < aligned <= whole and aligned > best:
            best = aligned
    return best or whole
