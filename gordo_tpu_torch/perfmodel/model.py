"""
The regressor (``gordo_tpu/perfmodel/model.py``): closed-form ridge in log
space, in pure Python.

Each ``(target, program)`` population gets ``log(y) = intercept + coef .
features``: a program's cost is near-multiplicative in its shape, so 7
coefficients fit it without an iterative solver. A small L2 term on the
non-intercept coefficients keeps the normal equations solvable when the
corpus exercised one rung of an axis only.

The solve is Gaussian elimination with partial pivoting, operation for
operation the JAX package's: a LAPACK solve differs in the last bits,
which would move promotions that sit on the 1e-6 margin
(``service._PROMOTE_MARGIN``). It is host arithmetic on a few dozen rows.

- :func:`holdout_split` carves a deterministic ~25% holdout before the
  fit: every error this package reports is holdout error;
- :func:`fit_section` refuses populations under the
  ``GORDO_TPU_PERFMODEL_MIN_SAMPLES`` floor (default 32);
- :func:`analytic_prediction` replays the analytic model on the same
  feature vector, so the gate compares like with like. ``hbm_bytes`` has
  no such replay (its formula needs the spec's geometry): its baseline is
  the training median.
"""

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..planner.costmodel import _TRAIN_FLOP_FACTOR, LEARNED_FEATURES, LEARNED_VERSION, CostTable
from ..utils.env import env_int
from .features import TrainingRow

#: the floor under a measurement before its log (ms or bytes)
_EPS = 1e-9
#: the L2 strength on the non-intercept coefficients
_DEFAULT_L2 = 1e-3

MIN_SAMPLES_ENV = "GORDO_TPU_PERFMODEL_MIN_SAMPLES"


def fit_ridge(xs: Sequence[Sequence[float]], ys: Sequence[float], l2: float = _DEFAULT_L2) -> List[float]:
    """``[intercept, w_1..w_d]`` minimizing ``sum (intercept + w.x - y)^2 +
    l2 |w|^2`` (the intercept unpenalized), from the normal equations.

    >>> [round(c, 6) for c in fit_ridge([[0.0], [1.0], [2.0]], [1.0, 3.0, 5.0], l2=0.0)]
    [1.0, 2.0]
    """
    if not xs:
        raise ValueError("cannot fit on an empty sample set")
    d = len(xs[0]) + 1  # the intercept's column first
    a = [[0.0] * d for _ in range(d)]
    b = [0.0] * d
    for x, y in zip(xs, ys):
        row = (1.0, *x)
        for i in range(d):
            b[i] += row[i] * y
            for j in range(d):
                a[i][j] += row[i] * row[j]
    for i in range(1, d):
        a[i][i] += float(l2)
    for col in range(d):
        pivot = max(range(col, d), key=lambda r: abs(a[r][col]))
        if abs(a[pivot][col]) < 1e-12:
            raise ValueError("singular design matrix (raise l2)")
        if pivot != col:
            a[col], a[pivot] = a[pivot], a[col]
            b[col], b[pivot] = b[pivot], b[col]
        inv = 1.0 / a[col][col]
        for r in range(col + 1, d):
            f = a[r][col] * inv
            if f == 0.0:
                continue
            for c in range(col, d):
                a[r][c] -= f * a[col][c]
            b[r] -= f * b[col]
    coef = [0.0] * d
    for i in range(d - 1, -1, -1):
        acc = b[i] - sum(a[i][j] * coef[j] for j in range(i + 1, d))
        coef[i] = acc / a[i][i]
    return coef


def holdout_split(rows: Sequence[TrainingRow]) -> Tuple[List[TrainingRow], List[TrainingRow]]:
    """``(train, holdout)``: the rows sorted by value, every 4th held out
    (a stride over the sorted population spreads the holdout over the
    shapes); a population too small for that still holds one out."""
    ordered = sorted(rows)
    train: List[TrainingRow] = []
    holdout: List[TrainingRow] = []
    for index, row in enumerate(ordered):
        (holdout if index % 4 == 3 else train).append(row)
    if not holdout and len(train) > 1:
        holdout.append(train.pop())
    return train, holdout


def evaluate_rows(rows: Sequence[TrainingRow],
                  predict: Callable[[TrainingRow], Optional[float]]) -> Tuple[float, int]:
    """``(mae_log, n_scored)``: the mean absolute error in log space over
    the rows ``predict`` answered with a positive value (0.1 is about 10%
    either way, in ms or bytes alike); ``(inf, 0)`` when it answered none."""
    total, n = 0.0, 0
    for row in rows:
        pred = predict(row)
        if pred is None or pred <= 0.0:
            continue
        total += abs(math.log(pred + _EPS) - math.log(max(row.y, 0.0) + _EPS))
        n += 1
    return (total / n, n) if n else (math.inf, 0)


def coef_predict(coef: Sequence[float], features: Sequence[float]) -> float:
    """``exp(intercept + coef.x)``: ``CostTable.learned_predict``'s
    arithmetic without its domain box (a holdout scores every row)."""
    return math.exp(float(coef[0]) + sum(float(c) * float(x) for c, x in zip(coef[1:], features)))


def _shape_from_features(features: Sequence[float]) -> Tuple[float, float, float, float, str]:
    """``(flops_per_sample, members, rows, epochs, precision)`` back from a
    ``learned_feature_vector``."""
    flops = math.exp(features[0]) - 1.0
    members = math.exp(features[1])
    rows = math.exp(features[2])
    epochs = math.exp(features[3])
    precision = "bf16" if features[4] >= 0.5 else "int8" if features[5] >= 0.5 else "f32"
    return flops, members, rows, epochs, precision


def analytic_prediction(table: CostTable, target: str, program: str,
                        features: Sequence[float]) -> Optional[float]:
    """What ``table``'s analytic model (its constants and factors, no
    learned section) predicts for a feature vector, in the target's unit;
    None for ``hbm_bytes``."""
    flops, members, rows, epochs, precision = _shape_from_features(features)
    if target == "device_ms":
        if program == "fleet_forward":
            total_flops = flops * members * rows
        else:
            total_flops = _TRAIN_FLOP_FACTOR * flops * members * rows * max(epochs, 1.0)
        factor = table.run_factors.get(program, 1.0) * table.precision_factor(precision)
        return (factor * (total_flops / table.throughput) + table.dispatch_s) * 1000.0
    if target == "compile_ms":
        factor = table.compile_factors.get(program, 1.0)
        return (factor * (table.compile_floor_s + table.compile_per_flop * flops)) * 1000.0
    return None


def min_samples_floor(override: Optional[int] = None) -> int:
    """The smallest population :func:`fit_section` fits (at least 2)."""
    if override is not None:
        return max(int(override), 2)
    return max(env_int(MIN_SAMPLES_ENV, 32), 2)


def fit_section(rows: Sequence[TrainingRow], min_samples: Optional[int] = None,
                l2: float = _DEFAULT_L2) -> Optional[dict]:
    """The ``learned`` section (``CostTable.from_dict``'s schema) of every
    ``(target, program)`` population of ``rows`` over the sample floor, each
    with its coefficients, its training box (``lo``, ``hi``), ``n`` and
    ``holdout_mae_log``; ``skipped`` names the rest. None when no population
    qualifies: the caller keeps its table as it is."""
    floor = min_samples_floor(min_samples)
    populations: Dict[Tuple[str, str], List[TrainingRow]] = {}
    for row in rows:
        populations.setdefault((row.target, row.program), []).append(row)
    targets: Dict[str, Dict[str, dict]] = {}
    skipped: Dict[str, int] = {}
    for (target, program), population in sorted(populations.items()):
        if len(population) < floor:
            skipped[f"{target}/{program}"] = len(population)
            continue
        train, holdout = holdout_split(population)
        try:
            coef = fit_ridge([r.features for r in train], [math.log(max(r.y, 0.0) + _EPS) for r in train], l2=l2)
        except ValueError:
            skipped[f"{target}/{program}"] = len(population)
            continue
        width = len(LEARNED_FEATURES)
        lo = [min(r.features[i] for r in train) for i in range(width)]
        hi = [max(r.features[i] for r in train) for i in range(width)]
        mae, _ = evaluate_rows(holdout, lambda r: coef_predict(coef, r.features))
        if not math.isfinite(mae):
            skipped[f"{target}/{program}"] = len(population)
            continue
        targets.setdefault(target, {})[program] = {
            "coef": [round(c, 10) for c in coef],
            "lo": [round(v, 6) for v in lo],
            "hi": [round(v, 6) for v in hi],
            "n": len(population),
            "holdout_mae_log": round(mae, 6),
        }
    if not targets:
        return None
    return {
        "version": LEARNED_VERSION,
        "features": list(LEARNED_FEATURES),
        "targets": targets,
        "skipped": dict(sorted(skipped.items())),
    }
