"""
The scikit-learn splitters and shuffles a fleet build uses, in numpy:

- :class:`TimeSeriesSplit`, ``sklearn.model_selection.TimeSeriesSplit``
  with its defaults (no gap, no train cap): the build's default CV of 3
  folds (``gordo_tpu/parallel/fleet_build.py:1445-1451``);
- :func:`shuffle_indices`, the row order of
  ``sklearn.utils.shuffle(np.arange(n), random_state=seed)``, which a
  ``DiffBasedAnomalyDetector(shuffle=True)`` trains in
  (``fleet_build.py:1286-1295``): ``RandomState(seed).shuffle`` of
  ``arange(n)``;
- :class:`KFold`, ``sklearn.model_selection.KFold``: the
  ``DiffBasedKFCVAnomalyDetector``'s CV, ``KFold(5, shuffle=True,
  random_state=0)`` (``fleet_build.py:1445-1447``);
- :func:`cross_validate`, ``sklearn.model_selection.cross_validate`` as
  the sequential ``ModelBuilder`` calls it: a clone of the estimator
  fitted on each fold's train rows, one fold after another, and scored
  on its test rows.
"""

import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from .preprocessing import clone


class TimeSeriesSplit:
    """Expanding-window folds: fold ``k`` trains on every row before its
    test block of ``n // (n_splits + 1)`` rows.

    >>> [(len(tr), int(te[0]), int(te[-1])) for tr, te in TimeSeriesSplit(3).split(np.zeros((10, 1)))]
    [(4, 4, 5), (6, 6, 7), (8, 8, 9)]
    """

    def __init__(self, n_splits: int = 3):
        self.n_splits = int(n_splits)

    def split(self, X) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        n_folds = self.n_splits + 1
        test_size = n_samples // n_folds
        if n_folds > n_samples:
            raise ValueError(
                f"Cannot have number of folds={n_folds} greater than the number of samples={n_samples}."
            )
        if n_samples - test_size * self.n_splits <= 0:
            raise ValueError(
                f"Too many splits={self.n_splits} for number of samples={n_samples} with test_size={test_size}."
            )
        indices = np.arange(n_samples)
        for test_start in range(n_samples - self.n_splits * test_size, n_samples, test_size):
            yield indices[:test_start], indices[test_start:test_start + test_size]


def shuffle_indices(n: int, random_state: int = 0) -> np.ndarray:
    """``sklearn.utils.shuffle(np.arange(n), random_state=random_state)``.

    >>> shuffle_indices(5).tolist()
    [2, 0, 1, 3, 4]
    """
    indices = np.arange(n)
    np.random.RandomState(random_state).shuffle(indices)
    return indices


class KFold:
    """
    ``sklearn.model_selection.KFold``: the rows (shuffled once by
    ``RandomState(random_state)`` when ``shuffle``) cut into ``n_splits``
    folds of ``n // n_splits`` rows, one more for each of the first
    ``n % n_splits``. scikit-learn yields both sides through a boolean
    mask, so a fold's test rows come sorted, as its train rows do.

    >>> [(tr.tolist(), te.tolist()) for tr, te in KFold(3).split(np.zeros((5, 1)))]
    [([2, 3, 4], [0, 1]), ([0, 1, 4], [2, 3]), ([0, 1, 2, 3], [4])]
    """

    def __init__(self, n_splits: int = 5, shuffle: bool = False, random_state=None):
        if int(n_splits) < 2:
            raise ValueError(f"k-fold cross-validation needs at least two splits, got n_splits={n_splits}")
        if not shuffle and random_state is not None:
            raise ValueError("Setting a random_state has no effect since shuffle is False")
        self.n_splits, self.shuffle, self.random_state = int(n_splits), bool(shuffle), random_state

    def split(self, X) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        if self.n_splits > n_samples:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} greater than the number of samples: "
                f"n_samples={n_samples}."
            )
        indices = np.arange(n_samples)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(indices)
        sizes = np.full(self.n_splits, n_samples // self.n_splits, dtype=int)
        sizes[: n_samples % self.n_splits] += 1
        current = 0
        for size in sizes:
            test = indices[current: current + size]
            mask = np.zeros(n_samples, bool)
            mask[test] = True
            yield np.flatnonzero(~mask), np.flatnonzero(mask)
            current += size


#: a scorer of :func:`cross_validate`: ``(y_true, y_pred) -> float``
Scorer = Callable[[np.ndarray, np.ndarray], float]


def cross_validate(
    estimator: Any,
    X,
    y,
    scoring: Optional[Mapping[str, Scorer]] = None,
    cv: Any = None,
    return_estimator: bool = False,
    return_indices: bool = False,
    return_predictions: bool = False,
    fit_params: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """
    ``sklearn.model_selection.cross_validate`` with its keys: for each fold
    of ``cv`` (default ``KFold(5)``), a :func:`~.preprocessing.clone` of
    ``estimator`` fitted on the fold's train rows (``fit_params`` go to
    its ``fit``), its ``predict`` on the test rows, and each scorer of
    ``scoring`` on ``(y_test, prediction)``; ``fit_time``,
    ``score_time`` (seconds) and ``test_<name>`` arrays, and with
    ``return_estimator`` the fitted clones, with ``return_indices`` the
    ``{"train": [...], "test": [...]}`` rows. A scorer takes the targets
    and the prediction rather than scikit-learn's ``(estimator, X, y)``,
    so one ``predict`` a fold serves them all; ``return_predictions``
    keeps those predictions (``predictions``) for a caller that needs
    them too.
    """
    X, y = np.asarray(X), np.asarray(y)
    cv = cv if cv is not None else KFold(n_splits=5)
    scoring = dict(scoring or {})
    out: Dict[str, Any] = {"fit_time": [], "score_time": [], **{f"test_{name}": [] for name in scoring}}
    estimators, indices, predictions = [], {"train": [], "test": []}, []
    for train, test in cv.split(X):
        fold = clone(estimator)
        start = time.time()
        fold.fit(X[train], y[train], **(fit_params or {}))
        out["fit_time"].append(time.time() - start)
        start = time.time()
        y_pred = fold.predict(X[test])
        for name, scorer in scoring.items():
            out[f"test_{name}"].append(scorer(y[test], y_pred))
        out["score_time"].append(time.time() - start)
        estimators.append(fold)
        indices["train"].append(train)
        indices["test"].append(test)
        predictions.append(y_pred)
    out = {key: np.asarray(values, np.float64) for key, values in out.items()}
    if return_estimator:
        out["estimator"] = estimators
    if return_indices:
        out["indices"] = indices
    if return_predictions:
        out["predictions"] = predictions
    return out
