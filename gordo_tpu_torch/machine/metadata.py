"""
Build metadata, the part of ``gordo_tpu/machine/metadata.py`` a fleet
build writes: the training summary of a fit's history
(``TrainingSummaryMetadata.from_history``, ``metadata.py:29-70``) and the
drift baseline of the raw input rows. The rest of the tree is plain
dicts with the JAX artifact's keys (``parallel/fleet_build.py``).
"""

import warnings
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np


@dataclass
class TrainingSummaryMetadata:
    """A fit's final/best losses, epochs run against epochs configured,
    and the epoch early stopping cut in at (None when it ran them all)."""

    final_loss: Optional[float] = None
    best_loss: Optional[float] = None
    final_val_loss: Optional[float] = None
    best_val_loss: Optional[float] = None
    epochs_run: int = 0
    epochs_configured: int = 0
    early_stop_epoch: Optional[int] = None

    @classmethod
    def from_history(cls, history) -> "TrainingSummaryMetadata":
        """Summarize a Keras-History-shaped record (``.history`` dict of
        loss lists, ``.params`` dict, ``.epoch`` list)."""
        losses = [float(v) for v in history.history.get("loss") or []]
        val = [float(v) for v in history.history.get("val_loss") or []]
        epochs_run = len(history.epoch)
        configured = int(history.params.get("epochs", epochs_run) or epochs_run)
        return cls(
            final_loss=losses[-1] if losses else None,
            best_loss=min(losses) if losses else None,
            final_val_loss=val[-1] if val else None,
            best_val_loss=min(val) if val else None,
            epochs_run=epochs_run,
            epochs_configured=configured,
            early_stop_epoch=epochs_run if epochs_run < configured else None,
        )

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def drift_baseline(X: np.ndarray, tags: Sequence[str]) -> Dict[str, Any]:
    """Per-tag NaN-aware means and standard deviations of the raw input
    rows, rounded to 8 digits, and their count (``DriftBaselineMetadata``)."""
    values = np.asarray(X, np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns stay NaN
        means = np.nanmean(values, axis=0)
        stds = np.nanstd(values, axis=0)
    return {
        "tags": [str(t) for t in tags],
        "feature_means": [round(float(v), 8) for v in means],
        "feature_stds": [round(float(v), 8) for v in stds],
        "n_samples": int(len(values)),
    }
