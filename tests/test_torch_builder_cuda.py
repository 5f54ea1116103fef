"""The sequential build on the card against the same on the CPU: a
feedforward detector at 20 tags (K1's narrow kernel) and at 40 (the wide
one), and an LSTM detector. Each fold's ``predict`` launches K1 once and
the LSTM's none; the card's params, thresholds and CV scores agree with
the CPU's within limits read by ``scripts/build_tolerance.py
sequential``.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_builder_cuda.py

Limits, TF32 off: ``chip_smoke.py``'s ``SEQUENTIAL_BUILD_LIMITS``, one set
for the sequential path (params max abs, thresholds max rel, CV scores
max |d| / (1 + |cpu|)), read by ``scripts/build_tolerance.py sequential``
on these builds and ``[sequential]``'s; the readings stand beside the
constant.
"""

import sys
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import SEQUENTIAL_BUILD_LIMITS  # noqa: E402

PARAM_ATOL, THRESHOLD_RTOL, SCORE_TOL = SEQUENTIAL_BUILD_LIMITS
ROWS = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _machine(kind, n_tags, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(ROWS)[:, None]
    X = rng.uniform(20, 80, n_tags) + 5 * np.sin(2 * np.pi * t / 144 + rng.uniform(0, 6, n_tags)) \
        + rng.standard_normal((ROWS, n_tags))
    estimator = ({"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 3}}
                 if kind == "feedforward" else
                 {"gordo_tpu.models.estimators.JaxLSTMAutoEncoder": {"kind": "lstm_hourglass", "lookback_window": 10,
                                                                     "epochs": 2}})
    model = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", estimator]}}}}
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    return Machine.from_config(
        {"name": f"{kind}-{n_tags}", "model": model, "dataset": {"tag_list": [f"tag-{i}" for i in range(n_tags)]}},
        "card-test", data=(X, None), index=[start + timedelta(minutes=10 * r) for r in range(ROWS)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_tags,launches", [("feedforward", 20, 3), ("feedforward", 40, 3), ("lstm", 20, 0)],
                         ids=["narrow", "wide", "lstm"])
def test_sequential_build_on_card_matches_cpu(cuda, kind, n_tags, launches):
    fleet_feedforward.launches = 0
    card, card_machine = ModelBuilder(_machine(kind, n_tags, n_tags), device=cuda).build()
    torch.cuda.synchronize()
    assert fleet_feedforward.launches == launches
    cpu, cpu_machine = ModelBuilder(_machine(kind, n_tags, n_tags), device="cpu").build()
    for key, layer in cpu.base_estimator.estimator.params_.items():
        for leaf, value in layer.items():
            got = card.base_estimator.estimator.params_[key][leaf].cpu().numpy()
            assert np.abs(got - value.numpy()).max() <= PARAM_ATOL, f"{key}/{leaf}"
    for got, want in ((card.feature_thresholds_, cpu.feature_thresholds_),
                      (card.aggregate_threshold_, cpu.aggregate_threshold_)):
        np.testing.assert_allclose(got, want, rtol=THRESHOLD_RTOL)
    scores = card_machine.metadata["build_metadata"]["model"]["cross_validation"]["scores"]
    cpu_scores = cpu_machine.metadata["build_metadata"]["model"]["cross_validation"]["scores"]
    assert list(scores) == list(cpu_scores)
    for key, folds in cpu_scores.items():
        want = np.array(list(folds.values()))
        got = np.array(list(scores[key].values()))
        assert (np.abs(got - want) / (1 + np.abs(want))).max() <= SCORE_TOL, key
    offset = card_machine.metadata["build_metadata"]["model"]["model_offset"]
    assert offset == cpu_machine.metadata["build_metadata"]["model"]["model_offset"] == (9 if kind == "lstm" else 0)
