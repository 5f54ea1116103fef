"""The definitions of ``tests/test_torch_definitions.py`` on the card: a
``device="cuda"`` app answers what the same app on the CPU answers for a
``StandardScaler`` / ``RobustScaler`` detector (K1 with the ingest
prologue) and two non-affine ones (``InfImputer`` →
``FunctionTransformer(multiply_by)`` → clipping ``MinMaxScaler``: K1 and
K2 without the prologue, on host-transformed rows, K2's ``y`` the raw
rows), one kernel launch a request and a bucket; and a host-loop fit
(``ReduceLROnPlateau``, ``EarlyStopping``) on the card runs the epochs and
learning rates of the same fit on the CPU.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package::

    python -m pytest --noconftest -q -m cuda tests/test_torch_definitions_cuda.py

Tolerance: answers rtol 1e-5, atol 1e-5 (f32 sums in another order on
the card); the fit's params atol 1e-5, its losses rtol 1e-5.
"""

import io
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from gordo_tpu_torch import serializer
from gordo_tpu_torch.models import callbacks
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimators import TorchAutoEncoder
from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.nn import init_feedforward, params_to_numpy
from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
from gordo_tpu_torch.server import build_app

TAGS = 20
MULTIPLY_BY = "gordo_tpu.models.transformer_funcs.general.multiply_by"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _detector(spec, seed, pipeline, scaler):
    params = params_to_numpy(init_feedforward(spec, torch.Generator().manual_seed(seed)))
    return DiffBasedAnomalyDetector.from_state({"spec": spec.to_dict(), "params": params, "pipeline": pipeline,
                                                "scaler": scaler, "feature_thresholds": [1.0] * TAGS,
                                                "aggregate_threshold": 1.0}, device="cpu")


@pytest.fixture
def collection(tmp_path):
    rng = np.random.RandomState(0)
    standard = {"type": "StandardScaler", "mean_": rng.rand(TAGS) * 50, "scale_": rng.rand(TAGS) * 10 + 1,
                "var_": np.ones(TAGS), "n_samples_seen_": 100}
    robust = {"type": "RobustScaler", "center_": rng.rand(TAGS) * 50, "scale_": rng.rand(TAGS) * 10 + 1}
    non_affine = [
        {"type": "InfImputer", "_fill_values": np.full(TAGS, 90.0), "_neg_fill_values": np.full(TAGS, 10.0)},
        {"type": "FunctionTransformer", "func": MULTIPLY_BY, "kw_args": {"factor": 2}},
        {"type": "MinMaxScaler", "clip": True, "scale_": np.full(TAGS, 1 / 120), "min_": np.full(TAGS, -0.5)},
    ]
    models = {
        "standard": _detector(feedforward_hourglass(TAGS, encoding_layers=2), 1, [standard], robust),
        "non-affine-0": _detector(feedforward_hourglass(TAGS), 2, non_affine, standard),
        "non-affine-1": _detector(feedforward_hourglass(TAGS), 3, non_affine, robust),
    }
    tags = [f"t-{j:02d}" for j in range(TAGS)]
    for name, model in models.items():
        serializer.dump(model, str(tmp_path / name), {"name": name, "dataset": {"tag_list": tags,
                                                                              "resolution": "10min"}})
    return str(tmp_path)


def _frame(seed, rows=200):
    start = datetime(2020, 3, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(rows)]
    values = np.random.RandomState(seed).rand(rows, TAGS) * 60 + 20
    return {f"t-{j:02d}": dict(zip(keys, values[:, j].tolist())) for j in range(TAGS)}


def _post(app, path, payload):
    body = json.dumps(payload).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path, "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": "application/json", "wsgi.input": io.BytesIO(body)}
    status = []
    chunks = app(environ, lambda s, h: status.append(int(s.split()[0])))
    return status[0], json.loads(b"".join(chunks))


def _close(expected, got, path="data"):
    if isinstance(expected, dict):
        assert list(got) == list(expected), path
        for key in expected:
            _close(expected[key], got[key], f"{path}/{key}")
    elif isinstance(expected, float):
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5, err_msg=path)
    else:
        assert got == expected, path


@pytest.mark.cuda
def test_new_definitions_serve_on_card_as_on_cpu(cuda, collection):
    card_app, cpu_app = build_app(collection, device=cuda), build_app(collection, device="cpu")
    for i, name in enumerate(("standard", "non-affine-0", "non-affine-1")):
        frame = _frame(i)
        k1 = fleet_feedforward.launches
        status, body = _post(card_app, f"/gordo/v0/card/{name}/anomaly/prediction", {"X": frame, "y": frame})
        assert fleet_feedforward.launches == k1 + 1
        cpu_status, expected = _post(cpu_app, f"/gordo/v0/card/{name}/anomaly/prediction", {"X": frame, "y": frame})
        assert status == cpu_status == 200
        _close(expected["data"], body["data"])
    fleet = card_app.store.fleet()
    spec = fleet.loaded_specs()["non-affine-0"]
    assert fleet.host_transformed(spec) and fleet.ingest_plan(spec) is None
    assert fleet.ingest_plan(fleet.loaded_specs()["standard"]) is not None
    payload = {"X": {name: _frame(10 + i) for i, name in enumerate(("standard", "non-affine-0", "non-affine-1"))}}
    k2 = fleet_anomaly_scores.launches
    status, body = _post(card_app, "/gordo/v0/card/prediction/fleet", payload)
    assert fleet_anomaly_scores.launches == k2 + 2  # one a bucket
    cpu_status, expected = _post(cpu_app, "/gordo/v0/card/prediction/fleet", payload)
    assert status == cpu_status == 200
    _close(expected["data"], body["data"])


@pytest.mark.cuda
def test_host_loop_on_card_matches_cpu(cuda):
    X = np.random.RandomState(1).rand(300, TAGS).astype(np.float32)
    fits = {}
    for device in (cuda, "cpu"):
        recorder = _Recorder()
        cbs = [callbacks.EarlyStopping(monitor="loss", patience=2, min_delta=0.004),
               callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1, min_delta=0.01), recorder]
        model = TorchAutoEncoder(device=device, kind="feedforward_hourglass", epochs=20, batch_size=32, seed=3,
                                 callbacks=cbs).fit(X, X)
        fits[str(device)] = model, recorder.lrs
    (card, card_lrs), (cpu, cpu_lrs) = fits["cuda"], fits["cpu"]
    assert card.history.epoch == cpu.history.epoch and card_lrs == cpu_lrs
    assert len(set(cpu_lrs)) >= 2
    np.testing.assert_allclose(card.history.history["loss"], cpu.history.history["loss"], rtol=1e-5)
    for key, layer in cpu.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(card.params_[key][leaf].cpu().numpy(), value.numpy(), atol=1e-5)


class _Recorder(callbacks.Callback):
    def __init__(self):
        self.lrs = []

    def on_epoch_end(self, epoch, logs=None):
        self.lrs.append(logs["lr"])
        return False
