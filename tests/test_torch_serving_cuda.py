"""The per-model prediction route on the card: ``POST .../<name>/prediction``
on a ``device="cuda"`` app answers what the same app on the CPU answers,
at 20 tags (K1's narrow kernel) and 40 tags (its wide kernel), and each
request is one K1 launch.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_serving_cuda.py

Tolerance: rtol 1e-5, atol 1e-5 (f32 sums in another order on the card).
"""

import io
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.nn import init_feedforward, params_to_numpy
from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
from gordo_tpu_torch.server import build_app

WIDTHS = {"narrow-": 20, "wide-": 40}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def collection(tmp_path):
    """Two detectors of each width (MinMax pipeline, random seeded params)."""
    rng = np.random.RandomState(0)
    for prefix, width in WIDTHS.items():
        spec = feedforward_hourglass(width)
        for i in range(2):
            scaler = {"scale_": rng.rand(width) + 0.5, "min_": rng.rand(width) - 0.5}
            detector = DiffBasedAnomalyDetector.from_state(
                {"spec": spec.to_dict(), "params": params_to_numpy(init_feedforward(spec, torch.Generator().manual_seed(i))),
                 "pipeline": [scaler], "scaler": scaler},
                device="cpu",
            )
            tags = [f"t-{j:02d}" for j in range(width)]
            serializer.dump(detector, str(tmp_path / f"{prefix}{i}"),
                            {"name": f"{prefix}{i}", "dataset": {"tag_list": tags, "resolution": "10min"}})
    return str(tmp_path)


def _post(app, path, payload):
    body = json.dumps(payload).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path, "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": "application/json", "wsgi.input": io.BytesIO(body)}
    status = []
    chunks = app(environ, lambda s, h: status.append(int(s.split()[0])))
    return status[0], json.loads(b"".join(chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", list(WIDTHS), ids=["narrow", "wide"])
def test_prediction_route_on_card_matches_cpu(cuda, collection, prefix):
    width = WIDTHS[prefix]
    start = datetime(2020, 3, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(300)]
    values = np.random.RandomState(width).rand(300, width) * 40 + 10
    X = {f"t-{j:02d}": dict(zip(keys, values[:, j].tolist())) for j in range(width)}
    path = f"/gordo/v0/card/{prefix}1/prediction"
    card_app, cpu_app = build_app(collection, device=cuda), build_app(collection, device="cpu")
    launches = fleet_feedforward.launches
    status, body = _post(card_app, path, {"X": X})
    assert fleet_feedforward.launches == launches + 1
    cpu_status, expected = _post(cpu_app, path, {"X": X})
    assert status == cpu_status == 200
    assert list(body) == list(expected) == ["data", "revision"]
    for tag, column in expected["data"]["model-output"].items():
        np.testing.assert_allclose(list(body["data"]["model-output"][tag].values()), list(column.values()),
                                   rtol=1e-5, atol=1e-5)
    assert body["data"]["model-input"] == expected["data"]["model-input"]
