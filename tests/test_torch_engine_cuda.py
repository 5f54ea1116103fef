"""The serving engine on the card: its gather forward at coalesced shapes
against K1's plain version, the bf16 and int8 forwards on the card against
their CPU runs, and an app whose concurrent requests coalesce into one K1
launch that answers what the CPU app answers.

Every test here needs an NVIDIA GPU; on a machine without one each skips.
The file imports neither JAX nor the JAX package, so it runs on the card's
machine (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_engine_cuda.py

Tolerance: rtol 1e-5, atol 1e-5 for f32 (sums in another order on the
card). The reduced forwards: within CARD_VS_CPU_ULPS bf16 ulps of their
CPU runs and further than that from f32 on the card, and at the parity
gate's own tolerances (``serve/precision.py``: rtol 0.05, atol 0.01,
every row).
"""

import json
import threading

import numpy as np
import pytest
import torch

from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.nn import init_feedforward
from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference
from gordo_tpu_torch.parallel.fleet import stack_member_params
from gordo_tpu_torch.serve import precision
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.fleet_store import fleet_forward_gather

from tests.test_torch_serving_cuda import _post, collection  # noqa: F401 - the fixture is used by name

#: the coalesced shapes: (tags, bucket members, batch members, rows)
SHAPES = {"narrow": (20, 48, 32, 2048), "wide": (40, 12, 8, 2048)}


#: the reduced forwards on the card against the same on the CPU, in bf16
#: ulps (``bf16_ulps``): each layer's sums run in another order (cuBLAS may
#: reduce in bf16) before their rounding to bf16. Readings on an H100,
#: card against CPU / f32 against the reduced output on the card: narrow
#: bf16 51.9 / 329.9, int8 36.0 / 468.5; wide bf16 28.0 / 363.1, int8
#: 25.5 / 450.3. The limit sits 2.5x above the largest reading and 2.6x
#: below the smallest f32 gap, so a forward run in f32 fails it.
CARD_VS_CPU_ULPS = 128.0


def bf16_ulps(a, b):
    """``|a - b|`` in bf16 ulps of the larger magnitude (floored at 2**-8,
    so values near zero are judged at that scale)."""
    magnitude = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0**-8)
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(magnitude)) - 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(width, n, m, rows, device):
    spec = feedforward_hourglass(width)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(i)) for i in range(n)], device)
    rng = np.random.default_rng(width)
    X = torch.from_numpy(rng.random((m, rows, width), dtype=np.float32) * 40 + 10).to(device)
    ingest = tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                   for a in (1 / (40 + rng.random((n, width))), rng.random((n, width)) * -0.25))
    indices = rng.choice(n, m, replace=False).tolist()
    return spec, bucket, X, indices, ingest


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_engine_gather_on_card_matches_plain(cuda, shape):
    spec, bucket, X, indices, ingest = _batch(*SHAPES[shape], cuda)
    launches = fleet_feedforward.launches
    got = fleet_forward_gather(spec, bucket, indices, X, ingest=ingest)
    assert fleet_feedforward.launches == launches + 1
    expected = fleet_feedforward_reference(spec, bucket, X, indices, ingest)
    np.testing.assert_allclose(got.cpu().numpy(), expected.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["bf16", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_reduced_forwards_on_card_match_cpu(cuda, shape, prec):
    spec, bucket, X, indices, ingest = _batch(*SHAPES[shape], cuda)
    cast = precision.cast_bucket_params(bucket, prec)
    on_card = fleet_forward_gather(spec, cast, indices, X, ingest=ingest, precision=prec).cpu().numpy()
    cpu = lambda tree: {k: {n: t.cpu() for n, t in layer.items()} for k, layer in tree.items()}  # noqa: E731
    on_cpu = fleet_forward_gather(spec, cpu(cast), indices, X.cpu(), ingest=tuple(t.cpu() for t in ingest),
                                  precision=prec).numpy()
    f32 = fleet_forward_gather(spec, bucket, indices, X, ingest=ingest).cpu().numpy()
    assert on_card.dtype == np.float32
    gap, reduced = bf16_ulps(on_card, on_cpu).max(), bf16_ulps(f32, on_card).max()
    print(f"{shape} {prec}: card against CPU {gap} bf16 ulps, f32 against {prec} on the card {reduced}")
    assert gap <= CARD_VS_CPU_ULPS
    assert reduced > CARD_VS_CPU_ULPS
    config = precision.ParityConfig()
    assert precision.recon_agreement(on_cpu, on_card, rtol=config.rtol, atol=config.atol)["agreement"] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", ["narrow-", "wide-"])
def test_coalesced_requests_are_one_launch(cuda, collection, prefix, monkeypatch):  # noqa: F811
    """Two clients of one bucket: one batch, one K1 launch, the CPU app's answers."""
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    width = 20 if prefix == "narrow-" else 40
    rng = np.random.RandomState(width)
    keys = [f"2020-03-01T{r // 6:02d}:{r % 6}0:00+00:00" for r in range(100)]
    payloads = [{"X": {f"t-{j:02d}": dict(zip(keys, (rng.rand(100) * 40 + 10).tolist())) for j in range(width)}}
                for _ in range(2)]
    paths = [f"/gordo/v0/card/{prefix}{i}/prediction" for i in range(2)]
    config = ServeConfig(max_size=2, max_delay_ms=20000.0, deadline_ms=40000.0, row_ladder=(128,))
    card_app, cpu_app = build_app(collection, device=cuda, serve_config=config), build_app(collection, device="cpu")
    try:
        launches = fleet_feedforward.launches
        answers = [None, None]
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, _post(card_app, paths[i], payloads[i])))
                   for i in range(2)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
        assert fleet_feedforward.launches == launches + 1
        assert card_app.engine.stats()["batches"] == 1
        for path, body, (status, got) in zip(paths, payloads, answers):
            cpu_status, expected = _post(cpu_app, path, body)
            assert status == cpu_status == 200
            for tag, column in expected["data"]["model-output"].items():
                np.testing.assert_allclose(list(got["data"]["model-output"][tag].values()), list(column.values()),
                                           rtol=1e-5, atol=1e-5)
        assert json.dumps(got["data"]["model-input"]) == json.dumps(expected["data"]["model-input"])
    finally:
        card_app.shutdown()
