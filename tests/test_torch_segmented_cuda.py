"""The segmented LSTM fit on the card against the same on the CPU, and
against the windowed fit at one window a segment; the Arrow wire format
on a card app against the JSON answers of the same app.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_segmented_cuda.py

Tolerances, TF32 off, as ``tests/test_torch_lstm_cuda.py``'s fit: losses
rtol 1e-5, params atol 1e-4 after two epochs, card against CPU; at G = B
the segmented fit against the windowed one on the card within
``chip_smoke.py``'s ``LSTM_BUILD_LIMITS`` (params 1e-5, losses 3e-6
relative).
"""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from gordo_tpu_torch.models.factories import lstm_hourglass, lstm_model
from gordo_tpu_torch.models.nn import init_lstm
from gordo_tpu_torch.models.training import FitConfig, SegmentedFit, WindowedFit
from gordo_tpu_torch.parallel.fleet import stack_member_params

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(spec, members, rows, split=0.2):
    series = torch.from_numpy(np.random.RandomState(0).rand(members, rows, spec.n_features).astype(np.float32))
    targets = series[:, spec.lookback_window - 1:].contiguous()
    nw = targets.shape[1]
    nv = -(-nw // 32) * 32
    wtr, wval = torch.zeros(members, nv), torch.zeros(members, nv)
    n_val = int(nw * split)
    wtr[:, :nw - n_val], wval[:, nw - n_val:nw] = 1.0, 1.0
    init = [init_lstm(spec, torch.Generator().manual_seed(s)) for s in range(members)]
    return series, targets, wtr, wval, init


def _on(device, *tensors):
    return [t.to(device) for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [lstm_model(20, lookback_window=10),
                                  lstm_hourglass(20, lookback_window=10, encoding_layers=2)],
                         ids=["lstm_model", "lstm_hourglass"])
def test_segmented_fit_on_card_matches_cpu(cuda, spec):
    config = FitConfig(epochs=2, batch_size=32, validation_split=0.2, shuffle=False)
    series, targets, wtr, wval, init = _problem(spec, 3, 400)
    outs = [SegmentedFit(spec, config, 4).run(stack_member_params(init, device), *_on(device, series, targets, wtr,
                                                                                      wval))
            for device in ("cpu", cuda)]
    np.testing.assert_allclose(outs[1].losses.cpu().numpy(), outs[0].losses.numpy(), rtol=RTOL)
    np.testing.assert_allclose(outs[1].val_losses.cpu().numpy(), outs[0].val_losses.numpy(), rtol=RTOL)
    for key, layer in outs[0].params.items():
        for name, leaf in layer.items():
            np.testing.assert_allclose(outs[1].params[key][name].cpu().numpy(), leaf.numpy(), atol=ATOL)


@pytest.mark.cuda
def test_one_window_segments_equal_windowed_fit_on_card(cuda):
    spec = lstm_hourglass(20, lookback_window=10, encoding_layers=2)
    config = FitConfig(epochs=2, batch_size=32, validation_split=0.2, shuffle=False)
    series, targets, wtr, wval, init = _problem(spec, 3, 300)
    series, targets, wtr, wval = _on(cuda, series, targets, wtr, wval)
    nv, nw = wtr.shape[1], targets.shape[1]
    order = torch.arange(nv, device=cuda).clamp(max=nw - 1).repeat(3, 1)
    windowed = WindowedFit(spec, config).run(stack_member_params(init, cuda), series, targets, order, wtr, wval, None)
    segmented = SegmentedFit(spec, config, 32).run(stack_member_params(init, cuda), series, targets, wtr, wval)
    np.testing.assert_allclose(segmented.losses.cpu().numpy(), windowed.losses.cpu().numpy(), rtol=3e-6)
    np.testing.assert_allclose(segmented.val_losses.cpu().numpy(), windowed.val_losses.cpu().numpy(), rtol=3e-6)
    for key, layer in windowed.params.items():
        for name, leaf in layer.items():
            np.testing.assert_allclose(segmented.params[key][name].cpu().numpy(), leaf.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
def test_arrow_answers_equal_json_answers_on_card(cuda, tmp_path):
    """A card app over two feedforward detectors built on the card: an
    Arrow anomaly request and an Arrow fleet request answer what the JSON
    requests answer, to the bit."""
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.parallel.fleet_build import fleet_build
    from gordo_tpu_torch.server import build_app, wire

    tags = [f"tag-{i}" for i in range(6)]
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    index = [start + timedelta(minutes=10 * r) for r in range(300)]
    definition = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 2}}]}}}}
    machines = [Machine.from_config({"name": f"m-{i}", "model": definition,
                                     "dataset": {"tag_list": tags, "resolution": "10min"}}, "p",
                                    data=(np.random.RandomState(i).rand(300, 6), None), index=index)
                for i in range(2)]
    fleet_build(machines, output_dir=str(tmp_path / "1"), device="cuda")
    app = build_app(str(tmp_path / "1"), device="cuda")
    keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(64)]
    frame = {tag: dict(zip(keys, np.random.RandomState(9).rand(64).tolist())) for tag in tags}
    arrow = wire.encode_request(wire.decode_frame(frame), wire.decode_frame(frame))

    def post(path, body, content_type, accept=None):
        from io import BytesIO
        from wsgiref.util import setup_testing_defaults

        environ = {}
        setup_testing_defaults(environ)
        environ.update(REQUEST_METHOD="POST", PATH_INFO=path, CONTENT_TYPE=content_type,
                       CONTENT_LENGTH=str(len(body)), **{"wsgi.input": BytesIO(body)})
        if accept:
            environ["HTTP_ACCEPT"] = accept
        status = []
        chunks = app(environ, lambda s, h: status.append(int(s.split()[0])))
        return status[0], b"".join(chunks)

    url = "/gordo/v0/p/m-0/anomaly/prediction"
    status, body = post(url, json.dumps({"X": frame, "y": frame}).encode(), "application/json")
    arrow_status, arrow_body = post(url, arrow, wire.ARROW_CONTENT_TYPE, wire.ARROW_CONTENT_TYPE)
    assert status == arrow_status == 200
    expected = json.loads(body)["data"]
    table, extra = wire.decode_response(arrow_body)
    keys_out = wire.index_wire_keys(table.index)
    for column in table.columns:
        want = expected[column.group][column.sub or column.group]
        values = [None if v is None or v != v else v for v in column.values.tolist()]
        assert dict(zip(keys_out, values)) == want, column
    fleet = wire.pack_streams({name: arrow for name in ("m-0", "m-1")})
    status, body = post("/gordo/v0/p/prediction/fleet", json.dumps({"X": {"m-0": frame, "m-1": frame}}).encode(),
                        "application/json")
    arrow_status, arrow_body = post("/gordo/v0/p/prediction/fleet", fleet, wire.ARROW_CONTENT_TYPE,
                                    wire.ARROW_CONTENT_TYPE)
    assert status == arrow_status == 200
    entries, trailer = wire.unpack_streams(arrow_body)
    expected = json.loads(body)
    assert trailer == {"errors": {}, "revision": expected["revision"]}
    for name, stream in entries.items():
        table, _ = wire.decode_response(stream)
        outputs = {c.sub: c.values.tolist() for c in table.columns if c.group == "model-output"}
        assert outputs == {sub: list(cells.values()) for sub, cells in expected["data"][name]["model-output"].items()}
