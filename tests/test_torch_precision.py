"""The port's serving precision ladder against the JAX package's, on the CPU.

- the vocabulary and its resolution order;
- the bf16 cast, bit for bit after a cast back to f32, and the int8
  quantization (``Wq`` equal, ``scale`` within one ulp) of the same
  stacked params;
- the bf16 and int8 forwards of both packages on the same inputs: within
  one bf16 ulp of each other and further than that from f32, and judged
  by the package's own agreement math at the gate's defaults;
- the parity gate's verdict on both packages' fleets;
- through both apps: a failed gate serves f32 with no 5xx, a reduced
  forward's device fault degrades the bucket to f32 before the breaker,
  a verdict goes stale when the bucket's membership grows, and f32 and
  bf16 traffic of one moment never share a batch.

The fleets are ``tests/test_torch_engine.py``'s collection, plus a third
revision whose specs declare ``precision: bf16``.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from gordo_tpu import planner as jax_planner
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.models.spec import FeedForwardSpec as JaxFeedForwardSpec
from gordo_tpu.serve import precision as JP
from gordo_tpu.server.fleet_store import RevisionFleet as JaxRevisionFleet
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.server.fleet_store import fleet_forward_gather as jax_gather
from gordo_tpu_torch import planner, serializer
from gordo_tpu_torch.models.estimators import find_estimator
from gordo_tpu_torch.models.spec import FeedForwardSpec
from gordo_tpu_torch.serve import precision as P
from gordo_tpu_torch.server.fleet_store import RevisionFleet, fleet_forward_gather

from tests.test_torch_engine import (  # noqa: F401 - fixtures used by name
    NARROW,
    both_faults,
    build_collections,
    call,
    concurrent,
    engines,
    jax_app,
    payload,
    same_answer,
    serving_env,
    url,
)

#: a third revision: the same machines, their specs declaring bf16
BF16_REVISION = "1700000000002"


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """``tests/test_torch_engine.py``'s collections, with BF16_REVISION beside each."""
    jax_dir, port_dir = build_collections(tmp_path_factory.mktemp("torch-precision"))
    for name in NARROW:
        model = jax_serializer.load(os.path.join(jax_dir, name))
        estimator = model.base_estimator.steps[-1][1]
        estimator.spec_ = dataclasses.replace(estimator.spec_, precision="bf16")
        with open(os.path.join(jax_dir, name, "metadata.json")) as f:
            metadata = json.load(f)
        jax_serializer.dump(model, os.path.join(jax_dir, "..", BF16_REVISION, name), metadata=metadata)
        model = serializer.load(os.path.join(port_dir, name), "cpu")
        estimator = find_estimator(model)
        estimator.spec_ = dataclasses.replace(estimator.spec_, precision="bf16")
        serializer.dump(model, os.path.join(port_dir, "..", BF16_REVISION, name), metadata=metadata)
    return jax_dir, port_dir


def test_vocabulary_and_resolution_match_jax(monkeypatch):
    for value in ("f32", "FP32", "float32", "bf16", "bfloat16", "int8", "i8", "w8", "fp16", "", None, " BF16 "):
        assert P.normalize(value) == JP.normalize(value), value
    spec = FeedForwardSpec(4, 4, (2,), ("tanh",))
    jax_spec = JaxFeedForwardSpec(4, 4, (2,), ("tanh",))
    for env in (None, "bf16", "int8", "nonsense"):
        if env is None:
            monkeypatch.delenv(P.PRECISION_ENV, raising=False)
        else:
            monkeypatch.setenv(P.PRECISION_ENV, env)
        assert P.serve_precision() == JP.serve_precision()
        for declared in ("", "int8", "bfloat16"):
            for default in (None, "f32", "bf16"):
                ours = P.resolve_precision(dataclasses.replace(spec, precision=declared), default)
                assert ours == JP.resolve_precision(dataclasses.replace(jax_spec, precision=declared), default)
    assert P.payload_dtype("f32") is not P.payload_dtype("bf16") is P.payload_dtype("int8")
    monkeypatch.setenv(P.GATE_ENV, "0")
    assert P.gate_enabled() is JP.gate_enabled() is False
    # the learned model's nomination (GORDO_TPU_PERFMODEL_PRECISION): the JAX answer on the same table,
    # knob off and on, in and out of the table's domain, on evidence for reduced, for f32 and for neither
    entry = {"coef": [0.1, 0.0, 1.0, 1.0, 0.0, -0.5, 0.2], "lo": [0.0] * 6, "hi": [8.0] * 6, "n": 64,
             "holdout_mae_log": 0.05}
    learned = {"version": 1, "features": list(planner.LEARNED_FEATURES), "targets": {"device_ms": {
        "fleet_forward": entry}}}
    tables = (learned, {**learned, "targets": {"device_ms": {"fleet_forward": {
        **entry, "coef": [0.1, 0.0, 1.0, 1.0, 0.0, 0.5, 0.7]}}}}, None)
    nominated = []
    for knob in ("0", "1"):
        monkeypatch.setenv("GORDO_TPU_PERFMODEL_PRECISION", knob)
        for section in tables:
            ours = planner.CostModel(planner.CostTable(learned=copy.deepcopy(section)))
            theirs = jax_planner.CostModel(jax_planner.CostTable(learned=copy.deepcopy(section)))
            for members, rows in ((8, 32), (1, 1), (8, 65536)):
                got = P.model_preferred(spec, members, rows, ours)
                assert got == JP.model_preferred(jax_spec, members, rows, theirs), (knob, members, rows)
                nominated.append(got)
    assert nominated.count("bf16") == 2 and set(nominated) == {None, "bf16"}


SPEC = dict(n_features=20, n_features_out=20, dims=(16, 8, 16), activations=("tanh", "relu", "tanh"))


@pytest.fixture(scope="module")
def stacked():
    """``(port spec, jax spec, numpy params)``: three members, seeded."""
    import jax.numpy as jnp  # noqa: F401 - JAX is on the CPU here

    rng = np.random.default_rng(5)
    widths = (20, 16, 8, 16, 20)
    keys = ["dense_0", "dense_1", "dense_2", "out"]
    params = {}
    for i, key in enumerate(keys):
        params[key] = {
            "W": (rng.standard_normal((3, widths[i], widths[i + 1])) / np.sqrt(widths[i])).astype(np.float32),
            "b": (0.1 * rng.standard_normal((3, widths[i + 1]))).astype(np.float32),
        }
    params["dense_2"]["W"][1, :, 3] = 0.0  # a dead output channel: the scale's clamp
    return FeedForwardSpec(**SPEC), JaxFeedForwardSpec(**SPEC), params


def _port(params):
    import torch

    return {k: {n: torch.from_numpy(v.copy()) for n, v in layer.items()} for k, layer in params.items()}


def _jax(params):
    import jax.numpy as jnp

    return {k: {n: jnp.asarray(v) for n, v in layer.items()} for k, layer in params.items()}


def test_bf16_cast_matches_jax(stacked):
    _, _, params = stacked
    ours, theirs = P.cast_bucket_params(_port(params), "bf16"), JP.cast_bucket_params(_jax(params), "bf16")
    for key in params:
        for leaf in ("W", "b"):
            got = ours[key][leaf].float().numpy()
            np.testing.assert_array_equal(got, np.asarray(theirs[key][leaf], np.float32))
    assert P.cast_bucket_params(_port(params), "f32")["out"]["W"].dtype == P.payload_dtype("f32")
    with pytest.raises(ValueError):
        P.cast_bucket_params(_port(params), "fp4")


def test_int8_quantization_matches_jax(stacked):
    _, _, params = stacked
    ours, theirs = P.cast_bucket_params(_port(params), "int8"), JP.cast_bucket_params(_jax(params), "int8")
    for key in params:
        np.testing.assert_array_equal(ours[key]["W"].numpy(), np.asarray(theirs[key]["W"]))
        scale, jax_scale = ours[key]["scale"].numpy(), np.asarray(theirs[key]["scale"])
        assert scale.shape == jax_scale.shape == (3, 1, params[key]["W"].shape[-1])
        np.testing.assert_array_max_ulp(scale, jax_scale, maxulp=1)
        np.testing.assert_array_equal(ours[key]["b"].numpy(), params[key]["b"])
    assert float(ours["dense_2"]["scale"][1, 0, 3]) == pytest.approx(1e-12)


def bf16_ulps(a, b):
    """``|a - b|`` in bf16 ulps of the larger magnitude (floored at 2**-8,
    so values near zero are judged at that scale)."""
    magnitude = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0**-8)
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(magnitude)) - 7)


#: the port's reduced forward against JAX's, in bf16 ulps (``bf16_ulps``).
#: Readings on the CPU, both precisions: port against JAX 0.5 at most;
#: f32 against either package's reduced output 190 (bf16) and 279 (int8).
#: So the limit is one ulp, and a port that ran its reduced forward in
#: f32 would miss it by two orders.
REDUCED_VS_JAX_ULPS = 1.0


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_forwards_agree_with_jax(stacked, precision):
    """The same gathered members (one of them twice) and raw rows with an
    ingest plan through both packages' serving forwards: the port's
    reduced output is within REDUCED_VS_JAX_ULPS of the JAX package's on
    every value, while each package's f32 output is further than that
    from it (the port computes at the precision it claims); the three
    pairs agree on every row by the package's own agreement math at the
    gate's tolerances, and the two packages' reduced verdicts agree at
    the gate's agreement."""
    import torch

    spec, jax_spec, params = stacked
    rng = np.random.default_rng(6)
    X = rng.random((4, 128, 20)).astype(np.float32) * 3 - 1
    scale = (0.5 + rng.random((3, 20))).astype(np.float32)
    offset = (0.1 * rng.standard_normal((3, 20))).astype(np.float32)
    indices = np.asarray([2, 0, 1, 2], np.int32)
    ingest = (torch.from_numpy(scale), torch.from_numpy(offset))
    ours = fleet_forward_gather(spec, P.cast_bucket_params(_port(params), precision), indices,
                                torch.from_numpy(X), ingest=ingest, precision=precision).numpy()
    theirs = np.asarray(jax_gather(jax_spec, JP.cast_bucket_params(_jax(params), precision), indices, X,
                                   precision=precision, ingest=(scale, offset)))
    f32 = fleet_forward_gather(spec, _port(params), indices, torch.from_numpy(X), ingest=ingest).numpy()
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (4, 128, 20)
    assert bf16_ulps(ours, theirs).max() <= REDUCED_VS_JAX_ULPS
    assert bf16_ulps(f32, ours).max() > REDUCED_VS_JAX_ULPS
    assert bf16_ulps(f32, theirs).max() > REDUCED_VS_JAX_ULPS
    config = P.ParityConfig()
    for a, b in ((theirs, ours), (f32, ours), (f32, theirs)):
        report = P.recon_agreement(a, b, rtol=config.rtol, atol=config.atol)
        assert report == JP.recon_agreement(a, b, rtol=config.rtol, atol=config.atol)
        assert report["agreement"] == 1.0, report
    # verdicts at a detector-like threshold: the 90th percentile of the f32 errors
    threshold = float(np.quantile(np.mean(np.square(f32 - X), axis=-1), 0.9))
    for m in range(4):
        verdict = P.verdict_agreement(theirs[m], ours[m], X[m], scaler=_Identity(), threshold=threshold)
        assert verdict == JP.verdict_agreement(theirs[m], ours[m], X[m], scaler=_Identity(), threshold=threshold)
        assert verdict["mode"] == "verdict" and verdict["agreement"] >= config.agreement, verdict


class _Identity:
    def transform(self, X):
        return np.asarray(X)


def _fleets(collections):
    jax_dir, port_dir = collections
    port_fleet, jax_fleet = RevisionFleet(port_dir, __import__("torch").device("cpu")), JaxRevisionFleet(jax_dir)
    for name in NARROW:
        port_fleet.model(name)
        jax_fleet.model(name)
    return port_fleet, jax_fleet


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_parity_gate_matches_jax(collections, precision):
    port_fleet, jax_fleet = _fleets(collections)
    spec, jax_spec = port_fleet.loaded_specs()[NARROW[0]], jax_fleet.loaded_specs()[NARROW[0]]
    ours, theirs = P.evaluate_parity(port_fleet, spec, precision), JP.evaluate_parity(jax_fleet, jax_spec, precision)
    assert ours["passed"] is theirs["passed"] is True
    assert sorted(ours["members"]) == sorted(theirs["members"]) == NARROW
    for name in NARROW:
        assert ours["members"][name]["mode"] == theirs["members"][name]["mode"] == "verdict"
    assert ours["agreement_min"] >= ours["agreement_threshold"] == theirs["agreement_threshold"]
    assert P.evaluate_parity(port_fleet, spec, "f32")["passed"]


def test_verdict_goes_stale_when_the_bucket_grows(collections):
    """A verdict taken over two members reads as absent once a third
    loads, on both packages, and the next request re-gates over three."""
    jax_dir, port_dir = collections
    import torch

    for fleet, governor in ((RevisionFleet(port_dir, torch.device("cpu")), P.PrecisionGovernor()),
                            (JaxRevisionFleet(jax_dir), JP.PrecisionGovernor())):
        for name in NARROW[:2]:
            fleet.model(name)
        spec = fleet.loaded_specs()[NARROW[0]]
        assert governor.effective_precision(fleet, spec, "bf16") == "bf16"
        assert set(fleet.precision_state(spec, "bf16")["members"]) == set(NARROW[:2])
        fleet.model(NARROW[2])
        assert fleet.precision_state(spec, "bf16") is None
        assert governor.effective_precision(fleet, spec, "bf16") == "bf16"
        assert set(fleet.precision_state(spec, "bf16")["members"]) == set(NARROW[:3])


def test_failed_gate_serves_f32_with_no_5xx(collections, jax_app, monkeypatch):
    """A corrupted cast fails the gate: every request answers 200 with the
    f32 answer, counted as degraded."""
    jax_dir, port_dir = collections
    requests = [(url(name), payload(name, seed=i)) for i, name in enumerate(NARROW)]
    with engines(port_dir) as (_, port_app):
        f32_port = concurrent(port_app, requests)
    monkeypatch.setattr(P, "cast_bucket_params", lambda stacked, precision: {
        k: {n: t * 0.0 for n, t in layer.items()} for k, layer in stacked.items()})
    monkeypatch.setattr(JP, "cast_bucket_params", lambda stacked, precision: __import__("jax").tree_util.tree_map(
        lambda a: a * 0.0, stacked))
    JAX_STORE.invalidate(jax_dir)
    try:
        with engines(port_dir, serve_precision="bf16") as (jax_engine, port_app):
            jax_answers, port_answers = concurrent(jax_app, requests), concurrent(port_app, requests)
            for stats in (port_app.engine.stats(), jax_engine.stats()):
                assert stats["precision_degraded"] == 4
                assert stats["precision"] == {"config": "bf16", "coalesced": {"f32": 4}}
        assert [a[0] for a in jax_answers] == [200] * 4
        for alone, answer in zip(f32_port, port_answers):
            same_answer(alone, answer)
        spec = port_app.store.fleet().loaded_specs()[NARROW[0]]
        assert port_app.store.fleet().precision_state(spec, "bf16")["passed"] is False
    finally:
        JAX_STORE.invalidate(jax_dir)


def test_reduced_fault_degrades_to_f32_before_the_breaker(collections, jax_app, monkeypatch):
    """A bf16 forward that keeps failing for one member: the bucket is
    degraded to f32 and the member retried there (200), with no breaker
    failure; later requests of the bucket serve f32."""
    jax_dir, port_dir = collections
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    JAX_STORE.invalidate(jax_dir)
    requests = [(url(name), payload(name, seed=10 + i)) for i, name in enumerate(NARROW)]
    try:
        with engines(port_dir, serve_precision="bf16") as (jax_engine, port_app):
            stack, _ = both_faults("serve_device_program", f"*:bf16:{NARROW[1]}", times=None)
            with stack:
                for app in (jax_app, port_app):
                    assert [a[0] for a in concurrent(app, requests)] == [200] * 4
                    assert [a[0] for a in concurrent(app, requests)] == [200] * 4
            for stats in (port_app.engine.stats(), jax_engine.stats()):
                assert stats["members_isolated"] == 0 and stats["breaker"]["tracked"] == 0
                assert stats["breaker"]["degraded_buckets"] == 1
                assert stats["precision"]["coalesced"] == {"bf16": 4, "f32": 4}
                assert stats["precision_degraded"] == 1 + 4  # the faulted member, then the next round
    finally:
        JAX_STORE.invalidate(jax_dir)


def test_mixed_precision_traffic_never_shares_a_batch(collections, jax_app):
    """f32 requests to the served revision and bf16 ones pinned to the
    revision whose specs declare bf16, at the same moment: all 200, one
    batch of each precision."""
    jax_dir, port_dir = collections
    names = NARROW[:2]
    requests = [(url(n), payload(n, seed=20 + i)) for i, n in enumerate(names)] * 2
    pins = [None, None, {"revision": BF16_REVISION}, {"revision": BF16_REVISION}]
    import threading

    for side in ("jax", "port"):
        with engines(port_dir, max_size=2) as (jax_engine, port_app):
            app, engine = (jax_app, jax_engine) if side == "jax" else (port_app, port_app.engine)
            statuses = [None] * 4
            threads = [threading.Thread(target=lambda i=i: statuses.__setitem__(
                i, call(app, *requests[i], query=pins[i])[0])) for i in range(4)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
            stats = engine.stats()
            assert statuses == [200] * 4
            assert stats["batches"] == 2 and stats["precision"]["coalesced"] == {"f32": 2, "bf16": 2}
            if side == "port":
                assert sorted(shape[2:] for shape in engine.program_shapes()) == [(2, 2, 32, "bf16"),
                                                                                   (2, 2, 32, "f32")]
    JAX_STORE.invalidate(os.path.join(jax_dir, "..", BF16_REVISION))
