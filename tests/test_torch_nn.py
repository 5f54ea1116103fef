"""The port's specs, factories, init and plain forward against the JAX package.

Specs must be equal field by field. The forward runs JAX-initialized
params (carried over with ``params_from_jax``) on the same seeded numpy
inputs and is held to rtol 1e-5, atol 1e-6, the tolerance the JAX
package holds its own Pallas kernel to (``tests/ops/test_pallas_dense.py``).
"""

import math
import pickle

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models import factories as jax_factories
from gordo_tpu.models.nn import forward_feedforward as jax_forward
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.estimators import NotFittedError, TorchAutoEncoder
from gordo_tpu_torch.models.nn import (
    forward_feedforward,
    init_feedforward,
    params_from_jax,
    params_to_numpy,
)
from gordo_tpu_torch.models.spec import FeedForwardSpec
from gordo_tpu_torch.parallel.fleet import stack_member_params

FACTORY_CASES = [
    ("feedforward_hourglass", (20,), {}),
    ("feedforward_hourglass", (10,), {"compression_factor": 0.2}),
    ("feedforward_hourglass", (10,), {"encoding_layers": 1, "func": "relu"}),
    ("feedforward_model", (20,), {}),
    ("feedforward_model", (6, 4), {"encoding_dim": (8, 4), "decoding_dim": (4, 8),
                                   "encoding_func": ("relu", "relu"), "decoding_func": ("relu", "relu"),
                                   "out_func": "sigmoid", "optimizer_kwargs": {"lr": 0.01, "beta_1": 0.8}}),
    ("feedforward_symmetric", (7,), {"dims": (5, 3), "funcs": ("elu", "selu")}),
]


@pytest.mark.parametrize("factory,args,kwargs", FACTORY_CASES)
def test_factory_specs_equal_jax(factory, args, kwargs):
    jax_spec = getattr(jax_factories, factory)(*args, **kwargs)
    spec = getattr(factories, factory)(*args, **kwargs)
    assert spec.to_dict() == jax_spec.to_dict()
    assert FeedForwardSpec.from_dict(jax_spec.to_dict()) == spec
    assert hash(spec) == hash(FeedForwardSpec.from_dict(jax_spec.to_dict()))


def test_production_geometries():
    assert factories.feedforward_hourglass(20).widths() == (20, 17, 13, 10, 10, 13, 17, 20)
    assert factories.feedforward_model(20).widths() == (20, 256, 128, 64, 64, 128, 256, 20)


FORWARD_CASES = [
    ("feedforward_hourglass", (12,), {}),
    ("feedforward_model", (6, 6), {"encoding_dim": (8, 4), "decoding_dim": (4, 8),
                                   "encoding_func": ("relu", "relu"), "decoding_func": ("relu", "relu")}),
    ("feedforward_model", (5, 3), {"encoding_dim": (7,), "decoding_dim": (6,), "encoding_func": ("gelu",),
                                   "decoding_func": ("softmax",), "out_func": "tanh"}),
    ("feedforward_symmetric", (9,), {"dims": (6, 4), "funcs": ("selu", "swish")}),
]


@pytest.mark.parametrize("case", range(len(FORWARD_CASES)))
def test_forward_matches_jax(case):
    factory, args, kwargs = FORWARD_CASES[case]
    jax_spec = getattr(jax_factories, factory)(*args, **kwargs)
    spec = getattr(factories, factory)(*args, **kwargs)
    params = jax_init(jax.random.PRNGKey(case), jax_spec)
    x = np.random.RandomState(case).standard_normal((33, spec.n_features)).astype(np.float32)
    expected, expected_penalty = jax_forward(jax_spec, params, x)
    got, penalty = forward_feedforward(spec, params_from_jax(params), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(penalty), float(expected_penalty), rtol=1e-5, atol=1e-6)


def test_init_shapes_bounds_dtype():
    spec = factories.feedforward_model(20)
    params = init_feedforward(spec, torch.Generator().manual_seed(0))
    widths = spec.widths()
    assert list(params) == [key for key, _ in spec.layer_names()]
    for i, (key, _) in enumerate(spec.layer_names()):
        W, b = params[key]["W"], params[key]["b"]
        assert W.shape == (widths[i], widths[i + 1]) and b.shape == (widths[i + 1],)
        assert W.dtype == torch.float32 and b.dtype == torch.float32
        limit = math.sqrt(6.0 / (widths[i] + widths[i + 1]))
        assert float(W.abs().max()) <= limit
        assert float(W.abs().max()) > 0.9 * limit  # fills the range
        assert float(b.abs().max()) == 0.0


def test_init_is_seeded():
    spec = factories.feedforward_hourglass(8)
    a = init_feedforward(spec, torch.Generator().manual_seed(3))
    b = init_feedforward(spec, torch.Generator().manual_seed(3))
    c = init_feedforward(spec, torch.Generator().manual_seed(4))
    assert torch.equal(a["dense_0"]["W"], b["dense_0"]["W"])
    assert not torch.equal(a["dense_0"]["W"], c["dense_0"]["W"])


def test_params_round_trip_and_stacking():
    spec = factories.feedforward_hourglass(6)
    members = [init_feedforward(spec, torch.Generator().manual_seed(i)) for i in range(3)]
    host = [params_to_numpy(p) for p in members]
    assert all(isinstance(p["out"]["W"], np.ndarray) for p in host)
    stacked = stack_member_params(host)
    assert stacked["dense_0"]["W"].shape == (3, 6, 5)
    for i, p in enumerate(members):
        assert torch.equal(stacked["out"]["b"][i], p["out"]["b"])


def test_estimator_predict_and_pickle():
    spec = factories.feedforward_hourglass(5)
    params = params_to_numpy(init_feedforward(spec, torch.Generator().manual_seed(1)))
    est = TorchAutoEncoder(spec, params, device="cpu")
    x = np.random.RandomState(1).rand(11, 5).astype(np.float32)
    expected, _ = forward_feedforward(spec, params_from_jax(params), torch.from_numpy(x))
    np.testing.assert_allclose(est.predict(x), expected.numpy(), rtol=1e-6, atol=1e-7)
    assert isinstance(est.__getstate__()["params_"]["out"]["W"], np.ndarray)
    restored = pickle.loads(pickle.dumps(est))
    # an unpickled estimator is on no device until the caller places it
    assert restored.device is None
    with pytest.raises(RuntimeError, match="no device"):
        restored.predict(x)
    np.testing.assert_array_equal(restored.to("cpu").predict(x), est.predict(x))
    with pytest.raises(NotFittedError):
        TorchAutoEncoder(spec, device="cpu").predict(x)


def test_estimator_defaults_to_cuda():
    """The estimator runs on cuda unless the caller asks for the CPU, and
    raises rather than moving to the CPU when there is no card."""
    spec = factories.feedforward_hourglass(5)
    params = params_to_numpy(init_feedforward(spec, torch.Generator().manual_seed(1)))
    restored = pickle.loads(pickle.dumps(TorchAutoEncoder(spec, params, device="cpu")))
    if torch.cuda.is_available():
        assert TorchAutoEncoder(spec, params).device.type == "cuda"
        assert restored.to().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchAutoEncoder(spec, params)
        with pytest.raises(RuntimeError, match="CUDA"):
            restored.to()
