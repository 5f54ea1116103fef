"""The wide kernel's numerical recipe, 3xTF32, emulated on the CPU and held
against the JAX forward.

``fleet_dense_wide_kernel`` (``gordo_tpu_torch/ops/csrc/fleet_dense.cu``)
sums every layer on the tensor cores with ``mma.sync.m16n8k8`` over TF32
operands. To keep f32 accuracy it splits each f32 operand ``x`` into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: 10
mantissa bits, to nearest, ties away from zero) and sums, per k step of 8,
``lo*hi``, then ``hi*lo``, then ``hi*hi`` into an f32 accumulator, the
bias after the sum. This file rounds by bit masking, sums the three
products in that order (a product of two TF32 values is exact in f32),
and holds the result against ``gordo_tpu.models.nn.forward_feedforward``
at the tolerance the kernel is held to on the card (rtol 1e-5, atol
1e-5): feedforward_model(20), all 16 activations at a 48-wide hidden
layer and the 512-300-1-512 softmax spec. The emulation lives here only;
nothing in the package calls it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gordo_tpu.models import factories as jax_factories
from gordo_tpu.models.nn import forward_feedforward as jax_forward
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.ops.activations import ACTIVATION_NAMES, resolve_activation

RTOL, ATOL = 1e-5, 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: add half of the
    13 dropped bits to the bit pattern (sign and magnitude, so the
    magnitude rounds away from zero on a tie; a carry moves the exponent)
    and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, guard: bool = False):
    """``(hi, lo)`` with ``hi + lo`` = ``x`` to ~22 bits; with ``guard`` (the
    kernel's activations) ``lo`` is 0 where ``x - hi`` is not finite."""
    hi = tf32(x)
    rest = x - hi
    if guard:
        rest = torch.where(torch.isfinite(rest), rest, torch.zeros_like(rest))
    return hi, tf32(rest)


def layer_3xtf32(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h W + b`` as the kernel sums it: depth padded to 8 with zeros, per
    k step of 8 the three products lo*hi, hi*lo, hi*hi, then the bias."""
    k = h.shape[1]
    k8 = -(-k // 8) * 8
    a_hi, a_lo = split(F.pad(h, (0, k8 - k)), guard=True)
    b_hi, b_lo = split(F.pad(W, (0, 0, 0, k8 - k)))
    acc = torch.zeros(h.shape[0], W.shape[1], dtype=torch.float32)
    for k0 in range(0, k8, 8):
        s = slice(k0, k0 + 8)
        acc = acc + a_lo[:, s] @ b_hi[s]
        acc = acc + a_hi[:, s] @ b_lo[s]
        acc = acc + a_hi[:, s] @ b_hi[s]
    return acc + b


def forward_3xtf32(spec, params, X: np.ndarray) -> np.ndarray:
    h = torch.from_numpy(X)
    for key, act in spec.layer_names():
        layer = params[key]
        h = resolve_activation(act)(layer_3xtf32(h, torch.from_numpy(layer["W"]), torch.from_numpy(layer["b"])))
    return h.numpy()


def _params(spec, seed):
    """Glorot-scaled weights and non-zero biases, seeded numpy."""
    rng = np.random.RandomState(seed)
    widths = spec.widths()
    params = {}
    for i, (key, _) in enumerate(spec.layer_names()):
        limit = np.sqrt(6.0 / (widths[i] + widths[i + 1]))
        params[key] = {
            "W": rng.uniform(-limit, limit, (widths[i], widths[i + 1])).astype(np.float32),
            "b": rng.uniform(-0.1, 0.1, widths[i + 1]).astype(np.float32),
        }
    return params


def _check(factory, args, kwargs, rows, seed):
    jax_spec = getattr(jax_factories, factory)(*args, **kwargs)
    spec = getattr(factories, factory)(*args, **kwargs)
    params = _params(spec, seed)
    X = np.random.RandomState(seed + 1).rand(rows, spec.n_features).astype(np.float32)
    expected, _ = jax_forward(jax_spec, {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params.items()},
                              jnp.asarray(X))
    got = forward_3xtf32(spec, params, X)
    np.testing.assert_allclose(got, np.asarray(expected), rtol=RTOL, atol=ATOL)
    return got, np.asarray(expected)


def test_feedforward_model_defaults():
    _check("feedforward_model", (20,), {}, 64, 0)


@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_every_activation_at_hidden_48(name):
    kwargs = dict(encoding_dim=(48,), decoding_dim=(5,), encoding_func=(name,), decoding_func=("tanh",),
                  out_func=name)
    _check("feedforward_model", (6,), kwargs, 37, 10)


def test_widest_softmax_spec():
    kwargs = dict(encoding_dim=(300,), decoding_dim=(1,), encoding_func=("tanh",), decoding_func=("softmax",))
    _check("feedforward_model", (512,), kwargs, 16, 9)


def test_one_tf32_product_alone_misses_the_tolerance():
    """The split is what buys the accuracy: hi*hi alone (plain TF32) is
    off by ~1e-4 relative on feedforward_model(20)."""
    spec = factories.feedforward_model(20)
    params = _params(spec, 0)
    X = torch.from_numpy(np.random.RandomState(1).rand(64, 20).astype(np.float32))
    h3, h1 = X, X
    for key, act in spec.layer_names():
        W, b = torch.from_numpy(params[key]["W"]), torch.from_numpy(params[key]["b"])
        h3 = resolve_activation(act)(layer_3xtf32(h3, W, b))
        h1 = resolve_activation(act)(tf32(h1) @ tf32(W) + b)
    exact = torch.from_numpy(np.array(_check("feedforward_model", (20,), {}, 64, 0)[1]))
    assert not torch.allclose(h1, exact, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(h3, exact, rtol=RTOL, atol=ATOL)


def test_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # a TF32 ulp at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 1.0 + 0.75 * one_ulp,
                      2.0 - one_ulp / 2], dtype=torch.float32)
    expected = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, 2.0], dtype=torch.float32)
    torch.testing.assert_close(tf32(x), expected, rtol=0, atol=0)
    assert bool(((tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF) == 0).all())


def test_split_keeps_22_bits_and_passes_non_finite_through_hi():
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(10_000).astype(np.float32)) * 100
    hi, lo = split(x)
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -21
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, lo = split(special, guard=True)
    assert torch.equal(lo, torch.zeros(3))
    assert hi[0] == float("inf") and hi[1] == -float("inf") and torch.isnan(hi[2])
