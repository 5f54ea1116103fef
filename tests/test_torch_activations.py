"""The port's activation table against the JAX package's, name by name.

Inputs are a seeded float32 grid given to both; the tolerance (rtol 1e-6,
atol 1e-6) allows for the two libraries' transcendental functions
rounding the last bit differently.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.activations import _ACTIVATIONS as JAX_ACTIVATIONS
from gordo_tpu_torch.ops.activations import (
    ACTIVATION_CODES,
    ACTIVATION_NAMES,
    activation_code,
    resolve_activation,
)

CSRC = Path(__file__).resolve().parents[1] / "gordo_tpu_torch" / "ops" / "csrc"

GRID = np.concatenate(
    [
        np.linspace(-12.0, 12.0, 481),
        np.random.RandomState(0).standard_normal(203) * 3,
        [0.0, -0.0, 1e-7, -1e-7, 30.0, -30.0],
    ]
).astype(np.float32)


def test_same_names_as_the_jax_table():
    assert set(ACTIVATION_NAMES) == set(JAX_ACTIVATIONS)
    assert len(ACTIVATION_NAMES) == 16


@pytest.mark.parametrize("name", sorted(JAX_ACTIVATIONS))
def test_activation_matches_jax(name):
    x = GRID.reshape(-1, 6 if name == "softmax" else 1)
    if name == "exponential":
        x = np.clip(x, -20, 20)
    expected = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(x)))
    got = resolve_activation(name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["relu", "relu6", "leaky_relu", "tanh", "gelu"])
def test_nan_propagates_like_jax(name):
    x = np.array([np.nan, 1.0], np.float32)
    expected = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(x)))
    got = resolve_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expected))


def test_codes_are_the_kernel_enum():
    """The order is the ABI of ``fleet_dense.cu``'s ``Act`` enum."""
    assert sorted(ACTIVATION_CODES.values()) == list(range(16))
    source = (CSRC / "fleet_dense.cu").read_text()
    enum = source[source.index("enum Act"):source.index("kNumActs")]
    kernel_names = re.findall(r"\bk([A-Z][A-Za-z0-9]*)", enum)
    expected = ["".join(p.capitalize() for p in name.split("_")) for name in ACTIVATION_NAMES]
    assert kernel_names == expected


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="Unknown activation"):
        resolve_activation("nope")
    with pytest.raises(ValueError, match="Unknown activation"):
        activation_code("nope")
