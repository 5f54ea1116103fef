"""The port's stacked optimizers (``gordo_tpu_torch/models/optim.py``)
against optax as the JAX package builds it (``OptimizerSpec.to_optax``),
vmapped over the member axis with the JAX fit program's masked update
(``gordo_tpu/models/training.py:295-303``).

Three members take five steps of seeded gradients; member 1 sees a
masked (all-padding) step at step 2 and must come out of it unmoved:
params, moments and step count. Tolerance: rtol 1e-6, atol 1e-7 on
params and moments (f32, the same operations in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gordo_tpu.models.spec import OptimizerSpec as JaxOptimizerSpec
from gordo_tpu_torch.models.optim import StackedOptimizer
from gordo_tpu_torch.models.spec import OptimizerSpec

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"W": (4, 3), "b": (3,)}
MEMBERS, STEPS = 3, 5

CASES = {
    "adam": ("Adam", {}),
    "adam-lr-betas": ("adam", {"learning_rate": 0.01, "beta_1": 0.8, "beta_2": 0.99, "epsilon": 1e-6}),
    "adamw": ("AdamW", {"weight_decay": 0.01}),
    "adamw-default-decay": ("adamw", {}),
    "sgd": ("SGD", {"learning_rate": 0.1}),
    "sgd-momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "sgd-nesterov": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True}),
    "rmsprop": ("RMSprop", {"learning_rate": 0.01}),
    "rmsprop-momentum": ("rmsprop", {"learning_rate": 0.01, "rho": 0.8, "momentum": 0.5}),
}


def _draws(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(MEMBERS, *s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(MEMBERS, *s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(STEPS)]
    masks = np.ones((STEPS, MEMBERS), bool)
    masks[2, 1] = False  # member 1: an all-padding batch
    masks[0, 2] = False  # member 2: its first step is padding too
    return params, grads, masks


def _jax_run(tx, params, grads, masks):
    def one(p, state, g, mask):
        updates, new_state = tx.update(g, state, p)
        p = jax.tree_util.tree_map(lambda a, b: jnp.where(mask, a, b), optax.apply_updates(p, updates), p)
        state = jax.tree_util.tree_map(lambda a, b: jnp.where(mask, a, b), new_state, state)
        return p, state

    step = jax.vmap(one)  # eager: a compile per case would cost more than the steps
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax.vmap(tx.init)(p)
    history = []
    for g, mask in zip(grads, masks):
        p, state = step(p, state, {k: jnp.asarray(v) for k, v in g.items()}, jnp.asarray(mask))
        history.append({k: np.asarray(v) for k, v in p.items()})
    return history, state


def _port_run(optimizer, params, grads, masks):
    leaves = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    state = optimizer.init(leaves)
    history = []
    for g, mask in zip(grads, masks):
        optimizer.step(leaves, [torch.from_numpy(g[k]) for k in SHAPES], state, torch.from_numpy(mask))
        history.append({k: leaf.numpy().copy() for k, leaf in zip(SHAPES, leaves)})
    return history, state


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_optimizer_matches_optax(case):
    name, kwargs = CASES[case]
    params, grads, masks = _draws(seed=len(case))
    expected, jax_state = _jax_run(
        JaxOptimizerSpec.from_config(name, dict(kwargs)).to_optax(), params, grads, masks
    )
    got, state = _port_run(StackedOptimizer(OptimizerSpec.from_config(name, dict(kwargs))), params, grads, masks)
    for step, (want, have) in enumerate(zip(expected, got)):
        for k in SHAPES:
            np.testing.assert_allclose(have[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{case} step {step} {k}")
    # the masked steps moved nothing
    for k in SHAPES:
        np.testing.assert_array_equal(got[2][k][1], got[1][k][1])
        np.testing.assert_array_equal(got[0][k][2], params[k][2])
    # moments and step counts, where optax keeps them
    moments = _jax_moments(jax_state)
    assert set(moments) == set(state.slots)
    for slot, jax_leaves in moments.items():
        for k, leaf in zip(SHAPES, state.slots[slot]):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jax_leaves[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} {slot} {k}")
    if name.lower() in ("adam", "adamw"):
        np.testing.assert_array_equal(state.count.numpy(), [STEPS, STEPS - 1, STEPS - 1])


def _jax_moments(state):
    """optax's moment trees by the port's slot names."""
    found = {}
    for part in jax.tree_util.tree_leaves(state, is_leaf=lambda s: hasattr(s, "_fields")):
        for slot in ("mu", "nu", "trace"):
            if hasattr(part, slot):
                found[slot] = getattr(part, slot)
    return found


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        StackedOptimizer(OptimizerSpec.from_config("Adagrad"))


def test_defaults_are_keras_not_torch():
    adam = StackedOptimizer(OptimizerSpec())
    assert (adam.lr, adam.b1, adam.b2, adam.eps) == (0.001, 0.9, 0.999, 1e-7)
    assert StackedOptimizer(OptimizerSpec.from_config("adamw")).weight_decay == 1e-4
