"""The port's stacked fit (``gordo_tpu_torch/models/training.py``)
against the JAX package's ``_fleet_fit_program``
(``jit(vmap(build_raw_fit_fn))``) on seeded numpy data with JAX's own
randomness injected: each member's initial params and per-epoch
permutations are derived as the JAX trainer derives them
(``split(PRNGKey(seed))`` into fit and init keys, ``split(fit, epochs)``,
``permutation(key, n)``); the fleet trainer's (``parallel/fleet.py``)
``predict_bucket`` against the JAX trainer's, and its bucketing, retries
and bisection.

Tolerance: per-epoch losses rtol 1e-5, params atol 1e-5, epochs run
equal. Measured on the CPU (torch 2.13, jax 0.9): every case within
7e-8 of the JAX params and 1e-7 relative of its losses after three
epochs; the f32 sums are taken in another order.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models import training as jax_training
from gordo_tpu.models.callbacks import EarlyStopping as JaxEarlyStopping
from gordo_tpu.models.factories.feedforward_autoencoder import feedforward_hourglass as jax_hourglass
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu_torch.models import training
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.estimators import TorchAutoEncoder
from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.parallel import fleet
from gordo_tpu_torch.utils.faults import FaultRule, InjectedDeviceError, inject

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
EPOCHS, ROWS, BATCH = 3, 64, 16


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return jax_init(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX fleet trainer's randomness, for the port's trainer (each
    derivation jitted once: eager JAX compiles every new op)."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


#: fit configs; every case trains the same three members: member 0 with a
#: tail validation split, member 1 20 rows of the 64 (its last two
#: no-shuffle batches are all padding), member 2 with a NaN reading
CASES = {
    "shuffle": dict(),
    "no-shuffle-early-stop-restore-best": dict(shuffle=False, early_stopping=("val_loss", 1, 5.0, True)),
    "shuffle-early-stop-loss-patience-0": dict(early_stopping=("loss", 0, 5.0, False)),
}


def _case(name):
    rng = np.random.RandomState(len(name))
    X = rng.rand(3, ROWS, 6).astype(np.float32)
    wtr = np.ones((3, ROWS), np.float32)
    wval = np.zeros((3, ROWS), np.float32)
    wtr[0, 50:], wval[0, 50:] = 0.0, 1.0
    X[1, 20:] = 0.0
    wtr[1, 20:] = 0.0
    X[2, 5, 0] = np.nan
    opts = CASES[name]
    config = dict(epochs=EPOCHS, batch_size=BATCH, shuffle=opts.get("shuffle", True),
                  early_stopping=opts.get("early_stopping"))
    return X, wtr, wval, config


def _jax_fit(spec, config, seeds, X, wtr, wval):
    split = jax.jit(jax.vmap(jax.random.split))(jax_fleet.host_prng_keys(seeds))
    params = jax_fleet._fleet_init_program(spec)(split[:, 1])
    opt_state = jax.jit(jax.vmap(spec.optimizer.to_optax().init))(params)
    program = jax_fleet._fleet_fit_program(spec, jax_training.FitConfig(**config))
    params, _, losses, val_losses, ran = program(params, opt_state, X, X, wtr, X, X, wval, split[:, 0])
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(losses), np.asarray(val_losses), np.asarray(ran)


@pytest.mark.parametrize("name", list(CASES))
def test_stacked_fit_matches_jax_fit_program(name):
    """Shuffle on and off, a validation split, early stopping with and
    without restore-best, the L1 activity term (hourglass(6)'s inner
    encoder layers), a member shorter than the bucket, and a NaN that
    stays with its member."""
    X, wtr, wval, config = _case(name)
    seeds = [11, 12, 13]
    jax_spec, spec = jax_hourglass(6), feedforward_hourglass(6)
    assert spec.l1_activity and spec == type(spec).from_dict(jax_spec.to_dict())
    want_params, want_losses, want_val, want_ran = _jax_fit(jax_spec, config, seeds, X, wtr, wval)

    random = JaxRandom()
    params = fleet.stack_member_params([random.init_params(spec, s) for s in seeds])
    perms = torch.from_numpy(np.stack([random.permutations(s, EPOCHS, ROWS) for s in seeds]))
    Xt = torch.from_numpy(X)
    out = training.StackedFit(spec, training.FitConfig(**config)).run(
        params, Xt, Xt, torch.from_numpy(wtr), torch.from_numpy(wval), perms
    )
    ran = out.epochs_ran.numpy()
    np.testing.assert_array_equal(ran, want_ran)
    for m, epochs in enumerate(ran):  # epochs after a member stopped are never reported
        np.testing.assert_allclose(out.losses.numpy()[m, :epochs], want_losses[m, :epochs], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out.val_losses.numpy()[m, :epochs], want_val[m, :epochs], rtol=LOSS_RTOL)
    for key, layer in want_params.items():
        for leaf, want in layer.items():
            np.testing.assert_allclose(out.params[key][leaf].numpy(), want, atol=PARAM_ATOL, equal_nan=True,
                                       err_msg=f"{key}/{leaf}")
    assert np.isnan(out.losses.numpy()[2, :ran[2]]).all()
    assert np.isfinite(out.losses.numpy()[:2, :ran[0]]).all()  # the NaN stays with its member
    assert np.isnan(out.val_losses.numpy()[1]).all()  # member 1 has no validation rows
    if config["early_stopping"]:
        assert (ran < EPOCHS).all()
    else:
        assert (ran == EPOCHS).all()


def test_all_padding_batches_leave_a_member_unmoved():
    """A member with no training rows at all keeps its initial params."""
    X, wtr, wval, config = _case("no-shuffle-early-stop-restore-best")
    X[2, 5, 0] = 0.5
    wtr[1] = 0.0
    spec = feedforward_hourglass(6)
    params = fleet.stack_member_params([JaxRandom().init_params(spec, s) for s in (1, 2, 3)])
    before = {k: {n: t.clone() for n, t in layer.items()} for k, layer in params.items()}
    out = training.StackedFit(spec, training.FitConfig(**config)).run(
        params, torch.from_numpy(X), torch.from_numpy(X), torch.from_numpy(wtr), torch.from_numpy(wval), None)
    for key, layer in before.items():
        for leaf, t in layer.items():
            assert torch.equal(out.params[key][leaf][1], t[1])
            assert not torch.equal(out.params[key][leaf][0], t[0])
    assert (out.losses[1] == 0).all()  # contributions of 0 over max(sum w, 1)


def _members(module, spec_of, names_rows, seed0=40):
    rng = np.random.RandomState(5)
    members = []
    for i, (name, n_features, rows) in enumerate(names_rows):
        X = rng.rand(rows, n_features).astype(np.float32)
        if name == "diverges":
            X[3, 0] = np.nan
        members.append(module.FleetMember(name=name, spec=spec_of(n_features), X=X, y=X, seed=seed0 + i))
    return members


#: one bucket (5 wide, padded to 128 rows); the diverged member's retry
#: trains alone
MEMBERS = [("a", 5, 70), ("b", 5, 120), ("c", 5, 65), ("d", 5, 100), ("diverges", 5, 90)]


def test_fleet_trainer_buckets_and_retries():
    """Ragged members stack into one bucket; a diverged member retrains
    alone with seed ``seed + 7919``, as the JAX trainer reseeds it
    (``gordo_tpu/parallel/fleet.py:476-531``). The trainer's numbers are
    held against the JAX trainer's through ``fleet_build`` in
    ``tests/test_torch_fleet_build.py``."""
    config = training.FitConfig(epochs=2, batch_size=BATCH, validation_split=0.2)
    trainer = fleet.FleetTrainer(device="cpu", random=JaxRandom())
    members = _members(fleet, lambda n: feedforward_hourglass(n, encoding_layers=2), MEMBERS)
    results = trainer.train(members, config)
    assert [r.name for r in results] == [m.name for m in members]
    assert [(f["members"], f["rows"], f["steps"]) for f in trainer.fits] == [(5, 128, 16), (1, 128, 16)]
    for result in results[:-1]:
        assert result.retries == 0 and result.error is None
        assert list(result.history.history) == ["loss", "val_loss"]
        assert np.isfinite(result.history.history["loss"]).all()
        assert result.history.params == {"epochs": 2, "steps": 8, "verbose": 0, "metrics": ["loss", "val_loss"]}
    diverged = results[-1]
    assert diverged.retries == 1 and diverged.seed == 44 + 7919
    assert diverged.history.params["fleet_retry"] == {"retries": 1, "seed": 44 + 7919}
    assert np.isnan(diverged.history.history["loss"]).all()  # its NaN row diverges again


def test_predict_bucket_matches_jax():
    rng = np.random.RandomState(9)
    spec, jax_spec = feedforward_hourglass(5), jax_hourglass(5)
    per_member = [JaxRandom().init_params(spec, s) for s in range(4)]
    X = rng.rand(4, 33, 5).astype(np.float32)
    want = jax_fleet.FleetTrainer().predict_bucket(
        jax_spec, jax.tree_util.tree_map(lambda *a: np.stack(a), *per_member), X)
    got = fleet.FleetTrainer(device="cpu").predict_bucket(spec, fleet.stack_member_params(per_member), X)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_device_failure_is_bisected_to_its_member():
    trainer = fleet.FleetTrainer(device="cpu")
    members = _members(fleet, feedforward_hourglass, [(n, 5, 40) for n in "abcd"])
    with inject(FaultRule("device_program", match="c", times=None, exc=InjectedDeviceError)):
        results = trainer.train(members, training.FitConfig(epochs=1, batch_size=BATCH))
    assert [r.error is not None for r in results] == [False, False, True, False]
    assert isinstance(results[2].error, InjectedDeviceError) and results[2].params is None
    assert trainer.bucket_bisects == 2 and trainer.bisect_counts == {"a": 1, "b": 1, "c": 2, "d": 2}
    with pytest.raises(ValueError):  # host errors are not bisected
        with inject(FaultRule("device_program", match="a", exc=ValueError)):
            trainer.train(members, training.FitConfig(epochs=1, batch_size=BATCH))


@pytest.mark.parametrize(
    "exc,device",
    [
        (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
        (RuntimeError("fleet_dense kernel launch failed (2): too many resources"), True),
        (InjectedDeviceError("x"), True),
        (RuntimeError("shape mismatch"), False),
        (ValueError("CUDA in a value error"), False),
    ],
)
def test_is_device_error(exc, device):
    assert fleet.is_device_error(exc) is device


def test_fit_kwargs_match_jax():
    kwargs = {"epochs": 4, "batch_size": 8, "validation_split": 0.1, "shuffle": False, "seed": 3,
              "kind": "feedforward_hourglass", "encoding_layers": 2}
    assert training.split_fit_kwargs(kwargs) == jax_training.split_fit_kwargs(kwargs)
    config, host = training.fit_config_from_kwargs(
        {**kwargs, "callbacks": [EarlyStopping(patience=2, min_delta=0.1, restore_best_weights=True)]})
    jax_config, _ = jax_training.fit_config_from_kwargs(
        {**kwargs, "callbacks": [JaxEarlyStopping(patience=2, min_delta=0.1, restore_best_weights=True)]})
    assert host == [] and config.__dict__ == jax_config.__dict__
    with pytest.raises(TypeError):
        training.fit_config_from_kwargs({"callbacks": ["not a callback"]})


def _estimator_fit_against_jax(fit_kwargs):
    """A ``TorchAutoEncoder`` fitted with JAX's randomness, the trainer's
    ``fit_single`` of the same member, and the JAX estimator's fit."""
    from gordo_tpu.models.estimators import JaxAutoEncoder

    rng = np.random.RandomState(3)
    X = rng.rand(90, 5).astype(np.float32)
    kwargs = dict(kind="feedforward_hourglass", epochs=2, batch_size=BATCH, seed=7, **fit_kwargs)
    estimator = TorchAutoEncoder(device="cpu", **kwargs)
    estimator.fit(X, X, random=JaxRandom())
    want = fleet.FleetTrainer(device="cpu", random=JaxRandom()).fit_single(
        fleet.FleetMember("m", feedforward_hourglass(5), X, X, seed=7),
        training.FitConfig(epochs=2, batch_size=BATCH, **fit_kwargs))
    return estimator, want, JaxAutoEncoder(**kwargs).fit(X, X)


def test_estimator_fit_is_a_fleet_of_one():
    """``TorchAutoEncoder.fit`` trains a fleet of one member through the
    trainer's ``fit_single``, as the JAX estimator's ``fit_single`` trains
    it (the train rows padded to whole batches, not to a power of two as
    in a fleet bucket), keeps its history, and pickles numpy only."""
    import pickle

    estimator, want, jax_estimator = _estimator_fit_against_jax({})
    assert estimator.spec_ == feedforward_hourglass(5)
    assert estimator.history.history == want.history.history
    np.testing.assert_array_equal(estimator.params_["out"]["W"].numpy(), want.params["out"]["W"])
    assert estimator.get_metadata()["history"]["params"] == want.history.params == jax_estimator._history.params
    for key in jax_estimator._history.history:
        np.testing.assert_allclose(estimator.history.history[key], jax_estimator._history.history[key], rtol=LOSS_RTOL)
    for key, layer in jax_estimator.params_.items():
        for name, leaf in layer.items():
            np.testing.assert_allclose(estimator.params_[key][name].numpy(), np.asarray(leaf), atol=PARAM_ATOL)
    state = pickle.loads(pickle.dumps(estimator)).__dict__
    assert isinstance(state["params_"]["out"]["W"], np.ndarray) and state["device"] is None
    assert state["kind"] == "feedforward_hourglass" and state["kwargs"]["epochs"] == 2


def test_estimator_fit_single_validation_matches_jax():
    """With a validation split, the last 20% of the rows validate apart
    from the padded train rows: history and params as the JAX estimator's."""
    estimator, want, jax_estimator = _estimator_fit_against_jax({"validation_split": 0.2})
    assert estimator.history.history == want.history.history
    assert list(estimator.history.history) == ["loss", "val_loss"]
    assert want.history.params == jax_estimator._history.params
    for key in jax_estimator._history.history:
        np.testing.assert_allclose(estimator.history.history[key], jax_estimator._history.history[key], rtol=LOSS_RTOL)
    for key, layer in jax_estimator.params_.items():
        for name, leaf in layer.items():
            np.testing.assert_allclose(estimator.params_[key][name].numpy(), np.asarray(leaf), atol=PARAM_ATOL)


def test_training_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.FleetTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAutoEncoder(kind="feedforward_hourglass")
