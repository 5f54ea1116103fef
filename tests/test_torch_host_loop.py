"""The port's per-epoch host loop (``models/training.py::StackedFit._fit_host_loop``,
reached through ``FleetTrainer.fit_single`` and the estimators' ``fit``)
against the JAX package's ``fit_single(host_callbacks=...)``
(``gordo_tpu/models/training.py::_fit_host_loop``), with the JAX
randomness injected: the init from ``split(PRNGKey(seed))[1]``, and each
epoch's permutation from the host loop's own key chain (``rng, erng =
split(rng)``, then ``split(erng, 1)[0]``).

Compared: the loss and val_loss history, the learning rate each epoch
ran at (a recording callback reads ``logs["lr"]``), the epochs run and
the history's ``params``, equal or at the loss tolerance of
``tests/test_torch_training.py`` (rtol 1e-5); final params at its atol
1e-5. Measured on the CPU (torch 2.13, jax 0.9): losses within 1.3e-7
relative, params within 1.2e-7.
"""

import functools

import jax
import numpy as np
import pytest

from gordo_tpu.models import callbacks as jax_callbacks
from gordo_tpu.models.estimators import JaxAutoEncoder, JaxLSTMAutoEncoder
from gordo_tpu.models.nn import init_feedforward, init_lstm
from gordo_tpu_torch.models import callbacks, training
from gordo_tpu_torch.models.estimators import TorchAutoEncoder, TorchLSTMAutoEncoder
from gordo_tpu_torch.models.spec import LSTMSpec

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@functools.partial(jax.jit, static_argnums=1)
def _jax_init(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return (init_lstm if isinstance(spec, LSTMSpec) else init_feedforward)(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_host_loop_permutations(seed, epochs, n_total):
    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    perms = []
    for _ in range(epochs):
        rng, erng = jax.random.split(rng)
        perms.append(jax.random.permutation(jax.random.split(erng, 1)[0], n_total))
    return jax.numpy.stack(perms)


class JaxHostLoopRandom:
    """The JAX ``fit_single`` host loop's randomness, for the port's trainer."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init(seed, spec))

    def host_loop_permutations(self, seed, epochs, n_total):
        return np.array(_jax_host_loop_permutations(seed, epochs, n_total))


def recorder(base):
    class Recorder(base):
        """Keeps the learning rate of every epoch's logs."""

        def __init__(self):
            self.lrs = []

        def on_epoch_end(self, epoch, logs=None):
            self.lrs.append(logs["lr"])
            return False

    return Recorder()


def both_callbacks(spec):
    """``[(name, kwargs)]`` as the port's and the JAX package's objects, a
    learning-rate recorder last in each list."""
    port = [getattr(callbacks, name)(**kwargs) for name, kwargs in spec] + [recorder(callbacks.Callback)]
    jax_side = [getattr(jax_callbacks, name)(**kwargs) for name, kwargs in spec] + [recorder(jax_callbacks.Callback)]
    return port, jax_side


CASES = {
    # plateaus halve the rate twice; early stopping ends the fit before its epochs
    "loss-plateau-early-stop": (dict(epochs=16, batch_size=16), [
        ("EarlyStopping", {"monitor": "loss", "patience": 2, "min_delta": 0.007}),
        ("ReduceLROnPlateau", {"monitor": "loss", "factor": 0.5, "patience": 1, "min_delta": 0.01}),
        ("TerminateOnNaN", {}),
    ]),
    # validation rows: val_loss monitored, a cooldown, restore-best (which the host loop ignores)
    "val-loss-cooldown": (dict(epochs=8, batch_size=16, validation_split=0.2), [
        ("ReduceLROnPlateau", {"monitor": "val_loss", "factor": 0.3, "patience": 1, "min_delta": 0.05,
                               "cooldown": 1, "min_lr": 1e-4}),
        ("EarlyStopping", {"monitor": "val_loss", "patience": 2, "min_delta": 0.02, "restore_best_weights": True}),
    ]),
    # a NaN reading: the first epoch's loss is NaN and TerminateOnNaN stops
    "terminate-on-nan": (dict(epochs=5, batch_size=16), [("TerminateOnNaN", {}), ("ReduceLROnPlateau", {})]),
}


def rows(name, n=90, f=5):
    rng = np.random.RandomState(len(name))
    X = rng.rand(n, f).astype(np.float32)
    if name == "terminate-on-nan":
        X[17, 2] = np.nan
    return X


def assert_fits_agree(port, jax_est, port_cbs, jax_cbs):
    want = jax_est._history
    got = port.history
    assert list(got.history) == list(want.history)
    for key in want.history:
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=LOSS_RTOL, equal_nan=True)
    assert got.epoch == want.epoch and got.params == want.params
    assert port_cbs[-1].lrs == jax_cbs[-1].lrs
    for key, layer in jax_est.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(port.params_[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL,
                                       equal_nan=True, err_msg=f"{key}/{leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_dense_host_loop_matches_jax(name):
    fit_kwargs, spec = CASES[name]
    X = rows(name)
    port_cbs, jax_cbs = both_callbacks(spec)
    kwargs = dict(kind="feedforward_hourglass", encoding_layers=2, seed=11, **fit_kwargs)
    port = TorchAutoEncoder(device="cpu", callbacks=port_cbs, **kwargs).fit(X, X, random=JaxHostLoopRandom())
    jax_est = JaxAutoEncoder(callbacks=jax_cbs, **kwargs).fit(X, X)
    assert_fits_agree(port, jax_est, port_cbs, jax_cbs)
    ran = len(port.history.epoch)
    lrs = port_cbs[-1].lrs
    if name == "loss-plateau-early-stop":
        assert ran < fit_kwargs["epochs"] and len(set(lrs)) >= 3, (ran, lrs)
    elif name == "val-loss-cooldown":
        assert "val_loss" in port.history.history and len(set(lrs)) >= 2, lrs
    else:
        assert ran == 1 and np.isnan(port.history.history["loss"][0])


def test_windowed_host_loop_matches_jax():
    """An LSTM estimator's host loop over its windows, never shuffled."""
    X = rows("lstm", n=70, f=3)
    port_cbs, jax_cbs = both_callbacks([("ReduceLROnPlateau", {"monitor": "loss", "patience": 1, "min_delta": 0.05,
                                                                "factor": 0.5}),
                                        ("EarlyStopping", {"monitor": "loss", "patience": 2, "min_delta": 0.01})])
    kwargs = dict(kind="lstm_hourglass", lookback_window=4, encoding_layers=1, epochs=6, batch_size=16, seed=5)
    port = TorchLSTMAutoEncoder(device="cpu", callbacks=port_cbs, **kwargs).fit(X, X, random=JaxHostLoopRandom())
    jax_est = JaxLSTMAutoEncoder(callbacks=jax_cbs, **kwargs).fit(X, X)
    assert_fits_agree(port, jax_est, port_cbs, jax_cbs)
    assert len(set(port_cbs[-1].lrs)) >= 2


def test_early_stopping_rides_the_host_loop():
    """With host callbacks, EarlyStopping is a host callback ahead of them,
    as in JAX (it was dropped before), and runs its own epoch hook."""
    es, plateau = callbacks.EarlyStopping(monitor="loss", patience=1), callbacks.ReduceLROnPlateau()
    config, host = training.fit_config_from_kwargs({"epochs": 3, "callbacks": [plateau, es]})
    jax_config, jax_host = jax_training_config([plateau, es])
    assert host == [es, plateau] and config.early_stopping is None
    assert [type(cb).__name__ for cb in jax_host] == [type(cb).__name__ for cb in host]
    assert config.__dict__ == jax_config.__dict__
    es.on_train_begin()
    assert [es.on_epoch_end(i, {"loss": v}) for i, v in enumerate([3.0, 2.0, 2.5])] == [False, False, True]


def jax_training_config(port_cbs):
    from gordo_tpu.models import training as jax_training

    jax_cbs = [getattr(jax_callbacks, type(cb).__name__)(**cb.get_params()) for cb in port_cbs]
    return jax_training.fit_config_from_kwargs({"epochs": 3, "callbacks": jax_cbs})


@pytest.mark.parametrize("logs_seq", [
    [{"loss": 1.0, "lr": 0.1}, {"loss": 1.0, "lr": 0.1}, {"loss": 0.99995, "lr": 0.1}, {"loss": 2.0, "lr": 0.05}],
    [{"loss": 1.0, "val_loss": 3.0, "lr": 0.2}, {"loss": 0.5, "val_loss": 3.0, "lr": 0.2},
     {"loss": float("nan"), "lr": 0.2}, {"loss": 0.4, "lr": 0.2}, {"loss": 0.4, "lr": 0.2}],
])
@pytest.mark.parametrize("kwargs", [{}, {"monitor": "loss", "patience": 1, "cooldown": 1, "min_lr": 0.06},
                                    {"monitor": "val_loss", "patience": 1, "factor": 0.5, "mode": "max"}])
def test_reduce_lr_on_plateau_matches_jax(logs_seq, kwargs):
    """Request by request, as the JAX callback: the ``loss`` fallback of an
    absent monitor, the cooldown, ``min_lr``, and ``mode`` ignored."""
    ours, theirs = callbacks.ReduceLROnPlateau(**kwargs), jax_callbacks.ReduceLROnPlateau(**kwargs)
    ours.on_train_begin()
    theirs.on_train_begin()
    for epoch, logs in enumerate(logs_seq):
        assert ours.on_epoch_end(epoch, logs) == theirs.on_epoch_end(epoch, logs)
        assert ours.consume_lr_request() == theirs.consume_lr_request()
    assert ours.get_params() == theirs.get_params()
    with pytest.raises(ValueError):
        callbacks.ReduceLROnPlateau(factor=1.0)
