"""The port's packed fleet fit on the card (``models/packing.py``,
``FleetTrainer(packing=)``) against the same fit on the CPU. A packed
build from a ``packed`` plan on the card against the CPU's is
``chip_smoke.py``'s ``[packing]``.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_packing_cuda.py

Tolerances as ``tests/test_torch_training_cuda.py`` holds the unpacked
fit, TF32 off: losses rtol 1e-5, params atol 1e-3 (a near-zero
gradient's last bit moves one parameter by a few learning-rate steps
under Adam).
"""

import numpy as np
import pytest
import torch

from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.parallel.fleet import FleetMember, FleetTrainer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _members(n_features, count, seed=0):
    """``count`` members of 300 to 300 - 5 (count - 1) rows: one pad
    target (512), ragged packs."""
    rng = np.random.RandomState(seed)
    members = []
    for i in range(count):
        X = rng.rand(300 - 5 * i, n_features).astype(np.float32)
        members.append(FleetMember(f"m-{i}", feedforward_hourglass(n_features), X, X, seed=100 + i))
    return members


@pytest.mark.cuda
@pytest.mark.parametrize("n_features,count", [(20, 8), (40, 5)])
def test_packed_fit_on_card_matches_cpu(cuda, n_features, count):
    config = FitConfig(epochs=3, batch_size=32, validation_split=0.1)
    card_trainer = FleetTrainer(cuda, packing="auto")
    card = card_trainer.train(_members(n_features, count), config)
    host = FleetTrainer("cpu", packing="auto").train(_members(n_features, count), config)
    assert card_trainer.fits[0]["packed"] == (6 if n_features == 20 else 3)
    for got, want in zip(card, host):
        assert got.history.params == want.history.params and got.history.params["packed"] > 1
        for key in want.history.history:
            np.testing.assert_allclose(got.history.history[key], want.history.history[key], rtol=1e-5)
        for key, layer in want.params.items():
            for leaf, value in layer.items():
                np.testing.assert_allclose(got.params[key][leaf], value, atol=1e-3)
