"""The port's training path on the card: a stacked fit on CUDA against
the same fit on the CPU, and ``FleetTrainer.predict_bucket`` (one K1
launch) against K1's plain version at the cross-validation shapes of the
served fleet: the 20-tag group (192 fold members x 500 test rows, the
narrow kernel) and the 40-tag one (24 x 500, the wide kernel); and the
fleet build of one ``DiffBasedKFCVAnomalyDetector`` machine, its data
fetched by its ``RandomDataProvider``, on the card against the CPU.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_training_cuda.py

Tolerances: K1 against its plain version rtol 1e-5, atol 1e-5 (f32 sums
in another order). The fit, card against CPU, TF32 off: losses rtol
1e-5, params atol 1e-3 after three epochs. cuBLAS and the CPU's BLAS sum
in other orders, and Adam divides each gradient by its own running
scale, so the last-bit difference of a near-zero gradient can move one
parameter by a few steps of the learning rate: measured on an H100, 1
element of 130 2.5e-4 apart, the rest within 1e-5. The KFCV build is
held to ``chip_smoke.py``'s build limits: params atol 1e-6, thresholds
rtol 3e-6, epochs equal.
"""

import numpy as np
import pytest
import torch

from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.nn import init_feedforward
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference
from gordo_tpu_torch.parallel.fleet import FleetMember, FleetTrainer, stack_member_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _members(n_features, count, rows, seed=0):
    rng = np.random.RandomState(seed)
    members = []
    for i in range(count):
        X = (20 + 10 * rng.rand(rows - 7 * i, n_features)).astype(np.float32)
        X = (X - X.min(0)) / (X.max(0) - X.min(0))
        members.append(FleetMember(f"m-{i}", feedforward_hourglass(n_features), X, X, seed=100 + i))
    return members


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", [20, 40])
def test_fit_on_card_matches_cpu(cuda, n_features):
    config = FitConfig(epochs=3, batch_size=32, validation_split=0.1)
    members = _members(n_features, 4, 300)
    card = FleetTrainer(cuda).train(members, config)
    host = FleetTrainer("cpu").train(members, config)
    for got, want in zip(card, host):
        assert got.history.epoch == want.history.epoch and got.history.params == want.history.params
        for key in want.history.history:
            np.testing.assert_allclose(got.history.history[key], want.history.history[key], rtol=1e-5)
        for key, layer in want.params.items():
            for leaf, value in layer.items():
                np.testing.assert_allclose(got.params[key][leaf], value, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_features,members", [(20, 192), (40, 24)])
def test_predict_bucket_launches_k1_at_the_cv_shape(cuda, n_features, members):
    spec = feedforward_hourglass(n_features)
    gen = torch.Generator().manual_seed(5)
    per_member = [init_feedforward(spec, gen) for _ in range(members)]
    X = torch.rand(members, 500, n_features, generator=gen).numpy()
    trainer = FleetTrainer(cuda)
    launches = fleet_feedforward.launches
    got = trainer.predict_bucket(spec, stack_member_params(per_member), X)
    assert fleet_feedforward.launches == launches + 1
    expected = fleet_feedforward_reference(
        spec, stack_member_params(per_member, cuda), torch.from_numpy(X).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kfcv_fleet_build_on_card_matches_cpu(cuda):
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    config = {
        "name": "kfcv-1",
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": {"base_estimator": {
            "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
                "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 2}}]}}}},
        "dataset": {"train_start_date": "2020-02-01T00:00:00+00:00", "train_end_date": "2020-02-08T00:00:00+00:00",
                    "tag_list": [f"tag-{i:02d}" for i in range(20)],
                    "data_provider": {"type": "RandomDataProvider", "min_size": 900, "max_size": 1100}},
    }
    built = {}
    for device in (cuda, "cpu"):
        builder = FleetBuilder([Machine.from_config(config, "card-test")], device=device)
        ((model, machine),) = builder.build()
        assert not builder.build_errors
        built[str(device)] = (model, machine.metadata["build_metadata"]["model"])
    (card, card_meta), (host, host_meta) = built["cuda"], built["cpu"]
    assert card_meta["training"]["epochs_run"] == host_meta["training"]["epochs_run"]
    np.testing.assert_allclose(card.feature_thresholds_, host.feature_thresholds_, rtol=3e-6)
    np.testing.assert_allclose(card.aggregate_threshold_, host.aggregate_threshold_, rtol=3e-6)
    for key, layer in host.base_estimator.estimator.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(card.base_estimator.estimator.params_[key][leaf].cpu().numpy(),
                                       value.cpu().numpy(), atol=1e-6)
