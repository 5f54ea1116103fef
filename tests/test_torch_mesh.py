"""The port's process mesh and sharded fleet training
(``gordo_tpu_torch/parallel/mesh.py``, ``parallel/fleet.py``) against the
JAX package's device mesh (``gordo_tpu/parallel/mesh.py``, ``fleet.py``),
on the CPU.

- the grid, each rank's coordinates and member block against JAX's
  ``make_mesh`` shapes and shardings over the virtual devices;
- two ranks in one gloo group (processes started here, joined with a
  timeout), each training its block of a ``(2, 1)`` mesh: the gathered
  results equal the port's one-process train to the bit, and JAX's
  ``make_mesh(jax.devices()[:2])`` train with the same injected params and
  permutations within rtol 1e-5, atol 1e-6 (``tests/parallel/
  test_fleet.py:77-92``); the windowed (LSTM) bucket and both forwards
  gathered alike;
- ``(1, 2)``: the data axis's all-reduced gradients against the one-process
  train and JAX's ``data_parallelism=2`` train, rtol 1e-5, atol 1e-6 (the
  f32 sums are taken in another order; measured on the CPU within 1e-7);
- ``(1, 3)`` at batch 32: the samples rounded to ``lcm(32, 3) = 96``
  (``:109-119``);
- ``fleet_plan.json`` of ``plan`` on a two-rank mesh byte-equal to JAX's on
  two devices.
"""

import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models.factories.feedforward_autoencoder import feedforward_hourglass as jax_hourglass
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu.parallel.mesh import model_sharding as jax_model_sharding
from gordo_tpu_torch.models.factories import feedforward_hourglass, lstm_model
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.ops.windows import window_targets
from gordo_tpu_torch.parallel import fleet, mesh
from tests.test_torch_planner import SHARD  # noqa: F401 - the plan command's shard

RTOL, ATOL = 1e-5, 1e-6
#: seconds a group of ranks may take, start to end
JOIN_TIMEOUT = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, BATCH = 2, 16

#: one rank: joins the group, trains the job's members on its mesh,
#: forwards them, writes its results and fits
WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
rank, world, port, job_path, out_path = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
from gordo_tpu_torch.parallel import mesh as M
from gordo_tpu_torch.parallel.fleet import FleetTrainer, stack_member_params
from gordo_tpu_torch.models.training import TorchRandom
from gordo_tpu_torch.utils.faults import InjectedDeviceError
job = pickle.load(open(job_path, "rb"))

class Injected(TorchRandom):
    # the job's params and permutations (default the port's), and its failure on one rank
    def init_params(self, spec, seed):
        fail = job.get("fail")
        if fail and fail["rank"] == rank and fail["seed"] == seed:
            raise InjectedDeviceError("injected") if fail["kind"] == "device" else ValueError("injected host error")
        return job["inits"][seed] if job["inits"] else super().init_params(spec, seed)
    def permutations(self, seed, epochs, n):
        return job["perms"][(seed, epochs, n)] if job["perms"] else super().permutations(seed, epochs, n)

M.initialize_backend(f"localhost:{port}", world, rank, device="cpu", timeout_s=120)
try:
    trainer = FleetTrainer(random=Injected(), mesh=M.make_mesh(job["data"], device="cpu"))
    try:
        results = trainer.train(job["members"], job["config"])
    except Exception as exc:
        with open(out_path, "wb") as f:
            pickle.dump({"raised": repr(exc)}, f)
        raise SystemExit(3)
    forwards = {}
    for key, (spec, names, X) in job.get("forwards", {}).items():
        params = stack_member_params([next(r.params for r in results if r.name == n) for n in names])
        params = {k: {n: t.numpy() for n, t in layer.items()} for k, layer in params.items()}
        if key == "dense":
            forwards[key] = trainer.predict_bucket(spec, params, X)
        else:
            forwards[key] = trainer.predict_windowed_bucket(spec, params, X[0], X[1], batch_size=32)
    with open(out_path, "wb") as f:
        pickle.dump({"results": [(r.name, r.params, r.history.history, repr(r.error) if r.error else None)
                                 for r in results],
                     "fits": trainer.fits, "coords": trainer.mesh.coords, "forwards": forwards,
                     "bisects": trainer.bucket_bisects}, f)
finally:
    M.shutdown_backend()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_ranks(tmp_path, world, job, codes=None):
    """Every rank's output of ``job`` over a ``world``-rank gloo group, each
    rank exiting with ``codes`` (default 0)."""
    job_path = tmp_path / "job.pkl"
    job_path.write_bytes(pickle.dumps(job))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(port), str(job_path),
                               str(tmp_path / f"out{r}.pkl")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=JOIN_TIMEOUT)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log, code in zip(procs, logs, codes or [0] * world):
        assert p.returncode == code, log[-4000:]
    return [pickle.loads((tmp_path / f"out{r}.pkl").read_bytes()) for r in range(world)]


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return jax_init(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


def _dense(rows=(70, 100, 45), seed=0, features=5):
    rng = np.random.RandomState(seed)
    return [(f"m{i}", rng.rand(n, features).astype(np.float32), 11 + i) for i, n in enumerate(rows)]


def _injected(data, epochs=EPOCHS, totals=(64, 128, 256)):
    spec = jax_hourglass(data[0][1].shape[1])
    inits = {s: jax.tree_util.tree_map(np.array, _jax_init_params(s, spec)) for _, _, s in data}
    perms = {(s, epochs, n): np.array(_jax_permutations(s, epochs, n)) for _, _, s in data for n in totals}
    return inits, perms


def _port_members(data):
    spec = feedforward_hourglass(data[0][1].shape[1])
    return [fleet.FleetMember(name, spec, X, X, seed=seed) for name, X, seed in data]


def _jax_train(data, config, devices, data_parallelism=1):
    spec = jax_hourglass(data[0][1].shape[1])
    members = [jax_fleet.FleetMember(name=n, spec=spec, X=X, y=X, seed=s) for n, X, s in data]
    trainer = jax_fleet.FleetTrainer(mesh=jax_make_mesh(devices, data_parallelism=data_parallelism))
    return trainer.train(members, JaxFitConfig(**config))


def _assert_results(got, want, exact=False):
    """Member for member: params and losses, exactly or within tolerance."""
    check = np.testing.assert_array_equal if exact else functools.partial(
        np.testing.assert_allclose, rtol=RTOL, atol=ATOL)
    for (name, params, history, error), expected in zip(got, want):
        assert error is None and name == expected.name
        for key, layer in expected.params.items():
            for leaf, value in layer.items():
                check(params[key][leaf], np.asarray(value), err_msg=f"{name} {key}/{leaf}")
        assert list(history) == list(expected.history.history)
        for metric, values in expected.history.history.items():
            check(np.asarray(history[metric]), np.asarray(values), err_msg=f"{name} {metric}")


def _one_process(members, config, random=None):
    return fleet.FleetTrainer("cpu", random=random).train(members, config)


class _Injected:
    def __init__(self, inits, perms):
        self.inits, self.perms = inits, perms

    def init_params(self, spec, seed):
        return self.inits[seed]

    def permutations(self, seed, epochs, n):
        return self.perms[(seed, epochs, n)]


# -- the grid ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("world,data", [(2, 1), (2, 2), (4, 2), (6, 3), (8, 1), (8, 4)])
def test_grid_and_blocks_match_jax(monkeypatch, world, data):
    """Each rank's mesh: JAX's grid shape, the rank's place in it (rank r
    is JAX's device r), and its member block JAX's shard of that device."""
    jax_mesh = jax_make_mesh(jax.devices()[:world], data_parallelism=data)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(mesh.dist, "new_group", lambda ranks: tuple(ranks))
    monkeypatch.setattr(mesh, "_meshes", {})
    for members in (5, world * 3, 1):
        m_total = -(-members // jax_mesh.devices.shape[0]) * jax_mesh.devices.shape[0]
        indices = jax_model_sharding(jax_mesh).devices_indices_map((m_total,))
        for rank in range(world):
            monkeypatch.setattr(mesh.dist, "get_rank", lambda r=rank: r)
            port = mesh.make_mesh(data, device="cpu")
            assert port.shape == jax_mesh.devices.shape and port.axis_names == jax_mesh.axis_names
            device = jax.devices()[rank]
            assert port.coords == tuple(int(i) for i in np.argwhere(jax_mesh.devices == device)[0])
            assert port.data_group == (tuple(int(r) for r in port.devices[port.coords[0]]) if data > 1 else None)
            want = range(m_total)[indices[device][0]]
            block = mesh.model_sharding(port, members)
            assert (block.start, block.stop) == (min(want.start, members), min(want.stop, members))


def test_no_process_group_is_the_one_device_mesh():
    one = mesh.make_mesh(device="cpu")
    assert one.shape == (1, 1) and one.coords == (0, 0) and not one.distributed
    assert one.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh(2, device="cpu")
    assert mesh.initialize_backend() is None
    with pytest.raises(ValueError, match="nccl"):
        mesh.initialize_backend("localhost:1", 2, 0, backend="nccl", device="cpu")


# -- sharded training ------------------------------------------------------------------------------------------


def _windowed_members():
    spec = lstm_model(3, lookback_window=4, encoding_dim=(6,), encoding_func=("tanh",), decoding_dim=(6,),
                      decoding_func=("tanh",))
    rng = np.random.RandomState(9)
    out = []
    for i, n in enumerate((90, 60, 75)):
        series = rng.rand(n, 3).astype(np.float32)
        out.append(fleet.WindowedFleetMember(f"w{i}", spec, series, window_targets(series, 4, 0), seed=30 + i))
    return out


def _job(data_parallelism, shuffle=True):
    data = _dense()
    inits, perms = _injected(data)
    config = dict(epochs=EPOCHS, batch_size=BATCH, validation_split=0.2, shuffle=shuffle)
    members = _port_members(data)
    X = np.stack([np.pad(x, ((0, 100 - len(x)), (0, 0))) for _, x, _ in data])
    return data, config, {"members": members, "config": FitConfig(**config), "data": data_parallelism,
                          "inits": inits, "perms": perms,
                          "forwards": {"dense": (members[0].spec, [m.name for m in members], X)}}


def test_two_ranks_model_axis_equal_one_process_and_match_jax(tmp_path):
    data, config, job = _job(1)
    outs = _run_ranks(tmp_path, 2, job)
    assert [o["coords"] for o in outs] == [(0, 0), (1, 0)]
    # two buckets (128 and 64 rows): each rank trained its block of each,
    # JAX's [m0], [m1] and [m2], [dummy]
    assert [[f["names"] for f in o["fits"]] for o in outs] == [[["m0"], ["m2"]], [["m1"]]]
    local = _one_process(job["members"], job["config"], _Injected(job["inits"], job["perms"]))
    _assert_results(outs[0]["results"], local, exact=True)
    _assert_results(outs[1]["results"], local, exact=True)
    _assert_results(outs[0]["results"], _jax_train(data, config, jax.devices()[:2]))
    # the gathered forward: every rank holds the whole [M, N, F] prediction
    spec, names, X = job["forwards"]["dense"]
    stacked = {k: {n: np.stack([r[1][k][n] for r in outs[0]["results"]]) for n in layer}
               for k, layer in outs[0]["results"][0][1].items()}
    want = fleet.FleetTrainer("cpu").predict_bucket(spec, stacked, X)
    for out in outs:
        np.testing.assert_array_equal(out["forwards"]["dense"], want)


def test_two_ranks_windowed_bucket_equal_one_process(tmp_path):
    """An LSTM bucket over ``(2, 1)``: each rank its block of series, the
    gathered results and windowed forward the one-process ones."""
    members = _windowed_members()
    config = FitConfig(epochs=1, batch_size=BATCH, shuffle=False)
    order = np.stack([np.arange(50) for _ in members])
    series = np.stack([m.series[:60] for m in members])
    job = {"members": members, "config": config, "data": 1, "inits": None, "perms": None,
           "forwards": {"windowed": (members[0].spec, [m.name for m in members], (series, order))}}
    outs = _run_ranks(tmp_path, 2, job)
    local = _one_process(members, config)
    for out in outs:
        _assert_results(out["results"], local, exact=True)
    stacked = {k: {n: np.stack([r.params[k][n] for r in local]) for n in layer}
               for k, layer in local[0].params.items()}
    want = fleet.FleetTrainer("cpu").predict_windowed_bucket(members[0].spec, stacked, series, order, batch_size=32)
    for out in outs:
        np.testing.assert_array_equal(out["forwards"]["windowed"], want)


def test_a_failure_on_one_rank_is_every_ranks(tmp_path):
    """A device error in one rank's block bisects the bucket on both ranks
    (the failing member's half then trains on rank 0, where it does not
    fail); a host error on one rank fails the train on both."""
    data = _dense()
    members = _port_members(data)
    config = FitConfig(epochs=1, batch_size=BATCH, shuffle=False)
    job = {"members": members, "config": config, "data": 1, "inits": None, "perms": None,
           "fail": {"rank": 1, "seed": 12, "kind": "device"}}
    outs = _run_ranks(tmp_path, 2, job)
    local = _one_process(members, config)
    for out in outs:
        assert out["bisects"] == 1
        _assert_results(out["results"], local, exact=True)
    # rank 0: its block of the failed bucket, then each half, then the 64-row bucket; rank 1 trained none
    assert [f["names"] for f in outs[0]["fits"]] == [["m0"], ["m0"], ["m1"], ["m2"]]
    assert [f["names"] for f in outs[1]["fits"]] == [] and outs[1]["bisects"] == 1
    job["fail"]["kind"] = "host"
    outs = _run_ranks(tmp_path, 2, job, codes=[3, 3])
    assert "RankError" in outs[0]["raised"] and "injected host error" in outs[1]["raised"]


def test_data_axis_matches_one_process_and_jax(tmp_path):
    """``(1, 2)``: both ranks train every member on half of each batch's
    rows and apply the same all-reduced update."""
    data, config, job = _job(2)
    job["forwards"] = {}
    outs = _run_ranks(tmp_path, 2, job)
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1)]
    assert all([f["names"] for f in o["fits"]] == [["m0", "m1"], ["m2"]] for o in outs)
    _assert_results(outs[1]["results"], [_to_result(r) for r in outs[0]["results"]], exact=True)
    local = _one_process(job["members"], job["config"], _Injected(job["inits"], job["perms"]))
    _assert_results(outs[0]["results"], local)
    _assert_results(outs[0]["results"], _jax_train(data, config, jax.devices()[:2], data_parallelism=2))


def _to_result(entry):
    from gordo_tpu_torch.models.training import History

    name, params, history, _ = entry
    return fleet.FleetResult(name=name, params=params, history=History(history=history, params={}, epoch=[]))


def test_lcm_padding_at_data_3(tmp_path):
    """Data axis 3 and batch 32: the sample axis rounds to 96 rows, a whole
    number of batches that divides across the axis."""
    data = _dense(rows=(20, 20))
    config = FitConfig(epochs=1, batch_size=32, shuffle=False)
    members = _port_members(data)
    outs = _run_ranks(tmp_path, 3, {"members": members, "config": config, "data": 3, "inits": None,
                                    "perms": None})
    assert all(f["rows"] == 96 for o in outs for f in o["fits"])
    for name, _, history, error in outs[0]["results"]:
        assert error is None and np.isfinite(history["loss"]).all()
    _assert_results(outs[0]["results"], _one_process(members, config))


# -- the plan ---------------------------------------------------------------------------------------------------


def test_fleet_plan_on_a_two_rank_mesh_matches_jax(tmp_path, capsys, monkeypatch):
    """``plan --as-json`` on a ``(2, 1)`` mesh: JAX's bytes on two devices
    (the member axis rounded to the model axis, ``mesh_shape`` [2, 1])."""
    from click.testing import CliRunner

    from gordo_tpu.cli.cli import gordo_tpu_cli
    from gordo_tpu_torch.cli.cli import main

    path = tmp_path / "shard.json"
    path.write_text(json.dumps(SHARD))
    monkeypatch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:2]))
    two = mesh.Mesh(np.arange(2).reshape(2, 1), 0, torch.device("cpu"))
    monkeypatch.setattr(fleet, "make_mesh", lambda *a, **k: two)
    for strategy in ("naive", "packed"):
        expected = CliRunner().invoke(gordo_tpu_cli, ["plan", str(path), "--strategy", strategy, "--as-json"])
        assert expected.exit_code == 0, expected.output
        assert main(["plan", str(path), "--strategy", strategy, "--as-json", "--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert got == expected.stdout
        assert json.loads(got)["mesh_shape"] == [2, 1]
