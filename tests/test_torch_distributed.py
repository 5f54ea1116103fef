"""The port's ``build-fleet`` across processes (``cli/cli.py``,
``parallel/mesh.py``) against a one-process build, on the CPU, as
``tests/parallel/test_distributed.py:123`` holds the JAX command.

- two processes started with the variables the JAX workflow template
  injects (``JAX_PROCESS_COUNT``, ``JAX_PROCESS_INDEX``,
  ``JAX_COORDINATOR_ADDRESS``) form one gloo group and build the shard
  over a ``(2, 1)`` mesh: the coordinator's artifacts equal a one-process
  build's (params to the bit, the CV scores and thresholds), its telemetry
  files are written with ``fleet_plan.json``'s ``mesh_shape`` [2, 1], and
  the second process writes nothing;
- a group that does not form within the join timeout (``mesh``'s
  ``DEFAULT_TIMEOUT_S``, patched to 3 s) fails the build with exit code 1;
- on a host with two cards (``torch.cuda.device_count`` patched), the
  library's ``build_fleet(device="cuda")`` stays one rank in its own
  process and hands its builder back, while the command line spawns one
  rank a card, and a device that names its card spawns nothing;
- the mirror filters of a non-coordinator (resume and model register),
  without spawning: the machines rank 0 will skip, read without a write.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gordo_tpu_torch import serializer
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.models.estimators import find_estimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 240
PROJECT = "dist-test"


def _machine(name, days, tags, encoding_layers=1):
    model = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": encoding_layers,
                                                "epochs": 2}}]}}}}
    return {"name": name, "project_name": PROJECT, "model": model, "dataset": {
        "train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": f"2020-01-{1 + days:02d}T00:00:00+00:00",
        "tag_list": tags, "data_provider": {"type": "RandomDataProvider"}}}


#: five machines of two specs, 145 to 433 rows
SHARD = {"machines": [_machine(f"dist-{i}", days, ["a", "b", "c"]) for i, days in enumerate((1, 2, 3))]
         + [_machine(f"wide-{i}", days, ["a", "b", "c", "d"], 2) for i, days in enumerate((1, 2))]}
NAMES = [m["name"] for m in SHARD["machines"]]


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist") / "shard.json"
    path.write_text(json.dumps(SHARD))
    return str(path)


@pytest.fixture(scope="module")
def single(shard, tmp_path_factory):
    out = tmp_path_factory.mktemp("single") / "1"
    assert cli.main(["build-fleet", shard, str(out), "--device", "cpu"]) == 0
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _ranks(shard, out_dirs, count):
    """``build-fleet`` in ``len(out_dirs)`` processes of a ``count``-process
    layout, each with its own output directory; their exit codes and logs."""
    port = _free_port()
    procs = []
    for index, out in enumerate(out_dirs):
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_PROCESS_COUNT": str(count),
               "JAX_PROCESS_INDEX": str(index), "JAX_COORDINATOR_ADDRESS": f"localhost:{port}"}
        procs.append(subprocess.Popen([sys.executable, "-m", "gordo_tpu_torch", "build-fleet", shard, str(out),
                                       "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=JOIN_TIMEOUT)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], logs


def _params(model):
    return find_estimator(model).params_


def test_two_process_build_fleet_matches_single_process(shard, single, tmp_path):
    out_dirs = [tmp_path / "rank0" / "1", tmp_path / "rank1" / "1"]
    codes, logs = _ranks(shard, out_dirs, 2)
    assert codes == [0, 0], "\n".join(log[-3000:] for log in logs)
    assert not out_dirs[1].exists() and not out_dirs[1].parent.exists()
    for name in NAMES:
        got = serializer.load(str(out_dirs[0] / name), device="cpu")
        want = serializer.load(str(single / name), device="cpu")
        for key, layer in _params(want).items():
            for leaf, value in layer.items():
                np.testing.assert_array_equal(_params(got)[key][leaf].numpy(), value.numpy(), err_msg=name)
        meta = [json.loads((d / name / "metadata.json").read_text())["metadata"]["build_metadata"]["model"]
                for d in (out_dirs[0], single)]
        assert meta[0]["cross_validation"]["scores"] == meta[1]["cross_validation"]["scores"], name
        np.testing.assert_array_equal(got.feature_thresholds_, want.feature_thresholds_)
        assert got.aggregate_threshold_ == want.aggregate_threshold_
    for telemetry_file in ("build_status.json", "build_trace.jsonl", "fleet_plan.json"):
        assert (out_dirs[0] / telemetry_file).exists(), telemetry_file
    plan = json.loads((out_dirs[0] / "fleet_plan.json").read_text())
    assert plan["mesh_shape"] == [2, 1]
    assert json.loads((single / "fleet_plan.json").read_text())["mesh_shape"] == [1, 1]
    assert "rank 1: side effects skipped" in logs[1]


def test_a_group_that_does_not_form_fails_the_build(shard, tmp_path, monkeypatch):
    """The coordinator of a two-process layout waits for its peer, then
    fails, and leaves no group behind."""
    import torch.distributed as dist

    from gordo_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT_S", 3.0)
    monkeypatch.setenv("JAX_PROCESS_COUNT", "2")
    monkeypatch.setenv("JAX_PROCESS_INDEX", "0")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"localhost:{_free_port()}")
    code, builder = cli.build_fleet(shard, str(tmp_path / "alone"), "cpu")
    assert code == 1 and builder is None
    assert not (tmp_path / "alone").exists() and not dist.is_initialized()


def test_missing_coordinator_address_fails(shard, tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_PROCESS_COUNT", "2")
    monkeypatch.setenv("JAX_PROCESS_INDEX", "1")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    code, builder = cli.build_fleet(shard, str(tmp_path / "out"), "cpu")
    assert code == 1 and builder is None


class _Builder:
    """A ``FleetBuilder`` that records its device and builds nothing."""

    def __init__(self, machines, device=None, **_):
        self.machines, self.device, self.resumed, self.build_errors = machines, device, [], {}

    def build(self, output_dir, model_register_dir=None, resume=False):
        return []  # FleetBuilder.build's (model, machine) results: none built


def test_build_fleet_spawns_only_from_the_command_line(shard, tmp_path, monkeypatch):
    """Two visible cards: the library call is one rank in this process on
    the default card, its builder handed back (what a caller reads its
    results and its kernel counts from); ``build-fleet --device cuda``
    spawns one rank a card as process 0 of 1; ``--device cuda:0`` names a
    card and runs in this process."""
    import torch
    import torch.multiprocessing as mp

    from gordo_tpu_torch.parallel import fleet_build

    for var in ("JAX_PROCESS_COUNT", "JAX_PROCESS_INDEX", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(fleet_build, "FleetBuilder", _Builder)
    spawned = []
    monkeypatch.setattr(mp, "start_processes", lambda fn, args, nprocs, start_method: spawned.append((args, nprocs)))
    code, builder = cli.build_fleet(shard, str(tmp_path / "library"), device="cuda")
    assert code == 0 and isinstance(builder, _Builder) and not spawned
    assert builder.device == "cuda" and [m.name for m in builder.machines] == NAMES
    assert cli.main(["build-fleet", shard, str(tmp_path / "command"), "--device", "cuda"]) == 0
    assert len(spawned) == 1 and spawned[0][1] == 2
    command, index, count, cards, coordinator = spawned[0][0]
    assert (index, count, cards) == (0, 1, 2) and coordinator.startswith("localhost:")
    assert command[:3] == (shard, str(tmp_path / "command"), "cuda")
    assert cli.main(["build-fleet", shard, str(tmp_path / "named"), "--device", "cuda:0"]) == 0
    assert len(spawned) == 1


def _listing(root):
    return sorted((str(p.relative_to(root)), p.stat().st_mtime_ns, p.stat().st_size) for p in root.rglob("*"))


def test_mirror_filters_read_without_writing(shard, single, tmp_path):
    """A non-coordinator drops what rank 0's resume and model-register
    filters will skip (``cli.py:654-675``), and writes nothing."""
    machines = cli.load_fleet_machines(shard)
    before = _listing(single)
    assert cli._mirror_filters(machines, str(single), None, resume=True) == []
    assert [m.name for m in cli._mirror_filters(machines, str(tmp_path / "empty"), None, resume=True)] == NAMES
    assert _listing(single) == before and not (tmp_path / "empty").exists()
    register, out = tmp_path / "register", tmp_path / "registered" / "1"
    assert cli.main(["build-fleet", shard, str(out), "--device", "cpu", "--model-register-dir", str(register)]) == 0
    before = _listing(register)
    assert cli._mirror_filters(machines, str(tmp_path / "other"), str(register), resume=False) == []
    assert [m.name for m in cli._mirror_filters(machines, str(tmp_path / "other"), str(tmp_path / "none"),
                                                resume=False)] == NAMES
    assert _listing(register) == before
