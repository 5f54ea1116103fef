"""``python -m gordo_tpu_torch build-fleet`` and ``normalize``, run in
process on the CPU: the artifacts serve; a machine with too few rows
exits 80 (the JAX command's code for ``InsufficientDataError``) while the
other is still dumped beside the build journal, with the JSON failure
report written; an unknown data provider exits with the code the JAX
command gives; the planner's options, which the port does not have, are
refused, naming ``ROADMAP.md``; ``--resume`` and ``--model-register-dir``
work."""

import json

import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu.cli.cli import build_fleet as jax_build_fleet
from gordo_tpu_torch.cli.cli import _parser, build_fleet, main
from gordo_tpu_torch.parallel.journal import BuildJournal
from gordo_tpu_torch.server import build_app

PROJECT = "cli-test"
MODEL = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 1}},
    ]}}}}


def _machine(name, **dataset):
    return {
        "name": name,
        "project_name": PROJECT,
        "model": MODEL,
        "dataset": {"train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": "2020-01-03T00:00:00+00:00",
                    "tag_list": ["a", "b"], "data_provider": {"type": "RandomDataProvider"}, **dataset},
    }


def _shard(tmp_path, *machines):
    path = tmp_path / "shard.json"
    path.write_text(json.dumps({"machines": list(machines)}))
    return str(path)


def test_build_fleet_writes_servable_artifacts(tmp_path):
    shard = _shard(tmp_path, _machine("m-1"), _machine("m-2", tag_list=["c", "d", "e"]))
    out = tmp_path / "out"
    assert main(["build-fleet", shard, str(out), "--device", "cpu"]) == 0
    client = Client(build_app(str(out), device="cpu"))
    body = json.loads(client.get(f"/gordo/v0/{PROJECT}/models").get_data())
    assert body["models"] == ["m-1", "m-2"]
    meta = json.loads(client.get(f"/gordo/v0/{PROJECT}/m-1/metadata").get_data())["metadata"]
    assert meta["metadata"]["build_metadata"]["dataset"]["dataset_meta"]["row_count"] == 289


def test_too_few_rows_exits_80_and_the_rest_is_dumped(tmp_path):
    shard = _shard(tmp_path, _machine("m-1", n_samples_threshold=10**6), _machine("m-2"))
    out, report = tmp_path / "out", tmp_path / "report.json"
    code = main(["build-fleet", shard, str(out), "--device", "cpu", "--exceptions-reporter-file", str(report)])
    assert code == 80
    assert sorted(p.name for p in out.iterdir()) == ["build_state.json", "m-2"]
    assert BuildJournal.load(str(out)).machines()["m-1"]["status"] == "failed"
    assert json.loads(report.read_text())["type"] == "InsufficientDataError"


def test_unknown_data_provider_exits_as_the_jax_command_does(tmp_path):
    shard = _shard(tmp_path, _machine("m-1", data_provider={"type": "NoSuchProvider"}))
    jax_code = CliRunner().invoke(jax_build_fleet, [shard, str(tmp_path / "jax")]).exit_code
    assert jax_code == 2
    assert main(["build-fleet", shard, str(tmp_path / "port"), "--device", "cpu"]) == jax_code


@pytest.mark.parametrize("option", [["--plan-from", "plan.json"], ["--plan-strategy", "packed"],
                                    ["--cost-table", "table.json"]])
def test_options_not_ported_are_refused(tmp_path, capsys, option):
    shard = _shard(tmp_path, _machine("m-1"))
    with pytest.raises(SystemExit) as exit_info:
        main(["build-fleet", shard, str(tmp_path / "out"), "--device", "cpu", *option])
    assert exit_info.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_resume_and_model_register_dir_are_taken(tmp_path, monkeypatch):
    """``--resume`` (or ``FLEET_RESUME``) skips what a first run built, and
    ``--model-register-dir`` registers each build, then loads it."""
    shard = _shard(tmp_path, _machine("m-1"))
    out, register = tmp_path / "out", tmp_path / "register"
    assert main(["build-fleet", shard, str(out), "--device", "cpu", "--model-register-dir", str(register)]) == 0
    model_bytes = (out / "m-1" / "model.pkl").read_bytes()
    assert sorted(p.name for p in (register / "builds").iterdir()) == [p.name for p in register.iterdir()
                                                                        if p.name != "builds"]
    monkeypatch.setenv("FLEET_RESUME", "1")
    assert _parser().parse_args(["build-fleet", shard, str(out)]).resume
    code, builder = build_fleet(shard, str(out), "cpu", resume=True)
    assert (code, builder.resumed) == (0, ["m-1"])
    assert (out / "m-1" / "model.pkl").read_bytes() == model_bytes
    code, builder = build_fleet(shard, str(tmp_path / "again"), "cpu", model_register_dir=str(register))
    assert code == 0 and builder.trainer.fits == []
    assert (tmp_path / "again" / "m-1" / "model.pkl").read_bytes() == model_bytes


def test_normalize_prints_the_shard(tmp_path, capsys):
    assert main(["normalize", "examples/config.yaml", "my-project"]) == 0
    document = json.loads(capsys.readouterr().out)
    assert [m["name"] for m in document["machines"]] == ["ct-23-0001", "ct-23-0002", "ct-23-0003"]
    assert {m["project_name"] for m in document["machines"]} == {"my-project"}
