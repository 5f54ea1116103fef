"""The port's reporters (``gordo_tpu_torch/reporters/``) against the JAX
package's, on the CPU:

- the JAX dotted paths read through the port's table, and each reporter's
  ``to_dict`` equal to the JAX reporter's;
- ``get_machine_log_items`` and ``batch_log_items`` of one built machine's
  dict equal to the JAX functions' (the metrics' timestamps left out);
  the MLflow runs of both reporters: the same tags (the cache key), batches
  and ``metadata.json``; with workspace kwargs, the JAX package without
  mlflow raises where the port logs the same run to the workspace (a stub
  of its login, ARM and tracking server);
- the ``sqlite://`` rows equal to the JAX reporter's;
- ``pgwire`` against a stub of the Postgres backend (``reporters/pgstub.py``):
  trust, cleartext, MD5 and SCRAM-SHA-256, the last with RFC 7677's
  ``user``/``pencil`` exchange as a fixed vector, and refused when the
  server skips its final signature; an ``ErrorResponse``; the JSON bound
  as parameters, never in the SQL;
- a reporter's failure exits 90 from ``build`` and ``build-fleet``, as the
  JAX commands do, after the artifacts were dumped.
"""

import base64
import json
import sqlite3

import pytest
from click.testing import CliRunner

from gordo_tpu.cli import gordo_tpu_cli
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.reporters import mlflow as jax_mlflow
from gordo_tpu.reporters import LogReporter as JaxLogReporter
from gordo_tpu.reporters import MlFlowReporter as JaxMlFlowReporter
from gordo_tpu.reporters import PostgresReporter as JaxPostgresReporter
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.reporters import (
    LogReporter,
    MlflowLoggingError,
    MlFlowReporter,
    PostgresReporter,
    PostgresReporterException,
    create_reporters,
    mlflow,
    pgwire,
)
from gordo_tpu_torch.reporters.mlflowstub import MlflowStub
from gordo_tpu_torch.reporters.pgstub import PostgresStub

PROJECT = "reporter-test"
MODEL = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 1}},
    ]}}}}
POSTGRES = "gordo_tpu.reporters.postgres.PostgresReporter"
#: RFC 7677 §3: the SCRAM-SHA-256 exchange of user "user", password "pencil"
RFC7677 = {
    "client_nonce": "rOprNGfwEbeRWgbNEkqO",
    "server_nonce": "%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0",
    "salt": "W22ZaJ0SNY7soEsUEjb6gQ==",
    "client_first": "n,,n=user,r=rOprNGfwEbeRWgbNEkqO",
    "server_first": "r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096",
    "client_final": "c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
                    "p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ=",
    "server_final": "v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=",
}


def machine_config(name="m-1", reporters=None, tags=("a", "b")):
    return {
        "name": name, "project_name": PROJECT, "model": MODEL,
        "dataset": {"train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": "2020-01-03T00:00:00+00:00",
                    "tag_list": list(tags), "data_provider": {"type": "RandomDataProvider"}},
        "runtime": {"reporters": reporters or []},
    }


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A machine built by the port's ``build`` on the CPU, as its
    ``metadata.json`` dict, with a fit history added to its metadata."""
    out = tmp_path_factory.mktemp("built") / "m-1"
    assert main(["build", json.dumps(machine_config()), str(out), "--device", "cpu"]) == 0
    document = json.loads((out / "metadata.json").read_text())
    model = document["metadata"]["build_metadata"]["model"]
    model["model_meta"]["history"] = {"loss": [0.5, 0.25], "val_loss": [0.6, 0.3], "params": {"epochs": 2}}
    model["model_training_duration_sec"] = 1.5
    return document


def _untimed(metrics):
    return [(m.key, m.value, m.step) for m in metrics]


def test_reporters_read_the_jax_paths_and_write_the_jax_definitions(tmp_path):
    database = f"sqlite:///{tmp_path / 'r.db'}"
    definitions = ["gordo_tpu.reporters.mlflow.MlFlowReporter", "gordo_tpu.reporters.LogReporter",
                   {POSTGRES: {"host": database, "port": 5433}},
                   {"gordo_tpu.reporters.base.LogReporter": {"level": "DEBUG"}},
                   {"gordo_tpu.reporters.mlflow.MlFlowReporter": {"args": [], "model_builder_class": None}}]
    ours = create_reporters(definitions)
    assert [type(r) for r in ours] == [MlFlowReporter, LogReporter, PostgresReporter, LogReporter, MlFlowReporter]
    jax = [JaxMlFlowReporter(), JaxLogReporter(), JaxPostgresReporter(host=database, port=5433),
           JaxLogReporter(level="DEBUG"), JaxMlFlowReporter()]
    assert [r.to_dict() for r in ours] == [r.to_dict() for r in jax]
    assert [type(r) for r in create_reporters([r.to_dict() for r in ours])] == [type(r) for r in ours]
    with pytest.raises(NotImplementedError, match="gordo_tpu.reporters.Nope"):
        create_reporters(["gordo_tpu.reporters.Nope"])


def test_log_items_and_batches_equal_the_jax_functions(built):
    ours, jax = Machine.from_dict(built), JaxMachine.from_dict(json.loads(json.dumps(built)))
    metrics, params = mlflow.get_machine_log_items(ours)
    jax_metrics, jax_params = jax_mlflow.get_machine_log_items(jax)
    assert params == jax_params and len(params) > 10
    assert _untimed(metrics) == _untimed(jax_metrics)
    assert {m.key for m in metrics} >= {"loss", "val_loss", "model_training_duration_sec", "r2-score-mean"}
    batches = mlflow.batch_log_items(metrics, params, n_max_metrics=7, n_max_params=3)
    jax_batches = jax_mlflow.batch_log_items(jax_metrics, jax_params, n_max_metrics=7, n_max_params=3)
    assert [(_untimed(b["metrics"]), b["params"]) for b in batches] == [
        (_untimed(b["metrics"]), b["params"]) for b in jax_batches]
    assert len(batches) > 2


def test_mlflow_runs_equal_the_jax_reporters(built, tmp_path, monkeypatch):
    runs = {}
    for package, reporter, machine in (("port", MlFlowReporter(), Machine.from_dict(built)),
                                       ("jax", JaxMlFlowReporter(), JaxMachine.from_dict(json.loads(json.dumps(
                                           built))))):
        monkeypatch.setenv("GORDO_TPU_MLFLOW_DIR", str(tmp_path / package))
        reporter.report(machine)
        (run,) = (tmp_path / package / "m-1").iterdir()
        runs[package] = {
            "tags": json.loads((run / "tags.json").read_text()),
            "batches": [{"metrics": [m[:2] + m[3:] for m in b["metrics"]], "params": b["params"]}
                        for b in map(json.loads, (run / "batches.jsonl").read_text().splitlines())],
            "metadata": json.loads((run / "artifacts" / "metadata.json").read_text()),
            "status": (run / "status").read_text(),
        }
    assert runs["port"] == runs["jax"]
    assert runs["port"]["status"] == "FINISHED" and len(runs["port"]["tags"]["model_key"]) == 64
    monkeypatch.setenv("AZUREML_WORKSPACE_STR", "sub:group:workspace")
    monkeypatch.setenv("DL_SERVICE_AUTH_STR", "tenant:client:secret")
    with pytest.raises(jax_mlflow.MlflowLoggingError) as jax:
        JaxMlFlowReporter().report(JaxMachine.from_dict(json.loads(json.dumps(built))))
    assert str(jax.value) == "mlflow (and the AzureML SDK) are required for remote tracking"
    # the port reaches the workspace's tracking server through the service principal (a stub of login, ARM, MLflow)
    stub = MlflowStub(token="arm-token", tls=True)
    try:
        stub.service_principal = ("tenant", "client", "secret")
        stub.add_workspace("sub", "group", "workspace")
        monkeypatch.setenv("MLFLOW_TRACKING_SERVER_CERT_PATH", stub.cafile)
        with mlflow.mlflow_context("m-1", runs["port"]["tags"]["model_key"], mlflow.get_workspace_kwargs(),
                                   mlflow.get_spauth_kwargs(), login_host=stub.url, arm_host=stub.url) as (
                client, run_id):
            mlflow.log_machine(client, run_id, Machine.from_dict(built))
    finally:
        stub.close()
    (run,) = stub.runs.values()
    assert run["tags"] == runs["port"]["tags"] and run["info"]["status"] == "FINISHED"
    assert [[k, v, step] for k, v, _, step in run["metrics"]] == [m for b in runs["port"]["batches"]
                                                                  for m in b["metrics"]]
    assert [list(p) for p in run["params"]] == [p for b in runs["port"]["batches"] for p in b["params"]]
    assert [json.loads(a) for a in stub.artifacts.values()] == [runs["port"]["metadata"]]


def test_sqlite_rows_equal_the_jax_reporters(built, tmp_path):
    rows = {}
    for package, cls, machine in (("port", PostgresReporter, Machine.from_dict(built)),
                                  ("jax", JaxPostgresReporter, JaxMachine.from_dict(json.loads(json.dumps(built))))):
        path = tmp_path / f"{package}.db"
        reporter = cls(host=f"sqlite:///{path}")
        reporter.report(machine)
        reporter.report(machine)  # the upsert: one row a name
        rows[package] = (sqlite3.connect(path).execute("SELECT * FROM machine").fetchall(), reporter.fetch("m-1"))
    assert rows["port"] == rows["jax"]
    assert len(rows["port"][0]) == 1 and rows["port"][1]["metadata"] == built["metadata"]
    memory = PostgresReporter(host="sqlite://:memory:")
    with pytest.raises(PostgresReporterException, match="No machine named 'absent'"):
        memory.fetch("absent")


def test_scram_matches_rfc7677():
    bare = pgwire.scram_client_first("user", RFC7677["client_nonce"])
    assert "n,," + bare == RFC7677["client_first"]
    final, signature = pgwire.scram_client_final("pencil", bare, RFC7677["server_first"], RFC7677["client_nonce"])
    assert final == RFC7677["client_final"]
    assert "v=" + signature == RFC7677["server_final"]
    with pytest.raises(pgwire.PgError, match="nonce"):
        pgwire.scram_client_final("pencil", bare, "r=other,s=AA==,i=1", RFC7677["client_nonce"])


def test_pgwire_logs_in_with_the_rfc7677_exchange():
    stub = PostgresStub(auth="scram", user="user", password="pencil", salt=base64.b64decode(RFC7677["salt"]),
                        server_nonce=RFC7677["server_nonce"])
    try:
        connection = pgwire.connect("127.0.0.1", stub.port, "user", "pencil", "postgres",
                                    nonce=RFC7677["client_nonce"])
        assert connection.parameters["server_version"].startswith("14")
        connection.close()
    finally:
        stub.close()
    assert stub.scram == [(RFC7677["client_first"], RFC7677["server_first"], RFC7677["client_final"],
                           RFC7677["server_final"])]


def test_pgwire_refuses_a_scram_login_the_server_did_not_prove():
    stub = PostgresStub(auth="scram", user="gordo", password="right")
    stub.sasl_final = False  # AuthenticationOk straight after the client's proof
    try:
        with pytest.raises(pgwire.PgError, match="without proving its signature"):
            pgwire.connect("127.0.0.1", stub.port, "gordo", "right", "postgres")
    finally:
        stub.close()
    assert len(stub.scram) == 1 and stub.refused == []


@pytest.mark.parametrize("auth", ["trust", "password", "md5", "scram"])
def test_pgwire_authenticates_and_binds_parameters(auth):
    stub = PostgresStub(auth=auth, user="gordo", password="s3cret'pw")
    try:
        connection = pgwire.connect("127.0.0.1", stub.port, "gordo", "s3cret'pw", "postgres")
        tricky = json.dumps({"quote": "it's $1; DROP TABLE machine; --", "nested": [1, None]})
        connection.execute("CREATE TABLE IF NOT EXISTS machine (name VARCHAR(255))")
        connection.execute("INSERT INTO machine (name, dataset, model, metadata) VALUES ($1, $2, $3, $4)",
                           ("m'1", tricky, "{}", "null"))
        rows = connection.execute("SELECT name, dataset, model, metadata FROM machine WHERE name = $1", ("m'1",))
        assert [(r[0], json.loads(r[1])) for r in rows] == [("m'1", json.loads(tricky))]
        assert connection.execute("SELECT name, dataset, model, metadata FROM machine WHERE name = $1",
                                  ("absent",)) == []
        with pytest.raises(pgwire.PgError) as error:
            connection.execute("DROP TABLE machine")
        assert error.value.fields["code"] == "42601" and error.value.fields["severity"] == "ERROR"
        with pytest.raises(pgwire.PgError, match="22P02"):
            connection.execute("INSERT INTO machine (name, dataset, model, metadata) VALUES ($1, $2, $3, $4)",
                               ("m2", "{not json", "{}", "{}"))
        # the session is ready again after each error
        assert len(connection.execute("SELECT name, dataset, model, metadata FROM machine WHERE name = $1",
                                      ("m'1",))) == 1
        connection.close()
    finally:
        stub.close()
    sql = [s for s, _ in stub.statements]
    assert not any("it's" in s or "m'1" in s for s in sql)
    assert stub.statements[1][1] == ["m'1", tricky, "{}", "null"]


@pytest.mark.parametrize("auth", ["password", "md5", "scram"])
def test_pgwire_raises_the_servers_refusal(auth):
    stub = PostgresStub(auth=auth, user="gordo", password="right")
    try:
        with pytest.raises(pgwire.PgError) as error:
            pgwire.connect("127.0.0.1", stub.port, "gordo", "wrong", "postgres")
    finally:
        stub.close()
    assert error.value.fields["code"] == "28P01" and error.value.fields["severity"] == "FATAL"
    assert stub.refused == ["gordo"]


def test_postgres_reporter_over_pgwire_equals_its_sqlite_rows(built, tmp_path):
    stub = PostgresStub(auth="scram")
    try:
        reporter = PostgresReporter(host="127.0.0.1", port=stub.port)
        machine = Machine.from_dict(built)
        reporter.report(machine)
        reporter.report(machine)
        fetched = reporter.fetch("m-1")
    finally:
        stub.close()
    local = PostgresReporter(host=f"sqlite:///{tmp_path / 'r.db'}")
    local.report(machine)
    assert fetched == local.fetch("m-1")
    assert stub.statements[0][0].endswith("metadata JSONB NOT NULL)")
    assert sorted(stub.rows) == ["m-1"] and len([s for s, _ in stub.statements if s.startswith("INSERT")]) == 2
    with pytest.raises(PostgresReporterException):
        PostgresReporter(host="127.0.0.1", port=stub.port)  # the stub is closed: no server


def test_a_reporters_failure_exits_90_after_the_dump(tmp_path):
    stub = PostgresStub(auth="scram")
    stub.refuse = True
    reporters = [{POSTGRES: {"host": "127.0.0.1", "port": stub.port}}]
    try:
        config = json.dumps(machine_config(reporters=reporters))
        report = tmp_path / "report.json"
        code = main(["build", config, str(tmp_path / "one"), "--device", "cpu", "--exceptions-reporter-file",
                     str(report)])
        jax = CliRunner().invoke(gordo_tpu_cli, ["build", config, str(tmp_path / "jax-one")])
        assert code == jax.exit_code == 90
        assert (tmp_path / "one" / "model.pkl").is_file() and (tmp_path / "jax-one" / "model.pkl").is_file()
        assert json.loads(report.read_text())["type"] == "PostgresReporterException"

        shard = tmp_path / "shard.json"
        shard.write_text(json.dumps({"machines": [machine_config("m-1", reporters),
                                                  machine_config("m-2", reporters, tags=("c", "d", "e"))]}))
        code = main(["build-fleet", str(shard), str(tmp_path / "fleet"), "--device", "cpu"])
        jax = CliRunner().invoke(gordo_tpu_cli, ["build-fleet", str(shard), str(tmp_path / "jax-fleet")])
        assert code == jax.exit_code == 90
        for root in ("fleet", "jax-fleet"):
            assert sorted(p.name for p in (tmp_path / root).iterdir() if p.name.startswith("m-")) == ["m-1", "m-2"]
    finally:
        stub.close()
    assert stub.refused == ["postgres", "postgres"]


def test_build_fleet_reports_every_dumped_machine(tmp_path):
    shard = tmp_path / "shard.json"
    database = tmp_path / "rows.db"
    reporters = [{POSTGRES: {"host": f"sqlite:///{database}"}}, "gordo_tpu.reporters.LogReporter"]
    shard.write_text(json.dumps({"machines": [machine_config("m-1", reporters), machine_config("m-2", reporters)]}))
    assert main(["build-fleet", str(shard), str(tmp_path / "out"), "--device", "cpu"]) == 0
    reporter = PostgresReporter(host=f"sqlite:///{database}")
    for name in ("m-1", "m-2"):
        artifact = json.loads((tmp_path / "out" / name / "metadata.json").read_text())
        assert reporter.fetch(name)["metadata"] == artifact["metadata"]
