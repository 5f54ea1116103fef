"""The port's remote MLflow tracking (``reporters/mlflow_rest.py``,
``reporters/azureml.py``) against the JAX reporter's, on the CPU, through
a stub of the tracking server (``reporters/mlflowstub.py``):

- the REST requests of the port's ``MlFlowReporter`` map one to one onto
  the calls the JAX reporter makes of ``MlflowClient`` (a recording fake,
  ``MLFLOW_AVAILABLE`` patched on) for the same built machine: the
  experiment looked up and created (missing, then present), the run's
  ``model_key``, every batch (timestamps left out), the ``metadata.json``
  artifact (JSON-equal) and ``FINISHED``;
- the AzureML route (``azureml.core`` faked in ``sys.modules`` for the JAX
  reporter): the tracking URI the JAX reporter hands to ``MlflowClient``
  equals the one the port resolves from the stub's ARM answer, the token
  request carries the service principal, every later request its token;
- failures: a 503 retried; a 400, a 403 and an unreachable port raise
  ``MlflowLoggingError`` and ``build`` exits 90 with its artifact dumped
  and no file-client run; unknown tracking and artifact schemes named;
  a NaN score sent as ``"NaN"``; the interactive login refused; the
  missing-keys messages the JAX package's.
"""

import json
import math
import os
import re
import socket
import sys
import types
import urllib.parse

import pytest

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.reporters import MlFlowReporter as JaxMlFlowReporter
from gordo_tpu.reporters import mlflow as jax_mlflow
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.reporters import MlflowLoggingError, MlFlowReporter, azureml, mlflow, mlflow_rest
from gordo_tpu_torch.reporters.mlflowstub import MlflowStub

PROJECT = "mlflow-remote-test"
MODEL = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 1}},
    ]}}}}
MLFLOW = "gordo_tpu.reporters.mlflow.MlFlowReporter"
WORKSPACE = {"subscription_id": "sub-1", "resource_group": "group-1", "workspace_name": "ws-1"}
PRINCIPAL = {"tenant_id": "tenant-1", "service_principal_id": "client-1", "service_principal_password": "s3cret"}
SCOPE = "/subscriptions/sub-1/resourceGroups/group-1/providers/Microsoft.MachineLearningServices/workspaces/ws-1"
TOKEN = "arm-token"
MLFLOW_ENV = ("MLFLOW_TRACKING_URI", "MLFLOW_TRACKING_TOKEN", "MLFLOW_TRACKING_USERNAME", "MLFLOW_TRACKING_PASSWORD",
              "MLFLOW_TRACKING_INSECURE_TLS", "MLFLOW_TRACKING_SERVER_CERT_PATH", "MLFLOW_HTTP_REQUEST_TIMEOUT",
              "MLFLOW_HTTP_REQUEST_MAX_RETRIES", "MLFLOW_HTTP_REQUEST_BACKOFF_FACTOR", "AZUREML_WORKSPACE_STR",
              "DL_SERVICE_AUTH_STR")


def machine_config(reporters=()):
    return {
        "name": "m-1", "project_name": PROJECT, "model": MODEL,
        "dataset": {"train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": "2020-01-03T00:00:00+00:00",
                    "tag_list": ["a", "b"], "data_provider": {"type": "RandomDataProvider"}},
        "runtime": {"reporters": list(reporters)},
    }


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    for name in MLFLOW_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GORDO_TPU_MLFLOW_DIR", str(tmp_path / "mlruns"))


@pytest.fixture(scope="module")
def register(tmp_path_factory):
    """A model register holding the machine, built once by the port's
    ``build`` on the CPU (reported through the file client): later builds
    of it are cache hits, which run the registered machine's reporters."""
    root = tmp_path_factory.mktemp("register")
    with pytest.MonkeyPatch.context() as patch:
        for name in MLFLOW_ENV:
            patch.delenv(name, raising=False)
        patch.setenv("GORDO_TPU_MLFLOW_DIR", str(root / "mlruns"))
        assert main(["build", json.dumps(machine_config([MLFLOW])), str(root / "m-1"), "--device", "cpu",
                     "--model-register-dir", str(root / "register")]) == 0
    assert len(list((root / "mlruns" / "m-1").iterdir())) == 1
    return root


@pytest.fixture(scope="module")
def built(register):
    """The built machine's ``metadata.json`` dict, with a fit history added."""
    document = json.loads((register / "m-1" / "metadata.json").read_text())
    model = document["metadata"]["build_metadata"]["model"]
    model["model_meta"]["history"] = {"loss": [0.5, 0.25], "val_loss": [0.6, 0.3], "params": {"epochs": 2}}
    model["model_training_duration_sec"] = 1.5
    return document


@pytest.fixture
def stub():
    stub = MlflowStub(token="tok")
    yield stub
    stub.close()


class FakeMlflowClient:
    """Records the JAX reporter's calls as the stub's requests are mapped
    below; experiments live on the class, as on a server."""

    calls, experiments = [], {}

    def __init__(self, tracking_uri=None):
        self.calls.append(("client", tracking_uri))

    def get_experiment_by_name(self, name):
        self.calls.append(("get_experiment_by_name", name))
        found = self.experiments.get(name)
        return types.SimpleNamespace(experiment_id=found) if found else None

    def create_experiment(self, name):
        self.calls.append(("create_experiment", name))
        self.experiments[name] = str(len(self.experiments) + 1)
        return self.experiments[name]

    def create_run(self, experiment_id, tags):
        self.calls.append(("create_run", tags))
        return types.SimpleNamespace(info=types.SimpleNamespace(run_id=f"run-{len(self.calls)}"))

    def log_batch(self, run_id, metrics=(), params=()):
        self.calls.append(("log_batch", [(m.key, m.value, m.step) for m in metrics],
                           [(p.key, p.value) for p in params]))

    def log_artifacts(self, run_id, local_dir):
        self.calls.append(("log_artifacts", {name: json.loads(open(os.path.join(local_dir, name)).read())
                                             for name in sorted(os.listdir(local_dir))}))

    def set_terminated(self, run_id):
        self.calls.append(("set_terminated", "FINISHED"))


@pytest.fixture
def jax_client(monkeypatch):
    monkeypatch.setattr(jax_mlflow, "MLFLOW_AVAILABLE", True)
    monkeypatch.setattr(jax_mlflow, "MlflowClient", FakeMlflowClient)
    monkeypatch.setattr(FakeMlflowClient, "calls", [])
    monkeypatch.setattr(FakeMlflowClient, "experiments", {})
    return FakeMlflowClient


def fake_azureml(monkeypatch, service_host):
    """``azureml.core`` and ``azureml.core.authentication`` in
    ``sys.modules``: a ``Workspace`` whose tracking URI is built as
    azureml-core builds it (the run-history service's host, ``/mlflow/
    v1.0`` and the workspace's ARM scope). Returns what each was called
    with."""
    seen = {}

    class ServicePrincipalAuthentication:
        def __init__(self, tenant_id, service_principal_id, service_principal_password):
            seen["principal"] = {"tenant_id": tenant_id, "service_principal_id": service_principal_id,
                                 "service_principal_password": service_principal_password}

    class InteractiveLoginAuthentication:
        def __init__(self, force=False):
            seen["interactive"] = force

    class Workspace:
        def __init__(self, subscription_id, resource_group, workspace_name, auth=None):
            seen["workspace"] = (subscription_id, resource_group, workspace_name)
            self.scope = (f"/subscriptions/{subscription_id}/resourceGroups/{resource_group}/providers/"
                          f"Microsoft.MachineLearningServices/workspaces/{workspace_name}")

        def get_mlflow_tracking_uri(self):
            return f"azureml://{service_host}/mlflow/v1.0{self.scope}"

    core, authentication = types.ModuleType("azureml.core"), types.ModuleType("azureml.core.authentication")
    core.Workspace = Workspace
    authentication.ServicePrincipalAuthentication = ServicePrincipalAuthentication
    authentication.InteractiveLoginAuthentication = InteractiveLoginAuthentication
    monkeypatch.setitem(sys.modules, "azureml", types.ModuleType("azureml"))
    monkeypatch.setitem(sys.modules, "azureml.core", core)
    monkeypatch.setitem(sys.modules, "azureml.core.authentication", authentication)
    return seen


def as_calls(requests):
    """The stub's requests as the ``MlflowClient`` calls they stand for."""
    calls = []
    for request in requests:
        route, body = request["path"].partition("/api/2.0/")[2], request["body"]
        if route == "mlflow/experiments/get-by-name":
            calls.append(("get_experiment_by_name", request["query"]["experiment_name"]))
        elif route == "mlflow/experiments/create":
            calls.append(("create_experiment", body["name"]))
        elif route == "mlflow/runs/create":
            calls.append(("create_run", {t["key"]: t["value"] for t in body["tags"]}))
        elif route == "mlflow/runs/log-batch":
            calls.append(("log_batch", [(m["key"], float(m["value"]), m["step"]) for m in body["metrics"]],
                          [(p["key"], p["value"]) for p in body["params"]]))
        elif route.startswith("mlflow-artifacts/artifacts/"):
            calls.append(("log_artifacts", {route.rsplit("/", 1)[1]: json.loads(body)}))
        elif route == "mlflow/runs/update":
            calls.append(("set_terminated", body["status"]))
        else:
            calls.append((request["method"], request["path"]))
    return calls


def machines(document):
    return Machine.from_dict(document), JaxMachine.from_dict(json.loads(json.dumps(document)))


def report_on_both(document, jax_client, stub, monkeypatch, times=2):
    """The JAX reporter through its ``MlflowClient`` and the port's against
    the stub, ``times`` reports each: ``(port calls, JAX calls)``."""
    ours, jax = machines(document)
    for _ in range(times):
        JaxMlFlowReporter().report(jax)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", stub.url)
    monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
    for _ in range(times):
        MlFlowReporter().report(ours)
    return as_calls(stub.requests), [c for c in jax_client.calls if c[0] != "client"]


def test_rest_requests_map_onto_the_jax_mlflowclient_calls(built, jax_client, stub, monkeypatch, tmp_path):
    ours, jax = report_on_both(built, jax_client, stub, monkeypatch)
    assert ours == jax
    assert [c[0] for c in ours[:3]] == ["get_experiment_by_name", "create_experiment", "create_run"]
    second = ours.index(("set_terminated", "FINISHED")) + 1
    assert [c[0] for c in ours[second:second + 2]] == ["get_experiment_by_name", "create_run"]
    assert jax_client.calls[0] == ("client", None)  # MlflowClient(): MLFLOW_TRACKING_URI's server
    key = ModelBuilder.calculate_cache_key(Machine.from_dict(built))
    assert ours[2] == ("create_run", {"model_key": key})
    assert ours[4] == ("log_artifacts", {"metadata.json": json.loads(Machine.from_dict(built).to_json())})
    assert all(r["headers"]["authorization"] == "Bearer tok" for r in stub.requests)
    assert [r["info"]["status"] for r in stub.runs.values()] == ["FINISHED", "FINISHED"]
    assert list(stub.experiments) == ["m-1"] and not (tmp_path / "mlruns").exists()


def test_azureml_route_resolves_the_jax_reporters_tracking_uri(built, jax_client, monkeypatch):
    stub = MlflowStub(token=TOKEN, tls=True)
    try:
        stub.service_principal = tuple(PRINCIPAL.values())
        stub.add_workspace(*WORKSPACE.values())
        seen = fake_azureml(monkeypatch, stub.netloc)
        monkeypatch.setenv("AZUREML_WORKSPACE_STR", ":".join(WORKSPACE.values()))
        monkeypatch.setenv("DL_SERVICE_AUTH_STR", ":".join(PRINCIPAL.values()))
        monkeypatch.setenv("MLFLOW_TRACKING_SERVER_CERT_PATH", stub.cafile)
        ours, jax = machines(built)
        JaxMlFlowReporter().report(jax)
        (_, jax_uri), *jax_calls = jax_client.calls

        token = azureml.ServicePrincipalToken(**PRINCIPAL, login_host=stub.url)
        assert azureml.workspace_tracking_uri(WORKSPACE, token, arm_host=stub.url) == jax_uri
        del stub.requests[:], stub.logins[:]
        key = ModelBuilder.calculate_cache_key(ours)
        with mlflow.mlflow_context("m-1", key, mlflow.get_workspace_kwargs(), mlflow.get_spauth_kwargs(),
                                   login_host=stub.url, arm_host=stub.url) as (client, run_id):
            mlflow.log_machine(client, run_id, ours)
    finally:
        stub.close()
    login, workspace, *tracking = stub.requests
    assert login["path"] == f"/{PRINCIPAL['tenant_id']}/oauth2/v2.0/token" and "authorization" not in login["headers"]
    assert {"tenant_id": login["path"].split("/")[1], "service_principal_id": login["body"]["client_id"],
            "service_principal_password": login["body"]["client_secret"]} == seen["principal"] == PRINCIPAL
    assert workspace["path"] == SCOPE and seen["workspace"] == tuple(WORKSPACE.values())
    assert client.tracking_uri == "https://" + jax_uri[len("azureml://"):]
    prefix = urllib.parse.urlsplit(jax_uri).path + "/api/2.0/"
    assert all(r["path"].startswith(prefix) for r in tracking)
    assert all(r["headers"]["authorization"] == f"Bearer {TOKEN}" for r in [workspace, *tracking])
    assert as_calls(tracking) == jax_calls and len(stub.logins) == 1
    assert [r["info"]["status"] for r in stub.runs.values()] == ["FINISHED"]


def test_azureml_location_fallback_and_token_expiry(monkeypatch):
    stub = MlflowStub(token=TOKEN, tls=True)
    try:
        stub.service_principal = tuple(PRINCIPAL.values())
        stub.add_workspace(*WORKSPACE.values(), location="northeurope", tracking_uri=False)
        monkeypatch.setenv("MLFLOW_TRACKING_SERVER_CERT_PATH", stub.cafile)
        fake_azureml(monkeypatch, "northeurope.api.azureml.ms")
        jax_uri = sys.modules["azureml.core"].Workspace(**WORKSPACE).get_mlflow_tracking_uri()
        stub.expires_in = 0  # expired on arrival: fetched again at each use
        token = azureml.ServicePrincipalToken(**PRINCIPAL, login_host=stub.url)
        assert azureml.workspace_tracking_uri(WORKSPACE, token, arm_host=stub.url) == jax_uri
        assert token() == token() == f"Bearer {TOKEN}" and len(stub.logins) == 3
        stub.expires_in = 3600
        token = azureml.ServicePrincipalToken(**PRINCIPAL, login_host=stub.url)
        assert token() == token() and len(stub.logins) == 4
        wrong = azureml.ServicePrincipalToken(**dict(PRINCIPAL, service_principal_password="nope"),
                                              login_host=stub.url)
        with pytest.raises(MlflowLoggingError, match="HTTP 401 invalid_client: AADSTS7000215"):
            wrong()
        with pytest.raises(MlflowLoggingError, match="HTTP 404 ResourceNotFound"):
            azureml.workspace_tracking_uri(dict(WORKSPACE, workspace_name="absent"), token, arm_host=stub.url)
    finally:
        stub.close()
    with pytest.raises(MlflowLoggingError, match="not an azureml:// URI"):
        azureml.rest_uri("https://example.invalid/mlflow")


def test_a_503_is_retried(built, stub, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", stub.url)
    monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
    stub.fail(503)
    MlFlowReporter().report(Machine.from_dict(built))
    first, retried = stub.requests[:2]
    assert (first["status"], retried["status"]) == (503, 404) and first["path"] == retried["path"]
    assert [r["info"]["status"] for r in stub.runs.values()] == ["FINISHED"]
    stub.fail(503, times=3)
    monkeypatch.setenv("MLFLOW_HTTP_REQUEST_MAX_RETRIES", "2")
    monkeypatch.setenv("MLFLOW_HTTP_REQUEST_BACKOFF_FACTOR", "0.05")
    del stub.requests[:]
    with pytest.raises(MlflowLoggingError, match=r"HTTP 503 TEMPORARILY_UNAVAILABLE: .* \(3 attempts\)"):
        MlFlowReporter().report(Machine.from_dict(built))
    arrived = [r["at"] for r in stub.requests]
    assert len(arrived) == 3 and arrived[2] - arrived[1] >= 0.1  # the second retry after factor * 2


@pytest.mark.parametrize("failure", [400, 403, "unreachable"])
def test_a_tracking_failure_exits_90_after_the_dump(failure, register, stub, monkeypatch, tmp_path):
    url = stub.url
    if failure == "unreachable":
        stub.close()
        monkeypatch.setenv("MLFLOW_HTTP_REQUEST_MAX_RETRIES", "1")
        monkeypatch.setenv("MLFLOW_HTTP_REQUEST_BACKOFF_FACTOR", "0")
    else:
        stub.fail(failure, times=10)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", url)
    monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
    report = tmp_path / "report.json"
    code = main(["build", json.dumps(machine_config([MLFLOW])), str(tmp_path / "out"), "--device", "cpu",
                 "--model-register-dir", str(register / "register"), "--exceptions-reporter-file", str(report),
                 "--exceptions-report-level", "message"])
    assert code == 90 and (tmp_path / "out" / "model.pkl").is_file()
    written = json.loads(report.read_text())
    assert written["type"] == "MlflowLoggingError"
    expected = {400: "GET .*/experiments/get-by-name: HTTP 400 INVALID_PARAMETER_VALUE: the stub answers 400",
                403: "GET .*/experiments/get-by-name: HTTP 403 PERMISSION_DENIED: the stub answers 403",
                "unreachable": r"ConnectionRefusedError: .* \(2 attempts\)"}[failure]
    assert re.search(expected, written["message"]), written["message"]
    assert not (tmp_path / "mlruns").exists()


@pytest.mark.parametrize("uri", ["file:///tmp/mlruns", "databricks://profile", "sqlite:///mlflow.db", "azureml://x/y"])
def test_an_unknown_tracking_scheme_is_named(uri, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", uri)
    scheme = urllib.parse.urlsplit(uri).scheme
    with pytest.raises(MlflowLoggingError, match=f"the scheme '{scheme}' is not supported"):
        mlflow.get_mlflow_client()


@pytest.mark.parametrize("root", ["s3://bucket/mlruns", "gs://bucket/mlruns", "wasbs://c@a.blob.core.windows.net/m",
                                  "dbfs:/databricks/mlflow", "azureml://experiments/e/runs"])
def test_an_unknown_artifact_scheme_is_named(root, built, stub, monkeypatch):
    stub.artifact_root = root
    monkeypatch.setenv("MLFLOW_TRACKING_URI", stub.url)
    monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
    scheme = urllib.parse.urlsplit(root).scheme
    with pytest.raises(MlflowLoggingError, match=f"the scheme '{scheme}' is not written"):
        MlFlowReporter().report(Machine.from_dict(built))
    assert not stub.artifacts and [r["info"]["status"] for r in stub.runs.values()] == ["FINISHED"]


@pytest.mark.parametrize("store", ["proxy host", "http", "file", "path"])
def test_artifact_stores_written(store, built, stub, monkeypatch, tmp_path):
    other = MlflowStub()
    try:
        stub.artifact_root = {"proxy host": f"mlflow-artifacts://{other.netloc}",
                              "http": f"{other.url}/api/2.0/mlflow-artifacts/artifacts/files",
                              "file": (tmp_path / "store").as_uri(), "path": str(tmp_path / "store")}[store]
        monkeypatch.setenv("MLFLOW_TRACKING_URI", stub.url)
        monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
        machine = Machine.from_dict(built)
        MlFlowReporter().report(machine)
    finally:
        other.close()
    (run_id,) = stub.runs
    experiment = stub.experiments["m-1"]
    if store in ("file", "path"):
        written = (tmp_path / "store" / experiment / run_id / "artifacts" / "metadata.json").read_bytes()
    else:
        prefix = "files/" if store == "http" else ""
        written = other.artifacts[f"{prefix}{experiment}/{run_id}/artifacts/metadata.json"]
        assert other.requests[0]["headers"]["authorization"] == "Bearer tok"
    assert json.loads(written) == json.loads(machine.to_json()) and not stub.artifacts


def test_non_finite_scores_are_sent_as_protobuf_json_writes_them(built, stub, monkeypatch):
    document = json.loads(json.dumps(built))
    scores = document["metadata"]["build_metadata"]["model"]["cross_validation"]["scores"]
    scores["r2-score"]["fold-1"] = float("nan")
    scores["r2-score"]["fold-max"] = float("inf")
    scores["r2-score"]["fold-min"] = float("-inf")
    monkeypatch.setenv("MLFLOW_TRACKING_URI", stub.url)
    monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "tok")
    MlFlowReporter().report(Machine.from_dict(document))
    sent = {m["key"] + str(m["step"]): m["value"] for r in stub.requests if r["path"].endswith("log-batch")
            for m in r["body"]["metrics"]}
    assert (sent["r2-score0"], sent["r2-score-max0"], sent["r2-score-min0"]) == ("NaN", "Infinity", "-Infinity")
    (run,) = stub.runs.values()
    read_back = {(k, step): v for k, v, _, step in run["metrics"]}
    assert math.isnan(read_back["r2-score", 0]) and read_back["r2-score-max", 0] == math.inf
    assert read_back["r2-score-min", 0] == -math.inf and read_back["loss", 1] == 0.25


@pytest.mark.parametrize("auth_str", [None, ""])
def test_the_interactive_login_is_refused(auth_str, built, jax_client, monkeypatch):
    seen = fake_azureml(monkeypatch, "westeurope.api.azureml.ms")
    monkeypatch.setenv("AZUREML_WORKSPACE_STR", ":".join(WORKSPACE.values()))
    if auth_str is not None:
        monkeypatch.setenv("DL_SERVICE_AUTH_STR", auth_str)
    ours, jax = machines(built)
    JaxMlFlowReporter().report(jax)
    assert seen["interactive"] is True  # the JAX reporter asks for a browser login
    with pytest.raises(MlflowLoggingError, match="remote AzureML tracking needs DL_SERVICE_AUTH_STR"):
        MlFlowReporter().report(ours)


@pytest.mark.parametrize("workspace, principal", [
    ({"subscription_id": "s", "resource_group": "g"}, PRINCIPAL),
    (WORKSPACE, {"tenant_id": "t", "service_principal_password": "p"}),
])
def test_missing_keys_messages_are_the_jax_packages(workspace, principal, jax_client, monkeypatch):
    fake_azureml(monkeypatch, "westeurope.api.azureml.ms")
    with pytest.raises(jax_mlflow.MlflowLoggingError) as jax:
        jax_mlflow.get_mlflow_client(dict(workspace), dict(principal))
    with pytest.raises(MlflowLoggingError) as ours:
        mlflow.get_mlflow_client(dict(workspace), dict(principal))
    assert str(ours.value) == str(jax.value) and str(ours.value).startswith("Missing keys [")


@pytest.mark.parametrize("setting", ["cert path", "insecure", "neither", "both"])
def test_tls_settings(setting, monkeypatch):
    stub = MlflowStub(tls=True)
    try:
        monkeypatch.setenv("MLFLOW_HTTP_REQUEST_MAX_RETRIES", "0")
        if setting in ("cert path", "both"):
            monkeypatch.setenv("MLFLOW_TRACKING_SERVER_CERT_PATH", stub.cafile)
        if setting in ("insecure", "both"):
            monkeypatch.setenv("MLFLOW_TRACKING_INSECURE_TLS", "true")
        if setting in ("neither", "both"):
            match = "CERTIFICATE_VERIFY_FAILED" if setting == "neither" else "cannot both be set"
            with pytest.raises(MlflowLoggingError, match=match):
                mlflow_rest.RestTrackingClient(stub.url).create_experiment("e")
        else:
            assert mlflow_rest.RestTrackingClient(stub.url).create_experiment("e") == "1"
    finally:
        stub.close()


def test_basic_auth_and_a_refused_login(monkeypatch):
    stub = MlflowStub(basic=("user", "pw"))
    try:
        monkeypatch.setenv("MLFLOW_TRACKING_USERNAME", "user")
        monkeypatch.setenv("MLFLOW_TRACKING_PASSWORD", "pw")
        monkeypatch.setenv("MLFLOW_TRACKING_TOKEN", "ignored")  # requests' Basic auth overwrites the Bearer
        assert mlflow_rest.RestTrackingClient(stub.url).create_experiment("e") == "1"
        monkeypatch.setenv("MLFLOW_TRACKING_PASSWORD", "wrong")
        with pytest.raises(MlflowLoggingError, match="POST .*/experiments/create: HTTP 401 UNAUTHENTICATED") as error:
            mlflow_rest.RestTrackingClient(stub.url).create_experiment("f")
        assert (error.value.status, error.value.error_code) == (401, "UNAUTHENTICATED")
        monkeypatch.setenv("MLFLOW_TRACKING_PASSWORD", "pw")
        with pytest.raises(MlflowLoggingError, match="HTTP 404 ENDPOINT_NOT_FOUND"):
            mlflow_rest.RestTrackingClient(stub.url)._call("POST", "registered-models/create", {"name": "m"})
    finally:
        stub.close()


def test_the_request_timeout_is_read_from_the_environment(monkeypatch):
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)  # connects, never answers
    try:
        monkeypatch.setenv("MLFLOW_HTTP_REQUEST_TIMEOUT", "0.2")
        with pytest.raises(MlflowLoggingError, match="timed out"):
            mlflow_rest.RestTrackingClient(f"http://127.0.0.1:{silent.getsockname()[1]}").create_experiment("e")
    finally:
        silent.close()
