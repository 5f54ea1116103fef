"""The port's ``workflow generate`` against the JAX command: for the same
config and options, the documents parse equal outside the closed list of
deliberate differences, and each difference reads as it should:

- every container's ``command`` runs ``python -m gordo_tpu_torch`` with the
  same arguments;
- the builder Job's pods are GPU pods: ``nvidia.com/gpu`` cards a pod from
  the slice geometry, a GKE GPU node selector, no ``JAX_PLATFORMS``;
- the server Deployment has no metrics sidecar: the server's pre-fork
  master answers 9090 itself (``--metrics-port 9090`` and a ``metrics``
  port of 9090) from the same ``PROMETHEUS_MULTIPROC_DIR`` and
  ``emptyDir`` volume as the JAX server's workers write to;
- the shard ConfigMaps' ``machines.yaml`` is JSON text of the same data.

Also: ``yaml_lite.safe_load_all`` against ``yaml.safe_load_all`` on the
rendered streams, ``validate_manifests`` against the JAX function on broken
manifests, and the command's validation gate and its exit codes."""

import copy
import json
import logging
import os

import pytest
import yaml
from click.testing import CliRunner

from gordo_tpu.cli import gordo_tpu_cli
from gordo_tpu.workflow import manifest_validation as jax_validation
from gordo_tpu_torch.cli.cli import main as port_main
from gordo_tpu_torch.utils import yaml_lite
from gordo_tpu_torch.workflow import manifest_validation
from gordo_tpu_torch.workflow.config_elements import schemas
from gordo_tpu_torch.workflow.workflow_generator import default_workflow_template
from gordo_tpu_torch.workflow.workflow_generator.tpu import GKE_GPU_LABEL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "workflow", "data")
FIXTURES = sorted(os.path.join(DATA, f) for f in os.listdir(DATA) if f.endswith(".yml")) + [
    os.path.join(REPO, "examples", "config.yaml")]
COMMON = ["--project-name", "fixture-proj", "--project-revision", "1600000000000",
          "--replay-start", "2020-01-01T00:00:00+00:00", "--replay-end", "2020-01-02T00:00:00+00:00"]
OWNER = '[{"uid": "u-1", "name": "owner", "kind": "Workflow", "apiVersion": "argoproj.io/v1alpha1"}]'
OPTIONS = {
    "every-plane": ["--with-istio", "--with-prediction-replay", "--ml-server-hpa-type", "keda", "--with-keda",
                    "--prometheus-server-address", "http://prometheus:9090", "--owner-references", OWNER,
                    "--split-workflows", "1", "--resources-labels", '{"team": "a"}',
                    "--server-labels", '{"tier": "serve"}', "--model-builder-labels", '{"tier": "build"}',
                    "--security-context", '{"runAsNonRoot": "true", "runAsUser": 1000}',
                    "--pod-security-context", '{"fsGroup": "2000", "supplementalGroups": [1, 2]}',
                    "--custom-model-builder-envs", '[{"name": "A", "value": "1"}, {"name": "B", "valueFrom": {}}]',
                    "--model-builder-class", "my.Builder", "--gordo-server-workers", "3",
                    "--gordo-server-threads", "4", "--gordo-server-probe-timeout", "9", "--n-servers", "7"],
    "bare": ["--without-prometheus", "--revisions-to-keep", "0", "--without-model-crds", "--ml-server-hpa-type",
             "none", "--gordo-version", "pr-12", "--namespace", "gordo"],
}
PORT_COMMAND = ["python", "-m", "gordo_tpu_torch"]


@pytest.fixture(autouse=True)
def _logger_levels():
    """Both generators set their package logger's level (``--log-level``);
    a later test in the same process must not inherit it."""
    loggers = [logging.getLogger(name) for name in ("gordo_tpu", "gordo_tpu_torch")]
    levels = [logger.level for logger in loggers]
    yield
    for logger, level in zip(loggers, levels):
        logger.setLevel(level)


def jax_render(config, *options):
    result = CliRunner().invoke(gordo_tpu_cli, ["workflow", "generate", "--machine-config", config, *COMMON,
                                                *options], catch_exceptions=False)
    return result.exit_code, result.output


def port_render(capsys, config, *options):
    code = port_main(["workflow", "generate", "--machine-config", config, *COMMON, *options])
    captured = capsys.readouterr()
    return code, captured.out, captured.err


def _containers(doc):
    spec = ((doc.get("spec") or {}).get("template") or {}).get("spec") or {}
    return list(spec.get("initContainers") or []) + list(spec.get("containers") or [])


def _env_names(container):
    return [e["name"] for e in container.get("env") or []]


def as_jax(doc, jax_doc):
    """A port document with the closed list's differences undone, each
    asserted as it should read; the JAX twin gives the TPU lines."""
    doc = copy.deepcopy(doc)
    kind, name = doc["kind"], doc["metadata"]["name"]
    for container in _containers(doc):
        command = container.get("command")
        if command is None:  # a third party's image: InfluxDB, Postgres, Grafana
            continue
        assert command[:3] == PORT_COMMAND, (name, command)
        container["command"] = ["gordo-tpu", *command[3:]]
    if kind == "ConfigMap" and "machines.yaml" in doc.get("data", {}):
        text = doc["data"]["machines.yaml"]
        assert yaml.safe_load(text) == json.loads(text) == yaml.safe_load(jax_doc["data"]["machines.yaml"])
        doc["data"]["machines.yaml"] = jax_doc["data"]["machines.yaml"]
    if kind == "Job" and name.startswith("gordo-fleet-"):
        pod = doc["spec"]["template"]["spec"]
        jax_pod = jax_doc["spec"]["template"]["spec"]
        assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": GKE_GPU_LABEL}
        pod["nodeSelector"] = jax_pod["nodeSelector"]
        builder, jax_builder = pod["containers"][0], jax_pod["containers"][0]
        cards = jax_builder["resources"]["limits"]["google.com/tpu"]
        assert "google.com/tpu" not in str(builder)
        for bound in ("requests", "limits"):
            assert builder["resources"][bound].pop("nvidia.com/gpu") == cards
            builder["resources"][bound]["google.com/tpu"] = cards
        assert "JAX_PLATFORMS" not in _env_names(builder)
        assert {"JAX_PROCESS_COUNT", "JAX_PROCESS_INDEX", "JAX_COORDINATOR_ADDRESS"} <= set(_env_names(builder))
        at = _env_names(jax_builder).index("JAX_PLATFORMS")
        builder["env"].insert(at, {"name": "JAX_PLATFORMS", "value": "tpu"})
    if kind == "Deployment" and name.startswith("gordo-tpu-server-"):
        pod = doc["spec"]["template"]["spec"]
        jax_pod = jax_doc["spec"]["template"]["spec"]
        server = pod["containers"][0]
        assert [c["name"] for c in pod["containers"]] == ["server"]
        if "--with-prometheus-config" in server["args"]:
            at = server["args"].index("--metrics-port")
            assert server["args"][at:at + 2] == ["--metrics-port", "9090"]
            del server["args"][at:at + 2]
            assert server["ports"].pop() == {"name": "metrics", "containerPort": 9090}
            jax_server, sidecar = jax_pod["containers"]
            assert sidecar["name"] == "metrics"
            assert {"name": "PROMETHEUS_MULTIPROC_DIR", "value": "/tmp/prometheus"} in server["env"]
            assert {"name": "prometheus-metrics", "mountPath": "/tmp/prometheus"} in server["volumeMounts"]
            assert {"name": "prometheus-metrics", "emptyDir": {}} in pod["volumes"]
            pod["containers"].append(sidecar)
        else:
            assert "PROMETHEUS_MULTIPROC_DIR" not in _env_names(server)
            assert [v["name"] for v in pod["volumes"]] == ["models"]
            assert "--metrics-port" not in server["args"] and len(server["ports"]) == 1
    return doc


def _check_equal(port_docs, jax_docs):
    port_docs = [d for d in port_docs if d]
    jax_docs = [d for d in jax_docs if d]
    assert [(d["kind"], d["metadata"]["name"]) for d in port_docs] == [
        (d["kind"], d["metadata"]["name"]) for d in jax_docs]
    for doc, jax_doc in zip(port_docs, jax_docs):
        assert as_jax(doc, jax_doc) == jax_doc, (doc["kind"], doc["metadata"]["name"])


@pytest.mark.parametrize("config", FIXTURES, ids=[os.path.basename(f) for f in FIXTURES])
def test_documents_equal_the_jax_commands(config, capsys):
    jax_code, jax_out = jax_render(config)
    code, out, _ = port_render(capsys, config)
    assert jax_code == code == 0
    _check_equal(yaml_lite.safe_load_all(out), list(yaml.safe_load_all(jax_out)))
    assert yaml_lite.safe_load_all(out) == list(yaml.safe_load_all(out))
    assert yaml_lite.safe_load_all(jax_out) == list(yaml.safe_load_all(jax_out))


@pytest.mark.parametrize("options", sorted(OPTIONS))
def test_documents_equal_the_jax_commands_with_options(options, capsys):
    config = os.path.join(DATA, "machines-per-slice.yml")
    jax_code, jax_out = jax_render(config, *OPTIONS[options])
    code, out, _ = port_render(capsys, config, *OPTIONS[options])
    assert jax_code == code == 0
    docs = yaml_lite.safe_load_all(out)
    assert docs == list(yaml.safe_load_all(out))
    _check_equal(docs, list(yaml.safe_load_all(jax_out)))


def test_output_file_and_no_validate(tmp_path, capsys):
    config = os.path.join(DATA, "minimal-single-machine.yml")
    target = tmp_path / "out.yml"
    code, out, _ = port_render(capsys, config, "--output-file", str(target), "--split-workflows", "1")
    assert code == 0 and out == ""
    _, jax_out = jax_render(config, "--split-workflows", "1")
    _check_equal(yaml_lite.safe_load_all(target.read_text()), list(yaml.safe_load_all(jax_out)))
    code, out, _ = port_render(capsys, config, "--no-validate")
    assert code == 0
    _check_equal(yaml_lite.safe_load_all(out), list(yaml.safe_load_all(jax_out)))


def test_reporters_are_injected_under_the_jax_paths(tmp_path, capsys):
    config = tmp_path / "config.yml"
    config.write_text(_with_remote_logging(os.path.join(DATA, "minimal-single-machine.yml")))
    code, out, _ = port_render(capsys, str(config))
    assert code == 0
    shard = next(d for d in yaml_lite.safe_load_all(out) if d and d["kind"] == "ConfigMap"
                 and "machines.yaml" in d["data"])
    for machine in json.loads(shard["data"]["machines.yaml"])["machines"]:
        assert machine["runtime"]["reporters"] == [
            {"gordo_tpu.reporters.postgres.PostgresReporter": {"host": "gordo-postgres-fixture-proj"}},
            "gordo_tpu.reporters.mlflow.MlFlowReporter"]


def _with_remote_logging(path):
    config = yaml.safe_load(open(path))
    body = config["spec"]["config"] if "spec" in config else config
    body.setdefault("globals", {}).setdefault("runtime", {}).setdefault("builder", {})["remote_logging"] = {
        "enable": True}
    return yaml.safe_dump(config)


@pytest.mark.parametrize("options, message", [
    (["--ml-server-hpa-type", "keda"], "--ml-server-hpa-type=keda requires --with-keda"),
    (["--ml-server-hpa-type", "keda", "--with-keda"], "requires --prometheus-server-address"),
    (["--resources-labels", "[1]"], "--resources-labels: expected a JSON object, got list"),
    (["--project-name", "p" * 30], "fit within k8s' 63-char resource-name labels"),
])
def test_refusals_exit_as_the_jax_command(options, message, capsys):
    config = os.path.join(DATA, "minimal-single-machine.yml")
    result = CliRunner().invoke(gordo_tpu_cli, ["workflow", "generate", "--machine-config", config, *COMMON,
                                                *options])
    code, _, err = port_render(capsys, config, *options)
    assert result.exit_code == code == 1
    assert message in result.output and message in err


@pytest.mark.parametrize("options", [["--custom-model-builder-envs", "[{]"],
                                     ["--custom-model-builder-envs", '[{"value": "x"}]'],
                                     ["--security-context", '{"runAsUser": "root"}'],
                                     ["--ml-server-hpa-type", "other"]])
def test_bad_options_exit_2(options, capsys):
    config = os.path.join(DATA, "minimal-single-machine.yml")
    result = CliRunner().invoke(gordo_tpu_cli, ["workflow", "generate", "--machine-config", config, *COMMON,
                                                *options])
    with pytest.raises(SystemExit) as exc:
        port_main(["workflow", "generate", "--machine-config", config, *COMMON, *options])
    assert result.exit_code == exc.value.code == 2


def test_option_schemas_match_pydantics():
    from pydantic import TypeAdapter, ValidationError
    from typing import List

    from gordo_tpu.workflow.config_elements.schemas import EnvVar, PodSecurityContext, SecurityContext

    cases = [
        (SecurityContext, schemas.security_context, {"runAsUser": "1000", "runAsNonRoot": "yes", "x": 1}),
        (SecurityContext, schemas.security_context, {"readOnlyRootFilesystem": 0, "runAsGroup": 5.0}),
        (SecurityContext, schemas.security_context, {"runAsUser": "root"}),
        (PodSecurityContext, schemas.pod_security_context, {"fsGroup": 3, "supplementalGroups": ["1", 2]}),
        (PodSecurityContext, schemas.pod_security_context, {"supplementalGroups": 1}),
        (List[EnvVar], schemas.env_vars, [{"name": "A", "value": "1", "extra": None}, {"name": "B"}]),
        (List[EnvVar], schemas.env_vars, [{"name": "A", "value": 1}]),
        (List[EnvVar], schemas.env_vars, [{"value": "1"}]),
    ]
    for model, check, data in cases:
        try:
            parsed = TypeAdapter(model).validate_python(data)
        except ValidationError:
            with pytest.raises(ValueError):
                check(data)
            continue
        dumped = ([p.model_dump(exclude_none=True) for p in parsed] if isinstance(parsed, list)
                  else parsed.model_dump(exclude_none=True))
        assert check(data) == dumped


def test_validation_gate_fails_the_command_with_the_jax_errors(tmp_path, capsys):
    config = os.path.join(DATA, "minimal-single-machine.yml")
    broken = {}
    for package, path in (("port", default_workflow_template()),
                          ("jax", os.path.join(REPO, "gordo_tpu", "workflow", "workflow_generator", "resources",
                                               "tpu-workflow.yml.template"))):
        broken[package] = tmp_path / f"{package}.template"
        broken[package].write_text(open(path).read().replace("restartPolicy: Never", "restartPolicy: never", 1))
    result = CliRunner().invoke(gordo_tpu_cli, ["workflow", "generate", "--machine-config", config, *COMMON,
                                                "--workflow-template", str(broken["jax"])])
    code, out, err = port_render(capsys, config, "--workflow-template", str(broken["port"]))
    assert result.exit_code == code == 1 and out == ""
    assert "failed schema validation" in err
    assert err.strip().splitlines()[-1] == result.output.strip().splitlines()[-1]
    code, out, _ = port_render(capsys, config, "--workflow-template", str(broken["port"]), "--no-validate")
    assert code == 0 and out


def test_unparseable_render_fails(tmp_path, capsys):
    template = tmp_path / "bad.template"
    template.write_text("---\nkind: [unclosed\n")
    code, out, err = port_render(capsys, os.path.join(DATA, "minimal-single-machine.yml"), "--workflow-template",
                                 str(template))
    assert code == 1 and out == ""
    assert "Rendered manifests are not parseable YAML (--no-validate to bypass)" in err


def _mutations(docs):
    """Broken copies of a rendered stream, one slip each."""
    def edit(fn):
        out = copy.deepcopy(docs)
        fn(out)
        return out

    def find(out, kind, prefix=""):
        return next(d for d in out if d and d["kind"] == kind and d["metadata"]["name"].startswith(prefix))

    def pod(out, kind, prefix=""):
        return find(out, kind, prefix)["spec"]["template"]["spec"]

    return {
        "continers": edit(lambda o: pod(o, "Job", "gordo-fleet-").update(
            continers=pod(o, "Job", "gordo-fleet-").pop("containers"))),
        "apiversion": edit(lambda o: find(o, "Deployment").update(apiVersion="apps/v1beta1")),
        "restart": edit(lambda o: pod(o, "Job").update(restartPolicy="never")),
        "mount": edit(lambda o: pod(o, "Job", "gordo-fleet-")["containers"][0]["volumeMounts"][0].update(
            name="fleet-cfg")),
        "label": edit(lambda o: find(o, "Service")["metadata"]["labels"].update(bad="-x-")),
        "port": edit(lambda o: find(o, "Service")["spec"]["ports"][0].update(port="80", protocol="HTTP")),
        "empty": edit(lambda o: pod(o, "Deployment").update(containers=[])),
        "env": edit(lambda o: pod(o, "Deployment")["containers"][0]["env"].append(
            {"name": "X", "value": "1", "valueFrom": {}})),
        "env-dup": edit(lambda o: pod(o, "Deployment")["containers"][0]["env"].append({"name": "PROJECT",
                                                                                      "value": 1})),
        "duplicate": edit(lambda o: o.append(copy.deepcopy(find(o, "Service")))),
        "unknown": edit(lambda o: o.append({"apiVersion": "v1", "kind": "Gadget", "metadata": {"name": "x"}})),
        "replicas": edit(lambda o: find(o, "Deployment")["spec"].update(replicas=-1, selector={
            "matchLabels": {"app": "other"}})),
        "hpa": edit(lambda o: find(o, "HorizontalPodAutoscaler")["spec"]["scaleTargetRef"].update(name="nope")),
        "name": edit(lambda o: find(o, "ConfigMap")["metadata"].update(name="Bad_Name", labels=None)),
        "pvc": edit(lambda o: find(o, "PersistentVolumeClaim")["spec"].update(accessModes=[], resources={})),
        "no-metadata": edit(lambda o: o.append({"apiVersion": "v1", "kind": "Service", "spec": {"ports": [
            {"port": 0}]}})),
        "const": edit(lambda o: find(o, "ConfigMap").update(apiVersion="v2", data={"a": 1})),
    }


def test_validate_manifests_errors_equal_the_jax_functions(capsys):
    code, out, _ = port_render(capsys, os.path.join(DATA, "minimal-single-machine.yml"))
    assert code == 0
    docs = yaml_lite.safe_load_all(out)
    assert manifest_validation.validate_manifests(docs) == jax_validation.validate_manifests(docs) == []
    for name, broken in _mutations(docs).items():
        expected = jax_validation.validate_manifests(broken)
        assert expected, name
        assert sorted(manifest_validation.validate_manifests(broken)) == sorted(expected), name
