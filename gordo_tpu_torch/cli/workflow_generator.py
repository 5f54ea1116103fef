"""
``python -m gordo_tpu_torch workflow generate``: a project config to the
deployable k8s manifests, the JAX package's command
(``gordo_tpu/cli/workflow_generator.py:168-744``) on ``argparse``, with
every option, its ``WORKFLOW_GENERATOR_*`` variable, its messages and its
exit codes: 2 for an option that does not parse, 1 for a config or
render the command refuses (``Error: ...``).

The config goes through the port's ``NormalizedConfig``; the machines are
cut into workflows of ``--split-workflows`` machines and shards of
``runtime.fleet.machines_per_slice``; the reporters are injected under the
JAX package's dotted paths (a ``PostgresReporter`` at
``gordo-postgres-<project>`` for every machine when InfluxDB is on, an
``MlFlowReporter`` where ``runtime.builder.remote_logging.enable``); each
workflow is rendered from the port's template by ``utils/template.py``
and, unless ``--no-validate``, every document is read back
(``utils/yaml_lite.safe_load_all``) and held to the vendored schemas
(``workflow/manifest_validation.py``) before anything is printed.

The port's template differs from the JAX one only as its header says: the
containers run ``python -m gordo_tpu_torch``, the builder pods are GPU
pods, the server exposes its own metrics port. The shard ConfigMaps'
``machines.yaml`` and the Model resources' ``config`` are JSON text.
"""

import argparse
import datetime
import json
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, List

from .. import __version__
from ..utils import yaml_lite
from ..utils.template import Template
from ..workflow.config_elements import schemas
from ..workflow.config_elements.normalized_config import NormalizedConfig
from ..workflow.workflow_generator import workflow_generator as wg
from ..workflow.workflow_generator.tpu import GKE_GPU_LABEL, gke_accelerator_label, slice_geometry
from .exceptions_reporter import ReportLevel

logger = logging.getLogger(__name__)

PREFIX = "WORKFLOW_GENERATOR"
DEFAULT_BUILDER_EXCEPTIONS_REPORT_LEVEL = ReportLevel.TRACEBACK

ML_SERVER_HPA_TYPES = ["none", "k8s_cpu", "keda"]
DEFAULT_ML_SERVER_HPA_TYPE = "k8s_cpu"

DEFAULT_KEDA_PROMETHEUS_METRIC_NAME = "gordo_server_request_duration_seconds_count"
DEFAULT_KEDA_PROMETHEUS_QUERY = (
    "sum(rate(gordo_server_request_duration_seconds_count"
    '{project=~"{{project_name}}",path=~".*prediction"}[30s]))'
)
DEFAULT_KEDA_PROMETHEUS_THRESHOLD = "1.0"
DEFAULT_CUSTOM_MODEL_BUILDER_ENVS = "[]"

#: the reporters the command injects, by the JAX package's paths
POSTGRES_REPORTER = "gordo_tpu.reporters.postgres.PostgresReporter"
MLFLOW_REPORTER = "gordo_tpu.reporters.mlflow.MlFlowReporter"


class GenerateError(Exception):
    """A config or render the command refuses; exits 1 with ``Error: ...``."""


def resolve_exceptions_report_level(config: NormalizedConfig) -> ReportLevel:
    """``runtime.builder.exceptions_report_level`` of the globals, default
    TRACEBACK."""
    name = config.globals.get("runtime", {}).get("builder", {}).get("exceptions_report_level")
    if name is None:
        return DEFAULT_BUILDER_EXCEPTIONS_REPORT_LEVEL
    level = ReportLevel.get_by_name(name)
    if level is None:
        valid = ", ".join(level.name for level in ReportLevel)
        raise ValueError(f"runtime.builder.exceptions_report_level={name!r} is not one of: {valid}")
    return level


#: the worst non-project characters a generated name carries (k8s names hold 63)
_NAME_OVERHEAD = max(
    len("gordo-tpu-fleet-config-") + len("-r12345678-999-99"),
    len("gordo-fleet-") + len("-r12345678-999-99-99"),
)


def check_project_name_fits(project_name: str) -> None:
    budget = 63 - _NAME_OVERHEAD
    if len(project_name) > budget:
        raise GenerateError(
            f"--project-name {project_name!r} is {len(project_name)} chars; "
            f"at most {budget} fit within k8s' 63-char resource-name labels "
            "once revision/workflow/shard suffixes are added"
        )


def check_keda_flags(context: Dict[str, Any]) -> None:
    """KEDA autoscaling needs both the feature flag and a Prometheus URL."""
    if context["ml_server_hpa_type"] != "keda":
        return
    missing = None
    if not context["with_keda"]:
        missing = "--with-keda"
    elif not context["prometheus_server_address"]:
        missing = "--prometheus-server-address"
    if missing:
        raise GenerateError(f"--ml-server-hpa-type=keda requires {missing}")


def render_keda_query(query: str, project_name: str) -> str:
    """The ``{{project_name}}`` placeholder of a KEDA query expanded (an
    undefined name prints as nothing, as in the JAX command)."""
    if not query:
        return query
    return Template(query, strict=False).render(project_name=project_name)


def parse_label_overrides(value: str, flag: str = "--resources-labels") -> Dict[str, Any]:
    """A ``--*-labels`` JSON object as a dict; empty means none."""
    if not value:
        return {}
    try:
        labels = json.loads(value)
    except json.JSONDecodeError as exc:
        raise GenerateError(f"{flag}: not valid JSON ({exc})")
    if not isinstance(labels, dict):
        raise GenerateError(f"{flag}: expected a JSON object, got {type(labels).__name__}")
    return labels


def _k8s_resources(resources: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, str]]:
    """Config resource ints (MB / millicores) as k8s quantities."""
    return {
        bound: {"memory": f"{values['memory']}M", "cpu": f"{values['cpu']}m"}
        for bound, values in resources.items()
        if bound in ("requests", "limits")
    }


# -- the options -----------------------------------------------------------------------


def _env(name: str, default: Any = None, cast: Callable = str) -> Any:
    value = os.environ.get(f"{PREFIX}_{name}")
    return default if value is None else cast(value)


def _json_option(check: Callable[[Any], Any], flag: str) -> Callable[[str], Any]:
    """An option of JSON checked by ``check``; argparse reports a failure
    as ``invalid value`` and exits 2, as click does."""

    def parse(text: str) -> Any:
        try:
            data = json.loads(text)
        except json.JSONDecodeError as exc:
            raise argparse.ArgumentTypeError(f"Malformed JSON string - {exc}")
        try:
            return check(data)
        except ValueError as exc:
            raise argparse.ArgumentTypeError(f"Schema validation error - {exc}")

    parse.__name__ = flag
    return parse


def add_parser(commands) -> None:
    """``workflow generate`` with the JAX command's options."""
    workflow = commands.add_parser("workflow", help="workflow generation")
    generate = workflow.add_subparsers(dest="workflow_command", required=True).add_parser(
        "generate", help="machine configuration to fleet workflow manifests")
    add = generate.add_argument
    add("--machine-config", default=_env("MACHINE_CONFIG"), help="Machine configuration file")
    add("--workflow-template", default=None, help="Template to expand")
    add("--validate", dest="validate_manifests_flag", action=argparse.BooleanOptionalAction,
        default=_env("VALIDATE", True, _bool), help="validate every rendered document before printing (default)")
    add("--owner-references", default=_env("OWNER_REFERENCES"),
        help="Kubernetes owner references to inject into all created resources, a yaml/json list")
    add("--gordo-version", default=_env("GORDO_VERSION", wg._docker_friendly_version(__version__)))
    add("--project-name", default=_env("PROJECT_NAME"), help="Name of the project which owns the workflow.")
    add("--project-revision", default=_env("PROJECT_REVISION", str(int(time.time() * 1000))))
    add("--output-file", default=_env("OUTPUT_FILE"), help="Optional file to render to")
    add("--namespace", default=_env("NAMESPACE", "kubeflow"))
    add("--split-workflows", type=int, default=_env("SPLIT_WORKFLOWS", 30, int))
    add("--n-servers", type=int, default=_env("N_SERVERS", None, int))
    add("--docker-repository", default=_env("DOCKER_REPOSITORY", "equinor"))
    add("--docker-registry", default=_env("DOCKER_REGISTRY", "ghcr.io"))
    add("--retry-backoff-limit", type=int, default=_env("RETRY_BACKOFF_LIMIT", 6, int))
    add("--gordo-server-workers", type=int, default=_env("GORDO_SERVER_WORKERS", None, int))
    add("--gordo-server-threads", type=int, default=_env("GORDO_SERVER_THREADS", None, int))
    add("--gordo-server-probe-timeout", type=int, default=_env("GORDO_SERVER_PROBE_TIMEOUT", None, int))
    add("--without-prometheus", action="store_true", default=_env("WITHOUT_PROMETHEUS", False, _bool))
    add("--image-pull-policy", default=_env("IMAGE_PULL_POLICY"))
    add("--with-keda", action="store_true", default=_env("WITH_KEDA", False, _bool))
    add("--ml-server-hpa-type", choices=ML_SERVER_HPA_TYPES,
        default=_env("ML_SERVER_HPA_TYPE", DEFAULT_ML_SERVER_HPA_TYPE))
    add("--custom-model-builder-envs", type=_json_option(schemas.env_vars, "custom-model-builder-envs"),
        default=_env("CUSTOM_MODEL_BUILDER_ENVS", DEFAULT_CUSTOM_MODEL_BUILDER_ENVS))
    add("--prometheus-server-address", default=_env("PROMETHEUS_SERVER_ADDRESS"))
    add("--keda-prometheus-metric-name", default=_env("KEDA_PROMETHEUS_METRIC_NAME",
                                                      DEFAULT_KEDA_PROMETHEUS_METRIC_NAME))
    add("--keda-prometheus-query", default=_env("KEDA_PROMETHEUS_QUERY", DEFAULT_KEDA_PROMETHEUS_QUERY))
    add("--keda-prometheus-threshold", default=_env("KEDA_PROMETHEUS_THRESHOLD", DEFAULT_KEDA_PROMETHEUS_THRESHOLD))
    add("--resources-labels", default=_env("RESOURCE_LABELS", ""))
    add("--model-builder-labels", default=_env("MODEL_BUILDER_LABELS", ""))
    add("--server-labels", default=_env("SERVER_LABELS", ""))
    add("--server-termination-grace-period", type=int, default=_env("SERVER_TERMINATION_GRACE_PERIOD", 60, int))
    add("--server-target-cpu-utilization-percentage", type=int,
        default=_env("SERVER_TARGET_CPU_UTILIZATION_PERCENTAGE", 50, int))
    add("--gordo-server-readiness-initial-delay", type=int,
        default=_env("GORDO_SERVER_READINESS_INITIAL_DELAY", 5, int))
    add("--gordo-server-liveness-initial-delay", type=int,
        default=_env("GORDO_SERVER_LIVENESS_INITIAL_DELAY", 600, int))
    add("--security-context", type=_json_option(schemas.security_context, "security-context"),
        default=_env("SECURITY_CONTEXT"))
    add("--pod-security-context", type=_json_option(schemas.pod_security_context, "pod-security-context"),
        default=_env("POD_SECURITY_CONTEXT"))
    add("--model-builder-class", default=os.environ.get("MODEL_BUILDER_CLASS"))
    add("--models-storage-size", default=_env("MODELS_STORAGE_SIZE", "10Gi"))
    add("--with-istio", action="store_true", default=_env("WITH_ISTIO", False, _bool))
    add("--istio-gateway", default=_env("ISTIO_GATEWAY", "istio-system/ingressgateway"))
    add("--istio-host", default=_env("ISTIO_HOST", "*"))
    add("--with-prediction-replay", action="store_true", default=_env("WITH_PREDICTION_REPLAY", False, _bool))
    add("--replay-start", default=_env("REPLAY_START"))
    add("--replay-end", default=_env("REPLAY_END"))
    add("--client-max-instances", type=int, default=_env("CLIENT_MAX_INSTANCES", 30, int))
    add("--revisions-to-keep", type=int, default=_env("REVISIONS_TO_KEEP", 3, int))
    add("--without-model-crds", action="store_true", default=_env("WITHOUT_MODEL_CRDS", False, _bool))
    add("--infra-storage-size", default=_env("INFRA_STORAGE_SIZE", "10Gi"))
    add("--job-ttl-seconds", type=int, default=_env("JOB_TTL_SECONDS", 7 * 24 * 3600, int))


def _bool(text: str) -> bool:
    """An environment flag as click reads one."""
    return text.strip().lower() in ("1", "true", "t", "yes", "y", "on")


# -- the command -----------------------------------------------------------------------


def main(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    """``workflow generate``; its exit code."""
    for option in ("machine_config", "project_name"):
        if not getattr(args, option):
            parser.error(f"--{option.replace('_', '-')} is required (or ${PREFIX}_{option.upper()})")
    # argparse has parsed the JSON options' string defaults (their variables) as it parses the options
    context = {key: value for key, value in vars(args).items() if key not in ("command", "workflow_command")}
    if context["owner_references"] is not None:
        context["owner_references"] = wg._valid_owner_ref(context["owner_references"])
    try:
        generate(context, parser_log_level=args.log_level)
    except GenerateError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


def generate(context: Dict[str, Any], parser_log_level: str = "INFO") -> None:
    """Render and print (or write) the workflows of ``context``, the
    command's options by their ``argparse`` names."""
    yaml_content = wg.get_dict_from_yaml(context["machine_config"])
    model_builder_env = context["custom_model_builder_envs"] or None
    config = NormalizedConfig(yaml_content, project_name=context["project_name"],
                              model_builder_env=model_builder_env)

    try:
        log_level = config.globals["runtime"]["log_level"]
    except KeyError:
        log_level = os.getenv("GORDO_LOG_LEVEL", parser_log_level)
    logging.getLogger("gordo_tpu_torch").setLevel(log_level.upper())
    context["log_level"] = log_level.upper()

    check_keda_flags(context)
    check_project_name_fits(context["project_name"])

    resources_labels = parse_label_overrides(context["resources_labels"])
    model_builder_labels = parse_label_overrides(context["model_builder_labels"], "--model-builder-labels")
    server_labels = parse_label_overrides(context["server_labels"], "--server-labels")
    context["common_labels"] = {
        "app.kubernetes.io/component": "gordo-tpu",
        "app.kubernetes.io/managed-by": "gordo-tpu",
        "applications.gordo.equinor.com/project-name": context["project_name"],
        "applications.gordo.equinor.com/project-revision": context["project_revision"],
        **resources_labels,
    }
    context["builder_labels"] = {**context["common_labels"], **model_builder_labels}
    context["server_labels_merged"] = {**context["common_labels"], **server_labels}

    for key in ("pod_security_context", "security_context"):
        if not context[key]:
            context.pop(key)

    version = wg.parse_version(context["gordo_version"])
    if not context.get("image_pull_policy"):
        context["image_pull_policy"] = wg.default_image_pull_policy(version)
    logger.info("Generate config with gordo_version=%s and imagePullPolicy=%s", context["gordo_version"],
                context["image_pull_policy"])

    context["max_server_replicas"] = context.pop("n_servers") or len(config.machines) * 10

    builder_runtime = config.globals["runtime"]["builder"]
    builder_resources = builder_runtime["resources"]
    context["model_builder_resources_requests_memory"] = builder_resources["requests"]["memory"]
    context["model_builder_resources_requests_cpu"] = builder_resources["requests"]["cpu"]
    context["model_builder_resources_limits_memory"] = builder_resources["limits"]["memory"]
    context["model_builder_resources_limits_cpu"] = builder_resources["limits"]["cpu"]
    builder_runtime_env = list(builder_runtime.get("env") or [])
    if context["model_builder_class"]:
        builder_runtime_env.append({"name": "MODEL_BUILDER_CLASS", "value": context["model_builder_class"]})
    context["builder_runtime_env"] = builder_runtime_env
    context["builder_volumes"] = builder_runtime.get("volumes") or []
    context["builder_volume_mounts"] = builder_runtime.get("volumeMounts") or []
    context["server_resources_k8s"] = _k8s_resources(config.globals["runtime"]["server"]["resources"])
    context["prometheus_metrics_server_resources_k8s"] = _k8s_resources(
        config.globals["runtime"]["prometheus_metrics_server"]["resources"])

    fleet = config.globals["runtime"]["fleet"]
    context["slice_geometry"] = slice_geometry(fleet["accelerator_type"])
    context["tpu_accelerator_label"] = gke_accelerator_label(fleet["accelerator_type"])
    context["gpu_accelerator_label"] = GKE_GPU_LABEL
    machines_per_slice = fleet["machines_per_slice"]

    context["keda_prometheus_query"] = render_keda_query(context["keda_prometheus_query"], context["project_name"])

    generated_at = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    if not context["replay_end"]:
        context["replay_end"] = generated_at.isoformat()
    if not context["replay_start"]:
        context["replay_start"] = (generated_at - datetime.timedelta(hours=24)).isoformat()

    # a Postgres row a machine when InfluxDB is on (the infra plane rides the same switch), MLflow opt-in
    enable_influx = any(machine.runtime.get("influx", {}).get("enable", True) for machine in config.machines)
    context["with_influx"] = enable_influx
    context["influx_resources_k8s"] = _k8s_resources(config.globals["runtime"]["influx"]["resources"])
    if enable_influx:
        pg_reporter = {POSTGRES_REPORTER: {"host": f"gordo-postgres-{config.project_name}"}}
        for machine in config.machines:
            machine.runtime.setdefault("reporters", []).append(pg_reporter)
    for machine in config.machines:
        try:
            enabled = machine.runtime["builder"]["remote_logging"]["enable"]
        except KeyError:
            continue
        if enabled:
            machine.runtime.setdefault("reporters", []).append(MLFLOW_REPORTER)

    context["target_names"] = [machine.name for machine in config.machines]
    if context["owner_references"]:
        context["owner_references"] = json.dumps(context["owner_references"])
    else:
        context.pop("owner_references")
    context["builder_exceptions_report_level"] = resolve_exceptions_report_level(config).name
    context["builder_exceptions_report_file"] = "/dev/termination-log"

    template = wg.load_workflow_template(context["workflow_template"] or wg.default_workflow_template())

    if context["output_file"]:
        open(context["output_file"], "w").close()
    validate = bool(context.get("validate_manifests_flag", True))
    rendered_chunks: List[str] = []
    project_workflow = 0
    for i in range(0, len(config.machines), context["split_workflows"]):
        logger.info("Generating workflow for machines %d to %d", i, i + context["split_workflows"])
        chunk = config.machines[i: i + context["split_workflows"]]
        context["machines"] = chunk
        context["machine_shards"] = [
            {"machines_yaml": wg.machines_document(chunk[j: j + machines_per_slice])}
            for j in range(0, len(chunk), machines_per_slice)
        ]
        context["project_workflow"] = str(project_workflow)
        # project-level documents render once, in the first workflow only
        context["first_workflow"] = project_workflow == 0
        output = template.render(**context)
        if context["output_file"]:
            with open(context["output_file"], "a") as f:
                if i != 0:
                    f.write("\n---\n")
                f.write(output)
        else:
            rendered_chunks.append(output)
            if not validate:
                if i != 0:
                    print("\n---\n")
                print(output)
        project_workflow += 1

    if validate:
        from ..workflow.manifest_validation import validate_manifests

        if context["output_file"]:
            with open(context["output_file"]) as f:
                text = f.read()
        else:
            text = "\n---\n".join(rendered_chunks)
        try:
            documents = yaml_lite.safe_load_all(text)
        except yaml_lite.YAMLError as exc:
            raise GenerateError(f"Rendered manifests are not parseable YAML (--no-validate to bypass): {exc}")
        errors = validate_manifests(documents)
        if errors:
            shown = "\n  ".join(errors[:20])
            more = f"\n  ... and {len(errors) - 20} more" if len(errors) > 20 else ""
            raise GenerateError(
                f"Rendered manifests failed schema validation ({len(errors)} error(s); --no-validate to bypass):"
                f"\n  {shown}{more}"
            )
        logger.info("Rendered manifests validated against vendored schemas")
        if not context["output_file"]:
            print("\n---\n".join(rendered_chunks))
