"""The port stands alone: no module of ``gordo_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, the JAX package, or a library the card's
machine does not have (pandas, scikit-learn, werkzeug, yaml, pyarrow,
click, jinja2, pydantic, dateutil, ml_dtypes, prometheus_client,
influxdb, requests, a snappy binding, numexpr, fastparquet, mlflow, the
AzureML SDK, psycopg2, jsonschema).
Checked on the source with ``ast``, so an import inside a function
counts too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "gordo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {
    "jax", "jaxlib", "gordo_tpu", "pandas", "sklearn", "werkzeug", "yaml", "pyarrow", "optax", "flax",
    "click", "jinja2", "pydantic", "dateutil", "ml_dtypes", "prometheus_client",
    "influxdb", "requests", "snappy", "cramjam", "numexpr", "fastparquet", "mlflow", "azureml", "psycopg2",
    "jsonschema",
}


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree) if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_check_sees_imports():
    tree = ast.parse("import jax.numpy\nfrom gordo_tpu.server import x\nfrom . import y\nimport gordo_tpu_torch\n")
    assert [root for _, root in _imported_roots(tree)] == ["jax", "gordo_tpu", "gordo_tpu_torch"]


def test_package_has_modules():
    names = {p.relative_to(REPO / "gordo_tpu_torch").as_posix() for p in FILES[:-1]}
    for expected in (
        "ops/fleet_dense.py", "server/app.py", "models/nn.py", "serializer/serializer.py",
        "utils/env.py", "utils/faults.py", "serve/ladder.py", "serve/breaker.py",
        "stream/events.py", "stream/ring.py", "stream/session.py", "stream/telemetry.py",
        "stream/scorer.py", "stream/plane.py", "server/views/stream.py",
        "ops/losses.py", "models/optim.py", "models/training.py", "models/callbacks.py",
        "models/metrics.py", "models/model_selection.py", "planner/packing.py", "parallel/fleet.py",
        "parallel/fleet_build.py", "serializer/from_definition.py", "machine/machine.py", "machine/metadata.py",
        "server/utils.py", "server/fleet_store.py", "server/wire/negotiate.py", "server/wire/assemble.py",
        "server/views/base.py", "utils/yaml_lite.py", "utils/args.py", "workflow/helpers.py",
        "workflow/workflow_generator/workflow_generator.py", "workflow/config_elements/normalized_config.py",
        "machine/constants.py", "utils/postfork.py", "server/prefork.py", "server/prometheus/multiprocess.py",
        "machine/loader.py", "dataset/exceptions.py", "dataset/sensor_tag.py", "dataset/series.py",
        "dataset/data_provider.py", "dataset/datasets.py", "models/anomaly/diff.py", "cli/cli.py",
        "cli/exceptions_reporter.py", "__main__.py", "ops/windows.py", "models/factories/lstm_autoencoder.py",
        "builder/__init__.py", "builder/build_model.py", "builder/local_build.py", "builder/utils.py",
        "parallel/journal.py", "utils/disk_registry.py", "serve/batcher.py", "serve/engine.py",
        "serve/precision.py", "server/model_io.py", "telemetry/recorder.py", "telemetry/progress.py",
        "telemetry/device.py", "telemetry/fleet_health.py", "planner/costmodel.py", "planner/plan.py",
        "telemetry/tracing.py", "telemetry/serving.py", "telemetry/profiler.py", "telemetry/slo.py",
        "utils/profiling.py", "telemetry/aggregate.py", "telemetry/trace_analysis.py",
        "lifecycle/__init__.py", "lifecycle/state.py", "lifecycle/revision.py", "lifecycle/drift.py",
        "lifecycle/gates.py", "lifecycle/loop.py", "planner/ladder.py", "planner/report.py", "models/packing.py",
        "dataset/query.py", "dataset/influx.py", "utils/snappy.py", "utils/thrift_compact.py", "utils/parquet.py",
        "server/multipart.py", "server/wire/parquet_codec.py", "client/__init__.py", "client/client.py",
        "client/io.py", "client/utils.py", "client/forwarders.py", "client/cli.py", "cli/deploy.py",
        "serializer/into_definition.py", "reporters/__init__.py", "reporters/base.py", "reporters/mlflow.py",
        "reporters/postgres.py", "reporters/pgwire.py", "reporters/pgstub.py", "utils/template.py",
        "workflow/workflow_generator/tpu.py",
        "workflow/workflow_generator/__init__.py", "workflow/config_elements/schemas.py",
        "workflow/manifest_validation.py", "cli/workflow_generator.py",
        "perfmodel/__init__.py", "perfmodel/features.py", "perfmodel/model.py", "perfmodel/service.py",
        "cli/perfmodel.py",
    ):
        assert expected in names
    assert (REPO / "gordo_tpu_torch" / "telemetry" / "slos.toml").read_text() == (
        REPO / "gordo_tpu" / "telemetry" / "slos.toml").read_text()
    assert (REPO / "gordo_tpu_torch" / "workflow" / "workflow_generator" / "resources"
            / "gpu-workflow.yml.template").is_file()


#: library recurrences: the port writes its LSTM out (gate order, the
#: activation on candidate and cell output, one bias)
RECURRENT = {"LSTM", "GRU", "RNN", "LSTMCell", "GRUCell", "RNNCell", "_cudnn_rnn", "rnn_tanh", "lstm"}


def _library_recurrence_or_compile(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and (
            node.attr in RECURRENT or (node.attr == "compile" and getattr(node.value, "id", None) == "torch")
            or node.attr == "_dynamo"
        ):
            yield node.lineno, node.attr
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("torch"):
            for alias in node.names:
                if alias.name in RECURRENT or alias.name in ("compile", "_dynamo"):
                    yield node.lineno, alias.name


@pytest.mark.parametrize("path", FILES[:-1], ids=[str(p.relative_to(REPO)) for p in FILES[:-1]])
def test_no_library_recurrence_or_compile(path):
    """No ``torch.nn.LSTM`` (or another library RNN), cuDNN RNN or
    ``torch.compile`` in the package; ``chip_smoke.py`` times cuDNN as a
    yardstick only."""
    bad = list(_library_recurrence_or_compile(ast.parse(path.read_text(), filename=str(path))))
    assert not bad, f"{path.name} uses {bad}"


def test_the_recurrence_check_sees_them():
    tree = ast.parse("import torch\ntorch.nn.LSTM(3, 4)\nf = torch.compile(g)\nfrom torch.nn import GRU\nre.compile('x')\n")
    assert sorted(_library_recurrence_or_compile(tree)) == [(2, "LSTM"), (3, "compile"), (4, "GRU")]
