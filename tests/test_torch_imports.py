"""The port stands alone: no module of ``gordo_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, the JAX package, or a library the card's
machine does not have (pandas, scikit-learn, werkzeug, yaml, pyarrow,
click, jinja2, pydantic, dateutil).
Checked on the source with ``ast``, so an import inside a function
counts too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "gordo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {
    "jax", "jaxlib", "gordo_tpu", "pandas", "sklearn", "werkzeug", "yaml", "pyarrow", "optax", "flax",
    "click", "jinja2", "pydantic", "dateutil",
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
        "workflow/workflow_generator.py", "workflow/config_elements/normalized_config.py", "machine/constants.py",
        "machine/loader.py", "dataset/exceptions.py", "dataset/sensor_tag.py", "dataset/series.py",
        "dataset/data_provider.py", "dataset/datasets.py", "models/anomaly/diff.py", "cli/cli.py",
        "cli/exceptions_reporter.py", "__main__.py",
    ):
        assert expected in names
