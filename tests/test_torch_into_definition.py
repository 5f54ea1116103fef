"""The port's ``into_definition`` (``gordo_tpu_torch/serializer/into_definition.py``)
and the ``build`` command's expanded definition against the JAX
package's, on the CPU.

- Every model definition of ``examples/*.yaml`` (the blocks of
  ``model-configuration.yaml``, each config's ``globals`` and machine
  models, the YAML-text ones read first) and every definition of
  ``tests/test_torch_definitions.py`` (scalers, imputers, function
  transformers, reference paths, callbacks): the port's
  ``into_definition(from_definition(d))`` equals the JAX package's, as
  Python values and as JSON text (the key order included); the port reads
  its own expanded definition back to the same definition.
- The port's ``build`` and the JAX ``build`` of one machine (each through
  a model register) record the same ``model`` in ``metadata.json`` and
  land under the same cache key, and so do they with a model given as a
  template string and expanded by ``--model-parameter``.
"""

import glob
import json

import pytest
import yaml
from click.testing import CliRunner

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.cli import gordo_tpu_cli
from gordo_tpu_torch import serializer
from gordo_tpu_torch.cli.cli import main

from tests.test_torch_builder import PROJECT, machine_config
from tests.test_torch_definitions import DEFINITIONS


def _model(value):
    return yaml.safe_load(value) if isinstance(value, str) else value


def example_definitions():
    """``{label: definition}`` of every model definition in ``examples/``."""
    found = {}
    with open("examples/model-configuration.yaml") as f:
        for name, block in yaml.safe_load(f).items():
            found[f"model-configuration:{name}"] = block
    for path in sorted(glob.glob("examples/*.yaml")):
        if path.endswith("model-configuration.yaml"):
            continue
        with open(path) as f:
            for document in yaml.safe_load_all(f):
                config = (document or {}).get("spec", {}).get("config", document or {})
                model = (config.get("globals") or {}).get("model")
                if model:
                    found[f"{path}:globals"] = _model(model)
                for machine in config.get("machines") or []:
                    if machine.get("model"):
                        found[f"{path}:{machine['name']}"] = _model(machine["model"])
    return found


EXAMPLES = example_definitions()
ALL = {**{f"example:{k}": v for k, v in EXAMPLES.items()}, **{f"definitions:{k}": v for k, v in DEFINITIONS.items()}}


def test_every_example_config_is_covered():
    assert len(EXAMPLES) >= 9
    assert any(label.endswith(":globals") for label in EXAMPLES)


@pytest.mark.parametrize("label", list(ALL))
def test_into_definition_matches_jax(label):
    definition = ALL[label]
    expected = jax_serializer.into_definition(jax_serializer.from_definition(definition))
    got = serializer.into_definition(serializer.from_definition(definition, device="cpu"))
    assert got == expected
    assert json.dumps(got) == json.dumps(expected)
    # the port reads its expanded definition back to itself
    assert serializer.into_definition(serializer.from_definition(got, device="cpu")) == got


def test_build_records_the_jax_commands_definition_and_cache_key(tmp_path, capsys):
    config = json.dumps({**machine_config("detector"), "project_name": PROJECT})
    roots = tmp_path / "jax", tmp_path / "port"
    result = CliRunner().invoke(gordo_tpu_cli, ["build", config, str(roots[0] / "out"), "--model-register-dir",
                                                str(roots[0] / "register")])
    assert result.exit_code == 0, result.output
    assert main(["build", config, str(roots[1] / "out"), "--device", "cpu", "--model-register-dir",
                 str(roots[1] / "register")]) == 0
    models = []
    for root in roots:
        with open(root / "out" / "metadata.json") as f:
            models.append(json.load(f)["model"])
    assert models[1] == models[0]
    assert "sklearn.preprocessing._data.MinMaxScaler" in json.dumps(models[1])
    keys = [sorted(p.name for p in (root / "register" / "builds").iterdir()) for root in roots]
    assert keys[1] == keys[0] and len(keys[0]) == 1


TEMPLATED = """
gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
  base_estimator:
    sklearn.pipeline.Pipeline:
      steps:
        - sklearn.preprocessing.{{ scaler }}
        - gordo_tpu.models.JaxAutoEncoder:
            kind: feedforward_hourglass
            encoding_layers: 1
            epochs: {{ n_epochs }}
"""


def test_build_model_parameter_expands_as_the_jax_command(tmp_path):
    config = json.dumps({**machine_config("detector"), "project_name": PROJECT, "model": TEMPLATED})
    parameters = ["--model-parameter", "n_epochs,2", "--model-parameter", "scaler,MinMaxScaler"]
    roots = tmp_path / "jax", tmp_path / "port"
    result = CliRunner().invoke(gordo_tpu_cli, ["build", config, str(roots[0] / "out"), "--model-register-dir",
                                                str(roots[0] / "register"), *parameters])
    assert result.exit_code == 0, result.output
    assert main(["build", config, str(roots[1] / "out"), "--device", "cpu", "--model-register-dir",
                 str(roots[1] / "register"), *parameters]) == 0
    models = [json.loads((root / "out" / "metadata.json").read_text())["model"] for root in roots]
    assert models[1] == models[0]
    assert '"epochs": 2' in json.dumps(models[1]) and "{{" not in json.dumps(models[1])
    keys = [sorted(p.name for p in (root / "register" / "builds").iterdir()) for root in roots]
    assert keys[1] == keys[0] and len(keys[0]) == 1
