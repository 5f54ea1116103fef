"""The port's config path against the JAX package's: ``NormalizedConfig``
of the example configs (every machine's ``to_dict()`` equal, datetimes
compared as ISO strings, and the patched globals), the machine shard
(the port's JSON read back by its own reader and by ``yaml.safe_load``,
equal to the JAX package's YAML shard), the refusal of naive time
stamps and of bad runtime blocks, and ``KFold`` against
``sklearn.model_selection.KFold``, fold for fold and in order."""

import datetime
import io
import json

import numpy as np
import pytest
import yaml
from sklearn.model_selection import KFold as SkKFold

from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict_from_yaml
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.model_selection import KFold
from gordo_tpu_torch.utils import yaml_lite
from gordo_tpu_torch.workflow.config_elements.normalized_config import NormalizedConfig
from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml, machines_document, normalize

EXAMPLES = ["examples/config.yaml", "examples/config-file-data.yaml"]


def _iso(document):
    """``document`` with every datetime as its ISO string."""

    def default(obj):
        if isinstance(obj, (datetime.datetime, datetime.date)):
            return obj.isoformat()
        raise TypeError(type(obj))

    return json.loads(json.dumps(document, default=default))


@pytest.mark.parametrize("path", EXAMPLES)
def test_normalized_config_matches_jax(path):
    jax_config = JaxNormalizedConfig(jax_get_dict_from_yaml(path), "my-project")
    config = NormalizedConfig(get_dict_from_yaml(path), "my-project")
    assert config.globals == jax_config.globals
    assert [m.name for m in config.machines] == [m.name for m in jax_config.machines]
    for machine, jax_machine in zip(config.machines, jax_config.machines):
        assert _iso(machine.to_dict()) == _iso(jax_machine.to_dict()), machine.name


@pytest.mark.parametrize("path", EXAMPLES)
def test_shard_reads_back_in_both_readers(path):
    shard = normalize(path, "my-project")
    document = yaml.safe_load(shard)
    assert yaml_lite.safe_load(shard) == document
    jax_machines = JaxNormalizedConfig(jax_get_dict_from_yaml(path), "my-project").machines
    assert document == yaml.safe_load(jax_machines_yaml(jax_machines))
    machines = [Machine.from_dict(m) for m in document["machines"]]
    assert machines_document(machines) == shard


NAIVE = """
machines:
  - name: m-1
    dataset:
      tags: [a, b]
      train_start_date: 2020-01-01T00:00:00
      train_end_date: 2020-01-02T00:00:00+00:00
globals:
  model: "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"
"""


def test_naive_timestamps_are_refused():
    with pytest.raises(ValueError, match="timezone"):
        jax_get_dict_from_yaml(io.StringIO(NAIVE))
    with pytest.raises(ValueError, match="timezone"):
        get_dict_from_yaml(io.StringIO(NAIVE))
    aware = NAIVE.replace("00:00:00\n", "00:00:00+01:00\n", 1)
    assert _iso(get_dict_from_yaml(io.StringIO(aware))) == _iso(jax_get_dict_from_yaml(io.StringIO(aware)))


@pytest.mark.parametrize(
    "runtime",
    [{"fleet": {"num_slices": 0}}, {"fleet": {"machines_per_slice": "many"}}, {"server": {"resources": [1]}},
     {"builder": {"env": [{"value": "x"}]}}, {"builder": {"volumes": [{"configMap": {}}]}}],
    ids=["slices-0", "slices-word", "resources-list", "env-without-name", "volume-without-name"],
)
def test_bad_runtime_blocks_raise_in_both(runtime):
    config = jax_get_dict_from_yaml("examples/config.yaml")
    config["globals"]["runtime"] = runtime
    with pytest.raises(ValueError):
        JaxNormalizedConfig(config, "my-project")
    with pytest.raises(ValueError):
        NormalizedConfig(config, "my-project")


def test_fleet_block_is_normalized_as_pydantic_dumps_it():
    config = jax_get_dict_from_yaml("examples/config.yaml")
    config["globals"]["runtime"] = {"fleet": {"num_slices": "2", "extra": 1}}
    assert NormalizedConfig(config, "p").globals == JaxNormalizedConfig(config, "p").globals


@pytest.mark.parametrize(
    "n,splits,shuffle,seed",
    [(5, 3, False, None), (101, 5, True, 0), (4032, 5, True, 0), (7, 2, True, 3), (10, 10, True, 1)],
)
def test_kfold_matches_sklearn(n, splits, shuffle, seed):
    X = np.zeros((n, 2))
    for (train, test), (sk_train, sk_test) in zip(
        KFold(splits, shuffle, seed).split(X), SkKFold(splits, shuffle=shuffle, random_state=seed).split(X),
        strict=True,
    ):
        np.testing.assert_array_equal(train, sk_train)
        np.testing.assert_array_equal(test, sk_test)
