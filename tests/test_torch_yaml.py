"""The port's YAML reader (``gordo_tpu_torch/utils/yaml_lite.py``) against
PyYAML's ``yaml.safe_load``: every shipped example, the dict configs of
the fleet-build tests written out by ``yaml.safe_dump`` in block and in
flow style, YAML 1.1's hazard scalars, and a hypothesis round trip of
``yaml.safe_dump`` over nested maps and lists. Equality is exact (``==``
and the same types); NaN has no equal, so the round trip leaves it out.
Anchors, aliases, tags and a second document raise, naming the line."""

import ast
import datetime
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from gordo_tpu_torch.utils import yaml_lite

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.yaml"))


def _same(got, want):
    """Equal, and of the same types all the way down."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want
        if isinstance(want, datetime.datetime):
            assert got.utcoffset() == want.utcoffset()


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_examples_read_as_pyyaml_reads_them(path):
    text = path.read_text()
    _same(yaml_lite.safe_load(text), yaml.safe_load(text))


def _test_configs():
    """The module-level dict literals of the fleet-build tests."""
    configs = []
    for source in ("tests/test_torch_fleet_build.py", "tests/parallel/test_fleet_build.py"):
        tree = ast.parse((REPO / source).read_text())
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                try:
                    value = ast.literal_eval(node.value)
                except ValueError:
                    continue
                configs.append((f"{source}:{node.targets[0].id}", value))
    return configs


CONFIGS = _test_configs()


@pytest.mark.parametrize("flow", [False, True], ids=["block", "flow"])
@pytest.mark.parametrize("name,config", CONFIGS, ids=[name for name, _ in CONFIGS])
def test_test_configs_round_trip(name, config, flow):
    text = yaml.safe_dump({"machines": [{"name": "m", "model": config}]}, default_flow_style=flow)
    _same(yaml_lite.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize(
    "text",
    [
        "1e-3", "1.0e-3", "1.0e3", "yes", "no", "on", "off", "Yes", "OFF", "017", "0o17", "0x1F", "0b101", "1_000",
        "190:20:30", "-.inf", ".NaN", "~", "null", "", "2016-11-07T09:11:30+01:00", "2020-01-01",
        "2020-1-1 1:02:03.5 +5:30", "2020-01-01T00:00:00Z", "2020-01-01 00:00:00", "2min", "GRA-TAG 1", "10T",
        "'017'", '"yes"', "it's", "a: b", "[a, b,]", "{a: 1, 'b': [x, {c: d}]}", '{"a":1, "b": [1.5, null]}',
        "- a\n-\n  b: 1\n- - c", "a:\n- 1\n- 2\nb: x", 'k: "a\n  b\n\n  c"', "k: a\n  b\n\n  c",
        "a: >\n  x\n  y\n\n  z\n   w\n  v\n", "a: |-\n  x\n\n  y\n\n\nb: 1", "a: |+\n  x\n\n\nb: 1",
        "a: |2\n    x\n  y\n", 'x: "\\u00e9\\t\\x41"', "x: 'it''s'", "a: \"x\\\n   y\"", "---\na: 1 # c\n",
        "[a: 1, b]", "a: [1,\n  2]\n", "1: one\ntrue: yes\nnull: ~\n", "? a\n: 1\n", "{? '' : null}",
    ],
)
def test_hazard_scalars_and_forms(text):
    document = text if "\n" in text or text[:1] in "[{" or ": " in text else f"x: {text}"
    _same(yaml_lite.safe_load(document), yaml.safe_load(document))


@pytest.mark.parametrize(
    "text,line",
    [
        ("a: &x 1\nb: *x\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1), ("a: 1\n---\nb: 2\n", 2),
        ("%YAML 1.1\n---\na: 1\n", 1), ("a: [1, , 2]\n", 1), ("a:\n  - [1,\n  2\n", 3), ("a: 1\n...\nb: 2\n", 2),
    ],
)
def test_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(yaml_lite.YAMLError, match=f"line {line}:"):
        yaml_lite.safe_load(text)


_TEXT = st.text(alphabet="abcxyz XYZ019:-_.#'\"", min_size=0, max_size=40)
_SCALARS = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(10**12), max_value=10**12),
    st.floats(allow_nan=False),
    _TEXT,
    st.datetimes(
        min_value=datetime.datetime(1970, 1, 1), max_value=datetime.datetime(2100, 1, 1),
        timezones=st.sampled_from([datetime.timezone.utc, datetime.timezone(datetime.timedelta(hours=5, minutes=30)),
                                   datetime.timezone(-datetime.timedelta(hours=2))]),
    ),
)
_DOCUMENTS = st.recursive(
    _SCALARS,
    lambda inner: st.one_of(st.lists(inner, max_size=4), st.dictionaries(_TEXT, inner, max_size=4)),
    max_leaves=20,
)


@settings(max_examples=50, deadline=None, derandomize=True)
@given(document=st.dictionaries(_TEXT, _DOCUMENTS, max_size=5))
def test_safe_dump_round_trip(document):
    """``yaml.safe_dump``'s default (block) style; its flow style tags an
    aware datetime (``!!timestamp``), and tags are outside the subset."""
    text = yaml.safe_dump(document)
    _same(yaml_lite.safe_load(text), yaml.safe_load(text))
