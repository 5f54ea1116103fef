"""A dataset's ``row_filter`` on the port (``gordo_tpu_torch/dataset/query.py``,
``ast`` and numpy) against pandas' ``DataFrame.query``, which the JAX
dataset runs, on the CPU.

- ``row_mask`` selects exactly the rows ``DataFrame.query`` selects on
  seeded frames: ``tests/workflow/data/row-filter.yml``'s filter, the
  ``&`` precedence pandas gives (`` `tag-1` > 1 & b > 1 `` is two
  comparisons joined, not Python's ``tag-1 > (1 & b) > 1``), chained
  comparisons, ``~``, ``not``, ``abs``, arithmetic, backticked names with
  ``-``, spaces and dots, and ``{tag}_{method}`` columns; and a hypothesis
  property over generated expressions of the subset.
- What is outside the subset raises ``ValueError`` naming it, an unknown
  column the ``UnknownColumnError`` that names the column.
- The JAX dataset and the port's give the same ``X``, ``y``, index,
  metadata (``filtered_rows`` among it) under a ``row_filter``, alone and
  between the known filter periods and the thresholds, over several
  aggregation methods, and from ``row-filter.yml`` through both packages'
  normalized configs.
"""

import copy
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict_from_yaml
from gordo_tpu_torch.dataset import GordoBaseDataset
from gordo_tpu_torch.dataset.query import RowFilterError, UnknownColumnError, row_mask
from tests.test_torch_dataset import _assert_same_data, _both

REPO = Path(__file__).resolve().parents[1]
COLUMNS = ["tag-1", "b", "c d", "x.y", "t1_mean", "t1_max"]


def _frame(seed: int, rows: int = 300) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    values = rng.randn(rows, len(COLUMNS)) * 3
    values[::7, 1] = 0.0  # exact zeros: == and != see them
    values[::11, 2] = 2.0
    return pd.DataFrame(values, columns=COLUMNS)


def _same_rows(text: str, frame: pd.DataFrame):
    want = frame.index.isin(frame.query(text).index)
    got = row_mask(text, list(frame.columns), frame.to_numpy())
    np.testing.assert_array_equal(got, want, err_msg=text)
    return got


CASES = [
    "`tag-1` > -500",
    "`tag-1` > 1 & b > 1",
    "`tag-1` > 1 & b > 1 | `c d` < 0",
    "1 < `tag-1` <= 3",
    "-2 <= b < `c d` <= 4",
    "~(b > 0)",
    "~(b > 0) & ~(`x.y` < 1)",
    "not b > 0 and `x.y` < 0",
    "not (b > 0 or `x.y` < 0)",
    "abs(b) < 1 | `c d` > 2",
    "abs(b - `tag-1`) >= 2",
    "b ** 2 + `c d` % 2 > 3",
    "-b > +1.5",
    "(`tag-1` - b) / 2 >= 0.5",
    "b == 0",
    "b != 0 & `c d` == 2",
    "2 ** -1 < b",
    "t1_mean > t1_max - 3",
    "t1_mean * 2 < 1 | t1_max >= 2.5e0",
    "(b > 0) & (b < 2) | (b > 5)",
]


@pytest.mark.parametrize("text", CASES)
def test_row_mask_matches_query(text):
    for seed in (0, 1):
        _same_rows(text, _frame(seed))


def test_precedence_is_pandas_not_python():
    """The trap: Python reads ``a > 1 & b > 1`` as ``a > (1 & b) > 1``."""
    frame = _frame(2)
    got = _same_rows("`tag-1` > 1 & b > 1", frame)
    both = (frame["tag-1"] > 1) & (frame["b"] > 1)
    np.testing.assert_array_equal(got, both.to_numpy())
    assert 0 < got.sum() < len(frame)


# -- a property over generated expressions ------------------------------------------------

_NAMES = st.sampled_from(["`tag-1`", "b", "`c d`", "`x.y`", "t1_mean", "t1_max"])
_LITERALS = st.sampled_from(["0", "1", "2", "3", "0.5", "1.25", "2.5", "1e-1"])
_NONZERO = st.sampled_from(["1", "2", "3", "0.5", "1.25", "2.5"])


def _numeric(depth: int):
    leaf = st.one_of(_NAMES, _LITERALS)
    if depth == 0:
        return leaf
    inner = _numeric(depth - 1)
    return st.one_of(
        leaf,
        st.tuples(inner, st.sampled_from(["+", "-", "*"]), inner).map(lambda t: f"({t[0]} {t[1]} {t[2]})"),
        st.tuples(inner, st.sampled_from(["/", "%"]), _NONZERO).map(lambda t: f"({t[0]} {t[1]} {t[2]})"),
        st.tuples(inner, st.sampled_from(["1", "2", "3"])).map(lambda t: f"({t[0]} ** {t[1]})"),
        inner.map(lambda e: f"-{e}"),
        inner.map(lambda e: f"abs({e})"),
    )


_COMPARISONS = st.sampled_from(["<", "<=", ">", ">=", "==", "!="])


def _comparison():
    numeric = _numeric(2)
    single = st.tuples(_NAMES, _COMPARISONS, numeric).map(lambda t: f"{t[0]} {t[1]} {t[2]}")
    chained = st.tuples(numeric, _COMPARISONS, _NAMES, _COMPARISONS, numeric).map(
        lambda t: f"{t[0]} {t[1]} {t[2]} {t[3]} {t[4]}")
    return st.one_of(single, chained)


def _boolean(depth: int):
    if depth == 0:
        return _comparison()
    inner = _boolean(depth - 1)
    return st.one_of(
        _comparison(),
        st.tuples(inner, st.sampled_from(["&", "|", "and", "or"]), inner).map(lambda t: f"{t[0]} {t[1]} {t[2]}"),
        inner.map(lambda e: f"({e})"),
        inner.map(lambda e: f"~({e})"),
        inner.map(lambda e: f"not ({e})"),
    )


@settings(max_examples=150, deadline=None)
@given(_boolean(2), st.integers(0, 3))
def test_property_generated_expressions_match_query(text, seed):
    frame = _frame(10 + seed, rows=60)
    with np.errstate(all="ignore"):
        _same_rows(text, frame)


# -- refusals -----------------------------------------------------------------------------

REFUSED = {
    "@local > 1": "local variables",
    "b > 'a'": "literal 'a'",
    "b in [1, 2]": "comparison In",
    "index > 3": "index",
    "sin(b) > 0": "call sin",
    "b.abs() > 0": "method call .abs",
    "b > True": "literal True",
    "b + 1": "one boolean a row",
    "b > 1 ^ b < 2": "BitXor",
    "b[0] > 1": "subscript",
    "`tag-1 > 1": "unclosed backtick",
    "b = 1": "does not parse",
    "b is None": "comparison Is",
    "-(b > 1)": "negative",
}


@pytest.mark.parametrize("text,what", list(REFUSED.items()))
def test_refused_constructs_raise_value_error(text, what):
    frame = _frame(3, rows=10)
    with pytest.raises(RowFilterError, match=what.replace("(", r"\(").replace(".", r"\.")) as info:
        row_mask(text, list(frame.columns), frame.to_numpy())
    assert isinstance(info.value, ValueError) and text in str(info.value)


def test_unknown_column_names_it():
    frame = _frame(4, rows=10)
    with pytest.raises(UnknownColumnError, match="tag-9") as info:
        row_mask("`tag-9` > 1 & b > 0", list(frame.columns), frame.to_numpy())
    assert info.value.name == "tag-9" and isinstance(info.value, ValueError)
    with pytest.raises(Exception) as pandas_error:
        frame.query("`tag-9` > 1 & b > 0")
    assert isinstance(pandas_error.value, NameError)


# -- datasets -----------------------------------------------------------------------------


def _random(**extra):
    return {
        "train_start_date": "2020-01-01T00:00:00+00:00",
        "train_end_date": "2020-01-08T00:00:00+00:00",
        "tag_list": ["tag-1", "t2", "t3"],
        "data_provider": {"type": "RandomDataProvider"},
        **extra,
    }


DATASETS = {
    "row-filter-yml": _random(row_filter="`tag-1` > -500", resolution="30min"),
    "precedence": _random(row_filter="`tag-1` > 37 & t2 < 30"),
    "chained-abs": _random(row_filter="37 < `tag-1` <= 38.2 | abs(t3) > 16"),
    "with-periods-and-thresholds": _random(
        row_filter="~(t2 > 30) and t3 != 0",
        known_filter_periods=[["2020-01-02T00:00:00+00:00", "2020-01-03T12:00:00+00:00"]],
        low_threshold=-45.0, high_threshold=45.0, target_tag_list=["t2"]),
    "aggregations": _random(row_filter="`tag-1_max` - `tag-1_min` > 0.05 & t2_mean < 30", resolution="1h",
                            aggregation_methods=["mean", "max", "min"],
                            data_provider={"type": "RandomDataProvider", "min_size": 2000, "max_size": 3000}),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_matches_jax_under_row_filter(name):
    jax_dataset, dataset = _both(copy.deepcopy(DATASETS[name]))
    X = _assert_same_data(jax_dataset, dataset)
    filtered = dataset.get_metadata()["filtered_rows"]
    assert filtered == jax_dataset.get_metadata()["filtered_rows"]
    assert len(X) > 10
    if name != "row-filter-yml":
        assert filtered > 0


def test_row_filter_yml_through_both_configs():
    """``tests/workflow/data/row-filter.yml`` normalized by both packages:
    the same rows."""
    from gordo_tpu_torch.workflow.config_elements.normalized_config import NormalizedConfig
    from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml

    path = REPO / "tests" / "workflow" / "data" / "row-filter.yml"
    jax_config = JaxNormalizedConfig(jax_get_dict_from_yaml(str(path)), "proj")
    config = NormalizedConfig(get_dict_from_yaml(str(path)), "proj")
    (jax_machine,), (machine,) = jax_config.machines, config.machines
    assert machine.dataset.to_dict()["row_filter"] == "`tag-1` > -500"
    _assert_same_data(jax_machine.dataset, machine.dataset)


def test_unknown_column_fails_the_data_stage():
    dataset = GordoBaseDataset.from_dict(_random(row_filter="`tag-9` > 0"))
    with pytest.raises(ValueError, match="tag-9"):
        dataset.get_data()
