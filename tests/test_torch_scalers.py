"""The port's preprocessing steps (``gordo_tpu_torch/models/preprocessing.py``,
``models/transformers/imputer.py``, ``models/transformer_funcs/general.py``)
against scikit-learn and the JAX package's own steps.

Each scaler is fitted on the same float64 rows (NaN cells and a constant
column among them) and held to scikit-learn's ``fit`` attributes and
``transform`` at rtol 1e-12, and its ``affine()`` to
``gordo_tpu/ingest/plan.py::_affine_of`` of the fitted sklearn scaler at
the same tolerance. On float32 rows ``transform`` keeps sklearn's dtype
flow and matches it to 1 ulp. ``InfImputer`` and ``multiply_by`` are held
to the JAX package's bit for bit.
"""

import numpy as np
import pytest
from sklearn import preprocessing as skp

from gordo_tpu.ingest.plan import _affine_of
from gordo_tpu.models.transformer_funcs.general import multiply_by as jax_multiply_by
from gordo_tpu.models.transformers.imputer import InfImputer as JaxInfImputer
from gordo_tpu_torch.models import preprocessing as port
from gordo_tpu_torch.models.transformer_funcs.general import multiply_by
from gordo_tpu_torch.models.transformers.imputer import InfImputer
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.server.fleet_store import NOT_AFFINE, member_plan

RTOL = 1e-12

#: (port class, sklearn class, constructor arguments, fitted attributes compared)
CASES = [
    ("MinMaxScaler", {}, ("scale_", "min_")),
    ("MinMaxScaler", {"feature_range": (-1.0, 2.0)}, ("scale_", "min_")),
    ("StandardScaler", {}, ("mean_", "var_", "scale_")),
    ("StandardScaler", {"with_mean": False}, ("var_", "scale_")),
    ("StandardScaler", {"with_std": False}, ("mean_",)),
    ("MaxAbsScaler", {}, ("max_abs_", "scale_")),
    ("RobustScaler", {}, ("center_", "scale_")),
    ("RobustScaler", {"quantile_range": (10.0, 90.0), "unit_variance": True}, ("center_", "scale_")),
    ("RobustScaler", {"with_centering": False}, ("scale_",)),
    ("RobustScaler", {"with_scaling": False}, ("center_",)),
]


def rows(seed=0, n=257, f=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f)) * rng.uniform(0.1, 50, f) + rng.uniform(-30, 30, f)
    X[:, 2] = 4.25  # constant: sklearn's zero-scale rule
    X[[3, n // 2, n - 1], 1] = np.nan
    return X


def case_id(case):
    name, kwargs, _ = case
    return name + "".join(f"-{k}={v}" for k, v in kwargs.items())


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_scaler_fit_transform_affine_match_sklearn(case):
    name, kwargs, attributes = case
    X, Z = rows(0), rows(1, n=50)
    ours = getattr(port, name)(**kwargs).fit(X)
    theirs = getattr(skp, name)(**kwargs).fit(X)
    for attr in attributes:
        np.testing.assert_allclose(getattr(ours, attr), getattr(theirs, attr), rtol=RTOL, err_msg=attr)
    np.testing.assert_allclose(ours.transform(Z), theirs.transform(Z), rtol=RTOL, atol=1e-300)
    scale, offset = ours.affine()
    want_scale, want_offset = _affine_of(theirs)
    np.testing.assert_allclose(np.broadcast_to(scale, 6), np.broadcast_to(want_scale, 6), rtol=RTOL)
    np.testing.assert_allclose(np.broadcast_to(offset, 6), np.broadcast_to(want_offset, 6), rtol=RTOL, atol=1e-300)
    # the affine form is the transform
    finite = np.nan_to_num(Z)
    np.testing.assert_allclose(finite * scale + offset, ours.transform(finite), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("name", ["StandardScaler", "MaxAbsScaler", "RobustScaler"])
def test_float32_transform_keeps_sklearn_dtype_flow(name):
    X = rows(2)
    Z = rows(3, n=40).astype(np.float32)
    ours = getattr(port, name)().fit(X)
    theirs = getattr(skp, name)().fit(X)
    got, want = ours.transform(Z), theirs.transform(Z)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(np.nan_to_num(got), np.nan_to_num(want), maxulp=1)


@pytest.mark.parametrize("name,kwargs,low,high", [
    ("MinMaxScaler", {"clip": True, "feature_range": (0.0, 1.0)}, 0.0, 1.0),
    ("MaxAbsScaler", {"clip": True}, -1.0, 1.0),
])
def test_clipping_scalers_have_no_affine_form(name, kwargs, low, high):
    X = rows(4)
    Z = rows(5, n=60) * 3.0  # beyond the fitted range: clipped
    ours = getattr(port, name)(**kwargs).fit(X)
    theirs = getattr(skp, name)(**kwargs).fit(X)
    np.testing.assert_allclose(ours.transform(Z), theirs.transform(Z), rtol=RTOL)
    assert np.nanmin(ours.transform(Z)) == low and np.nanmax(ours.transform(Z)) == high
    assert ours.affine() is None
    jax_plan = _affine_of(theirs)
    if name == "MinMaxScaler":
        assert jax_plan is None
    else:
        # the JAX plan matches MaxAbsScaler by type and misses its clip
        # (ROADMAP.md queue 3): its affine form is not the transform
        assert not np.allclose(np.nan_to_num(Z) * jax_plan[0] + jax_plan[1], np.nan_to_num(theirs.transform(Z)))


@pytest.mark.parametrize("kwargs", [{}, {"strategy": "extremes"}, {"delta": 0.5},
                                    {"inf_fill_value": 7.0, "neg_inf_fill_value": -3.0}])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inf_imputer_matches_jax(kwargs, dtype):
    X = rows(6).astype(dtype)
    X[[5, 9], 0] = np.inf
    X[[7], 3] = -np.inf
    X[:, 4] = np.inf  # a column of only inf: max/min fall back to 0 +- delta
    Z = rows(7, n=30).astype(dtype)
    Z[[0, 2], 1] = np.inf
    Z[[1], 5] = -np.inf
    ours, theirs = InfImputer(**kwargs).fit(X), JaxInfImputer(**kwargs).fit(X)
    np.testing.assert_array_equal(ours.transform(Z), theirs.transform(Z))
    assert ours.transform(Z).dtype == dtype
    assert not hasattr(ours, "affine")


def test_multiply_by_and_function_transformer_match_jax():
    X = rows(8)
    np.testing.assert_array_equal(multiply_by(X, 2), jax_multiply_by(X, 2))
    for path in ("gordo_tpu.models.transformer_funcs.general.multiply_by",
                 "gordo.machine.model.transformer_funcs.general.multiply_by"):
        step = from_definition({"sklearn.preprocessing.FunctionTransformer": {
            "func": path, "kw_args": {"factor": 2.5}}}, device="cpu")
        np.testing.assert_array_equal(step.fit_transform(X), X * 2.5)
        assert not hasattr(step, "affine")
    identity = port.FunctionTransformer()
    assert identity.transform(X) is X
    with pytest.raises(NotImplementedError):
        port.FunctionTransformer("numpy.log1p")


def test_transformer_state_clone_and_member_plan():
    X = rows(9)
    steps = [port.StandardScaler().fit(X), port.RobustScaler(quantile_range=(5.0, 95.0)).fit(X),
             port.MaxAbsScaler().fit(X), port.MinMaxScaler(feature_range=(-1, 1), clip=True).fit(X),
             InfImputer(delta=3.0).fit(X)]
    for step in steps:
        params = step.get_params()
        fitted = {k: v for k, v in vars(step).items() if k.endswith("_") or k.startswith("_")}
        again = port.transformer_from_state({"type": type(step).__name__, **params, **fitted})
        np.testing.assert_array_equal(again.transform(X), step.transform(X))
        fresh = port.clone(step)
        assert type(fresh) is type(step) and fresh.get_params() == params
    # an entry without a type is a MinMaxScaler, as the states of earlier tests give it
    old = port.transformer_from_state({"scale_": [2.0], "min_": [1.0]})
    assert isinstance(old, port.MinMaxScaler) and old.transform(np.array([[1.0]])).tolist() == [[3.0]]

    class Model:
        def __init__(self, transformers):
            self.base_estimator = port.Pipeline([(f"s{i}", t) for i, t in enumerate(transformers)] + [("e", None)])

    assert member_plan(Model([]), 6) is None
    assert member_plan(Model(steps[:3]), 6) is not None
    assert member_plan(Model(steps[:4]), 6) is NOT_AFFINE
    assert member_plan(Model([steps[4], steps[0]]), 6) is NOT_AFFINE
