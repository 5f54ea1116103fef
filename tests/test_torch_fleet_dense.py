"""K1, the fleet dense-stack forward, against the JAX package.

On the CPU the wrapper runs its plain version; these cases are those of
``tests/ops/test_pallas_dense.py``, held against
``fleet_feedforward_pallas(..., interpret=True)`` at that file's
tolerance (rtol 1e-5, atol 1e-6), plus the gather and ingest variants
against ``gordo_tpu.server.fleet_store.fleet_forward_gather``. Inputs
and params are made with seeded numpy/JAX and given to both packages.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_fleet_dense_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

import gordo_tpu.ops.pallas_dense as pallas_dense
from gordo_tpu.models import factories as jax_factories
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.server.fleet_store import fleet_forward_gather as jax_forward_gather
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.nn import init_feedforward, params_from_jax
from gordo_tpu_torch.ops import _build, fleet_dense
from gordo_tpu_torch.ops.fleet_dense import (
    fleet_feedforward,
    fleet_feedforward_reference,
)
from gordo_tpu_torch.parallel.fleet import stack_member_params


def _jax_bucket(spec, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: jax_init(k, spec))(keys)


def _port(bucket):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, bucket))


def _both(factory, *args, **kwargs):
    return getattr(jax_factories, factory)(*args, **kwargs), getattr(factories, factory)(*args, **kwargs)


@pytest.mark.parametrize("m,b", [(1, 8), (4, 32)])
def test_hourglass_matches_pallas(m, b):
    jax_spec, spec = _both("feedforward_hourglass", 12)
    bucket = _jax_bucket(jax_spec, m, 0)
    X = np.random.RandomState(0).rand(m, b, 12).astype(np.float32)
    expected = pallas_dense.fleet_feedforward_pallas(jax_spec, bucket, X, interpret=True)
    launches = fleet_feedforward.launches
    got = fleet_feedforward(spec, _port(bucket), torch.from_numpy(X))
    assert fleet_feedforward.launches == launches  # CPU runs are plain runs
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_launches_are_counted_by_shape_where_the_kernel_launches(monkeypatch):
    """A launch (the kernel stood in for, on a tensor off the CPU) adds one
    to ``launches`` and one to ``shapes`` at X's shape; a CPU run to neither."""
    import collections

    spec = factories.feedforward_hourglass(6)
    bucket = {k: {n: torch.zeros(2, *t.shape) for n, t in layer.items()}
              for k, layer in init_feedforward(spec, torch.Generator().manual_seed(0)).items()}
    monkeypatch.setattr(fleet_feedforward, "launches", 0)
    monkeypatch.setattr(fleet_feedforward, "shapes", collections.Counter())
    monkeypatch.setattr(fleet_dense, "_launch", lambda spec, stacked, X, *_: (X, None))
    fleet_feedforward(spec, bucket, torch.zeros(2, 5, 6))
    assert fleet_feedforward.launches == 0 and not fleet_feedforward.shapes
    for M, B in ((2, 5), (1, 7), (2, 5)):
        fleet_feedforward(spec, bucket, torch.empty(M, B, 6, device="meta"))
    assert fleet_feedforward.launches == 3
    assert fleet_feedforward.shapes == {(2, 5, 6): 2, (1, 7, 6): 1}


def test_explicit_dims_relu_matches_pallas():
    kwargs = dict(encoding_dim=(8, 4), decoding_dim=(4, 8),
                  encoding_func=("relu", "relu"), decoding_func=("relu", "relu"))
    jax_spec, spec = _both("feedforward_model", 6, 6, **kwargs)
    bucket = _jax_bucket(jax_spec, 3, 1)
    X = np.random.RandomState(1).rand(3, 16, 6).astype(np.float32)
    expected = pallas_dense.fleet_feedforward_pallas(jax_spec, bucket, X, interpret=True)
    got = fleet_feedforward(spec, _port(bucket), torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


#: specs the wide kernel takes on the card (wider than 32): a 40-tag
#: hourglass and feedforward_model stacks with 64- and 128-wide layers
WIDE_SPECS = {
    "hourglass40": ("feedforward_hourglass", (40,), {}),
    "model_64_128": ("feedforward_model", (24,), dict(encoding_dim=(128, 64), decoding_dim=(64, 128),
                                                       encoding_func=("tanh", "relu"), decoding_func=("tanh", "tanh"))),
    "model_64_relu": ("feedforward_model", (20,), dict(
        encoding_dim=(64,), decoding_dim=(64,), encoding_func=("relu",), decoding_func=("elu",))),
}


@pytest.mark.parametrize("name", WIDE_SPECS)
def test_wide_specs_match_pallas(name):
    factory, args, kwargs = WIDE_SPECS[name]
    jax_spec, spec = _both(factory, *args, **kwargs)
    bucket = _jax_bucket(jax_spec, 2, 7)
    X = np.random.RandomState(7).rand(2, 16, spec.n_features).astype(np.float32)
    expected = pallas_dense.fleet_feedforward_pallas(jax_spec, bucket, X, interpret=True)
    got = fleet_feedforward(spec, _port(bucket), torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_ragged_batch_matches_pallas(monkeypatch):
    """50 rows: the JAX kernel pads to its 16-row blocks and trims."""
    monkeypatch.setattr(pallas_dense, "BLOCK_B", 16)
    jax_spec, spec = _both("feedforward_hourglass", 7)
    bucket = _jax_bucket(jax_spec, 2, 3)
    X = np.random.RandomState(3).rand(2, 50, 7).astype(np.float32)
    expected = pallas_dense.fleet_feedforward_pallas(jax_spec, bucket, X, interpret=True)
    got = fleet_feedforward(spec, _port(bucket), torch.from_numpy(X))
    assert got.shape == (2, 50, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ingest", [False, True], ids=["gather", "gather+ingest"])
def test_gather_matches_jax_serving_program(ingest):
    jax_spec, spec = _both("feedforward_hourglass", 9)
    bucket = _jax_bucket(jax_spec, 5, 4)
    rng = np.random.RandomState(4)
    indices = np.array([3, 0, 3, 4], np.int32)
    X = (rng.rand(4, 21, 9) * 50).astype(np.float32)
    plan = None
    if ingest:
        plan = ((rng.rand(5, 9) / 50).astype(np.float32), (rng.rand(5, 9) - 0.5).astype(np.float32))
    expected = jax_forward_gather(
        jax_spec, bucket, indices, X,
        ingest=None if plan is None else tuple(jax.numpy.asarray(a) for a in plan),
    )
    got = fleet_feedforward(
        spec, _port(bucket), torch.from_numpy(X), indices=indices,
        ingest=None if plan is None else tuple(torch.from_numpy(a) for a in plan),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


#: gather patterns of the narrow kernel's card tests: a member repeats in
#: neighbouring and in distant batch rows
GATHER_PATTERNS = {
    "6": [3, 3, 0, 9, 3, 1],
    "64": [5 if i % 3 == 0 else (i // 2) % 5 * 2 for i in range(64)],
}


@pytest.mark.parametrize("pattern", GATHER_PATTERNS)
@pytest.mark.parametrize("as_tensor", [False, True], ids=["list", "tensor"])
def test_gather_patterns_match_jax_serving_program(pattern, as_tensor):
    jax_spec, spec = _both("feedforward_hourglass", 20)
    bucket = _jax_bucket(jax_spec, 10, 5)
    rng = np.random.RandomState(5)
    indices = np.array(GATHER_PATTERNS[pattern], np.int32)
    X = rng.rand(len(indices), 9, 20).astype(np.float32)
    plan = ((rng.rand(10, 20) * 2).astype(np.float32), (rng.rand(10, 20) - 0.5).astype(np.float32))
    expected = jax_forward_gather(jax_spec, bucket, indices, X, ingest=tuple(jax.numpy.asarray(a) for a in plan))
    got = fleet_feedforward(
        spec, _port(bucket), torch.from_numpy(X),
        indices=torch.from_numpy(indices) if as_tensor else indices.tolist(),
        ingest=tuple(torch.from_numpy(a) for a in plan),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_indices_already_on_the_device_are_not_read_back():
    """An index tensor on X's (non-CPU) device is cast in place, never
    copied to the host: a meta tensor, which has no data, shows it."""
    on_device = torch.tensor([1, 0, 2], dtype=torch.int64, device="meta")
    idx = fleet_dense._device_indices(on_device, 3, 3, torch.device("meta"))
    assert idx.device.type == "meta" and idx.dtype == torch.int32 and tuple(idx.shape) == (3,)
    with pytest.raises(ValueError, match="shape"):
        fleet_dense._device_indices(on_device, 2, 3, torch.device("meta"))
    with pytest.raises(TypeError, match="int32 or int64"):
        fleet_dense._device_indices(on_device.float(), 3, 3, torch.device("meta"))


def test_host_index_tensors_are_still_checked():
    spec = factories.feedforward_hourglass(4)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(0))])
    with pytest.raises(IndexError):
        fleet_feedforward(spec, bucket, torch.zeros(2, 3, 4), indices=torch.tensor([0, 1]))


def test_sass_counts_reads_the_kernel_out_of_a_disassembly():
    """``scripts/sass_counts.py`` counts the opcodes of the named kernel
    only, predicated instructions by their opcode."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "sass_counts.py"
    module_spec = importlib.util.spec_from_file_location("sass_counts", path)
    sass_counts = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(sass_counts)
    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_121fleet_dense_wide_kernelILi64ELi256EEEv4Args",
        "        /*0000*/                   FFMA R1, R2, R3, R4 ;   /* 0x000 */",
        "\t\tFunction : _ZN12_GLOBAL__N_125fleet_dense_narrow_kernelE4Args",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "        /*0010*/                   FFMA R4, R5, R6, R4 ;   /* 0x000 */",
        "        /*0020*/              @!P0 FFMA R4, R5, R7, R4 ;   /* 0x000 */",
        "        /*0030*/                   LDS.128 R8, [R2+0x10] ;   /* 0x000 */",
        "        /*0040*/               @P1 MUFU.EX2 R9, R9 ;   /* 0x000 */",
    ])
    counts = sass_counts.opcode_counts(sass, "fleet_dense_narrow_kernel")
    assert list(counts) == ["_ZN12_GLOBAL__N_125fleet_dense_narrow_kernelE4Args"]
    ops = next(iter(counts.values()))
    assert ops == {"LDC": 1, "FFMA": 2, "LDS.128": 1, "MUFU.EX2": 1}


def test_sass_counts_adds_up_the_tensor_core_families():
    """HMMA and the TF32 conversions are counted by family, whatever their
    suffixes, so the A/B shows the wide kernel's tensor-core path."""
    import collections
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "sass_counts.py"
    module_spec = importlib.util.spec_from_file_location("sass_counts", path)
    sass_counts = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(sass_counts)
    ops = collections.Counter({"HMMA.1688.F32.TF32": 24, "HMMA.16816.F32": 1, "F2FP.TF32.F32.PACK_AB": 3,
                               "FRND.TF32": 2, "F2F.F64.F32": 1, "FFMA": 9})
    assert sass_counts.family_counts(ops) == {"HMMA": 25, "F2FP": 3, "F2F": 1, "FRND": 2}


def test_arguments_are_checked():
    spec = factories.feedforward_hourglass(4)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(0))])
    X = torch.zeros(2, 3, 4)
    with pytest.raises(IndexError):
        fleet_feedforward(spec, bucket, X, indices=[0, 1])
    with pytest.raises(ValueError):
        fleet_feedforward(spec, bucket, X[:1], indices=[0, 0])
    with pytest.raises(ValueError):
        fleet_feedforward(spec, bucket, torch.zeros(1, 3, 5))
    with pytest.raises(TypeError):
        fleet_feedforward(spec, bucket, X[:1].double())
    with pytest.raises(ValueError):
        fleet_feedforward(spec, bucket, X[:1], ingest=(torch.ones(2, 4), torch.zeros(2, 4)))


def test_build_variants_are_libraries_of_their_own():
    """A set of preprocessor defines is a build of its own: its own key and
    its own library file, so the measured variant never loads as K1."""
    source = _build.CSRC / "fleet_dense.cu"
    wide_only = ("FLEET_DENSE_WIDE_ONLY",)
    assert _build.kernel_sources() == [source]
    assert "FLEET_DENSE_WIDE_ONLY" in source.read_text()
    assert _build.library_name(source) == "fleet_dense"
    assert _build.library_name(source, wide_only) == "fleet_dense+FLEET_DENSE_WIDE_ONLY"
    assert _build.library_path(source) != _build.library_path(source, wide_only)
    assert _build.library_path(source).parent == _build.BUILD_DIR
