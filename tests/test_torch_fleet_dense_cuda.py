"""K1 and K2, the fleet dense-stack CUDA kernel and its anomaly-score
epilogue, against their plain versions on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; on a machine without a
card each one skips. The file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch (``tests/conftest.py``
imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_fleet_dense_cuda.py

Tolerance: rtol 1e-5, atol 1e-5, f32 sums taken in another order than
the plain version's ``bmm``. Both of the kernel's paths are covered:
the register-resident one for specs at most 32 wide and the tensor-core
one (3xTF32) for wider specs, up to 512 wide, with weights resident in
shared memory or streamed through a ring of tiles (``WIDE_SPECS``,
``test_wide_plan_*``).
K2's per-row MSE is held to the same tolerance, with ``y`` the input rows
themselves (the store's case), a separate ``y`` as wide as the output or
narrower, and a NaN in ``y``. The narrow kernel's persistent loop has
cases of its own (``LOOP_CASES``): many tiles a member, more tiles than
resident blocks, one member, and gather patterns in which a member
leaves a block's run and comes back.
"""

import threading

import pytest
import torch

from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.nn import init_feedforward
from gordo_tpu_torch.ops.activations import ACTIVATION_NAMES
from gordo_tpu_torch.ops.fleet_dense import (
    fleet_anomaly_scores,
    fleet_anomaly_scores_reference,
    fleet_feedforward,
    fleet_feedforward_reference,
)
from gordo_tpu_torch.parallel.fleet import stack_member_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(device, spec, n, m, b, indices=None, ingest=False, seed=0, defines=()):
    gen = torch.Generator().manual_seed(seed)
    bucket = stack_member_params([init_feedforward(spec, gen) for _ in range(n)], device)
    X = torch.rand(m, b, spec.n_features, generator=gen).to(device)
    plan = None
    if ingest:
        plan = (torch.rand(n, spec.n_features, generator=gen).to(device) * 2,
                torch.rand(n, spec.n_features, generator=gen).to(device) - 0.5)
    launches = fleet_feedforward.launches
    got = fleet_feedforward(spec, bucket, X, indices, plan, defines=defines)
    torch.cuda.synchronize()
    assert fleet_feedforward.launches == launches + 1
    expected = fleet_feedforward_reference(spec, bucket, X, indices, plan)
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_name", ["hourglass", "model"])
def test_kernel_matches_plain_on_card(cuda, spec_name):
    spec = factories.feedforward_hourglass(20) if spec_name == "hourglass" else factories.feedforward_model(20)
    _kernel_vs_plain(cuda, spec, 8, 8, 1008)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [9, 48], ids=["narrow", "wide"])
@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_kernel_activation_on_card(cuda, name, hidden):
    spec = factories.feedforward_model(6, encoding_dim=(hidden,), decoding_dim=(5,),
                                       encoding_func=(name,), decoding_func=("tanh",), out_func=name)
    _kernel_vs_plain(cuda, spec, 3, 3, 37)


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", [20, 40], ids=["narrow", "wide"])
def test_kernel_gather_ingest_ragged_on_card(cuda, n_features):
    _kernel_vs_plain(cuda, factories.feedforward_hourglass(n_features), 10, 6, 301,
                     indices=[3, 3, 0, 9, 3, 1], ingest=True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 50, 129])
def test_kernel_ragged_tiles_on_card(cuda, rows):
    _kernel_vs_plain(cuda, factories.feedforward_hourglass(7), 2, 2, rows)


@pytest.mark.cuda
def test_kernel_chunks_wide_layers_on_card(cuda):
    """A 256x256 layer's weights do not fit beside the row tiles: they
    stream through the wide kernel's ring of weight tiles."""
    spec = factories.feedforward_model(256, encoding_dim=(256,), decoding_dim=(256,),
                                       encoding_func=("relu",), decoding_func=("gelu",))
    _kernel_vs_plain(cuda, spec, 2, 2, 200)


@pytest.mark.cuda
def test_kernel_widest_spec_on_card(cuda):
    spec = factories.feedforward_model(512, encoding_dim=(300,), decoding_dim=(1,),
                                       encoding_func=("tanh",), decoding_func=("softmax",))
    _kernel_vs_plain(cuda, spec, 2, 2, 70)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    too_wide = factories.feedforward_model(513, encoding_dim=(4,), decoding_dim=(4,),
                                           encoding_func=("tanh",), decoding_func=("tanh",))
    bucket = stack_member_params([init_feedforward(too_wide, torch.Generator().manual_seed(0))], cuda)
    with pytest.raises(ValueError, match="kernel"):
        fleet_feedforward(too_wide, bucket, torch.zeros(1, 2, 513, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,indices", [(8, 1008, None), (1, 1008, [5])], ids=["fleet", "gather"])
def test_wide_only_build_matches_plain_on_narrow_spec(cuda, m, b, indices):
    """The build that sends every spec to the wide kernel, which
    chip_smoke.py times against the narrow one, computes the same."""
    _kernel_vs_plain(cuda, factories.feedforward_hourglass(20), 8, m, b, indices=indices,
                     ingest=True, defines=("FLEET_DENSE_WIDE_ONLY",))


@pytest.mark.cuda
def test_launch_count_is_exact_under_threads(cuda):
    """Server request threads launch concurrently; no launch is lost."""
    spec = factories.feedforward_hourglass(7)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(0))], cuda)
    X = torch.rand(1, 16, 7, device=cuda)
    fleet_feedforward(spec, bucket, X)  # build and load before the threads start
    before = fleet_feedforward.launches

    def launch():
        for _ in range(200):
            fleet_feedforward(spec, bucket, X)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    torch.cuda.synchronize()
    assert fleet_feedforward.launches == before + 8 * 200


def _scores_vs_plain(device, spec, n, m, b, indices=None, ingest=False, y="x", seed=0, defines=()):
    """K2 against its plain version; ``y`` is ``"x"`` (X itself), ``"same"``
    (a separate y as wide as the output), ``"narrower"`` (F_y < F_out) or
    ``"nan"`` (a separate y with a NaN)."""
    gen = torch.Generator().manual_seed(seed)
    bucket = stack_member_params([init_feedforward(spec, gen) for _ in range(n)], device)
    X = torch.rand(m, b, spec.n_features, generator=gen).to(device)
    plan = None
    if ingest:
        plan = (torch.rand(n, spec.n_features, generator=gen).to(device) * 2,
                torch.rand(n, spec.n_features, generator=gen).to(device) - 0.5)
    if y == "x":
        target = X
    else:
        width = spec.n_features_out - (3 if y == "narrower" else 0)
        target = torch.rand(m, b, width, generator=gen).to(device)
        if y == "nan":
            target[0, b // 2, 1] = float("nan")
    launches, k1_launches = fleet_anomaly_scores.launches, fleet_feedforward.launches
    recon, mse = fleet_anomaly_scores(spec, bucket, X, target, indices, plan, defines=defines)
    torch.cuda.synchronize()
    assert fleet_anomaly_scores.launches == launches + 1
    assert fleet_feedforward.launches == k1_launches  # K2 counts as K2 alone
    expected_recon, expected_mse = fleet_anomaly_scores_reference(spec, bucket, X, target, indices, plan)
    torch.testing.assert_close(recon, expected_recon, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mse, expected_mse, rtol=1e-5, atol=1e-5, equal_nan=True)
    if y == "nan":
        assert torch.isnan(mse[0, b // 2]) and int(torch.isnan(mse).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same", "narrower", "nan"])
@pytest.mark.parametrize("spec_name", ["hourglass", "model"], ids=["narrow", "wide"])
def test_scores_match_plain_on_card(cuda, spec_name, y):
    spec = factories.feedforward_hourglass(20) if spec_name == "hourglass" else factories.feedforward_model(20)
    _scores_vs_plain(cuda, spec, 8, 8, 1008, ingest=y == "x", y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 50, 129])
@pytest.mark.parametrize("n_features", [7, 40], ids=["narrow", "wide"])
def test_scores_ragged_tiles_on_card(cuda, n_features, rows):
    _scores_vs_plain(cuda, factories.feedforward_hourglass(n_features), 2, 2, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "narrower"])
@pytest.mark.parametrize("n_features", [20, 40], ids=["narrow", "wide"])
def test_scores_gather_ingest_on_card(cuda, n_features, y):
    """Gather indices with repeats; y stays row-aligned with X."""
    _scores_vs_plain(cuda, factories.feedforward_hourglass(n_features), 10, 6, 301,
                     indices=[3, 3, 0, 9, 3, 1], ingest=True, y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "narrower"])
def test_scores_wide_only_build_on_card(cuda, y):
    _scores_vs_plain(cuda, factories.feedforward_hourglass(20), 8, 8, 1008, ingest=True, y=y,
                     defines=("FLEET_DENSE_WIDE_ONLY",))


#: gather patterns in which a member repeats in neighbouring and in distant
#: batch rows, so a persistent block sees its member change and come back
NO_SPLIT = ("FLEET_DENSE_NO_SPLIT",)
GATHER_6 = [3, 3, 0, 9, 3, 1]
GATHER_64 = [5 if i % 3 == 0 else (i // 2) % 5 * 2 for i in range(64)]
#: the narrow kernel's persistent loop, hourglass(20): (N, M, B, indices,
#: ingest); every B leaves a ragged last tile in each member's span
LOOP_CASES = {
    "many_tiles_a_member": (2, 2, 52_560, None, False),
    "more_tiles_than_blocks": (2000, 2000, 144, None, False),
    "one_row": (8, 1, 1, [5], True),
    "one_member": (8, 1, 1008, [5], False),
    "one_member_ragged": (8, 1, 50, [5], True),
    "gather_6": (10, 6, 301, GATHER_6, True),
    "gather_6_tiled": (10, 1200, 144, GATHER_6 * 200, True),
    "gather_64_tiled": (10, 1024, 144, GATHER_64 * 16, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOOP_CASES)
def test_persistent_loop_matches_plain_on_card(cuda, case):
    n, m, b, indices, ingest = LOOP_CASES[case]
    _kernel_vs_plain(cuda, factories.feedforward_hourglass(20), n, m, b, indices=indices, ingest=ingest)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same", "nan"])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_persistent_loop_scores_match_plain_on_card(cuda, case, y):
    n, m, b, indices, ingest = LOOP_CASES[case]
    _scores_vs_plain(cuda, factories.feedforward_hourglass(20), n, m, b, indices=indices, ingest=ingest, y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same", "nan"])
@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_scores_activation_on_card(cuda, name, y):
    spec = factories.feedforward_model(6, encoding_dim=(9,), decoding_dim=(5,),
                                       encoding_func=(name,), decoding_func=("tanh",), out_func=name)
    _scores_vs_plain(cuda, spec, 3, 3, 37, y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "one_member", "one_member_ragged"])
def test_no_split_build_matches_plain_on_card(cuda, case):
    """Few rows share each row among lanes; the build that never does
    (which chip_smoke.py times against) computes the same."""
    n, m, b, indices, ingest = LOOP_CASES[case]
    _kernel_vs_plain(cuda, factories.feedforward_hourglass(20), n, m, b, indices=indices, ingest=ingest,
                     defines=NO_SPLIT)
    _scores_vs_plain(cuda, factories.feedforward_hourglass(20), n, m, b, indices=indices, ingest=ingest,
                     y="nan", defines=NO_SPLIT)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_no_split_build_activation_on_card(cuda, name):
    spec = factories.feedforward_model(6, encoding_dim=(9,), decoding_dim=(5,),
                                       encoding_func=(name,), decoding_func=("tanh",), out_func=name)
    _kernel_vs_plain(cuda, spec, 3, 3, 37, defines=NO_SPLIT)


@pytest.mark.cuda
def test_indices_on_the_card_are_taken_in_place(cuda):
    """A gather index tensor already on the card gives what host indices give."""
    spec = factories.feedforward_hourglass(20)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(i)) for i in range(10)], cuda)
    X = torch.rand(64, 300, 20, generator=torch.Generator().manual_seed(0)).to(cuda)
    on_card = torch.tensor(GATHER_64, dtype=torch.int64, device=cuda)
    got = fleet_feedforward(spec, bucket, X, on_card)
    expected = fleet_feedforward(spec, bucket, X, GATHER_64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, expected, rtol=0, atol=0)


@pytest.mark.cuda
def test_store_scores_launch_k2_on_card(cuda, tmp_path):
    """``fleet_scores`` on the card launches K2 once per spec bucket and
    answers what the CPU store answers."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.estimators import TorchAutoEncoder
    from gordo_tpu_torch.models.nn import params_to_numpy
    from gordo_tpu_torch.server.fleet_store import RevisionFleet

    spec = factories.feedforward_hourglass(6)
    for i in range(3):
        params = params_to_numpy(init_feedforward(spec, torch.Generator().manual_seed(i)))
        serializer.dump(TorchAutoEncoder(spec, params, device="cpu"), str(tmp_path / f"m-{i}"), {"name": f"m-{i}"})
    rng = np.random.RandomState(0)
    inputs = {f"m-{i}": rng.rand(10 + i, 6).astype(np.float32) for i in (2, 0)}
    launches = fleet_anomaly_scores.launches
    scores, errors = RevisionFleet(str(tmp_path), cuda).fleet_scores(inputs)
    assert fleet_anomaly_scores.launches == launches + 1 and not errors
    expected, _ = RevisionFleet(str(tmp_path), torch.device("cpu")).fleet_scores(inputs)
    for name, (recon, mse) in expected.items():
        np.testing.assert_allclose(scores[name][0], recon, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(scores[name][1], mse, rtol=1e-5, atol=1e-5)


# -- the wide kernel (3xTF32 on the tensor cores) ----------------------------


def _wide_plan(spec, m, b):
    """``(resident, rows a tile, warps a slice, smem, blocks an SM, grid)``
    of the wide kernel at this shape, from ``fleet_dense_wide_occupancy``."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    fn = _build.load("fleet_dense").fleet_dense_wide_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    widths = spec.widths()
    dims = (ctypes.c_int * len(widths))(*widths)
    out = [ctypes.c_int() for _ in range(6)]
    assert fn(len(widths) - 1, ctypes.cast(dims, ctypes.c_void_p), m, b, *map(ctypes.byref, out)) == 0
    return tuple(v.value for v in out)


def _model(n, enc, dec, enc_func=None, dec_func=None, out_func="linear"):
    return factories.feedforward_model(
        n, encoding_dim=enc, decoding_dim=dec, encoding_func=enc_func or ("tanh",) * len(enc),
        decoding_func=dec_func or ("tanh",) * len(dec), out_func=out_func)


#: wide specs: odd widths (33, 27, 1, 300), a member that fits in shared
#: memory (resident) and ones that stream
WIDE_SPECS = {
    "odd_33_27_1": lambda: _model(33, (27, 1), (27,), ("tanh", "relu"), ("elu",)),
    "odd_300_27_1_33": lambda: _model(300, (27, 1), (33,), ("relu", "tanh"), ("tanh",)),
    "hourglass40": lambda: factories.feedforward_hourglass(40),
    "model20": lambda: factories.feedforward_model(20),
    "model_64_128": lambda: _model(24, (128, 64), (64, 128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same", "nan"])
@pytest.mark.parametrize("name", WIDE_SPECS)
def test_wide_specs_match_plain_on_card(cuda, name, y):
    spec = WIDE_SPECS[name]()
    _kernel_vs_plain(cuda, spec, 3, 3, 157, ingest=True)
    _scores_vs_plain(cuda, spec, 3, 3, 157, ingest=y == "x", y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hourglass40", "model20"])
@pytest.mark.parametrize("pattern,repeat", [(GATHER_6, 40), (GATHER_64, 2)], ids=["gather_6", "gather_64"])
def test_wide_member_changes_match_plain_on_card(cuda, name, pattern, repeat):
    """Persistent blocks whose member changes and comes back."""
    spec = WIDE_SPECS[name]()
    indices = pattern * repeat
    _kernel_vs_plain(cuda, spec, 10, len(indices), 144, indices=indices, ingest=True)
    _scores_vs_plain(cuda, spec, 10, len(indices), 144, indices=indices, ingest=True, y="x")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 1008])
@pytest.mark.parametrize("name", ["hourglass40", "model20", "odd_300_27_1_33"])
def test_wide_one_member_matches_plain_on_card(cuda, name, rows):
    """M = 1: the served anomaly request, on 16-row tiles."""
    spec = WIDE_SPECS[name]()
    _kernel_vs_plain(cuda, spec, 8, 1, rows, indices=[5], ingest=True)
    _scores_vs_plain(cuda, spec, 8, 1, rows, indices=[5], ingest=True, y="x")
    _scores_vs_plain(cuda, spec, 8, 1, rows, indices=[5], y="nan")


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same", "nan"])
@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_wide_scores_activation_on_card(cuda, name, y):
    spec = factories.feedforward_model(6, encoding_dim=(48,), decoding_dim=(5,),
                                       encoding_func=(name,), decoding_func=("tanh",), out_func=name)
    _scores_vs_plain(cuda, spec, 3, 3, 37, y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "same"])
def test_wide_softmax_rows_on_card(cuda, y):
    """Softmax hidden and output layers: a row reduction over the slice's rows."""
    spec = _model(40, (48, 33), (48,), ("softmax", "tanh"), ("relu",), out_func="softmax")
    _kernel_vs_plain(cuda, spec, 4, 4, 300, ingest=True)
    _scores_vs_plain(cuda, spec, 4, 4, 300, y=y)


@pytest.mark.cuda
@pytest.mark.parametrize("y", ["x", "nan"])
def test_wide_widest_spec_scores_on_card(cuda, y):
    spec = factories.feedforward_model(512, encoding_dim=(300,), decoding_dim=(1,),
                                       encoding_func=("tanh",), decoding_func=("softmax",))
    _scores_vs_plain(cuda, spec, 2, 2, 70, y=y)


@pytest.mark.cuda
def test_wide_plan_keeps_a_fitting_member_resident(cuda):
    """hourglass(40) stays in shared memory on 256-row tiles, one warp a
    slice; feedforward_model streams on 128-row tiles, two warps a slice;
    the 512-wide spec streams on 16-row tiles; a lone served machine gets
    16-row tiles on many SMs."""
    resident, rows, wpr, smem, per_sm, grid = _wide_plan(factories.feedforward_hourglass(40), 64, 1008)
    assert (resident, rows, wpr) == (1, 256, 1) and smem <= 232448 and per_sm >= 1
    assert _wide_plan(factories.feedforward_model(20), 64, 1008)[:3] == (0, 128, 2)
    widest = factories.feedforward_model(512, encoding_dim=(300,), decoding_dim=(1,),
                                         encoding_func=("tanh",), decoding_func=("softmax",))
    assert _wide_plan(widest, 2, 70)[:3] == (0, 16, 16)
    resident, rows, wpr, _, _, grid = _wide_plan(factories.feedforward_hourglass(40), 1, 1008)
    assert (resident, rows, wpr, grid) == (1, 16, 16, 63)
