#!/usr/bin/env python3
"""
Smoke test of gordo_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
``gordo_tpu_torch/ops/csrc`` if they are not built, then:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels (one ``nvcc`` per source, all started together;
   ``[build]`` prints each build's registers, stack and spills);
3. holds K1 (the fleet dense-stack kernel) against its plain PyTorch
   version on the card: feedforward_hourglass(20) at 1000 members x 1008
   rows, feedforward_model(20)'s 256-wide defaults at 64 x 1008, every
   activation on both of the kernel's paths, ragged batches, gather
   indices with repeats, the ingest prologue, layers whose weights stream
   through the wide kernel's ring, odd widths, and the shapes the serving
   path uses;
4. trains the collection it then serves (``[train]``): 64 20-tag machines
   and 8 40-tag ones, each a ``DiffBasedAnomalyDetector`` of a MinMax
   pipeline and a feedforward_hourglass autoencoder (5 epochs, batch 32,
   ``examples/config.yaml``'s settings) on 2000 seeded rows, written as a
   project config in ``examples/config.yaml``'s dialect whose machines
   read CSV files (``FileDataProvider``), normalized to a shard and built
   by the ``build-fleet`` command's function on the card (each machine's
   fetched rows must equal its seeded rows): TimeSeriesSplit(3) cross-validation with
   every fold of every machine of a width in one stacked fit, the folds
   scored by one K1 launch a spec group (checked on the launch counter;
   each forward held against the plain version on its own inputs and
   timed: the 20-tag group's on the narrow kernel, the 40-tag group's on
   the wide one), the final fit, the dump. It prints each phase's wall
   time, steps a second, the CUDA-event time a step and one step's
   device time and the data fetch's time a machine; then it builds 4 of
   the machines again on the CPU from the same shard and holds the card's
   params, thresholds, CV scores and epochs to them. ``[config]`` then
   builds ``examples/config.yaml`` and 16 generated
   ``DiffBasedKFCVAnomalyDetector`` machines (4 weeks of seeded
   ``RandomDataProvider`` readings) in one ``build-fleet`` run: each
   build phase's time, K1 launched once a spec group in CV scoring (the
   KFCV group 80 fold models x ~807 rows), each forward against the
   plain version, 2 KFCV machines against a CPU build, and an anomaly
   request to a KFCV and an example machine on a card app and a CPU app;
5. serves that collection (64 feedforward_hourglass(20) detectors and 8
   feedforward_hourglass(40) ones, a 40-tag bucket which the store sends
   to the wide kernel) through ``build_app`` on a localhost
   ``wsgiref`` thread: three ``/anomaly/prediction`` requests and one
   fleet request for the 64, then one anomaly request to a 40-tag
   machine and one fleet request for the 8 (each 40-tag machine sent its
   own next rows), 1008 rows each; every answer
   must be 200, carry the right column groups, and agree with the same
   app on the CPU; K1's and K2's launch counts over each group of
   requests must be above zero;
6. times K1, its plain version and a cuBLAS ``baddbmm`` chain (the
   library yardstick, used nowhere in the package; also timed with TF32
   allowed, less accurate than the kernel, to show what cuBLAS gives on
   the tensor cores) with CUDA events, beside the card's bound for the
   same work (at the 3xTF32 tensor-core rate, with the CUDA-core f32
   bound beside it); and, at the hourglass(20) shapes, K1 against its
   build with ``FLEET_DENSE_WIDE_ONLY``, which runs them through the wide
   kernel instead of the narrow one (the measurement that keeps two
   kernels in the source).

``[lstm]`` (after ``[config]``) writes 16 LSTM machines as a project
config (``examples/model-configuration.yaml``'s settings, lookback 10,
20 tags, 2000 seeded rows in ``FileDataProvider`` CSVs, 5 epochs, batch
32, TimeSeriesSplit(3)): 8 lstm_hourglass autoencoders (15-10-10-15), 4
lstm_symmetric forecasters (64-32-32-64) and 4 lstm_model autoencoders at
its 256-128-64-64-128-256 defaults, each a ``DiffBasedAnomalyDetector``
over MinMax. It builds them on the card through ``build-fleet`` (every
``model_offset`` 9 or 10, one windowed CV forward a spec group) and prints
the phases, steps a second, and each group's CV step: kernel launches
and kernel time (``torch.profiler``), the device's idle share; builds one
machine an architecture again on the CPU and holds the card's params,
thresholds, CV scores, epochs and offsets to it; serves the collection
with 4 of ``[train]``'s feedforward machines from one app on the card and
one on the CPU: an anomaly request an architecture (999 rows out of an
autoencoder, 998 of a forecaster), a ``/prediction`` (held to an f64
forward if the apps differ) and a fleet request over all 20 machines,
which must launch K2 once, for the feedforward bucket; and ``[lstm
times]`` times the windowed forward at 1 x 1008 and 16 x 1008 rows for
lstm_model and the hourglass beside its bound and a cuDNN
``torch.nn.LSTM`` stack of the same layers (the yardstick, used nowhere
in the package).

``[sequential]`` (after ``[lstm]``) drives the sequential build and the fleet
build's crash recovery. It builds three machines one at a time with
``ModelBuilder`` on the card (machine-000 of ``[train]``, 20 tags, K1's
narrow kernel; compressor-000, 40 tags, the wide one; lstm-hourglass-000
of ``[lstm]``), each fold's ``predict`` one K1 launch (3 a feedforward
machine, 0 for the LSTM, read on the counter; the last fold's forward of
each width held against the plain version on its own params and rows, M
= 1 x 500, and timed), prints each build's times beside the fleet
build's ms a machine, and holds each to a CPU ``ModelBuilder`` build of
the same machine within ``SEQUENTIAL_BUILD_LIMITS``. It runs ``python -m
gordo_tpu_torch build`` in a subprocess as a build pod does
(``MACHINE``, ``OUTPUT_DIR``, ``--print-cv-scores``), serves the artifact
from the card's app, and runs it twice more with ``--model-register-dir``: the second is a cache hit
with the first's ``model.pkl`` bytes. Then the kill drill: ``build-fleet``
of 16 of ``[train]``'s machines in a subprocess with
``GORDO_TPU_FAULTS="process_kill_after_n_machines:*:after=5:kill"`` must
exit 137 with exactly 6 complete artifacts (the site fires after its
machine's artifact landed), ``build-fleet --resume`` must resume those 6
(their ``info.json`` unchanged) and build the other 10 within
``BUILD_LIMITS`` of ``[train]``'s artifacts, and the card's app must list
all 16. The kernel JSON's ``launches_by_path`` has a ``build`` key: the
sequential builds' launches; two of its rows are the fold forwards.

``[routes]`` then drives the rest of the JSON surface on the card's app
over the socket, each answer held to the CPU app's on the same
directories: ``/models``, ``/revisions``, ``/server-version``,
``/expected-models`` and a machine's ``/metadata``; ``/prediction`` for a
20-tag machine (K1's narrow kernel) and a 40-tag one (the wide kernel),
each a K1 launch, then both again pinned (``?revision=``) to a second
revision beside the first (copies of three 20-tag machines and one
40-tag machine, given a smoothing window of a day); a pin to a missing
revision (410); ``?all_columns`` on an anomaly request of the second
revision (14 column groups); ``Accept: text/csv`` (406); ``DELETE`` of
the served revision (409) and of one machine of the second (200), after
which a request pinned to it answers 404. It prints each request's
status and host ms.

K2, the fused anomaly scores (K1 with a per-row MSE epilogue, the same
source), is held the same way: against its plain version on both
kernel paths with ``y`` the input rows (with the ingest prologue), a
separate ``y``, a narrower ``y``, a NaN in ``y``, ragged rows, gather
indices with repeats and the wide-only build (``[kernel]``); the fleet
request must launch it (``[serve]``); and ``[stream]`` drives the
streaming plane over the socket on the same 64 machines with 64-row
watermark windows: one ingest of 1008 rows a machine and three of 64,
the SSE feed and the close, each answer equal to the CPU app's, K2
launched by every flush. ``[times]`` times K2 at six shapes (the wide
kernel's three among them) against its plain version, a ``baddbmm`` chain
plus ``torch.square(out - y).mean(-1)`` in f32 and with TF32, K1 alone at
the same shape, and its bounds.

The narrow kernel's persistent loop has cases of its own, K1 and K2 (y =
X, a separate y, a NaN in y): many tiles a member (2 x 52,560 rows), more
tiles than resident blocks (2000 x 144), one member (1 x 1 and 1 x 1008),
and gather patterns in which a member leaves a block and comes back.
``[occupancy]`` prints the narrow kernel's launch at the hourglass(20)
shapes: lanes a row, shared memory, blocks an SM and grid; and the wide
kernel's at its timed shapes: weights resident or streamed, rows a tile,
warps a 16-row slice, shared memory, blocks an SM and grid. ``[times]``
prints the launch floor (a one-element ``zero_``) beside each served
shape and K1 at the served anomaly shape with its indices already on the
card, so the index copy shows apart. Where M x B rows make fewer tiles
than the card has SMs, the narrow kernel shares each row among lanes;
``[split]`` times that against the build with ``FLEET_DENSE_NO_SPLIT``,
which ``[kernel]`` also holds against the plain version.

It prints one line per phase, then a JSON line with the kernel numbers,
then ``nvidia-smi``'s line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that last line; so does a machine
without CUDA, and a directory without the package.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.abspath(__file__))

#: f32 sums taken in another order (kernel FMA chain vs cuBLAS/CPU BLAS)
RTOL, ATOL = 1e-5, 1e-5
#: where both apps' f32 forwards are themselves beyond ATOL of the exact
#: answer (rows far from what a model was trained on), the card's output may
#: lie at most this many times as far from an f64 forward as the CPU app's
F64_MULTIPLE = 2.0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
#: the fastest f32-accurate rate of the card: TF32 on the tensor cores (495
#: TFLOP/s dense), three products to an f32 one (3xTF32, the wide kernel's)
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3
ROWS = 1008  # one week of 10-minute data
SERVED_MACHINES = 64
#: the 40-tag bucket served beside the 64 20-tag machines: its spec is wider
#: than 32, so the store sends it to the wide kernel
WIDE_MACHINES = 8
WIDE_TAGS = 40
#: the stream phase's watermark and its ingests: 1008 rows a machine, then
#: three of 64; snap_rows cuts 512, 512, 64 and 64 rows a machine
STREAM_WINDOW = 64
STREAM_POSTS = (ROWS, STREAM_WINDOW, STREAM_WINDOW, STREAM_WINDOW)
STREAM_SCORED = (512, 512, 64, 64)
#: [routes]: the served revision's name, a second one beside it, and the
#: smoothing window (a day of 10-minute rows) its detectors are given
REVISION = "1700000000000"
SECOND_REVISION = "1690000000000"
SMOOTH_WINDOW = 144
#: [routes]: what /expected-models lists (a YAML flow list, as deployments write it)
EXPECTED_MODELS = "[machine-000, compressor-000]"
TIMED = 6  # the first cases of kernel_cases(): the full widths and the served shapes
#: the 40-tag anomaly request's kernel shape (the wide kernel, 16-row tiles)
WIDE_ANOMALY = "served anomaly: hourglass40 gather M=1 B=1008 +ingest"
#: the wide kernel's timed shapes, K1 (and K2 with y = X)
WIDE_CASES = ("feedforward_model20 M=64 B=1008", "hourglass40 M=64 B=1008", WIDE_ANOMALY)
#: K1 in the build's CV scoring, by input width: 3 folds of each group's
#: machines x each fold's 500 test rows; the 20-tag group on the narrow
#: kernel, the 40-tag one on the wide kernel (a ragged last row tile)
CV_CASES = {20: "CV fold scoring: hourglass20 M=192 B=500", WIDE_TAGS: "CV fold scoring: hourglass40 M=24 B=500"}
CV_MACHINES = {20: SERVED_MACHINES, WIDE_TAGS: WIDE_MACHINES}
#: the ``[config]`` build's KFCV fold scoring: 16 machines x 5 folds, ~4032 / 5 test rows each
KFCV_CASE = "KFCV fold scoring: hourglass20 M=80"
#: the build of K1 that sends narrow specs through the wide kernel
WIDE_ONLY = ("FLEET_DENSE_WIDE_ONLY",)
#: the build of K1 whose narrow kernel never shares a row among lanes
NO_SPLIT = ("FLEET_DENSE_NO_SPLIT",)
#: the cases in which the narrow kernel shares each row among lanes (fewer
#: tiles than SMs), timed against NO_SPLIT
SPLIT_CASES = (
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
    "one member: hourglass20 gather M=1 B=1008",
    "one row: hourglass20 gather M=1 B=1",
)
#: the hourglass(20) cases that the narrow kernel takes, timed against WIDE_ONLY
NARROW_CASES = (
    "hourglass20 M=1000 B=1008",
    "served fleet: hourglass20 M=64 B=1008 +ingest",
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
)


class SmokeFailure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def phase(name, detail):
    print(f"[{name}] {detail}", flush=True)


# -- phase 1: device ----------------------------------------------------------


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


# -- phase 3: K1 against its plain version ------------------------------------


def make_bucket(spec, n, seed, device):
    import torch

    from gordo_tpu_torch.models.nn import init_feedforward
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    gen = torch.Generator().manual_seed(seed)
    return stack_member_params([init_feedforward(spec, gen) for _ in range(n)], device)


def make_case(spec, n, m, b, indices=None, ingest=False, seed=0):
    import torch

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    bucket = make_bucket(spec, n, seed, device)
    X = torch.rand(m, b, spec.n_features, generator=gen).to(device)
    plan = None
    if ingest:
        plan = (
            (torch.rand(n, spec.n_features, generator=gen) * 2).to(device),
            (torch.rand(n, spec.n_features, generator=gen) - 0.5).to(device),
        )
    return dict(spec=spec, bucket=bucket, X=X, indices=indices, ingest=plan)


def compare(case, defines=()):
    import torch

    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference

    args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
    got = fleet_feedforward(*args, defines=defines)
    torch.cuda.synchronize()
    expected = fleet_feedforward_reference(*args)
    check(got.shape == expected.shape, f"shape {tuple(got.shape)} != {tuple(expected.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    diff = (got - expected).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / expected.abs().clamp_min(1e-6)).max())
    check(
        bool(torch.allclose(got, expected, rtol=RTOL, atol=ATOL)),
        f"kernel disagrees with the plain version: max abs {max_abs}, max rel {max_rel}",
    )
    return max_abs, max_rel


def kernel_cases():
    from gordo_tpu_torch.models.factories import feedforward_hourglass, feedforward_model
    from gordo_tpu_torch.ops.activations import ACTIVATION_NAMES

    hourglass = feedforward_hourglass(20)
    cases = {
        "hourglass20 M=1000 B=1008": make_case(hourglass, 1000, 1000, ROWS),
        "feedforward_model20 M=64 B=1008": make_case(feedforward_model(20), 64, 64, ROWS, seed=1),
        "served fleet: hourglass20 M=64 B=1008 +ingest": make_case(
            hourglass, SERVED_MACHINES, SERVED_MACHINES, ROWS, ingest=True, seed=2
        ),
        "served anomaly: hourglass20 gather M=1 B=1008 +ingest": make_case(
            hourglass, SERVED_MACHINES, 1, ROWS, indices=[17], ingest=True, seed=3
        ),
        # 40 wide: the wide kernel with the member's stack resident (feedforward_model streams it)
        "hourglass40 M=64 B=1008": make_case(feedforward_hourglass(40), 64, 64, ROWS, seed=11),
        WIDE_ANOMALY: make_case(feedforward_hourglass(40), WIDE_MACHINES, 1, ROWS, indices=[5], ingest=True,
                                seed=12),
        "ragged: hourglass7 B=50": make_case(feedforward_hourglass(7), 2, 2, 50, seed=4),
        "ragged: hourglass7 B=129": make_case(feedforward_hourglass(7), 2, 2, 129, seed=4),
        "gather repeats: hourglass20 N=10 M=6 B=301": make_case(
            hourglass, 10, 6, 301, indices=[3, 3, 0, 9, 3, 1], seed=5
        ),
        "ingest: hourglass20 N=10 M=4 B=300": make_case(
            hourglass, 10, 4, 300, indices=[1, 2, 2, 7], ingest=True, seed=6
        ),
        "ingest, wide path: hourglass40 N=10 M=4 B=300": make_case(
            feedforward_hourglass(40), 10, 4, 300, indices=[1, 2, 2, 7], ingest=True, seed=7
        ),
        "chunked 256x256 layer B=200": make_case(
            feedforward_model(256, encoding_dim=(256,), decoding_dim=(256,),
                              encoding_func=("relu",), decoding_func=("gelu",)), 2, 2, 200, seed=8
        ),
        "widest: 512-300-1-512 B=70": make_case(
            feedforward_model(512, encoding_dim=(300,), decoding_dim=(1,),
                              encoding_func=("tanh",), decoding_func=("softmax",)), 2, 2, 70, seed=9
        ),
    }
    # every activation on both kernel paths: a 9-wide (registers) and a
    # 48-wide (shared memory) hidden layer
    for i, name in enumerate(ACTIVATION_NAMES):
        for hidden in (9, 48):
            spec = feedforward_model(
                6, encoding_dim=(hidden,), decoding_dim=(5,),
                encoding_func=(name,), decoding_func=("tanh",), out_func=name,
            )
            cases[f"activation {name}, hidden {hidden}"] = make_case(spec, 3, 3, 37, seed=10 + i)
    # the narrow kernel's persistent loop: every B below leaves a ragged
    # last tile in each member's span
    cases.update({
        "many tiles a member: hourglass20 M=2 B=52560": make_case(hourglass, 2, 2, 52_560, seed=60),
        "more tiles than blocks: hourglass20 M=N=2000 B=144": make_case(hourglass, 2000, 2000, 144, seed=61),
        "one row: hourglass20 gather M=1 B=1": make_case(hourglass, 8, 1, 1, indices=[5], ingest=True, seed=62),
        "one member: hourglass20 gather M=1 B=1008": make_case(hourglass, 8, 1, ROWS, indices=[5], seed=63),
        "member returns: hourglass20 N=10 M=1200 B=144 [3,3,0,9,3,1]": make_case(
            hourglass, 10, 1200, 144, indices=GATHER_6 * 200, ingest=True, seed=64),
        "member returns: hourglass20 N=10 M=1024 B=144 64-long pattern": make_case(
            hourglass, 10, 1024, 144, indices=GATHER_64 * 16, ingest=True, seed=65),
    })
    # the wide kernel: persistent blocks whose member changes (resident and
    # streamed stacks), one row, odd widths
    model = feedforward_model(20)
    cases.update({
        "wide member returns: hourglass40 N=10 M=240 B=144 [3,3,0,9,3,1]": make_case(
            feedforward_hourglass(40), 10, 240, 144, indices=GATHER_6 * 40, ingest=True, seed=70),
        "wide member returns: feedforward_model20 N=10 M=128 B=144 64-long pattern": make_case(
            model, 10, 128, 144, indices=GATHER_64 * 2, ingest=True, seed=71),
        "wide one row: hourglass40 gather M=1 B=1": make_case(
            feedforward_hourglass(40), 8, 1, 1, indices=[5], ingest=True, seed=72),
        "wide one member: feedforward_model20 gather M=1 B=1008": make_case(
            model, 8, 1, ROWS, indices=[5], ingest=True, seed=73),
        "odd widths: 33-27-1-27-33 M=3 B=157": make_case(feedforward_model(
            33, encoding_dim=(27, 1), decoding_dim=(27,), encoding_func=("tanh", "relu"),
            decoding_func=("elu",)), 3, 3, 157, ingest=True, seed=74),
        "odd widths: 300-27-1-33-300 M=3 B=157": make_case(feedforward_model(
            300, encoding_dim=(27, 1), decoding_dim=(33,), encoding_func=("relu", "tanh"),
            decoding_func=("tanh",)), 3, 3, 157, ingest=True, seed=75),
    })
    return cases


#: gather patterns in which a member repeats in neighbouring and in distant
#: batch rows, so a block that walks several rows sees its member change
#: and come back
GATHER_6 = [3, 3, 0, 9, 3, 1]
GATHER_64 = [5 if i % 3 == 0 else (i // 2) % 5 * 2 for i in range(64)]
#: K1 cases that K2 also takes, each with y = X, a separate y and a NaN in y
K2_LOOP_CASES = (
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
    "many tiles a member: hourglass20 M=2 B=52560",
    "more tiles than blocks: hourglass20 M=N=2000 B=144",
    "one row: hourglass20 gather M=1 B=1",
    "one member: hourglass20 gather M=1 B=1008",
    "gather repeats: hourglass20 N=10 M=6 B=301",
    "member returns: hourglass20 N=10 M=1200 B=144 [3,3,0,9,3,1]",
    "member returns: hourglass20 N=10 M=1024 B=144 64-long pattern",
    "wide member returns: hourglass40 N=10 M=240 B=144 [3,3,0,9,3,1]",
    "wide member returns: feedforward_model20 N=10 M=128 B=144 64-long pattern",
    "wide one row: hourglass40 gather M=1 B=1",
    "wide one member: feedforward_model20 gather M=1 B=1008",
    "odd widths: 33-27-1-27-33 M=3 B=157",
    "odd widths: 300-27-1-33-300 M=3 B=157",
)


def scores_case(case, y="x", seed=0):
    """A K1 case with targets for K2: ``y`` is ``"x"`` (X itself, the
    store's case), ``"same"`` (a separate y as wide as the output),
    ``"narrower"`` (3 columns fewer) or ``"nan"`` (a separate y with one
    NaN)."""
    import torch

    X = case["X"]
    if y == "x":
        return dict(case, y=X)
    M, B, _ = X.shape
    width = case["spec"].n_features_out - (3 if y == "narrower" else 0)
    target = torch.rand(M, B, width, generator=torch.Generator().manual_seed(seed + 2)).to(X.device)
    if y == "nan":
        target[0, B // 2, 1] = float("nan")
    return dict(case, y=target)


def compare_scores(case, defines=()):
    """K2 against its plain version: ``(max abs, max rel)`` over the
    reconstruction and the mse (NaN where the plain version has NaN)."""
    import torch

    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_anomaly_scores_reference

    args = (case["spec"], case["bucket"], case["X"], case["y"], case["indices"], case["ingest"])
    recon, mse = fleet_anomaly_scores(*args, defines=defines)
    torch.cuda.synchronize()
    expected_recon, expected_mse = fleet_anomaly_scores_reference(*args)
    check(recon.shape == expected_recon.shape and mse.shape == expected_mse.shape, "K2 output shapes")
    check(bool((torch.isnan(mse) == torch.isnan(expected_mse)).all()), "K2's NaN rows differ from the plain version's")
    worst = (0.0, 0.0)
    for got, expected in ((recon, expected_recon), (mse, expected_mse)):
        keep = ~torch.isnan(expected)
        got, expected = got[keep], expected[keep]
        if not expected.numel():  # one row, and its target has the NaN
            continue
        diff = (got - expected).abs()
        check(bool(torch.allclose(got, expected, rtol=RTOL, atol=ATOL)),
              f"K2 disagrees with the plain version: max abs {float(diff.max())}")
        worst = max(worst, (float(diff.max()), float((diff / expected.abs().clamp_min(1e-6)).max())))
    return worst


def k2_cases(cases):
    """K2's cases, on K1's buckets and rows where the shapes are the same."""
    from gordo_tpu_torch.models.factories import feedforward_hourglass

    served = cases["served fleet: hourglass20 M=64 B=1008 +ingest"]
    flush = dict(served, X=served["X"][:, :512].contiguous())
    k2 = {
        "K2 hourglass20 M=1000 B=1008 y=X": scores_case(cases["hourglass20 M=1000 B=1008"]),
        "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest": scores_case(flush),
        "K2 feedforward_model20 M=64 B=1008 y=X": scores_case(cases["feedforward_model20 M=64 B=1008"]),
        "K2 served fleet: hourglass20 M=64 B=1008 y=X +ingest": scores_case(served),
        "K2 hourglass40 M=64 B=1008 y=X": scores_case(cases["hourglass40 M=64 B=1008"]),
        f"K2 {WIDE_ANOMALY} y=X": scores_case(cases[WIDE_ANOMALY]),
    }
    for path, name in (("narrow", "served fleet: hourglass20 M=64 B=1008 +ingest"),
                       ("wide", "feedforward_model20 M=64 B=1008")):
        for y in ("same", "narrower", "nan"):
            k2[f"K2 {path}: {name.split(': ')[-1]} y={y}"] = scores_case(cases[name], y, seed=20)
    for path, ragged, gathered in (("narrow", 7, 20), ("wide", 40, 40)):
        for rows in (1, 50, 129):
            k2[f"K2 ragged {path}: hourglass{ragged} B={rows}"] = scores_case(
                make_case(feedforward_hourglass(ragged), 2, 2, rows, seed=30 + rows))
        gather = make_case(feedforward_hourglass(gathered), 10, 6, 301, indices=[3, 3, 0, 9, 3, 1],
                           ingest=True, seed=40)
        k2[f"K2 gather repeats {path}: hourglass{gathered} N=10 M=6 B=301 y=X +ingest"] = scores_case(gather)
        k2[f"K2 gather repeats {path}: hourglass{gathered} N=10 M=6 B=301 y=narrower"] = scores_case(
            gather, "narrower", seed=41)
    activations = [name for name in cases if name.startswith("activation")]
    for name in (*K2_LOOP_CASES, *activations):
        for y in ("x", "same", "nan"):
            k2[f"K2 {name} y={y}"] = scores_case(cases[name], y, seed=50)
    return k2


#: K2's cases that also go through the wide-only build
K2_WIDE_ONLY = (
    "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest",
    "K2 narrow: hourglass20 M=64 B=1008 +ingest y=narrower",
)


# -- phase 4: serving ------------------------------------------------------------


def sensor_data(seed, rows, n_tags):
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(rows)[:, None]
    phase_ = rng.uniform(0, 2 * np.pi, n_tags)
    level = rng.uniform(20, 80, n_tags)
    return level + 5 * np.sin(2 * np.pi * t / 144 + phase_) + rng.standard_normal((rows, n_tags))


#: the served collection's detector, as ``examples/config.yaml`` defines it
DEFINITION = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.estimators.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 5, "batch_size": 32}},
    ]}}}}
DETECTOR_PATH = "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"
KFCV_DETECTOR = "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector"
TRAIN_ROWS = 2000
TRAIN_START = datetime(2020, 1, 1, tzinfo=timezone.utc)
#: the generated KFCV project of ``[config]``: machines, and its data's first day
KFCV_MACHINES = 16
KFCV_START = datetime(2020, 2, 1, tzinfo=timezone.utc)
#: the build phases ``[train]`` and ``[config]`` print, in order
BUILD_PHASES = ("plan", "data_fetch", "stage", "cv_train", "cv_predict", "cv_score", "cv_finalize", "final_fit",
                "assemble", "dump")
#: the 40-tag compressors' sensor_data seeds start here (the 20-tag machines' at 0)
WIDE_SEED = 500
#: machines built again on the CPU from the same seeds, 2 of each width
CPU_CHECK = ("machine-000", "machine-001", "compressor-000", "compressor-001")
#: the card's build against the CPU's, TF32 off: f32 sums in other orders
#: (cuBLAS, the CPU's BLAS) through 640 Adam steps a machine. Each limit
#: lies between the sound build's reading and a planted fault's
#: (``scripts/build_tolerance.py`` on an H100; sound / TF32 on / one row
#: swapped between batches in the last epoch): params max abs 1.8e-7 /
#: 4.0e-6 / 9.1e-6; thresholds max rel 3.0e-7 / 4.0e-7 / 3.5e-5; CV
#: scores max |d| / (1 + |cpu|) 2.7e-6 / 2.9e-6 / 2.2e-4. The sound
#: readings repeat to the last digit from run to run at these shapes.
BUILD_PARAM_ATOL = 1e-6
BUILD_THRESHOLD_RTOL = 3e-6
BUILD_SCORE_TOL = 2e-5
BUILD_LIMITS = (BUILD_PARAM_ATOL, BUILD_THRESHOLD_RTOL, BUILD_SCORE_TOL)
#: the same check for the [lstm] build (params, thresholds, CV scores):
#: the recurrence carries the f32 differences through 10 steps a window
#: and 2 layers' more products; ``scripts/build_tolerance.py lstm`` reads
#: the sound build against its planted faults
LSTM_BUILD_LIMITS = (1e-5, 3e-6, 2e-5)


def served_machines():
    """The served collection's machines (``machine_rows``) as fleet-build
    machines of ``DEFINITION`` holding their rows as arrays, the same rows
    ``[train]`` fetches from its project config (``scripts/build_tolerance.py``
    builds them)."""
    from gordo_tpu_torch.machine import Machine

    index = [TRAIN_START + timedelta(minutes=10 * r) for r in range(TRAIN_ROWS)]
    return [
        Machine.from_config({"name": name, "model": DEFINITION, "dataset": {"tag_list": tags, "resolution": "10min"}},
                            "smoke", data=(values, None), index=index)
        for name, tags, values in machine_rows()
    ]


def build_summary(model, metadata):
    """What the card's build is held to the CPU's on: final params,
    thresholds, CV scores, epochs run and the model offset (``metadata`` is
    a machine's ``metadata.json`` tree, or the machine itself)."""
    import numpy as np

    if not isinstance(metadata, dict):
        metadata = metadata.to_dict()
    meta = metadata["metadata"]["build_metadata"]["model"]
    return {
        "params": {k: {n: t.detach().cpu().numpy() for n, t in layer.items()}
                   for k, layer in model.base_estimator.estimator.params_.items()},
        "thresholds": np.append(model.feature_thresholds_, model.aggregate_threshold_),
        "scores": meta["cross_validation"]["scores"],
        "epochs_run": meta["training"]["epochs_run"],
        "offset": meta["model_offset"],
    }


def compare_builds(card, cpu, limits=BUILD_LIMITS):
    """The card's build against the CPU's: the largest differences,
    ``[params abs, thresholds rel, scores |d| / (1 + |cpu|)]``, and what
    lies beyond the stated limits, ran another number of epochs or has
    another model offset (empty when the builds agree)."""
    import numpy as np

    param_atol, threshold_rtol, score_tol = limits
    worst, faults = [0.0, 0.0, 0.0], []
    for name, want in cpu.items():
        got = card[name]
        if got["epochs_run"] != want["epochs_run"]:
            faults.append(f"{name}: epochs run {got['epochs_run']} vs {want['epochs_run']}")
        if got["offset"] != want["offset"]:
            faults.append(f"{name}: model_offset {got['offset']} vs {want['offset']}")
        for key, layer in want["params"].items():
            for leaf, value in layer.items():
                diff = float(np.abs(got["params"][key][leaf] - value).max())
                if not diff <= param_atol:
                    faults.append(f"{name} {key}/{leaf}: params {diff} apart")
                worst[0] = max(worst[0], diff)
        rel = float((np.abs(got["thresholds"] - want["thresholds"]) / np.abs(want["thresholds"])).max())
        if not rel <= threshold_rtol:
            faults.append(f"{name}: thresholds {rel} apart (relative)")
        worst[1] = max(worst[1], rel)
        if list(got["scores"]) != list(want["scores"]):
            faults.append(f"{name}: CV score keys differ")
            continue
        for key, folds in want["scores"].items():
            values = np.array(list(folds.values()))
            have = np.array(list(got["scores"][key].values()))
            diff = float((np.abs(have - values) / (1 + np.abs(values))).max())
            if not diff <= score_tol:
                faults.append(f"{name} {key}: {diff} apart")
            worst[2] = max(worst[2], diff)
    return worst, faults


def build_summaries(machines, device, random=None):
    """``{name: build_summary}`` of ``machines`` built with
    ``FleetBuilder`` on ``device``, and the build's seconds."""
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    t0 = time.perf_counter()
    builder = FleetBuilder(machines, device=device, random=random)
    results = builder.build()
    check(not builder.build_errors, f"build errors: {builder.build_errors}")
    return {machine.name: build_summary(model, machine) for model, machine in results}, time.perf_counter() - t0


def yaml_block(value, indent=0):
    """``value`` (dicts, lists, strings, numbers) as block YAML, the way a
    project config is written by hand; the port reads it back with its
    own reader."""
    pad = " " * indent
    if isinstance(value, dict):
        lines = []
        for key, item in value.items():
            if isinstance(item, (dict, list)) and item:
                lines.append(f"{pad}{key}:\n{yaml_block(item, indent + 2)}")
            else:
                lines.append(f"{pad}{key}: {yaml_block(item)}")
        return "\n".join(lines)
    if isinstance(value, list):
        if not value:
            return "[]"
        lines = []
        for item in value:
            body = yaml_block(item, indent + 2).lstrip(" ") if isinstance(item, (dict, list)) else yaml_block(item)
            lines.append(f"{pad}- {body}")
        return "\n".join(lines)
    return str(value)


def machine_rows():
    """The served collection: (name, tags, sensor_data rows) of
    SERVED_MACHINES 20-tag machines and WIDE_MACHINES 40-tag compressors."""
    machines = [(f"machine-{i:03d}", 20, i) for i in range(SERVED_MACHINES)]
    machines += [(f"compressor-{i:03d}", WIDE_TAGS, WIDE_SEED + i) for i in range(WIDE_MACHINES)]
    return [(name, tag_list(n_tags), sensor_data(seed, TRAIN_ROWS, n_tags)) for name, n_tags, seed in machines]


def write_project(directory, machines=None, models=None, project="smoke"):
    """A collection as a project config in ``examples/config.yaml``'s
    dialect (a CRD document, ``globals.model`` a ``|`` block holding
    ``DEFINITION``, or each machine's own ``model`` block from ``models``),
    each machine's dataset a ``FileDataProvider`` CSV of its rows
    (``machines``: ``(name, tags, rows)``, default the served collection's
    ``machine_rows``) at 10-minute stamps from TRAIN_START, floats with 17
    significant digits so they read back exactly, and the half-open window
    ``[TRAIN_START, TRAIN_START + TRAIN_ROWS x 10 min)`` holding all of
    them. Returns the config's path and ``{name: rows}``."""
    stamps = [(TRAIN_START + timedelta(minutes=10 * r)).isoformat() for r in range(TRAIN_ROWS)]
    end = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
    entries, rows = [], {}
    for name, tags, values in machine_rows() if machines is None else machines:
        path = os.path.join(directory, f"{name}.csv")
        with open(path, "w") as f:
            f.write(",".join(["time", *tags]) + "\n")
            for stamp, row in zip(stamps, values):
                f.write(stamp + "," + ",".join(f"{v:.17g}" for v in row) + "\n")
        dataset = yaml_block({
            "data_provider": {"type": "FileDataProvider", "path": path, "timestamp_column": "time"},
            "tag_list": "[" + ", ".join(tags) + "]",
            "train_start_date": TRAIN_START.isoformat(),
            "train_end_date": end,
        }, 10)
        model = "" if models is None else f"        model: |\n{yaml_block(models[name], 10)}\n"
        entries.append(f"      - name: {name}\n        dataset: |\n{dataset}\n{model}")
        rows[name] = values
    config = (
        f"apiVersion: equinor.com/v1\nkind: Gordo\nmetadata:\n  name: {project}\nspec:\n  config:\n    machines:\n"
        + "".join(entries)
        + ("    globals:\n      model: |\n" + yaml_block(DEFINITION, 8) + "\n" if models is None else "")
    )
    config_path = os.path.join(directory, f"{project}.yaml")
    with open(config_path, "w") as f:
        f.write(config)
    return config_path, rows


@contextlib.contextmanager
def captured_build():
    """During a build: each CV scoring forward (``predict_bucket``) with the
    K1 launches it made, and each machine's fetched rows."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.parallel.fleet import FleetTrainer
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    forwards, fetched = [], {}
    predict, stage = FleetTrainer.predict_bucket, FleetBuilder._stage_arrays

    def captured_predict(self, spec, stacked, X):
        before = fleet_feedforward.launches
        out = predict(self, spec, stacked, X)
        forwards.append((spec, stacked, X, fleet_feedforward.launches - before))
        return out

    def captured_stage(plan):
        fetched[plan.machine.name] = plan.X
        return stage(plan)

    FleetTrainer.predict_bucket = captured_predict
    FleetBuilder._stage_arrays = staticmethod(captured_stage)
    try:
        yield forwards, fetched
    finally:
        FleetTrainer.predict_bucket = predict
        FleetBuilder._stage_arrays = staticmethod(stage)


def as_case(spec, stacked, X):
    """A CV scoring forward's inputs as a K1 case on the card."""
    import torch

    bucket = {k: {n: torch.as_tensor(t).cuda() for n, t in layer.items()} for k, layer in stacked.items()}
    return dict(spec=spec, bucket=bucket, X=torch.from_numpy(X).cuda(), indices=None, ingest=None)


def build_phases(builder):
    seconds = builder.phase_seconds
    return ", ".join(f"{name} {seconds[name]:.3f} s" for name in BUILD_PHASES)


def fit_rates(builder):
    fits = builder.trainer.fits
    steps = sum(f["steps"] for f in fits)
    fit_s = sum(f["seconds"] for f in fits)
    event_ms = sum(f["event_ms"] for f in fits)
    return fits, steps, fit_s, event_ms


def train_phase(work_dir, directory):
    """Build the served collection on the card from its project config:
    the config written to ``work_dir``, normalized to a shard, built by the
    ``build-fleet`` command's function into ``directory``; each machine's
    fetched rows must equal its ``sensor_data`` rows; a CPU build of
    CPU_CHECK from the same shard is held against the card's; one training
    step timed. Returns the two lists of names, the kernel launches of the
    build, each CV scoring forward as a K1 case on the card with the K1
    launches it made, by input width, and the build's ms a machine."""
    import numpy as np
    import torch

    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    check(torch.backends.cuda.matmul.allow_tf32 is False and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: training must run in full f32")
    t0 = time.perf_counter()
    config_path, rows = write_project(work_dir)
    shard = os.path.join(work_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    phase("train", f"project config of {len(rows)} machines (CRD document, FileDataProvider CSVs of {TRAIN_ROWS} "
          f"rows) written and normalized to a shard in {time.perf_counter() - t0:.2f} s")
    with captured_build() as (forwards, fetched):
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    check(sorted(fetched) == sorted(rows), "build-fleet fetched other machines")
    unequal = [name for name, X in fetched.items() if not np.array_equal(X, rows[name])]
    check(not unequal, f"fetched rows differ from sensor_data for {unequal[:5]}")
    check(len(forwards) == 2 and launches["K1"] == 2 and all(n == 1 for *_, n in forwards),
          f"CV scoring launched K1 {[n for *_, n in forwards]} times for {len(forwards)} spec groups, "
          f"not once a group")
    cv_cases = {X.shape[-1]: (as_case(spec, stacked, X), n) for spec, stacked, X, n in forwards}
    seconds = builder.phase_seconds
    fits, steps, fit_s, event_ms = fit_rates(builder)
    phase("train", f"build-fleet of {len(fetched)} machines ({SERVED_MACHINES} x 20 tags, {WIDE_MACHINES} x "
          f"{WIDE_TAGS}; hourglass, 5 epochs, batch 32, TimeSeriesSplit(3)) on the card in {wall:.2f} s: "
          f"{build_phases(builder)}; data_fetch {1e3 * seconds['data_fetch'] / len(fetched):.2f} ms a machine "
          f"(CSV read and 10-minute resampling on the host); every machine's fetched X equal to its sensor_data rows")
    phase("train", f"{len(fits)} stacked fits, members {[f['members'] for f in fits]}, {steps} optimizer steps in "
          f"{fit_s:.3f} s: {steps / fit_s:.1f} steps a second, {1e3 * fit_s / steps:.3f} ms a step on the host "
          f"clock, {event_ms / steps:.3f} ms a step between CUDA events; "
          f"K1 launches {launches['K1']} (one per spec group), K2 {launches['K2']}")
    device_ms = step_device_ms(make_step(20, 3 * SERVED_MACHINES))
    phase("train", f"one training step of the 20-tag CV bucket ({3 * SERVED_MACHINES} members x 32 rows) "
          f"with the host's enqueue hidden: {device_ms!r} ms of device time; the steps above take "
          f"{event_ms / steps:.3f} ms between events: the device idles ~{1 - device_ms * steps / event_ms:.0%} "
          f"of a step")

    from gordo_tpu_torch import serializer

    card = {}
    for name in CPU_CHECK:
        model = serializer.load(os.path.join(directory, name), "cpu")
        card[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in CPU_CHECK], "cpu")
    worst, faults = compare_builds(card, cpu)
    check(not faults, "card build disagrees with the CPU's: " + "; ".join(faults[:5]))
    phase("train", f"card build against a CPU build of {', '.join(CPU_CHECK)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds "
          f"max rel {worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) {worst[2]:.3e} "
          f"(limit {BUILD_SCORE_TOL}), epochs run equal")
    names = sorted(n for n in fetched if n.startswith("machine-"))
    wide_names = sorted(n for n in fetched if n.startswith("compressor-"))
    return names, wide_names, launches, cv_cases, 1e3 * wall / len(fetched)


def kfcv_project(directory):
    """The generated KFCV project: KFCV_MACHINES machines of 20 tags, each
    a ``DiffBasedKFCVAnomalyDetector`` (window 144, ``smm``) over MinMax +
    feedforward_hourglass (5 epochs, batch 32) on ``RandomDataProvider``
    readings (3000-4000 a tag) over 4 weeks from KFCV_START at 10 minutes;
    written as a CRD config, its path returned."""
    definition = {KFCV_DETECTOR: {"window": 144, "smoothing_method": "smm", **DEFINITION[DETECTOR_PATH]}}
    entries = []
    for i in range(KFCV_MACHINES):
        name = f"kfcv-{i:03d}"
        dataset = yaml_block({
            "data_provider": {"type": "RandomDataProvider", "min_size": 3000, "max_size": 4000},
            "tag_list": "[" + ", ".join(f"{name}-tag-{j:02d}" for j in range(20)) + "]",
            "resolution": "10min",
            "train_start_date": KFCV_START.isoformat(),
            "train_end_date": (KFCV_START + timedelta(weeks=4)).isoformat(),
        }, 10)
        entries.append(f"      - name: {name}\n        dataset: |\n{dataset}\n")
    config = (
        "apiVersion: equinor.com/v1\nkind: Gordo\nmetadata:\n  name: kfcv\nspec:\n  config:\n    machines:\n"
        + "".join(entries) + "    globals:\n      model: |\n" + yaml_block(definition, 8) + "\n"
    )
    path = os.path.join(directory, "kfcv.yaml")
    with open(path, "w") as f:
        f.write(config)
    return path


def config_phase(work_dir):
    """``examples/config.yaml`` and the generated KFCV project, built by one
    ``build-fleet`` run on the card into a fresh directory: K1 launched once
    a spec group in CV scoring, each forward held to the plain version; 2
    KFCV machines built again on the CPU from the same shard and held to the
    card's build; a card app and a CPU app over the directory answer
    alike. Returns K1's and K2's launches, and the KFCV forward as a case
    with its launches and its distance from the plain version."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    directory = os.path.join(work_dir, "config-build", REVISION)
    documents = [json.loads(normalize(path, "smoke-config"))
                 for path in (os.path.join(HERE, "examples", "config.yaml"), kfcv_project(work_dir))]
    shard = os.path.join(work_dir, "config-shard.json")
    with open(shard, "w") as f:
        json.dump({"machines": [m for document in documents for m in document["machines"]]}, f)
    with captured_build() as (forwards, fetched):
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        build_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    groups = {(spec, X.shape[-1]) for spec, _, X, _ in forwards}
    check(build_launches["K1"] == len(forwards) == len(groups) == 2 and all(n == 1 for *_, n in forwards),
          f"CV scoring launched K1 {build_launches['K1']} times for {len(groups)} spec groups "
          f"({len(forwards)} forwards)")
    fits, steps, fit_s, _ = fit_rates(builder)
    rows = {name: len(X) for name, X in fetched.items()}
    phase("config", f"build-fleet of examples/config.yaml (3 machines, 3 tags) and {KFCV_MACHINES} KFCV machines "
          f"(20 tags, window 144 smm, KFold(5)) on the card in {wall:.2f} s: {build_phases(builder)}; "
          f"data_fetch {1e3 * builder.phase_seconds['data_fetch'] / len(rows):.2f} ms a machine; {steps} optimizer "
          f"steps in {fit_s:.3f} s, {steps / fit_s:.1f} steps a second; rows a machine {sorted(set(rows.values()))}; "
          f"K1 launches in CV scoring {build_launches['K1']} for {len(groups)} spec groups")
    kfcv = [i for i, (_, _, X, _) in enumerate(forwards) if X.shape[-1] == 20]
    check(len(kfcv) == 1 and forwards[kfcv[0]][2].shape[0] == 5 * KFCV_MACHINES, "the KFCV forward's members")
    cases = [as_case(spec, stacked, X) for spec, stacked, X, _ in forwards]
    errors = [compare(case) for case in cases]
    phase("config", "each CV scoring forward against the plain version on its own inputs: "
          + "; ".join(f"{tuple(c['X'].shape)} max abs {e[0]:.3e}" for c, e in zip(cases, errors))
          + f" (rtol {RTOL}, atol {ATOL})")

    cpu_names = [f"kfcv-{i:03d}" for i in range(2)]
    card_summaries = {}
    for name in cpu_names:
        model = serializer.load(os.path.join(directory, name), "cpu")
        card_summaries[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in cpu_names], "cpu")
    worst, faults = compare_builds(card_summaries, cpu)
    phase("config", f"card KFCV build against a CPU build of {', '.join(cpu_names)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds "
          f"max rel {worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) "
          f"{worst[2]:.3e} (limit {BUILD_SCORE_TOL}), epochs run equal")
    check(not faults, "card KFCV build disagrees with the CPU's: " + "; ".join(faults[:5]))

    apps = build_app(directory, device="cuda"), build_app(directory, device="cpu")
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for name in ("kfcv-000", "ct-23-0003"):
        X = fetched[name][-ROWS:]
        meta = serializer.load_metadata(os.path.join(directory, name))
        tags = [t["name"] for t in meta["metadata"]["build_metadata"]["dataset"]["dataset_meta"]["tag_list"]]
        start = datetime(2020, 3, 1, tzinfo=timezone.utc)
        keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(len(X))]
        frame = {tag: dict(zip(keys, X[:, j].tolist())) for j, tag in enumerate(tags)}
        path = f"/gordo/v0/smoke-config/{name}/anomaly/prediction"
        t0 = time.perf_counter()
        status, body = wsgi_post(apps[0], path, {"X": frame, "y": frame})
        ms = 1e3 * (time.perf_counter() - t0)
        cpu_status, cpu_body = wsgi_post(apps[1], path, {"X": frame, "y": frame})
        check(status == cpu_status == 200, f"{path} answered {status} (CPU app {cpu_status})")
        check(list(body["data"]) == ANOMALY_GROUPS, f"{path}: anomaly groups {list(body['data'])}")
        diff = same_json(cpu_body["data"], body["data"])
        phase("config", f"POST {path} ({len(X)} of its own rows): 200 in {ms:.1f} ms on the card's app, "
              f"max abs diff vs the CPU app {diff:.3e} (rtol {RTOL}, atol {ATOL})")
    launches = {k: build_launches[k] + n for k, n in (("K1", fleet_feedforward.launches),
                                                       ("K2", fleet_anomaly_scores.launches))}
    check(launches["K1"] >= build_launches["K1"] + 1, "the [config] anomaly requests never launched K1")
    return launches, cases[kfcv[0]], forwards[kfcv[0]][3], errors[kfcv[0]]


# -- phase: the LSTM family ----------------------------------------------------------------

#: the [lstm] collection, ``examples/model-configuration.yaml``'s LSTM settings:
#: (name prefix, machines, estimator path, estimator kwargs, model offset)
LSTM_AE = "gordo_tpu.models.estimators.JaxLSTMAutoEncoder"
LSTM_FORECAST = "gordo_tpu.models.estimators.JaxLSTMForecast"
LSTM_GROUPS = (
    ("lstm-hourglass", 8, LSTM_AE,
     {"kind": "lstm_hourglass", "lookback_window": 10, "compression_factor": 0.5, "encoding_layers": 2}, 9),
    ("lstm-forecast", 4, LSTM_FORECAST,
     {"kind": "lstm_symmetric", "lookback_window": 10, "dims": [64, 32], "funcs": ["tanh", "tanh"]}, 10),
    ("lstm-model", 4, LSTM_AE, {"kind": "lstm_model", "lookback_window": 10}, 9),
)
#: the examples' 5 epochs cut to 2: at 5 the card's build took 47 s and
#: the CPU check 91 s (one H100 machine), far past the phase's minute
LSTM_EPOCHS = 2
#: the LSTM machines' sensor_data seeds start here
LSTM_SEED = 700
#: feedforward machines of the [train] collection served beside the LSTMs
LSTM_FF_MACHINES = ("machine-000", "machine-001", "machine-002", "machine-003")
#: machines built again on the CPU, one an architecture
LSTM_CPU_CHECK = ("lstm-hourglass-000", "lstm-forecast-000", "lstm-model-000")


def lstm_machines():
    """The [lstm] collection: ``(name, tags, rows)`` of each machine and
    ``{name: definition}`` (a detector over MinMax and the group's LSTM
    estimator, 5 epochs, batch 32)."""
    machines, models, seed = [], {}, LSTM_SEED
    for prefix, count, path, kwargs, _ in LSTM_GROUPS:
        for i in range(count):
            name = f"{prefix}-{i:03d}"
            machines.append((name, tag_list(20), sensor_data(seed, TRAIN_ROWS, 20)))
            estimator = {path: {**kwargs, "epochs": LSTM_EPOCHS, "batch_size": 32}}
            models[name] = {DETECTOR_PATH: {"base_estimator": {"sklearn.pipeline.Pipeline": {
                "steps": ["sklearn.preprocessing.MinMaxScaler", estimator]}}}}
            seed += 1
    return machines, models


def lstm_offsets():
    """``{name: model offset}`` of the [lstm] collection."""
    return {f"{prefix}-{i:03d}": offset for prefix, count, _, _, offset in LSTM_GROUPS for i in range(count)}


def lstm_own_frame(name, seed):
    """An LSTM machine's next ROWS rows (``sensor_data`` from its seed past
    the TRAIN_ROWS it trained on), with request_frame's excursion."""
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (TRAIN_ROWS + r))).isoformat() for r in range(ROWS)]
    values = sensor_data(seed, TRAIN_ROWS + ROWS, 20)[TRAIN_ROWS:]
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(20))}


def lstm_f64_forward(model, X):
    """An LSTM detector's output for raw rows ``X[rows, tags]`` in float64,
    written out apart from the port's code: its ingest plan, every window,
    the recurrence of each layer with the f32 weights widened, the head."""
    import numpy as np
    import torch
    from gordo_tpu_torch.models.estimators import find_estimator
    from gordo_tpu_torch.ops.activations import resolve_activation
    from gordo_tpu_torch.server.fleet_store import member_plan

    estimator = find_estimator(model)
    spec, params = estimator.spec_, estimator.params_
    scale, offset = member_plan(model, X.shape[1])
    x = torch.from_numpy(np.asarray(X, np.float64) * scale.astype(np.float64) + offset.astype(np.float64))
    count = len(x) - estimator.offset
    h_seq = torch.stack([x[t:t + count] for t in range(spec.lookback_window)])  # [T, windows, F]
    for key, activation in spec.layer_names()[:-1]:
        act = resolve_activation(activation)
        Wx, Wh, b = (params[key][n].cpu().double() for n in ("Wx", "Wh", "b"))
        H = Wh.shape[0]
        h = torch.zeros(count, H, dtype=torch.float64)
        c = torch.zeros_like(h)
        hidden = []
        for t in range(spec.lookback_window):
            g = h_seq[t] @ Wx + b + h @ Wh
            c = torch.sigmoid(g[:, H:2 * H]) * c + torch.sigmoid(g[:, :H]) * act(g[:, 2 * H:3 * H])
            h = torch.sigmoid(g[:, 3 * H:]) * act(c)
            hidden.append(h)
        h_seq = torch.stack(hidden)
    head = params["out"]
    return resolve_activation(spec.out_activation)(h_seq[-1] @ head["W"].cpu().double() + head["b"].cpu().double()).numpy()


def lstm_step(spec, members):
    """One optimizer step of an LSTM CV bucket on the card, as a closure:
    ``members`` members of ``spec``, Adam, 32 windows each gathered from a
    seeded 2000-row series (``WindowedFit``'s own gather)."""
    import torch

    from gordo_tpu_torch.models.training import FitConfig, TorchRandom, WindowedFit
    from gordo_tpu_torch.ops.windows import gather_windows
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    fit = WindowedFit(spec, FitConfig(epochs=LSTM_EPOCHS, batch_size=32, shuffle=False))
    params = stack_member_params([TorchRandom().init_params(spec, s) for s in range(members)], "cuda")
    for leaf in fit.leaves(params):
        leaf.requires_grad_(True)
    state = fit.optimizer.init(fit.leaves(params))
    gen = torch.Generator().manual_seed(0)
    series = torch.rand(members, TRAIN_ROWS, spec.n_features, generator=gen).cuda()
    targets = series[:, spec.lookback_window - 1:]
    starts = torch.arange(32, device="cuda").repeat(members, 1) * 7
    wb = torch.ones(members, 32, device="cuda")
    active = torch.ones(members, dtype=torch.bool, device="cuda")

    def step():
        xb = gather_windows(series, starts, spec.lookback_window)
        yb = torch.take_along_dim(targets, starts[..., None], dim=1)
        return fit.train_step(params, state, xb, yb, wb, active)

    return step


def profile_step(step, steps=5):
    """``(kernel launches, kernel ms)`` a step, from ``torch.profiler`` over
    ``steps`` steps (CPU and CUDA activities)."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    kernel_us = sum(e.self_device_time_total for e in averages if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches / steps, kernel_us / steps / 1e3


@contextlib.contextmanager
def captured_windowed():
    """During a build: each windowed CV forward (``predict_windowed_bucket``)
    as ``(spec, members, windows a member)``."""
    from gordo_tpu_torch.parallel.fleet import FleetTrainer

    forwards, predict = [], FleetTrainer.predict_windowed_bucket

    def captured(self, spec, stacked, series, order, batch_size=256):
        forwards.append((spec, order.shape[0], order.shape[1]))
        return predict(self, spec, stacked, series, order, batch_size)

    FleetTrainer.predict_windowed_bucket = captured
    try:
        yield forwards
    finally:
        FleetTrainer.predict_windowed_bucket = predict


def lstm_case(spec, members, seed=0):
    """A windowed forward on the card: ``members`` members of ``spec``
    (``TorchRandom`` params) over seeded ROWS-row series, every window."""
    import torch

    from gordo_tpu_torch.models.training import TorchRandom
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    params = stack_member_params([TorchRandom().init_params(spec, seed + s) for s in range(members)], "cuda")
    gen = torch.Generator().manual_seed(seed)
    series = torch.rand(members, ROWS, spec.n_features, generator=gen).cuda()
    count = ROWS - spec.lookback_window + 1
    order = torch.arange(count, device="cuda").repeat(members, 1)
    return dict(spec=spec, params=params, series=series, order=order)


def lstm_bound(case):
    """(bound_ms, bound_by) of a windowed forward: the series read once,
    the params once, the output written once, at HBM rate; 2 flops a
    multiply-add of the products (the gates' elementwise work left out)
    at the CUDA-core f32 rate."""
    spec, series, order = case["spec"], case["series"], case["order"]
    M, windows = order.shape
    widths = spec.widths()
    macs = sum(spec.lookback_window * (widths[i] * 4 * widths[i + 1] + widths[i + 1] * 4 * widths[i + 1])
               for i in range(len(spec.dims)))
    macs += widths[-2] * widths[-1]
    params = sum(t[0].numel() for layer in case["params"].values() for t in layer.values())
    byte_count = 4 * (series.numel() + M * params + M * windows * spec.n_features_out)
    byte_ms = byte_count / PEAK_BYTES_PER_S * 1e3
    flop_ms = 2 * M * windows * macs / PEAK_F32_FLOP_PER_S * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def cudnn_yardstick(case):
    """The same windowed forward through cuDNN (``torch.nn.LSTM``, one
    module a layer and member, tanh only, ``bias_hh`` zero, a ``Linear``
    head), as a closure, and its output for the first member. Used here
    only, as the measure of what a library recurrence gives."""
    import torch

    from gordo_tpu_torch.ops.windows import gather_windows

    spec, params = case["spec"], case["params"]
    check(set(spec.activations) == {"tanh"} and spec.out_activation == "linear", "the yardstick is tanh only")
    members = []
    for m in range(case["order"].shape[0]):
        layers = []
        for key, _ in spec.layer_names()[:-1]:
            Wx, Wh, b = (params[key][n][m] for n in ("Wx", "Wh", "b"))
            lstm = torch.nn.LSTM(Wx.shape[0], Wh.shape[0], batch_first=False).cuda()
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(Wx.T)
                lstm.weight_hh_l0.copy_(Wh.T)
                lstm.bias_ih_l0.copy_(b)
                lstm.bias_hh_l0.zero_()
            layers.append(lstm)
        head = torch.nn.Linear(*params["out"]["W"][m].shape).cuda()
        with torch.no_grad():
            head.weight.copy_(params["out"]["W"][m].T)
            head.bias.copy_(params["out"]["b"][m])
        members.append((layers, head))

    @torch.no_grad()
    def run():
        outs = []
        for start in range(0, case["order"].shape[1], 256):
            x = gather_windows(case["series"], case["order"][:, start:start + 256], spec.lookback_window)
            batch = []
            for m, (layers, head) in enumerate(members):
                h = x[m]  # [T, B, F]
                for lstm in layers:
                    h = lstm(h)[0]
                batch.append(head(h[-1]))
            outs.append(torch.stack(batch))
        return torch.cat(outs, dim=1)

    return run


def host_step_ms(step, steps=10):
    """Host ms a ``step`` over ``steps`` steps, ending in a synchronise."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def lstm_build(work_dir, card):
    """Write the [lstm] collection as a project config and build it on the
    card through ``build-fleet``: the phases, steps a second, every
    ``model_offset``, one windowed CV forward a spec group; each group's CV
    step profiled (launches, device time, idle share); one machine an
    architecture built again on the CPU from the same shard and held to
    the card's. Returns the build's directory, its seeds by machine and
    K1's and K2's launches and the build's ms a machine."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    t0 = time.perf_counter()
    machines, models = lstm_machines()
    lstm_dir = os.path.join(work_dir, "lstm")
    os.makedirs(lstm_dir)
    config_path, rows = write_project(lstm_dir, machines, models, project="smoke-lstm")
    shard = os.path.join(lstm_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke-lstm"))
    phase("lstm", f"project config of {len(rows)} LSTM machines (8 lstm_hourglass autoencoders 15-10-10-15, 4 "
          f"lstm_symmetric forecasters 64-32-32-64, 4 lstm_model autoencoders 256-128-64-64-128-256; lookback 10, "
          f"20 tags, {TRAIN_ROWS} rows, {LSTM_EPOCHS} epochs (cut from the examples' 5 to keep the phase near a "
          f"minute), batch 32, TimeSeriesSplit(3)) written and normalized in {time.perf_counter() - t0:.2f} s")
    directory = os.path.join(work_dir, "lstm-build", REVISION)
    with captured_windowed() as forwards:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    check(len(forwards) == len(LSTM_GROUPS), f"CV scoring ran {len(forwards)} windowed forwards for "
          f"{len(LSTM_GROUPS)} spec groups")
    for name, offset in lstm_offsets().items():
        got = serializer.load_metadata(os.path.join(directory, name))["metadata"]["build_metadata"]["model"]
        check(got["model_offset"] == offset, f"{name}: model_offset {got['model_offset']}, not {offset}")
    fits, steps, fit_s, event_ms = fit_rates(builder)
    phase("lstm", f"build-fleet of {len(rows)} machines on the card in {wall:.2f} s: {build_phases(builder)}; "
          f"model_offset 9 (autoencoders) and 10 (forecasters) in every metadata.json; CV scoring "
          f"{len(forwards)} windowed forwards, members x windows {[(m, w) for _, m, w in forwards]}; "
          f"K1 launches {launches['K1']}, K2 {launches['K2']}; {card}")
    phase("lstm", f"{len(fits)} windowed fits, members {[f['members'] for f in fits]}, steps "
          f"{[f['steps'] for f in fits]} ({steps} in all, the all-padding batches left out) in {fit_s:.3f} s: "
          f"{steps / fit_s:.1f} steps a second, {1e3 * fit_s / steps:.3f} ms a step on the host clock, "
          f"{event_ms / steps:.3f} ms between CUDA events; per fit ms a step between events "
          f"{[round(f['event_ms'] / f['steps'], 3) for f in fits]}; {card}")
    for (prefix, count, *_), fit in zip(LSTM_GROUPS, fits):
        spec = serializer.load(os.path.join(directory, f"{prefix}-000"), "cpu").base_estimator.estimator.spec_
        step = lstm_step(spec, 3 * count)
        device_ms = step_device_ms(step)
        host_ms = host_step_ms(step)
        step_launches, kernel_ms = profile_step(step)
        fit_ms = fit["event_ms"] / fit["steps"]
        # a step of more launches than the card's queue holds lets the host pace
        # the sleep-hidden timing too: the profiler's kernel time is the device's busy time
        phase("lstm", f"one CV step of {prefix} ({3 * count} members x 32 windows, dims {spec.dims}): "
              f"{step_launches:.0f} kernel launches, {kernel_ms:.3f} ms of kernel time in the profiler "
              f"({device_ms!r} ms between events with the host's enqueue hidden behind a device sleep), "
              f"{host_ms:.3f} ms on the host clock (its CV fit {fit_ms:.3f} ms a step between events): the "
              f"device idles ~{1 - kernel_ms / fit_ms:.0%} of a step; {card}")

    card_summaries = {name: build_summary(serializer.load(os.path.join(directory, name), "cpu"),
                                          serializer.load_metadata(os.path.join(directory, name)))
                      for name in LSTM_CPU_CHECK}
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in LSTM_CPU_CHECK], "cpu")
    worst, faults = compare_builds(card_summaries, cpu, LSTM_BUILD_LIMITS)
    phase("lstm", f"card build against a CPU build of {', '.join(LSTM_CPU_CHECK)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {LSTM_BUILD_LIMITS[0]}), thresholds "
          f"max rel {worst[1]:.3e} (limit {LSTM_BUILD_LIMITS[1]}), CV scores max |d| / (1 + |cpu|) "
          f"{worst[2]:.3e} (limit {LSTM_BUILD_LIMITS[2]}), epochs run and model_offset equal")
    check(not faults, "card LSTM build disagrees with the CPU's: " + "; ".join(faults[:5]))
    seeds = {name: LSTM_SEED + i for i, (name, _, _) in enumerate(machines)}
    return directory, seeds, launches, 1e3 * wall / len(rows)


def f64_held(cpu_data, data, reference, path):
    """Both apps' answers (``data`` trees) held to ``reference`` (the same
    answer made from an f64 forward): each group's numeric cells no
    further from it on the card than F64_MULTIPLE times the CPU app's
    distance (or ATOL), everything else equal. Returns ``{group: (card's
    distance, CPU app's)}`` and the largest abs difference of the two."""
    import math

    def cells(tree, prefix=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from cells(value, prefix + (key,))
            else:
                yield prefix + (key,), value

    want, have, exact = dict(cells(cpu_data)), dict(cells(data)), dict(cells(reference))
    check(list(have) == list(want) == list(exact), f"{path}: the answers' keys differ")
    distances, diff = {}, 0.0
    for key, value in want.items():
        group = key[:-2] if len(key) > 2 else key[:1]  # a column's group: (machine,) group for the fleet route
        if all(isinstance(v, float) for v in (value, have[key], exact[key])) and math.isfinite(exact[key]):
            card_err, cpu_err = distances.get(group, (0.0, 0.0))
            distances[group] = (max(card_err, abs(have[key] - exact[key])), max(cpu_err, abs(value - exact[key])))
            diff = max(diff, abs(have[key] - value))
        else:
            check(have[key] == value, f"{path}: {'/'.join(key)}: {have[key]!r} vs {value!r}")
    for group, (card_err, cpu_err) in distances.items():
        limit = F64_MULTIPLE * max(cpu_err, ATOL)
        check(card_err <= limit, f"{path}: {'/'.join(group)} {card_err:.3e} from the f64 answer, the CPU app's "
              f"{cpu_err:.3e} (limit {limit:.3e})")
    return distances, diff


def lstm_serve(directory, collection, seeds, card):
    """An app over the [lstm] collection and LSTM_FF_MACHINES of [train]'s,
    on the card and on the CPU: one anomaly request an LSTM architecture
    (999 rows out of an autoencoder, 998 of a forecaster), one
    ``/prediction`` and one fleet request over all 20 machines (K2 once, for
    the feedforward bucket), each machine sent its own next ROWS rows.
    Each answer equals the CPU app's within RTOL/ATOL, or else both are held
    to the answer an f64 forward gives (``f64_held``). Returns K1's and K2's
    launches."""
    import shutil

    from gordo_tpu_torch.models.spec import LSTMSpec
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app, wire

    for name in LSTM_FF_MACHINES:
        shutil.copytree(os.path.join(collection, name), os.path.join(directory, name))
    apps = build_app(directory, device="cuda"), build_app(directory, device="cpu")
    check(len(apps[0].store.fleet().warm()) == len(seeds) + len(LSTM_FF_MACHINES), "not every model loaded")
    offsets = lstm_offsets()
    frames = {name: lstm_own_frame(name, seed) for name, seed in seeds.items()}
    frames.update({name: own_frame(name, 20) for name in LSTM_FF_MACHINES})
    prefix = "/gordo/v0/smoke-lstm"
    fleet = apps[1].store.fleet()

    def exact(name):
        """``(resolution, X, f64 output)`` of a machine's request rows."""
        resolution = fleet.resolution(name)
        X = wire.verify_frame(wire.decode_frame(frames[name]), resolution.tag_names)
        forward = lstm_f64_forward if isinstance(fleet.loaded_specs()[name], LSTMSpec) else f64_forward
        return resolution, X, forward(resolution.model, X.values)

    def hold(path, body, cpu_body, reference):
        """``(max abs diff, note)``: within RTOL/ATOL of the CPU app's, or
        held to ``reference()``."""
        try:
            return same_json(cpu_body["data"], body["data"]), "within rtol/atol of the CPU app's"
        except SmokeFailure as exc:
            distances, diff = f64_held(cpu_body["data"], body["data"], reference(), path)
            worst = max(distances.values())
            return diff, (
                f"beyond rtol/atol of the CPU app's ({exc}), so both held to the f64 answer: furthest group "
                f"card {worst[0]:.3e}, CPU app {worst[1]:.3e} (limit {F64_MULTIPLE} x max(CPU app's, ATOL))")

    def both(path, payload):
        t0 = time.perf_counter()
        status, body = wsgi_post(apps[0], prefix + path, payload)
        ms = (time.perf_counter() - t0) * 1e3
        cpu_status, cpu_body = wsgi_post(apps[1], prefix + path, payload)
        check(status == cpu_status == 200, f"{path} answered {status} (CPU app {cpu_status})")
        return body, cpu_body, ms

    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for group, *_ in LSTM_GROUPS:
        name = f"{group}-001"
        path = f"/{name}/anomaly/prediction"
        k1 = fleet_feedforward.launches
        body, cpu_body, ms = both(path, {"X": frames[name], "y": frames[name]})
        check(list(body["data"]) == ANOMALY_GROUPS, f"{path}: anomaly groups {list(body['data'])}")
        lengths = {len(col) for group_ in body["data"].values() for col in group_.values()}
        check(lengths == {ROWS - offsets[name]}, f"{path}: {lengths} rows, not {ROWS - offsets[name]}")

        def reference(name=name):
            resolution, X, output = exact(name)
            table = wire.anomaly_table(resolution.model, X, X, output, frequency=resolution.frequency,
                                       thresholds=resolution.feature_thresholds,
                                       aggregate=resolution.aggregate_threshold)
            return json.loads(wire.encode_response(table))["data"]

        diff, note = hold(path, body, cpu_body, reference)
        phase("lstm", f"POST {path} ({ROWS} rows): 200 in {ms:.1f} ms on the card's app, {ROWS - offsets[name]} "
              f"rows out, K1 launches {fleet_feedforward.launches - k1}, max abs diff vs the CPU app {diff:.3e}: "
              f"{note}; {card}")
    name = "lstm-forecast-002"
    path = f"/{name}/prediction"
    body, cpu_body, ms = both(path, {"X": frames[name]})
    check(len(body["data"]["model-output"]["tag-00"]) == ROWS - offsets[name], f"{path}: rows")

    def reference():
        resolution, X, output = exact(name)
        table = wire.prediction_table(X, output, resolution.tag_names, resolution.target_names)
        return json.loads(wire.encode_response(table))["data"]

    diff, note = hold(path, body, cpu_body, reference)
    phase("lstm", f"POST {path} ({ROWS} rows): 200 in {ms:.1f} ms, {ROWS - offsets[name]} rows out, max abs "
          f"diff vs the CPU app {diff:.3e}: {note}; {card}")
    k2 = fleet_anomaly_scores.launches
    body, cpu_body, ms = both("/prediction/fleet", {"X": frames})
    k2 = fleet_anomaly_scores.launches - k2
    check(k2 == 1, f"the fleet request launched K2 {k2} times, not once for the feedforward bucket")
    check(sorted(body["data"]) == sorted(frames) and "errors" not in body, "the fleet request's machines")
    for name, entry in body["data"].items():
        check(len(entry["total-anomaly-unscaled"]) == ROWS - offsets.get(name, 0), f"fleet entry {name}: rows")

    def reference():
        entries = {}
        for name in body["data"]:
            _, X, output = exact(name)
            tail = X.values[len(X.values) - len(output):]
            keys = wire.index_wire_keys(X.index[len(X.index) - len(output):])
            entries[name] = json.loads(wire.encode_lean_entry(keys, output, ((output - tail) ** 2).mean(-1)))
        return entries

    diff, note = hold("/prediction/fleet", body, cpu_body, reference)
    phase("lstm", f"POST /prediction/fleet ({len(frames)} machines x {ROWS} rows: {len(seeds)} LSTM in "
          f"{len(LSTM_GROUPS)} buckets, {len(LSTM_FF_MACHINES)} feedforward): 200 in {ms:.1f} ms on the card's "
          f"app, K2 launches {k2}, max abs diff vs the CPU app {diff:.3e}: {note}; {card}")
    return {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}


def lstm_times(card):
    """The windowed forward (``forward_lstm_windows``, 256 windows a batch)
    at the anomaly shape (1 x ROWS) and the fleet shape (16 x ROWS) for
    lstm_model's defaults and the hourglass, with CUDA events, beside its
    bound and a cuDNN ``torch.nn.LSTM`` stack of the same layers. Returns
    ``{shape: (ms, bound_ms, bound_by, cudnn_ms, max abs from cuDNN)}``."""
    from gordo_tpu_torch.models.factories import lstm_hourglass, lstm_model
    from gordo_tpu_torch.models.nn import forward_lstm_windows

    out = {}
    for label, spec in (("lstm_model(20)", lstm_model(20, lookback_window=10)),
                        ("lstm_hourglass(20)", lstm_hourglass(20, lookback_window=10, encoding_layers=2))):
        for members in (1, 16):
            case = lstm_case(spec, members)
            args = (spec, case["params"], case["series"], case["order"])
            ms = cuda_ms(lambda: forward_lstm_windows(*args), iters=5, warmup=2)
            yardstick = cudnn_yardstick(case)
            cudnn_ms = cuda_ms(yardstick, iters=5, warmup=2)
            err = float((yardstick() - forward_lstm_windows(*args)).abs().max())
            bound_ms, bound_by = lstm_bound(case)
            shape = f"{label} M={members} B={ROWS}"
            out[shape] = (ms, bound_ms, bound_by, cudnn_ms, err)
            phase("lstm times", f"windowed forward {shape} ({case['order'].shape[1]} windows a member): "
                  f"{ms!r} ms, bound {bound_ms!r} ms ({bound_by}, CUDA-core f32; {bound_ms / ms:.2%} of it), "
                  f"cuDNN nn.LSTM stack {cudnn_ms!r} ms (max abs {err:.3e} from the port's); {card}")
    return out


def make_step(n_features, members):
    """One optimizer step of the build's stacked fit on the card, as a
    closure: ``members`` feedforward_hourglass(``n_features``) members,
    Adam, 32 seeded rows each."""
    import torch

    from gordo_tpu_torch.models.factories import feedforward_hourglass
    from gordo_tpu_torch.models.training import FitConfig, StackedFit, TorchRandom
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    spec = feedforward_hourglass(n_features)
    fit = StackedFit(spec, FitConfig(epochs=5, batch_size=32))
    params = stack_member_params([TorchRandom().init_params(spec, s) for s in range(members)], "cuda")
    for leaf in fit.leaves(params):
        leaf.requires_grad_(True)
    state = fit.optimizer.init(fit.leaves(params))
    gen = torch.Generator().manual_seed(0)
    xb = torch.rand(members, 32, n_features, generator=gen).cuda()
    wb = torch.ones(members, 32, device="cuda")
    active = torch.ones(members, dtype=torch.bool, device="cuda")
    return lambda: fit.train_step(params, state, xb, xb, wb, active)


def step_device_ms(step):
    """Device ms of one ``step`` (from :func:`make_step`): CUDA events
    around one step queued behind a device sleep, the median of 5. One
    step at a time: a step is ~350 launches, and more than the card's
    launch queue holds would let the host pace the device again."""
    import statistics

    return statistics.median(cuda_ms(step, iters=1) for _ in range(5))


def tag_list(n_tags):
    """The 20-tag machines' tags, or the 40-tag compressors' own."""
    return [f"tag-{j:02d}" for j in range(n_tags)] if n_tags == 20 else [f"ctag-{j:02d}" for j in range(n_tags)]


def request_frame(seed, rows=ROWS, first_row=0, n_tags=20):
    """``rows`` 10-minute rows of ``n_tags`` tags from row ``first_row`` on."""
    start = datetime(2020, 3, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (first_row + r))).isoformat() for r in range(rows)]
    values = sensor_data(10_000 + seed, rows, n_tags)
    values[rows // 2:rows // 2 + 6, 3] += 25.0  # an excursion to flag
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(n_tags))}


def own_frame(name, n_tags):
    """A machine's next ROWS rows, as a deployment sends them: its own
    sensor stream (``sensor_data`` from its build seed) past the
    TRAIN_ROWS it was trained on, with request_frame's excursion."""
    seed = int(name.rsplit("-", 1)[1]) + (WIDE_SEED if name.startswith("compressor-") else 0)
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (TRAIN_ROWS + r))).isoformat() for r in range(ROWS)]
    values = sensor_data(seed, TRAIN_ROWS + ROWS, n_tags)[TRAIN_ROWS:]
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(n_tags))}


def post(url, payload):
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(request, timeout=300) as response:
        body = response.read()
        status = response.status
    return status, json.loads(body), (time.perf_counter() - t0) * 1e3


def wsgi_call(app, method, path, payload=None, query="", headers=None):
    """One request straight into a WSGI app, without a socket: ``(status,
    body bytes)``."""
    import io
    from wsgiref.util import setup_testing_defaults

    body = b"" if payload is None else json.dumps(payload).encode()
    environ = {}
    setup_testing_defaults(environ)
    environ.update(
        REQUEST_METHOD=method, PATH_INFO=path, QUERY_STRING=query, CONTENT_LENGTH=str(len(body)),
        CONTENT_TYPE="application/json", **{"wsgi.input": io.BytesIO(body)},
        **{"HTTP_" + k.upper().replace("-", "_"): v for k, v in (headers or {}).items()},
    )
    status = []
    chunks = app(environ, lambda s, h: status.append(int(s.split()[0])))
    try:
        return status[0], b"".join(chunks)
    finally:
        getattr(chunks, "close", lambda: None)()


def wsgi_post(app, path, payload):
    """One POST straight into a WSGI app: ``(status, parsed JSON)``."""
    status, body = wsgi_call(app, "POST", path, payload)
    return status, json.loads(body)


def http_call(url, method="GET"):
    """A bodiless request over the socket: ``(status, body bytes)``."""
    with urllib.request.urlopen(urllib.request.Request(url, method=method), timeout=300) as response:
        return response.status, response.read()


def http_request(url, method, payload=None, headers=None):
    """One request over the socket, any status: ``(status, body bytes,
    revision header, host ms)``."""
    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            status, body, revision = response.status, response.read(), response.headers.get("revision")
    except urllib.error.HTTPError as error:
        status, body, revision = error.code, error.read(), error.headers.get("revision")
    return status, body, revision, (time.perf_counter() - t0) * 1e3


def same_json(expected, got, path="data"):
    """Nested objects equal: same keys in the same order, numbers within
    RTOL/ATOL, everything else exact. Returns the largest abs difference."""
    if isinstance(expected, dict):
        check(isinstance(got, dict) and list(got) == list(expected), f"keys differ at {path}")
        return max([same_json(expected[k], got[k], f"{path}/{k}") for k in expected] or [0.0])
    if isinstance(expected, float) and isinstance(got, float):
        diff = abs(got - expected)
        check(diff <= ATOL + RTOL * abs(expected), f"{path}: {got} vs {expected}")
        return diff
    check(got == expected, f"{path}: {got!r} vs {expected!r}")
    return 0.0


ANOMALY_GROUPS = [
    "start", "end", "model-input", "model-output", "tag-anomaly-scaled", "total-anomaly-scaled",
    "tag-anomaly-unscaled", "total-anomaly-unscaled", "anomaly-confidence", "total-anomaly-confidence",
]


def serve_phase(base, names, wide_names, cpu_app):
    """Three anomaly requests and one fleet request to the 20-tag machines
    of the card's app at ``base``, then one anomaly request to a 40-tag
    machine and one fleet request for the 40-tag bucket (the wide kernel),
    each answer held against the CPU app's; returns the launches of K1 (the
    anomaly route) and K2 (the fleet route) the first four made, and those
    the two 40-tag requests made."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    anomaly_names = [names[0], names[17], names[63]]
    requests = [(f"/{n}/anomaly/prediction", {"X": request_frame(i), "y": request_frame(i)})
                for i, n in enumerate(anomaly_names)]
    fleet_payload = {"X": {n: request_frame(100 + i) for i, n in enumerate(names)}}
    requests.append(("/prediction/fleet", fleet_payload))
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    answers = [post(base + path, payload) for path, payload in requests]
    launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(launches["K1"] >= 1, "the served anomaly requests never launched K1")
    check(launches["K2"] >= 1, "the served fleet request never launched K2")
    max_diff = check_answers(requests, answers, names, 20, cpu_app)
    phase("serve", f"{len(requests)} requests, K1 launches {launches['K1']}, K2 launches {launches['K2']}, "
          f"max abs diff vs the CPU app {max_diff:.3e} (rtol {RTOL}, atol {ATOL})")

    # the 40-tag bucket: its spec is wider than 32, so only the wide kernel runs. Each machine is sent
    # its own next rows: another machine's levels put both apps' f32 forwards beyond ATOL of the exact
    # answer, so they would agree only by chance ([routes] holds one such request to an f64 forward)
    frame = own_frame(wide_names[5], WIDE_TAGS)
    wide_requests = [
        (f"/{wide_names[5]}/anomaly/prediction", {"X": frame, "y": frame}),
        ("/prediction/fleet", {"X": {n: own_frame(n, WIDE_TAGS) for n in wide_names}}),
    ]
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    wide_answers = [post(base + path, payload) for path, payload in wide_requests]
    wide_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(wide_launches["K1"] >= 1, "the 40-tag anomaly request never launched K1's wide kernel")
    check(wide_launches["K2"] >= 1, "the 40-tag fleet request never launched K2's wide kernel")
    wide_diff = check_answers(wide_requests, wide_answers, wide_names, WIDE_TAGS, cpu_app)
    phase("serve", f"{len(wide_requests)} 40-tag requests (hourglass40, the wide kernel), "
          f"K1 launches {wide_launches['K1']}, K2 launches {wide_launches['K2']}, "
          f"max abs diff vs the CPU app {wide_diff:.3e} (rtol {RTOL}, atol {ATOL})")
    return launches, wide_launches


def check_answers(requests, answers, names, n_tags, cpu_app):
    """Each answer 200, of the right shape, equal to the CPU app's; returns
    the largest abs difference."""
    import math

    max_diff = 0.0
    for (path, payload), (status, body, ms) in zip(requests, answers):
        check(status == 200, f"{path} answered {status}")
        cpu_status, cpu_body = wsgi_post(cpu_app, "/gordo/v0/smoke" + path, payload)
        check(cpu_status == 200, f"CPU app answered {cpu_status} on {path}")
        data = body["data"]
        if path.endswith("anomaly/prediction"):
            check(list(data) == ANOMALY_GROUPS, f"anomaly groups {list(data)}")
            check(all(len(col) == ROWS for group in data.values() for col in group.values()), "row count")
            check(all(isinstance(v, float) and math.isfinite(v)
                      for g in ANOMALY_GROUPS[2:] for col in data[g].values() for v in col.values()),
                  "non-finite anomaly values")
            flagged = max(data["total-anomaly-confidence"]["total-anomaly-confidence"].values())
            phase("serve", f"POST {path}: 200 in {ms:.1f} ms, peak total-anomaly-confidence {flagged:.3f}")
        else:
            check(sorted(data) == names, "fleet answered other machines")
            check(all(list(entry) == ["model-output", "total-anomaly-unscaled"] for entry in data.values()),
                  "fleet entry groups")
            check(all(len(entry["model-output"]) == n_tags and len(entry["total-anomaly-unscaled"]) == ROWS
                      for entry in data.values()), "fleet entry shape")
            phase("serve", f"POST {path} ({len(names)} machines x {ROWS} rows): 200 in {ms:.1f} ms")
        max_diff = max(max_diff, same_json(cpu_body["data"], data))
    return max_diff


def sse_events(body):
    """``(id, event, data)`` of each event frame of an SSE body; heartbeat
    comments left out."""
    frames = []
    for frame in body.decode().split("\n\n"):
        if frame and not frame.startswith(":"):
            fields = dict(line.split(": ", 1) for line in frame.split("\n"))
            frames.append((fields.get("id"), fields["event"], json.loads(fields["data"])))
    return frames


def stream_phase(base, names, cpu_app):
    """The streaming plane on the card's app at ``base`` and on the CPU app:
    the same ingests, acks and events; every flush one K2 launch. Returns
    K2's launches, the ingest latencies and the rows scored a second."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    stream = "/stream/smoke"
    local = "/gordo/v0/smoke" + stream  # the same path on the CPU app
    first_row, latencies, scored = 0, [], 0
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for step, rows in enumerate(STREAM_POSTS):
        payload = {"X": {n: request_frame(300 + 10 * step + i, rows, first_row) for i, n in enumerate(names)}}
        first_row += rows
        status, ack, ms = post(base + stream + "/ingest", payload)
        cpu_status, cpu_ack = wsgi_post(cpu_app, local + "/ingest", payload)
        check(status == cpu_status == 200, f"stream ingest answered {status} (CPU app {cpu_status})")
        same_json(cpu_ack, ack)
        check(ack["scored"] == {n: STREAM_SCORED[step] for n in names} and not ack["errors"],
              f"ingest {step} scored {ack['scored']} with errors {ack['errors']}")
        latencies.append(ms)
        scored += sum(ack["scored"].values())
        phase("stream", f"ingest {step}: {len(names)} machines x {rows} rows, scored {STREAM_SCORED[step]} a machine, "
              f"200 in {ms:.1f} ms")
    launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(launches["K2"] >= len(STREAM_POSTS), f"the stream flushes launched K2 {launches['K2']} times")

    expected_events = len(STREAM_POSTS) * len(names)
    query = f"max_events={expected_events}&idle_timeout_s=5"
    status, body = http_call(f"{base}{stream}/events?{query}")
    cpu_status, cpu_body = wsgi_call(cpu_app, "GET", local + "/events", query=query)
    check(status == cpu_status == 200, f"events answered {status} (CPU app {cpu_status})")
    got, expected = sse_events(body), sse_events(cpu_body)
    check([k for _, k, _ in got] == ["open"] + ["anomaly"] * expected_events, "stream event kinds")
    check([(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in expected], "stream event ids differ from the CPU app's")
    max_diff = max(same_json(want, have) for (_, _, want), (_, _, have) in zip(expected, got))
    check(all(d["mse_mean"] is not None for _, k, d in got if k == "anomaly"), "an anomaly event without mse")
    status, body = http_call(base + stream, method="DELETE")
    cpu_status, cpu_body = wsgi_call(cpu_app, "DELETE", local)
    check(status == cpu_status == 200 and json.loads(body) == json.loads(cpu_body), "stream close")
    rows_per_s = scored / (sum(latencies) / 1e3)
    phase("stream", f"{len(got) - 1} anomaly events equal to the CPU app's (max abs diff {max_diff:.3e}, "
          f"rtol {RTOL}, atol {ATOL}); K2 launches {launches['K2']}, K1 launches {launches['K1']}; "
          f"ingest ms {[round(ms, 1) for ms in latencies]}, {rows_per_s:.0f} rows scored a second")
    return launches, latencies, rows_per_s


def second_revision(collection, machines):
    """A revision beside ``collection`` holding copies of ``machines``,
    each detector given a ``SMOOTH_WINDOW``-row rolling median (as a later
    build of the same config with a window would)."""
    from gordo_tpu_torch import serializer

    second = os.path.join(os.path.dirname(collection), SECOND_REVISION)
    for name in machines:
        source = os.path.join(collection, name)
        with open(os.path.join(source, serializer.MODEL_FILE), "rb") as f:
            detector = serializer.loads(f.read(), device="cpu")
        detector.window, detector.smoothing_method = SMOOTH_WINDOW, "smm"
        serializer.dump(detector, os.path.join(second, name), metadata=serializer.load_metadata(source))
    return second


def f64_forward(model, X):
    """``model``'s reconstruction of raw rows ``X[rows, tags]`` in float64:
    its ingest plan and layers, the f32 weights widened."""
    import numpy as np
    import torch
    from gordo_tpu_torch.models.estimators import find_estimator
    from gordo_tpu_torch.ops.activations import resolve_activation
    from gordo_tpu_torch.server.fleet_store import member_plan

    estimator = find_estimator(model)
    scale, offset = member_plan(model, X.shape[1])
    h = torch.from_numpy(np.asarray(X, np.float64) * scale.astype(np.float64) + offset.astype(np.float64))
    for key, activation in estimator.spec_.layer_names():
        W, b = (estimator.params_[key][n].cpu().double() for n in ("W", "b"))
        h = resolve_activation(activation)(h @ W + b)
    return h.numpy()


def f64_distances(cpu_body, body, reference, path):
    """Pop ``model-output`` from both answers and return the largest abs
    difference of the CPU app's and of the card's from ``reference[rows,
    tags]``; the groups' tags and row keys must be equal."""
    import numpy as np

    outputs = [answer["data"].pop("model-output") for answer in (cpu_body, body)]
    check([(t, list(c)) for t, c in outputs[0].items()] == [(t, list(c)) for t, c in outputs[1].items()],
          f"{path}: model-output tags or rows differ")
    return [float(np.abs(np.array([list(col.values()) for col in out.values()]).T - reference).max())
            for out in outputs]


def routes_phase(base, names, wide_names, cpu_app, collection, card):
    """The JSON routes of the card's app at ``base`` beside a second
    revision, every answer held to the CPU app's on the same directories;
    each ``/prediction`` must launch K1. Returns the phase's launches of K1
    and K2."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server.wire import decode_frame

    root, prefix = base.split("/gordo/v0/")
    prefix = "/gordo/v0/" + prefix
    second = second_revision(collection, names[:3] + wide_names[:1])
    pin = f"revision={SECOND_REVISION}"
    narrow_x, wide_x = own_frame(names[0], 20), own_frame(wide_names[0], WIDE_TAGS)

    def both(method, path, query="", payload=None, headers=None, status=200, cpu_first=None, f64=None):
        """The request to the card's app over the socket and to the CPU app
        (``cpu_first`` runs between the two when given); both answer
        ``status`` with equal bodies, except that with ``f64`` (an f64
        forward of the rows) ``model-output`` is held to it instead: the
        card's at most F64_MULTIPLE times as far as the CPU app's (or ATOL).
        Returns the card's parsed body."""
        url = path if path == "/server-version" else prefix + path
        before = fleet_feedforward.launches
        if cpu_first is not None:
            cpu_status, cpu_body = wsgi_call(cpu_app, method, url, payload, query, headers)
            cpu_first()
        got, body, revision, ms = http_request(root + url + ("?" + query if query else ""), method, payload, headers)
        k1 = fleet_feedforward.launches - before
        if cpu_first is None:
            cpu_status, cpu_body = wsgi_call(cpu_app, method, url, payload, query, headers)
        check(got == cpu_status == status, f"{method} {url}?{query} answered {got} (CPU app {cpu_status}), not {status}")
        body, cpu_body = json.loads(body), json.loads(cpu_body)
        body.pop("time-seconds", None)
        cpu_body.pop("time-seconds", None)
        note = ""
        if f64 is not None:
            cpu_err, card_err = f64_distances(cpu_body, body, f64, path)
            limit = F64_MULTIPLE * max(cpu_err, ATOL)
            check(card_err <= limit, f"{path}: model-output {card_err:.3e} from an f64 forward, "
                  f"the CPU app's {cpu_err:.3e} (limit {limit:.3e})")
            note = (f", model-output max abs from an f64 forward: card {card_err:.3e}, CPU app {cpu_err:.3e} "
                    f"(limit {F64_MULTIPLE} x max(CPU app's, ATOL) = {limit:.3e})")
        same_json(cpu_body, body, path)
        check(revision == body.get("revision"), f"{path}: revision header {revision!r}, body {body.get('revision')!r}")
        if path.endswith("/prediction") and status == 200:
            check(k1 >= 1, f"{method} {url}?{query} never launched K1")
        sent = f"{method} {url}{'?' + query if query else ''}{' ' + json.dumps(headers) if headers else ''}"
        phase("routes", f"{sent}: {got} in {ms:.1f} ms on the host clock, K1 launches {k1}{note}; {card}")
        return body

    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    models = both("GET", "/models")["models"]
    check(models == sorted(names + wide_names), "/models lists other machines")
    revisions = both("GET", "/revisions")
    check(revisions["latest"] == REVISION and SECOND_REVISION in revisions["available-revisions"], "/revisions")
    check(list(both("GET", "/server-version")) == ["version"], "/server-version")
    check(both("GET", "/expected-models")["expected-models"] == ["machine-000", "compressor-000"], "/expected-models")
    check(both("GET", f"/{names[0]}/metadata")["metadata"]["name"] == names[0], "metadata")
    served = [both("POST", f"/{n}/prediction", payload={"X": x}) for n, x in ((names[0], narrow_x), (wide_names[0], wide_x))]
    pinned = [both("POST", f"/{n}/prediction", pin, {"X": x}) for n, x in ((names[0], narrow_x), (wide_names[0], wide_x))]
    for got, want in zip(pinned, served):
        check(got["revision"] == SECOND_REVISION, "a pinned answer carries another revision")
        same_json(want["data"], got["data"])  # the copies score what the originals score
    check(len(served[1]["data"]["model-output"]) == WIDE_TAGS, "40-tag prediction columns")
    # another machine's levels at a 40-tag machine: both apps' f32 forwards lie beyond ATOL of the
    # exact answer here, so each is held to an f64 forward of the same rows
    far_x = request_frame(401, n_tags=WIDE_TAGS)
    reference = f64_forward(serializer.load(os.path.join(collection, wide_names[0]), "cpu"),
                            decode_frame(far_x).values)
    both("POST", f"/{wide_names[0]}/prediction", payload={"X": far_x}, f64=reference)
    both("POST", f"/{names[0]}/anomaly/prediction", "revision=999", {"X": narrow_x, "y": narrow_x}, status=410)
    smooth = both("POST", f"/{names[0]}/anomaly/prediction", pin + "&all_columns", {"X": narrow_x, "y": narrow_x})
    check(len(smooth["data"]) == 14 and "smooth-total-anomaly-scaled" in smooth["data"],
          f"?all_columns gave {len(smooth['data'])} column groups")
    both("POST", f"/{names[0]}/anomaly/prediction", payload={"X": narrow_x, "y": narrow_x},
         headers={"Accept": "text/csv"}, status=406)
    both("DELETE", f"/{names[0]}/revision/{REVISION}", status=409)
    machine_dir = os.path.join(second, names[2])
    kept = shutil.copytree(machine_dir, os.path.join(os.path.dirname(second), "kept"))
    both("DELETE", f"/{names[2]}/revision/{SECOND_REVISION}", cpu_first=lambda: shutil.copytree(kept, machine_dir))
    check(not os.path.exists(machine_dir), "DELETE left the machine's directory")
    both("POST", f"/{names[2]}/prediction", pin, {"X": narrow_x}, status=404)
    return {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}


# -- phase 5: times ----------------------------------------------------------------


# -- [sequential]: the sequential build, the build command, kill and resume --------

#: machines built one at a time by ``ModelBuilder``: a 20-tag and a 40-tag
#: machine of [train] and an lstm_hourglass machine of [lstm], with the K1
#: launches each must make (one a TimeSeriesSplit(3) fold; an LSTM none)
SEQUENTIAL = (("machine-000", 3), ("compressor-000", 3), ("lstm-hourglass-000", 0))
#: the kill-and-resume drill: [train]'s first 16 20-tag machines; the kill
#: site fires after its machine's artifact landed and was journaled, so
#: ``after=5`` dies with exactly 6 artifacts on disk
DRILL_MACHINES = 16
DRILL_KILL = "process_kill_after_n_machines:*:after=5:kill"
DRILL_LEFT = 6
#: the ``build`` command's machine: one week of RandomDataProvider readings
COMMAND_MACHINE = "command-000"
#: a fold forward of each sequential feedforward build, held to the plain
#: version and timed: one member, the fold's 500 test rows
SEQUENTIAL_CASES = {20: "sequential fold scoring: hourglass20 M=1 B=500",
                    WIDE_TAGS: "sequential fold scoring: hourglass40 M=1 B=500"}
#: a sequential build (``ModelBuilder``) on the card against the same on
#: the CPU, TF32 off (params, thresholds, CV scores), for every machine of
#: that path here and in ``tests/test_torch_builder_cuda.py``: a lone
#: member's Adam steps carry the f32 differences further than a stacked
#: bucket's. ``scripts/build_tolerance.py sequential`` on an H100 (sound /
#: TF32 on / one row swapped in the last epoch): feedforward params 3.71e-6
#: / 3.22e-3 / 4.35e-5, thresholds 1.31e-7 / 2.04e-5 / 4.55e-6, CV scores
#: 5.90e-7 / 5.87e-4 / 1.17e-4; LSTM (sound / TF32 on; it never shuffles)
#: params LSTM_SOUND_TF32_PARAMS, thresholds LSTM_SOUND_TF32_THRESHOLDS,
#: CV scores LSTM_SOUND_TF32_SCORES.
SEQUENTIAL_BUILD_LIMITS = (1e-5, 3e-6, 2e-5)


def sequential_machines():
    """``(machine, expected K1 launches, model_offset)`` of SEQUENTIAL, each
    holding its seeded rows, with [train]'s or [lstm]'s definition."""
    from gordo_tpu_torch.machine import Machine

    index = [TRAIN_START + timedelta(minutes=10 * r) for r in range(TRAIN_ROWS)]
    rows = {name: (tags, values) for name, tags, values in machine_rows()}
    lstm, models = lstm_machines()
    rows.update({name: (tags, values) for name, tags, values in lstm})
    out = []
    for name, launches in SEQUENTIAL:
        tags, values = rows[name]
        config = {"name": name, "model": models.get(name, DEFINITION),
                  "dataset": {"tag_list": tags, "resolution": "10min"}}
        out.append((Machine.from_config(config, "smoke", data=(values, None), index=index), launches,
                    lstm_offsets().get(name, 0)))
    return out


@contextlib.contextmanager
def captured_fold_forwards():
    """During sequential builds: each ``TorchAutoEncoder.predict``'s K1 call
    as ``(spec, params, X, K1 launches it made)``, its tensors on the card."""
    from gordo_tpu_torch.models import estimators

    forwards, launch = [], estimators.fleet_feedforward

    def captured(spec, bucket, X, *args, **kwargs):
        before = launch.launches
        out = launch(spec, bucket, X, *args, **kwargs)
        forwards.append((spec, bucket, X, launch.launches - before))
        return out

    estimators.fleet_feedforward = captured
    try:
        yield forwards
    finally:
        estimators.fleet_feedforward = launch


def sequential_builds(card, fleet_ms):
    """Build SEQUENTIAL one at a time with ``ModelBuilder`` on the card, each
    K1 launch counted (the counters set to 0 before the first build, read
    after each); print each build's times beside the fleet build's ms a
    machine of its collection (``fleet_ms``: ``{"train": ms, "lstm": ms}``)
    and hold it to a CPU build of the same machine within
    SEQUENTIAL_BUILD_LIMITS. Returns the launches, and each feedforward
    machine's last fold forward as a K1 case on the card with the K1
    launches its build made, by input width."""
    import torch

    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    machines = sequential_machines()
    card_summaries, walls, cases = {}, {}, {}
    with captured_fold_forwards() as forwards:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        before = 0
        for machine, launches, offset in machines:
            first = len(forwards)
            t0 = time.perf_counter()
            model, built = ModelBuilder(machine, device="cuda").build()
            torch.cuda.synchronize()
            walls[machine.name] = 1e3 * (time.perf_counter() - t0)
            made, before = fleet_feedforward.launches - before, fleet_feedforward.launches
            meta = built.metadata["build_metadata"]
            collection = "lstm" if offset else "train"
            phase("sequential", f"{machine.name} built alone by ModelBuilder on the card in "
                  f"{walls[machine.name]:.1f} ms: fetch {1e3 * meta['dataset']['query_duration_sec']:.3f} ms (rows "
                  f"already in memory), CV {1e3 * meta['model']['cross_validation']['cv_duration_sec']:.1f} ms "
                  f"(3 folds, one after another), final fit {1e3 * meta['model']['model_training_duration_sec']:.1f} "
                  f"ms; [{collection}]'s build-fleet took {fleet_ms[collection]:.1f} ms a machine "
                  f"({walls[machine.name] / fleet_ms[collection]:.1f}x); K1 launches {made} (expected {launches}: "
                  f"one a fold's predict), model_offset {meta['model']['model_offset']}; {card}")
            check(made == launches and len(forwards) - first == launches,
                  f"{machine.name}: the sequential build launched K1 {made} times in {len(forwards) - first} "
                  f"predicts, not {launches}")
            check(meta["model"]["model_offset"] == offset,
                  f"{machine.name}: model_offset {meta['model']['model_offset']}")
            if launches:
                spec, params, X, _ = forwards[-1]
                cases[X.shape[-1]] = (dict(spec=spec, bucket=params, X=X, indices=None, ingest=None), made)
            card_summaries[machine.name] = build_summary(model, built)
        launched = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    t0 = time.perf_counter()
    cpu = {}
    for machine, _, _ in sequential_machines():
        model, built = ModelBuilder(machine, device="cpu").build()
        cpu[machine.name] = build_summary(model, built)
    cpu_s = time.perf_counter() - t0
    limits = SEQUENTIAL_BUILD_LIMITS
    for kind in ("feedforward", "lstm"):
        names = [m.name for m, _, offset in machines if bool(offset) == (kind == "lstm")]
        worst, faults = compare_builds(card_summaries, {n: cpu[n] for n in names}, limits)
        phase("sequential", f"{kind} ({', '.join(names)}): card against a CPU ModelBuilder build of the same "
              f"machine ({cpu_s:.2f} s on the CPU for all three): params max abs {worst[0]:.3e} (limit "
              f"{limits[0]}), thresholds max rel {worst[1]:.3e} (limit {limits[1]}), CV scores max |d| / "
              f"(1 + |cpu|) {worst[2]:.3e} (limit {limits[2]}), epochs run and model_offset equal")
        check(not faults, f"sequential {kind} card build disagrees with the CPU's: " + "; ".join(faults[:5]))
    return launched, cases


def run_command(args, env=None, timeout=600):
    """``python -m gordo_tpu_torch ARGS`` from the checkout: ``(exit code,
    stdout, stderr, seconds)``."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "gordo_tpu_torch", *args], cwd=HERE, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, **(env or {})})
    return done.returncode, done.stdout, done.stderr, time.perf_counter() - t0


def build_command(work_dir, card):
    """The ``build`` command in a subprocess, as a build pod runs it
    (``MACHINE``, ``OUTPUT_DIR``, ``--print-cv-scores``): exit 0, the score
    lines, an artifact the port's app serves; then twice with
    ``--model-register-dir``, the second a cache hit with the first's
    ``model.pkl`` bytes."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.server import build_app

    end = TRAIN_START + timedelta(days=7)
    machine = json.dumps({"name": COMMAND_MACHINE, "project_name": "smoke", "model": DEFINITION, "dataset": {
        "type": "RandomDataset", "train_start_date": TRAIN_START.isoformat(), "train_end_date": end.isoformat(),
        "tag_list": tag_list(20)}})
    collection = os.path.join(work_dir, "command", REVISION)
    output = os.path.join(collection, COMMAND_MACHINE)
    code, out, err, seconds = run_command(["build", "--print-cv-scores"], {"MACHINE": machine, "OUTPUT_DIR": output})
    check(code == 0, f"build exited {code}: {err[-2000:]}")
    scores = [line for line in out.splitlines() if "_fold-" in line]
    check(len(scores) == 4 * 21 * 7, f"build printed {len(scores)} score lines, not {4 * 21 * 7}")
    app = build_app(collection, device="cuda")
    status, body = wsgi_call(app, "GET", "/gordo/v0/smoke/models")
    check(status == 200 and json.loads(body)["models"] == [COMMAND_MACHINE], f"models: {status} {body[:200]}")
    frame = request_frame(7)
    status, answer = wsgi_post(app, f"/gordo/v0/smoke/{COMMAND_MACHINE}/anomaly/prediction", {"X": frame, "y": frame})
    check(status == 200, f"anomaly request to the built machine answered {status}")
    confidence = np.array(list(answer["data"]["total-anomaly-confidence"]["total-anomaly-confidence"].values()))
    check(confidence.shape == (ROWS,) and np.isfinite(confidence).all(), "anomaly confidence not finite")
    phase("sequential", f"python -m gordo_tpu_torch build (MACHINE, OUTPUT_DIR, --print-cv-scores; {COMMAND_MACHINE}: "
          f"20 tags, one week of RandomDataProvider readings, hourglass, 5 epochs) exited 0 in {seconds:.2f} s "
          f"(a new process: import, kernel load, fetch, 3 folds, fit, dump), {len(scores)} score lines "
          f"({scores[0]}); the port's app on the card serves the artifact: anomaly request 200; {card}")
    register = os.path.join(work_dir, "register")
    times_, pickles = [], []
    for attempt in range(2):
        target = os.path.join(work_dir, "command-register", str(attempt), COMMAND_MACHINE)
        code, _, err, seconds = run_command(["build", "--model-register-dir", register],
                                            {"MACHINE": machine, "OUTPUT_DIR": target})
        check(code == 0, f"build --model-register-dir exited {code}: {err[-2000:]}")
        times_.append(seconds)
        with open(os.path.join(target, serializer.MODEL_FILE), "rb") as f:
            pickles.append(f.read())
        retrieved = serializer.load_metadata(target)["metadata"]["user_defined"].get("date_of_retrieval")
        check((retrieved is not None) == (attempt == 1), f"run {attempt + 1}: date_of_retrieval {retrieved!r}")
    check(pickles[0] == pickles[1], "the cache hit's model.pkl differs from the registered build's")
    phase("sequential", f"build --model-register-dir twice: the first built and registered in {times_[0]:.2f} s, the "
          f"second loaded the registered build (date_of_retrieval stamped, no training) in {times_[1]:.2f} s, "
          f"model.pkl bytes equal; {card}")


def kill_and_resume(work_dir, train_collection, card):
    """build-fleet of DRILL_MACHINES of [train]'s machines in a subprocess
    killed by ``GORDO_TPU_FAULTS`` (``os._exit(137)``): DRILL_LEFT complete
    artifacts and no half-written model directory; then ``--resume``: the
    DRILL_LEFT resumed from the journal with their ``info.json`` unchanged,
    the rest built within BUILD_LIMITS of [train]'s artifacts of the same
    names (or, where the smaller buckets make them differ, of an
    uninterrupted build of the same shard), and an app listing all of them."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.parallel.journal import BuildJournal, artifact_complete
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    drill_dir = os.path.join(work_dir, "drill")
    os.makedirs(drill_dir)
    machines = [m for m in machine_rows() if m[0].startswith("machine-")][:DRILL_MACHINES]
    config_path, _ = write_project(drill_dir, machines)
    shard = os.path.join(drill_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    out = os.path.join(drill_dir, REVISION)
    code, _, err, killed_s = run_command(["build-fleet", shard, out], {"GORDO_TPU_FAULTS": DRILL_KILL})
    check(code == 137, f"the killed build-fleet exited {code}, not 137: {err[-2000:]}")
    left = serializer.list_model_dirs(out)
    staging = [e for e in os.listdir(out) if serializer.is_staging_dir(e)]
    check(len(left) == DRILL_LEFT and all(artifact_complete(os.path.join(out, n)) for n in left),
          f"the kill left {len(left)} model directories ({left}), not {DRILL_LEFT} complete ones")
    journal = BuildJournal.load(out).machines()
    check(sorted(n for n, e in journal.items() if e["status"] == "built") == left, "journal and artifacts differ")
    checksums = {n: serializer.load_info(os.path.join(out, n))["checksum"] for n in left}
    code, _, err, resume_s = run_command(["build-fleet", shard, out, "--resume"])
    check(code == 0, f"build-fleet --resume exited {code}: {err[-2000:]}")
    summary = [line for line in err.splitlines() if "Fleet build complete" in line]
    expected = f"{DRILL_MACHINES - DRILL_LEFT} built, {DRILL_LEFT} resumed, 0 failed"
    check(summary and expected in summary[-1], f"the resume reported {summary[-1:]} , not {expected}")
    check({n: serializer.load_info(os.path.join(out, n))["checksum"] for n in left} == checksums,
          "a resumed machine's artifact changed")
    names = serializer.list_model_dirs(out)
    check(names == sorted(m[0] for m in machines), f"after the resume the revision holds {names}")
    rebuilt = [n for n in names if n not in left]
    summaries = {}
    for directory in (out, train_collection):
        summaries[directory] = {n: build_summary(serializer.load(os.path.join(directory, n), "cpu"),
                                                 serializer.load_metadata(os.path.join(directory, n)))
                                for n in rebuilt}
    worst, faults = compare_builds(summaries[out], summaries[train_collection])
    reference = "[train]'s artifacts"
    if faults:
        phase("sequential", f"the resumed machines against [train]'s artifacts: {'; '.join(faults[:3])}; building an "
              f"uninterrupted reference of the same shard")
        reference_dir = os.path.join(drill_dir, "reference")
        code, _, err, _ = run_command(["build-fleet", shard, reference_dir])
        check(code == 0, f"the reference build-fleet exited {code}: {err[-2000:]}")
        ref = {n: build_summary(serializer.load(os.path.join(reference_dir, n), "cpu"),
                                serializer.load_metadata(os.path.join(reference_dir, n))) for n in rebuilt}
        worst, faults = compare_builds(summaries[out], ref)
        reference = "an uninterrupted build of the same shard"
    check(not faults, "resumed machines disagree with their reference: " + "; ".join(faults[:5]))
    app = build_app(out, device="cuda")
    status, body = wsgi_call(app, "GET", "/gordo/v0/smoke/models")
    listed = json.loads(body)["models"]
    check(status == 200 and listed == names, f"the app lists {listed}")
    phase("sequential", f"kill and resume: build-fleet of {DRILL_MACHINES} [train] machines with GORDO_TPU_FAULTS="
          f"\"{DRILL_KILL}\" exited 137 after {killed_s:.2f} s with {len(left)} complete artifacts, no half-written "
          f"model directory ({len(staging)} staging leftovers, hidden), the journal naming the same {len(left)}; "
          f"--resume exited 0 in {resume_s:.2f} s: {expected}, the resumed info.json checksums unchanged, the "
          f"{len(rebuilt)} rebuilt within BUILD_LIMITS of {reference} (params max abs {worst[0]:.3e}, thresholds "
          f"max rel {worst[1]:.3e}, CV scores {worst[2]:.3e}); the app lists all {len(listed)} and no journal or "
          f"staging entry; {card}")


def sequential_phase(work_dir, train_collection, fleet_ms, card):
    """[sequential]: the sequential builds, the build command and the kill
    drill. Returns K1's and K2's launches in the sequential builds and their
    fold forwards (``sequential_builds``)."""
    t0 = time.perf_counter()
    launches, cases = sequential_builds(card, fleet_ms)
    build_command(work_dir, card)
    kill_and_resume(work_dir, train_collection, card)
    phase("sequential", f"the phase took {time.perf_counter() - t0:.1f} s")
    return launches, cases


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call: CUDA events around ``iters`` calls queued behind
    a device sleep that outlasts their enqueueing twice over, so the host's
    time (Python, ctypes) is hidden and the events see only the device's
    work. ``fn`` must not synchronise with the device."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(1e7, 2 * host_s * iters * 2e9)))  # cycles; the SM clock is below 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log):
    """``"<kernel>: <registers>, <spills>"`` for each entry function in
    ``nvcc -Xptxas -v``'s output; kernels named ``narrow<S>`` (S lanes a
    row) and ``wide<resident|streamed, 8|16>`` (the member's weights
    staged once or streamed through the ring; at most 8 or 16 fragments a
    warp)."""
    import re

    report, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            wide = re.search(r"wide_kernelILb([01])ELb([01])E", entry.group(1))
            narrow = re.search(r"narrow_kernelILi(\d+)E", entry.group(1))
            name = f"wide<{'resident' if wide.group(1) == '1' else 'streamed'}, {16 if wide.group(2) == '1' else 8}>" \
                if wide else \
                f"narrow<{narrow.group(1)}>" if narrow else \
                "narrow" if "narrow_kernel" in entry.group(1) else entry.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            used = re.search(r"Used (\d+) registers", line)
            report.append(f"{name}: {used.group(1) if used else '?'} registers, {spills}")
            name = None
    return report


def narrow_plan(case):
    """``(lanes a row, shared memory bytes a block, blocks an SM, grid)``
    of the narrow kernel at ``case``'s shape, as its launch works them out."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    fn = _build.load("fleet_dense").fleet_dense_narrow_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    widths = case["spec"].widths()
    dims = (ctypes.c_int * len(widths))(*widths)
    M, B, _ = case["X"].shape
    out = [ctypes.c_int() for _ in range(4)]
    status = fn(len(widths) - 1, ctypes.cast(dims, ctypes.c_void_p), M, B, *map(ctypes.byref, out))
    check(status == 0, f"fleet_dense_narrow_occupancy returned {status}")
    return tuple(v.value for v in out)


def wide_plan(case):
    """``(resident, rows a tile, warps a 16-row slice, shared memory bytes a
    block, blocks an SM, grid)`` of the wide kernel at ``case``'s shape, as
    its launch works them out."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    fn = _build.load("fleet_dense").fleet_dense_wide_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    widths = case["spec"].widths()
    dims = (ctypes.c_int * len(widths))(*widths)
    M, B, _ = case["X"].shape
    out = [ctypes.c_int() for _ in range(6)]
    status = fn(len(widths) - 1, ctypes.cast(dims, ctypes.c_void_p), M, B, *map(ctypes.byref, out))
    check(status == 0, f"fleet_dense_wide_occupancy returned {status}")
    return tuple(v.value for v in out)


def library_chain(case):
    """cuBLAS ``baddbmm`` per layer over pre-gathered params: the library
    yardstick for the same function (in full f32 unless the caller lets
    cuBLAS use TF32, see :func:`with_tf32`)."""
    import torch

    from gordo_tpu_torch.ops.activations import resolve_activation

    spec, bucket, X = case["spec"], case["bucket"], case["X"]
    idx = torch.as_tensor(case["indices"] if case["indices"] is not None else range(X.shape[0]),
                          device=X.device)
    layers = [(bucket[k]["W"][idx].contiguous(), bucket[k]["b"][idx][:, None, :].contiguous(),
               resolve_activation(a)) for k, a in spec.layer_names()]
    ingest = None
    if case["ingest"] is not None:
        ingest = (case["ingest"][0][idx][:, None, :], case["ingest"][1][idx][:, None, :])

    def run():
        h = X if ingest is None else torch.addcmul(ingest[1], X, ingest[0])
        for W, b, act in layers:
            h = act(torch.baddbmm(b, h, W))
        return h

    return run


def bound(case):
    """(bound_ms, bound_by, cuda_core_ms): each input read once and each
    output written once against HBM, and 2 flops per multiply-add against
    the card's fastest f32-accurate rate, the tensor cores' 3xTF32
    (``PEAK_3XTF32_FLOP_PER_S``); ``cuda_core_ms`` is the same bound at the
    f32 rate outside the tensor cores (67 TFLOP/s), the bound before the
    wide kernel used them, kept for the record. With K2's targets
    ``case["y"]``: 4 more bytes a row for the mse, y's bytes when y is not
    X, and 3 flops a compared column."""
    spec, X = case["spec"], case["X"]
    M, B, _ = X.shape
    # only the members the batch reads: a gather touches len(set(indices)) rows
    n = case["bucket"]["out"]["W"].shape[0] if case["indices"] is None else len(set(case["indices"]))
    widths = spec.widths()
    macs = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
    params = n * (macs + sum(widths[1:]))
    byte_count = 4 * (X.numel() + M * B * spec.n_features_out + params + M)
    if case["ingest"] is not None:
        byte_count += 4 * 2 * n * spec.n_features
    flops = 2 * M * B * macs
    y = case.get("y")
    if y is not None:
        byte_count += 4 * M * B + (0 if y is X else 4 * y.numel())
        flops += 3 * M * B * min(spec.n_features_out, y.shape[-1])
    byte_ms = byte_count / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_3XTF32_FLOP_PER_S * 1e3
    cuda_core_ms = max(byte_ms, flops / PEAK_F32_FLOP_PER_S * 1e3)
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations", cuda_core_ms


def with_tf32(fn):
    """``fn`` with cuBLAS allowed TF32 (one product, ~3 decimal digits):
    what the library gives on the tensor cores, less accurate than the
    kernel's 3xTF32; the yardstick stays the f32 chain."""
    import torch

    def run():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    return run


def times(case):
    """K1, its plain version, the f32 ``baddbmm`` chain, the chain with
    TF32, and the bounds."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference

    args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
    kernel = cuda_ms(lambda: fleet_feedforward(*args))
    plain = cuda_ms(lambda: fleet_feedforward_reference(*args))
    library = cuda_ms(library_chain(case))
    library_tf32 = cuda_ms(with_tf32(library_chain(case)))
    return (kernel, plain, library, library_tf32, *bound(case))


def scores_times(case):
    """K2, its plain version, the library yardstick (the ``baddbmm`` chain
    and ``torch.square(out - y).mean(-1)``) in f32 and with TF32, K1 alone
    at the same shape, and the bounds."""
    import torch

    from gordo_tpu_torch.ops.fleet_dense import (
        fleet_anomaly_scores,
        fleet_anomaly_scores_reference,
        fleet_feedforward,
    )

    y = case["y"]
    w = min(case["spec"].n_features_out, y.shape[-1])
    args = (case["spec"], case["bucket"], case["X"], y, case["indices"], case["ingest"])
    chain = library_chain(case)

    def library():
        out = chain()
        return out, torch.square(out[..., :w] - y[..., :w]).mean(-1)

    kernel = cuda_ms(lambda: fleet_anomaly_scores(*args))
    plain = cuda_ms(lambda: fleet_anomaly_scores_reference(*args))
    library_ms = cuda_ms(library)
    library_tf32 = cuda_ms(with_tf32(library))
    k1 = cuda_ms(lambda: fleet_feedforward(*args[:3], *args[4:]))
    return (kernel, plain, library_ms, library_tf32, k1, *bound(case))


# -- main ------------------------------------------------------------------------------


def main():
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import gordo_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"gordo_tpu_torch is not importable beside this script: {exc}")
    package_dir = os.path.dirname(os.path.abspath(gordo_tpu_torch.__file__))
    check(os.path.dirname(package_dir) == HERE, f"gordo_tpu_torch found at {package_dir}, not beside the script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    phase("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible")

    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    t0 = time.perf_counter()
    libraries = _build.build(variants=((), WIDE_ONLY, NO_SPLIT))
    for stem, path in libraries.items():
        log = path.with_suffix(".log")
        report = ptxas_report(log.read_text()) if log.exists() else ["(prebuilt)"]
        phase("build", f"{stem}: {path.name} in {time.perf_counter() - t0:.1f} s; " + " | ".join(report))

    cases = kernel_cases()
    errors = {}
    for name, case in cases.items():
        errors[name] = compare(case)
        phase("kernel", f"{name}: max abs {errors[name][0]:.3e}, max rel {errors[name][1]:.3e} "
              f"(rtol {RTOL}, atol {ATOL}: f32 sums in another order)")
    scored = k2_cases(cases)
    for name, case in scored.items():
        errors[name] = compare_scores(case)
        phase("kernel", f"{name}: max abs {errors[name][0]:.3e}, max rel {errors[name][1]:.3e} "
              f"over recon and mse (rtol {RTOL}, atol {ATOL})")
    for name in K2_WIDE_ONLY:
        wide_err = compare_scores(scored[name], WIDE_ONLY)
        phase("kernel", f"{name}, wide-only build: max abs {wide_err[0]:.3e}, max rel {wide_err[1]:.3e}")
    for name in SPLIT_CASES:
        for y in ("x", "nan"):
            k2_name = f"K2 {name} y={y}"
            unsplit = max(compare(cases[name], NO_SPLIT), compare_scores(scored[k2_name], NO_SPLIT))
            phase("kernel", f"{name}, K1 and {k2_name}, no-split build: max abs {unsplit[0]:.3e}, "
                  f"max rel {unsplit[1]:.3e}")
    # the activation cases (3 x 37 rows) share rows among lanes; one lane a row too
    activations = [name for name in cases if name.startswith("activation") and name.endswith("hidden 9")]
    unsplit = max(compare(cases[name], NO_SPLIT) for name in activations)
    phase("kernel", f"{len(activations)} activations at hidden 9, no-split build: max abs {unsplit[0]:.3e}, "
          f"max rel {unsplit[1]:.3e}")

    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.server.app import make_wsgi_server

    # the stream plane reads its knobs when the first stream route creates it
    os.environ["GORDO_TPU_STREAM_WINDOW_ROWS"] = str(STREAM_WINDOW)
    os.environ["EXPECTED_MODELS"] = EXPECTED_MODELS
    build_dir = os.path.join(HERE, "build")  # git-ignored; the collection is temporary
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        collection = os.path.join(work_dir, REVISION)
        names, wide_names, train_launches, cv_cases, train_ms = train_phase(work_dir, collection)
        check(sorted(cv_cases) == sorted(CV_CASES), f"CV forwards of widths {sorted(cv_cases)}")
        for width, name in CV_CASES.items():
            cv_case = cv_cases[width][0]
            shape = (3 * CV_MACHINES[width], TRAIN_ROWS // 4, width)
            check(tuple(cv_case["X"].shape) == shape, f"the {width}-tag CV forward had shape "
                  f"{tuple(cv_case['X'].shape)}, not {shape}")
            errors[name] = compare(cv_case)
            phase("kernel", f"{name}, the build's own fold params and test rows: max abs {errors[name][0]:.3e}, "
                  f"max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        config_launches, kfcv_case, kfcv_launches, errors[KFCV_CASE] = config_phase(work_dir)
        t0 = time.perf_counter()
        lstm_directory, lstm_seeds, lstm_build_launches, lstm_ms = lstm_build(work_dir, card)
        lstm_serve_launches = lstm_serve(lstm_directory, collection, lstm_seeds, card)
        phase("lstm", f"the phase took {time.perf_counter() - t0:.1f} s ([lstm times] comes later)")
        lstm_launches = {k: lstm_build_launches[k] + lstm_serve_launches[k] for k in ("K1", "K2")}
        build_launches, sequential_cases = sequential_phase(work_dir, collection, {"train": train_ms, "lstm": lstm_ms},
                                                            card)
        check(sorted(sequential_cases) == sorted(SEQUENTIAL_CASES),
              f"sequential fold forwards of widths {sorted(sequential_cases)}")
        for width, name in SEQUENTIAL_CASES.items():
            case = sequential_cases[width][0]
            shape = (1, TRAIN_ROWS // 4, width)
            check(tuple(case["X"].shape) == shape, f"the {width}-tag sequential fold forward had shape "
                  f"{tuple(case['X'].shape)}, not {shape}")
            errors[name] = compare(case)
            phase("kernel", f"{name}, a sequential build's own fold params and test rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        app = build_app(collection, device="cuda")
        check(len(app.store.fleet().warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
        cpu_app = build_app(collection, device="cpu")
        server = make_wsgi_server(app, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_port}/gordo/v0/smoke"
        try:
            launches, wide_launches = serve_phase(base, names, wide_names, cpu_app)
            stream_launches, _latencies, _rows_per_s = stream_phase(base, names, cpu_app)
            route_launches = routes_phase(base, names, wide_names, cpu_app, collection, card)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread did not stop")

    for name in (*NARROW_CASES, "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest"):
        split, smem, per_sm, grid = narrow_plan(scored[name] if name.startswith("K2") else cases[name])
        phase("occupancy", f"narrow kernel at {name}: {split} lanes a row, {smem} B of shared memory a block, "
              f"{per_sm} blocks of 128 threads an SM, grid {grid}")
    for name in (*WIDE_CASES, "widest: 512-300-1-512 B=70"):
        resident, rows, wpr, smem, per_sm, grid = wide_plan(cases[name])
        phase("occupancy", f"wide kernel at {name}: weights {'resident' if resident else 'streamed'}, "
              f"{rows}-row tiles, {wpr} warps a 16-row slice, {smem} B of shared memory a block, "
              f"{per_sm} blocks of 512 threads an SM, grid {grid}")

    # what no kernel launch can beat: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    floor = cuda_ms(lambda: one.zero_())
    phase("times", f"launch floor (a one-element zero_): {floor!r} ms; {card}")
    timed = {}
    for name in list(cases)[:TIMED]:
        timed[name] = times(cases[name])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        served = f", launch floor {floor!r} ms" if name.startswith("served") else ""
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}){served}; {card}")
    for width, name in CV_CASES.items():
        timed[name] = times(cv_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    for width, name in SEQUENTIAL_CASES.items():
        timed[name] = times(sequential_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    timed[KFCV_CASE] = times(kfcv_case)
    kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[KFCV_CASE]
    phase("times", f"{KFCV_CASE} {tuple(kfcv_case['X'].shape)}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm "
          f"chain {library!r} ms (with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 "
          f"tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
          f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    anomaly = cases[NARROW_CASES[2]]
    on_card = torch.tensor(anomaly["indices"], dtype=torch.int32, device="cuda")
    k1_on_card = cuda_ms(lambda: fleet_feedforward(
        anomaly["spec"], anomaly["bucket"], anomaly["X"], on_card, anomaly["ingest"]))
    phase("times", f"{NARROW_CASES[2]}, indices already on the card: K1 {k1_on_card!r} ms (host indices "
          f"{timed[NARROW_CASES[2]][0]!r} ms), launch floor {floor!r} ms; {card}")
    scored_timed = {}
    for name in list(scored)[:6]:
        scored_timed[name] = scores_times(scored[name])
        kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[name]
        served = f", launch floor {floor!r} ms" if "served" in name or "stream" in name else ""
        phase("times", f"{name}: K2 {kernel!r} ms, plain {plain!r} ms, baddbmm chain + mean {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), K1 alone {k1!r} ms (epilogue {kernel - k1:+.5f} ms), "
              f"bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), "
              f"CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}){served}; {card}")

    lstm_times(card)

    for name in NARROW_CASES:
        case = cases[name]
        args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
        wide_err = compare(case, WIDE_ONLY)[0]
        narrow = cuda_ms(lambda: fleet_feedforward(*args))
        wide = cuda_ms(lambda: fleet_feedforward(*args, defines=WIDE_ONLY))
        phase("narrow vs wide", f"{name}: narrow kernel {narrow!r} ms, wide kernel {wide!r} ms "
              f"(wide/narrow {wide / narrow:.2f}; wide max abs {wide_err:.3e}); {card}")
    for name in K2_WIDE_ONLY[:1]:
        case = scored[name]
        args = (case["spec"], case["bucket"], case["X"], case["y"], case["indices"], case["ingest"])
        narrow = cuda_ms(lambda: fleet_anomaly_scores(*args))
        wide = cuda_ms(lambda: fleet_anomaly_scores(*args, defines=WIDE_ONLY))
        phase("narrow vs wide", f"{name}: narrow kernel {narrow!r} ms, wide kernel {wide!r} ms "
              f"(wide/narrow {wide / narrow:.2f}); {card}")

    for name in SPLIT_CASES:
        case = cases[name]
        on_card = torch.tensor(case["indices"], dtype=torch.int32, device="cuda")
        args = (case["spec"], case["bucket"], case["X"], on_card, case["ingest"])
        split = cuda_ms(lambda: fleet_feedforward(*args))
        unsplit = cuda_ms(lambda: fleet_feedforward(*args, defines=NO_SPLIT))
        phase("split", f"{name}, indices on the card: {narrow_plan(case)[0]} lanes a row {split!r} ms, "
              f"one lane a row {unsplit!r} ms (split/one {split / unsplit:.2f}), launch floor {floor!r} ms; {card}")

    def entry(name, replaces, launches_, by_path, case, numbers):
        kernel, plain, library, library_tf32 = numbers[:4]
        bound_ms, bound_by, cuda_core_ms = numbers[-3:]
        return {
            "name": name, "route": "cuda", "source": "gordo_tpu_torch/ops/csrc/fleet_dense.cu",
            "replaces": replaces, "launches": launches_, "launches_by_path": by_path, "shape": case,
            "max_abs_err": errors[case][0], "ms": kernel, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library, "library_tf32_ms": library_tf32,
            "cuda_core_bound_ms": cuda_core_ms, "launch_floor_ms": floor,
        }

    k1_by_path = {"train": train_launches["K1"], "config": config_launches["K1"], "serve": launches["K1"],
                  "serve_wide": wide_launches["K1"], "stream": stream_launches["K1"], "routes": route_launches["K1"],
                  "lstm": lstm_launches["K1"], "build": build_launches["K1"]}
    k2_by_path = {"train": train_launches["K2"], "config": config_launches["K2"], "serve": launches["K2"],
                  "serve_wide": wide_launches["K2"], "stream": stream_launches["K2"], "routes": route_launches["K2"],
                  "lstm": lstm_launches["K2"], "build": build_launches["K2"]}
    k2_wide = f"K2 {WIDE_CASES[0]} y=X"
    print(json.dumps({"kernels": [
        entry("fleet_dense (K1), narrow kernel", "gordo_tpu/ops/pallas_dense.py:114", launches["K1"],
              k1_by_path, "hourglass20 M=1000 B=1008", timed["hourglass20 M=1000 B=1008"]),
        entry("fleet_anomaly_scores (K2), narrow kernel", "gordo_tpu/ops/pallas_dense.py:126",
              stream_launches["K2"], k2_by_path, "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest",
              scored_timed["K2 stream flush: hourglass20 M=64 B=512 y=X +ingest"]),
        entry("fleet_dense (K1), wide kernel", "gordo_tpu/ops/pallas_dense.py:114", wide_launches["K1"],
              k1_by_path, WIDE_CASES[0], timed[WIDE_CASES[0]]),
        entry("fleet_anomaly_scores (K2), wide kernel", "gordo_tpu/ops/pallas_dense.py:126", wide_launches["K2"],
              k2_by_path, k2_wide, scored_timed[k2_wide]),
        # launches: the build's CV forward of that width, read on the counter
        entry("fleet_dense (K1), narrow kernel, CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              cv_cases[20][1], k1_by_path, CV_CASES[20], timed[CV_CASES[20]]),
        entry("fleet_dense (K1), wide kernel, CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              cv_cases[WIDE_TAGS][1], k1_by_path, CV_CASES[WIDE_TAGS], timed[CV_CASES[WIDE_TAGS]]),
        # launches: the [config] build's KFCV forward, read on the counter
        entry("fleet_dense (K1), narrow kernel, KFCV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              kfcv_launches, k1_by_path, KFCV_CASE, timed[KFCV_CASE]),
        # launches: the [sequential] build of that width, one a fold, read on the counter
        entry("fleet_dense (K1), narrow kernel, sequential fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              sequential_cases[20][1], k1_by_path, SEQUENTIAL_CASES[20], timed[SEQUENTIAL_CASES[20]]),
        entry("fleet_dense (K1), wide kernel, sequential fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              sequential_cases[WIDE_TAGS][1], k1_by_path, SEQUENTIAL_CASES[WIDE_TAGS],
              timed[SEQUENTIAL_CASES[WIDE_TAGS]]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # noqa: BLE001 - every failure ends the run non-zero
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
