#!/usr/bin/env python3
"""
How far ``chip_smoke.py``'s card-against-CPU build check sits from a
wrong build.

    python3 scripts/build_tolerance.py [lstm | segmented | sequential | definitions]

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds
``chip_smoke.CPU_CHECK`` (two 20-tag and two 40-tag machines: the smoke's
definition, rows and seeds), or with ``lstm`` ``chip_smoke.LSTM_CPU_CHECK``
(one ``[lstm]`` machine an architecture, its definition, rows and seed),
on the CPU, then three times on the card, and holds each card build to
the CPU's with ``chip_smoke.compare_builds`` at the smoke's limits
(``LSTM_BUILD_LIMITS`` for ``lstm``). ``segmented`` builds the same
machines with ``GORDO_TPU_LSTM_SEGMENTED=chip_smoke.LSTM_SEGMENTS`` (the
final fits segmented, the CV folds windowed): ``sound`` and ``tf32`` as
below, then ``bucket``: each machine built on the card among every
``[lstm]`` machine of its group, as the smoke's build trains it (4 or 8
members to a bucket), held to its CPU build alone. With ``sequential`` the builds are
``ModelBuilder``'s, one machine at a time: the machines of
``chip_smoke.py``'s ``[sequential]`` and those of
``tests/test_torch_builder_cuda.py``, held at ``SEQUENTIAL_BUILD_LIMITS``,
the feedforward machines and the LSTM machines apart (an LSTM never
shuffles, so it has no ``swap`` build there). With ``definitions`` the
machines are ``[definitions]``'s (its project config and CSVs): one of
each affine fleet kind, then every non-affine machine, at
``DEFINITIONS_BUILD_LIMITS``, and
the callbacks machine, which ``build-fleet`` sends to ``ModelBuilder``,
at ``SEQUENTIAL_BUILD_LIMITS``:

- ``sound``: full f32, as the smoke builds;
- ``tf32``: TF32 allowed for matmuls, the precision setting the build
  must keep off;
- ``swap``: in every member's last epoch, the first and the last row of
  its permutation exchanged (an injected random source): one row trained
  in another batch, the smallest change to what a member sees. An LSTM
  member never shuffles: in the final fit its first and last windows
  exchange places in its window order instead, for every epoch.

Prints one line a build: the largest params, thresholds and CV score
differences beside the smoke's limits, and how many of its checks
failed; then the card's name and power limit. Exits non-zero if the
sound build fails the check.
"""

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lstm_machines(every=False):
    """``chip_smoke.LSTM_CPU_CHECK`` (with ``every``, all of ``[lstm]``'s
    machines) as fleet-build machines holding their rows as arrays (the
    rows ``[lstm]`` writes to its CSVs)."""
    from datetime import timedelta

    import chip_smoke
    from gordo_tpu_torch.machine import Machine

    machines, models = chip_smoke.lstm_machines()
    index = [chip_smoke.TRAIN_START + timedelta(minutes=10 * r) for r in range(chip_smoke.LSTM_ROWS)]
    return [
        Machine.from_config({"name": name, "model": models[name], "dataset": {"tag_list": tags, "resolution": "10min"}},
                            "smoke-lstm", data=(values, None), index=index)
        for name, tags, values in machines if every or name in chip_smoke.LSTM_CPU_CHECK
    ]


@contextlib.contextmanager
def swapped_windows():
    """Every windowed final-fit member made with its first and last window
    exchanged in its window order."""
    import numpy as np

    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    make = FleetBuilder._make_member

    def swapped(plan, train_weights, seed, name):
        member = make(plan, train_weights, seed, name)
        if hasattr(member, "series") and train_weights is None:  # the final fit: every window trains
            order = np.arange(member.n_windows) if member.order is None else member.order.copy()
            order[[0, -1]] = order[[-1, 0]]
            member.order = order
        return member

    FleetBuilder._make_member = staticmethod(swapped)
    try:
        yield
    finally:
        FleetBuilder._make_member = staticmethod(make)


def definitions_machines(directory):
    """``[definitions]``'s machines (its project written into ``directory``):
    ``(fleet machines, the callbacks machine)``."""
    import chip_smoke
    from gordo_tpu_torch.cli.cli import load_fleet_machines
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    config_path, _ = chip_smoke.definitions_project(directory)
    machines = load_fleet_machines(normalize(config_path, "smoke"))
    fleet = [m for m in machines if m.name in chip_smoke.DEFINITIONS_CPU_CHECK[:-1] or m.name.startswith("nonaffine")]
    return fleet, [m for m in machines if m.name == chip_smoke.DEFINITIONS_CPU_CHECK[-1]]


def sequential_summaries(machines, device, random=None):
    """``chip_smoke.build_summaries`` of ``ModelBuilder`` builds, one machine
    at a time."""
    import time

    import chip_smoke
    from gordo_tpu_torch.builder import ModelBuilder

    t0 = time.perf_counter()
    out = {}
    for machine in machines:
        model, built = ModelBuilder(machine, device=device, random=random).build()
        out[machine.name] = chip_smoke.build_summary(model, built)
    return out, time.perf_counter() - t0


def sequential_machines():
    """``(machine, is an LSTM)``: the machines of ``[sequential]`` and of the
    card test."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import chip_smoke
    import test_torch_builder_cuda

    smoke = [(machine, bool(offset)) for machine, _, offset in chip_smoke.sequential_machines()]
    return smoke + [(test_torch_builder_cuda._machine(kind, n, n), kind == "lstm")
                    for kind, n in (("feedforward", 20), ("feedforward", 40), ("lstm", 20))]


def tolerance(kind, machines, limits, summaries, labels, swap_windows=False):
    """Build ``machines`` on the CPU, then on the card once a label of
    ``labels``, each card build held to the CPU's at ``limits``; prints a
    line a build. Returns the sound build's failed checks."""
    import torch

    import chip_smoke
    from gordo_tpu_torch.models.training import TorchRandom

    class Swapped(TorchRandom):
        def permutations(self, seed, epochs, n_total):
            perms = super().permutations(seed, epochs, n_total).clone()
            perms[-1, [0, -1]] = perms[-1, [-1, 0]]
            return perms

    names = [m.name for m in machines]
    cpu, cpu_s = summaries(machines, "cpu")
    sound_faults = None
    for label in labels:
        torch.backends.cuda.matmul.allow_tf32 = label == "tf32"
        random = Swapped() if label == "swap" else None
        try:
            with swapped_windows() if swap_windows and label == "swap" else contextlib.nullcontext():
                card, card_s = summaries(machines, "cuda", random)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        worst, faults = chip_smoke.compare_builds(card, cpu, limits)
        if label == "sound":
            sound_faults = faults
        print(f"[tolerance] {kind} {label}: card build of {', '.join(names)} in {card_s:.2f} s against "
              f"the CPU's ({cpu_s:.2f} s): params max abs {worst[0]!r} (limit {limits[0]}), "
              f"thresholds max rel {worst[1]!r} (limit {limits[1]}), CV scores max "
              f"|d| / (1 + |cpu|) {worst[2]!r} (limit {limits[2]}); {len(faults)} checks "
              f"failed: {faults[:3]}", flush=True)
    return sound_faults


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("build_tolerance.py needs an NVIDIA GPU")
    controls = ("sound", "tf32", "swap")
    if sys.argv[1:] == ["sequential"]:
        machines = sequential_machines()
        limits = chip_smoke.SEQUENTIAL_BUILD_LIMITS
        faults = tolerance("sequential feedforward", [m for m, lstm in machines if not lstm], limits,
                           sequential_summaries, controls)
        faults += tolerance("sequential lstm", [m for m, lstm in machines if lstm], limits,
                            sequential_summaries, ("sound", "tf32"))
    elif sys.argv[1:] == ["definitions"]:
        import tempfile

        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as directory:
            fleet, callbacks = definitions_machines(directory)
            affine = [m for m in fleet if not m.name.startswith("nonaffine")]
            limits = chip_smoke.DEFINITIONS_BUILD_LIMITS
            faults = tolerance("definitions raw, standard, maxabs", affine, limits, chip_smoke.build_summaries,
                               controls)
            faults += tolerance("definitions nonaffine", [m for m in fleet if m not in affine], limits,
                                chip_smoke.build_summaries, controls)
            faults += tolerance("definitions callbacks", callbacks, chip_smoke.SEQUENTIAL_BUILD_LIMITS,
                                chip_smoke.build_summaries, controls)
    elif sys.argv[1:] == ["segmented"]:
        os.environ["GORDO_TPU_LSTM_SEGMENTED"] = str(chip_smoke.LSTM_SEGMENTS)
        checked = lstm_machines()
        cpu_build = []

        def alone(machines, device, random=None):  # the CPU build once, for both calls
            if device != "cpu":
                return chip_smoke.build_summaries(machines, device, random)
            if not cpu_build:
                cpu_build.append(chip_smoke.build_summaries(machines, device))
            return cpu_build[0]

        faults = tolerance("lstm segmented", checked, chip_smoke.LSTM_BUILD_LIMITS, alone, ("sound", "tf32"))
        groups = tuple(name.rsplit("-", 1)[0] for name in chip_smoke.LSTM_CPU_CHECK)

        def in_buckets(machines, device, random=None):
            if device == "cpu":
                return alone(machines, device)
            everything = lstm_machines(every=True)
            summaries, seconds = chip_smoke.build_summaries(
                [m for m in everything if m.name.rsplit("-", 1)[0] in groups], device)
            return {m.name: summaries[m.name] for m in machines}, seconds

        tolerance("lstm segmented", checked, chip_smoke.LSTM_BUILD_LIMITS, in_buckets, ("bucket",))
    elif sys.argv[1:] == ["lstm"]:
        faults = tolerance("lstm", lstm_machines(), chip_smoke.LSTM_BUILD_LIMITS, chip_smoke.build_summaries,
                           controls, swap_windows=True)
    else:
        machines = [m for m in chip_smoke.served_machines() if m.name in chip_smoke.CPU_CHECK]
        faults = tolerance("fleet", machines, chip_smoke.BUILD_LIMITS, chip_smoke.build_summaries, controls)
    print(chip_smoke.device_line(), flush=True)
    if faults:
        raise SystemExit("the sound build failed the check")


if __name__ == "__main__":
    main()
