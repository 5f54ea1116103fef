#!/usr/bin/env python3
"""
How far ``chip_smoke.py``'s card-against-CPU build check sits from a
wrong build.

    python3 scripts/build_tolerance.py [lstm]

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds
``chip_smoke.CPU_CHECK`` (two 20-tag and two 40-tag machines: the smoke's
definition, rows and seeds), or with ``lstm`` ``chip_smoke.LSTM_CPU_CHECK``
(one ``[lstm]`` machine an architecture, its definition, rows and seed),
on the CPU, then three times on the card, and holds each card build to
the CPU's with ``chip_smoke.compare_builds`` at the smoke's limits
(``LSTM_BUILD_LIMITS`` for ``lstm``):

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


def lstm_machines():
    """``chip_smoke.LSTM_CPU_CHECK`` as fleet-build machines holding their
    rows as arrays (the rows ``[lstm]`` writes to its CSVs)."""
    from datetime import timedelta

    import chip_smoke
    from gordo_tpu_torch.machine import Machine

    machines, models = chip_smoke.lstm_machines()
    index = [chip_smoke.TRAIN_START + timedelta(minutes=10 * r) for r in range(chip_smoke.TRAIN_ROWS)]
    return [
        Machine.from_config({"name": name, "model": models[name], "dataset": {"tag_list": tags, "resolution": "10min"}},
                            "smoke-lstm", data=(values, None), index=index)
        for name, tags, values in machines if name in chip_smoke.LSTM_CPU_CHECK
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


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from gordo_tpu_torch.models.training import TorchRandom

    if not torch.cuda.is_available():
        raise SystemExit("build_tolerance.py needs an NVIDIA GPU")

    class Swapped(TorchRandom):
        def permutations(self, seed, epochs, n_total):
            perms = super().permutations(seed, epochs, n_total).clone()
            perms[-1, [0, -1]] = perms[-1, [-1, 0]]
            return perms

    lstm = sys.argv[1:] == ["lstm"]
    if lstm:
        machines, names, limits = lstm_machines(), chip_smoke.LSTM_CPU_CHECK, chip_smoke.LSTM_BUILD_LIMITS
    else:
        machines = [m for m in chip_smoke.served_machines() if m.name in chip_smoke.CPU_CHECK]
        names, limits = chip_smoke.CPU_CHECK, chip_smoke.BUILD_LIMITS
    cpu, cpu_s = chip_smoke.build_summaries(machines, "cpu")
    sound_faults = None
    for label, tf32, random in (("sound", False, None), ("tf32", True, None), ("swap", False, Swapped())):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with swapped_windows() if lstm and label == "swap" else contextlib.nullcontext():
                card, card_s = chip_smoke.build_summaries(machines, "cuda", random)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        worst, faults = chip_smoke.compare_builds(card, cpu, limits)
        if label == "sound":
            sound_faults = faults
        print(f"[tolerance] {label}: card build of {', '.join(names)} in {card_s:.2f} s against "
              f"the CPU's ({cpu_s:.2f} s): params max abs {worst[0]!r} (limit {limits[0]}), "
              f"thresholds max rel {worst[1]!r} (limit {limits[1]}), CV scores max "
              f"|d| / (1 + |cpu|) {worst[2]!r} (limit {limits[2]}); {len(faults)} checks "
              f"failed: {faults[:3]}", flush=True)
    print(chip_smoke.device_line(), flush=True)
    if sound_faults:
        raise SystemExit("the sound build failed the check")


if __name__ == "__main__":
    main()
