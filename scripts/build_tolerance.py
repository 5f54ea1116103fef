#!/usr/bin/env python3
"""
How far ``chip_smoke.py``'s card-against-CPU build check sits from a
wrong build.

    python3 scripts/build_tolerance.py

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds
``chip_smoke.CPU_CHECK`` (two 20-tag and two 40-tag machines: the smoke's
definition, rows and seeds) on the CPU, then three times on the card, and
holds each card build to the CPU's with ``chip_smoke.compare_builds``:

- ``sound``: full f32, as the smoke builds;
- ``tf32``: TF32 allowed for matmuls, the precision setting the build
  must keep off;
- ``swap``: in every member's last epoch, the first and the last row of
  its permutation exchanged (an injected random source): one row trained
  in another batch, the smallest change to what a member sees.

Prints one line a build: the largest params, thresholds and CV score
differences beside the smoke's limits, and how many of its checks
failed; then the card's name and power limit. Exits non-zero if the
sound build fails the check.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

    machines = [m for m in chip_smoke.served_machines() if m.name in chip_smoke.CPU_CHECK]
    cpu, cpu_s = chip_smoke.build_summaries(machines, "cpu")
    sound_faults = None
    for label, tf32, random in (("sound", False, None), ("tf32", True, None), ("swap", False, Swapped())):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            card, card_s = chip_smoke.build_summaries(machines, "cuda", random)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        worst, faults = chip_smoke.compare_builds(card, cpu)
        if label == "sound":
            sound_faults = faults
        print(f"[tolerance] {label}: card build of {', '.join(chip_smoke.CPU_CHECK)} in {card_s:.2f} s against "
              f"the CPU's ({cpu_s:.2f} s): params max abs {worst[0]!r} (limit {chip_smoke.BUILD_PARAM_ATOL}), "
              f"thresholds max rel {worst[1]!r} (limit {chip_smoke.BUILD_THRESHOLD_RTOL}), CV scores max "
              f"|d| / (1 + |cpu|) {worst[2]!r} (limit {chip_smoke.BUILD_SCORE_TOL}); {len(faults)} checks "
              f"failed: {faults[:3]}", flush=True)
    print(chip_smoke.device_line(), flush=True)
    if sound_faults:
        raise SystemExit("the sound build failed the check")


if __name__ == "__main__":
    main()
