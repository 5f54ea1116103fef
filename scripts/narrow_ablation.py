#!/usr/bin/env python3
"""
Where the fleet-dense kernels' time goes, part by part, on one card.

    python3 scripts/narrow_ablation.py [--wide]

Run from the root of a checkout on a machine with an NVIDIA GPU and
``nvcc``. Builds ``gordo_tpu_torch/ops/csrc/fleet_dense.cu`` four times:
as it is, with ``-DFLEET_DENSE_SKIP_ACTIVATIONS``, with
``-DFLEET_DENSE_SKIP_FMAS`` (the layer sums left out), and with both. The
three reduced builds compute wrong answers on purpose. It then times K1
with CUDA events (``chip_smoke.cuda_ms``) at the hourglass(20) shapes of
``chip_smoke.py``: 1000 x 1008 rows, the served fleet (64 x 1008 with the
ingest prologue), the served anomaly request (1 x 1008, gather and
ingest, indices already on the card), and K2 at the stream flush (64 x
512, ingest, y = X); with ``--wide``, the wide (tensor-core) kernel's
shapes instead: feedforward_model(20) and hourglass(40) at 64 x 1008 and
the 40-tag anomaly request (1 x 1008, gather and ingest), and a fifth
build, ``-DFLEET_DENSE_SKIP_SPLIT``, whose weights are not split into TF32
hi and lo (the cost of that split). Each build is timed twice, in turns. The full
build's time less a reduced build's is that part's cost; what the build
without both keeps is the tile I/O, the staging and the per-row overhead.
Prints one line a build and pass, and the card's name and power limit.
Last it launches the full build at 1000 x 1008 back to back for three
seconds while ``nvidia-smi`` samples the SM clock, power and temperature
every 100 ms, and prints the samples' range: the clock an issue rate is
reckoned at.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = (
    (),
    ("FLEET_DENSE_SKIP_ACTIVATIONS",),
    ("FLEET_DENSE_SKIP_FMAS",),
    ("FLEET_DENSE_SKIP_ACTIVATIONS", "FLEET_DENSE_SKIP_FMAS"),
)
#: with --wide, also the wide kernel without the hi/lo split of its weights
WIDE_VARIANTS = VARIANTS + (("FLEET_DENSE_SKIP_SPLIT",),)


def main(argv=None) -> int:
    wide = "--wide" in (sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from gordo_tpu_torch.models.factories import feedforward_hourglass, feedforward_model
    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    if not torch.cuda.is_available():
        print("narrow_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = chip_smoke.device_line()
    variants = WIDE_VARIANTS if wide else VARIANTS
    _build.build(variants=variants)
    hourglass = feedforward_hourglass(20)
    big = chip_smoke.make_case(hourglass, 1000, 1000, chip_smoke.ROWS)
    fleet = chip_smoke.make_case(hourglass, 64, 64, chip_smoke.ROWS, ingest=True, seed=2)
    anomaly = chip_smoke.make_case(hourglass, 64, 1, chip_smoke.ROWS, indices=[17], ingest=True, seed=3)
    on_card = torch.tensor(anomaly["indices"], dtype=torch.int32, device="cuda")
    flush_X = fleet["X"][:, :512].contiguous()

    def k1(case, indices, defines):
        return lambda: fleet_feedforward(case["spec"], case["bucket"], case["X"], indices, case["ingest"],
                                         defines=defines)

    if wide:
        model = chip_smoke.make_case(feedforward_model(20), 64, 64, chip_smoke.ROWS, seed=1)
        wide_big = chip_smoke.make_case(feedforward_hourglass(40), 64, 64, chip_smoke.ROWS, seed=11)
        wide_anomaly = chip_smoke.make_case(feedforward_hourglass(40), 8, 1, chip_smoke.ROWS, indices=[5],
                                            ingest=True, seed=12)
        wide_on_card = torch.tensor(wide_anomaly["indices"], dtype=torch.int32, device="cuda")

    def shapes(defines):
        if wide:
            return {
                "K1 feedforward_model20 64x1008": k1(model, None, defines),
                "K1 hourglass40 64x1008": k1(wide_big, None, defines),
                "K1 hourglass40 served anomaly 1x1008": k1(wide_anomaly, wide_on_card, defines),
            }
        return {
            "K1 1000x1008": k1(big, None, defines),
            "K1 served fleet 64x1008": k1(fleet, None, defines),
            "K1 served anomaly 1x1008": k1(anomaly, on_card, defines),
            "K2 stream flush 64x512": lambda: fleet_anomaly_scores(
                hourglass, fleet["bucket"], flush_X, flush_X, None, fleet["ingest"], defines=defines),
        }
    for run in range(2):
        for defines in variants:
            ms = {name: chip_smoke.cuda_ms(fn) for name, fn in shapes(defines).items()}
            name = "+".join(defines) or "full"
            print(f"[ablation] pass {run}, {name}: " + ", ".join(f"{k} {v!r} ms" for k, v in ms.items())
                  + f"; {card}", flush=True)
    if wide:
        return 0

    launch = k1(big, None, ())
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3:
            for _ in range(100):
                launch()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    samples = [[float(v) for v in line.split(",")] for line in smi.communicate()[0].splitlines() if line.strip()]
    samples = samples[2:-2] or samples  # drop the ramp at either end
    clock, power, temp = (sorted(column) for column in zip(*samples))
    print(f"[clock] K1 1000x1008 back to back for 3 s: SM clock {clock[0]:.0f}-{clock[-1]:.0f} MHz "
          f"(median {clock[len(clock) // 2]:.0f}), power {power[0]}-{power[-1]} W, {temp[-1]:.0f} C at most, "
          f"{len(samples)} samples; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
