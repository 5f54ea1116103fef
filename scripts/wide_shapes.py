#!/usr/bin/env python3
"""
K1 and K2 at the wide kernel's shapes, timed with the package of a given
checkout, so that two commits compare at shapes only one of them times.

    python3 scripts/wide_shapes.py [TREE]

``TREE`` (default: this checkout) is the root of a checkout with its own
``chip_smoke.py`` and ``gordo_tpu_torch``; both are imported from there,
and its kernels are built into its own ``build/`` if they are not. Times
K1 and K2 (y = X) with ``chip_smoke.cuda_ms`` at feedforward_model(20)
and hourglass(40), 64 x 1008 rows, and at the 40-tag served anomaly
request (1 x 1008, gather and ingest), and prints one line a shape with
the card's name and power limit. Needs an NVIDIA GPU.
"""

import os
import sys


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(args[0] if args else os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from gordo_tpu_torch.models.factories import feedforward_hourglass, feedforward_model
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    if not torch.cuda.is_available():
        print("wide_shapes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = chip_smoke.device_line()
    rows = chip_smoke.ROWS
    shapes = {
        "feedforward_model20 M=64 B=1008": chip_smoke.make_case(feedforward_model(20), 64, 64, rows, seed=1),
        "hourglass40 M=64 B=1008": chip_smoke.make_case(feedforward_hourglass(40), 64, 64, rows, seed=11),
        "served anomaly: hourglass40 gather M=1 B=1008 +ingest": chip_smoke.make_case(
            feedforward_hourglass(40), 8, 1, rows, indices=[5], ingest=True, seed=12),
    }
    for name, case in shapes.items():
        args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
        k1 = chip_smoke.cuda_ms(lambda: fleet_feedforward(*args))
        k2 = chip_smoke.cuda_ms(lambda: fleet_anomaly_scores(*args[:3], case["X"], *args[3:]))
        print(f"[wide shapes] {os.path.basename(tree)} {name}: K1 {k1!r} ms, K2 (y=X) {k2!r} ms; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
