#!/usr/bin/env python3
"""
Where the segmented LSTM fit's card-against-CPU distance comes from.

    python3 scripts/segmented_precision.py

Run from the root of a checkout on a machine with an NVIDIA GPU, TF32
off. Prints:

- each ``baddbmm`` of one lstm_model(20) update (the input projection,
  the recurrence, the head; forward shapes) at the segmented fit's rows
  (G = 4 segments, a span of 17) and the windowed fit's (32 windows of
  10): the largest error relative to the largest output, f32 on the card
  and f32 on the CPU, each against the same product in f64;
- one machine of ``chip_smoke.py [lstm]``'s lstm_model group (its rows,
  seed and MinMax scaling; 1 epoch, batch 32) fitted segmented and
  windowed, from the same params, in f32 on the card, in f32 on the CPU
  and in f64 on the CPU (``compute_dtype`` float64, params f64): the
  params' largest abs distance of each f32 fit from the f64 one and from
  each other.

Then the card's name and power limit.
"""

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gemm_errors(rows, k, n, seed=0):
    """``(card rel error, CPU rel error)`` of ``baddbmm(b, A[1, rows, k], W[1, k, n])``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    A, W, b = (torch.rand(*shape, generator=gen, dtype=torch.float64) - 0.5
               for shape in ((1, rows, k), (1, k, n), (1, 1, n)))
    exact = torch.baddbmm(b, A, W)
    scale = float(exact.abs().max())
    out = []
    for device in ("cuda", "cpu"):
        got = torch.baddbmm(*(t.float().to(device) for t in (b, A, W))).double().cpu()
        out.append(float((got - exact).abs().max()) / scale)
    return out


def fit(spec, kind, device, dtype, series, init):
    import torch

    from gordo_tpu_torch.models.training import FitConfig, SegmentedFit, WindowedFit

    config = FitConfig(epochs=1, batch_size=32, shuffle=False)
    spec = dataclasses.replace(spec, compute_dtype="float64") if dtype == torch.float64 else spec
    params = {k: {n: torch.as_tensor(t)[None].to(device, dtype).clone() for n, t in layer.items()}
              for k, layer in init.items()}
    s = series.to(device, dtype)
    targets = s[:, spec.lookback_window - 1:]
    nw = targets.shape[1]
    nv = -(-nw // 32) * 32
    wtr = torch.zeros(1, nv, device=device, dtype=dtype)
    wtr[:, :nw] = 1.0
    if kind == "segmented":
        out = SegmentedFit(spec, config, 4).run(params, s, targets, wtr, torch.zeros_like(wtr))
    else:
        order = torch.arange(nv, device=device).clamp(max=nw - 1)[None]
        out = WindowedFit(spec, config).run(params, s, targets, order, wtr, torch.zeros_like(wtr), None)
    return {k: {n: t[0].double().cpu() for n, t in layer.items()} for k, layer in out.params.items()}


def distance(a, b):
    return max(float((a[k][n] - b[k][n]).abs().max()) for k, layer in a.items() for n in layer)


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke
    from gordo_tpu_torch.models.factories import lstm_model
    from gordo_tpu_torch.models.training import TorchRandom

    if not torch.cuda.is_available():
        raise SystemExit("segmented_precision.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = lstm_model(20, lookback_window=10)
    widths = spec.widths()
    for label, steps, rows in (("segmented", 17, 4), ("windowed", 10, 32)):
        for i, (f_in, h) in enumerate(zip(widths[:-2], widths[1:-1])):
            for name, shape in (("input projection", (steps * rows, f_in, 4 * h)), ("recurrence", (rows, h, 4 * h))):
                card, cpu = gemm_errors(*shape, seed=i)
                print(f"[precision] {label} layer {i} {name} {shape}: card f32 {card:.3e}, CPU f32 {cpu:.3e} "
                      f"(max error / max |product|, against f64)", flush=True)
        card, cpu = gemm_errors(steps * rows if label == "segmented" else rows, widths[-2], widths[-1])
        print(f"[precision] {label} head: card f32 {card:.3e}, CPU f32 {cpu:.3e}", flush=True)

    machines, _ = chip_smoke.lstm_machines()
    name, _, values = next(m for m in machines if m[0] == "lstm-model-000")
    lo, hi = values.min(axis=0), values.max(axis=0)
    series = torch.from_numpy(((values - lo) / np.where(hi > lo, hi - lo, 1.0)).astype(np.float32))[None]
    init = TorchRandom().init_params(spec, 1)
    for kind in ("segmented", "windowed"):
        exact = fit(spec, kind, "cpu", torch.float64, series, init)
        card = fit(spec, kind, "cuda", torch.float32, series, init)
        cpu = fit(spec, kind, "cpu", torch.float32, series, init)
        print(f"[precision] {kind} fit of {name}'s rows (lstm_model(20), 1 epoch): params max abs from the f64 fit: "
              f"card f32 {distance(card, exact):.3e}, CPU f32 {distance(cpu, exact):.3e}; card from CPU "
              f"{distance(card, cpu):.3e}", flush=True)
    print(chip_smoke.device_line(), flush=True)


if __name__ == "__main__":
    main()
