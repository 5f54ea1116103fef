#!/usr/bin/env python3
"""
Where a stacked training step's time goes on one card.

    python3 scripts/train_profile.py [OUT_DIR]

Run from the root of a checkout on a machine with an NVIDIA GPU. Makes
the training step of ``chip_smoke.py``'s ``[train]`` buckets with
``chip_smoke.make_step`` (feedforward_hourglass, Adam, batch 32, TF32
off): the 20-tag CV bucket (192 members), the 40-tag one (24) and the
20-tag final fit (64), on seeded rows; and of its ``[lstm]`` CV buckets
with ``chip_smoke.lstm_step`` (the windowed step, 32 windows of 10 rows
gathered on the card a member): lstm_hourglass (24 members),
lstm_symmetric (12) and lstm_model (12). For each:

- times one ``StackedFit.train_step`` three ways: the host clock over 50
  steps ending in a synchronise, CUDA events around the same 50, and
  ``chip_smoke.step_device_ms`` (one step queued behind a device sleep:
  the device's own time a step), and for comparison ``chip_smoke.cuda_ms``
  over 50 queued steps, more launches than the card's queue holds (the
  host then paces the device, and the number reads as the host's);
- runs 10 steps under ``torch.profiler`` (CPU and CUDA) and prints the
  kernels' device time a step, the operators with the most of it, the
  kernel launches and on-card copies a step, and the host calls that
  wait for the device (synchronise, scalar reads; the profiler's own
  two synchronises included).

Prints one block a bucket and the card's name and power limit; writes
each profiler table to ``OUT_DIR`` (default ``build/train_profile``).
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (("20-tag CV bucket", 20, 192), ("40-tag CV bucket", 40, 24), ("20-tag final fit", 20, 64))
STEPS = 50


def lstm_spec(kwargs):
    """The spec an ``[lstm]`` group's estimator kwargs make for 20 tags."""
    from gordo_tpu_torch.models import factories

    kwargs = dict(kwargs)
    return getattr(factories, kwargs.pop("kind"))(20, **kwargs)


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("train_profile.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "build", "train_profile")
    os.makedirs(out_dir, exist_ok=True)
    card = chip_smoke.device_line()
    buckets = [(f"{label} ({members} members x 32 rows, hourglass({n_features}))",
                f"{n_features}_{members}", lambda n=n_features, m=members: chip_smoke.make_step(n, m))
               for label, n_features, members in BUCKETS]
    for prefix, count, path, kwargs, _ in chip_smoke.LSTM_GROUPS:
        spec = lstm_spec(kwargs)
        buckets.append((f"{prefix} CV bucket ({3 * count} members x 32 windows, dims {spec.dims})",
                        f"{prefix}_{3 * count}", lambda s=spec, m=3 * count: chip_smoke.lstm_step(s, m)))
    for label, stem, make in buckets:
        step = make()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(STEPS):
            step()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        event_ms = start.elapsed_time(end) / STEPS
        device_ms = chip_smoke.step_device_ms(step)
        queued_ms = chip_smoke.cuda_ms(step, iters=STEPS)

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        on_card = torch.autograd.DeviceType.CUDA
        # kernels carry the device time; operators repeat it as theirs
        device_total = sum(e.self_device_time_total for e in averages if e.device_type == on_card)
        launches = sum(e.count for e in averages if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        copies = sum(e.count for e in averages if e.key.startswith("cudaMemcpy"))
        waits = {e.key: e.count for e in averages
                 if any(w in e.key for w in ("Synchronize", "_local_scalar_dense", "aten::item"))}
        table = averages.table(sort_by="self_device_time_total", row_limit=25)
        with open(os.path.join(out_dir, f"train_profile_{stem}.txt"), "w") as f:
            f.write(table)
        print(f"[profile] {label}: host clock "
              f"{host_ms:.3f} ms a step, CUDA events {event_ms:.3f}, device alone {device_ms:.3f} (50 queued: "
              f"{queued_ms:.3f}); profiler: "
              f"{device_total / 10 / 1e3:.3f} ms of kernel time a step, {launches / 10:.0f} kernel launches and "
              f"{copies / 10:.0f} copies a step, waiting calls over the 10 steps {waits}; {card}", flush=True)
        ops = [e for e in averages if e.device_type != on_card]
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"[profile]   {e.key[:60]}: {e.self_device_time_total / 10 / 1e3:.3f} ms a step "
                  f"over {e.count // 10} calls", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
