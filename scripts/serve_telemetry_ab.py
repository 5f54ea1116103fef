#!/usr/bin/env python3
"""
What the serving telemetry costs a request on the card: the same
requests with telemetry on and off, alternated.

    python3 scripts/serve_telemetry_ab.py [PAIRS]

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds
``chip_smoke.py``'s served collection on the card (its 64 20-tag and 8
40-tag machines, its definition and rows), serves it from one app over a
localhost socket and an engine app beside it, and sends
``chip_smoke.py [observability]``'s requests (three 20-tag anomaly
requests, the fleet request of 64, a 40-tag anomaly request, the fleet
request of 8, two ingests of 64 rows a machine on a stream, a burst of 8
anomaly requests through the engine) once to warm up, then PAIRS times
(default 3) with telemetry on (``GORDO_TPU_TELEMETRY_DIR`` set, every
request exported) and off (``GORDO_TPU_TELEMETRY=0``), in the order on,
off in odd pairs and off, on in even ones. Prints each pass's wall
seconds and its requests' ``Server-Timing`` summed by stage, then each
mode's mean and the card's name and power limit.
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_pass(base, engine_base, requests, burst_requests):
    """The requests in order, then the burst: ``(wall seconds, {stage: ms})``."""
    import chip_smoke

    stages = {}
    t0 = time.perf_counter()
    for path, payload in requests:
        status, _, headers, _ = chip_smoke.traced_request(base + path, "POST", payload)
        chip_smoke.check(status == 200, f"{path} answered {status}")
        for name, ms in chip_smoke.server_timing(headers)[0].items():
            stages[name] = stages.get(name, 0.0) + ms
    answers, _ = chip_smoke.burst(engine_base, burst_requests)
    chip_smoke.check(all(status == 200 for status, _, _ in answers), "a burst request failed")
    return time.perf_counter() - t0, stages


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.parallel.fleet_build import fleet_build
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.telemetry import serving

    if not torch.cuda.is_available():
        raise SystemExit("serve_telemetry_ab.py needs an NVIDIA GPU")
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    card = chip_smoke.device_line()
    _build.build()
    os.environ["GORDO_TPU_STREAM_WINDOW_ROWS"] = str(chip_smoke.STREAM_WINDOW)
    os.environ["GORDO_TPU_TRACE_SAMPLE_RATE"] = "1"
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        collection = os.path.join(work, chip_smoke.REVISION)
        fleet_build(chip_smoke.served_machines(), output_dir=collection, device="cuda")
        os.environ["GORDO_TPU_TELEMETRY_DIR"] = os.path.join(work, "telemetry")
        app = build_app(collection, device="cuda")
        app.store.fleet().warm()
        engine, _ = chip_smoke.engine_app(collection, max_size=chip_smoke.OBS_BURST, max_delay_ms=20000.0,
                                          deadline_ms=60000.0)
        base, stop = chip_smoke.serving(app)
        engine_base, stop_engine = chip_smoke.serving(engine)
        names = [f"machine-{i:03d}" for i in range(chip_smoke.SERVED_MACHINES)]
        wide_names = [f"compressor-{i:03d}" for i in range(chip_smoke.WIDE_MACHINES)]
        burst_requests = [(f"/{n}/anomaly/prediction", chip_smoke.engine_body("anomaly", chip_smoke.own_frame(n, 20)))
                          for n in names[:chip_smoke.OBS_BURST]]
        walls = {"on": [], "off": []}
        try:
            modes = ["warm-up"] + [m for p in range(pairs) for m in (("on", "off") if p % 2 == 0 else ("off", "on"))]
            for i, mode in enumerate(modes):
                os.environ["GORDO_TPU_TELEMETRY"] = "0" if mode == "off" else "1"
                serving.reset_serve_recorder()
                requests = chip_smoke.observability_requests(names, wide_names,
                                                             first_row=2 * i * chip_smoke.OBS_STREAM_ROWS)
                wall, stages = one_pass(base, engine_base, requests, burst_requests)
                if mode != "warm-up":
                    walls[mode].append(wall)
                print(f"[telemetry ab] pass {i} ({mode}): {wall:.3f} s; stages summed: "
                      + ", ".join(f"{name} {ms:.1f}" for name, ms in stages.items()) + f" ms; {card}", flush=True)
        finally:
            stop()
            stop_engine()
            engine.shutdown()
            serving.reset_serve_recorder()
        for mode, values in walls.items():
            print(f"[telemetry ab] {mode}: mean {sum(values) / len(values):.3f} s over {len(values)} passes "
                  f"({', '.join(f'{v:.3f}' for v in values)}); {card}", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
