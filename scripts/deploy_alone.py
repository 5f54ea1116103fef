#!/usr/bin/env python3
"""
``chip_smoke.py``'s ``[deploy]`` phase alone, with what it needs before it.

    python3 scripts/deploy_alone.py

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds
the kernel library, runs ``[train]`` (its 72 machines and their
collection), then ``deploy_phase`` with every check of the smoke's, and
holds each engine batch of the burst to the plain version at the shape
its ``serve_batch`` span recorded (timed beside it). The servers' logs
land in ``chiprun_out/``. About three minutes, most of them ``nvcc``.
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gordo_tpu_torch.models.factories import feedforward_hourglass
    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.server import build_app

    card = cs.device_line()
    print("[device]", card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build(variants=((),))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    os.environ["GORDO_TPU_STREAM_WINDOW_ROWS"] = str(cs.STREAM_WINDOW)
    os.environ["EXPECTED_MODELS"] = cs.EXPECTED_MODELS
    build_dir = os.path.join(HERE, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        collection = os.path.join(work_dir, cs.REVISION)
        with cs.clocked("train"):
            names, wide_names, *_ = cs.train_phase(work_dir, collection)
        cpu_app = build_app(collection, device="cpu")
        with cs.clocked("deploy"):
            launches, _ = cs.deploy_phase(work_dir, collection, names, wide_names, cpu_app, card)
        print("[deploy launches]", launches["server"], launches["score"], flush=True)
        batches = {}
        for _, members, rows, riders in launches["server"]["engine_batches"]:
            batches.setdefault(cs.DEPLOY_ENGINE_CASE.format(M=members, B=rows), [0, riders, members, rows])[0] += 1
        for i, (name, (n, riders, members, rows)) in enumerate(sorted(batches.items())):
            case = cs.make_case(feedforward_hourglass(20), cs.SERVED_MACHINES, members, rows,
                                indices=[names.index(r) for r in riders], ingest=True, seed=92 + i)
            print("[engine batch]", name, "launches", n, "err", cs.compare(case), "times", cs.times(case),
                  flush=True)
        out = os.path.join(HERE, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        for log in ("deploy-workers.log", "deploy-engine.log", "deploy-one.log"):
            src = os.path.join(work_dir, log)
            if os.path.exists(src):
                with open(src) as f, open(os.path.join(out, log), "w") as g:
                    g.write(f.read())
    print("DEPLOY ALONE OK", flush=True)


if __name__ == "__main__":
    main()
