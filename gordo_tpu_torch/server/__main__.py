"""``python -m gordo_tpu_torch.server``: serve ``MODEL_COLLECTION_DIR`` from
one forked worker; with ``ENABLE_PROMETHEUS`` set, the master answers its
metrics on ``--metrics-port``. ``run-server`` takes ``--workers`` and
``--threads``."""

import argparse
import logging
import sys

from .app import run_server


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_tpu_torch.server",
        description="Serve the model collection in $MODEL_COLLECTION_DIR.",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--metrics-port", type=int, default=9090,
                        help="where the master answers /metrics while ENABLE_PROMETHEUS is set (default 9090; 0 "
                             "picks a free one)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    return run_server(host=args.host, port=args.port, device=args.device, metrics_port=args.metrics_port)


if __name__ == "__main__":
    sys.exit(main())
