"""``python -m gordo_tpu_torch.server``: serve ``MODEL_COLLECTION_DIR``;
with ``ENABLE_PROMETHEUS`` set, also its metrics on ``--metrics-port``."""

import argparse
import logging

from .app import run_server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_tpu_torch.server",
        description="Serve the model collection in $MODEL_COLLECTION_DIR.",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--metrics-port", type=int, default=9090,
                        help="where /metrics answers while ENABLE_PROMETHEUS is set (default 9090, the sidecar's "
                             "port; 0 picks a free one)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    run_server(host=args.host, port=args.port, device=args.device, metrics_port=args.metrics_port)


if __name__ == "__main__":
    main()
