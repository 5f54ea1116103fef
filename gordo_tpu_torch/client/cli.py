"""
The ``client`` command group (``gordo_tpu/client/cli.py``):
``python -m gordo_tpu_torch client --project P [--host H] [--port N]
[--scheme S] [--revision R] [--device D] COMMAND``, the host, port and
scheme also from ``GORDO_CLIENT_HOST``, ``GORDO_CLIENT_PORT`` and
``GORDO_CLIENT_SCHEME``.

- ``metadata [--target NAME ...] [--output-file F]``: every (or each
  listed) machine's metadata as JSON.
- ``download-model OUTPUT_DIR [--target NAME ...]``: each model saved to
  ``OUTPUT_DIR/<name>/`` (loaded on ``--device`` on its way, ``cuda``
  unless ``cpu``).
- ``predict START END [--target NAME ...] [--destination DIR]
  [--parquet/--no-parquet] [--batch-size N] [--parallelism N]
  [--fleet/--per-machine]``: the window through every (or each listed)
  machine, each machine's answer forwarded as parquet into
  ``--destination``; a line a machine, its errors on stderr, exit 1 when
  any machine has one.
"""

import argparse
import json
import os
import sys

from .client import Client
from .forwarders import ForwardPredictionsToDisk


def add_client_parser(commands) -> None:
    """The ``client`` group under the command line's subparsers."""
    group = commands.add_parser("client", help="interact with a deployed project")
    group.add_argument("--project", required=True, help="the project's name")
    group.add_argument("--host", default=os.environ.get("GORDO_CLIENT_HOST", "localhost"))
    group.add_argument("--port", type=int, default=int(os.environ.get("GORDO_CLIENT_PORT", "443")))
    group.add_argument("--scheme", default=os.environ.get("GORDO_CLIENT_SCHEME", "https"))
    group.add_argument("--revision", default=None, help="pin to a model revision")
    group.add_argument("--device", default="cuda", help="where download-model loads the models: cuda (default) "
                       "or cpu")
    client_commands = group.add_subparsers(dest="client_command", required=True)
    metadata = client_commands.add_parser("metadata", help="every (or each listed) machine's metadata as JSON")
    metadata.add_argument("--target", action="append", default=[], help="limit to this machine (repeatable)")
    metadata.add_argument("--output-file", default=None, help="write the JSON here instead of stdout")
    download = client_commands.add_parser("download-model", help="save the served models into OUTPUT_DIR/<name>/")
    download.add_argument("output_dir")
    download.add_argument("--target", action="append", default=[])
    predict = client_commands.add_parser("predict", help="replay [START, END] through the deployed machines")
    predict.add_argument("start")
    predict.add_argument("end")
    predict.add_argument("--target", action="append", default=[])
    predict.add_argument("--destination", default=None, help="forward each machine's predictions as parquet here")
    predict.add_argument("--parquet", action=argparse.BooleanOptionalAction, default=True,
                         help="parquet wire format (default; --no-parquet: JSON)")
    predict.add_argument("--batch-size", type=int, default=100000)
    predict.add_argument("--parallelism", type=int, default=10)
    predict.add_argument("--fleet", dest="fleet", action="store_true", default=False,
                         help="score through the fleet route (full anomaly frames, one launch a bucket)")
    predict.add_argument("--per-machine", dest="fleet", action="store_false",
                         help="one anomaly request a machine (default)")


def _client(args: argparse.Namespace, **extra) -> Client:
    return Client(project=args.project, host=args.host, port=args.port, scheme=args.scheme, revision=args.revision,
                  device=args.device, **extra)


def client_main(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    """Run a ``client`` command; its exit code."""
    from .. import serializer

    command = args.client_command
    if command == "metadata":
        payload = _client(args).get_metadata(args.target or None)
        if args.output_file:
            with open(args.output_file, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        else:
            json.dump(payload, sys.stdout, indent=2, default=str)
            sys.stdout.flush()
        return 0
    if command == "download-model":
        if not os.path.isdir(args.output_dir):
            parser.error(f"OUTPUT_DIR: directory {args.output_dir!r} does not exist")
        for name, model in _client(args).download_model(args.target or None).items():
            out = f"{args.output_dir}/{name}"
            serializer.dump(model, out)
            print(f"Saved {name} to {out}", flush=True)
        return 0
    forwarder = ForwardPredictionsToDisk(args.destination) if args.destination else None
    client = _client(args, prediction_forwarder=forwarder, use_parquet=args.parquet, batch_size=args.batch_size,
                     parallelism=args.parallelism)
    target = args.target or None
    if args.fleet:
        results = list(client.fleet_anomaly_scores(args.start, args.end, target, full=True).values())
    else:
        results = client.predict(args.start, args.end, target)
    failed = False
    for result in results:
        n = len(result.predictions.index) if result.predictions is not None else 0
        print(f"{result.name}: {n} rows, {len(result.error_messages)} errors", flush=True)
        for msg in result.error_messages:
            failed = True
            print(f"  {msg}", file=sys.stderr)
    return 1 if failed else 0
