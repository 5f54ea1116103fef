"""
The deploy pod's commands (``gordo_tpu/cli/cli.py:247-420`` and
``:1409-1758``), with the JAX commands' options, environment variables,
messages and exit codes: an error prints ``Error: <message>`` on stderr
and exits 1, a missing argument exits 2.

- ``run-server``: the JAX command's gunicorn server as the port's own
  pre-fork master (``server/prefork.py``; the card's machine has no
  gunicorn): ``--workers`` processes (``GORDO_SERVER_WORKERS``, default 2,
  1-4), each with its own app and CUDA context, answering at most
  ``--threads`` requests at once (``--worker-class gthread``; ``sync``
  answers one; any other class is served as ``gthread``, with one log
  line). With ``ENABLE_PROMETHEUS`` the master answers ``/metrics`` on
  ``--metrics-port`` from every worker's files
  (``PROMETHEUS_MULTIPROC_DIR``, a private directory when unset);
  ``--with-prometheus-config`` marks a dead worker's live gauges dead, as
  the JAX config module does. The batching options travel as the
  ``GORDO_TPU_*`` variables, as in JAX. ``--worker-connections`` and
  ``--server-app`` are gunicorn's: accepted and ignored, with one log
  line. The port adds ``--device``, ``--metrics-port`` and
  ``--drain-grace-s`` (``GORDO_TPU_DRAIN_GRACE_S``, default 0: the seconds
  a drain keeps answering before the socket closes). SIGTERM or SIGINT
  drains every worker and exits 0; a worker that cannot boot (no card,
  a kernel that fails) exits the command with 3.
- ``wait-for-models MODELS_DIR``: until every ``--name`` (default the
  ``EXPECTED_MODELS`` YAML list) has its ``metadata.json``; the timeout's
  message names the missing models.
- ``score MODEL_DIR OUTPUT``: a window of rows (``--input``, a CSV or
  parquet file; or ``--start``/``--end`` re-pointing the machine's own
  dataset) through a built model, written as one parquet file of flat
  pipe-joined columns: the anomaly frame (``--anomaly``, the default, for
  a detector) or the raw prediction (``--predict-only``). On the card
  (``--device``, ``cuda`` unless ``cpu``) a feedforward model scores with
  one K1 launch; a windowed model's long series takes the ring predict
  (``parallel/sequence.py``).
- ``ensure-single-workflow MODELS_ROOT REVISION [--check-only]``: the
  single-deployer guard on the shared model volume, ``deploy.lock``
  under a guard directory (:func:`ensure_single_workflow`).
- ``cleanup-revisions MODELS_ROOT CURRENT_REVISION [--keep N]
  [--dry-run]``: old revisions deleted, ordered numerically, the newest
  ``--keep`` and the current one kept; a failed delete fails the command.
"""

import argparse
import datetime
import json
import logging
import os
import secrets
import shutil
import sys
import tempfile
import time
from typing import List, Optional, Sequence

from ..utils import yaml_lite

logger = logging.getLogger(__name__)

#: the gunicorn options the pre-fork server accepts and ignores
GUNICORN_OPTIONS = ("worker_connections", "server_app")
LOCK_FILE = "deploy.lock"
GUARD = ".deploy.guard"
#: seconds before a guard counts as a crashed holder's, and the wait for the guard
STALE_GUARD_S = 300
ACQUIRE_TIMEOUT_S = 60


def _fail(message: str) -> int:
    print(f"Error: {message}", file=sys.stderr, flush=True)
    return 1


def _int_range(low: int, high: int):
    def parse(text: str) -> int:
        value = int(text)
        if not low <= value <= high:
            raise argparse.ArgumentTypeError(f"{value} is not in the range {low}<=x<={high}")
        return value
    return parse


def _float_range(low: float, high: float):
    def parse(text: str) -> float:
        value = float(text)
        if not low <= value <= high:
            raise argparse.ArgumentTypeError(f"{value} is not in the range {low}<=x<={high}")
        return value
    return parse


def add_parsers(commands) -> None:
    """The deploy commands under the command line's subparsers."""
    server = commands.add_parser("run-server", help="run the model server (a pre-fork master and its workers)")
    server.add_argument("--host", default=os.environ.get("GORDO_SERVER_HOST", "0.0.0.0"))
    server.add_argument("--port", type=_int_range(0, 65535), default=int(os.environ.get("GORDO_SERVER_PORT", 5555)),
                        help="the port the master binds (0 picks a free one, which its log names) "
                             "[GORDO_SERVER_PORT, 5555]")
    server.add_argument("--workers", type=_int_range(1, 4), default=int(os.environ.get("GORDO_SERVER_WORKERS", 2)),
                        help="worker processes the master forks [GORDO_SERVER_WORKERS, 2]")
    server.add_argument("--worker-connections", type=_int_range(1, 4000),
                        default=int(os.environ.get("GORDO_SERVER_WORKER_CONNECTIONS", 50)), help="gunicorn's; ignored")
    server.add_argument("--threads", type=int, default=int(os.environ.get("GORDO_SERVER_THREADS", 8)),
                        help="requests a gthread worker answers at once [GORDO_SERVER_THREADS, 8]")
    server.add_argument("--worker-class", default=os.environ.get("GORDO_SERVER_WORKER_CLASS", "gthread"),
                        help="gthread (threads a worker) or sync (one request at a time); any other is served as "
                             "gthread [GORDO_SERVER_WORKER_CLASS, gthread]")
    server.add_argument("--log-level", dest="server_log_level",
                        choices=("debug", "info", "warning", "error", "critical"),
                        default=os.environ.get("GORDO_SERVER_LOG_LEVEL", "debug"), help="the server's log level")
    server.add_argument("--server-app", default=os.environ.get("GORDO_SERVER_APP", "gordo_tpu.server.app:build_app()"),
                        help="gunicorn's; ignored")
    server.add_argument("--with-prometheus-config", action="store_true",
                        help="mark a dead worker's live gauges dead in the metrics directory")
    server.add_argument("--batching", action=argparse.BooleanOptionalAction, default=None,
                        help="coalesce concurrent requests into batches (default $GORDO_TPU_BATCHING, off)")
    server.add_argument("--batch-max-size", type=_int_range(1, 4096), default=None,
                        help="requests a batch before it flushes [GORDO_TPU_BATCH_MAX_SIZE, 32]")
    server.add_argument("--batch-max-delay-ms", type=_float_range(0.0, 60000.0), default=None,
                        help="longest a request waits for company [GORDO_TPU_BATCH_MAX_DELAY_MS, 5]")
    server.add_argument("--batch-queue-depth", type=_int_range(1, 1 << 20), default=None,
                        help="queued requests before 429 [GORDO_TPU_BATCH_QUEUE_DEPTH, 512]")
    server.add_argument("--batch-deadline-ms", type=_float_range(1.0, 600000.0), default=None,
                        help="a request's deadline before 504 [GORDO_TPU_BATCH_DEADLINE_MS, 2000]")
    server.add_argument("--batch-row-ladder", default=None,
                        help="comma-separated row rungs [GORDO_TPU_BATCH_ROW_LADDER, 32,128,512,2048,8192]")
    server.add_argument("--serve-warmup", action=argparse.BooleanOptionalAction, default=None,
                        help="warm the served buckets at start [GORDO_TPU_SERVE_WARMUP, on with batching]")
    server.add_argument("--serve-precision", choices=("f32", "bf16", "int8"), default=None,
                        help="the batches' precision [GORDO_TPU_SERVE_PRECISION, f32]")
    server.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    server.add_argument("--metrics-port", type=int, default=9090,
                        help="where the master answers /metrics while ENABLE_PROMETHEUS is set (0 picks a free "
                             "port)")
    server.add_argument("--drain-grace-s", type=_float_range(0.0, 600.0),
                        default=float(os.environ.get("GORDO_TPU_DRAIN_GRACE_S", 0.0)),
                        help="seconds a drain keeps answering (healthcheck 503) before the socket closes "
                             "[GORDO_TPU_DRAIN_GRACE_S, 0]")

    wait = commands.add_parser("wait-for-models", help="block until the named models' artifacts exist")
    wait.add_argument("models_dir", nargs="?", default=os.environ.get("MODELS_DIR"))
    wait.add_argument("--name", dest="names", action="append", default=[],
                      help="a model to wait for (repeatable; default $EXPECTED_MODELS)")
    wait.add_argument("--timeout", type=int, default=int(os.environ.get("WAIT_TIMEOUT", 3600)))
    wait.add_argument("--poll-interval", type=int, default=10)

    score_ = commands.add_parser("score", help="score a window of rows with a built model, into parquet")
    score_.add_argument("model_dir")
    score_.add_argument("output")
    score_.add_argument("--input", dest="input_path", default=None,
                        help="a parquet or CSV file of sensor columns (before --start/--end)")
    score_.add_argument("--start", default=None, help="the window's start (ISO time)")
    score_.add_argument("--end", default=None, help="the window's end (ISO time)")
    score_.add_argument("--anomaly", dest="with_anomaly", action="store_true", default=True,
                        help="the anomaly frame of a detector (default)")
    score_.add_argument("--predict-only", dest="with_anomaly", action="store_false", help="the raw prediction")
    score_.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    lock = commands.add_parser("ensure-single-workflow", help="the single-deployer guard on the model volume")
    lock.add_argument("models_root", nargs="?", default=os.environ.get("MODELS_ROOT"))
    lock.add_argument("revision", nargs="?", default=os.environ.get("PROJECT_REVISION"))
    lock.add_argument("--check-only", action="store_true", help="verify the lock without acquiring it")

    cleanup = commands.add_parser("cleanup-revisions", help="delete old model revisions")
    cleanup.add_argument("models_root", nargs="?", default=os.environ.get("MODELS_ROOT"))
    cleanup.add_argument("current_revision", nargs="?", default=os.environ.get("PROJECT_REVISION"))
    cleanup.add_argument("--keep", type=int, default=3, help="the newest revisions kept (the current one always is)")
    cleanup.add_argument("--dry-run", action="store_true")


def main(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    """Run a deploy command; its exit code."""
    command = args.command
    if command == "run-server":
        return run_server_command(args)
    if command == "wait-for-models":
        if not args.models_dir:
            parser.error("MODELS_DIR is required (argument or $MODELS_DIR)")
        return wait_for_models(args.models_dir, args.names, args.timeout, args.poll_interval)
    if command == "score":
        for option, path, is_dir in (("MODEL_DIR", args.model_dir, True), ("--input", args.input_path, False)):
            if path is not None and not (os.path.isdir(path) if is_dir else os.path.exists(path)):
                parser.error(f"{option}: {path!r} does not exist")
        return score(args.model_dir, args.output, args.input_path, args.start, args.end, args.with_anomaly,
                     args.device)
    if not args.models_root:
        parser.error("MODELS_ROOT is required (argument or $MODELS_ROOT)")
    if command == "ensure-single-workflow":
        if not args.revision:
            parser.error("REVISION is required (argument or $PROJECT_REVISION)")
        return ensure_single_workflow(args.models_root, args.revision, args.check_only)
    if not args.current_revision:
        parser.error("CURRENT_REVISION is required (argument or $PROJECT_REVISION)")
    return cleanup_revisions(args.models_root, args.current_revision, args.keep, args.dry_run)


# -- run-server ------------------------------------------------------------------------


def run_server_command(args: argparse.Namespace) -> int:
    """``run-server``: the batching options into the environment, then the
    pre-fork master and its workers until a signal drains them; the
    master's exit code."""
    from ..server.app import run_server

    for name, value in (
        ("GORDO_TPU_BATCHING", None if args.batching is None else int(args.batching)),
        ("GORDO_TPU_BATCH_MAX_SIZE", args.batch_max_size),
        ("GORDO_TPU_BATCH_MAX_DELAY_MS", args.batch_max_delay_ms),
        ("GORDO_TPU_BATCH_QUEUE_DEPTH", args.batch_queue_depth),
        ("GORDO_TPU_BATCH_DEADLINE_MS", args.batch_deadline_ms),
        ("GORDO_TPU_BATCH_ROW_LADDER", args.batch_row_ladder),
        ("GORDO_TPU_SERVE_WARMUP", None if args.serve_warmup is None else int(args.serve_warmup)),
        ("GORDO_TPU_SERVE_PRECISION", args.serve_precision),
    ):
        if value is not None:
            os.environ[name] = str(value)
    logging.getLogger().setLevel(args.server_log_level.upper())
    logger.warning("gunicorn is not used: the port's pre-fork master serves; %s are ignored",
                   ", ".join(f"--{name.replace('_', '-')}" for name in GUNICORN_OPTIONS))
    return run_server(args.host, args.port, device=args.device, metrics_port=args.metrics_port,
                      drain_grace_s=args.drain_grace_s, workers=args.workers, threads=args.threads,
                      worker_class=args.worker_class, prometheus_config=args.with_prometheus_config)


# -- wait-for-models -------------------------------------------------------------------


def wait_for_models(models_dir: str, names: Sequence[str] = (), timeout: int = 3600, poll_interval: int = 10) -> int:
    """``wait-for-models``: poll until every name's ``metadata.json``
    exists under ``models_dir``; exit 1 naming (up to 10 of) the missing
    ones after ``timeout`` seconds."""
    if not names:
        names = tuple(yaml_lite.safe_load(os.getenv("EXPECTED_MODELS", "[]")) or ())
    if not names:
        return _fail("No model names given (--name / EXPECTED_MODELS)")
    deadline = time.monotonic() + timeout
    missing = set(names)
    while missing:
        missing = {name for name in missing if not os.path.isfile(os.path.join(models_dir, name, "metadata.json"))}
        if not missing:
            break
        if time.monotonic() > deadline:
            return _fail(f"Timed out after {timeout}s waiting for models: {', '.join(sorted(missing)[:10])}")
        logger.info("Waiting for %d model(s)...", len(missing))
        time.sleep(poll_interval)
    print(f"All {len(names)} models present in {models_dir}", flush=True)
    return 0


# -- score -----------------------------------------------------------------------------


def read_input_frame(path: str):
    """A ``--input`` file as a request frame, as the JAX command reads it
    with pandas: a CSV's first column is the index (ISO times, else
    integers; naive times stay naive), its other columns floats (an empty
    cell NaN), rows in the file's order (the index's name is not kept);
    a parquet file through ``server/wire/parquet_codec.py``."""
    import csv

    import numpy as np

    from ..dataset.series import parse_datetime
    from ..server.wire import Frame, dataframe_from_parquet_bytes

    if not path.endswith(".csv"):
        with open(path, "rb") as f:
            return dataframe_from_parquet_bytes(f.read())
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    header, body = rows[0], rows[1:]
    keys = [row[0] for row in body]
    try:
        index: List = [parse_datetime(key) for key in keys]
    except ValueError:
        index = [int(key) for key in keys]
    values = np.array([[float(cell) if cell.strip() else np.nan for cell in row[1:]] for row in body], np.float64)
    return Frame(index, header[1:], values.reshape(len(body), len(header) - 1))


def score_table(model, X, y, with_anomaly: bool = True):
    """The frame ``score`` writes: ``model.anomaly(X, y)`` for a detector
    with ``with_anomaly``, else the prediction under positional column
    names, aligned to the last rows of ``X``."""
    import numpy as np

    from ..server.wire import WireColumn, WireTable

    if with_anomaly and hasattr(model, "anomaly"):
        return model.anomaly(X, y)
    values = np.asarray(model.predict(np.asarray(X.values)))
    index = X.index[len(X.index) - len(values):]
    return WireTable(index, [WireColumn(str(i), "", values[:, i]) for i in range(values.shape[1])],
                     getattr(X, "unit", None))


def score(model_dir: str, output: str, input_path: Optional[str] = None, start: Optional[str] = None,
          end: Optional[str] = None, with_anomaly: bool = True, device: Optional[str] = None) -> int:
    """``score``: see the module's docstring; the exit code."""
    from .. import resolve_device, serializer
    from ..client.forwarders import flat_parquet_bytes
    from ..dataset import GordoBaseDataset
    from ..server.wire import Frame

    target = resolve_device(device)
    if input_path:
        X = read_input_frame(input_path)
        y = X  # a file holds inputs only: an autoencoder's targets
    else:
        if not (start and end):
            return _fail("Provide --input or both --start/--end")
        dataset_config = dict(serializer.load_metadata(model_dir).get("dataset") or {})
        if not dataset_config:
            return _fail("Model metadata carries no dataset config; use --input")
        dataset_config["train_start_date"] = start
        dataset_config["train_end_date"] = end
        # the machine's own targets, so a distinct target_tag_list scores against its columns
        dataset = GordoBaseDataset.from_dict(dataset_config)
        values, targets, index = dataset.get_data()
        x_names, y_names = dataset.column_names()
        # a dataset's index is in nanoseconds, as pandas resamples it
        X, y = Frame(list(index), x_names, values, "ns"), Frame(list(index), y_names, targets, "ns")
    model = serializer.load(model_dir, device=target)
    logger.info("Scoring %d rows on %s", len(X.index), target)
    table = score_table(model, X, y, with_anomaly)
    with open(output, "wb") as f:
        f.write(flat_parquet_bytes(table))
    print(f"Scored {len(table.index)} rows -> {output}", flush=True)
    return 0


# -- ensure-single-workflow ----------------------------------------------------------------


def _read_lock(lock_path: str) -> str:
    try:
        with open(lock_path) as f:
            lock = json.load(f)
    except FileNotFoundError:
        return ""
    except ValueError:
        logger.warning("Corrupt deploy.lock at %s; overwriting", lock_path)
        return ""
    return str(lock.get("revision", "")) if isinstance(lock, dict) else ""


def _owner_token() -> str:
    """A guard's owner token: the process and a nonce no other holder has."""
    return f"owner-{os.getpid()}-{secrets.token_hex(8)}"


def ensure_single_workflow(models_root: str, revision: str, check_only: bool = False) -> int:
    """``ensure-single-workflow``: the JAX command's guard
    (``gordo_tpu/cli/cli.py:1536-1695``). ``MODELS_ROOT/deploy.lock``
    records the newest deploying revision (an atomic replace); a deploy
    of an older revision fails fast, one of the same revision passes.
    The read-check-replace runs under a guard: a directory, never empty,
    renamed onto ``MODELS_ROOT/.deploy.guard`` (a rename onto a non-empty
    directory fails, so a live guard cannot be taken). A guard older than
    300 s is a crashed holder's and is broken.

    Unlike the JAX guard, whose entry is ``held``, the port's guard holds
    one entry named by its **owner token** (pid and nonce). The JAX
    command breaks a stale guard by renaming the guard's path after an
    ``os.stat``, which takes a live guard that another waiter broke and
    re-acquired in between, and its holder's release then removes
    whatever stands at the path. The port breaks a stale guard by moving
    out the token entry it stat'ed (``.deploy.guard/<token>``): the rename
    succeeds only while that same guard stands at the path, so a guard
    re-acquired in between (another token) is never touched. A holder
    releases by removing its own token entry, then the guard only if it is
    empty."""
    if not str(revision).isdigit():
        return _fail(f"Revision must be numeric, got {revision!r}")
    os.makedirs(models_root, exist_ok=True)
    lock_path = os.path.join(models_root, LOCK_FILE)
    stale = (f"A newer deploy (revision {{held}}) owns {models_root}; this deploy (revision {revision}) is stale "
             "and must not write")
    if check_only:
        held = _read_lock(lock_path)
        if held.isdigit() and int(held) > int(revision):
            return _fail(stale.format(held=held))
        print(f"Lock check ok for revision {revision} (held: {held or 'none'})", flush=True)
        return 0
    mutex = os.path.join(models_root, GUARD)
    token = _owner_token()
    deadline = time.monotonic() + ACQUIRE_TIMEOUT_S
    while not _try_acquire(mutex, token):
        if time.monotonic() > deadline:
            return _fail(f"Could not acquire {mutex} within {ACQUIRE_TIMEOUT_S}s; if no other deploy is running, "
                         "remove the stale directory")
        if not _break_stale_guard(mutex):
            time.sleep(0.5)
    try:
        held = _read_lock(lock_path)
        if held.isdigit() and int(held) > int(revision):
            return _fail(stale.format(held=held))
        fd, tmp = tempfile.mkstemp(dir=models_root, prefix=".deploy.lock.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"revision": str(revision),
                           "acquired_at": datetime.datetime.now(datetime.timezone.utc).isoformat()}, f)
            os.replace(tmp, lock_path)  # atomic on the shared volume
        except OSError:
            try:
                os.unlink(tmp)
            finally:
                raise
    finally:
        _release(mutex, token)
    print(f"Acquired deploy lock for revision {revision}", flush=True)
    return 0


def _unique(mutex: str, suffix: str) -> str:
    return f"{mutex}.{suffix}-{os.getpid()}-{time.monotonic_ns()}"


def _try_acquire(mutex: str, token: str) -> bool:
    """Rename a staged guard holding ``token`` onto the guard's path;
    False while another guard stands there."""
    staging = _unique(mutex, "acquire")
    os.mkdir(staging)
    os.mkdir(os.path.join(staging, token))
    try:
        os.rename(staging, mutex)
        return True
    except OSError:
        shutil.rmtree(staging, ignore_errors=True)
        return False


def _break_stale_guard(mutex: str) -> bool:
    """Break the guard at ``mutex`` if its token entry is older than
    :data:`STALE_GUARD_S`: move that entry (the very guard that was
    stat'ed) out, then remove the guard if it is still the emptied one.
    True when a guard was broken."""
    try:
        entries = os.listdir(mutex)
        if len(entries) != 1:
            return False
        entry = os.path.join(mutex, entries[0])
        age = time.time() - os.stat(entry).st_mtime
    except OSError:
        return False
    if age <= STALE_GUARD_S:
        return False
    condemned = _unique(mutex, "stale")
    os.mkdir(condemned)
    try:
        # fails unless this guard still stands at the path: another token is another guard
        os.rename(entry, os.path.join(condemned, entries[0]))
    except OSError:
        return False
    finally:
        shutil.rmtree(condemned, ignore_errors=True)
    try:
        os.rmdir(mutex)  # the emptied guard; a successor's, never empty, stays
    except OSError:
        pass
    logger.warning("Broke stale deploy mutex %s (owner %s)", mutex, entries[0])
    return True


def _release(mutex: str, token: str) -> None:
    """Remove this holder's token entry, then the guard if it is empty (a
    guard another holder stands in is never empty)."""
    for path in (os.path.join(mutex, token), mutex):
        try:
            os.rmdir(path)
        except OSError:
            pass


# -- cleanup-revisions ----------------------------------------------------------------------


def cleanup_revisions(models_root: str, current_revision: str, keep: int = 3, dry_run: bool = False) -> int:
    """``cleanup-revisions``: delete the numbered revisions of
    ``models_root`` but the newest ``keep`` (ordered numerically: ``1000``
    is newer than ``999``) and ``current_revision``; exit 1 when a delete
    fails, so that the volume does not fill unnoticed."""
    try:
        entries = sorted((entry for entry in os.listdir(models_root)
                          if os.path.isdir(os.path.join(models_root, entry)) and entry.isdigit()), key=int)
    except FileNotFoundError:
        return _fail(f"No such models root: {models_root}")
    retained = set(entries[-keep:] if keep > 0 else [])
    retained.add(current_revision)
    doomed = [entry for entry in entries if entry not in retained]
    failed = []
    for revision in doomed:
        path = os.path.join(models_root, revision)
        if dry_run:
            print(f"Would delete {path}", flush=True)
            continue
        logger.info("Deleting old revision %s", path)
        try:
            shutil.rmtree(path)
        except OSError as exc:
            logger.error("Could not delete %s: %s", path, exc)
            failed.append(revision)
    print(f"Revisions: {len(entries) - len(doomed)} kept, {len(doomed) - len(failed)} deleted"
          f"{' (dry run)' if dry_run else ''}", flush=True)
    if failed:
        return _fail(f"Failed to delete {len(failed)} revision(s): {', '.join(failed)}")
    return 0
