"""
``run-server``'s pre-fork master: the port's own counterpart of the
gunicorn arbiter that serves the JAX command (``gordo_tpu/cli/cli.py:392-418``,
``gordo_tpu/server/app.py:800-895``), with the standard library only.

Before it forks, the master

- binds the listening socket (port 0 picks a free one; the log line
  ``listening on http://<host>:<port>`` names the port bound);
- imports the serving modules (:data:`PRELOADED`), so that no worker pays
  for ``import torch``;
- on ``cuda``, builds the kernel libraries (``ops/_build.build``: ``nvcc``
  only; nothing is loaded, so no CUDA runtime starts in the master);
- with ``ENABLE_PROMETHEUS``, binds its metrics port and, when
  ``PROMETHEUS_MULTIPROC_DIR`` is unset, makes a private directory,
  exports it to its workers (whose worker sinks then turn on, as under
  JAX) and removes it at exit;
- starts no thread and creates no CUDA context: a CUDA context does not
  survive ``fork``, and neither do threads.

Each worker, a forked child, runs the post-fork resets
(``utils/postfork.py``, from the fork hook), makes its own device context
and app (``server.app.build_app``), loads its store's models and buckets
(``warm_buckets``), launches K1 once on the card to prove the kernel runs
there (the launch is not counted), and answers the inherited socket with
a :class:`~gordo_tpu_torch.server.app.ThreadingWSGIServer` that answers
at most ``threads`` requests at once (``gthread``; ``sync`` is one). It
tells the master it booted over a pipe of its own.

The master's loop is one thread: a ``select`` over a self-pipe that its
signal handlers write to, its workers' boot pipes and its metrics socket.

- SIGTERM or SIGINT: SIGTERM to every worker, each of which drains
  (``server.app.drain_and_stop``); after :data:`GRACEFUL_TIMEOUT_S` plus
  the drain's grace the master kills what is left. It exits 0 only when
  every worker exited 0.
- A worker that dies after it booted is reaped, its pid given to
  ``mark_process_dead`` (with ``--with-prometheus-config``, as the JAX
  ``gunicorn_config.py``'s ``child_exit`` does) and replaced.
- A worker that exits before it booted (no card when ``cuda`` was asked
  for, a kernel that does not build, load or launch, a collection that is
  not a directory) stops the whole server: every other worker is stopped
  and the master exits :data:`WORKER_BOOT_ERROR`, as gunicorn's arbiter
  halts on a worker boot error. The server never carries on on the CPU.
- With ``ENABLE_PROMETHEUS`` the master answers ``/metrics`` from the
  fan-in of its workers' files (``prometheus/multiprocess.py``), in the
  same loop.
- A worker whose master died drains and exits by itself.

The log lines: the master's ``listening on ...``, ``Prometheus metrics
on ...``, ``worker <n> forked: pid <p>``, ``worker <n> booted (pid <p>):
...`` (models, device, threads, seconds, the card memory the worker
reserved), ``worker <n> (pid <p>) exited <code>`` (and, after a death, a
replacement forked), ``stopping (<why>): SIGTERM to <n> worker(s)`` and
``all workers stopped: exit <code>``; each worker's drain line (``drained in
... kernel launches: K1 <n>, K2 <m> (pid <p>)``) counts its own launches.
"""

import importlib
import logging
import os
import select
import shutil
import signal
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: the exit code of a worker that could not boot, and of a master it stopped (gunicorn's)
WORKER_BOOT_ERROR = 3
#: the seconds the master waits for its workers' drains, on top of the drain's grace (gunicorn's --graceful-timeout)
GRACEFUL_TIMEOUT_S = 30.0
#: the listening socket's backlog (gunicorn's default)
BACKLOG = 2048
#: the worker classes served as named; any other is served as gthread
WORKER_CLASSES = ("gthread", "sync")
#: the modules a worker needs, imported by the master before it forks
PRELOADED = (
    "gordo_tpu_torch.server.app",
    "gordo_tpu_torch.server.views.anomaly",
    "gordo_tpu_torch.server.views.base",
    "gordo_tpu_torch.server.views.stream",
    "gordo_tpu_torch.server.fleet_store",
    "gordo_tpu_torch.server.wire",
    "gordo_tpu_torch.server.prometheus.server",
    "gordo_tpu_torch.serve.engine",
    "gordo_tpu_torch.serializer",
    "gordo_tpu_torch.models.estimators",
    "gordo_tpu_torch.models.anomaly",
    "gordo_tpu_torch.lifecycle",
    "gordo_tpu_torch.ops.fleet_dense",
)


def worker_threads(worker_class: str, threads: int) -> int:
    """The requests a worker answers at once: 1 for ``sync``, else
    ``threads`` (any class but ``gthread`` and ``sync`` is served as
    ``gthread``, with one log line)."""
    if worker_class == "sync":
        return 1
    if worker_class not in WORKER_CLASSES:
        logger.warning("worker class %r is served as gthread", worker_class)
    return max(1, int(threads))


class _Worker:
    __slots__ = ("number", "pid", "pipe", "booted", "started")

    def __init__(self, number: int, pid: int, pipe: int):
        self.number, self.pid, self.pipe = number, pid, pipe
        self.booted = False
        self.started = time.monotonic()


class PreforkServer:
    """The master of ``workers`` forked worker processes serving
    ``collection_dir`` on ``device`` (module docstring). :meth:`run`
    returns the exit code."""

    def __init__(self, host: str = "0.0.0.0", port: int = 5555, workers: int = 1, threads: int = 8,
                 worker_class: str = "gthread", collection_dir: Optional[str] = None, device: Any = None,
                 metrics_port: int = 9090, drain_grace_s: float = 0.0, prometheus_config: bool = False):
        self.host, self.port = host, port
        self.n_workers = max(1, int(workers))
        self.threads = worker_threads(worker_class, threads)
        self.collection_dir = collection_dir
        self.device = device
        self.metrics_port = metrics_port
        self.drain_grace_s = drain_grace_s
        self.prometheus_config = prometheus_config
        self.workers: Dict[int, _Worker] = {}
        self.exit_codes: List[int] = []
        self.sock: Optional[socket.socket] = None
        self.metrics_server: Any = None
        self.private_dir: Optional[str] = None
        self._pid = os.getpid()
        self._wake_r = self._wake_w = -1
        self._signal: Optional[int] = None
        self._stopping = False
        self._deadline = 0.0
        self._boot_failed = False
        self._next_number = 0

    # -- the master -------------------------------------------------------------------

    def run(self) -> int:
        """Bind, preload, build, fork and supervise until a signal stops the
        workers; the exit code (0 only when every worker drained)."""
        try:
            self._prepare()
        except Exception:  # noqa: BLE001 - the master cannot start: nothing was forked
            logger.exception("the server could not start")
            self._close()
            return 1
        try:
            for _ in range(self.n_workers):
                self._spawn()
            return self._loop()
        finally:
            self._close()

    def _prepare(self) -> None:
        import torch

        from .app import enable_prometheus
        from .prometheus import multiprocess

        self.sock = bind_socket(self.host, self.port)
        bound = self.sock.getsockname()[1]
        logger.info("listening on http://%s:%d (master pid %d; %d worker(s) of %d thread(s) on %s)", self.host, bound,
                    self._pid, self.n_workers, self.threads, self.device or "cuda")
        if enable_prometheus():
            if not multiprocess.multiprocess_dir():
                self.private_dir = tempfile.mkdtemp(prefix="gordo-prometheus-")
                os.environ["PROMETHEUS_MULTIPROC_DIR"] = self.private_dir
        t0 = time.monotonic()
        for name in PRELOADED:
            importlib.import_module(name)
        logger.info("serving modules imported in %.2f s", time.monotonic() - t0)
        # torch.device parses the name only: no CUDA call in the master
        if torch.device("cuda" if self.device is None else self.device).type == "cuda":
            from ..ops import _build

            t0 = time.monotonic()
            built = _build.build()
            logger.info("kernel libraries built in %.2f s (no CUDA context in the master): %s",
                        time.monotonic() - t0, ", ".join(sorted(built)))
        if enable_prometheus():
            from wsgiref.simple_server import WSGIServer

            from .prometheus.server import build_metrics_app

            self.metrics_server = WSGIServer((self.host, self.metrics_port), _metrics_handler())
            self.metrics_server.set_app(build_metrics_app())
            self.metrics_server.timeout = 0
            logger.info("Prometheus metrics on http://%s:%d/metrics (the workers' files in %s)", self.host,
                        self.metrics_server.server_port, multiprocess.multiprocess_dir())
        self._wake_r, self._wake_w = os.pipe()
        for fd in (self._wake_r, self._wake_w):
            os.set_blocking(fd, False)
        signal.set_wakeup_fd(self._wake_w)
        for signum in (signal.SIGTERM, signal.SIGINT):
            signal.signal(signum, self._on_stop_signal)
        signal.signal(signal.SIGCHLD, lambda _signum, _frame: None)  # wakes the loop through the pipe

    def _on_stop_signal(self, signum: int, _frame: Any) -> None:
        if self._signal is None:
            self._signal = signum

    def _loop(self) -> int:
        while True:
            if self._signal is not None and not self._stopping:
                self._begin_stop(f"{signal.Signals(self._signal).name}")
            self._reap()
            if self._stopping:
                if not self.workers:
                    break
                if time.monotonic() > self._deadline:
                    for worker in self.workers.values():
                        logger.warning("worker %d (pid %d) did not drain in time: killed", worker.number, worker.pid)
                        _kill(worker.pid, signal.SIGKILL)
                    self._deadline = float("inf")
            elif self._boot_failed:
                self._begin_stop("a worker failed to boot")
                continue
            else:
                while len(self.workers) < self.n_workers:
                    self._spawn()
            waiting = [w.pipe for w in self.workers.values() if not w.booted and w.pipe >= 0]
            readable = [self._wake_r, *waiting]
            if self.metrics_server is not None:
                readable.append(self.metrics_server.socket)
            try:
                ready, _, _ = select.select(readable, [], [], 1.0)
            except InterruptedError:
                continue
            for fd in ready:
                if fd == self._wake_r:
                    try:
                        while os.read(self._wake_r, 512):
                            pass
                    except BlockingIOError:
                        pass
                elif self.metrics_server is not None and fd is self.metrics_server.socket:
                    self.metrics_server.handle_request()
                else:
                    self._read_boot_pipe(fd)
        failed = self._boot_failed or any(code != 0 for code in self.exit_codes)
        code = WORKER_BOOT_ERROR if self._boot_failed else (1 if failed else 0)
        logger.info("all workers stopped: exit %d", code)
        return code

    def _read_boot_pipe(self, fd: int) -> None:
        worker = next((w for w in self.workers.values() if w.pipe == fd), None)
        try:
            data = os.read(fd, 64)
        except OSError:
            data = b""
        if worker is None:
            return
        if data.startswith(b"ready"):
            worker.booted = True
        # a ready worker, or one that closed its pipe without booting (its exit is reaped)
        os.close(fd)
        worker.pipe = -1

    def _reap(self) -> None:
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            worker = self.workers.pop(pid, None)
            if worker is None:
                continue
            if worker.pipe >= 0:
                if not worker.booted:  # it may have written "ready" just before it died
                    try:
                        worker.booted = os.read(worker.pipe, 64).startswith(b"ready")
                    except OSError:
                        pass
                os.close(worker.pipe)
            code = os.waitstatus_to_exitcode(status)
            if self.prometheus_config:
                from .prometheus.multiprocess import mark_process_dead

                mark_process_dead(pid)
            if self._stopping:
                self.exit_codes.append(code)
                logger.info("worker %d (pid %d) exited %d", worker.number, pid, code)
            elif not worker.booted:
                logger.error("worker %d (pid %d) failed to boot (exit %d): stopping the server", worker.number, pid,
                             code)
                self._boot_failed = True
            else:
                logger.warning("worker %d (pid %d) exited %d after %.1f s: forking a replacement", worker.number,
                               pid, code, time.monotonic() - worker.started)

    def _begin_stop(self, reason: str) -> None:
        self._stopping = True
        self._deadline = time.monotonic() + GRACEFUL_TIMEOUT_S + self.drain_grace_s
        logger.info("stopping (%s): SIGTERM to %d worker(s)", reason, len(self.workers))
        for worker in self.workers.values():
            _kill(worker.pid, signal.SIGTERM)

    def _spawn(self) -> None:
        number = self._next_number
        self._next_number += 1
        read_fd, write_fd = os.pipe()
        pid = os.fork()
        if pid == 0:  # the worker
            code = WORKER_BOOT_ERROR
            try:
                os.close(read_fd)
                code = self._worker_main(number, write_fd)
            except BaseException:  # noqa: BLE001 - whatever stops a worker ends its process here
                logger.exception("worker %d (pid %d) failed", number, os.getpid())
            finally:
                for stream in (sys.stdout, sys.stderr):
                    try:
                        stream.flush()
                    except Exception:  # noqa: BLE001 - the process ends either way
                        pass
                # never unwind into the master's frames (its cleanup is not the worker's)
                os._exit(code)
        os.close(write_fd)
        self.workers[pid] = _Worker(number, pid, read_fd)
        logger.info("worker %d forked: pid %d", number, pid)

    def _close(self) -> None:
        if os.getpid() != self._pid:
            return
        for worker in list(self.workers.values()):  # the master failed: take its workers with it
            _kill(worker.pid, signal.SIGKILL)
            try:
                os.waitpid(worker.pid, 0)
            except ChildProcessError:
                pass
        self.workers.clear()
        if self.metrics_server is not None:
            self.metrics_server.server_close()
        if self.sock is not None:
            self.sock.close()
        if self._wake_w >= 0:
            signal.set_wakeup_fd(-1)
            os.close(self._wake_r)
            os.close(self._wake_w)
            self._wake_r = self._wake_w = -1
        if self.private_dir is not None:
            shutil.rmtree(self.private_dir, ignore_errors=True)
            os.environ.pop("PROMETHEUS_MULTIPROC_DIR", None)
            self.private_dir = None

    # -- a worker ---------------------------------------------------------------------

    def _worker_main(self, number: int, ready_fd: int) -> int:
        """Boot, tell the master, serve until a signal drains; the exit code."""
        for signum in (signal.SIGTERM, signal.SIGINT, signal.SIGCHLD):
            signal.signal(signum, signal.SIG_DFL)
        signal.set_wakeup_fd(-1)
        os.close(self._wake_r)
        os.close(self._wake_w)
        if self.metrics_server is not None:
            self.metrics_server.socket.close()
        for worker in self.workers.values():
            if worker.pipe >= 0:
                os.close(worker.pipe)
        t0 = time.monotonic()
        app, server, loaded = self._boot()
        from .app import drain_and_stop, install_graceful_shutdown

        handler = install_graceful_shutdown(app, server, self.drain_grace_s)
        _watch_master(self._pid, handler)
        reserved = _reserved_bytes(app.device)
        os.write(ready_fd, b"ready")
        os.close(ready_fd)
        logger.info("worker %d booted (pid %d): %d models on %s, %d thread(s), %.2f s; card memory reserved %s",
                    number, os.getpid(), loaded, app.device, self.threads, time.monotonic() - t0, reserved)
        try:
            server.serve_forever()
        finally:
            drain = None if handler is None else handler.thread
            if drain is not None:
                drain.join()
            else:
                drain_and_stop(app, server)
            server.server_close()
        return 0

    def _boot(self):
        from .. import resolve_device
        from .app import MODEL_COLLECTION_DIR_ENV_VAR, build_app, serve_socket

        device = resolve_device(self.device)  # no card when one was asked for: the boot fails
        collection = self.collection_dir or os.environ.get(MODEL_COLLECTION_DIR_ENV_VAR)
        if not collection or not os.path.isdir(collection):
            raise NotADirectoryError(f"the model collection {collection!r} is not a directory")
        app = build_app(collection, device)
        fleet = app.store.fleet(app.store.route(app.store.collection_dir))
        loaded = fleet.warm_buckets()
        if device.type == "cuda":
            _probe_kernel(fleet)
        server = serve_socket(app, self.sock, max_threads=self.threads)
        return app, server, len(loaded)


def _metrics_handler() -> Any:
    """The master's scrape handler: quiet, and with a timeout, so that a
    stalled scrape cannot hold the master's loop."""
    from .app import _QuietHandler

    class MetricsHandler(_QuietHandler):
        timeout = 10

    return MetricsHandler


def bind_socket(host: str, port: int) -> socket.socket:
    """The listening socket the workers share: bound, listening and
    non-blocking (a worker that loses the race for a connection returns
    to its loop instead of waiting in ``accept``)."""
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(BACKLOG)
    sock.setblocking(False)
    return sock


def _kill(pid: int, signum: int) -> None:
    try:
        os.kill(pid, signum)
    except ProcessLookupError:
        pass


def _watch_master(master_pid: int, handler: Any) -> None:
    """A worker whose master died drains as if it had been sent SIGTERM."""
    if handler is None:
        return

    def watch() -> None:
        while os.getppid() == master_pid:
            time.sleep(1.0)
        logger.warning("the master (pid %d) is gone: worker pid %d drains", master_pid, os.getpid())
        handler(signal.SIGTERM, None)

    threading.Thread(target=watch, name="gordo-master-watch", daemon=True).start()


def _probe_kernel(fleet: Any) -> None:
    """One K1 launch on the card at boot, through the first feedforward
    model's bucket: a kernel that does not load or launch fails the boot.
    The launch is not counted: the worker's counters report its serving."""
    import numpy as np

    from ..models.spec import FeedForwardSpec
    from ..ops import fleet_dense

    for name, spec in sorted(fleet.loaded_specs().items()):
        if isinstance(spec, FeedForwardSpec) and not fleet.host_transformed(spec):
            fleet.predict(name, np.zeros((1, spec.n_features), dtype=np.float32))
            with fleet_dense._launches_lock:
                fleet_dense.fleet_feedforward.launches = 0
                fleet_dense.fleet_feedforward.shapes.clear()
            return


def _reserved_bytes(device: Any) -> str:
    if getattr(device, "type", "cpu") != "cuda":
        return "n/a (cpu)"
    import torch

    return f"{torch.cuda.memory_reserved(device)} bytes"

