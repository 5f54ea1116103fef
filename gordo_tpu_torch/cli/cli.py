"""
The port's command line (``python -m gordo_tpu_torch``), on ``argparse``:

- ``build MACHINE OUTPUT_DIR [--device cuda|cpu]``: the JAX package's
  ``build`` (``gordo_tpu/cli/cli.py:104-244``), what an Argo build pod
  runs. ``MACHINE`` (default ``$MACHINE``) is one machine's config as JSON
  or YAML text with its ``project_name``; the sequential
  ``builder.ModelBuilder`` (or the ``--model-builder-class`` subclass)
  builds it into ``OUTPUT_DIR`` (default ``$OUTPUT_DIR``, else ``/data``),
  through the model-register cache with ``--model-register-dir``
  (``$MODEL_REGISTER_DIR``). ``--print-cv-scores`` prints each CV score
  as ``<metric>_<fold>=<value>``. The exit codes and the failure report
  are ``build-fleet``'s. ``--model-parameter key,val`` (repeated) renders
  a model given as a string through the port's template renderer
  (``utils/template.py``) and reads it as YAML (``expand_model``); a name
  the model uses and no parameter gives exits 2 with ``Model parameter
  missing value!``. Like the JAX command, it records the model definition
  expanded, every default filled in (``serializer.into_definition``), so
  its cache key is the JAX command's. The machine's reporters
  (``runtime.reporters``, ``reporters/``) run after the build, before the
  CV scores are printed; a reporter's failure exits 90.
- ``build-fleet MACHINES_CONFIG OUTPUT_DIR [--device cuda|cpu]``: the JAX
  package's ``build-fleet`` (``gordo_tpu/cli/cli.py:558-725``). It builds
  every machine of a shard (a path to, or the text of, a ``machines:``
  document; ``$MACHINES_CONFIG`` when not given) with
  ``parallel/fleet_build.py`` into ``OUTPUT_DIR`` (default
  ``$OUTPUT_DIR``, else ``/data``), on the card unless ``--device cpu``.
  A machine without ``project_name`` takes the document's, else
  ``fleet-build``. Rank 0 runs each dumped machine's reporters after the
  build. It exits with the code of the exception that failed it
  (:data:`EXIT_CODES`; a reporter's 90); when some machines fail and the
  rest are dumped and reported, with the first failure's;
  ``--exceptions-reporter-file`` writes the JSON report. ``--resume`` (``$FLEET_RESUME``) finishes a build that
  was cut short, from its journal; ``--model-register-dir`` shares the
  model-register cache with other builds. ``--plan-strategy
  {naive,packed}`` picks the bucket strategy (default
  ``$GORDO_TPU_PLAN_STRATEGY``, else ``naive``), ``--plan-from`` replays a
  plan of the ``plan`` command, ``--cost-table`` prices buckets with a
  calibrated table; an unusable plan or table fails with the JAX
  command's text (``_load_planner_inputs``, ``cli.py:438-456``), exit 1.
  **Across processes and cards** (``cli.py:634-749``): the command reads
  the variables the JAX workflow template injects, ``JAX_PROCESS_COUNT``,
  ``JAX_PROCESS_INDEX`` and ``JAX_COORDINATOR_ADDRESS`` (``host:port``).
  A JAX pod is one process driving every local chip; a port pod runs one
  process a visible card (``--device cuda``), spawned by the command line
  (:func:`spawn_build_fleet`), so the world is ``JAX_PROCESS_COUNT`` x
  cards and a rank is ``JAX_PROCESS_INDEX * cards + local``; with one
  visible card, or a device that names its card, nothing is spawned. The
  library function :func:`build_fleet` never spawns: it is one rank on
  one device. A join or a collective waits at most 600 s
  (``parallel/mesh.py``'s ``DEFAULT_TIMEOUT_S``). The ranks
  join one ``torch.distributed`` group (``parallel/mesh.py``: ``nccl``,
  or ``gloo`` on the CPU or when ``--dist-backend gloo`` names it, for
  ranks that share a card) and train the shard as one
  fleet over a ``(world, 1)`` mesh. Only rank 0 dumps, journals, writes
  the telemetry files and the failure report; the other ranks first
  mirror its resume and model-register filters read-only, so every rank
  trains the same machines. A rank that fails, or a group that does not
  form, fails the build.
- ``plan MACHINES_CONFIG [--strategy] [-o FILE] [--cost-table F]
  [--calibrate-from TRACE] [--cost-table-out F] [--as-json]``: the JAX
  package's ``plan`` (``gordo_tpu/cli/cli.py:459-555``). It fetches and
  stages the shard's data (``FleetBuilder.plan_only``, on ``--device``),
  trains nothing, and prints the ``FleetPlan`` a ``build-fleet`` would
  run, as the text table (``planner/report.py``) or the document;
  ``-o`` writes it for ``build-fleet --plan-from``. ``--calibrate-from``
  first fits a cost table from a build's ``build_trace.jsonl`` and saves
  it as ``cost_table.json`` beside the trace (or ``--cost-table-out``).
  A machine that cannot be planned exits 1 with the JAX message.
- ``build-status OUTPUT_DIR [--as-json] [--watch N]``: the JAX package's
  ``build-status`` (``gordo_tpu/cli/cli.py:751-800``). It renders the
  ``build_status.json`` a fleet build heartbeats into ``OUTPUT_DIR``
  (default ``$OUTPUT_DIR``): state, phase, machine counts with an ETA, the
  phase table; ``--as-json`` prints the document, ``--watch N`` renders it
  again every N seconds while the build runs. Without a document it exits
  1 with the JAX command's message.
- ``fleet-status DIRECTORY [--as-json] [--watch N] [--machines SEL]
  [--limit N] [--offset N]``: the JAX package's ``fleet-status``
  (``gordo_tpu/cli/cli.py:799-890``). It renders the joined fleet-status
  document of ``DIRECTORY`` (default ``$OUTPUT_DIR``): build, plan,
  lifecycle, the merged health snapshots with the top offenders, the SLO
  alerts, the device; ``--machines`` selects records (``all``, ``none``, a
  state, ``unhealthy``, a comma list), ``--limit``/``--offset`` page them.
  A missing directory exits 1.
- ``trace TARGET [--as-json] [--since TIME | --last DURATION]``: the JAX
  package's ``trace`` (``gordo_tpu/cli/cli.py:890-1005``). It analyzes a
  span trace (``telemetry/trace_analysis.py``): a file, or a directory's
  serve and build traces, each with its worker variants and rotated
  generations (``TARGET`` default ``$OUTPUT_DIR``); ``--since`` (ISO time
  or epoch seconds) or ``--last`` (``90m``, ``6h``, ``7d``) keeps the
  spans that end after it.
- ``slo status DIRECTORY [--config FILE] [--as-json] [--watch N]`` and
  ``slo check DIRECTORY [--config FILE] [--as-json]``: the JAX package's
  ``slo`` commands (``gordo_tpu/cli/cli.py:1008-1114``). Each evaluates
  the SLOs of ``DIRECTORY`` (default ``$GORDO_TPU_TELEMETRY_DIR``) once
  (``telemetry/slo.py``: the rollups brought up to date, the alerts
  stepped) and prints the status; ``check`` exits 1 while an alert is
  firing. A missing directory or a bad ``slos.toml`` exits 1 with the
  JAX command's message.
- ``bench-check CANDIDATE [--baseline F] [--tolerance X] [--report-only]
  [--as-json]``: the JAX package's ``bench-check``
  (``gordo_tpu/cli/cli.py:1116-1210``, ``telemetry/benchgate.py``). It
  holds a bench document to its baseline, by default the committed
  ``BENCH_*.json`` of its ``bench`` kind found beside the candidate, then
  in the current directory; it exits 1 on a regression (0 with
  ``--report-only``), 1 with the JAX command's message when the documents
  cannot be read or compared, 2 when a named file does not exist.
- ``lifecycle run MACHINES_CONFIG COLLECTION_DIR``, ``lifecycle status
  MODELS_ROOT [--as-json]``, ``lifecycle promote COLLECTION_DIR
  [--machines-config F] [--force]`` and ``lifecycle rollback
  COLLECTION_DIR [--reason R]``: the JAX package's ``lifecycle`` commands
  (``gordo_tpu/cli/cli.py:1758-2010``, ``lifecycle/``), their messages and
  exit codes. ``run`` scores one probe window a machine (its own dataset,
  fetched through ``dataset/``) through the served revision each cycle and
  advances the supervisor (``--once``, ``--interval``, ``--cycles``,
  ``--canary-fraction``, ``--auto-promote/--no-auto-promote``,
  ``--dry-run``); ``COLLECTION_DIR`` defaults to ``$MODEL_COLLECTION_DIR``,
  ``MACHINES_CONFIG`` to ``$MACHINES_CONFIG``, ``MODELS_ROOT`` to
  ``$MODELS_ROOT``. The routing a command installs lives in its own store,
  on ``--device`` (``cuda`` unless ``cpu``): a server picks a promotion up
  when it starts.
- ``perfmodel fit CORPUS_DIR``, ``perfmodel status`` and ``perfmodel eval
  CORPUS_DIR`` (``cli/perfmodel.py``): the JAX package's ``perfmodel``
  commands over the learned performance model (``perfmodel/``).
- ``workflow generate --machine-config F --project-name P ...``: the JAX
  package's ``workflow generate`` (``cli/workflow_generator.py``), every
  option with its ``WORKFLOW_GENERATOR_*`` variable: the manifests of a
  project's deploy rendered from the port's template, validated, printed.
- ``normalize CONFIG PROJECT``: the shard of a project config, what
  ``workflow generate`` puts into its ConfigMaps
  (``workflow/workflow_generator/workflow_generator.py::normalize``),
  printed or written to ``--output``.
- the deploy pod's commands (``cli/deploy.py``): ``run-server`` (the
  one-process server, drained by SIGTERM), ``wait-for-models``, ``score``,
  ``ensure-single-workflow`` and ``cleanup-revisions``; and the
  ``client`` group (``client/cli.py``): ``metadata``, ``download-model``
  and ``predict``.
"""

import argparse
import logging
import os
import socket
import sys
import traceback
from typing import Any, List, Optional, Sequence, Tuple

from ..client.cli import add_client_parser, client_main
from ..dataset.exceptions import ConfigException, InsufficientDataError, NoSuitableDataProviderError
from ..dataset.sensor_tag import SensorTagNormalizationError
from ..machine import Machine
from ..reporters.base import ReporterException
from ..utils import yaml_lite
from ..utils.env import env_bool, env_int, env_str
from ..utils.template import Template, UndefinedError
from . import deploy, perfmodel, workflow_generator
from .exceptions_reporter import ExceptionsReporter, ReportLevel

logger = logging.getLogger(__name__)

#: exception type to exit code, the JAX command's map (``cli.py:47-60``)
EXIT_CODES = (
    (Exception, 1),
    (ValueError, 2),
    (PermissionError, 20),
    (FileNotFoundError, 30),
    (SensorTagNormalizationError, 60),
    (NoSuitableDataProviderError, 70),
    (InsufficientDataError, 80),
    (ImportError, 85),
    (ReporterException, 90),
    (ConfigException, 100),
)
_reporter = ExceptionsReporter(EXIT_CODES)

#: the deploy pod's commands (``cli/deploy.py``)
DEPLOY_COMMANDS = ("run-server", "wait-for-models", "score", "ensure-single-workflow", "cleanup-revisions")

def _report(exceptions_reporter_file: Optional[str], exceptions_report_level: str) -> int:
    """Print the exception being handled, write its report when asked, and
    return its exit code."""
    traceback.print_exc()
    exc_type, exc_value, exc_traceback = sys.exc_info()
    if exceptions_reporter_file:
        level = ReportLevel.get_by_name(exceptions_report_level.upper(), ReportLevel.EXIT_CODE)
        # a Kubernetes termination message holds 2024 bytes; room for the JSON around it
        _reporter.safe_report(level, exc_type, exc_value, exc_traceback, exceptions_reporter_file,
                              max_message_len=2024 - 500)
    return _reporter.exception_exit_code(exc_type)


def get_all_score_strings(machine: Machine) -> List[str]:
    """Each CV score of a built machine as ``<metric>_<fold>=<value>``
    (spaces dashed), the lines a hyperparameter tuner reads off a build
    pod's log (``cli.py:230-244``).

    >>> m = Machine.from_dict({"name": "m", "project_name": "p", "model": {}, "dataset": {"type": "RandomDataset",
    ...     "train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": "2020-01-02T00:00:00+00:00",
    ...     "tag_list": ["a"]}})
    >>> m.metadata["build_metadata"]["model"]["cross_validation"]["scores"] = {"r2 score": {"fold-1": 0.5}}
    >>> get_all_score_strings(m)
    ['r2-score_fold-1=0.5']
    """
    scores = machine.metadata["build_metadata"]["model"]["cross_validation"]["scores"]
    return [
        f"{metric.replace(' ', '-')}_{name.replace(' ', '-')}={value}"
        for metric, values in scores.items()
        for name, value in values.items()
    ]


def key_value_par(val: str) -> List[str]:
    """A ``--model-parameter`` value split at its commas (``key,value``)."""
    return val.split(",")


def expand_model(model_config: str, model_parameters: dict) -> Any:
    """A model given as a template string, rendered with
    ``model_parameters`` and read as YAML; a name without a value raises
    ``ValueError`` (``gordo_tpu/cli/cli.py:214-225``)."""
    try:
        model_config = Template(model_config, strict=True).render(**model_parameters)
    except UndefinedError as exc:
        raise ValueError("Model parameter missing value!") from exc
    logger.info("Expanded model config: %s", model_config)
    return yaml_lite.safe_load(model_config)


def build(
    machine_config: str,
    output_dir: str,
    device: Optional[str] = None,
    model_register_dir: Optional[str] = None,
    model_builder_class: Optional[str] = None,
    print_cv_scores: bool = False,
    exceptions_reporter_file: Optional[str] = None,
    exceptions_report_level: str = ReportLevel.MESSAGE.name,
    model_parameter: Sequence[Sequence[str]] = (),
) -> int:
    """The ``build`` command: build one machine (``machine_config``, its
    JSON or YAML text) into ``output_dir``, its model a template string
    expanded with ``model_parameter``'s ``(key, value)`` pairs, then run
    its reporters; the exit code."""
    from ..builder import create_model_builder
    from ..serializer import from_definition, into_definition

    try:
        config = yaml_lite.safe_load(machine_config)
        if not isinstance(config, dict):
            raise ValueError(f"MACHINE must be a mapping, got {type(config).__name__}")
        if model_parameter and isinstance(config.get("model"), str):
            config["model"] = expand_model(config["model"], dict(model_parameter))
        machine = Machine.from_config(config, project_name=config["project_name"])
        # every default frozen into the recorded definition, as the JAX command records it
        machine.model = into_definition(from_definition(machine.model, device="cpu"))
        logger.info("Building, output will be at: %s", output_dir)
        logger.info("Register dir: %s", model_register_dir)
        builder = create_model_builder(model_builder_class)(machine, device=device)
        _, machine_out = builder.build(output_dir, model_register_dir)
        logger.debug("Reporting built machine.")
        machine_out.report()
        if print_cv_scores:
            for score in get_all_score_strings(machine_out):
                print(score)
        return 0
    except Exception:
        return _report(exceptions_reporter_file, exceptions_report_level)


def load_fleet_machines(machines_config: str) -> List[Machine]:
    """The machines of a shard: a path to, or the text of, a document with
    a ``machines:`` list of ``Machine.to_dict()`` entries."""
    if os.path.isfile(machines_config):
        with open(machines_config) as f:
            config = yaml_lite.safe_load(f.read())
    else:
        config = yaml_lite.safe_load(machines_config)
    if not isinstance(config, dict) or "machines" not in config:
        raise ValueError("MACHINES_CONFIG must be a path to, or the text of, a document with a 'machines' list")
    project = config.get("project_name", "fleet-build")
    machine_dicts = [dict(m) for m in config["machines"]]
    for machine in machine_dicts:
        machine.setdefault("project_name", project)
    return [Machine.from_dict(m) for m in machine_dicts]


class PlannerInputError(Exception):
    """A ``--plan-from`` plan or ``--cost-table`` table that cannot be used."""


def load_planner_inputs(plan_from: Optional[str], cost_table_path: Optional[str]):
    """``(FleetPlan, CostTable)`` from their options' paths (None where
    absent); an unusable document raises :class:`PlannerInputError` with
    the JAX command's text."""
    from ..planner import CostTable, FleetPlan

    try:
        fleet_plan = FleetPlan.load(plan_from) if plan_from else None
    except ValueError as exc:
        raise PlannerInputError(f"--plan-from: {exc}") from exc
    try:
        cost_table = CostTable.load(cost_table_path) if cost_table_path else None
    except ValueError as exc:
        raise PlannerInputError(f"--cost-table: {exc}") from exc
    return fleet_plan, cost_table


def build_fleet(
    machines_config: str,
    output_dir: str,
    device: Optional[str] = None,
    exceptions_reporter_file: Optional[str] = None,
    exceptions_report_level: str = ReportLevel.MESSAGE.name,
    resume: bool = False,
    model_register_dir: Optional[str] = None,
    plan_strategy: Optional[str] = None,
    plan_from: Optional[str] = None,
    cost_table_path: Optional[str] = None,
    dist_backend: Optional[str] = None,
) -> Tuple[int, Optional[object]]:
    """The ``build-fleet`` command in this process, on one device: its exit
    code and the ``FleetBuilder`` (None when the shard or the planner's
    inputs did not load). Under ``JAX_PROCESS_COUNT`` > 1 the process is
    rank ``JAX_PROCESS_INDEX`` of that many, on ``device`` (``cuda``:
    the default card). Spawning one rank a visible card is the command
    line's (:func:`spawn_build_fleet`), never this function's."""
    args = (machines_config, output_dir, device, exceptions_reporter_file, exceptions_report_level, resume,
            model_register_dir, plan_strategy, plan_from, cost_table_path, dist_backend)
    try:
        count, index, coordinator = _process_layout()
    except Exception:
        return _report(exceptions_reporter_file, exceptions_report_level), None
    return _build_fleet_rank(args, index, count, 0, coordinator)


def spawn_build_fleet(cards: int, *args) -> int:
    """``build-fleet`` as ``cards`` ranks of this process, one a card,
    spawned (``torch.multiprocessing``) with :func:`build_fleet`'s
    arguments: the world is ``JAX_PROCESS_COUNT`` x ``cards`` and a rank is
    ``JAX_PROCESS_INDEX * cards + local``. The exit code is the first
    failed rank's, else 0."""
    import torch.multiprocessing as mp

    exceptions_reporter_file, exceptions_report_level = args[3], args[4]
    try:
        count, index, coordinator = _process_layout()
    except Exception:
        return _report(exceptions_reporter_file, exceptions_report_level)
    coordinator = coordinator or f"localhost:{_free_port()}"
    logger.info("Spawning %d ranks, one a card, as process %d of %d", cards, index, count)
    try:
        mp.start_processes(_spawned_rank, args=(args, index, count, cards, coordinator), nprocs=cards,
                           start_method="spawn")
    except mp.ProcessExitedException as exc:
        logger.error("%s", exc)
        return exc.exit_code if exc.exit_code and exc.exit_code > 0 else 1
    except mp.ProcessRaisedException as exc:
        logger.error("%s", exc)
        return 1
    return 0


def _process_layout() -> Tuple[int, int, Optional[str]]:
    """``(count, index, coordinator)`` of this process from the variables
    the JAX workflow template injects; a layout of more than one process
    needs ``JAX_COORDINATOR_ADDRESS``."""
    count = env_int("JAX_PROCESS_COUNT", 1)
    index = env_int("JAX_PROCESS_INDEX", 0)
    coordinator = env_str("JAX_COORDINATOR_ADDRESS", None)
    if count > 1 and not coordinator:
        raise KeyError("JAX_COORDINATOR_ADDRESS")
    return count, index, coordinator if count > 1 else None


def visible_cards(device: Optional[str]) -> int:
    """The ranks the command line runs in this process: every visible card
    for ``--device cuda`` without an index, else 1."""
    import torch

    from .. import resolve_device

    target = resolve_device(device)
    return max(1, torch.cuda.device_count()) if target.type == "cuda" and target.index is None else 1


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawned_rank(local: int, args: tuple, index: int, count: int, cards: int, coordinator: str) -> None:
    """One spawned rank's build (``torch.multiprocessing`` target); a
    failure exits with its code."""
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    code, _ = _build_fleet_rank(args, index * cards + local, count * cards, local, coordinator)
    if code:
        sys.exit(code)


def _build_fleet_rank(args: tuple, rank: int, world: int, local: int,
                      coordinator: Optional[str]) -> Tuple[int, Optional[object]]:
    """Rank ``rank`` of ``world`` (alone without a ``coordinator``): join
    the group, build, leave; only rank 0 writes."""
    (machines_config, output_dir, device, exceptions_reporter_file, exceptions_report_level, resume,
     model_register_dir, plan_strategy, plan_from, cost_table_path, dist_backend) = args
    from ..parallel.fleet_build import FleetBuilder
    from ..parallel.mesh import initialize_backend, shutdown_backend

    coordinating = rank == 0
    builder = None
    try:
        if coordinator is not None and world > 1:
            if device in (None, "cuda"):
                device = f"cuda:{local}"
            initialize_backend(coordinator, world, rank, backend=dist_backend, device=device, local_rank=local)
        machines = load_fleet_machines(machines_config)
        fleet_plan, cost_table = load_planner_inputs(plan_from, cost_table_path)
        if not coordinating:
            machines = _mirror_filters(machines, output_dir, model_register_dir, resume)
        logger.info("Fleet-building %d machines; output at %s%s", len(machines), output_dir,
                    "" if coordinating else f" (rank {rank}: side effects skipped)")
        builder = FleetBuilder(machines, device=device, plan_strategy=plan_strategy, fleet_plan=fleet_plan,
                               cost_table=cost_table)
        results = builder.build(output_dir if coordinating else None,
                                model_register_dir=model_register_dir if coordinating else None, resume=resume)
        if coordinating:
            for _, machine_out in results:
                machine_out.report()
        from ..ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

        by_shape = ", ".join(f"{'x'.join(map(str, shape))} {n}" for shape, n in
                             sorted(fleet_feedforward.shapes.items()))
        logger.info("Fleet build complete: %d built, %d resumed, %d failed; kernel launches: K1 %d, K2 %d; "
                    "K1 launches by shape (members x rows x tags): %s", len(results), len(builder.resumed),
                    len(builder.build_errors), fleet_feedforward.launches, fleet_anomaly_scores.launches,
                    by_shape or "none")
        if builder.build_errors:
            _, exc = next(iter(builder.build_errors.items()))
            raise exc
        return 0, builder
    except Exception:
        return _report(exceptions_reporter_file if coordinating else None, exceptions_report_level), builder
    finally:
        if coordinator is not None and world > 1:
            shutdown_backend()


def _mirror_filters(machines: List[Machine], output_dir: str, model_register_dir: Optional[str],
                    resume: bool) -> List[Machine]:
    """The machines rank 0 will train, seen from another rank: rank 0's
    resume and model-register filters, read without writing anything
    (``cli.py:654-675``), so every rank trains the same machines."""
    from ..builder.build_model import ModelBuilder
    from ..parallel.journal import resumable_names

    if resume:
        skip = set(resumable_names(output_dir, machines))
        machines = [m for m in machines if m.name not in skip]
    if model_register_dir:
        machines = [m for m in machines if ModelBuilder.probe_cache(m, model_register_dir) is None]
    return machines


def plan_fleet(
    machines_config: str,
    device: Optional[str] = None,
    strategy: Optional[str] = None,
    output_path: Optional[str] = None,
    cost_table_path: Optional[str] = None,
    calibrate_from: Optional[str] = None,
    cost_table_out: Optional[str] = None,
    as_json: bool = False,
) -> int:
    """The ``plan`` command: print the ``FleetPlan`` a ``build-fleet`` of
    the shard would run (its document with ``as_json``), written to
    ``output_path`` when given; the exit code. Data is fetched and staged,
    nothing trains."""
    from ..parallel.fleet_build import FleetBuilder
    from ..planner import COST_TABLE_FILE, calibrate, render_plan

    try:
        _, cost_table = load_planner_inputs(None, cost_table_path)
    except PlannerInputError as exc:
        return _fail(str(exc))
    if calibrate_from:
        cost_table = calibrate(calibrate_from, cost_table)
        table_path = cost_table_out or os.path.join(os.path.dirname(os.path.abspath(calibrate_from)), COST_TABLE_FILE)
        cost_table.save(table_path)
        logger.info("Calibrated cost table written to %s", table_path)
    builder = FleetBuilder(load_fleet_machines(machines_config), device=device, plan_strategy=strategy,
                           cost_table=cost_table)
    plan = builder.plan_only()
    if builder.build_errors:
        name, exc = next(iter(builder.build_errors.items()))
        return _fail(f"{len(builder.build_errors)} machine(s) could not be planned (first: {name}: {exc!r})")
    if output_path:
        plan.save(output_path)
        logger.info("FleetPlan written to %s", output_path)
    if as_json:
        sys.stdout.write(plan.to_json())
    else:
        print(render_plan(plan))
    sys.stdout.flush()
    return 0


def build_status(output_dir: str, as_json: bool = False, watch: Optional[float] = None) -> int:
    """The ``build-status`` command: print the build's status; the exit code."""
    import json
    import time

    from ..telemetry import load_status, render_status

    while True:
        doc = load_status(output_dir)
        if doc is None:
            print(f"Error: No build status found in {output_dir} (no fleet build has written a heartbeat there, "
                  "or telemetry is disabled)", file=sys.stderr)
            return 1
        print(json.dumps(doc, indent=1, sort_keys=True) if as_json else render_status(doc), flush=True)
        if watch is None or doc.get("state") != "running":
            return 0
        time.sleep(max(0.1, watch))
        print("")


def fleet_status(directory: str, as_json: bool = False, watch: Optional[float] = None,
                 machines: Optional[str] = None, limit: Optional[int] = None, offset: int = 0) -> int:
    """The ``fleet-status`` command (``gordo_tpu/cli/cli.py:799-890``):
    print the joined fleet-status document of ``directory`` (a build's
    output, a served revision), as JSON or as text; the exit code. A
    process of its own has no live ledger, engine or plane: the health
    view is the snapshots on disk, and ``serving``, ``programs`` and
    ``stream`` are None (``/fleet-health`` of a running server has them)."""
    import json
    import time

    from ..telemetry import fleet_status_document, render_fleet_status, utilization_snapshot

    if not os.path.isdir(directory):
        print(f"Error: No such directory: {directory}", file=sys.stderr)
        return 1
    while True:
        doc = fleet_status_document(directory, device=utilization_snapshot(), machines=machines, limit=limit,
                                    offset=offset)
        print(json.dumps(doc, indent=1, sort_keys=True, default=str) if as_json else render_fleet_status(doc),
              flush=True)
        if watch is None:
            return 0
        time.sleep(max(0.1, watch))
        print("")


def _fail(message: str) -> int:
    """A command's error as the JAX commands print it; exit code 1."""
    print(f"Error: {message}", file=sys.stderr)
    return 1


def _parse_since(since: Optional[str], last: Optional[str]) -> Optional[float]:
    """``--since`` (ISO time or epoch seconds) or ``--last`` (a duration)
    as an epoch cutoff; ``ValueError`` with the JAX command's message.

    >>> _parse_since("1970-01-01T00:01:00+00:00", None), _parse_since("60", None), _parse_since(None, None)
    (60.0, 60.0, None)
    """
    import time

    from ..telemetry.aggregate import parse_span_time
    from ..telemetry.slo import parse_duration

    if since and last:
        raise ValueError("--since and --last are exclusive")
    if last:
        return time.time() - parse_duration(last)
    if since:
        try:
            return float(since)
        except ValueError:
            pass
        ts = parse_span_time(since)
        if ts is None:
            raise ValueError(f"Unparseable --since {since!r} (ISO timestamp or epoch)")
        return ts
    return None


def trace(target: str, as_json: bool = False, since: Optional[str] = None, last: Optional[str] = None) -> int:
    """The ``trace`` command: print the analysis of ``target`` (a trace
    file, or a directory's serve and build traces, one analysis each); the
    exit code."""
    import json

    from ..telemetry import BUILD_TRACE_FILE, SERVE_TRACE_FILE
    from ..telemetry.aggregate import sink_bases, sink_window_index
    from ..telemetry.trace_analysis import analyze_trace, render_analysis

    try:
        since_ts = _parse_since(since, last)
    except ValueError as exc:
        return _fail(str(exc))
    window_index: dict = {}
    if os.path.isdir(target):
        groups = [bases for bases in (sink_bases(target, SERVE_TRACE_FILE), sink_bases(target, BUILD_TRACE_FILE))
                  if bases]
        if since_ts is not None:  # the manifest's span windows skip old generations
            window_index = sink_window_index(target)
        if not groups:
            return _fail(f"No {SERVE_TRACE_FILE} or {BUILD_TRACE_FILE} in {target} (is GORDO_TPU_TELEMETRY_DIR "
                         "pointed elsewhere, or telemetry disabled?)")
    elif os.path.exists(target):
        groups = [[target]]
    else:
        return _fail(f"No such trace file or directory: {target}")
    docs = [analyze_trace(group, since_ts=since_ts, window_index=window_index) for group in groups]
    if as_json:
        print(json.dumps(docs[0] if len(docs) == 1 else docs, indent=1), flush=True)
    else:
        print("\n\n".join(render_analysis(doc) for doc in docs), flush=True)
    return 0


def slo_status(directory: str, config_path: Optional[str] = None, as_json: bool = False,
               watch: Optional[float] = None, check: bool = False) -> int:
    """The ``slo status`` command (``slo check`` with ``check``): evaluate
    ``directory``'s SLOs and print the status; the exit code, 1 for a
    check while an alert fires."""
    import json
    import time

    from ..telemetry import slo

    while True:
        if not os.path.isdir(directory):
            return _fail(f"No such directory: {directory}")
        try:
            config = slo.load_slo_config(directory, path=config_path)
        except (OSError, ValueError) as exc:
            return _fail(f"Bad SLO config: {exc}")
        try:
            doc = slo.evaluate(directory, config=config)
        except OSError as exc:
            return _fail(f"SLO evaluation failed: {exc}")
        print(json.dumps(doc, indent=1, sort_keys=True, default=str) if as_json else slo.render_slo_status(doc),
              flush=True)
        if check:
            return 1 if doc.get("firing") else 0
        if watch is None:
            return 0
        time.sleep(max(0.1, watch))
        print("")


def bench_check(candidate: str, baseline_path: Optional[str] = None, tolerance_scale: float = 1.0,
                report_only: bool = False, as_json: bool = False) -> int:
    """The ``bench-check`` command: print the comparison of ``candidate``
    with its baseline; the exit code."""
    import json

    from ..telemetry.benchgate import BASELINE_FILES, compare_files, render_report

    if baseline_path is None:
        try:
            with open(candidate) as handle:
                bench = json.load(handle).get("bench")
        except (OSError, ValueError) as exc:
            return _fail(f"Unreadable candidate: {exc}")
        default_name = BASELINE_FILES.get(str(bench))
        if default_name is None:
            return _fail(f"No default baseline known for bench {bench!r}; pass --baseline")
        for directory in (os.path.dirname(os.path.abspath(candidate)), os.getcwd()):
            probe = os.path.join(directory, default_name)
            if os.path.exists(probe) and os.path.abspath(probe) != os.path.abspath(candidate):
                baseline_path = probe
                break
        if baseline_path is None:
            return _fail(f"Committed baseline {default_name} not found beside the candidate or in the current "
                         "directory; pass --baseline")
    try:
        report = compare_files(baseline_path, candidate, tolerance_scale=tolerance_scale)
    except (OSError, ValueError) as exc:
        return _fail(str(exc))
    print(json.dumps(report, indent=1, sort_keys=True) if as_json else render_report(report), flush=True)
    return 1 if not report["ok"] and not report_only else 0


def _lifecycle_supervisor(collection_dir: str, machines_config: Optional[str], canary_fraction: Optional[float],
                          device: Optional[str], auto_promote: Optional[bool] = None):
    from ..lifecycle import LifecycleConfig, LifecycleSupervisor
    from .. import resolve_device
    from ..server.fleet_store import FleetModelStore

    machines = load_fleet_machines(machines_config) if machines_config else []
    config = LifecycleConfig.from_env()
    if canary_fraction is not None:
        config.canary_fraction = canary_fraction
    if auto_promote is not None:
        config.auto_promote = auto_promote
    store = FleetModelStore(collection_dir, resolve_device(device))
    return LifecycleSupervisor(machines, collection_dir, store, config=config)


def lifecycle_frames(machines: List[Machine]) -> dict:
    """One probe window a machine, its own dataset's rows; a machine whose
    fetch fails adds none this cycle."""
    from ..dataset.datasets import GordoBaseDataset

    frames = {}
    for machine in machines:
        try:
            dataset = (machine.dataset if isinstance(machine.dataset, GordoBaseDataset)
                       else GordoBaseDataset.from_dict(machine.dataset))
            frames[machine.name] = dataset.get_data()[0]
        except Exception as exc:  # noqa: BLE001 - per-machine isolation
            logger.warning("lifecycle probe fetch failed for %s: %r", machine.name, exc)
    return frames


def _echo_cycle(report) -> None:
    print(f"phase: {report.phase}")
    for name, reasons in sorted(report.drifted.items()):
        print(f"  drifted {name}: {'; '.join(reasons)}")
    if report.canary_revision:
        print(f"  canary revision: {report.canary_revision}")
    if report.gate is not None:
        print(f"  gates: {'PASSED' if report.gate['passed'] else 'FAILED'}")
        for failure in report.gate["failures"]:
            print(f"    {failure}")
    if report.promoted:
        print(f"  promoted (swap {report.details.get('swap_seconds', 0)}s)")
    if report.rolled_back:
        print("  rolled back; serving stays on the last-good revision")
    sys.stdout.flush()


def lifecycle_run(machines_config: str, collection_dir: str, once: bool = False, interval: float = 300.0,
                  cycles: Optional[int] = None, canary_fraction: Optional[float] = None, auto_promote: bool = True,
                  dry_run: bool = False, device: Optional[str] = None) -> int:
    """``lifecycle run``: supervise ``collection_dir``, a cycle every
    ``interval`` seconds (one with ``once``, ``cycles`` at most); exit code."""
    import time

    supervisor = _lifecycle_supervisor(collection_dir, machines_config, canary_fraction, device, auto_promote)
    try:
        ran = 0
        while True:
            frames = lifecycle_frames(supervisor.machines)
            if dry_run:
                supervisor.observe(frames)
                for name, verdict in sorted(supervisor.evaluate_drift().items()):
                    print(f"{name}: {'DRIFTED' if verdict.drifted else 'ok'} {'; '.join(verdict.reasons)}")
            else:
                _echo_cycle(supervisor.run_cycle(frames))
            ran += 1
            if once or (cycles is not None and ran >= cycles):
                return 0
            time.sleep(interval)
    finally:
        supervisor.close()


def lifecycle_status(models_root: str, as_json: bool = False) -> int:
    """``lifecycle status``: the state and quarantine record of ``models_root``."""
    import json

    from ..lifecycle import LifecycleState

    state = LifecycleState.load(models_root)
    quarantined = state.quarantined()
    if as_json:
        print(json.dumps({"state": state.doc, "quarantined": quarantined}, indent=1, sort_keys=True, default=str))
        return 0
    print(f"phase:    {state.phase}")
    print(f"anchor:   {state.anchor_revision}")
    print(f"serving:  {state.serving_revision}")
    print(f"canary:   {state.canary_revision or '-'}")
    if state.stale:
        print(f"stale:    {', '.join(state.stale)}")
    for entry in (state.doc.get("history") or [])[-5:]:
        print(f"  {entry.get('event')}: serving={entry.get('serving_revision')} canary={entry.get('canary_revision')}")
    print(f"quarantined canaries: {len(quarantined)}")
    for record in quarantined[-3:]:
        print(f"  revision {record.get('canary_revision')}: {'; '.join(record.get('reasons', [])[:2])}")
    return 0


def lifecycle_promote(collection_dir: str, machines_config: Optional[str] = None, force: bool = False,
                      device: Optional[str] = None) -> int:
    """``lifecycle promote``: gate (on a probe window fetched with
    ``machines_config``) and promote the canary, or promote it with ``force``."""
    supervisor = _lifecycle_supervisor(collection_dir, machines_config, None, device)
    try:
        if machines_config and not force:
            supervisor.observe(lifecycle_frames(supervisor.machines))
        report = supervisor.promote(force=force)
    except RuntimeError as exc:
        return _fail(str(exc))
    finally:
        supervisor.close()
    _echo_cycle(report)
    if report.rolled_back:
        return _fail("gates failed; canary rolled back")
    return 0


def lifecycle_rollback(collection_dir: str, reason: str = "operator rollback", device: Optional[str] = None) -> int:
    """``lifecycle rollback``: end the canary's slice and quarantine it."""
    supervisor = _lifecycle_supervisor(collection_dir, None, None, device)
    try:
        report = supervisor.rollback(reason)
    except RuntimeError as exc:
        return _fail(str(exc))
    finally:
        supervisor.close()
    _echo_cycle(report)
    return 0


def _fraction(text: str) -> float:
    value = float(text)
    if not 0.0 < value <= 1.0:
        raise argparse.ArgumentTypeError(f"{value} is not in the range 0<x<=1")
    return value


def _positive(kind):
    def parse(text: str):
        value = kind(text)
        if value < (1 if kind is int else 0):
            raise argparse.ArgumentTypeError(f"{value} is not in the range x>={1 if kind is int else 0}")
        return value
    return parse


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch")
    parser.add_argument("--log-level", default="INFO")
    commands = parser.add_subparsers(dest="command", required=True)

    def reporting(command: argparse.ArgumentParser) -> None:
        command.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        command.add_argument("--exceptions-reporter-file", default=os.environ.get("EXCEPTIONS_REPORTER_FILE"))
        command.add_argument("--exceptions-report-level", type=str.upper, choices=ReportLevel.get_names(),
                             default=os.environ.get("EXCEPTIONS_REPORT_LEVEL", "MESSAGE"))
        command.add_argument("--model-register-dir", default=os.environ.get("MODEL_REGISTER_DIR"))

    one = commands.add_parser("build", help="build one machine with the sequential builder")
    one.add_argument("machine_config", nargs="?", default=os.environ.get("MACHINE"),
                     help="the machine's config, JSON or YAML text (default $MACHINE)")
    one.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                     help="where the artifact goes (default $OUTPUT_DIR, else /data)")
    reporting(one)
    one.add_argument("--model-builder-class", default=os.environ.get("MODEL_BUILDER_CLASS"),
                     help="a subclass of gordo_tpu_torch.builder.build_model.ModelBuilder, as module.path.Name")
    one.add_argument("--print-cv-scores", action="store_true", help="print the CV scores to stdout")
    one.add_argument("--model-parameter", type=key_value_par, action="append", default=[],
                     help="key,value of a model parameter, for a model given as a template string; repeatable")

    build = commands.add_parser("build-fleet", help="build every machine of a shard")
    build.add_argument("machines_config", nargs="?", default=os.environ.get("MACHINES_CONFIG"),
                       help="path to, or text of, the machines document (default $MACHINES_CONFIG)")
    build.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                       help="where the artifacts go (default $OUTPUT_DIR, else /data)")
    reporting(build)
    build.add_argument("--resume", action="store_true", default=env_bool("FLEET_RESUME", False),
                       help="skip the machines the output directory's journal has built (default $FLEET_RESUME)")
    build.add_argument("--plan-strategy", choices=("naive", "packed"), default=None,
                       help="bucket strategy: naive (default, also $GORDO_TPU_PLAN_STRATEGY) or packed (the cost "
                            "model's bin packer)")
    build.add_argument("--plan-from", default=None,
                       help="replay a FleetPlan of the plan command: its members train in their planned buckets")
    build.add_argument("--cost-table", default=None, help="a calibrated cost_table.json for the cost model")
    build.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                       help="the ranks' torch.distributed backend (default nccl on cards, gloo on the CPU); "
                            "gloo lets ranks share one card")

    plan_ = commands.add_parser("plan", help="the FleetPlan a build-fleet of a shard would run")
    plan_.add_argument("machines_config", nargs="?", default=os.environ.get("MACHINES_CONFIG"),
                       help="path to, or text of, the machines document (default $MACHINES_CONFIG)")
    plan_.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    plan_.add_argument("--strategy", choices=("naive", "packed"), default=None,
                       help="bucket strategy (default $GORDO_TPU_PLAN_STRATEGY, else naive)")
    plan_.add_argument("--output", "-o", dest="output_path", default=None,
                       help="write the FleetPlan JSON here (for build-fleet --plan-from)")
    plan_.add_argument("--cost-table", default=None, help="a calibrated cost_table.json (default: the analytic one)")
    plan_.add_argument("--calibrate-from", default=None,
                       help="fit a cost table from this build_trace.jsonl first and plan with it")
    plan_.add_argument("--cost-table-out", default=None,
                       help="where --calibrate-from saves the table (default: cost_table.json beside the trace)")
    plan_.add_argument("--as-json", action="store_true", help="print the plan's document instead of the table")

    status = commands.add_parser("build-status", help="render a fleet build's build_status.json")
    status.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR"),
                        help="the build's output directory (default $OUTPUT_DIR)")
    status.add_argument("--as-json", action="store_true", help="print the raw document instead of the table")
    status.add_argument("--watch", type=float, default=None,
                        help="render again every N seconds until the build leaves 'running'")

    fleet = commands.add_parser("fleet-status", help="render the joined fleet-status document of a directory")
    fleet.add_argument("directory", nargs="?", default=os.environ.get("OUTPUT_DIR"),
                       help="a build's output or a served revision directory (default $OUTPUT_DIR)")
    fleet.add_argument("--as-json", action="store_true", help="print the raw document instead of the table")
    fleet.add_argument("--watch", type=float, default=None, help="render again every N seconds (Ctrl-C to stop)")
    fleet.add_argument("--machines", default=None,
                       help="records to show: all, none, a state (healthy, degraded, drifting, quarantined, "
                            "unhealthy) or a comma list of names; default: inline while the fleet is small")
    fleet.add_argument("--limit", type=int, default=None,
                       help="page size of a --machines selection (at most 500)")
    fleet.add_argument("--offset", type=int, default=0, help="page offset of a --machines selection")

    trace_ = commands.add_parser("trace", help="analyze a span trace: latency, stage breakdown, streams, profile")
    trace_.add_argument("target", nargs="?", default=os.environ.get("OUTPUT_DIR"),
                        help="a trace file, or a telemetry or build directory (default $OUTPUT_DIR)")
    trace_.add_argument("--as-json", action="store_true", help="print the raw analysis instead of the report")
    trace_.add_argument("--since", default=None,
                        help="only spans ending at or after this ISO time (or epoch seconds); older rotated "
                             "generations are skipped unread")
    trace_.add_argument("--last", default=None, help="only the trailing window, e.g. 1h, 90m, 7d (not with --since)")

    slo_ = commands.add_parser("slo", help="the SLO engine: rollups, error budgets, burn-rate alerts")
    slo_commands = slo_.add_subparsers(dest="slo_command", required=True)
    for name, help_ in (("status", "evaluate and render the SLO status of a directory"),
                        ("check", "evaluate, and exit 1 while a burn-rate alert is firing")):
        command = slo_commands.add_parser(name, help=help_)
        command.add_argument("directory", nargs="?", default=os.environ.get("GORDO_TPU_TELEMETRY_DIR"),
                             help="a telemetry or build directory (default $GORDO_TPU_TELEMETRY_DIR)")
        command.add_argument("--config", default=None, help="the slos.toml to evaluate against (default "
                             "$GORDO_TPU_SLO_CONFIG, then DIRECTORY/slos.toml, then the packaged one)")
        command.add_argument("--as-json", action="store_true", help="print the raw status instead of the table")
        if name == "status":
            command.add_argument("--watch", type=float, default=None,
                                 help="evaluate and render again every N seconds (Ctrl-C to stop)")

    bench = commands.add_parser("bench-check", help="the performance-regression gate: a bench run against its "
                                "committed baseline")
    bench.add_argument("candidate", help="a fresh bench run, a BENCH_*.json-shaped document")
    bench.add_argument("--baseline", default=None, help="the baseline document (default: the committed BENCH_*.json "
                       "of the candidate's bench kind, beside the candidate, then in the current directory)")
    bench.add_argument("--tolerance", type=float, default=1.0,
                       help="scale every gate's tolerance by this factor (2.0 = twice as lenient)")
    bench.add_argument("--report-only", action="store_true", help="always exit 0: print the comparison, never gate")
    bench.add_argument("--as-json", action="store_true", help="print the raw comparison instead of the report")

    lifecycle = commands.add_parser("lifecycle", help="the fleet lifecycle: drift-triggered rebuilds, canaries, "
                                    "promotion and rollback")
    lifecycle_commands = lifecycle.add_subparsers(dest="lifecycle_command", required=True)
    run = lifecycle_commands.add_parser("run", help="supervise a served revision directory")
    run.add_argument("machines_config", nargs="?", default=os.environ.get("MACHINES_CONFIG"),
                     help="path to, or text of, the machines document (default $MACHINES_CONFIG)")
    run.add_argument("collection_dir", nargs="?", default=os.environ.get("MODEL_COLLECTION_DIR"),
                     help="the served revision directory (default $MODEL_COLLECTION_DIR)")
    run.add_argument("--once", action="store_true", help="run a single cycle and exit (cron mode)")
    run.add_argument("--interval", type=_positive(float), default=300.0,
                     help="seconds between cycles in loop mode (default 300)")
    run.add_argument("--cycles", type=_positive(int), default=None,
                     help="stop after this many cycles (default: run forever)")
    run.add_argument("--canary-fraction", type=_fraction, default=None,
                     help="traffic slice routed to a canary under evaluation [GORDO_TPU_CANARY_FRACTION, default 0.25]")
    run.add_argument("--auto-promote", action=argparse.BooleanOptionalAction, default=True,
                     help="promote when the gates pass (default); off leaves the canary serving until "
                          "`lifecycle promote`")
    run.add_argument("--dry-run", action="store_true", help="observe and report drift only; never rebuild or route")
    status_ = lifecycle_commands.add_parser("status", help="the lifecycle state and quarantine record")
    status_.add_argument("models_root", nargs="?", default=os.environ.get("MODELS_ROOT"),
                         help="the directory holding the numbered revisions (default $MODELS_ROOT)")
    status_.add_argument("--as-json", "--json", dest="as_json", action="store_true", help="machine-readable output")
    promote = lifecycle_commands.add_parser("promote", help="promote the current canary revision into serving")
    promote.add_argument("collection_dir", nargs="?", default=os.environ.get("MODEL_COLLECTION_DIR"),
                         help="the served revision directory (default $MODEL_COLLECTION_DIR)")
    promote.add_argument("--machines-config", default=os.environ.get("MACHINES_CONFIG"),
                         help="machine document for fetching a probe window (gates need scored data; without it "
                              "only --force can promote)")
    promote.add_argument("--force", action="store_true",
                         help="skip the gates (operator has verified the canary externally)")
    rollback = lifecycle_commands.add_parser("rollback", help="roll back the current canary and quarantine it")
    rollback.add_argument("collection_dir", nargs="?", default=os.environ.get("MODEL_COLLECTION_DIR"),
                          help="the served revision directory (default $MODEL_COLLECTION_DIR)")
    rollback.add_argument("--reason", default="operator rollback", help="recorded in the quarantine entry")
    for command in (run, promote, rollback):
        command.add_argument("--device", default="cuda", help="cuda (default) or cpu: where the fleets score")

    normalize = commands.add_parser("normalize", help="print the shard of a project config")
    normalize.add_argument("config", help="the project's YAML config (a CRD document or its spec.config)")
    normalize.add_argument("project_name")
    normalize.add_argument("--output", default=None, help="write the shard here instead of printing it")
    deploy.add_parsers(commands)
    perfmodel.add_parser(commands)
    add_client_parser(commands)
    workflow_generator.add_parser(commands)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    """Run a command; its exit code."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(), format="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    if args.command == "normalize":
        from ..workflow.workflow_generator import normalize

        document = normalize(args.config, args.project_name)
        if args.output:
            with open(args.output, "w") as f:
                f.write(document)
        else:
            print(document)
        return 0
    if args.command == "workflow":
        return workflow_generator.main(parser, args)
    if args.command == "lifecycle":
        return _lifecycle_command(parser, args)
    if args.command == "perfmodel":
        return perfmodel.main(parser, args)
    if args.command in DEPLOY_COMMANDS:
        return deploy.main(parser, args)
    if args.command == "client":
        return client_main(parser, args)
    if args.command == "bench-check":
        for option, path in (("CANDIDATE", args.candidate), ("--baseline", args.baseline)):
            if path is not None and not os.path.isfile(path):
                parser.error(f"{option}: file {path!r} does not exist")
        return bench_check(args.candidate, args.baseline, args.tolerance, args.report_only, args.as_json)
    if args.command == "trace":
        if not args.target:
            parser.error("TARGET is required (argument or $OUTPUT_DIR)")
        return trace(args.target, args.as_json, args.since, args.last)
    if args.command == "slo":
        if not args.directory:
            parser.error("DIRECTORY is required (argument or $GORDO_TPU_TELEMETRY_DIR)")
        if args.config is not None and not os.path.isfile(args.config):
            parser.error(f"--config: file {args.config!r} does not exist")
        return slo_status(args.directory, args.config, args.as_json, getattr(args, "watch", None),
                          check=args.slo_command == "check")
    if args.command == "fleet-status":
        if not args.directory:
            parser.error("DIRECTORY is required (argument or $OUTPUT_DIR)")
        return fleet_status(args.directory, args.as_json, args.watch, args.machines, args.limit, args.offset)
    if args.command == "build-status":
        if not args.output_dir:
            parser.error("OUTPUT_DIR is required (argument or $OUTPUT_DIR)")
        return build_status(args.output_dir, args.as_json, args.watch)
    if args.command == "plan":
        if not args.machines_config:
            parser.error("MACHINES_CONFIG is required (argument or $MACHINES_CONFIG)")
        for option, path in (("--cost-table", args.cost_table), ("--calibrate-from", args.calibrate_from)):
            if path is not None and not os.path.isfile(path):
                parser.error(f"{option}: file {path!r} does not exist")
        return plan_fleet(args.machines_config, args.device, args.strategy, args.output_path, args.cost_table,
                          args.calibrate_from, args.cost_table_out, args.as_json)
    if args.command == "build":
        if not args.machine_config:
            parser.error("MACHINE is required (argument or $MACHINE)")
        return build(args.machine_config, args.output_dir, args.device, args.model_register_dir,
                     args.model_builder_class, args.print_cv_scores, args.exceptions_reporter_file,
                     args.exceptions_report_level, args.model_parameter)
    if not args.machines_config:
        parser.error("MACHINES_CONFIG is required (argument or $MACHINES_CONFIG)")
    for option, path in (("--plan-from", args.plan_from), ("--cost-table", args.cost_table)):
        if path is not None and not os.path.isfile(path):
            parser.error(f"{option}: file {path!r} does not exist")
    command = (args.machines_config, args.output_dir, args.device, args.exceptions_reporter_file,
               args.exceptions_report_level, args.resume, args.model_register_dir, args.plan_strategy,
               args.plan_from, args.cost_table, args.dist_backend)
    try:
        cards = visible_cards(args.device)
    except Exception:
        return _report(args.exceptions_reporter_file, args.exceptions_report_level)
    if cards > 1:
        return spawn_build_fleet(cards, *command)
    code, _ = build_fleet(*command)
    return code


def _lifecycle_command(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    command = args.lifecycle_command
    if command == "status":
        if not args.models_root:
            parser.error("MODELS_ROOT is required (argument or $MODELS_ROOT)")
        return lifecycle_status(args.models_root, args.as_json)
    if not args.collection_dir:
        parser.error("COLLECTION_DIR is required (argument or $MODEL_COLLECTION_DIR)")
    if command == "promote":
        return lifecycle_promote(args.collection_dir, args.machines_config, args.force, args.device)
    if command == "rollback":
        return lifecycle_rollback(args.collection_dir, args.reason, args.device)
    if not args.machines_config:
        parser.error("MACHINES_CONFIG is required (argument or $MACHINES_CONFIG)")
    return lifecycle_run(args.machines_config, args.collection_dir, args.once, args.interval, args.cycles,
                         args.canary_fraction, args.auto_promote, args.dry_run, args.device)
