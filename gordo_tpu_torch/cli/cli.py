"""
The port's command line (``python -m gordo_tpu_torch``), on ``argparse``:

- ``build-fleet MACHINES_CONFIG OUTPUT_DIR [--device cuda|cpu]``: the JAX
  package's ``build-fleet`` (``gordo_tpu/cli/cli.py:558-725``). It builds
  every machine of a shard (a path to, or the text of, a ``machines:``
  document; ``$MACHINES_CONFIG`` when not given) with
  ``parallel/fleet_build.py`` into ``OUTPUT_DIR`` (default
  ``$OUTPUT_DIR``, else ``/data``), on the card unless ``--device cpu``.
  A machine without ``project_name`` takes the document's, else
  ``fleet-build``. It exits with the code of the exception that failed
  it (:data:`EXIT_CODES`); when some machines fail and the rest are
  dumped, with the first failure's; ``--exceptions-reporter-file`` writes
  the JSON report. ``--resume``, ``--plan-strategy``, ``--plan-from``,
  ``--cost-table`` and ``--model-register-dir`` are refused: the port has
  no build journal, planner or model register yet (``ROADMAP.md`` queue
  1, items 7 and 8).
- ``normalize CONFIG PROJECT``: the shard of a project config, what
  ``workflow generate`` puts into its ConfigMaps
  (``workflow/workflow_generator.py::normalize``), printed or written to
  ``--output``.
"""

import argparse
import logging
import os
import sys
import traceback
from typing import List, Optional, Tuple

from ..dataset.exceptions import ConfigException, InsufficientDataError, NoSuitableDataProviderError
from ..dataset.sensor_tag import SensorTagNormalizationError
from ..machine import Machine
from ..utils import yaml_lite
from .exceptions_reporter import ExceptionsReporter, ReportLevel

logger = logging.getLogger(__name__)

#: exception type to exit code, the JAX command's map (``cli.py:47-60``)
#: without its reporters' exception: the port runs no reporters
EXIT_CODES = (
    (Exception, 1),
    (ValueError, 2),
    (PermissionError, 20),
    (FileNotFoundError, 30),
    (SensorTagNormalizationError, 60),
    (NoSuitableDataProviderError, 70),
    (InsufficientDataError, 80),
    (ImportError, 85),
    (ConfigException, 100),
)
_reporter = ExceptionsReporter(EXIT_CODES)

#: the JAX command's options that the port refuses, and why
_REFUSED = {
    "resume": "--resume needs the build journal (ROADMAP.md queue 1, item 8)",
    "plan_strategy": "--plan-strategy needs the packing planner (ROADMAP.md queue 1, item 7)",
    "plan_from": "--plan-from needs the packing planner (ROADMAP.md queue 1, item 7)",
    "cost_table": "--cost-table needs the packing planner's cost model (ROADMAP.md queue 1, item 7)",
    "model_register_dir": "--model-register-dir needs the model-register cache (ROADMAP.md queue 1, item 8)",
}


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


def build_fleet(
    machines_config: str,
    output_dir: str,
    device: Optional[str] = None,
    exceptions_reporter_file: Optional[str] = None,
    exceptions_report_level: str = ReportLevel.MESSAGE.name,
) -> Tuple[int, Optional[object]]:
    """The ``build-fleet`` command: its exit code and the ``FleetBuilder``
    (None when the shard did not load)."""
    from ..parallel.fleet_build import FleetBuilder

    builder = None
    try:
        machines = load_fleet_machines(machines_config)
        logger.info("Fleet-building %d machines; output at %s", len(machines), output_dir)
        builder = FleetBuilder(machines, device=device)
        results = builder.build(output_dir)
        logger.info("Fleet build complete: %d built, %d failed", len(results), len(builder.build_errors))
        if builder.build_errors:
            _, exc = next(iter(builder.build_errors.items()))
            raise exc
        return 0, builder
    except Exception:
        traceback.print_exc()
        exc_type, exc_value, exc_traceback = sys.exc_info()
        if exceptions_reporter_file:
            level = ReportLevel.get_by_name(exceptions_report_level.upper(), ReportLevel.EXIT_CODE)
            _reporter.safe_report(level, exc_type, exc_value, exc_traceback, exceptions_reporter_file,
                                  max_message_len=2024 - 500)
        return _reporter.exception_exit_code(exc_type), builder


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch")
    parser.add_argument("--log-level", default="INFO")
    commands = parser.add_subparsers(dest="command", required=True)

    build = commands.add_parser("build-fleet", help="build every machine of a shard")
    build.add_argument("machines_config", nargs="?", default=os.environ.get("MACHINES_CONFIG"),
                       help="path to, or text of, the machines document (default $MACHINES_CONFIG)")
    build.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                       help="where the artifacts go (default $OUTPUT_DIR, else /data)")
    build.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    build.add_argument("--exceptions-reporter-file", default=os.environ.get("EXCEPTIONS_REPORTER_FILE"))
    build.add_argument("--exceptions-report-level", default=os.environ.get("EXCEPTIONS_REPORT_LEVEL", "MESSAGE"),
                       type=str.upper, choices=ReportLevel.get_names())
    build.add_argument("--resume", action="store_true", default=bool(os.environ.get("FLEET_RESUME")))
    build.add_argument("--plan-strategy", default=None)
    build.add_argument("--plan-from", default=None)
    build.add_argument("--cost-table", default=None)
    build.add_argument("--model-register-dir", default=os.environ.get("MODEL_REGISTER_DIR"))

    normalize = commands.add_parser("normalize", help="print the shard of a project config")
    normalize.add_argument("config", help="the project's YAML config (a CRD document or its spec.config)")
    normalize.add_argument("project_name")
    normalize.add_argument("--output", default=None, help="write the shard here instead of printing it")
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
    for option, reason in _REFUSED.items():
        if getattr(args, option):
            parser.error(f"{reason}, which gordo_tpu_torch does not have yet")
    if not args.machines_config:
        parser.error("MACHINES_CONFIG is required (argument or $MACHINES_CONFIG)")
    code, _ = build_fleet(args.machines_config, args.output_dir, args.device, args.exceptions_reporter_file,
                          args.exceptions_report_level)
    return code
