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
  are ``build-fleet``'s. ``--model-parameter`` is refused: it renders the
  model config as a Jinja template, and the port has no Jinja
  (``ROADMAP.md`` queue 1, item 13). Unlike the JAX command, the port
  records the model definition as given, without every default filled in.
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
  the JSON report. ``--resume`` (``$FLEET_RESUME``) finishes a build that
  was cut short, from its journal; ``--model-register-dir`` shares the
  model-register cache with other builds. ``--plan-strategy``,
  ``--plan-from`` and ``--cost-table`` are refused: the port has no
  packing planner yet (``ROADMAP.md`` queue 1, item 7).
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
from ..utils.env import env_bool
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

#: the JAX commands' options that the port refuses, and why
_REFUSED = {
    "plan_strategy": "--plan-strategy needs the packing planner (ROADMAP.md queue 1, item 7)",
    "plan_from": "--plan-from needs the packing planner (ROADMAP.md queue 1, item 7)",
    "cost_table": "--cost-table needs the packing planner's cost model (ROADMAP.md queue 1, item 7)",
    "model_parameter": "--model-parameter renders the model config with Jinja (ROADMAP.md queue 1, item 13)",
}


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


def build(
    machine_config: str,
    output_dir: str,
    device: Optional[str] = None,
    model_register_dir: Optional[str] = None,
    model_builder_class: Optional[str] = None,
    print_cv_scores: bool = False,
    exceptions_reporter_file: Optional[str] = None,
    exceptions_report_level: str = ReportLevel.MESSAGE.name,
) -> int:
    """The ``build`` command: build one machine (``machine_config``, its
    JSON or YAML text) into ``output_dir``; the exit code."""
    from ..builder import create_model_builder

    try:
        config = yaml_lite.safe_load(machine_config)
        if not isinstance(config, dict):
            raise ValueError(f"MACHINE must be a mapping, got {type(config).__name__}")
        machine = Machine.from_config(config, project_name=config["project_name"])
        logger.info("Building, output will be at: %s", output_dir)
        logger.info("Register dir: %s", model_register_dir)
        builder = create_model_builder(model_builder_class)(machine, device=device)
        _, machine_out = builder.build(output_dir, model_register_dir)
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


def build_fleet(
    machines_config: str,
    output_dir: str,
    device: Optional[str] = None,
    exceptions_reporter_file: Optional[str] = None,
    exceptions_report_level: str = ReportLevel.MESSAGE.name,
    resume: bool = False,
    model_register_dir: Optional[str] = None,
) -> Tuple[int, Optional[object]]:
    """The ``build-fleet`` command: its exit code and the ``FleetBuilder``
    (None when the shard did not load)."""
    from ..parallel.fleet_build import FleetBuilder

    builder = None
    try:
        machines = load_fleet_machines(machines_config)
        logger.info("Fleet-building %d machines; output at %s", len(machines), output_dir)
        builder = FleetBuilder(machines, device=device)
        results = builder.build(output_dir, model_register_dir=model_register_dir, resume=resume)
        logger.info("Fleet build complete: %d built, %d resumed, %d failed", len(results), len(builder.resumed),
                    len(builder.build_errors))
        if builder.build_errors:
            _, exc = next(iter(builder.build_errors.items()))
            raise exc
        return 0, builder
    except Exception:
        return _report(exceptions_reporter_file, exceptions_report_level), builder


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
    one.add_argument("--model-parameter", action="append", default=[])

    build = commands.add_parser("build-fleet", help="build every machine of a shard")
    build.add_argument("machines_config", nargs="?", default=os.environ.get("MACHINES_CONFIG"),
                       help="path to, or text of, the machines document (default $MACHINES_CONFIG)")
    build.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                       help="where the artifacts go (default $OUTPUT_DIR, else /data)")
    reporting(build)
    build.add_argument("--resume", action="store_true", default=env_bool("FLEET_RESUME", False),
                       help="skip the machines the output directory's journal has built (default $FLEET_RESUME)")
    build.add_argument("--plan-strategy", default=None)
    build.add_argument("--plan-from", default=None)
    build.add_argument("--cost-table", default=None)

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
        if getattr(args, option, None):
            parser.error(f"{reason}, which gordo_tpu_torch does not have yet")
    if args.command == "build":
        if not args.machine_config:
            parser.error("MACHINE is required (argument or $MACHINE)")
        return build(args.machine_config, args.output_dir, args.device, args.model_register_dir,
                     args.model_builder_class, args.print_cv_scores, args.exceptions_reporter_file,
                     args.exceptions_report_level)
    if not args.machines_config:
        parser.error("MACHINES_CONFIG is required (argument or $MACHINES_CONFIG)")
    code, _ = build_fleet(args.machines_config, args.output_dir, args.device, args.exceptions_reporter_file,
                          args.exceptions_report_level, args.resume, args.model_register_dir)
    return code
