"""
The reporter contract, the port's ``gordo_tpu/reporters/base.py``: an
object with ``report(machine)``, made from a definition.

A config names the reporters by the JAX package's dotted paths
(``gordo_tpu.reporters.postgres.PostgresReporter``, a bare path for no
arguments); :func:`create_reporters` reads them through the port's path
table (``serializer/from_definition.py``'s :data:`REPORTERS`), and
:meth:`BaseReporter.to_dict` writes them back through
``serializer/into_definition.py``'s :data:`JAX_CLASSES`, under the JAX
paths with the JAX classes' defaults, so a machine's ``runtime.reporters``
round-trips to the JAX package's definition.
"""

import abc
import logging
from typing import Any, List

from ..utils.args import capture_args

logger = logging.getLogger(__name__)


class ReporterException(Exception):
    pass


class BaseReporter(abc.ABC):
    @abc.abstractmethod
    def report(self, machine) -> None:
        ...

    def get_params(self, deep: bool = False) -> dict:
        return dict(getattr(self, "_params", {}))

    def to_dict(self) -> dict:
        """The definition, as the JAX reporter's ``to_dict`` writes it."""
        from ..serializer.into_definition import into_definition

        return into_definition(self)

    @classmethod
    def from_dict(cls, config: Any) -> "BaseReporter":
        from ..serializer.from_definition import reporter_from_definition

        return reporter_from_definition(config)


class LogReporter(BaseReporter):
    """Logs each built machine; the reporter with no dependency."""

    @capture_args
    def __init__(self, level: str = "INFO"):
        self.level = level

    def report(self, machine) -> None:
        logger.log(logging.getLevelName(self.level), "Built machine %s (project %s)", machine.name,
                   machine.project_name)


def create_reporters(definitions: List[Any]) -> List[BaseReporter]:
    """The reporters of their definitions (a reporter passes through)."""
    from ..serializer.from_definition import reporter_from_definition

    reporters = []
    for definition in definitions or []:
        reporter = definition if isinstance(definition, BaseReporter) else reporter_from_definition(definition)
        if not isinstance(reporter, BaseReporter):
            raise ReporterException(f"{definition!r} did not resolve to a BaseReporter")
        reporters.append(reporter)
    return reporters
