"""
Exit codes and the JSON failure report of a command, a copy of
``gordo_tpu/cli/exceptions_reporter.py``: the most-derived registered
exception type of the raised one gives the exit code (a walk of its
``__mro__``); the report's verbosity is ``EXIT_CODE``, ``TYPE``,
``MESSAGE`` or ``TRACEBACK``; its strings are scrubbed to ASCII and cut
to fit a Kubernetes termination message.
"""

import json
import traceback
from enum import Enum
from types import TracebackType
from typing import IO, Dict, Iterable, List, Optional, Tuple, Type

DEFAULT_EXIT_CODE = 1
_ELLIPSIS = "..."


class ReportLevel(Enum):
    """How much of a failure the report spells out."""

    EXIT_CODE = 0
    TYPE = 1
    MESSAGE = 2
    TRACEBACK = 3

    @classmethod
    def get_by_name(cls, name: str, default: Optional["ReportLevel"] = None) -> Optional["ReportLevel"]:
        return cls.__members__.get(name, default)

    @classmethod
    def get_names(cls) -> List[str]:
        return list(cls.__members__)


def _ascii(text: str) -> str:
    return "".join(ch if ord(ch) < 128 else "?" for ch in text)


def _clip(text: str, budget: int) -> str:
    if len(text) <= budget:
        return text
    if budget <= len(_ELLIPSIS):
        return ""
    return text[: budget - len(_ELLIPSIS)] + _ELLIPSIS


def _traceback_tail(lines: List[str], budget: int) -> List[str]:
    """The innermost lines that fit ``budget``, after a ``...`` line when
    outer frames were dropped."""
    marker = "...\n"
    if sum(map(len, lines)) <= budget:
        return lines
    tail: List[str] = []
    used = len(marker)
    for line in reversed(lines):
        if used + len(line) > budget:
            break
        tail.append(line)
        used += len(line)
    return [marker] + tail[::-1]


class ExceptionsReporter:
    """A ``{exception type: exit code}`` registry and the report writer."""

    def __init__(self, exceptions: Iterable[Tuple[Type[BaseException], int]],
                 default_exit_code: int = DEFAULT_EXIT_CODE, traceback_limit: Optional[int] = None):
        self._registry: Dict[Type[BaseException], int] = dict(exceptions)
        self.default_exit_code = default_exit_code
        self.traceback_limit = traceback_limit

    def _resolve(self, exc_type: Type[BaseException]) -> Optional[Type[BaseException]]:
        for klass in exc_type.__mro__:
            if klass in self._registry:
                return klass
        return None

    def exception_exit_code(self, exc_type: Optional[Type[BaseException]]) -> int:
        """The exit code for an exception type (0 for None)."""
        if exc_type is None:
            return 0
        match = self._resolve(exc_type)
        return self._registry[match] if match else self.default_exit_code

    def report(self, level: ReportLevel, exc_type, exc_value, exc_traceback: Optional[TracebackType],
               report_file: IO[str], max_message_len: Optional[int] = None) -> None:
        """Write the JSON report; an exception outside the registry, or the
        ``EXIT_CODE`` level, writes ``{}``."""
        payload: Dict[str, str] = {}
        have_failure = exc_type is not None and exc_value is not None and exc_traceback is not None
        if have_failure and level is not ReportLevel.EXIT_CODE and self._resolve(exc_type) is not None:
            payload["type"] = _ascii(exc_type.__name__)
            if level is ReportLevel.MESSAGE:
                text = _ascii(str(exc_value))
                payload["message"] = _clip(text, max_message_len) if max_message_len is not None else text
            elif level is ReportLevel.TRACEBACK:
                lines = [_ascii(line) for line in traceback.format_exception(
                    exc_type, exc_value, exc_traceback, limit=self.traceback_limit)]
                if max_message_len is not None:
                    lines = _traceback_tail(lines, max_message_len)
                payload["traceback"] = "".join(lines)
        json.dump(payload, report_file)

    def safe_report(self, level: ReportLevel, exc_type, exc_value, exc_traceback, report_file_path: str,
                    max_message_len: Optional[int] = None) -> None:
        """:meth:`report` into a file, never raising."""
        try:
            with open(report_file_path, "w") as report_file:
                self.report(level, exc_type, exc_value, exc_traceback, report_file, max_message_len)
        except Exception:
            traceback.print_exc()
