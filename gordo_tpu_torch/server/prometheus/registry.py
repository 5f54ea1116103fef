"""
The part of ``prometheus_client`` the server's metrics use, written out
(the port does not depend on the library): a :class:`CollectorRegistry`,
:class:`Counter`, :class:`Gauge` and :class:`Histogram` with label
children, the scrape-time families a collector yields
(:class:`GaugeMetricFamily`, :class:`CounterMetricFamily`,
:class:`GaugeHistogramMetricFamily`) and :func:`generate_latest`, the
text exposition format 0.0.4 as ``prometheus_client.generate_latest``
writes it:

- ``# HELP`` (``\\`` and newlines escaped) and ``# TYPE`` a family, the
  families in registration order, each child's samples in the order its
  label values were first used;
- a counter's samples ``<name>_total`` and ``<name>_created``; a
  histogram's ``_bucket{le=...}`` (cumulative), ``_count``, ``_sum`` and
  ``_created``; a gauge histogram's ``_bucket``, ``_gcount`` and
  ``_gsum``; the ``_created``, ``_gcount`` and ``_gsum`` samples after the
  family's others, each set under a ``gauge`` family of its own;
- label names sorted within a sample, label values escaped (``\\``,
  ``"``, newlines), numbers as Go prints them (``1.0``, ``+Inf``, ``NaN``,
  ``1.7e+09``).

Every child keeps its own lock, so the server's request threads may
observe concurrently. :data:`REGISTRY` is the process's registry; unlike
``prometheus_client``'s, it carries no ``process_*`` or ``python_*``
collectors. A forked worker starts with it empty (its parent's metrics
are the parent's).

While ``PROMETHEUS_MULTIPROC_DIR`` is set, a child made from then on
keeps its numbers in this process's files of the directory
(``multiprocess.py``: the ``counter``, ``histogram`` and
``gauge_<multiprocess_mode>`` files, a gauge's mode ``all`` unless its
maker says otherwise); otherwise in memory.
"""

import bisect
import math
import re
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

from ...utils.postfork import register_postfork_reset

#: the ``Content-Type`` of an exposition
CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

INF = float("inf")

#: ``prometheus_client.Histogram.DEFAULT_BUCKETS``: request latencies in seconds
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0, INF)

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def float_to_go_string(value: Any) -> str:
    """A number as Go's ``strconv`` and ``prometheus_client`` print it.

    >>> [float_to_go_string(v) for v in (1, 0.25, float("inf"), 1.7e9 + 0.5, 1e16)]
    ['1.0', '0.25', '+Inf', '1.7000000005e+09', '1e+16']
    """
    d = float(value)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to an exponent sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


class Metric:
    """One family as a collector yields it: ``name``, ``documentation``
    (the HELP text), ``type`` and its ``samples``."""

    def __init__(self, name: str, documentation: str, typ: str):
        if not _METRIC_NAME.match(name):
            raise ValueError(f"Invalid metric name: {name}")
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples: List[Sample] = []

    def add_sample(self, name: str, labels: Dict[str, str], value: float) -> None:
        self.samples.append(Sample(name, labels, value))


class GaugeMetricFamily(Metric):
    """A gauge family a collector fills at scrape time."""

    def __init__(self, name: str, documentation: str, labels: Sequence[str] = ()):
        super().__init__(name, documentation, "gauge")
        self._labelnames = tuple(labels)

    def add_metric(self, labels: Sequence[str], value: float) -> None:
        self.add_sample(self.name, dict(zip(self._labelnames, labels)), float(value))


class CounterMetricFamily(Metric):
    """A counter family a collector fills at scrape time (``_total``
    samples, no ``_created``)."""

    def __init__(self, name: str, documentation: str, labels: Sequence[str] = ()):
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, "counter")
        self._labelnames = tuple(labels)

    def add_metric(self, labels: Sequence[str], value: float) -> None:
        self.add_sample(self.name + "_total", dict(zip(self._labelnames, labels)), float(value))


class GaugeHistogramMetricFamily(Metric):
    """A gauge histogram a collector fills at scrape time: cumulative
    ``(le, count)`` buckets ending at ``+Inf`` (whose count is the
    ``_gcount``) and the observations' sum (``_gsum``)."""

    def __init__(self, name: str, documentation: str, labels: Sequence[str] = ()):
        super().__init__(name, documentation, "gaugehistogram")
        self._labelnames = tuple(labels)

    def add_metric(self, labels: Sequence[str], buckets: Sequence[Tuple[str, float]], gsum_value: float) -> None:
        base = dict(zip(self._labelnames, labels))
        for le, value in buckets:
            self.add_sample(self.name + "_bucket", {**base, "le": le}, float(value))
        self.add_sample(self.name + "_gcount", dict(base), float(buckets[-1][1]))
        self.add_sample(self.name + "_gsum", dict(base), float(gsum_value))


class CollectorRegistry:
    """The metrics and collectors a scrape renders, in registration
    order. A name registered twice raises, as in ``prometheus_client``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: List[Any] = []
        self._names: set = set()

    def register(self, collector: Any) -> None:
        names = set(collector.describe_names()) if hasattr(collector, "describe_names") else set()
        with self._lock:
            if names & self._names:
                raise ValueError(f"Duplicated timeseries in CollectorRegistry: {names & self._names}")
            self._names |= names
            self._collectors.append(collector)

    def collect(self) -> Iterator[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            yield from collector.collect()


REGISTRY = CollectorRegistry()


def _reset_registry_after_fork() -> None:
    """A forked worker's process registry starts empty: the metrics its
    parent registered count the parent's numbers. The lock is rebound,
    never taken."""
    REGISTRY._lock = threading.Lock()
    REGISTRY._collectors = []
    REGISTRY._names = set()


register_postfork_reset(_reset_registry_after_fork, name="server.prometheus.registry.REGISTRY")


class _Value:
    """One number under its own lock (in memory)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def add(self, amount: float) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def get(self) -> float:
        with self._lock:
            return self.value


def make_value(typ: str, metric_name: str, name: str, labelnames: Sequence[str], labelvalues: Sequence[str],
               documentation: str, multiprocess_mode: str = "") -> Any:
    """A sample's number: in this process's file of the multi-process
    directory while one is set (``multiprocess.MmapedValue``), else in
    memory. ``name`` is the sample's (``<metric>_total``, ``_sum``, ...)."""
    from .multiprocess import MmapedValue, multiprocess_dir

    if multiprocess_dir():
        return MmapedValue(typ, metric_name, name, labelnames, labelvalues, documentation, multiprocess_mode)
    return _Value()


class _CounterChild:
    def __init__(self, value: Any):
        self._value = value
        self._created = time.time()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        self._value.add(float(amount))

    def samples(self) -> Iterable[Tuple[str, Dict[str, str], float]]:
        return (("_total", {}, self._value.get()), ("_created", {}, self._created))


class _GaugeChild:
    def __init__(self, value: Any):
        self._value = value

    def set(self, value: float) -> None:
        self._value.set(float(value))

    def samples(self) -> Iterable[Tuple[str, Dict[str, str], float]]:
        return (("", {}, self._value.get()),)


class _HistogramChild:
    """A histogram's sum and its counts a bucket (not cumulative), each a
    number of :func:`make_value`: ``values`` holds the sum's, then each
    bucket's."""

    def __init__(self, upper_bounds: Tuple[float, ...], values: List[Any]):
        self._upper_bounds = upper_bounds
        self._values = values
        self._created = time.time()

    def observe(self, amount: float) -> None:
        amount = float(amount)
        self._values[0].add(amount)
        if amount == amount:  # a NaN falls in no bucket
            self._values[1 + bisect.bisect_left(self._upper_bounds, amount)].add(1.0)

    def samples(self) -> Iterable[Tuple[str, Dict[str, str], float]]:
        total, counts = self._values[0].get(), [value.get() for value in self._values[1:]]
        out, acc = [], 0.0
        for bound, count in zip(self._upper_bounds, counts):
            acc += count
            out.append(("_bucket", {"le": float_to_go_string(bound)}, acc))
        out += [("_count", {}, acc), ("_sum", {}, total), ("_created", {}, self._created)]
        return out


class _MetricWrapper:
    """A metric with label children, registered on creation."""

    _type = ""
    _suffixes: Tuple[str, ...] = ("",)

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = REGISTRY):
        if not _METRIC_NAME.match(name):
            raise ValueError(f"Invalid metric name: {name}")
        for label in labelnames:
            if not _LABEL_NAME.match(label) or label.startswith("__"):
                raise ValueError(f"Invalid label metric name: {label}")
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if registry is not None:
            registry.register(self)

    def describe_names(self) -> List[str]:
        return [self._name + suffix for suffix in self._suffixes]

    def _child(self, labelvalues: Tuple[str, ...]) -> Any:
        raise NotImplementedError

    def _value(self, suffix: str, labelvalues: Tuple[str, ...], extra: Tuple[Tuple[str, str], ...] = (),
               multiprocess_mode: str = "") -> Any:
        """The number of the sample ``<name><suffix>`` of a child."""
        return make_value(self._type, self._name, self._name + suffix,
                          self._labelnames + tuple(k for k, _ in extra), labelvalues + tuple(v for _, v in extra),
                          self._documentation, multiprocess_mode)

    def labels(self, **labelkwargs: Any) -> Any:
        """The child of these label values, made on first use."""
        if sorted(labelkwargs) != sorted(self._labelnames):
            raise ValueError("Incorrect label names")
        values = tuple(str(labelkwargs[name]) for name in self._labelnames)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._child(values)
        return child

    def collect(self) -> List[Metric]:
        metric = Metric(self._name, self._documentation, self._type)
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            series = dict(zip(self._labelnames, values))
            for suffix, labels, value in child.samples():
                metric.add_sample(self._name + suffix, {**series, **labels}, value)
        return [metric]


class Counter(_MetricWrapper):
    """A counter; a name ending in ``_total`` loses the suffix, which its
    samples add back."""

    _type = "counter"
    _suffixes = ("", "_total", "_created")

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = REGISTRY):
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, labelnames, registry)

    def _child(self, labelvalues: Tuple[str, ...]) -> _CounterChild:
        return _CounterChild(self._value("_total", labelvalues))


class Gauge(_MetricWrapper):
    """A gauge; ``multiprocess_mode`` is how the multi-process fan-in
    merges its processes' numbers (``prometheus_client``'s modes)."""

    _type = "gauge"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = REGISTRY, multiprocess_mode: str = "all"):
        from .multiprocess import GAUGE_MODES

        if multiprocess_mode not in GAUGE_MODES:
            raise ValueError("Invalid multiprocess mode: " + multiprocess_mode)
        self._multiprocess_mode = multiprocess_mode
        super().__init__(name, documentation, labelnames, registry)

    def _child(self, labelvalues: Tuple[str, ...]) -> _GaugeChild:
        return _GaugeChild(self._value("", labelvalues, multiprocess_mode=self._multiprocess_mode))


class Histogram(_MetricWrapper):
    """A histogram over ``buckets`` (``+Inf`` appended when missing)."""

    _type = "histogram"
    _suffixes = ("", "_bucket", "_count", "_sum", "_created")

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = REGISTRY, buckets: Sequence[float] = DEFAULT_BUCKETS):
        if "le" in labelnames:
            raise ValueError("Invalid label name: le")
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if bounds and bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._upper_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _child(self, labelvalues: Tuple[str, ...]) -> _HistogramChild:
        # the sum's number first, then each bucket's, as prometheus_client makes them
        values = [self._value("_sum", labelvalues)] + [
            self._value("_bucket", labelvalues, (("le", float_to_go_string(bound)),)) for bound in self._upper_bounds]
        return _HistogramChild(self._upper_bounds, values)


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _sample_line(sample: Sample) -> str:
    labels = ""
    if sample.labels:
        labels = "{" + ",".join(
            '{}="{}"'.format(k, v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\""))
            for k, v in sorted(sample.labels.items())) + "}"
    return f"{sample.name}{labels} {float_to_go_string(sample.value)}\n"


#: family types as the text format 0.0.4 names them (a gauge histogram is typed a histogram)
_TEXT_TYPES = {"gaugehistogram": "histogram"}


def generate_latest(registry: CollectorRegistry = REGISTRY) -> bytes:
    """The registry's exposition in the text format 0.0.4, as UTF-8."""
    output: List[str] = []
    for metric in registry.collect():
        name = metric.name + "_total" if metric.type == "counter" else metric.name
        output.append(f"# HELP {name} {_escape_help(metric.documentation)}\n")
        output.append(f"# TYPE {name} {_TEXT_TYPES.get(metric.type, metric.type)}\n")
        trailing: Dict[str, List[str]] = {}
        for sample in metric.samples:
            for suffix in ("_created", "_gsum", "_gcount"):
                if sample.name == metric.name + suffix:
                    trailing.setdefault(suffix, []).append(_sample_line(sample))
                    break
            else:
                output.append(_sample_line(sample))
        for suffix, lines in sorted(trailing.items()):
            output.append(f"# HELP {metric.name}{suffix} {_escape_help(metric.documentation)}\n")
            output.append(f"# TYPE {metric.name}{suffix} gauge\n")
            output.extend(lines)
    return "".join(output).encode("utf-8")
