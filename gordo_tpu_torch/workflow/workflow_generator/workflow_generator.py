"""
The template machinery of ``workflow generate``, the port's
``gordo_tpu/workflow/workflow_generator/workflow_generator.py``:
:func:`get_dict_from_yaml` (``:51-85``), the machine shard
(``gordo_tpu/cli/workflow_generator.py:159-165``), the workflow template
(:func:`load_workflow_template`, :func:`default_workflow_template`) read
by the port's own renderer (``utils/template.py``), the owner-reference
check, and the ``imagePullPolicy`` the docker tag's version asks for
(:func:`parse_version`, ``gordo_tpu/utils/version.py``).

The shard, the template's ``yaml`` filter and ``Machine.to_yaml`` write
JSON text: JSON is YAML, so both packages' readers take it, and the port
has no YAML writer.
"""

import datetime
import io
import json
import os
import re
from dataclasses import dataclass
from enum import Enum
from typing import Any, Iterable, Optional, Union

from ...utils import yaml_lite
from ...utils.template import Template
from ...machine.machine import json_default as _json_default
from ..config_elements.normalized_config import NormalizedConfig


def _refuse_naive(node: Any, path: str = "") -> None:
    """A time stamp without a time zone anywhere in the document raises,
    as the JAX reader's timestamp constructor does (a bare date too)."""
    if isinstance(node, dict):
        for key, value in node.items():
            _refuse_naive(value, f"{path}/{key}")
    elif isinstance(node, list):
        for i, value in enumerate(node):
            _refuse_naive(value, f"{path}/{i}")
    elif isinstance(node, (datetime.datetime, datetime.date)):
        if not isinstance(node, datetime.datetime) or node.tzinfo is None:
            text = node.isoformat()
            raise ValueError(
                f"Provide timezone to timestamp {text} (at {path or '/'}). "
                f"Example: for UTC timezone use {text}Z or {text}+00:00 "
            )


def get_dict_from_yaml(config_file: Union[str, io.StringIO]) -> dict:
    """A YAML config file (a path or a file object) as a dict: time
    stamps must carry a time zone; a CRD document (``apiVersion``,
    ``kind``, ``spec.config``) is unwrapped to its ``spec.config``."""
    if hasattr(config_file, "read"):
        content = yaml_lite.safe_load(config_file.read())
    else:
        path = os.path.abspath(config_file)
        try:
            with open(path) as f:
                content = yaml_lite.safe_load(f.read())
        except FileNotFoundError:
            raise FileNotFoundError(f"Unable to find config file <{path}>")
    _refuse_naive(content)
    if "spec" in content:
        content = content["spec"]["config"]
    return content


def machines_document(machines: Iterable[Any]) -> str:
    """The shard ``build-fleet`` reads: ``{"machines": [machine.to_dict(),
    ...]}`` as JSON, datetimes as ISO strings."""
    return json.dumps({"machines": [m.to_dict() for m in machines]}, default=_json_default, indent=1)


def normalize(config_file: Union[str, io.StringIO], project_name: str) -> str:
    """The shard of a project config: what ``workflow generate`` puts into
    its ConfigMaps, for every machine of the config."""
    return machines_document(NormalizedConfig(get_dict_from_yaml(config_file), project_name).machines)


def _docker_friendly_version(version: str) -> str:
    """'+' is not valid in a docker tag."""
    return version.replace("+", "_")


def _valid_owner_ref(owner_reference_str: str) -> list:
    """A YAML or JSON list of k8s owner references, each with at least
    ``uid``, ``name``, ``kind`` and ``apiVersion``; else ``TypeError`` with
    the JAX package's text."""
    owner_ref = yaml_lite.safe_load(owner_reference_str)
    if not isinstance(owner_ref, list) or len(owner_ref) < 1:
        raise TypeError("Owner-references must be a list with at least one element")
    for oref in owner_ref:
        if not {"uid", "name", "kind", "apiVersion"} <= set(oref):
            raise TypeError(
                "All elements in owner-references must contain a uid, name, "
                "kind, and apiVersion key "
            )
    return owner_ref


def yaml_filter(data: Any) -> str:
    """The template's ``yaml`` filter: the data as JSON text (the JAX
    filter writes ``yaml.safe_dump``'s block YAML; both read back the same)."""
    return json.dumps(data, default=_json_default, sort_keys=True, indent=2) + "\n"


def load_workflow_template(workflow_template: str) -> Template:
    """The template at a path, strict about undefined names and with the
    ``yaml`` filter, as the JAX package's Jinja environment reads it."""
    with open(os.path.abspath(workflow_template)) as f:
        return Template(f.read(), strict=True, filters={"yaml": yaml_filter})


def default_workflow_template() -> str:
    """Path of the packaged workflow template (GPU builder pods)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources", "gpu-workflow.yml.template")


# -- docker tags (``gordo_tpu/utils/version.py``) -------------------------------------


class Special(Enum):
    LATEST = "latest"
    STABLE = "stable"


class Version:
    """A docker tag: a release, a special tag, a PR's tag or a git SHA."""


@dataclass(frozen=True)
class GordoRelease(Version):
    major: int
    minor: int
    patch: int
    suffix: Optional[str] = None

    def only_major(self) -> bool:
        return False

    def only_major_minor(self) -> bool:
        return False


@dataclass(frozen=True)
class GordoSpecial(Version):
    special: Special


@dataclass(frozen=True)
class GordoPR(Version):
    number: int


@dataclass(frozen=True)
class GordoSHA(Version):
    sha: str


_RELEASE_RE = re.compile(r"^(?P<major>\d+)\.(?P<minor>\d+)\.(?P<patch>\d+)(?P<suffix>[.\-+][0-9A-Za-z.\-+]+)?$")
_PR_RE = re.compile(r"^pr-(?P<number>\d+)$")
_SHA_RE = re.compile(r"^[0-9a-f]{7,40}$")


def parse_version(tag: str) -> Version:
    """A docker tag as one of the ``Version`` kinds; ``ValueError`` for
    any other.

    >>> parse_version("1.2.3"), parse_version("latest"), parse_version("pr-42")
    (GordoRelease(major=1, minor=2, patch=3, suffix=None), GordoSpecial(special=<Special.LATEST: 'latest'>), \
GordoPR(number=42))
    """
    for special in Special:
        if tag == special.value:
            return GordoSpecial(special)
    match = _RELEASE_RE.match(tag)
    if match:
        return GordoRelease(int(match.group("major")), int(match.group("minor")), int(match.group("patch")),
                            match.group("suffix"))
    match = _PR_RE.match(tag)
    if match:
        return GordoPR(int(match.group("number")))
    if _SHA_RE.match(tag):
        return GordoSHA(tag)
    raise ValueError(f"Unparseable docker tag: {tag!r}")


def default_image_pull_policy(gordo_version: Version) -> str:
    """Mutable tags (a PR's, ``latest``, ``stable``) always pull again; a
    pinned release or a SHA may be cached."""
    if isinstance(gordo_version, GordoRelease):
        if gordo_version.only_major() or gordo_version.only_major_minor():
            return "Always"
    elif isinstance(gordo_version, (GordoPR, GordoSpecial)):
        return "Always"
    return "IfNotPresent"
