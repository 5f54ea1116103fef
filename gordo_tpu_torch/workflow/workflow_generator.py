"""
The two halves of ``workflow generate`` that a fleet build needs, in the
port: :func:`get_dict_from_yaml`
(``gordo_tpu/workflow/workflow_generator/workflow_generator.py:51-85``)
and the machine shard (``gordo_tpu/cli/workflow_generator.py:159-165``).
The Argo/Jinja rendering is not ported.

The shard is written as JSON text: JSON is YAML, so both packages'
readers take it, and the port has no YAML writer.
"""

import datetime
import io
import json
import os
from typing import Any, Iterable, Union

from ..utils import yaml_lite
from .config_elements.normalized_config import NormalizedConfig


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


def _json_default(obj: Any) -> Any:
    if isinstance(obj, (datetime.datetime, datetime.date)):
        return obj.isoformat()
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def machines_document(machines: Iterable[Any]) -> str:
    """The shard ``build-fleet`` reads: ``{"machines": [machine.to_dict(),
    ...]}`` as JSON, datetimes as ISO strings."""
    return json.dumps({"machines": [m.to_dict() for m in machines]}, default=_json_default, indent=1)


def normalize(config_file: Union[str, io.StringIO], project_name: str) -> str:
    """The shard of a project config: what ``workflow generate`` puts into
    its ConfigMaps, for every machine of the config."""
    return machines_document(NormalizedConfig(get_dict_from_yaml(config_file), project_name).machines)
