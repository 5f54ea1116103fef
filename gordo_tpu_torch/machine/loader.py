"""
Machine and globals config loading, ``gordo_tpu/machine/loader.py`` in
the port: a field of ``MACHINE_YAML_FIELDS`` given as a string holds YAML
and is read (with ``utils/yaml_lite.py``); a machine needs a ``name``.
"""

from typing import Any, Dict, Optional

from ..utils import yaml_lite
from .constants import MACHINE_YAML_FIELDS

GlobalsConfig = Dict[str, Any]
MachineConfig = Dict[str, Any]


def _parse_yaml_fields(config: dict) -> dict:
    config = dict(config)
    for field in MACHINE_YAML_FIELDS:
        value = config.get(field)
        if isinstance(value, str):
            config[field] = yaml_lite.safe_load(value)
    return config


def load_globals_config(config: Optional[dict]) -> GlobalsConfig:
    """
    A ``globals`` block with its YAML-in-string fields read.

    >>> load_globals_config({"model": "{'sklearn.pipeline.Pipeline': {}}"})["model"]
    {'sklearn.pipeline.Pipeline': {}}
    """
    if config is None:
        return {}
    if not isinstance(config, dict):
        raise ValueError(f"globals config must be a mapping, got {type(config)}")
    return _parse_yaml_fields(config)


def load_machine_config(config: dict) -> MachineConfig:
    """One machine block with its YAML-in-string fields read; requires ``name``."""
    if not isinstance(config, dict):
        raise ValueError(f"machine config must be a mapping, got {type(config)}")
    config = _parse_yaml_fields(config)
    if not config.get("name"):
        raise ValueError("machine config requires a 'name'")
    return config
