"""
``NormalizedConfig``, ``gordo_tpu/workflow/config_elements/normalized_config.py``
in the port: a project config's ``globals`` laid over
``DEFAULT_CONFIG_GLOBALS``, the runtime blocks checked, and every machine
made through ``Machine.from_config``.

The JAX package checks the runtime blocks with pydantic schemas
(``schemas.py``); the port checks the same fields by hand
(:func:`check_runtime`): each pod block's ``image``, ``resources`` and
``env``, the builder's ``remote_logging``, ``volumes`` and
``volumeMounts``, and the ``fleet`` block, whose ``machines_per_slice``
and ``num_slices`` must be integers of at least 1 and whose unset fields
are dropped, as pydantic's ``model_dump(exclude_none=True)`` drops them.
"""

from copy import deepcopy
from typing import Any, Dict, List, Optional

from ...machine import Machine, load_globals_config, load_machine_config
from ..helpers import patch_dict


def _calculate_influx_resources(nr_of_machines: int) -> dict:
    """Influx sizing grows with the number of machines."""
    return {
        "requests": {
            "memory": min(3000 + (220 * nr_of_machines), 28000),
            "cpu": min(500 + (10 * nr_of_machines), 4000),
        },
        "limits": {
            "memory": min(3000 + (220 * nr_of_machines), 48000),
            "cpu": 10000 + (20 * nr_of_machines),
        },
    }


def _check_type(value: Any, types, where: str) -> None:
    if value is not None and not isinstance(value, types):
        names = " or ".join(t.__name__ for t in (types if isinstance(types, tuple) else (types,)))
        raise ValueError(f"{where} must be a {names}, got {value!r}")


def _check_pod(pod: Any, where: str, builder: bool = False) -> None:
    _check_type(pod, dict, where)
    _check_type(pod.get("image"), str, f"{where}.image")
    resources = pod.get("resources")
    _check_type(resources, dict, f"{where}.resources")
    for bound in ("requests", "limits"):
        _check_type((resources or {}).get(bound), dict, f"{where}.resources.{bound}")
    env = pod.get("env")
    _check_type(env, list, f"{where}.env")
    for i, var in enumerate(env or ()):
        _check_type(var, dict, f"{where}.env[{i}]")
        _check_type(var.get("name"), str, f"{where}.env[{i}].name")
        if "name" not in var:
            raise ValueError(f"{where}.env[{i}] needs a name")
        _check_type(var.get("value"), str, f"{where}.env[{i}].value")
        _check_type(var.get("valueFrom"), dict, f"{where}.env[{i}].valueFrom")
    if builder:
        _check_type(pod.get("remote_logging"), dict, f"{where}.remote_logging")
        for key, required in (("volumes", "name"), ("volumeMounts", "mountPath")):
            entries = pod.get(key)
            _check_type(entries, list, f"{where}.{key}")
            for i, entry in enumerate(entries or ()):
                _check_type(entry, dict, f"{where}.{key}[{i}]")
                for field in ("name", required):
                    if not isinstance(entry.get(field), str):
                        raise ValueError(f"{where}.{key}[{i}] needs a string {field}")


def _check_fleet(fleet: Any) -> dict:
    _check_type(fleet, dict, "runtime.fleet")
    out = {"accelerator_type": "v5litepod-16", "topology": None, "machines_per_slice": 1024, "num_slices": 1,
           "compute_dtype": "float32", "resources": None}
    out.update(fleet)
    for key in ("accelerator_type", "topology", "compute_dtype"):
        _check_type(out[key], str, f"runtime.fleet.{key}")
    for key in ("machines_per_slice", "num_slices"):
        value = out[key]
        if isinstance(value, bool) or not isinstance(value, (int, str)) or not str(value).strip().isdigit():
            raise ValueError(f"runtime.fleet.{key} must be an integer, got {value!r}")
        out[key] = int(value)
        if out[key] < 1:
            raise ValueError(f"runtime.fleet.{key} must be at least 1, got {value!r}")
    _check_type(out["resources"], dict, "runtime.fleet.resources")
    return {key: value for key, value in out.items() if value is not None}


def check_runtime(config: Dict[str, Any]) -> Dict[str, Any]:
    """The runtime pod blocks checked; the ``fleet`` block normalized."""
    runtime = config.get("runtime", {})
    if "builder" in runtime:
        _check_pod(runtime["builder"], "runtime.builder", builder=True)
    for pod in ("server", "prometheus_metrics_server", "client"):
        if pod in runtime:
            _check_pod(runtime[pod], f"runtime.{pod}")
    if "fleet" in runtime:
        runtime["fleet"] = _check_fleet(runtime["fleet"])
    return config


class NormalizedConfig:
    """A project config's globals defaulted and patched, its machines made."""

    DEFAULT_CONFIG_GLOBALS: Dict[str, Any] = {
        "runtime": {
            "reporters": [],
            "server": {
                "resources": {
                    "requests": {"memory": 3000, "cpu": 1000},
                    "limits": {"memory": 6000, "cpu": 2000},
                }
            },
            "prometheus_metrics_server": {
                "resources": {
                    "requests": {"memory": 200, "cpu": 100},
                    "limits": {"memory": 1000, "cpu": 200},
                }
            },
            "builder": {
                "resources": {
                    "requests": {"memory": 3900, "cpu": 1001},
                    "limits": {"memory": 31200, "cpu": 1001},
                },
                "remote_logging": {"enable": False},
            },
            "client": {
                "resources": {
                    "requests": {"memory": 3500, "cpu": 100},
                    "limits": {"memory": 4000, "cpu": 2000},
                },
                "max_instances": 30,
            },
            "influx": {"enable": True},
            # the JAX package's fleet-training block, kept so a machine's
            # runtime reads the same from either package
            "fleet": {
                "accelerator_type": "v5litepod-16",
                "machines_per_slice": 1024,
                "num_slices": 1,
                "compute_dtype": "float32",
            },
        },
        "evaluation": {
            "cv_mode": "full_build",
            "scoring_scaler": "sklearn.preprocessing.MinMaxScaler",
            "metrics": [
                "explained_variance_score",
                "r2_score",
                "mean_squared_error",
                "mean_absolute_error",
            ],
        },
    }

    def __init__(self, config: Dict[str, Any], project_name: str, model_builder_env: Optional[dict] = None):
        if not isinstance(config, dict):
            raise ValueError(f"Config must be a mapping, got {type(config)}")
        default_globals = deepcopy(self.DEFAULT_CONFIG_GLOBALS)
        user_globals = load_globals_config(config.get("globals", {}))
        patched_globals = check_runtime(patch_dict(default_globals, user_globals))
        if model_builder_env is not None:
            patched_globals.setdefault("runtime", {}).setdefault("builder", {})["env"] = model_builder_env
        self.project_name = project_name
        machine_configs = config.get("machines") or []
        if not machine_configs:
            raise ValueError("Config has no machines")
        self.machines: List[Machine] = [
            Machine.from_config(
                load_machine_config(machine_config), project_name=project_name, config_globals=patched_globals
            )
            for machine_config in machine_configs
        ]
        self.globals: Dict[str, Any] = patched_globals
        self.globals["runtime"]["influx"]["resources"] = _calculate_influx_resources(len(self.machines))
