"""
The option schemas of ``workflow generate``, the port's
``gordo_tpu/workflow/config_elements/schemas.py``: ``EnvVar``,
``SecurityContext`` and ``PodSecurityContext``, checked by hand in place
of pydantic (which the card's machine lacks).

Each checker takes the option's parsed JSON and gives what pydantic's
``model_dump(exclude_none=True)`` gives: the declared fields coerced as
pydantic's lax mode coerces them (an integer from a string of digits, a
boolean from ``"true"``/``"false"`` and their kin), unset ones dropped,
and any other field kept as given. A value of the wrong type raises
``ValueError`` naming the field.
"""

from typing import Any, Callable, Dict, List

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _string(value: Any, where: str) -> str:
    if not isinstance(value, str):
        raise ValueError(f"{where}: Input should be a valid string, got {value!r}")
    return value


def _integer(value: Any, where: str) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str) and value.strip().lstrip("+-").isdigit():
        return int(value)
    raise ValueError(f"{where}: Input should be a valid integer, got {value!r}")


def _boolean(value: Any, where: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
        return value.lower() in _TRUE
    raise ValueError(f"{where}: Input should be a valid boolean, got {value!r}")


def _mapping(value: Any, where: str) -> dict:
    if not isinstance(value, dict):
        raise ValueError(f"{where}: Input should be a valid dictionary, got {value!r}")
    return value


def _integers(value: Any, where: str) -> List[int]:
    if not isinstance(value, list):
        raise ValueError(f"{where}: Input should be a valid list, got {value!r}")
    return [_integer(item, f"{where}.{i}") for i, item in enumerate(value)]


Field = Callable[[Any, str], Any]


def _model(value: Any, fields: Dict[str, Field], required: tuple, where: str) -> Dict[str, Any]:
    """A mapping checked against ``fields``: the declared ones first, in
    their order, then the others as given; ``None`` values dropped."""
    _mapping(value, where)
    for name in required:
        if name not in value:
            raise ValueError(f"{where}.{name}: Field required")
    out: Dict[str, Any] = {}
    for name, check in fields.items():
        if value.get(name) is not None:
            out[name] = check(value[name], f"{where}.{name}")
    out.update((name, item) for name, item in value.items() if name not in fields and item is not None)
    return out


_SECURITY = {"runAsUser": _integer, "runAsGroup": _integer, "runAsNonRoot": _boolean,
             "readOnlyRootFilesystem": _boolean, "allowPrivilegeEscalation": _boolean}
_POD_SECURITY = {"runAsUser": _integer, "runAsGroup": _integer, "runAsNonRoot": _boolean, "fsGroup": _integer,
                 "supplementalGroups": _integers}
_ENV_VAR = {"name": _string, "value": _string, "valueFrom": _mapping}


def env_vars(value: Any) -> List[Dict[str, Any]]:
    """A JSON list of ``EnvVar``: each a ``name``, and a ``value`` or
    ``valueFrom``."""
    if not isinstance(value, list):
        raise ValueError(f"Input should be a valid list, got {value!r}")
    return [_model(item, _ENV_VAR, ("name",), str(i)) for i, item in enumerate(value)]


def security_context(value: Any) -> Dict[str, Any]:
    """A container's ``securityContext``."""
    return _model(value, _SECURITY, (), "SecurityContext")


def pod_security_context(value: Any) -> Dict[str, Any]:
    """A pod's ``securityContext``."""
    return _model(value, _POD_SECURITY, (), "PodSecurityContext")
