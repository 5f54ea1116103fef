"""
Offline schema validation of rendered manifests, the port's
``gordo_tpu/workflow/manifest_validation.py``: every document checked
against a vendored structural schema of its kind (the same ``SCHEMAS``),
then the cross-document invariants (selectors and pod-template labels,
volumeMounts and volumes, scale targets, duplicate names). An unknown
kind is an error.

The JAX package checks the schemas with ``jsonschema``, which the card's
machine lacks. :func:`schema_errors` is a checker of the keywords these
schemas use (``$ref`` into ``$defs``, ``type``, ``required``,
``properties``, ``additionalProperties``, ``items``, ``enum``, ``const``,
``pattern``, ``minLength``, ``minItems``, ``minimum``, ``maximum``,
``not``), in ``Draft202012Validator``'s order and with its messages, so
``validate_manifests`` returns the JAX function's error strings.
"""

import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# DNS-1123 subdomain (object names) and label restrictions.
_NAME_PATTERN = r"^[a-z0-9]([-a-z0-9.]{0,251}[a-z0-9])?$"
_LABEL_VALUE_PATTERN = r"^(|[A-Za-z0-9]([-A-Za-z0-9_.]{0,61}[A-Za-z0-9])?)$"

_DEFS: Dict[str, Any] = {
    "metadata": {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string", "pattern": _NAME_PATTERN},
            "namespace": {"type": "string", "pattern": _NAME_PATTERN},
            "labels": {
                "type": "object",
                "additionalProperties": {
                    "type": "string",
                    "pattern": _LABEL_VALUE_PATTERN,
                },
            },
            "annotations": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "ownerReferences": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["apiVersion", "kind", "name", "uid"],
                },
            },
        },
    },
    "quantity": {"type": ["string", "integer", "number"]},
    "resources": {
        "type": "object",
        "properties": {
            "limits": {
                "type": "object",
                "additionalProperties": {"$ref": "#/$defs/quantity"},
            },
            "requests": {
                "type": "object",
                "additionalProperties": {"$ref": "#/$defs/quantity"},
            },
        },
    },
    "envVar": {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string", "minLength": 1},
            "value": {"type": "string"},
            "valueFrom": {"type": "object"},
        },
        # exactly one source: a bare name is legal (empty value), but
        # value AND valueFrom together is a typo k8s rejects
        "not": {"required": ["value", "valueFrom"]},
    },
    "container": {
        "type": "object",
        "required": ["name", "image"],
        "properties": {
            "name": {"type": "string", "pattern": _NAME_PATTERN},
            "image": {"type": "string", "minLength": 1},
            "command": {"type": "array", "items": {"type": "string"}},
            "args": {"type": "array", "items": {"type": "string"}},
            "workingDir": {"type": "string"},
            "env": {"type": "array", "items": {"$ref": "#/$defs/envVar"}},
            "envFrom": {"type": "array", "items": {"type": "object"}},
            "ports": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["containerPort"],
                    "properties": {
                        "containerPort": {"$ref": "#/$defs/port"},
                        "name": {"type": "string"},
                    },
                },
            },
            "resources": {"$ref": "#/$defs/resources"},
            "volumeMounts": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["name", "mountPath"],
                    "properties": {
                        "name": {"type": "string"},
                        "mountPath": {"type": "string", "minLength": 1},
                        "subPath": {"type": "string"},
                        "readOnly": {"type": "boolean"},
                    },
                },
            },
            "livenessProbe": {"type": "object"},
            "readinessProbe": {"type": "object"},
            "securityContext": {"type": "object"},
            "lifecycle": {"type": "object"},
            "terminationMessagePath": {"type": "string"},
            "terminationMessagePolicy": {
                "enum": ["File", "FallbackToLogsOnError"]
            },
            "imagePullPolicy": {"enum": ["Always", "IfNotPresent", "Never"]},
        },
    },
    "port": {"type": "integer", "minimum": 1, "maximum": 65535},
    "podSpec": {
        "type": "object",
        "required": ["containers"],
        "properties": {
            "containers": {
                "type": "array",
                "minItems": 1,
                "items": {"$ref": "#/$defs/container"},
            },
            "initContainers": {
                "type": "array",
                "items": {"$ref": "#/$defs/container"},
            },
            "volumes": {
                "type": "array",
                "items": {"type": "object", "required": ["name"]},
            },
            "restartPolicy": {"enum": ["Always", "OnFailure", "Never"]},
            "serviceAccountName": {"type": "string"},
            "securityContext": {"type": "object"},
            "nodeSelector": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "tolerations": {"type": "array"},
            "affinity": {"type": "object"},
            "terminationGracePeriodSeconds": {"type": "integer"},
            "imagePullSecrets": {"type": "array"},
        },
    },
    "podTemplate": {
        "type": "object",
        "required": ["spec"],
        "properties": {
            "metadata": {"type": "object"},
            "spec": {"$ref": "#/$defs/podSpec"},
        },
    },
    "labelSelector": {
        "type": "object",
        "properties": {
            "matchLabels": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "matchExpressions": {"type": "array"},
        },
    },
}


def _kind_schema(
    api_versions: Iterable[str], spec: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    schema: Dict[str, Any] = {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata"],
        "properties": {
            "apiVersion": {"enum": list(api_versions)},
            "kind": {"type": "string"},
            "metadata": {"$ref": "#/$defs/metadata"},
        },
        "$defs": _DEFS,
    }
    if spec is not None:
        schema["required"] = schema["required"] + ["spec"]
        schema["properties"]["spec"] = spec
    return schema


#: kind → vendored structural schema. Every kind the workflow template
#: may emit MUST appear here; validate_manifests errors on strangers.
SCHEMAS: Dict[str, Dict[str, Any]] = {
    "ConfigMap": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata"],
        "properties": {
            "apiVersion": {"const": "v1"},
            "metadata": {"$ref": "#/$defs/metadata"},
            "data": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "binaryData": {"type": "object"},
            "immutable": {"type": "boolean"},
        },
        "$defs": _DEFS,
    },
    "PersistentVolumeClaim": _kind_schema(
        ["v1"],
        {
            "type": "object",
            "required": ["accessModes", "resources"],
            "properties": {
                "accessModes": {
                    "type": "array",
                    "minItems": 1,
                    "items": {
                        "enum": [
                            "ReadWriteOnce",
                            "ReadOnlyMany",
                            "ReadWriteMany",
                            "ReadWriteOncePod",
                        ]
                    },
                },
                "resources": {
                    "type": "object",
                    "required": ["requests"],
                    "properties": {
                        "requests": {
                            "type": "object",
                            "required": ["storage"],
                            "properties": {
                                "storage": {"$ref": "#/$defs/quantity"}
                            },
                        }
                    },
                },
                "storageClassName": {"type": "string"},
                "volumeMode": {"enum": ["Filesystem", "Block"]},
            },
        },
    ),
    "Service": _kind_schema(
        ["v1"],
        {
            "type": "object",
            "required": ["ports"],
            "properties": {
                "ports": {
                    "type": "array",
                    "minItems": 1,
                    "items": {
                        "type": "object",
                        "required": ["port"],
                        "properties": {
                            "port": {"$ref": "#/$defs/port"},
                            "targetPort": {"type": ["integer", "string"]},
                            "name": {"type": "string"},
                            "protocol": {"enum": ["TCP", "UDP", "SCTP"]},
                        },
                    },
                },
                "selector": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                },
                "type": {
                    "enum": [
                        "ClusterIP",
                        "NodePort",
                        "LoadBalancer",
                        "ExternalName",
                    ]
                },
                "clusterIP": {"type": "string"},
            },
        },
    ),
    "Job": _kind_schema(
        ["batch/v1"],
        {
            "type": "object",
            "required": ["template"],
            "properties": {
                "template": {"$ref": "#/$defs/podTemplate"},
                "backoffLimit": {"type": "integer", "minimum": 0},
                "activeDeadlineSeconds": {"type": "integer"},
                "ttlSecondsAfterFinished": {"type": "integer"},
                "completions": {"type": "integer"},
                "parallelism": {"type": "integer"},
            },
        },
    ),
    "Deployment": _kind_schema(
        ["apps/v1"],
        {
            "type": "object",
            "required": ["selector", "template"],
            "properties": {
                "replicas": {"type": "integer", "minimum": 0},
                "selector": {"$ref": "#/$defs/labelSelector"},
                "template": {"$ref": "#/$defs/podTemplate"},
                "strategy": {"type": "object"},
                "revisionHistoryLimit": {"type": "integer"},
            },
        },
    ),
    "StatefulSet": _kind_schema(
        ["apps/v1"],
        {
            "type": "object",
            "required": ["selector", "template", "serviceName"],
            "properties": {
                "serviceName": {"type": "string"},
                "replicas": {"type": "integer", "minimum": 0},
                "selector": {"$ref": "#/$defs/labelSelector"},
                "template": {"$ref": "#/$defs/podTemplate"},
                "volumeClaimTemplates": {"type": "array"},
            },
        },
    ),
    "HorizontalPodAutoscaler": _kind_schema(
        ["autoscaling/v2"],
        {
            "type": "object",
            "required": ["scaleTargetRef", "maxReplicas"],
            "properties": {
                "scaleTargetRef": {
                    "type": "object",
                    "required": ["apiVersion", "kind", "name"],
                },
                "minReplicas": {"type": "integer", "minimum": 1},
                "maxReplicas": {"type": "integer", "minimum": 1},
                "metrics": {"type": "array"},
                "behavior": {"type": "object"},
            },
        },
    ),
    "ServiceMonitor": _kind_schema(
        ["monitoring.coreos.com/v1"],
        {
            "type": "object",
            "required": ["selector", "endpoints"],
            "properties": {
                "selector": {"$ref": "#/$defs/labelSelector"},
                "endpoints": {
                    "type": "array",
                    "minItems": 1,
                    "items": {
                        "type": "object",
                        "properties": {
                            "port": {"type": "string"},
                            "path": {"type": "string"},
                            "interval": {"type": "string"},
                        },
                    },
                },
                "namespaceSelector": {"type": "object"},
            },
        },
    ),
    "ScaledObject": _kind_schema(
        ["keda.sh/v1alpha1"],
        {
            "type": "object",
            "required": ["scaleTargetRef", "triggers"],
            "properties": {
                "scaleTargetRef": {
                    "type": "object",
                    "required": ["name"],
                },
                "minReplicaCount": {"type": "integer"},
                "maxReplicaCount": {"type": "integer"},
                "triggers": {
                    "type": "array",
                    "minItems": 1,
                    "items": {
                        "type": "object",
                        "required": ["type", "metadata"],
                    },
                },
            },
        },
    ),
    "VirtualService": _kind_schema(
        [
            "networking.istio.io/v1",
            "networking.istio.io/v1beta1",
            "networking.istio.io/v1alpha3",
        ],
        {
            "type": "object",
            "required": ["http"],
            "properties": {
                "hosts": {"type": "array", "items": {"type": "string"}},
                "gateways": {"type": "array", "items": {"type": "string"}},
                "http": {
                    "type": "array",
                    "minItems": 1,
                    "items": {
                        "type": "object",
                        "required": ["route"],
                        "properties": {
                            "match": {"type": "array"},
                            "route": {
                                "type": "array",
                                "minItems": 1,
                                "items": {
                                    "type": "object",
                                    "required": ["destination"],
                                },
                            },
                            "rewrite": {"type": "object"},
                            "timeout": {"type": "string"},
                            "retries": {"type": "object"},
                        },
                    },
                },
            },
        },
    ),
    # The per-machine Model custom resource this project's controller
    # consumes (template :911); its spec is the machine config document.
    "Model": _kind_schema(
        ["equinor.com/v1", "gordo.equinor.com/v1"],
        {"type": "object", "required": ["config"]},
    ),
}



# -- the schema checker ---------------------------------------------------------------

_TYPES = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    "null": lambda v: v is None,
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: (isinstance(v, int) and not isinstance(v, bool)) or (isinstance(v, float) and v.is_integer()),
}


def _equal(a: Any, b: Any) -> bool:
    """JSON equality: ``True`` is not ``1``."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


Error = Tuple[Tuple[Any, ...], str]


def schema_errors(instance: Any, schema: Dict[str, Any]) -> List[Error]:
    """Every ``(path, message)`` of ``instance`` against ``schema``, in
    ``jsonschema``'s order (a schema's keywords in turn)."""
    return list(_errors(instance, schema, schema.get("$defs", {}), ()))


def _errors(instance: Any, schema: Any, defs: Dict[str, Any], path: Tuple[Any, ...]) -> Iterator[Error]:
    for keyword, value in schema.items():
        if keyword == "$ref":
            yield from _errors(instance, defs[value.rsplit("/", 1)[1]], defs, path)
        elif keyword == "type":
            types = value if isinstance(value, list) else [value]
            if not any(_TYPES[t](instance) for t in types):
                yield path, f"{instance!r} is not of type {', '.join(repr(t) for t in types)}"
        elif keyword == "required" and isinstance(instance, dict):
            for name in value:
                if name not in instance:
                    yield path, f"{name!r} is a required property"
        elif keyword == "properties" and isinstance(instance, dict):
            for name, subschema in value.items():
                if name in instance:
                    yield from _errors(instance[name], subschema, defs, path + (name,))
        elif keyword == "additionalProperties" and isinstance(instance, dict):
            known = schema.get("properties", {})
            for name in instance:
                if name not in known:
                    yield from _errors(instance[name], value, defs, path + (name,))
        elif keyword == "items" and isinstance(instance, list):
            for index, item in enumerate(instance):
                yield from _errors(item, value, defs, path + (index,))
        elif keyword == "enum":
            if not any(_equal(instance, option) for option in value):
                yield path, f"{instance!r} is not one of {value!r}"
        elif keyword == "const":
            if not _equal(instance, value):
                yield path, f"{value!r} was expected"
        elif keyword == "pattern" and isinstance(instance, str):
            if not re.search(value, instance):
                yield path, f"{instance!r} does not match {value!r}"
        elif keyword in ("minLength", "minItems") and isinstance(instance, str if keyword == "minLength" else list):
            if len(instance) < value:
                yield path, f"{instance!r} {'should be non-empty' if value == 1 else 'is too short'}"
        elif keyword in ("minimum", "maximum") and _TYPES["number"](instance):
            if (instance < value) if keyword == "minimum" else (instance > value):
                word = "less than the minimum" if keyword == "minimum" else "greater than the maximum"
                yield path, f"{instance!r} is {word} of {value!r}"
        elif keyword == "not":
            if not any(True for _ in _errors(instance, value, defs, path)):
                yield path, f"{instance!r} should not be valid under {value!r}"


def _pod_template_errors(
    where: str,
    template: Dict[str, Any],
    extra_volumes: Iterable[str] = (),
) -> List[str]:
    """Invariants jsonschema can't express: mounts must name declared
    volumes (``extra_volumes`` carries a StatefulSet's
    volumeClaimTemplates, which mounts may also reference); env and
    container names must be unique."""
    errors: List[str] = []
    spec = template.get("spec") or {}
    volumes = {v.get("name") for v in spec.get("volumes") or []}
    volumes.update(extra_volumes)
    containers = list(spec.get("containers") or []) + list(
        spec.get("initContainers") or []
    )
    names = [c.get("name") for c in containers]
    if len(names) != len(set(names)):
        errors.append(f"{where}: duplicate container names {names}")
    for container in containers:
        cwhere = f"{where}/{container.get('name')}"
        for mount in container.get("volumeMounts") or []:
            if mount.get("name") not in volumes:
                errors.append(
                    f"{cwhere}: volumeMount {mount.get('name')!r} has no "
                    f"matching volume (declared: {sorted(filter(None, volumes))})"
                )
        env_names = [e.get("name") for e in container.get("env") or []]
        if len(env_names) != len(set(env_names)):
            duplicates = sorted(
                {n for n in env_names if env_names.count(n) > 1}
            )
            errors.append(f"{cwhere}: duplicate env names {duplicates}")
    return errors


def _selector_matches(selector: Dict[str, Any], labels: Dict[str, str]) -> bool:
    selector = selector or {}
    if "matchLabels" in selector or "matchExpressions" in selector:
        match = selector.get("matchLabels") or {}
        expressions = selector.get("matchExpressions") or []
    else:  # a plain label map (Service spec.selector)
        match, expressions = selector, []
    if not all(labels.get(k) == v for k, v in match.items()):
        return False
    for expr in expressions:
        key = expr.get("key")
        operator = expr.get("operator")
        values = expr.get("values") or []
        if operator == "In":
            if labels.get(key) not in values:
                return False
        elif operator == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif operator == "Exists":
            if key not in labels:
                return False
        elif operator == "DoesNotExist":
            if key in labels:
                return False
        # unknown operators are left to the API server's own validation
    return True


def validate_manifests(docs: Iterable[Optional[Dict[str, Any]]]) -> List[str]:
    """
    Validate rendered manifest documents; returns a list of error strings
    (empty = valid). Checks, in order:

    1. every non-empty document has a known ``kind`` and validates
       against its vendored schema;
    2. no two documents share (kind, namespace, name);
    3. workload selectors match their own pod-template labels;
    4. Service selectors, HPA/ScaledObject scale targets point at an
       emitted workload;
    5. pod-level invariants (mounts ↔ volumes, unique env/container
       names) for every pod template.

    The schemas are checked by :func:`schema_errors`, which gives
    ``jsonschema``'s ``Draft202012Validator`` messages and paths.
    """
    errors: List[str] = []
    seen: set = set()
    workloads: Dict[str, Dict[str, Any]] = {}  # name → pod labels, for refs
    documents = [d for d in docs if d]

    for position, doc in enumerate(documents):
        kind = doc.get("kind")
        name = (doc.get("metadata") or {}).get("name", f"<doc {position}>")
        where = f"{kind}/{name}"
        if kind not in SCHEMAS:
            errors.append(
                f"document {position} ({where}): unknown kind {kind!r} — "
                "add a vendored schema to manifest_validation.SCHEMAS"
            )
            continue
        for path_parts, message in schema_errors(doc, SCHEMAS[kind]):
            path = ".".join(str(p) for p in path_parts)
            errors.append(f"{where}: {path or '<root>'}: {message}")

        key = (kind, (doc.get("metadata") or {}).get("namespace"), name)
        if key in seen:
            errors.append(f"{where}: duplicate (kind, namespace, name)")
        seen.add(key)

        spec = doc.get("spec") or {}
        template = spec.get("template")
        if isinstance(template, dict):
            claim_names = [
                ((t.get("metadata") or {}).get("name"))
                for t in spec.get("volumeClaimTemplates") or []
            ]
            errors.extend(_pod_template_errors(where, template, claim_names))
            pod_labels = (template.get("metadata") or {}).get("labels") or {}
            if kind in ("Deployment", "StatefulSet"):
                workloads[name] = pod_labels
                if not _selector_matches(spec.get("selector") or {}, pod_labels):
                    errors.append(
                        f"{where}: selector does not match its own pod-"
                        f"template labels {sorted(pod_labels)}"
                    )

    for doc in documents:
        kind, spec = doc.get("kind"), doc.get("spec") or {}
        name = (doc.get("metadata") or {}).get("name")
        where = f"{kind}/{name}"
        if kind == "Service" and spec.get("selector"):
            if not any(
                _selector_matches({"matchLabels": spec["selector"]}, labels)
                for labels in workloads.values()
            ):
                errors.append(
                    f"{where}: selector {spec['selector']} matches no "
                    "emitted Deployment/StatefulSet pod template"
                )
        elif kind in ("HorizontalPodAutoscaler", "ScaledObject"):
            target = (spec.get("scaleTargetRef") or {}).get("name")
            if target not in workloads:
                errors.append(
                    f"{where}: scaleTargetRef {target!r} is not an emitted "
                    f"workload (have: {sorted(workloads)})"
                )
    return errors
