"""``workflow generate``'s machinery (``gordo_tpu/workflow/workflow_generator``):
the config reader, the machine shard, the workflow template and the slice
geometry."""

from .workflow_generator import (
    default_image_pull_policy,
    default_workflow_template,
    get_dict_from_yaml,
    load_workflow_template,
    machines_document,
    normalize,
)

__all__ = [
    "default_image_pull_policy",
    "default_workflow_template",
    "get_dict_from_yaml",
    "load_workflow_template",
    "machines_document",
    "normalize",
]
