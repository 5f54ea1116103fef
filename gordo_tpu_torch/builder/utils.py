"""The ``--model-builder-class`` plug-in point (``gordo_tpu/builder/utils.py``)."""

import importlib
from typing import Any, Optional, Type

from .build_model import ModelBuilder


def import_location(location: str) -> Any:
    """The object a ``module.path.Name`` location names."""
    module_name, _, attribute = location.rpartition(".")
    if not module_name:
        raise ValueError(f"{location!r} is not a module.path.Name location")
    return getattr(importlib.import_module(module_name), attribute)


def create_model_builder(model_builder_class: Optional[str]) -> Type[ModelBuilder]:
    """The class ``model_builder_class`` names (``module.path.Name``), which
    must subclass :class:`ModelBuilder`; :class:`ModelBuilder` itself when
    it names none.

    >>> create_model_builder(None) is ModelBuilder
    True
    """
    if not model_builder_class:
        return ModelBuilder
    builder_class = import_location(model_builder_class)
    if not (isinstance(builder_class, type) and issubclass(builder_class, ModelBuilder)):
        raise ValueError(
            f"{model_builder_class} is not a subclass of gordo_tpu_torch.builder.build_model.ModelBuilder")
    return builder_class
