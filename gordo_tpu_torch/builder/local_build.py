"""
Every machine of a YAML project config built with the sequential
:class:`~.build_model.ModelBuilder`, no orchestration involved
(``gordo_tpu/builder/local_build.py``): the development and test loop.
"""

from typing import Any, Iterator, Optional, Tuple

from .. import DeviceLike
from ..machine import Machine
from ..models.training import RandomSource
from ..utils import yaml_lite
from .build_model import ModelBuilder


def local_build(
    config_str: str,
    project_name: str = "local-build",
    device: DeviceLike = None,
    random: Optional[RandomSource] = None,
) -> Iterator[Tuple[Any, Machine]]:
    """
    ``(model, machine)`` of each machine of ``config_str`` (a project
    config's YAML text, read with ``utils/yaml_lite.py`` and normalized),
    built one after another on ``device`` (``cuda`` unless the caller asks
    for the CPU) as a generator.

    >>> config = '''
    ... machines:
    ...   - name: machine-1
    ...     dataset:
    ...       data_provider: {type: RandomDataProvider}
    ...       train_start_date: "2020-01-01T00:00:00+00:00"
    ...       train_end_date: "2020-01-03T00:00:00+00:00"
    ...       tag_list: [tag-1, tag-2]
    ...     model:
    ...       gordo_tpu.models.JaxAutoEncoder:
    ...         kind: feedforward_hourglass
    ...         epochs: 1
    ... '''
    >>> model, machine = next(local_build(config, device="cpu"))  # doctest: +SKIP
    """
    from ..workflow.config_elements.normalized_config import NormalizedConfig

    normalized = NormalizedConfig(yaml_lite.safe_load(config_str), project_name=project_name)
    for machine in normalized.machines:
        yield ModelBuilder(machine, device=device, random=random).build()
