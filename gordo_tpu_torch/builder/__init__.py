"""The sequential build of one machine (:class:`ModelBuilder`), of a
project config's machines (:func:`local_build`), and the builder-class
plug-in (:func:`create_model_builder`)."""

from .build_model import ModelBuilder
from .local_build import local_build
from .utils import create_model_builder

__all__ = ["ModelBuilder", "create_model_builder", "local_build"]
