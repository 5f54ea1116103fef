"""The model server: ``build_app`` and ``run_server``."""

from .app import build_app, run_server

__all__ = ["build_app", "run_server"]
