"""The port's command line: ``python -m gordo_tpu_torch build-fleet`` and
``python -m gordo_tpu_torch normalize`` (``cli/cli.py``)."""
