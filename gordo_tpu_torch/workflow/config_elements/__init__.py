"""The project config's normalization (``gordo_tpu/workflow/config_elements``)."""
