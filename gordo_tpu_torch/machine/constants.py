"""Machine config constants, a copy of ``gordo_tpu/machine/constants.py``."""

#: fields of a machine config block that may arrive as YAML held in a
#: string, read when the config is loaded
MACHINE_YAML_FIELDS = ("model", "dataset", "evaluation", "metadata", "runtime")
