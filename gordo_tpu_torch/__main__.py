"""``python -m gordo_tpu_torch``: the port's commands (``cli/cli.py``)."""

import sys

from .cli.cli import main

if __name__ == "__main__":
    sys.exit(main())
