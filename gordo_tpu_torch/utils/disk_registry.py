"""
A registry of one file a key, the index of the model-register cache
(``gordo_tpu/utils/disk_registry.py``): ``write_key``, ``get_value``,
``delete_value``. Writes of different keys may run at once; two writes
of the same key are not atomic, which the builder never does.
"""

import logging
import os
import re
from pathlib import Path
from typing import Optional, Union

logger = logging.getLogger(__name__)

_VALID_KEY_RE = re.compile(r"^[A-Za-z0-9._\-]+$")


def _key_path(registry_dir: Union[os.PathLike, str], key: str) -> Path:
    if not _VALID_KEY_RE.match(key):
        raise ValueError(f"Invalid registry key: {key!r}")
    return Path(registry_dir) / key


def write_key(registry_dir: Union[os.PathLike, str], key: str, val: str) -> None:
    """Write ``val`` under ``key``, making the registry directory if needed.

    >>> import tempfile
    >>> with tempfile.TemporaryDirectory() as d:
    ...     write_key(d, "k", "v"); print(get_value(d, "k"), delete_value(d, "k"), get_value(d, "k"))
    v True None
    """
    path = _key_path(registry_dir, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    logger.debug("Registry write %s -> %s", key, val)
    path.write_text(str(val))


def get_value(registry_dir: Union[os.PathLike, str], key: str) -> Optional[str]:
    """The value under ``key``, or None when it is missing or unreadable."""
    path = _key_path(registry_dir, key)
    try:
        return path.read_text()
    except (FileNotFoundError, NotADirectoryError):
        return None
    except OSError:
        logger.warning("Failed reading registry key %s", key, exc_info=True)
        return None


def delete_value(registry_dir: Union[os.PathLike, str], key: str) -> bool:
    """Delete ``key``; True when it existed."""
    path = _key_path(registry_dir, key)
    try:
        path.unlink()
        return True
    except FileNotFoundError:
        return False
